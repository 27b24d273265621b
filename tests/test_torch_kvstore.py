"""The port's in-process kvstore (mxnet_tpu_torch/kvstore.py) and the
Trainer's kvstore path (mxnet_tpu_torch/gluon/trainer.py) held against the
JAX package's (mxnet_tpu/kvstore.py, mxnet_tpu/gluon/trainer.py).

The same numpy gradients go through both packages' stores over several
pushes: pulled values and compression residuals equal bit for bit in bf16
and float32 (the 2-bit codec, the residual in the gradient's dtype, the
dequantized sum cast back), list pushes summed left to right in bf16 as
JAX's ``add_n`` sums them, and update on kvstore with SGD and Adam (the
store's pickled copy of the optimizer) in bf16, where JAX's jitted update
rounds every op as the port does. Optimizer states saved by one store load
into another. A torch tensor is mutable, so the store never shares one
with its callers (the aliasing tests). A Trainer with a compressed store
attached trains a narrow net exactly as the same net does with its
gradients compressed by hand. The CUDA codec is checked on the card
(``chip_smoke.py`` phase ``train_kv``, ``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.kernels import compression as tc

# key -> shape: one above the default size_lower_bound of 4096, one at it,
# one below, and a string key
KEYS = {0: (64, 80), 1: (4096,), 2: (100,), "fc": (33, 129)}


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.view(torch.int16 if a.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(a._data if hasattr(a, "_data") else a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _pair(a, dtype):
    t = torch.from_numpy(a).to(getattr(torch, dtype), copy=True)
    return t, mxj.nd.array(t.float().numpy().copy()).astype(dtype)


def _stores(params=None):
    jkv, tkv = mxj.kv.create("local"), mx.kv.create("local")
    if params is not None:
        jkv.set_gradient_compression(params)
        tkv.set_gradient_compression(params)
    return jkv, tkv


@pytest.mark.parametrize("thr", [0.5, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_pushes_match_jax(dtype, thr):
    """Four pushes per key: pulled values and residuals bit for bit; the
    key below the bound passes through uncompressed."""
    jkv, tkv = _stores({"type": "2bit", "threshold": thr})
    for k, shape in KEYS.items():
        t, j = _pair(np.zeros(shape, np.float32), dtype)
        jkv.init(k, j)
        tkv.init(k, t)
    rs = np.random.RandomState(0)
    for _ in range(4):
        for k, shape in KEYS.items():
            t, j = _pair((rs.randn(*shape) * thr * 0.8).astype(np.float32),
                         dtype)
            jkv.push(k, j)
            tkv.push(k, t)
            tout, jout = _pair(np.zeros(shape, np.float32), dtype)
            jkv.pull(k, out=jout)
            tkv.pull(k, out=tout)
            assert np.array_equal(_bits(tout), _bits(jout))
            if k == 2:
                assert k not in tkv._compression_residuals
                assert np.array_equal(_bits(tout), _bits(t))
            else:
                assert np.array_equal(_bits(tkv._compression_residuals[k]),
                                      _bits(jkv._compression_residuals[k]))
    assert tkv.bytes_pushed == jkv.bytes_pushed
    assert tkv.bytes_pulled == jkv.bytes_pulled


@pytest.mark.parametrize("compress", [False, True])
def test_list_push_sums_like_jax_bf16(compress):
    """Three values for one key sum left to right in bf16 (JAX's add_n),
    then compress."""
    jkv, tkv = _stores({"type": "2bit", "threshold": 0.5}
                       if compress else None)
    shape = (80, 64)
    t0, j0 = _pair(np.zeros(shape, np.float32), "bfloat16")
    jkv.init(3, j0)
    tkv.init(3, t0)
    rs = np.random.RandomState(1)
    for _ in range(2):
        pairs = [_pair((rs.randn(*shape) * 0.3).astype(np.float32),
                       "bfloat16") for _ in range(3)]
        jkv.push(3, [j for _, j in pairs])
        tkv.push(3, [t for t, _ in pairs])
        tout, jout = _pair(np.zeros(shape, np.float32), "bfloat16")
        jkv.pull(3, out=jout)
        tkv.pull(3, out=tout)
        assert np.array_equal(_bits(tout), _bits(jout))


def _compressed_trio(dtype, update, keys):
    """Two port stores and a JAX store with the same compression (and, with
    ``update``, the same SGD on the store), each key initialized from the
    same numpy values."""
    stores = [mx.kv.create("local"), mx.kv.create("local"),
              mxj.kv.create("local")]
    rs = np.random.RandomState(6)
    for kv in stores:
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        if update:
            kv.set_optimizer((mxj.optimizer if kv is stores[2] else topt)
                             .create("sgd", **_OPTS["sgd"]))
    for k in keys:
        t, j = _pair(rs.randn(*KEYS[k]).astype(np.float32), dtype)
        stores[0].init(k, t)
        stores[1].init(k, t)
        stores[2].init(k, j)
    return stores


@pytest.mark.parametrize("update", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_list_push_equals_per_key_and_jax(dtype, update):
    """Three rounds of one list push (and one list pull) of every key
    against the same keys pushed and pulled one by one, and against the JAX
    store fed the same numpy values: pulled values (the weights, with an
    updater) and residuals bit for bit. The list goes through one grouped
    codec call per round. Integer keys with an updater (string keys share
    int key 0's optimizer state in both packages). JAX's float32 SGD
    update is contracted into an FMA by XLA:CPU, so float32 weights are
    held against JAX only without an updater; the residuals always are."""
    keys = [k for k in KEYS if isinstance(k, int) or not update]
    tlist, teach, jkv = _compressed_trio(dtype, update, keys)
    rs = np.random.RandomState(7)
    for _ in range(3):
        pairs = [_pair((rs.randn(*KEYS[k]) * 0.4).astype(np.float32), dtype)
                 for k in keys]
        tlist.push(keys, [t.clone() for t, _ in pairs])
        for k, (t, _) in zip(keys, pairs):
            teach.push(k, t.clone())
        jkv.push(keys, [j for _, j in pairs])
        outs = [_pair(np.zeros(KEYS[k], np.float32), dtype) for k in keys]
        tlist.pull(keys, out=[t for t, _ in outs])
        jkv.pull(keys, out=[j for _, j in outs])
        for k, (t, j) in zip(keys, outs):
            each = torch.zeros(KEYS[k], dtype=t.dtype)
            teach.pull(k, out=each)
            assert np.array_equal(_bits(t), _bits(each)), k
            if dtype == "bfloat16" or not update:
                assert np.array_equal(_bits(t), _bits(j)), k
        assert sorted(tlist._compression_residuals, key=str) == \
            sorted(jkv._compression_residuals, key=str)
        for k, res in tlist._compression_residuals.items():
            assert np.array_equal(_bits(res),
                                  _bits(teach._compression_residuals[k]))
            assert np.array_equal(_bits(res),
                                  _bits(jkv._compression_residuals[k]))
    assert tlist.bytes_pushed == teach.bytes_pushed == jkv.bytes_pushed


@pytest.mark.parametrize("update", [False, True])
def test_repeated_key_in_a_list_push(update):
    """A key twice in one list push equals two successive pushes: the
    second sees the residual the first left (and the weight it updated)."""
    keys = [0, 1]
    one, two, _ = _compressed_trio("bfloat16", update, keys)
    rs = np.random.RandomState(8)
    gs = [_pair((rs.randn(*KEYS[k]) * 0.4).astype(np.float32),
                "bfloat16")[0] for k in (0, 1, 0)]
    one.push([0, 1, 0], [g.clone() for g in gs])
    two.push([0, 1], [gs[0].clone(), gs[1].clone()])
    two.push(0, gs[2].clone())
    for k in keys:
        a, b = (torch.zeros(KEYS[k], dtype=torch.bfloat16) for _ in range(2))
        one.pull(k, out=a)
        two.pull(k, out=b)
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        assert torch.equal(one._compression_residuals[k].view(torch.int16),
                           two._compression_residuals[k].view(torch.int16))


def test_list_push_raises_at_the_first_key_not_initialized():
    """Keys before it are pushed, as the reference's loop pushes them."""
    kv = mx.kv.create("local")
    kv.init(0, torch.zeros(4))
    with pytest.raises(ValueError, match="not been initialized"):
        kv.push([0, 5, 0], [torch.ones(4), torch.ones(4), torch.ones(4)])
    out = torch.zeros(4)
    kv.pull(0, out=out)
    assert torch.equal(out, torch.ones(4))


def test_roundtrip_with_residual():
    """The JAX suite's case (tests/test_pallas.py): 0.3 stays below the
    threshold once, and fires with the residual the second time."""
    kv = mx.kv.create("local")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5,
                                 "size_lower_bound": 0})
    kv.init(3, torch.zeros(8, 8))
    g = torch.ones(8, 8) * 0.3
    out = torch.zeros(8, 8)
    kv.push(3, g)
    kv.pull(3, out=out)
    assert float(out.abs().max()) == 0.0
    kv.push(3, g)
    kv.pull(3, out=out)
    assert torch.allclose(out, torch.full((8, 8), 0.5))


def test_size_lower_bound_from_env(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_SIZE_LOWER_BOUND", "10")
    kv = mx.kv.create("device")
    kv.set_gradient_compression({"type": "2bit"})
    assert kv._compression_params["size_lower_bound"] == 10
    assert kv._compression_params["threshold"] == 0.5
    kv.init(0, torch.zeros(10))
    kv.push(0, torch.full((10,), 0.01))
    out = torch.zeros(10)
    kv.pull(0, out=out)
    assert float(out.abs().max()) == 0.0          # compressed to zeros
    with pytest.raises(ValueError):
        kv.set_gradient_compression({"type": "1bit"})


_OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
                 "rescale_grad": 0.125},
         "adam": {"learning_rate": 1e-2, "wd": 1e-4, "rescale_grad": 0.125}}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_update_on_kvstore_matches_jax_bf16(name, compress):
    """set_optimizer: the store updates its weights with a pickled copy of
    the optimizer at each push; three pushes, pulled weights bit for bit
    with the JAX store's, and the caller's optimizer untouched. Integer
    keys only: both packages number string keys from 0 for the updater
    (``_str_key_int``), so a string key would share int key 0's state."""
    jkv, tkv = _stores({"type": "2bit", "threshold": 0.5}
                       if compress else None)
    jo = mxj.optimizer.create(name, **_OPTS[name])
    to = topt.create(name, **_OPTS[name])
    jkv.set_optimizer(jo)
    tkv.set_optimizer(to)
    rs = np.random.RandomState(2)
    keys = {k: v for k, v in KEYS.items() if isinstance(k, int)}
    for k, shape in keys.items():
        t, j = _pair(rs.randn(*shape).astype(np.float32), "bfloat16")
        jkv.init(k, j)
        tkv.init(k, t)
    for _ in range(3):
        for k, shape in keys.items():
            t, j = _pair((rs.randn(*shape) * 2).astype(np.float32),
                         "bfloat16")
            tout, jout = _pair(np.zeros(shape, np.float32), "bfloat16")
            jkv.pushpull(k, j, out=jout)
            tkv.pushpull(k, t, out=tout)
            assert np.array_equal(_bits(tout), _bits(jout))
    assert to.num_update == 0 and tkv._optimizer.num_update == 3
    assert tkv._optimizer is not to


def test_optimizer_states_save_and_load(tmp_path):
    """The store's Adam states survive save/load bit for bit (a resumed
    store continues exactly), and states the JAX store saved load into the
    port's."""
    rs = np.random.RandomState(3)
    w0 = rs.randn(64, 80).astype(np.float32)
    grads = [rs.randn(64, 80).astype(np.float32) for _ in range(3)]
    runs = []
    for resume in (False, True):
        kv = mx.kv.create("local")
        kv.set_optimizer(topt.Adam(learning_rate=1e-2))
        kv.init(0, torch.from_numpy(w0))
        for i, g in enumerate(grads):
            if resume and i == 2:
                fname = str(tmp_path / "states")
                kv.save_optimizer_states(fname, dump_optimizer=True)
                w = torch.zeros(64, 80)
                kv.pull(0, out=w)
                kv = mx.kv.create("local")
                kv.set_optimizer(topt.Adam(learning_rate=1e-2))
                kv.init(0, w)
                kv.load_optimizer_states(fname)
                assert kv._updater.optimizer.num_update == 2
            kv.push(0, torch.from_numpy(g))
        out = torch.zeros(64, 80)
        runs.append(kv.pull(0, out=out))
    assert torch.equal(runs[0], runs[1])

    jkv = mxj.kv.create("local")
    jkv.set_optimizer(mxj.optimizer.Adam(learning_rate=1e-2))
    jkv.init(0, mxj.nd.array(w0))
    jkv.push(0, mxj.nd.array(grads[0]))
    fname = str(tmp_path / "jax_states")
    jkv.save_optimizer_states(fname)
    kv = mx.kv.create("local")
    kv.set_optimizer(topt.Adam(learning_rate=1e-2))
    kv.load_optimizer_states(fname)
    m, v = kv._updater.ensure_state(0, torch.zeros(64, 80))
    jm, jv = jkv._updater.states[0]
    assert np.array_equal(_bits(m), _bits(jm))
    assert np.array_equal(_bits(v), _bits(jv))


@pytest.mark.parametrize("compress", [False, True])
def test_store_never_aliases_callers(compress):
    """Mutating an init value, a pushed tensor or a pulled output never
    changes the store; pushpull writes a parameter that requires grad."""
    kv = mx.kv.create("local")
    if compress:
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5,
                                     "size_lower_bound": 0})
    w = torch.ones(32)
    kv.init(0, w)
    w += 1
    out = torch.zeros(32)
    kv.pull(0, out=out)
    assert torch.equal(out, torch.ones(32))
    g = torch.full((32,), 2.0)
    kv.push(0, g)
    g += 5
    kv.pull(0, out=out)
    want = torch.full((32,), 0.5 if compress else 2.0)
    assert torch.equal(out, want)
    out += 3
    again = torch.zeros(32)
    kv.pull(0, out=[again])
    assert torch.equal(again, want)
    kv.set_optimizer(topt.SGD(learning_rate=0.1))
    p = torch.nn.Parameter(torch.zeros(32))
    kv.pushpull(0, torch.ones(32), out=p)
    assert p.requires_grad and p.grad_fn is None
    p.data += 1
    kv.pull(0, out=again)
    assert not torch.equal(again, p.detach())


@pytest.mark.parametrize("kind", ["dist_sync", "dist_device_sync",
                                  "dist_async", "dist"])
def test_dist_kinds_raise(kind, monkeypatch):
    """In one process a dist kind is a store of one worker, and a Trainer
    given its name attaches it (updating on it); dist_async, the
    asynchronous server, raises, naming M10b
    (tests/test_torch_dist_kvstore.py runs two workers)."""
    monkeypatch.delenv("MXTPU_COORDINATOR", raising=False)
    net = _net("float32")
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", kvstore=kind)
    if kind == "dist_async":
        with pytest.raises(NotImplementedError, match="M10b"):
            mx.kv.create(kind)
        with pytest.raises(NotImplementedError, match="M10b"):
            tr._prepare()
        return
    kv = mx.kv.create(kind)
    assert (kv.type, kv.rank, kv.num_workers) == (kind, 0, 1)
    tr._prepare()
    assert tr._kvstore.type == kind and tr._update_on_kvstore


def test_create_kinds():
    for kind in ("local", "device", "nccl", "tpu", "LOCAL"):
        kv = mx.kvstore.create(kind)
        assert kv.type == kind.lower() and kv.rank == 0
        assert kv.num_workers == 1
    with pytest.raises(ValueError):
        mx.kv.create("parameter_server")
    with pytest.raises(TypeError):
        mx.kv.create(3)
    kv = mx.kv.create("local")
    with pytest.raises(ValueError):
        kv.push(9, torch.zeros(2))
    with pytest.raises(NotImplementedError):
        kv.row_sparse_pull(9, out=torch.zeros(2), row_ids=torch.zeros(1))
    kv.broadcast("b", torch.ones(3), out=torch.zeros(3))
    kv.set_barrier_before_exit(False)


# -- the Trainer --------------------------------------------------------------

def _net(dtype):
    """A narrow net whose first weight (80 x 64) is over the 4096 bound."""
    rs = np.random.RandomState(4)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(80, in_units=64, activation="relu"))
    net.add(mx.gluon.nn.Dense(4, in_units=80))
    net.initialize(ctx=mx.cpu())
    mx.convert.load_numpy_params(net, {
        "0.weight": rs.uniform(-0.3, 0.3, (80, 64)).astype("float32"),
        "0.bias": rs.uniform(-0.1, 0.1, (80,)).astype("float32"),
        "1.weight": rs.uniform(-0.3, 0.3, (4, 80)).astype("float32"),
        "1.bias": rs.uniform(-0.1, 0.1, (4,)).astype("float32")})
    net.cast(dtype)
    return net


def _batch(dtype):
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.rand(16, 64).astype("float32"))
    return x.to(getattr(torch, dtype)), torch.from_numpy(
        rs.randint(0, 4, (16,)).astype("float32"))


THR = 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_with_compressed_store_matches_hand_compression(dtype):
    """Three Trainer steps with a compressed store attached against the
    same net whose gradients are compressed by hand (quantize with the
    carried residual, dequantize, cast) before a plain Trainer step:
    weights and pulled gradients bit for bit; only the 80 x 64 weight
    (5120 elements) is compressed."""
    x, y = _batch(dtype)
    loss_fn = SoftmaxCrossEntropyLoss()
    kv = mx.kv.create("local")
    kv.set_gradient_compression({"type": "2bit", "threshold": THR})
    net, ref = _net(dtype), _net(dtype)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", opt, kvstore=kv)
    rtr = mx.gluon.Trainer(ref.collect_params(), "sgd", opt)
    residual = None
    for _ in range(3):
        for n in (net, ref):
            with autograd.record():
                loss = loss_fn(n(x), y)
            loss.backward()
        g = ref[0].weight._grad_tensor()
        flat = g.reshape(-1)
        if residual is None:
            residual = torch.zeros_like(flat)
        words, residual = tc.quantize_2bit(flat, residual, THR)
        g.copy_(tc.dequantize_2bit(words, flat.numel(), THR)
                .reshape(g.shape).to(g.dtype))
        tr.step(16)
        rtr.step(16)
        p, r = (m._collect_params_with_prefix() for m in (net, ref))
        for k in p:
            assert torch.equal(p[k]._tensor(), r[k]._tensor()), k
            assert torch.equal(p[k]._grad_tensor(), r[k]._grad_tensor()), k
    idx = tr._param2idx[net[0].weight.name]
    assert list(kv._compression_residuals) == [idx]
    assert torch.equal(kv._compression_residuals[idx], residual)


@pytest.mark.parametrize("on", [False, True])
def test_trainer_pushes_every_gradient_at_once(on):
    """A step makes one push of every trainable key in parameter order and
    one pull (pushpull into the weights with update on kvstore)."""
    x, y = _batch("float32")
    kv = mx.kv.create("local")
    kv.set_gradient_compression({"type": "2bit", "threshold": THR})
    calls = []
    push, pull = kv.push, kv.pull
    kv.push = lambda key, value, priority=0: (
        calls.append(("push", list(key))), push(key, value, priority))
    kv.pull = lambda key, out=None, priority=0, ignore_sparse=True: (
        calls.append(("pull", list(key))), pull(key, out, priority))
    net = _net("float32")
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=kv,
                          update_on_kvstore=on)
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    tr.step(16)
    keys = [tr._param2idx[p.name] for p in tr._params]
    assert calls == [("push", keys), ("pull", keys)]


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_update_on_kvstore_equals_trainer_update(name):
    """Two compressed steps with update_on_kvstore=True (the store's copy
    of the optimizer updates, pull writes the weights) equal two with it
    False, bit for bit, from the same start."""
    x, y = _batch("bfloat16")
    loss_fn = SoftmaxCrossEntropyLoss()
    nets = []
    for on in (False, True):
        kv = mx.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": THR})
        net = _net("bfloat16")
        tr = mx.gluon.Trainer(net.collect_params(), name,
                              {"learning_rate": 0.01, "wd": 1e-4},
                              kvstore=kv, update_on_kvstore=on)
        for _ in range(2):
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(16)
        assert tr._update_on_kvstore is on
        if on:
            with pytest.raises(AssertionError):
                tr.update(16)
        nets.append(net)
    a, b = (n._collect_params_with_prefix() for n in nets)
    for k in a:
        assert torch.equal(a[k]._tensor(), b[k]._tensor()), k


def test_string_kvstores_ignore_compression_and_update_on_kvstore():
    """As in the JAX package: a kvstore string attaches no store, so
    compression_params and update_on_kvstore are ignored."""
    x, y = _batch("float32")
    loss_fn = SoftmaxCrossEntropyLoss()
    outs = []
    for kw in ({}, {"kvstore": "local", "update_on_kvstore": True,
                    "compression_params": {"type": "2bit"}},
               {"kvstore": None}, {"kvstore": "nccl"}):
        net = _net("float32")
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}, **kw)
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(16)
        assert tr._kvstore is None and tr._update_on_kvstore is False
        outs.append(net[0].weight._tensor().clone())
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_fused_step_falls_back_with_a_store():
    x, y = _batch("float32")
    net = _net("float32")
    net.hybridize()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1},
                          kvstore=mx.kv.create("local"))
    step = mx.gluon.train_step(net, SoftmaxCrossEntropyLoss(), tr)
    step(x, y)
    assert step.last_mode == "fallback:kvstore"


@pytest.mark.parametrize("on", [False, True])
def test_trainer_save_and_load_states(on, tmp_path):
    """save_states/load_states round trip (the store's states with update
    on kvstore): a trainer that loads continues exactly."""
    x, y = _batch("float32")
    loss_fn = SoftmaxCrossEntropyLoss()

    def trainer(net):
        return mx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.01},
                                kvstore=mx.kv.create("local"),
                                update_on_kvstore=on)

    def step(net, tr):
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(16)

    net = _net("float32")
    tr = trainer(net)
    step(net, tr)
    fname = str(tmp_path / "trainer")
    tr.save_states(fname)
    net2 = _net("float32")
    for k, p in net2._collect_params_with_prefix().items():
        p.set_data(net._collect_params_with_prefix()[k]._tensor().detach())
    tr2 = trainer(net2)
    tr2.load_states(fname)
    assert isinstance(tr2.optimizer, topt.Adam)
    assert tr2.optimizer.param_dict[0] is tr2._params[0]
    step(net, tr)
    step(net2, tr2)
    assert torch.equal(net[0].weight._tensor(), net2[0].weight._tensor())
