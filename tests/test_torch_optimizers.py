"""The port's optimizers (mxnet_tpu_torch/optimizer/optimizer.py) held
against the JAX package's (mxnet_tpu/optimizer/optimizer.py) on the CPU.

Every registered optimizer and ``Test`` takes five ``update`` calls on f32
weights of three shapes, from the same weights and gradients drawn with
numpy, with ``wd``, ``rescale_grad`` and ``clip_gradient`` set where the
optimizer takes them. SGD and Adam keep their bitwise contract in bf16 (in
f32 XLA:CPU contracts their chains into FMAs under jit: within
F32_JIT_ULPS of each tensor's largest magnitude, as in
test_torch_adam.py). Every other optimizer: weights and states within
RTOL of each tensor's largest magnitude after every update. SGLD's noise
comes from the port's generator, which JAX cannot reproduce, so it is held
against a numpy restatement of its update fed the same noise.
"""
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.optimizer import optimizer as jopt
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

# every optimizer but SGD and Adam, f32: within this much of each tensor's
# largest magnitude (the chains differ from XLA's in FMA contraction and in
# reduction order, a few ulps that the updates carry forward)
RTOL = 1e-5
# SGD and Adam in f32, under jax.jit: FMA contraction
F32_JIT_ULPS = 4
# bf16 weights cast from f32 masters that agree within RTOL: one bf16 ulp
# of the tensor's largest magnitude
BF16_RTOL = 2.0 ** -8

SHAPES = [(4, 5), (7,), (2, 3, 4)]
NAMES = {0: "dense0_weight", 1: "dense0_bias", 2: "conv0_weight"}
COMMON = dict(wd=1e-3, rescale_grad=0.5, clip_gradient=0.8)

# (name, hyperparameters): each optimizer with its own knobs set away from
# their defaults where that reaches another branch
CASES = [
    ("test", dict(rescale_grad=0.5)),
    ("sgd", dict(COMMON, learning_rate=0.1, momentum=0.9)),
    ("sgd", dict(COMMON, learning_rate=0.1)),
    ("signum", dict(COMMON, learning_rate=0.01, momentum=0.9, wd_lh=1e-3)),
    ("signum", dict(COMMON, learning_rate=0.01, momentum=0.0, wd_lh=1e-3)),
    ("ftml", dict(COMMON, learning_rate=0.05)),
    ("lars", dict(COMMON, learning_rate=0.1, momentum=0.9, lars_eta=0.01,
                  lars_epsilon=1e-8, param_idx2name=NAMES)),
    ("lars", dict(COMMON, learning_rate=0.1, lars_eta=0.01,
                  momentum_correction=False, param_idx2name=NAMES)),
    ("lbsgd", dict(COMMON, learning_rate=0.1, momentum=0.9, batch_scale=4,
                   warmup_epochs=1, updates_per_epoch=8)),
    ("lbsgd", dict(COMMON, learning_rate=0.1, warmup_strategy="lars")),
    ("dcasgd", dict(COMMON, learning_rate=0.1, momentum=0.9)),
    ("dcasgd", dict(COMMON, learning_rate=0.1)),
    ("adam", dict(COMMON, learning_rate=0.01)),
    ("adamw", dict(COMMON, learning_rate=0.01)),
    ("adagrad", dict(COMMON, learning_rate=0.1)),
    ("adadelta", dict(COMMON)),
    ("rmsprop", dict(COMMON, learning_rate=0.01, clip_weights=1.5)),
    ("rmsprop", dict(COMMON, learning_rate=0.01, centered=True)),
    ("adamax", dict(COMMON, learning_rate=0.01)),
    ("nadam", dict(COMMON, learning_rate=0.01)),
    ("ftrl", dict(COMMON, learning_rate=0.1, lamda1=0.05)),
    ("nag", dict(COMMON, learning_rate=0.1, momentum=0.9)),
    ("nag", dict(COMMON, learning_rate=0.1)),
    ("lamb", dict(COMMON, learning_rate=0.01, lower_bound=0.5,
                  upper_bound=3.0)),
    ("lamb", dict(COMMON, learning_rate=0.01, bias_correction=False)),
]


def _ids(cases):
    return ["%s-%d" % (c[0], i) for i, c in enumerate(cases)]


def _weights(seed=0, dtype="float32"):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(dtype) for s in SHAPES]


def _grads(step, dtype="float32"):
    rs = np.random.RandomState(100 + step)
    return [(rs.randn(*s) * 2).astype(dtype) for s in SHAPES]


def _leaves(st):
    """A state's tensors in order (None skipped), as numpy."""
    if st is None:
        return []
    if isinstance(st, (tuple, list)):
        return [a for s in st for a in _leaves(s)]
    if isinstance(st, NDArray):
        return [st.asnumpy()]
    if isinstance(st, torch.Tensor):
        return [st.detach().float().numpy()]
    return [np.asarray(st, dtype="float32")]


def _torch(a, dtype="float32"):
    return torch.from_numpy(np.array(a, dtype="float32")).to(
        getattr(torch, dtype))


def _jax(a, dtype="float32"):
    return NDArray(jnp.asarray(np.array(a, dtype="float32")).astype(dtype))


def _run_both(name, kw, dtype="float32", steps=5, check=None):
    """``steps`` rounds of update_multi_precision over the three weights in
    both packages; ``check(t_weights, t_states, j_weights, j_states)``
    after every round."""
    to, jo = topt.create(name, **kw), jopt.create(name, **kw)
    tws = [_torch(w, dtype) for w in _weights()]
    jws = [_jax(w, dtype) for w in _weights()]
    tst = [to.create_state_multi_precision(i, w) for i, w in enumerate(tws)]
    jst = [jo.create_state_multi_precision(i, w) for i, w in enumerate(jws)]
    for step in range(steps):
        for i, g in enumerate(_grads(step)):
            to.update_multi_precision(i, tws[i], _torch(g, dtype), tst[i])
            jo.update_multi_precision(i, jws[i], _jax(g, dtype), jst[i])
        check(tws, tst, jws, jst)
    assert to.num_update == jo.num_update == (0 if name == "test"
                                              else steps)
    return to, jo


def _within(t, j, rtol):
    t, j = np.asarray(t, "float32"), np.asarray(j, "float32")
    assert t.shape == j.shape
    scale = max(float(np.abs(j).max()), 1e-30)
    err = float(np.abs(t - j).max())
    assert err <= rtol * scale, (err, scale)


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(t)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("name,kw", CASES, ids=_ids(CASES))
def test_update_matches_jax_f32(name, kw):
    """Five updates of f32 weights of three shapes: every weight and state
    tensor within RTOL (SGD, Adam: F32_JIT_ULPS) of its largest magnitude
    after every update."""
    def check(tws, tst, jws, jst):
        for tw, ts, jw, js in zip(tws, tst, jws, jst):
            for t, j in zip([tw.detach().numpy()] + _leaves(ts),
                            [jw.asnumpy()] + _leaves(js)):
                if name in ("sgd", "adam"):
                    scale = max(float(np.abs(j).max()), 1e-30)
                    assert np.abs(t - j).max() <= F32_JIT_ULPS * np.spacing(
                        np.float32(scale))
                else:
                    _within(t, j, RTOL)
    _run_both(name, kw, check=check)


@pytest.mark.parametrize("name,kw", [c for c in CASES
                                     if c[0] in ("sgd", "adam")],
                         ids=_ids([c for c in CASES
                                   if c[0] in ("sgd", "adam")]))
def test_sgd_and_adam_stay_bitwise_in_bf16(name, kw):
    """SGD and Adam in bf16 without master copies: every weight and state
    equal to JAX's bit for bit after every update (their contract)."""
    def check(tws, tst, jws, jst):
        for tw, ts, jw, js in zip(tws, tst, jws, jst):
            assert np.array_equal(_bits(tw), _bits(jw._data))
            flat = [ts] if isinstance(ts, torch.Tensor) else \
                [s for s in (ts or ()) if s is not None]
            jflat = [js] if isinstance(js, NDArray) else \
                [s for s in (js or ()) if s is not None]
            for t, j in zip(flat, jflat):
                assert np.array_equal(_bits(t), _bits(j._data))
    _run_both(name, kw, dtype="bfloat16", check=check)


@pytest.mark.parametrize("name,kw", [c for c in CASES if c[0] != "test"],
                         ids=_ids([c for c in CASES if c[0] != "test"]))
def test_multi_precision_bf16_matches_jax(name, kw):
    """bf16 weights with ``multi_precision=True``: each f32 master and
    state within RTOL of JAX's (SGD, Adam: F32_JIT_ULPS), the bf16 weight
    within BF16_RTOL of its largest magnitude, after every update (Test
    steps no master copy)."""

    def check(tws, tst, jws, jst):
        for tw, ts, jw, js in zip(tws, tst, jws, jst):
            assert tw.dtype == torch.bfloat16
            _within(tw.float().numpy(), jw.asnumpy(), BF16_RTOL)
            for t, j in zip(_leaves(ts), _leaves(js)):
                if name in ("sgd", "adam"):
                    scale = max(float(np.abs(j).max()), 1e-30)
                    assert np.abs(t - j).max() <= F32_JIT_ULPS * np.spacing(
                        np.float32(scale))
                else:
                    _within(t, j, RTOL)
    _run_both(name, dict(kw, multi_precision=True), dtype="bfloat16",
              check=check)


@pytest.mark.parametrize("wd,clip", [(0.0, None), (1e-2, 0.8)])
def test_sgld_matches_numpy_restatement(wd, clip):
    """SGLD's five updates against the reference's formula restated in
    numpy, float64, with the noise the port drew (the port's generator
    reseeded): w - lr/2 * (clip(rescale * g) + wd * w) + sqrt(lr) * noise,
    within RTOL of the largest weight."""
    lr, rescale = 0.01, 0.5
    mx.random.seed(7)
    opt = topt.create("sgld", learning_rate=lr, wd=wd, rescale_grad=rescale,
                      clip_gradient=clip)
    tws = [_torch(w) for w in _weights()]
    want = [w.astype("float64") for w in _weights()]
    gen = torch.Generator().manual_seed(7)
    for step in range(5):
        for i, g in enumerate(_grads(step)):
            opt.update(i, tws[i], _torch(g), None)
            noise = torch.randn(SHAPES[i], generator=gen,
                                dtype=torch.float32).numpy()
            gg = g.astype("float64") * rescale
            if clip is not None:
                gg = np.clip(gg, -clip, clip)
            want[i] = want[i] - lr / 2 * (gg + wd * want[i]) \
                + np.sqrt(lr) * noise
    for t, w in zip(tws, want):
        _within(t.numpy(), w, RTOL)
    assert opt.num_update == 5


def test_registry_and_states():
    """The port registers the JAX package's optimizers, each creates the
    state structure JAX's creates (None, one tensor, or a tuple with
    None where JAX has None), and SGD takes lazy_update."""
    want = {"sgd", "signum", "ftml", "lars", "lbsgd", "dcasgd", "sgld",
            "adam", "adamw", "adagrad", "adadelta", "rmsprop", "adamax",
            "nadam", "ftrl", "nag", "lamb", "test"}
    # (the JAX registry also holds contrib's SVRG, not a core optimizer)
    assert set(topt.opt_registry) == want
    assert want <= set(jopt.Optimizer.opt_registry)

    def shape_of(st):
        if st is None:
            return None
        if isinstance(st, (tuple, list)):
            return tuple(shape_of(s) for s in st)
        return "tensor"
    for name, kw in CASES + [("sgld", {}), ("dcasgd", {})]:
        to, jo = topt.create(name, **kw), jopt.create(name, **kw)
        st = to.create_state(0, torch.zeros(3, 2))
        js = jo.create_state(0, NDArray(jnp.zeros((3, 2))))
        assert shape_of(st) == shape_of(js), name
    assert topt.SGD(lazy_update=False).lazy_update is False
    assert topt.optimizer.ccSGD is topt.SGD


def test_lr_and_wd_mult_by_index_and_name():
    """set_lr_mult/set_wd_mult by index and by name (param_idx2name), and
    param_dict's multipliers first: the same lrs and wds as JAX's."""
    names = {0: "fc_weight", 1: "fc_bias", 2: "bn_gamma", 3: "bn_beta",
             4: "other"}

    class P:
        def __init__(self, lr_mult, wd_mult):
            self.lr_mult, self.wd_mult = lr_mult, wd_mult
    for pd in (None, {4: P(0.25, 3.0)}):
        to = topt.SGD(learning_rate=0.1, wd=0.01, param_idx2name=names,
                      param_dict=pd)
        jo = jopt.SGD(learning_rate=0.1, wd=0.01, param_idx2name=names,
                      param_dict=pd)
        for o in (to, jo):
            o.set_lr_mult({0: 2.0, "fc_bias": 0.5, "bn_gamma": 3.0})
            o.set_wd_mult({"fc_weight": 0.5, 3: 2.0})
        idx = list(range(6))
        assert to._get_lrs(idx) == jo._get_lrs(idx)
        assert to._get_wds(idx) == jo._get_wds(idx)
        assert [to._get_lr(i) for i in idx] == [jo._get_lr(i) for i in idx]
        assert [to._get_wd(i) for i in idx] == [jo._get_wd(i) for i in idx]
    assert to._get_wd(1) == 0.0            # a bias takes no weight decay


def test_begin_num_update_and_contexts():
    """begin_num_update starts every index's count; set_current_context
    keeps a count table per device id (as JAX's)."""
    to = topt.SGD(begin_num_update=10)
    jo = jopt.SGD(begin_num_update=10)
    for o in (to, jo):
        o._update_count(0)
        o.set_current_context(1)
        o._update_count([0, 1])
        o.set_current_context(0)
        o._update_count(1)
    assert to._all_index_update_counts == jo._all_index_update_counts
    assert to.num_update == jo.num_update == 11


def _tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _tree_equal(u, v) for u, v in zip(a, b))
    return a is None and b is None


@pytest.mark.parametrize("name,kw", [
    ("dcasgd", dict(momentum=0.0)), ("ftml", {}),
    ("rmsprop", dict(centered=True)), ("adadelta", {}),
    ("sgd", dict(momentum=0.9, multi_precision=True)),
    ("lamb", dict(multi_precision=True))])
def test_updater_states_round_trip(name, kw):
    """Updater.get_states/set_states (with and without the optimizer) carry
    the new state structures (a None inside a tuple, three tensors, an f32
    master beside bf16 weights) and training goes on from them with the
    same bits."""
    dtype = torch.bfloat16 if kw.get("multi_precision") else torch.float32
    u = topt.get_updater(topt.create(name, learning_rate=0.05, **kw))
    ws = [_torch(w).to(dtype) for w in _weights()]
    for step in range(2):
        u(list(range(3)), [_torch(g).to(dtype) for g in _grads(step)], ws)
    for dump in (False, True):
        blob = u.get_states(dump_optimizer=dump)
        v = topt.get_updater(topt.create(name, learning_rate=0.05, **kw))
        v.set_states(blob)
        if dump:
            assert type(v.optimizer) is type(u.optimizer)
            assert v.optimizer.num_update == u.optimizer.num_update
        for i in range(3):
            assert _tree_equal(v.states[i], u.states[i]), i
    # both go on: the restored one with the restored optimizer's counts
    v = topt.get_updater(topt.create(name, learning_rate=0.05, **kw))
    v.set_states(u.get_states(dump_optimizer=True))
    ws2 = [w.clone() for w in ws]
    g = [_torch(x).to(dtype) for x in _grads(5)]
    u(list(range(3)), g, ws)
    v(list(range(3)), [x.clone() for x in g], ws2)
    assert all(torch.equal(a, b) for a, b in zip(ws, ws2))
    pickle.loads(pickle.dumps(u.optimizer))


def _dense_net():
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, in_units=8, activation="relu"))
    net.add(mx.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    rs = np.random.RandomState(1)
    mx.convert.load_numpy_params(net, {
        "0.weight": rs.uniform(-0.5, 0.5, (16, 8)).astype("float32"),
        "0.bias": rs.uniform(-0.1, 0.1, (16,)).astype("float32"),
        "1.weight": rs.uniform(-0.5, 0.5, (4, 16)).astype("float32"),
        "1.bias": rs.uniform(-0.1, 0.1, (4,)).astype("float32")})
    net.hybridize()
    return net


@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("name,kw", [
    ("adagrad", dict(learning_rate=0.1, wd=1e-3, clip_gradient=0.8)),
    ("rmsprop", dict(learning_rate=0.01, wd=1e-3, clip_weights=1.5)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_gradient=0.8)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("nag", dict(learning_rate=0.1))])
def test_fused_step_takes_adagrad_rmsprop_nag(name, kw, mp, monkeypatch):
    """gluon.train_step with AdaGrad, RMSProp or NAG runs fused (their pure
    step_fn, no "optimizer:<Name>" fallback) and equals the eager
    record/backward/Trainer.step triple bit for bit after three steps:
    weights, gradients, states and update counts (bf16 with f32 masters
    under multi_precision)."""
    monkeypatch.setenv("MXTPU_FUSED_APPLY", "1")
    dtype = torch.bfloat16 if mp else torch.float32
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(8, 8).astype("float32")).to(dtype)
    y = torch.from_numpy(rs.randint(0, 4, (8,)).astype("float32"))
    runs = {}
    for mode in ("eager", "fused"):
        net = _dense_net()
        net.cast(dtype)
        tr = mx.gluon.Trainer(net.collect_params(), name,
                              dict(kw, multi_precision=mp))
        loss_fn = SoftmaxCrossEntropyLoss()
        step = mx.gluon.train_step(net, loss_fn, tr)
        assert tr._optimizer.fused_step_supported()
        for _ in range(3):
            if mode == "eager":
                with autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                tr.step(8)
            else:
                step(x, y)
                assert step.last_mode == "fused"
        runs[mode] = (net, tr)
    (en, et), (fn, ft) = runs["eager"], runs["fused"]
    ep, fp = en._collect_params_with_prefix(), fn._collect_params_with_prefix()
    for k in ep:
        assert torch.equal(ep[k].data(), fp[k].data()), k
        assert torch.equal(ep[k].grad(), fp[k].grad()), k
    for i, st in et._updater.states.items():
        assert _tree_equal(ft._updater.states[i], st), i
    assert et._optimizer.num_update == ft._optimizer.num_update == 3
