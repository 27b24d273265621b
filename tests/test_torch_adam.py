"""The port's Adam (mxnet_tpu_torch/optimizer/optimizer.py) and its packed
apply (mxnet_tpu_torch/kernels/optimizer_apply.py) held against the JAX
package's (mxnet_tpu/optimizer/optimizer.py ``Adam``,
mxnet_tpu/pallas_kernels/optimizer_apply.py).

The same weights, gradients and states, drawn with numpy from fixed seeds,
go through both. ``Adam.step_fn`` run op by op equals JAX's unjitted
``step_fn`` bit for bit in bf16 and f32, with weight decay and clipping, at
update counts 1 and 10 (the bias-corrected rate of ``step_lr``).
``Adam.update`` equals JAX's jitted ``update`` bit for bit in bf16; in f32
XLA:CPU contracts the chain into FMAs under jit, one rounding where the
port rounds twice, so f32 is held within 4 ulps of each tensor's largest
magnitude there. The packed apply (on the CPU its plain version, the
optimizer's ``step_fn`` over each bucket) equals JAX's
``packed_apply_reference`` and the per-parameter chain bit for bit, and
``gluon.train_step`` with Adam equals the eager step. The CUDA kernel is
held against the plain version on the card (``chip_smoke.py`` phase
``kernel``, ``tests/test_torch_cuda.py``).
"""
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.optimizer import optimizer as jopt
from mxnet_tpu.pallas_kernels import optimizer_apply as JOA
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.kernels import optimizer_apply as OA

# f32 under jax.jit: FMA contraction, held within this many ulps of each
# tensor's largest magnitude
F32_JIT_ULPS = 4

SPEC = [((64, 32), "float32"), ((32,), "float32"), ((32, 16), "bfloat16"),
        ((16,), "bfloat16"), ((7, 3), "float32"), ((5,), "bfloat16"),
        ((9, 9, 3), "float32")]


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(t)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _pair(a, dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    t = torch.from_numpy(a).to(getattr(torch, dtype), copy=True)
    # a copy: JAX may share a numpy buffer, and the port updates in place
    return t, jnp.asarray(t.float().numpy().copy()).astype(dtype)


def _arrays(shape, seed):
    rs = np.random.RandomState(seed)
    w = rs.randn(*shape).astype("float32")
    g = (rs.randn(*shape) * 3).astype("float32")
    return w, g


def _opts(**kw):
    return topt.create("adam", **kw), jopt.create("adam", **kw)


def _assert_same(t, j):
    assert np.array_equal(_bits(t), _bits(j))


def _close_f32(t, j):
    t, j = t.detach().numpy(), np.asarray(j)
    scale = max(float(np.abs(j).max()), 1e-30)
    assert np.all(np.abs(t - j) <= F32_JIT_ULPS * np.spacing(
        np.float32(scale)))


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("wd,clip", [(0.0, None), (1e-4, None),
                                     (1e-2, 0.5)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_step_fn_matches_jax_unjitted(dtype, wd, clip, steps):
    """``steps`` updates through ``step_fn``, op by op in both packages,
    with lr from ``step_lr`` (the bias correction at each update count):
    weight, m and v bit for bit after every update."""
    kw = dict(learning_rate=1e-2, wd=wd, clip_gradient=clip,
              rescale_grad=1.0 / 16)
    to, jo = _opts(**kw)
    w, _ = _arrays((64, 48), 3)
    tw, jw = _pair(w, dtype)
    tm, tv = to.create_state(0, tw)
    jm, jv = (jnp.zeros_like(jw), jnp.zeros_like(jw))
    for i in range(steps):
        tg, jg = _pair(_arrays((64, 48), 10 + i)[1], dtype)
        to._update_count(0)
        jo._update_count(0)
        lr = to.step_lr(0)
        assert lr == jo.step_lr(0)
        with torch.no_grad():
            tw, (tm, tv) = to.step_fn(tw, tg, (tm, tv), lr, wd, 1.0 / 16)
        jw, (jm, jv) = jo.step_fn(jw, jg, (jm, jv), lr, wd, 1.0 / 16)
        for t, j in ((tw, jw), (tm, jm), (tv, jv)):
            assert t.dtype == getattr(torch, dtype)
            _assert_same(t, j)


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_update_matches_jax_jitted(dtype, clip):
    """Ten updates through ``update`` (JAX jits its chain): bit for bit in
    bf16; f32 within F32_JIT_ULPS (FMA contraction under jit)."""
    kw = dict(learning_rate=1e-2, wd=1e-4, clip_gradient=clip,
              rescale_grad=1.0 / 16)
    to, jo = _opts(**kw)
    w, _ = _arrays((4096,), 4)
    tw, jw0 = _pair(w, dtype)
    jw = NDArray(jw0)
    ts = to.create_state(0, tw)
    js = jo.create_state(0, jw)
    for i in range(10):
        tg, jg = _pair(_arrays((4096,), 20 + i)[1], dtype)
        to.update(0, tw, tg, ts)
        jo.update(0, jw, NDArray(jg), js)
        for t, j in ((tw, jw), (ts[0], js[0]), (ts[1], js[1])):
            if dtype == "bfloat16":
                _assert_same(t, j._data)
            else:
                _close_f32(t, j._data)
    assert to.num_update == jo.num_update == 10


def _case(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for shape, dt in SPEC:
        w = rs.randn(*shape).astype("float32")
        g = (rs.randn(*shape) * 3).astype("float32")
        m = (rs.randn(*shape) * 0.1).astype("float32")
        v = (rs.rand(*shape) * 0.01).astype("float32")
        out.append((w, g, m, v, dt))
    lrs = [1e-3 * (1 + i % 3) for i in range(len(SPEC))]
    wds = [1e-4 * (i % 2) for i in range(len(SPEC))]
    return out, lrs, wds


@pytest.mark.parametrize("clip", [None, 0.5])
def test_packed_apply_matches_jax_and_chain(clip):
    """The packed Adam apply over mixed bf16/f32 buckets, against JAX's
    packed_apply (its packed_apply_reference off the TPU, run eagerly), its
    per-parameter step_fn and the port's own per-parameter chain: bit for
    bit."""
    kw = dict(learning_rate=1e-3, wd=1e-4, clip_gradient=clip)
    to, jo = _opts(**kw)
    arrays, lrs, wds = _case(1)
    ts = [[_pair(a, dt)[0] for a in (w, g, m, v)]
          for w, g, m, v, dt in arrays]
    js = [[_pair(a, dt)[1] for a in (w, g, m, v)]
          for w, g, m, v, dt in arrays]
    chain = [to.step_fn(w, g, (m, v), lr, wd, 1.0 / 32)
             for (w, g, m, v), lr, wd in zip(ts, lrs, wds)]
    ws = [t[0] for t in ts]
    states = [(t[2], t[3]) for t in ts]
    OA.packed_apply(to, ws, [t[1] for t in ts], states, lrs, wds, 1.0 / 32)
    jws, jst = JOA.packed_apply(
        jo, [j[0] for j in js], [j[1] for j in js],
        [(j[2], j[3]) for j in js], [jnp.float32(v) for v in lrs],
        [jnp.float32(v) for v in wds], jnp.float32(1.0 / 32))
    for i in range(len(SPEC)):
        _assert_same(ws[i], jws[i])
        _assert_same(ws[i], chain[i][0])
        for k in range(2):
            _assert_same(states[i][k], jst[i][k])
            _assert_same(states[i][k], chain[i][1][k])


def test_fused_apply_supported_and_arity():
    assert topt.Adam().fused_apply_supported()
    assert topt.Adam().fused_step_supported()
    w = torch.zeros(3)
    with pytest.raises(ValueError):       # Adam's state is (m, v)
        OA.packed_apply(topt.Adam(), [w], [w.clone()], [w.clone()], [0.1],
                        [0.0], 1.0)


def _net(dtype):
    rs = np.random.RandomState(1)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, in_units=8, activation="relu"))
    net.add(mx.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    mx.convert.load_numpy_params(net, {
        "0.weight": rs.uniform(-0.5, 0.5, (16, 8)).astype("float32"),
        "0.bias": rs.uniform(-0.1, 0.1, (16,)).astype("float32"),
        "1.weight": rs.uniform(-0.5, 0.5, (4, 16)).astype("float32"),
        "1.bias": rs.uniform(-0.1, 0.1, (4,)).astype("float32")})
    net.cast(dtype)
    net.hybridize()
    return net


def _train(mode, dtype, steps=3):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(8, 8).astype("float32")) \
        .to(getattr(torch, dtype))
    y = torch.from_numpy(rs.randint(0, 4, (8,)).astype("float32"))
    net = _net(dtype)
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 1e-2, "wd": 1e-4})
    loss_fn = SoftmaxCrossEntropyLoss()
    step = mx.gluon.train_step(net, loss_fn, tr)
    for _ in range(steps):
        if mode == "eager":
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(8)
        else:
            step(x, y)
            assert step.last_mode == "fused"
    return net, tr


@pytest.mark.parametrize("apply", ["0", "1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_adam_matches_eager(dtype, apply, monkeypatch):
    """gluon.train_step with Adam (packed apply on or off) against the
    eager record/backward/Trainer.step: weights, gradients, (m, v) and the
    update counts bit for bit after three steps, every step "fused"."""
    enet, etr = _train("eager", dtype)
    monkeypatch.setenv("MXTPU_FUSED_APPLY", apply)
    fnet, ftr = _train("fused", dtype)
    ep, fp = (n._collect_params_with_prefix() for n in (enet, fnet))
    for k in ep:
        assert torch.equal(ep[k]._tensor(), fp[k]._tensor()), k
        assert torch.equal(ep[k]._grad_tensor(), fp[k]._grad_tensor()), k
    # each Trainer indexes its parameters in the order of their full
    # names, which hang on the process's block counters ("dense9" sorts
    # after "dense10"), so the states are matched by structural key
    eidx = {id(p): i for i, p in enumerate(etr._params)}
    fidx = {id(p): i for i, p in enumerate(ftr._params)}
    for k in ep:
        m, v = etr._updater.states[eidx[id(ep[k])]]
        fm, fv = ftr._updater.states[fidx[id(fp[k])]]
        assert torch.equal(m, fm) and torch.equal(v, fv), k
    assert ftr._optimizer.num_update == etr._optimizer.num_update == 3


def test_packed_apply_selects_adam_states(monkeypatch):
    """With MXTPU_FUSED_APPLY=1 every Adam parameter goes through one
    packed launch per bucket (on the CPU, its plain version)."""
    monkeypatch.setenv("MXTPU_FUSED_APPLY", "1")
    from mxnet_tpu_torch.gluon.fused_step import FusedTrainStep
    select = FusedTrainStep._packed_apply_fn(topt.Adam())
    ws = [torch.zeros(3), torch.zeros(2), torch.zeros(2)]
    states = [(torch.zeros(3), torch.zeros(3)),
              (torch.zeros(2), torch.zeros(2)),
              (torch.zeros(2, dtype=torch.float64), torch.zeros(2))]
    assert select(ws, states) == [0, 1]


def test_adam_pickles_and_states_round_trip():
    """An optimizer pickles with its parameters' multipliers only; the
    updater's states survive get_states/set_states bit for bit, bf16
    included, and move to the weight's device at first use."""
    net = _net("float32")
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 1e-2})
    tr._optimizer.param_dict[0].lr_mult = 0.5
    copy = pickle.loads(pickle.dumps(tr._optimizer))
    assert isinstance(copy, topt.Adam) and copy.beta2 == 0.999
    assert copy._get_lr(0) == 0.5 * 1e-2 and copy._get_lr(1) == 1e-2
    up = topt.get_updater(topt.Adam())
    w = torch.ones(5, dtype=torch.bfloat16)
    up(0, torch.full((5,), 0.25, dtype=torch.bfloat16), w)
    blob = up.get_states(dump_optimizer=True)
    up2 = topt.get_updater(topt.Adam())
    up2.set_states(blob)
    assert up2.optimizer.num_update == 1
    m, v = up2.ensure_state(0, w)
    assert m.dtype == torch.bfloat16 and torch.equal(m, up.states[0][0])
    assert torch.equal(v, up.states[0][1])
