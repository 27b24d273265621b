"""The port's packed multi-tensor optimizer apply
(mxnet_tpu_torch/kernels/optimizer_apply.py) and its bucket plan
(mxnet_tpu_torch/parallel/overlap.py) held against the JAX package's.

On the CPU ``packed_apply`` runs its plain version (the optimizer's own
``step_fn`` over each packed bucket), which is what the wrapper takes for a
CPU tensor; tests/test_torch_cuda.py holds the CUDA kernel against the
per-parameter chain on the card, bit for bit. The JAX side runs its
per-parameter ``step_fn`` under ``jax.jit`` and its ``packed_apply`` off the
TPU, i.e. its ``packed_apply_reference`` (not the interpret-mode kernel,
whose momentum case fails in the JAX suite itself).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.optimizer import optimizer as jopt
from mxnet_tpu.pallas_kernels import optimizer_apply as JOA
from mxnet_tpu.parallel import overlap as joverlap
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.kernels import optimizer_apply as OA
from mxnet_tpu_torch.parallel import overlap

# (shape, dtype): mixed dtypes in an order that splits buckets, sizes that
# are not whole 16-byte vectors
SPEC = [((64, 32), "float32"), ((32,), "float32"), ((32, 16), "bfloat16"),
        ((16,), "bfloat16"), ((7, 3), "float32"), ((5,), "bfloat16"),
        ((9, 9, 3), "float32")]


def _bits(t):
    t = t.detach()
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _case(momentum, seed=0, spec=SPEC):
    rs = np.random.RandomState(seed)
    arrays = []
    for shape, dt in spec:
        w = rs.randn(*shape).astype("float32")
        g = (rs.randn(*shape) * 3).astype("float32")
        m = rs.randn(*shape).astype("float32") if momentum else None
        arrays.append((w, g, m, dt))
    lrs = [0.05 + 0.01 * i for i in range(len(spec))]
    wds = [1e-4 * i for i in range(len(spec))]
    return arrays, lrs, wds


def _torch(arrays):
    ws, gs, ms = [], [], []
    for w, g, m, dt in arrays:
        d = getattr(torch, dt)              # copies: updates are in place
        ws.append(torch.from_numpy(w).to(d, copy=True))
        gs.append(torch.from_numpy(g).to(d, copy=True))
        ms.append(None if m is None else torch.from_numpy(m).to(d, copy=True))
    return ws, gs, ms


def _jax(arrays):
    ws, gs, ms = [], [], []
    for w, g, m, dt in arrays:
        d = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
        ws.append(jnp.asarray(w).astype(d))
        gs.append(jnp.asarray(g).astype(d))
        ms.append(None if m is None else jnp.asarray(m).astype(d))
    return ws, gs, ms


# -- the bucket plan ----------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 1024, 3000, 1 << 30])
def test_bucket_plan_matches_jax(cap):
    """The same size-capped, dtype-homogeneous, order-keeping plan as
    mxnet_tpu/parallel/overlap.py, for mixed shapes and dtypes."""
    arrays, _, _ = _case(0.0)
    ws, _, _ = _torch(arrays)
    jws, _, _ = _jax(arrays)
    plan = overlap.bucket_plan(ws, cap)
    assert plan == joverlap.bucket_plan(jws, cap)
    assert OA.bucketize(ws) == overlap.bucket_plan(ws)
    for bucket in plan:                        # the dtype split
        assert len({ws[i].dtype for i in bucket}) == 1


def test_default_bucket_bytes_reads_env(monkeypatch):
    monkeypatch.setenv("MXTPU_ELASTIC_BUCKET_MB", "0.5")
    assert overlap.default_bucket_bytes() == 1 << 19
    assert overlap.default_bucket_bytes() == joverlap.default_bucket_bytes()


# -- packed apply against the per-parameter chain ------------------------------

@pytest.mark.parametrize("cap_mb", ["4", "0.001"])
@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_packed_apply_equals_per_param_chain(momentum, clip, cap_mb,
                                             monkeypatch):
    """packed_apply (in place) equals the port's per-parameter step_fn
    chain bit for bit: f32 and bf16 buckets, a different lr and wd per
    parameter, and with a 1 KiB cap many more buckets."""
    monkeypatch.setenv("MXTPU_ELASTIC_BUCKET_MB", cap_mb)
    opt = topt.SGD(momentum=momentum, learning_rate=0.05, wd=1e-4,
                   clip_gradient=clip)
    arrays, lrs, wds = _case(momentum)
    ws, gs, ms = _torch(arrays)
    want = [opt.step_fn(w, g, m, lr, wd, 1.0 / 32)
            for w, g, m, lr, wd in zip(ws, gs, ms, lrs, wds)]
    nw, nm = OA.packed_apply(opt, ws, gs, ms, lrs, wds, 1.0 / 32)
    assert nw is ws and nm is ms              # updated in place
    for (w2, m2), w, m in zip(want, nw, nm):
        assert np.array_equal(_bits(w), _bits(w2))
        if momentum:
            assert np.array_equal(_bits(m), _bits(m2))


def _close_f32(got, want, *operands):
    """|got - want| within 2 f32 ulps of the largest magnitude among the
    result and the operands it was computed from."""
    scale = np.maximum.reduce([np.abs(np.asarray(a, np.float32))
                               for a in (want,) + operands])
    assert np.all(np.abs(got - np.asarray(want)) <= 2 * np.spacing(scale))


@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_packed_apply_matches_jax(momentum, clip):
    """Against the JAX package. Its per-parameter step_fn run op by op
    (scalars demoted to a bf16 weight's dtype, as its fused step does):
    bit for bit in f32 and bf16. Its per-parameter chain under jax.jit and
    its packed_apply (packed_apply_reference off the TPU, also jitted): bit
    for bit in bf16; in f32 XLA:CPU contracts ``momentum*m - lr*t`` into one
    FMA under jit (one rounding where PyTorch and the port's kernel round
    twice), which moves up to a quarter of the momentum values by an ulp,
    so f32 there is held within 2 ulps of the operands' magnitude."""
    kw = dict(momentum=momentum, learning_rate=0.05, wd=1e-4,
              clip_gradient=clip)
    opt, jo = topt.SGD(**kw), jopt.SGD(**kw)
    arrays, lrs, wds = _case(momentum, seed=1)
    ws, gs, ms = _torch(arrays)
    OA.packed_apply(opt, ws, gs, ms, lrs, wds, 1.0 / 32)
    jws, jgs, jms = _jax(arrays)
    jlrs = [jnp.float32(v) for v in lrs]
    jwds = [jnp.float32(v) for v in wds]
    rescale = jnp.float32(1.0 / 32)

    def perparam():
        outs = []
        for w, g, m, lr, wd in zip(jws, jgs, jms, jlrs, jwds):
            rs_ = rescale
            if w.dtype != jnp.float32:
                lr, wd, rs_ = (v.astype(w.dtype) for v in (lr, wd, rs_))
            outs.append(jo.step_fn(w, g, m, lr, wd, rs_))
        return outs

    def packed():
        return JOA.packed_apply(jo, jws, jgs, jms, jlrs, jwds, rescale)

    eager = perparam()
    jitted = jax.jit(perparam)()
    pw, pm = jax.jit(packed)()
    for i, (w, m) in enumerate(zip(ws, ms)):
        assert np.array_equal(_bits(w), _jbits(eager[i][0]))
        if momentum:
            assert np.array_equal(_bits(m), _jbits(eager[i][1]))
        pairs = [(w, jitted[i][0], pw[i])]
        if momentum:
            pairs.append((m, jitted[i][1], pm[i]))
        for got, *wants in pairs:
            for want in wants:
                if got.dtype == torch.bfloat16:
                    assert np.array_equal(_bits(got), _jbits(want))
                else:
                    _close_f32(got.numpy(), want, arrays[i][0],
                               *([] if m is None else [arrays[i][2]]))


def test_packed_apply_reference_is_step_fn_over_the_segment():
    """The plain version is the optimizer's step_fn on one flat segment
    with per-element lr and wd vectors."""
    opt = topt.SGD(momentum=0.9, learning_rate=0.1, wd=1e-3)
    rs = np.random.RandomState(2)
    w, g, m = (torch.from_numpy(rs.randn(40).astype("float32"))
               .bfloat16() for _ in range(3))
    lrv = torch.full((40,), 0.1)
    wdv = torch.full((40,), 1e-3)
    nw, nm = OA.packed_apply_reference(opt, w, g, m, lrv, wdv, 0.5)
    w2, m2 = opt.step_fn(w, g, m, 0.1, 1e-3, 0.5)
    assert torch.equal(nw, w2) and torch.equal(nm, m2)


# -- flags and refusals -------------------------------------------------------

def test_fused_apply_supported_flags():
    """True only for an optimizer whose packed math has a CUDA kernel:
    SGD, with or without momentum."""

    class NoPacked(topt.Optimizer):
        def step_fn(self, weight, grad, state, lr, wd, rescale):
            return weight - lr * grad, state

    assert topt.SGD().fused_apply_supported()
    assert topt.SGD(momentum=0.9).fused_apply_supported()
    assert not topt.Optimizer().fused_apply_supported()
    assert not NoPacked().fused_apply_supported()
    assert NoPacked().fused_step_supported()
    assert not topt.Optimizer().fused_step_supported()


@pytest.mark.parametrize("value,on", [(None, False), ("0", False),
                                      ("1", True), ("interpret", True)])
def test_enabled_reads_env(value, on, monkeypatch):
    if value is None:
        monkeypatch.delenv("MXTPU_FUSED_APPLY", raising=False)
    else:
        monkeypatch.setenv("MXTPU_FUSED_APPLY", value)
    assert OA.enabled() is on


@pytest.mark.parametrize("case", ["optimizer", "grad_shape", "state",
                                  "lengths", "meta"])
def test_packed_apply_refuses(case):
    opt = topt.SGD(momentum=0.9)
    ws = [torch.ones(4), torch.ones(3)]
    gs = [torch.ones(4), torch.ones(3)]
    ms = [torch.zeros(4), torch.zeros(3)]
    lrs, wds = [0.1, 0.1], [0.0, 0.0]
    err = ValueError
    if case == "optimizer":
        opt, err = topt.Optimizer(), MXNetError
    elif case == "grad_shape":
        gs[1] = torch.ones(2)
    elif case == "state":
        ms[0] = None
    elif case == "lengths":
        lrs = [0.1]
    else:
        ws, gs, ms = ([t.to("meta") for t in ts] for ts in (ws, gs, ms))
        err = MXNetError
    with pytest.raises(err):
        OA.packed_apply(opt, ws, gs, ms, lrs, wds, 1.0)
