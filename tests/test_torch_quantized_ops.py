"""The port's int8 quantized operator family (mxnet_tpu_torch/ops/quantized.py)
held against the JAX package's registered ops (mxnet_tpu/ops/quantized.py).

The same inputs, drawn with numpy from fixed seeds, go through
``mxnet_tpu.ops.registry.get_op(name).fn`` and the port's op of the same
name. ``MXTPU_QUANT_MATMUL=interpret`` makes the JAX side's FC and 1x1
convolution run its Pallas kernel in interpret mode; its other
convolutions run XLA's int32 convolution, where the port runs an int8
im2col and its int8 product. Integer sums are exact and every float step is
the same IEEE operation in both, so payloads and ranges must be equal bit
for bit. bf16 data takes JAX's type promotion at each quantize step (an f32
range promotes it to f32, a Python range rounds to bf16, a bf16 range
keeps the step in bf16), so bf16 codes and ranges are equal bit for bit
too.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import quantized as TQ
from mxnet_tpu_torch.ops import registry as treg


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_QUANT_MATMUL", "interpret")


def _i8(shape, seed, lo=-127, hi=128):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int8)


def _f32(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _to_jax(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _to_torch(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _run(name, args, kwargs=None):
    kwargs = kwargs or {}
    ref = jreg.get_op(name).fn(*[_to_jax(a) for a in args], **kwargs)
    out = treg.get_op(name).fn(*[_to_torch(a) for a in args], **kwargs)
    return ref, out


def _assert_same(ref, out):
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        o = o.detach().cpu().numpy() if isinstance(o, torch.Tensor) \
            else np.asarray(o)
        r = np.asarray(r)
        assert o.shape == r.shape, (o.shape, r.shape)
        assert o.dtype == r.dtype, (o.dtype, r.dtype)
        np.testing.assert_array_equal(_bits(o), _bits(r))


@pytest.mark.parametrize("ranges", [(-2.5, 3.0), (-0.5, 0.25),
                                    (np.float32(-1.3), np.float32(0.7))])
def test_quantize_v1(ranges):
    x = _f32((4, 5, 6), 0, 1.5)
    mn = np.asarray([ranges[0]], np.float32)
    mx_ = np.asarray([ranges[1]], np.float32)
    _assert_same(*_run("_contrib_quantize", [x, mn, mx_]))


@pytest.mark.parametrize("calib", [None, (-1.75, 2.25), (-0.3, 0.3)])
def test_quantize_v2(calib):
    x = _f32((3, 7, 5), 1, 1.2)
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}
    _assert_same(*_run("_contrib_quantize_v2", [x], kw))


@pytest.mark.parametrize("calib", [None, (-0.02, 0.03)])
def test_requantize(calib):
    rs = np.random.RandomState(2)
    acc = rs.randint(-2 ** 24, 2 ** 24, (6, 10)).astype(np.int32)
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}
    _assert_same(*_run("_contrib_requantize", [acc, -4.0, 3.0], kw))


def test_act_and_flatten():
    q = _i8((2, 3, 4, 4), 3)
    _assert_same(*_run("_contrib_quantized_act", [q, -1.0, 1.0]))
    _assert_same(*_run("_contrib_quantized_flatten", [q, -1.0, 1.0]))


@pytest.mark.parametrize("kw", [
    dict(kernel=(2, 2), pool_type="max", stride=(2, 2)),
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), pool_type="avg", stride=(1, 1), pad=(1, 1)),
    dict(kernel=(2, 3), pool_type="avg", stride=(2, 1)),
    dict(pool_type="avg", global_pool=True),
    dict(pool_type="max", global_pool=True),
], ids=["max2", "max3pad", "avg3pad", "avg2x3", "avg_global", "max_global"])
def test_pooling(kw):
    """Negative windows floor-divide (not truncate); padding never wins a
    max and counts in an average."""
    q = _i8((2, 3, 7, 6), 4, lo=-128)
    q[0, 0] = -128
    _assert_same(*_run("_contrib_quantized_pooling", [q, -1.0, 1.0], kw))


@pytest.mark.parametrize("fill", [None, 127, -127])
def test_elemwise_add(fill):
    lhs, rhs = _i8((3, 8), 5), _i8((3, 8), 6)
    if fill is not None:    # the sum lands on the int32 range's edge
        lhs[:] = fill
        rhs[:] = fill
    _assert_same(*_run("_contrib_quantized_elemwise_add",
                       [lhs, rhs, -0.8, 1.2, -1.2, 0.6]))
    _assert_same(*_run("_contrib_quantized_elemwise_add",
                       [lhs, rhs, -1.0, 1.0, -1.0, 1.0]))


def test_concat():
    a, b, c = _i8((2, 3, 4), 7), _i8((2, 5, 4), 8), _i8((2, 1, 4), 9)
    args = [a, b, c, -0.5, 0.5, -2.0, 1.5, -0.1, 0.3]
    _assert_same(*_run("_contrib_quantized_concat", args, {"dim": 1}))


@pytest.mark.parametrize("calib", [None, (-3.0, 3.5)])
def test_batch_norm(calib):
    q = _i8((2, 4, 5, 5), 10)
    gamma = (np.random.RandomState(11).rand(4) + 0.5).astype(np.float32)
    beta = _f32((4,), 12, 0.1)
    mean = _f32((4,), 13, 0.1)
    var = (np.random.RandomState(14).rand(4) + 0.5).astype(np.float32)
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}
    _assert_same(*_run("_contrib_quantized_batch_norm",
                       [q, gamma, beta, mean, var, -1.5, 2.0], kw))


@pytest.mark.parametrize("bias,flatten", [(True, True), (False, True),
                                          (True, False)])
def test_fully_connected(bias, flatten):
    data = _i8((4, 3, 2, 8), 15) if flatten else _i8((4, 5, 48), 15)
    weight = _i8((24, 48), 16)
    b = _i8((24,), 17) if bias else None
    args = [data, weight, b, -1.0, 1.5, -0.25, 0.2,
            -0.05 if bias else None, 0.04 if bias else None]
    _assert_same(*_run("_contrib_quantized_fully_connected", args,
                       {"num_hidden": 24, "no_bias": not bias,
                        "flatten": flatten}))


def test_fully_connected_int32_payload():
    """A payload that is not int8 takes the generic integer product (XLA's
    int32 dot in JAX; int64 summed and wrapped on the CPU here)."""
    data = np.random.RandomState(26).randint(-300, 300, (5, 12)) \
        .astype(np.int32)
    weight = _i8((7, 12), 27)
    _assert_same(*_run("_contrib_quantized_fully_connected",
                       [data, weight, None, -1.0, 1.0, -0.5, 0.5, None,
                        None], {"num_hidden": 7, "no_bias": True}))


CONVS = {
    "1x1": dict(kernel=(1, 1)),
    "3x3_s2_p1": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    "3x3_d2": dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2)),
    "7x7_s2_p3": dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3)),
    "1x1_s2": dict(kernel=(1, 1), stride=(2, 2)),
}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv(name, bias):
    kw = dict(CONVS[name])
    ci = 3 if name.startswith("7x7") else 16
    data = _i8((2, ci, 11, 9), 18, lo=-128)
    weight = _i8((24, ci) + kw["kernel"], 19)
    b = _i8((24,), 20) if bias else None
    kw.update(num_filter=24, no_bias=not bias)
    args = [data, weight, b, -1.0, 1.0, -0.3, 0.3,
            -0.02 if bias else None, 0.02 if bias else None]
    _assert_same(*_run("_contrib_quantized_conv", args, kw))


def test_grouped_conv():
    kw = dict(kernel=(3, 3), pad=(1, 1), num_filter=8, num_group=2,
              no_bias=True)
    args = [_i8((2, 6, 5, 5), 21), _i8((8, 3, 3, 3), 22), None, -1.0, 1.0,
            -0.5, 0.5, None, None]
    _assert_same(*_run("_contrib_quantized_conv", args, kw))


def test_calibrate_entropy():
    a = np.random.RandomState(23).randn(20000)
    hist, edges = np.histogram(a, bins=1001, range=(-5, 5))
    _assert_same(*_run("_contrib_calibrate_entropy", [hist, edges]))


def test_im2col_matches_unfold():
    """The int8 im2col's tap-major column order, with K padded, against
    torch's float unfold (a relabelling of the same window entries)."""
    x = _i8((2, 5, 9, 7), 24)
    cols, (n, ho, wo) = TQ.im2col(torch.from_numpy(x), (3, 2), (2, 1),
                                  (1, 0), (1, 2), align=16)
    k = 3 * 2 * 5
    assert cols.shape == (n * ho * wo, 32) and cols.dtype == torch.int8
    assert bool((cols[:, k:] == 0).all())
    ref = torch.nn.functional.unfold(torch.from_numpy(x).float(), (3, 2),
                                     dilation=(1, 2), padding=(1, 0),
                                     stride=(2, 1))       # (n, C*kh*kw, L)
    ref = ref.reshape(n, 5, 6, ho * wo).permute(0, 3, 2, 1).reshape(-1, k)
    np.testing.assert_array_equal(cols[:, :k].float().numpy(), ref.numpy())


def test_nd_contrib_names():
    """Every registered ``_contrib_X`` op is ``nd.contrib.X``, and the
    port registers the JAX package's quantized family under its names."""
    names = [n for n in treg.list_ops() if n.startswith("_contrib_")]
    assert names
    for n in names:
        assert callable(getattr(mx.nd.contrib, n[len("_contrib_"):]))
    jax_family = {n for n in jreg.list_ops()
                  if jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops.quantized"}
    assert jax_family and jax_family <= set(treg.list_ops())
    q = torch.from_numpy(_i8((2, 3), 25))
    out = mx.nd.contrib.quantized_act(q, -1.0, 1.0)
    assert bool((out[0] >= 0).all())
    assert mx.nd.contrib.quantize is mx.contrib.quantization.quantize


# -- bf16 data: JAX's type promotion at each quantize step ------------------

def _bf16_pair(a):
    """The same bf16 values for both packages (numpy float32 rounded once)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _typed(v):
    """(dtype name, float32 bits) of a JAX or torch output."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", ""), _bits(
            v.detach().float().numpy() if v.is_floating_point()
            else v.numpy())
    v = jnp.asarray(v)
    return str(v.dtype), _bits(np.asarray(v.astype(jnp.float32)
                                          if jnp.issubdtype(v.dtype,
                                                            jnp.floating)
                                          else v))


def _assert_same_typed(ref, out):
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        (rd, rb), (od, ob) = _typed(r), _typed(o)
        assert od == rd, (od, rd)
        assert ob.shape == rb.shape
        np.testing.assert_array_equal(ob, rb)


_BF16_RANGES = {
    "f32_vector": lambda a, b: (np.asarray([a], np.float32),
                                np.asarray([b], np.float32)),
    "f32_scalar": lambda a, b: (np.asarray(a, np.float32),
                                np.asarray(b, np.float32)),
    "python": lambda a, b: (a, b),
    "bf16_vector": lambda a, b: tuple(_bf16_pair(np.asarray([v], np.float32))
                                      for v in (a, b)),
}


def _pair_arg(v, side):
    return v[side] if isinstance(v, tuple) else v


@pytest.mark.parametrize("kind", sorted(_BF16_RANGES))
@pytest.mark.parametrize("ranges", [(-2.5, 3.0), (-0.3, 0.7)])
def test_quantize_v1_bf16(kind, ranges):
    """bf16 data: an f32 range promotes the division to f32, a Python one
    rounds to bf16 and a bf16 one keeps it in bf16, as JAX types them."""
    xj, xt = _bf16_pair(_f32((64, 256), 30, 1.5))
    mn, mx_ = _BF16_RANGES[kind](*ranges)
    ref = jreg.get_op("_contrib_quantize").fn(
        xj, *[_to_jax(_pair_arg(v, 0)) for v in (mn, mx_)])
    out = treg.get_op("_contrib_quantize").fn(
        xt, *[_to_torch(_pair_arg(v, 1)) for v in (mn, mx_)])
    _assert_same_typed(ref, out)


@pytest.mark.parametrize("calib", [None, (-1.75, 2.25), (-0.3, 0.3)])
def test_quantize_v2_bf16(calib):
    """Without calibration the range is the data's own bf16 min and max;
    with it, the calibrated range is a weak float32 scalar."""
    xj, xt = _bf16_pair(_f32((64, 256), 31, 1.2))
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}
    ref = jreg.get_op("_contrib_quantize_v2").fn(xj, **kw)
    out = treg.get_op("_contrib_quantize_v2").fn(xt, **kw)
    _assert_same_typed(ref, out)


@pytest.mark.parametrize("calib", [None, (-0.02, 0.03)])
@pytest.mark.parametrize("kind", ["python", "bf16_vector"])
def test_requantize_bf16_ranges(kind, calib):
    acc = np.random.RandomState(32).randint(-2 ** 24, 2 ** 24, (64, 64)) \
        .astype(np.int32)
    mn, mx_ = _BF16_RANGES[kind](-4.0, 3.0)
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}
    ref = jreg.get_op("_contrib_requantize").fn(
        jnp.asarray(acc), *[_to_jax(_pair_arg(v, 0)) for v in (mn, mx_)],
        **kw)
    out = treg.get_op("_contrib_requantize").fn(
        torch.from_numpy(acc), *[_to_torch(_pair_arg(v, 1))
                                 for v in (mn, mx_)], **kw)
    _assert_same_typed(ref, out)
