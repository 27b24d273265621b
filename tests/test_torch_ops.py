"""The port's ops (mxnet_tpu_torch/ops) held against the JAX package's
(mxnet_tpu/ops) on the same numpy inputs, in float32 on the CPU.

Convolutions and matmuls may sum in another order in the two frameworks,
so those compare at rtol/atol 1e-5. The BatchNorm inference chain is
built from correctly rounded ops after its inverse standard deviation, so
that part is compared bitwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import elemwise as jel
from mxnet_tpu.ops import tensor as jtensor
from mxnet_tpu.pallas_kernels import batchnorm_fused as jbnf
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import batchnorm_fused as bnf
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import tensor as ttensor

F = mx.nd


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype("float32")


def _close(port, ref, tol=1e-5):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)) \
        .view(np.uint32)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("kernel,stride,pad", [
    ((3, 3), (1, 1), (1, 1)),      # bottleneck 3x3
    ((3, 3), (2, 2), (1, 1)),      # strided 3x3
    ((7, 7), (2, 2), (3, 3)),      # ResNet stem
    ((1, 1), (2, 2), (0, 0)),      # NHWC: the matmul branch, stride = slice
    ((1, 1), (1, 1), (0, 0)),
])
def test_convolution(layout, kernel, stride, pad):
    ci, co = 6, 10
    x = _rand(2, 9, 11, ci) if layout == "NHWC" else _rand(2, ci, 9, 11)
    w = _rand(co, ci, *kernel, seed=1, scale=0.2)
    bias = _rand(co, seed=2)
    kw = dict(kernel=kernel, stride=stride, pad=pad, num_filter=co,
              layout=layout)
    for bb in (None, bias):
        out = tnn.convolution(torch.from_numpy(x), torch.from_numpy(w),
                              None if bb is None else torch.from_numpy(bb),
                              no_bias=bb is None, **kw)
        ref = jnn.convolution(jnp.asarray(x), jnp.asarray(w),
                              None if bb is None else jnp.asarray(bb),
                              no_bias=bb is None, **kw)
        assert tuple(out.shape) == tuple(ref.shape)
        _close(out, ref)


def test_convolution_rejects_kernel_mismatch():
    with pytest.raises(ValueError):
        tnn.convolution(torch.zeros(1, 4, 4, 2), torch.zeros(3, 2, 3, 3),
                        kernel=(1, 1), layout="NHWC")


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="max"),
    dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
         pooling_convention="full"),
    dict(global_pool=True, pool_type="avg"),
    dict(global_pool=True, pool_type="max"),
])
def test_pooling(layout, kw):
    """Windowed max pooling with -inf padding, and the global pools."""
    x = _rand(2, 9, 10, 3) if layout == "NHWC" else _rand(2, 3, 9, 10)
    out = tnn.pooling(torch.from_numpy(x), layout=layout, **kw)
    ref = jnn.pooling(jnp.asarray(x), layout=layout, **kw)
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref)


@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected(flatten):
    x = _rand(4, 3, 5)
    in_units = 15 if flatten else 5
    w = _rand(7, in_units, seed=1)
    b = _rand(7, seed=2)
    out = tnn.fully_connected(*map(torch.from_numpy, (x, w, b)),
                              num_hidden=7, flatten=flatten)
    ref = jnn.fully_connected(*map(jnp.asarray, (x, w, b)), num_hidden=7,
                              flatten=flatten)
    _close(out, ref)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation(act):
    x = _rand(3, 17, scale=3.0)
    _close(tnn.activation(torch.from_numpy(x), act_type=act),
           jnn.activation(jnp.asarray(x), act_type=act), tol=1e-6)


@pytest.mark.parametrize("axis,temperature", [(-1, None), (1, None),
                                              (-1, 2.0)])
def test_softmax(axis, temperature):
    x = _rand(4, 6, 5, scale=4.0)
    _close(tnn.softmax(torch.from_numpy(x), axis=axis,
                       temperature=temperature),
           jnn.softmax(jnp.asarray(x), axis=axis, temperature=temperature),
           tol=1e-6)


def _bn_inputs(c, seed=0):
    rs = np.random.RandomState(seed)
    return ((rs.rand(c) + 0.5).astype("float32"),
            (rs.randn(c) * 0.1).astype("float32"),
            (rs.randn(c) * 0.1).astype("float32"),
            rs.uniform(0.5, 2.0, c).astype("float32"))


def _xla_inv_std(var, eps):
    """The JAX package's inverse standard deviation as XLA:CPU computes
    it: ``1.0 / jnp.sqrt`` is rewritten into XLA's ``rsqrt``."""
    return np.array(jax.jit(lambda v, e: 1.0 / jnp.sqrt(v + e))(
        var, jnp.float32(eps)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis,fix_gamma", [(-1, False), (1, False),
                                            (-1, True)])
def test_batch_norm_inference_chain_bitwise(axis, fix_gamma, dtype):
    """Given the same inverse standard deviation, the normalize chain
    (exact_mul, then one add, then the cast) equals the JAX op bit for
    bit: every op in it is correctly rounded in both frameworks."""
    x = _rand(2, 5, 6, 8, scale=3.0)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    c = x.shape[axis]
    g, beta, mean, var = _bn_inputs(c)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref, _, _ = jnn.batch_norm(jx, *map(jnp.asarray, (g, beta, mean, var)),
                               eps=1e-5, fix_gamma=fix_gamma, axis=axis,
                               _training=False)
    gg = np.ones_like(g) if fix_gamma else g
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = tnn.bn_apply(tx, torch.from_numpy(mean),
                       torch.from_numpy(_xla_inv_std(var, 1e-5)),
                       torch.from_numpy(gg), torch.from_numpy(beta),
                       axis % x.ndim)
    assert out.dtype == tx.dtype
    assert np.array_equal(_bits(out.float().numpy()),
                          _bits(np.asarray(ref.astype(jnp.float32))))


@pytest.mark.parametrize("axis,fix_gamma", [(-1, False), (1, False),
                                            (-1, True)])
def test_batch_norm_inference_matches_jax(axis, fix_gamma):
    """The whole op. The port takes 1/sqrt as two IEEE ops (the same bits
    on the CPU and the card); XLA:CPU rewrites the JAX package's
    ``1.0 / jnp.sqrt`` into its own rsqrt. Measured on these inputs the
    two inverse standard deviations differ by at most 2 ulp, so each
    output may differ by 2^-21 of its terms (|x-mean|*|inv*gamma| +
    |beta|); everything after the inverse is bitwise (test above)."""
    x = _rand(2, 5, 6, 8, scale=3.0)
    c = x.shape[axis]
    g, beta, mean, var = _bn_inputs(c)
    out, m, v = tnn.batch_norm(*map(torch.from_numpy, (x, g, beta, mean,
                                                       var)),
                               eps=1e-5, fix_gamma=fix_gamma, axis=axis,
                               _training=False)
    ref, _, _ = jnn.batch_norm(*map(jnp.asarray, (x, g, beta, mean, var)),
                               eps=1e-5, fix_gamma=fix_gamma, axis=axis,
                               _training=False)
    inv = tnn.bn_inv_std(torch.from_numpy(var), 1e-5).numpy()
    inv_ulp = np.abs(inv.view(np.int32).astype(np.int64)
                     - _xla_inv_std(var, 1e-5).view(np.int32)).max()
    assert inv_ulp <= 2, inv_ulp
    shape = [1] * x.ndim
    shape[axis] = c
    gg = np.ones_like(g) if fix_gamma else g
    terms = np.abs(x - mean.reshape(shape)) * (inv * gg).reshape(shape) \
        + np.abs(beta).reshape(shape)
    assert np.all(np.abs(out.numpy() - np.asarray(ref)) <= 2.0 ** -21 * terms)
    assert torch.equal(m, torch.from_numpy(mean))
    assert torch.equal(v, torch.from_numpy(var))


def test_unported_pooling_raises():
    with pytest.raises(NotImplementedError):
        tnn.pooling(torch.zeros(1, 4, 4, 2), kernel=(2, 2),
                    pool_type="avg", layout="NHWC")


def test_batch_norm_training_mode_is_not_ported():
    """Training mode is ported now: it normalizes with the batch
    statistics and returns them, leaving the running ones alone."""
    x = torch.from_numpy(_rand(6, 3, scale=2.0) + 5.0)
    rm, rv = torch.zeros(3), torch.ones(3)
    out, mean, var = tnn.batch_norm(x, torch.ones(3), torch.zeros(3), rm, rv,
                                    axis=1, eps=1e-5, _training=True)
    assert torch.allclose(mean, x.mean(0), atol=1e-5)
    assert torch.allclose(var, x.var(0, unbiased=False), atol=1e-4)
    assert torch.allclose(out.mean(0), torch.zeros(3), atol=1e-5)
    assert torch.equal(rm, torch.zeros(3)) and torch.equal(rv, torch.ones(3))


def test_exact_mul_bitwise():
    rs = np.random.RandomState(5)
    a = (rs.randn(1000) * 10.0 ** rs.randint(-8, 8, 1000)).astype("float32")
    b = (rs.randn(1000) * 10.0 ** rs.randint(-8, 8, 1000)).astype("float32")
    a[:4] = [np.inf, -np.inf, np.nan, 0.0]
    out = bnf.exact_mul(torch.from_numpy(a), torch.from_numpy(b))
    ref = jbnf.exact_mul(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(_bits(out.numpy()), _bits(ref))


def test_exact_mul_broadcasts():
    a = _rand(3, 4, 5)
    b = _rand(1, 1, 5, seed=1)
    out = bnf.exact_mul(torch.from_numpy(a), torch.from_numpy(b))
    ref = jbnf.exact_mul(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("name,args,kwargs", [
    ("transpose", ((2, 3, 4, 5),), {"axes": (0, 2, 3, 1)}),
    ("transpose", ((2, 3, 4),), {}),
    ("reshape", ((2, 3, 4),), {"shape": (0, -1)}),
    ("reshape", ((2, 3, 4),), {"shape": (6, 4)}),
    ("flatten", ((2, 3, 4),), {}),
    ("ones_like", ((2, 3),), {}),
])
def test_tensor_ops(name, args, kwargs):
    x = _rand(*args[0])
    out = getattr(ttensor, name)(torch.from_numpy(x), **kwargs)
    ref = getattr(jtensor, name)(jnp.asarray(x), **kwargs)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cast(dtype):
    x = _rand(3, 4, scale=100.0)
    out = ttensor.cast(torch.from_numpy(x), dtype=dtype)
    ref = jtensor.cast(jnp.asarray(x), dtype=dtype)
    assert str(out.dtype) == "torch." + dtype
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_rsqrt_and_add():
    x = np.abs(_rand(100)) + 0.1
    _close(F.rsqrt(torch.from_numpy(x)), jel.rsqrt(jnp.asarray(x)),
           tol=1e-6)
    y = _rand(100, seed=1)
    _close(F.elemwise_add(torch.from_numpy(x), torch.from_numpy(y)),
           jnp.asarray(x) + jnp.asarray(y), tol=0)


def test_namespace_dispatch_supplies_training_flag():
    """F.BatchNorm gets _training from autograd like the JAX wrappers."""
    args = [torch.zeros(2, 3), torch.ones(3), torch.zeros(3),
            torch.zeros(3), torch.ones(3)]
    out, mean, _ = F.BatchNorm(*args, eps=1e-5)   # predict mode
    assert tuple(out.shape) == (2, 3)
    assert mean is args[3]                  # the running statistics
    args[0] = torch.arange(6.0).reshape(2, 3)
    with mx.autograd.train_mode():
        _, mean, _ = F.BatchNorm(*args, eps=1e-5)
    assert torch.equal(mean, torch.tensor([1.5, 2.5, 3.5]))  # the batch's
    for name in ("Convolution", "Pooling", "FullyConnected", "Activation",
                 "softmax", "BatchNorm", "transpose", "cast", "ones_like",
                 "flatten", "rsqrt", "elemwise_add"):
        assert callable(getattr(F, name)), name
