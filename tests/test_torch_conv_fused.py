"""The port's fused BN->ReLU->conv3x3 (mxnet_tpu_torch/kernels/conv_fused.py)
held against the JAX package's (mxnet_tpu/pallas_kernels/conv_fused.py).

On the CPU the JAX side runs its Pallas kernel in interpret mode and its
jnp reference; the port runs its plain PyTorch version, which is what its
wrapper takes for a CPU tensor. The CUDA kernel itself runs only on the
card: tests/test_torch_cuda.py holds it against the plain version there
(``python3 chip_smoke.py`` does the same at the ResNet-50 shapes).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.pallas_kernels import conv_fused as JCF
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import conv_fused as CF

SHAPES = [(3, 8, 8, 16, 24), (4, 4, 4, 8, 8), (2, 7, 7, 24, 40)]
BF16_EPS = 2.0 ** -8   # one bf16 ulp relative to the value's magnitude


def _mats(N, H, W, Ci, Co, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, H, W, Ci).astype("float32")
    s = (rs.rand(Ci) + 0.5).astype("float32")
    b = (rs.randn(Ci) * 0.1).astype("float32")
    w = (rs.randn(3, 3, Ci, Co) * 0.1).astype("float32")
    return x, s, b, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_f32(shape, relu):
    """f32 at the JAX suite's own bound (tests/test_conv_fused.py: atol
    1e-5): against the Pallas kernel in interpret mode and against the jnp
    reference."""
    x, s, b, w = _mats(*shape)
    out = CF.fused_conv_reference(*_t(x, s, b, w), relu=relu).numpy()
    jx = [jnp.asarray(a) for a in (x, s, b, w)]
    pallas = JCF.fused_scale_relu_conv3x3(*jx, relu=relu, interpret=True)
    ref = JCF.fused_conv_reference(*jx, relu=relu)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_bf16(shape, relu):
    """bf16 in, bf16 out, activation in bf16: the two frameworks may round
    the final f32 sum differently by one bf16 step, so the bound is one
    bf16 ulp of the output's magnitude."""
    x, s, b, w = _mats(*shape, seed=1)
    xb = torch.from_numpy(x).bfloat16()
    out = CF.fused_conv_reference(xb, *_t(s, b, w), relu=relu)
    assert out.dtype == torch.bfloat16
    ref = JCF.fused_conv_reference(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s), jnp.asarray(b),
        jnp.asarray(w), relu=relu)
    ref = np.asarray(ref.astype(jnp.float32))
    diff = np.abs(out.float().numpy() - ref).max()
    assert diff <= BF16_EPS * np.abs(ref).max(), diff


def test_padding_is_zero_after_activation():
    """The halo is zero in activated space: with x = 0 and b > 0 every
    interior tap sees relu(b), but border pixels see fewer taps."""
    x = torch.zeros(1, 3, 3, 1)
    s, b = torch.ones(1), torch.ones(1)
    w = torch.ones(3, 3, 1, 1)
    out = CF.fused_scale_relu_conv3x3(x, s, b, w)[0, :, :, 0]
    expect = torch.tensor([[4.0, 6.0, 4.0], [6.0, 9.0, 6.0],
                           [4.0, 6.0, 4.0]])
    assert torch.equal(out, expect)


def test_cpu_tensor_takes_plain_version():
    x, s, b, w = _t(*_mats(2, 5, 6, 8, 16))
    before = CF.LAUNCHES
    out = CF.fused_scale_relu_conv3x3(x, s, b, w)
    assert CF.LAUNCHES == before
    assert torch.equal(out, CF.fused_conv_reference(x, s, b, w))


@pytest.mark.parametrize("dtype,cdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.bfloat16), (torch.float64, torch.float32)])
def test_compute_dtype(dtype, cdt):
    """Other half types promote to bf16 and wider floats to f32, as the
    JAX module's _compute_dtype does; the result keeps x's dtype."""
    assert CF.compute_dtype(dtype) == cdt
    x, s, b, w = _t(*_mats(1, 4, 4, 8, 8))
    assert CF.fused_scale_relu_conv3x3(x.to(dtype), s, b, w).dtype == dtype


@pytest.mark.parametrize("case", ["int_x", "w5x5", "w_ci", "s_len",
                                  "x3d", "meta"])
def test_wrapper_raises_on_what_it_does_not_take(case):
    x, s, b, w = _t(*_mats(1, 4, 4, 8, 8))
    if case == "int_x":
        x, err = x.to(torch.int32), TypeError
    elif case == "w5x5":
        w, err = torch.zeros(5, 5, 8, 8), ValueError
    elif case == "w_ci":
        w, err = torch.zeros(3, 3, 4, 8), ValueError
    elif case == "s_len":
        s, err = torch.ones(7), ValueError
    elif case == "x3d":
        x, err = x[0], ValueError
    else:
        x, s, b, w = (t.to("meta") for t in (x, s, b, w))
        err = MXNetError
    with pytest.raises(err):
        CF.fused_scale_relu_conv3x3(x, s, b, w)
