"""Tests of the PyTorch port that need a CUDA device: the hand-written
kernels against their plain PyTorch versions, and the served forward's
launch count. Each skips inside the test when no card is present.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.kernels import conv_fused as CF

# bf16: one bf16 rounding step of the output magnitude; f32: summation
# order only (TF32 off in the plain version's convolution).
RTOL = {"bfloat16": 1.6e-2, "float32": 1e-4}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _mats(N, H, W, Ci, Co, seed=0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(a).cuda() for a in (
        rs.randn(N, H, W, Ci).astype("float32"),
        (rs.rand(Ci) + 0.5).astype("float32"),
        (rs.randn(Ci) * 0.1).astype("float32"),
        (rs.randn(3, 3, Ci, Co) * 0.1).astype("float32"))]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(3, 8, 8, 16, 24), (4, 4, 4, 8, 8),
                                   (2, 7, 7, 24, 40), (2, 9, 13, 3, 5)])
def test_conv_fused_kernel_matches_plain(shape, dtype, relu):
    _need_card()
    x, s, b, w = _mats(*shape)
    dt = getattr(torch, dtype)
    x, w = x.to(dt), w.to(dt)
    before = CF.LAUNCHES
    out = CF.fused_scale_relu_conv3x3(x, s, b, w, relu=relu)
    ref = CF.fused_conv_reference(x, s, b, w, relu=relu)
    torch.cuda.synchronize()
    assert CF.LAUNCHES == before + 1
    assert out.dtype == ref.dtype == dt
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= RTOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_conv_fused_kernel_raises_on_non_contiguous_input():
    _need_card()
    x, s, b, w = _mats(2, 6, 6, 8, 8)
    with pytest.raises(ValueError):
        CF.fused_scale_relu_conv3x3(x.transpose(1, 2), s, b, w)


@pytest.mark.cuda
def test_fused_resnet_forward_launches_kernel_per_block():
    """A narrow fused ResNet on the card: one launch per bottleneck, and
    the logits agree with the unfused net in f32."""
    _need_card()
    x = torch.rand(2, 3, 32, 32, device="cuda")
    nets = []
    for fuse in (True, False):
        net = tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1],
                            [16, 32, 64, 128, 256], classes=10,
                            thumbnail=True, layout="NHWC", fuse=fuse)
        net.initialize(ctx=mx.gpu(0))
        net(x)
        nets.append(net)
    arrays = convert.random_numpy_params(convert.param_shapes(nets[0]))
    for net in nets:
        convert.load_numpy_params(net, arrays)
    before = CF.LAUNCHES
    out = nets[0](x)
    torch.cuda.synchronize()
    assert CF.LAUNCHES == before + 4
    ref = nets[1](x)
    assert (out - ref).abs().max().item() <= \
        1e-4 * ref.abs().max().item()
