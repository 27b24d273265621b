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
from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
from mxnet_tpu_torch.kernels import conv_fused as CF
from mxnet_tpu_torch.kernels import flash_attention as FA
from mxnet_tpu_torch.kernels import quantized_matmul as QM
from mxnet_tpu_torch.contrib import quantization as Q
from mxnet_tpu_torch.parallel import transformer as T

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
@pytest.mark.parametrize("n_sm", [None, 5])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(4, 56, 56, 64, 64), (8, 28, 28, 128, 128),
                                   (8, 7, 7, 512, 512), (2, 7, 7, 136, 72),
                                   (4, 15, 17, 40, 129)])
def test_conv_fused_fwd_bf16_relaunch_same_bits(shape, relu, n_sm,
                                                monkeypatch):
    """The bf16 forward kernel gives the same bits on a second launch,
    within one bf16 step of the plain version, also planned for a card of 5
    SMs, where each persistent block walks several work items (several x
    chunks, co blocks of 64 and 128, resident weights at 64 x 64)."""
    _need_card()
    if n_sm is not None:
        monkeypatch.setattr(CF, "_sm_count", lambda dev: n_sm)
    x, s, b, w = _mats(*shape)
    x, w = x.bfloat16(), w.bfloat16()
    before = CF.LAUNCHES
    got = CF.fused_scale_relu_conv3x3(x, s, b, w, relu=relu)
    again = CF.fused_scale_relu_conv3x3(x, s, b, w, relu=relu)
    want = CF.fused_conv_reference(x, s, b, w, relu=relu)
    torch.cuda.synchronize()
    assert CF.LAUNCHES == before + 2
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    err = (got.float() - want.float()).abs().max().item()
    assert err <= RTOL["bfloat16"] * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "misaligned"])
def test_conv_fused_fwd_bf16_pads_through_the_wrapper(case):
    """Ci and Co that are not multiples of 8 (the wrapper pads x, s, b and
    w with zeros and cuts the result back), and an x whose base lies 2
    bytes off 16-byte alignment (the wrapper copies it): within one bf16
    step of the plain version."""
    _need_card()
    shape = (3, 10, 11, 20, 70) if case == "ragged" else (2, 9, 9, 64, 72)
    x, s, b, w = _mats(*shape)
    x, w = x.bfloat16(), w.bfloat16()
    if case == "misaligned":
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        x = buf[1:].view(x.shape).copy_(x)
        assert x.data_ptr() % 16
    out = CF.fused_scale_relu_conv3x3(x, s, b, w)
    ref = CF.fused_conv_reference(x, s, b, w)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= RTOL["bfloat16"] * ref.float().abs().max().item(), err


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


def _same_bits(a, b):
    """Bit equality of two float tensors, any NaN matching any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    nan = torch.isnan(a.float())
    if not torch.equal(nan, torch.isnan(b.float())):
        return False
    ia = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)
    ib = b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32)
    return bool(torch.equal(ia[~nan], ib[~nan]))


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 7, 9, 64), (3, 5, 5, 129)])
def test_batchnorm_kernels_match_plain(shape, dtype, act):
    """The four training-BatchNorm kernels against their plain versions:
    out, mean and var bit for bit; dx, dgamma, dbeta within 2e-4 of the
    largest reference magnitude."""
    _need_card()
    rs = np.random.RandomState(0)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rs.randn(*shape).astype("float32") * 2 + 1) \
        .cuda().to(dt)
    c = shape[-1]
    g = torch.from_numpy((rs.rand(c) + 0.5).astype("float32")).cuda()
    b = torch.from_numpy((rs.randn(c) * 0.1).astype("float32")).cuda()
    dy = torch.from_numpy(rs.randn(*shape).astype("float32")).cuda().to(dt)
    counts = (BNF.LAUNCHES_STATS, BNF.LAUNCHES_APPLY,
              BNF.LAUNCHES_BWD_REDUCE, BNF.LAUNCHES_BWD_DX)
    xr, gr, br = (t.clone().requires_grad_() for t in (x, g, b))
    out, mean, var = BNF.fused_batch_norm(xr, gr, br, act=act)
    out.backward(dy)
    torch.cuda.synchronize()
    assert (BNF.LAUNCHES_STATS, BNF.LAUNCHES_APPLY, BNF.LAUNCHES_BWD_REDUCE,
            BNF.LAUNCHES_BWD_DX) == tuple(n + 1 for n in counts)
    ref, rmean, rvar = BNF.batchnorm_reference(x, g, b, act=act)
    assert _same_bits(out, ref)
    assert _same_bits(mean, rmean) and _same_bits(var, rvar)
    grads = BNF.batchnorm_backward_reference(x, g, b, rmean, rvar, dy,
                                             act=act)
    for got, want in zip((xr.grad, gr.grad, br.grad), grads):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-4 * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_narrow_resnet_trains_on_the_card():
    """Two f32 steps of a narrow NHWC ResNet on the card match the port on
    the CPU (TF32 off), and every BatchNorm ran its kernels."""
    _need_card()
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    x = torch.rand(4, 3, 16, 16)
    y = torch.randint(0, 10, (4,)).float()
    nets, losses = [], []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1],
                            [16, 32, 64, 128, 256], classes=10,
                            thumbnail=True, layout="NHWC", fuse=False)
        net.initialize(ctx=ctx)
        net(x.to(ctx.device))
        nets.append(net)
    arrays = convert.random_numpy_params(convert.param_shapes(nets[0]))
    before = BNF.LAUNCHES_STATS
    for net, ctx in zip(nets, (mx.gpu(0), mx.cpu())):
        convert.load_numpy_params(net, arrays)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.01, "momentum": 0.9})
        for _ in range(2):
            with autograd.record():
                loss = SoftmaxCrossEntropyLoss()(net(x.to(ctx.device)),
                                                 y.to(ctx.device))
            loss.backward()
            trainer.step(4)
        losses.append(loss.detach().cpu())
    assert BNF.LAUNCHES_STATS == before + 2 * 16     # 16 BNs, 2 steps
    assert torch.allclose(losses[0], losses[1], rtol=1e-5)
    for (k, p), q in zip(nets[0]._collect_params_with_prefix().items(),
                         nets[1]._collect_params_with_prefix().values()):
        w, wr = p._tensor().detach().cpu(), q._tensor().detach()
        assert (w - wr).abs().max() <= 1e-5 * wr.abs().max(), k


# -- the conv_fused backward pair and the packed optimizer apply --------------

# Backward tolerances relative to max |reference|: bf16 outputs one bf16
# rounding step, as the forward; f32 dx summation order only; f32 dw, ds and
# db are sums over every pixel of the batch.
BWD_RTOL = {"bfloat16": {"dx": 1.6e-2, "ds": 1.6e-2, "db": 1.6e-2,
                         "dw": 1.6e-2},
            "float32": {"dx": 1e-4, "ds": 1e-3, "db": 1e-3, "dw": 1e-3}}


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(3, 8, 8, 16, 24), (2, 9, 13, 3, 5),
                                   (4, 15, 17, 40, 129)])
def test_conv_fused_backward_kernels_match_plain(shape, dtype, relu):
    """The d-input and d-weight kernels (with their finalize and reduce
    launches) against the plain backward, one launch each."""
    _need_card()
    x, s, b, w = _mats(*shape)
    dt = getattr(torch, dtype)
    x, w = x.to(dt), w.to(dt)
    dy = torch.randn(shape[:3] + (shape[4],), device="cuda").to(dt)
    before = (CF.LAUNCHES_BWD_DX, CF.LAUNCHES_BWD_DW, CF.LAUNCHES_FINALIZE,
              CF.LAUNCHES_REDUCE)
    got = CF.fused_conv_backward(x, s, b, w, dy, relu=relu)
    want = CF.fused_conv_backward_reference(x, s, b, w, dy, relu=relu)
    torch.cuda.synchronize()
    assert (CF.LAUNCHES_BWD_DX, CF.LAUNCHES_BWD_DW, CF.LAUNCHES_FINALIZE,
            CF.LAUNCHES_REDUCE) == tuple(n + 1 for n in before)
    for name, g, r in zip(("dx", "ds", "db", "dw"), got, want):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        err = (g.float() - r.float()).abs().max().item()
        assert err <= BWD_RTOL[dtype][name] * r.float().abs().max().item(), \
            (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("n_sm", [None, 5])
@pytest.mark.parametrize("shape", [(8, 28, 28, 128, 128),
                                   (4, 15, 17, 40, 129)])
def test_conv_fused_dw_bf16_relaunch_same_bits(shape, n_sm, monkeypatch):
    """The bf16 d-weight kernel gives the same bits on a second launch,
    within one bf16 step of the plain version, also planned for a card of 5
    SMs, where each persistent block walks several work items."""
    _need_card()
    if n_sm is not None:
        monkeypatch.setattr(CF, "_sm_count", lambda dev: n_sm)
    x, s, b, w = _mats(*shape)
    x, w = x.bfloat16(), w.bfloat16()
    dy = torch.randn(shape[:3] + (shape[4],), device="cuda").bfloat16()
    got = CF.fused_conv_backward(x, s, b, w, dy)[3]
    again = CF.fused_conv_backward(x, s, b, w, dy)[3]
    want = CF.backward_weight_reference(x, s, b, w, dy)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BWD_RTOL["bfloat16"]["dw"] * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n_sm", [None, 5])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(8, 28, 28, 128, 128), (8, 7, 7, 512, 512),
                                   (4, 15, 17, 40, 129)])
def test_conv_fused_dx_bf16_relaunch_same_bits(shape, relu, n_sm,
                                               monkeypatch):
    """The bf16 d-input kernel and its finalize give dx, ds and db the same
    bits on a second launch, within one bf16 step of the plain version,
    also planned for a card of 5 SMs, where each persistent block walks
    several work items."""
    _need_card()
    if n_sm is not None:
        monkeypatch.setattr(CF, "_sm_count", lambda dev: n_sm)
    x, s, b, w = _mats(*shape)
    x, w = x.bfloat16(), w.bfloat16()
    dy = torch.randn(shape[:3] + (shape[4],), device="cuda").bfloat16()
    got = CF.fused_conv_backward(x, s, b, w, dy, relu=relu)[:3]
    again = CF.fused_conv_backward(x, s, b, w, dy, relu=relu)[:3]
    want = CF.backward_input_reference(x, s, b, w, dy, relu=relu)
    torch.cuda.synchronize()
    for name, g, a, r in zip(("dx", "ds", "db"), got, again, want):
        assert torch.equal(g.view(torch.int16 if g.dtype == torch.bfloat16
                                  else torch.int32),
                           a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32)), name
        err = (g.float() - r.float()).abs().max().item()
        assert err <= BWD_RTOL["bfloat16"][name] * \
            r.float().abs().max().item(), (name, err)


@pytest.mark.cuda
def test_conv_fused_autograd_on_the_card():
    """Gradients through the autograd Function on the card match the CPU's
    plain backward (f32, TF32 off); a non-contiguous dy is copied and
    counted."""
    _need_card()
    x, s, b, w = _mats(2, 6, 7, 16, 24)
    dy = torch.randn(2, 7, 6, 24, device="cuda").transpose(1, 2)
    leaves = [t.clone().requires_grad_() for t in (x, s, b, w)]
    copies = CF.COPIES
    CF.fused_scale_relu_conv3x3(*leaves).backward(dy)
    torch.cuda.synchronize()
    assert CF.COPIES == copies + 1
    want = CF.fused_conv_backward_reference(
        *(t.cpu() for t in (x, s, b, w, dy)))
    for t, r in zip(leaves, want):
        err = (t.grad.cpu() - r).abs().max().item()
        assert err <= 1e-3 * r.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_optimizer_apply_kernel_bitwise(momentum, clip):
    """The packed SGD kernel against the per-parameter step_fn chain on the
    card, bit for bit: mixed shapes and dtypes (two bf16 buckets around an
    f32 one), a different lr and wd per parameter, sizes that are not whole
    16-byte vectors, and a 1 KiB bucket cap that splits them further."""
    _need_card()
    import os
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.kernels import optimizer_apply as OA
    opt = topt.SGD(momentum=momentum, learning_rate=0.05, wd=1e-4,
                   clip_gradient=clip)
    rs = np.random.RandomState(0)
    spec = [((64, 32), "bfloat16"), ((33,), "bfloat16"), ((7, 3), "float32"),
            ((300,), "float32"), ((5,), "bfloat16"), ((9, 9, 3), "bfloat16")]
    ws = [torch.from_numpy(rs.randn(*sh).astype("float32")).cuda()
          .to(getattr(torch, d)) for sh, d in spec]
    gs = [torch.from_numpy(rs.randn(*w.shape).astype("float32") * 3).cuda()
          .to(w.dtype) for w in ws]
    sts = [None if momentum == 0 else torch.from_numpy(
        rs.randn(*w.shape).astype("float32")).cuda().to(w.dtype) for w in ws]
    lrs = [0.05 + 0.01 * i for i in range(len(ws))]
    wds = [1e-4 * i for i in range(len(ws))]
    want = [opt.step_fn(w, g, st, lr, wd, 1.0 / 32)
            for w, g, st, lr, wd in zip(ws, gs, sts, lrs, wds)]
    saved = os.environ.get("MXTPU_ELASTIC_BUCKET_MB")
    os.environ["MXTPU_ELASTIC_BUCKET_MB"] = str(1.0 / 1024)
    try:
        before = OA.LAUNCHES
        nw = [w.clone() for w in ws]
        ns = [None if st is None else st.clone() for st in sts]
        OA.packed_apply(opt, nw, gs, ns, lrs, wds, 1.0 / 32)
        torch.cuda.synchronize()
        assert OA.LAUNCHES - before == len(OA.bucketize(ws)) > 3
    finally:
        if saved is None:
            del os.environ["MXTPU_ELASTIC_BUCKET_MB"]
        else:
            os.environ["MXTPU_ELASTIC_BUCKET_MB"] = saved
    for (w2, m2), w, m in zip(want, nw, ns):
        assert _same_bits(w, w2)
        if momentum:
            assert _same_bits(m, m2)


@pytest.mark.cuda
def test_narrow_fused_resnet_trains_through_train_step_on_the_card(
        monkeypatch):
    """Two f32 steps of a narrow fuse=True ResNet through gluon.train_step
    with MXTPU_FUSED_APPLY=1 on the card match the port on the CPU (TF32
    off), with every fused link on its three kernels and one packed-apply
    launch per bucket per step."""
    _need_card()
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.kernels import optimizer_apply as OA
    monkeypatch.setenv("MXTPU_FUSED_APPLY", "1")
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(4, 3, 16, 16).astype("float32"))
    y = torch.from_numpy(rs.randint(0, 10, (4,)).astype("float32"))
    nets, losses = [], []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1],
                            [16, 32, 64, 128, 256], classes=10,
                            thumbnail=True, layout="NHWC", fuse=True)
        net.initialize(ctx=ctx)
        net(x.to(ctx.device))
        net.hybridize()
        nets.append(net)
    arrays = convert.random_numpy_params(convert.param_shapes(nets[0]))
    counts = (CF.LAUNCHES, CF.LAUNCHES_BWD_DX, CF.LAUNCHES_BWD_DW,
              OA.LAUNCHES)
    for net, ctx in zip(nets, (mx.gpu(0), mx.cpu())):
        convert.load_numpy_params(net, arrays)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.01, "momentum": 0.9})
        step = mx.gluon.train_step(net, SoftmaxCrossEntropyLoss(), trainer)
        for _ in range(2):
            loss = step(x.to(ctx.device), y.to(ctx.device))
            assert step.last_mode == "fused"
        losses.append(loss.cpu())
    torch.cuda.synchronize()
    train = [p._tensor() for p in trainer._params if p.grad_req != "null"]
    buckets = len(OA.bucketize(train))
    assert (CF.LAUNCHES, CF.LAUNCHES_BWD_DX, CF.LAUNCHES_BWD_DW,
            OA.LAUNCHES) == (counts[0] + 8, counts[1] + 8, counts[2] + 8,
                             counts[3] + 2 * buckets)
    assert torch.allclose(losses[0], losses[1], rtol=1e-5)
    for (k, p), q in zip(nets[0]._collect_params_with_prefix().items(),
                         nets[1]._collect_params_with_prefix().values()):
        w, wr = p._tensor().detach().cpu(), q._tensor().detach()
        assert (w - wr).abs().max() <= 1e-5 * wr.abs().max(), k


# Flash attention against its plain versions, relative to max |reference|:
# bf16 outputs one bf16 rounding step; f32 o and lse 1e-5, dq/dk/dv 1e-4
# (the JAX suite's own bounds; both sides keep f32 products). bf16 o, dq,
# dk and dv are also held row by row, each row against its own max
# |reference| (rows below 2^-12 of the tensor's max at that floor: the f32
# residue of a cancellation, as in causal query row 0 of dq).
FLASH_RTOL = {"bfloat16": {"o": 1.6e-2, "lse": 1e-5, "grad": 1.6e-2},
              "float32": {"o": 1e-5, "lse": 1e-5, "grad": 1e-4}}
FLASH_ROW_FLOOR = 2.0 ** -12


def _flash_inputs(case, dtype, layout="bhsd"):
    B, H, Sq, Sk, D, _ = case
    rs = np.random.RandomState(0)
    ts = [torch.from_numpy(rs.randn(B, H, s, D).astype("float32")).cuda()
          .to(getattr(torch, dtype)) for s in (Sq, Sk, Sk, Sq)]
    if layout == "bshd":        # [B, S, H, D] buffers seen as [B, H, S, D]
        ts = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in ts]
    return ts


def _row_rel_err(a, b):
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    ref = b.abs().amax(dim=1)
    floor = max(FLASH_ROW_FLOOR * ref.max().item(), 1e-30)
    return ((a - b).abs().amax(dim=1) / ref.clamp(min=floor)).max().item()


def _check_flash(case, dtype, layout):
    causal, scale = case[5], case[4] ** -0.5
    q, k, v, do = _flash_inputs(case, dtype, layout)
    before = dict(FA.LAUNCHES)
    o, lse = FA._flash_forward(q, k, v, causal, scale)
    ro, rlse = FA.flash_forward_reference(q, k, v, causal, scale)
    got = FA._flash_backward(q, k, v, ro, rlse, do, causal, scale)
    want = FA.flash_backward_reference(q, k, v, ro, rlse, do, causal, scale)
    torch.cuda.synchronize()
    assert {n: FA.LAUNCHES[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1}
    tol = FLASH_RTOL[dtype]
    for name, a, b, like in [("o", o, ro, q), ("lse", lse, rlse, None)] + [
            ("grad", g, w, t) for g, w, t in zip(got, want, (q, k, v))]:
        assert a.dtype == b.dtype and a.shape == b.shape
        if like is not None:
            assert a.stride() == like.stride(), (name, a.stride())
        assert bool(torch.isfinite(a.float()).all())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol[name] * b.float().abs().max().item(), (name, err)
        if dtype == "bfloat16" and name != "lse":
            assert _row_rel_err(a, b) <= tol[name], (name, _row_rel_err(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", [(2, 3, 257, 257, 128, True),
                                  (1, 2, 100, 300, 64, False)])
def test_flash_kernels_match_plain(case, dtype):
    """Forward, dQ and dK/dV against flash_forward_reference and
    flash_backward_reference: a ragged causal shape at head dim 128 and a
    ragged cross-attention shape at 64. One launch each."""
    _need_card()
    _check_flash(case, dtype, "bhsd")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", [(2, 4, 256, 256, 128, True),
                                  (1, 3, 200, 200, 64, True)])
def test_flash_kernels_match_plain_on_transposed_views(case, dtype):
    """As above on [B, S, H, D] tensors transposed to [B, H, S, D], the
    layout the LM's attention passes: the kernels read the strides, and o,
    dq, dk and dv come back laid out as q, k and v."""
    _need_card()
    _check_flash(case, dtype, "bshd")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("case", [(2, 3, 640, 640, 128, True),
                                  (1, 4, 520, 520, 64, True)])
def test_flash_forward_multi_tile_causal(case, layout):
    """The bf16 forward over several 128-row query tiles and 128-key tiles
    (ragged at 520), causal, contiguous and on transposed views: o and lse
    against flash_forward_reference as a whole and row by row (FLASH_RTOL),
    o laid out as q, one launch per call, and the same bits on a second
    launch."""
    _need_card()
    causal, scale = case[5], case[4] ** -0.5
    q, k, v, _ = _flash_inputs(case, "bfloat16", layout)
    before = FA.LAUNCHES["fwd"]
    o, lse = FA._flash_forward(q, k, v, causal, scale)
    o2, lse2 = FA._flash_forward(q, k, v, causal, scale)
    ro, rlse = FA.flash_forward_reference(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["fwd"] - before == 2
    assert o.stride() == q.stride() and o.dtype == torch.bfloat16
    tol = FLASH_RTOL["bfloat16"]
    err = (o.float() - ro.float()).abs().max().item()
    assert err <= tol["o"] * ro.float().abs().max().item(), err
    assert _row_rel_err(o, ro) <= tol["o"], _row_rel_err(o, ro)
    lerr = (lse - rlse).abs().max().item()
    assert lerr <= tol["lse"] * rlse.abs().max().item(), lerr
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_flash_forward_takes_expanded_views():
    """k and v broadcast over heads (stride 0, as an expand gives them): the
    bf16 forward reads them through a copy and gives what contiguous inputs
    give, bit for bit."""
    _need_card()
    q, k, v, _ = _flash_inputs((2, 4, 300, 300, 64, True), "bfloat16")
    ke, ve = k[:, :1].expand(-1, 4, -1, -1), v[:, :1].expand(-1, 4, -1, -1)
    assert ke.stride(1) == 0
    got = FA._flash_forward(q, ke, ve, True, 0.125)
    want = FA._flash_forward(q, ke.contiguous(), ve.contiguous(), True,
                             0.125)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("case", [(2, 3, 384, 384, 128, True),
                                  (1, 4, 1000, 1000, 64, True)])
def test_flash_backward_multi_block_causal(case, layout):
    """The bf16 backward over several 128-key blocks and 64-row query tiles
    (ragged at 1000), causal, contiguous and on transposed views: dq, dk and
    dv against flash_backward_reference as a whole and row by row
    (FLASH_RTOL), laid out as q, k and v, one dQ and one dK/dV launch per
    call, and the same bits on a second launch."""
    _need_card()
    causal, scale = case[5], case[4] ** -0.5
    q, k, v, do = _flash_inputs(case, "bfloat16", layout)
    ro, rlse = FA.flash_forward_reference(q, k, v, causal, scale)
    before = dict(FA.LAUNCHES)
    got = FA._flash_backward(q, k, v, ro, rlse, do, causal, scale)
    again = FA._flash_backward(q, k, v, ro, rlse, do, causal, scale)
    want = FA.flash_backward_reference(q, k, v, ro, rlse, do, causal, scale)
    torch.cuda.synchronize()
    assert {n: FA.LAUNCHES[n] - before[n] for n in ("dq", "dkv")} == \
        {"dq": 2, "dkv": 2}
    tol = FLASH_RTOL["bfloat16"]["grad"]
    for name, a, b, like, c in zip(("dq", "dk", "dv"), got, want, (q, k, v),
                                   again):
        assert a.dtype == torch.bfloat16 and a.stride() == like.stride()
        assert bool(torch.isfinite(a.float()).all()), name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item(), (name, err)
        assert _row_rel_err(a, b) <= tol, (name, _row_rel_err(a, b))
        assert torch.equal(a, c), name


@pytest.mark.cuda
def test_flash_backward_takes_expanded_views():
    """q, k, v and dO broadcast over heads (stride 0, as an expand gives
    them): the bf16 backward reads them through copies and gives what
    contiguous inputs give, bit for bit."""
    _need_card()
    q, k, v, do = _flash_inputs((2, 4, 300, 300, 128, True), "bfloat16")
    qe, ke, ve, doe = (t[:, :1].expand(-1, 4, -1, -1) for t in (q, k, v, do))
    assert all(t.stride(1) == 0 for t in (qe, ke, ve, doe))
    qc, kc, vc, doc = (t.contiguous() for t in (qe, ke, ve, doe))
    o, lse = FA._flash_forward(qc, kc, vc, True, 128 ** -0.5)
    got = FA._flash_backward(qe, ke, ve, o, lse, doe, True, 128 ** -0.5)
    want = FA._flash_backward(qc, kc, vc, o, lse, doc, True, 128 ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("case", [(1, 2, 130, 130, 128, True),
                                  (2, 3, 640, 640, 128, True),
                                  (1, 4, 520, 520, 64, True)])
def test_flash_dq_multi_block_causal(case, layout):
    """The bf16 dQ kernel over several 128-row query blocks and 128-key
    tiles, causal (S = 130: the last block's second half holds no row; 520:
    a ragged last tile), contiguous and on transposed views: dq against
    backward_dq_reference as a whole and row by row (FLASH_RTOL), laid out
    as q, one dQ launch per call, and the same bits on a second launch."""
    _need_card()
    causal, scale = case[5], case[4] ** -0.5
    q, k, v, do = _flash_inputs(case, "bfloat16", layout)
    ro, rlse = FA.flash_forward_reference(q, k, v, causal, scale)
    before = FA.LAUNCHES["dq"]
    dq = FA._flash_backward(q, k, v, ro, rlse, do, causal, scale)[0]
    again = FA._flash_backward(q, k, v, ro, rlse, do, causal, scale)[0]
    want = FA.backward_dq_reference(q, k, v, ro, rlse, do, causal, scale)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["dq"] - before == 2
    assert dq.dtype == torch.bfloat16 and dq.stride() == q.stride()
    assert bool(torch.isfinite(dq.float()).all())
    tol = FLASH_RTOL["bfloat16"]["grad"]
    err = (dq.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err
    assert _row_rel_err(dq, want) <= tol, _row_rel_err(dq, want)
    assert torch.equal(dq, again)


@pytest.mark.cuda
def test_flash_dq_takes_expanded_views():
    """q, k, v and dO broadcast over heads (stride 0) at head dim 64: the
    bf16 dQ kernel reads them through copies and gives what contiguous
    inputs give, bit for bit."""
    _need_card()
    q, k, v, do = _flash_inputs((2, 4, 260, 260, 64, True), "bfloat16")
    qe, ke, ve, doe = (t[:, :1].expand(-1, 4, -1, -1) for t in (q, k, v, do))
    qc, kc, vc, doc = (t.contiguous() for t in (qe, ke, ve, doe))
    o, lse = FA._flash_forward(qc, kc, vc, True, 0.125)
    got = FA._flash_backward(qe, ke, ve, o, lse, doe, True, 0.125)[0]
    want = FA._flash_backward(qc, kc, vc, o, lse, doc, True, 0.125)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_kernels_raise_on_unsupported_inputs():
    _need_card()
    q = torch.randn(1, 2, 128, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q)
    q = torch.randn(1, 2, 128, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        FA.flash_attention(q, q, q)
    q = torch.randn(1, 2, 64, 128, device="cuda",
                    dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q)


@pytest.mark.cuda
def test_tiny_lm_steps_on_the_card_match_the_cpu():
    """Two f32 SGD-momentum steps of a narrow LM (S = 128: the flash branch)
    on the card, TF32 off, against the port on the CPU: losses within 1e-5
    relative, weights within 1e-5 of each tensor's max; 2 forward (with
    recompute), 1 dQ and 1 dK/dV launch per layer per step."""
    _need_card()
    cfg = T.TransformerConfig(vocab_size=128, dim=256, n_layers=2,
                              n_heads=2, ffn_hidden=256, dtype="float32",
                              loss_chunks=2)
    rs = np.random.RandomState(0)
    tok = rs.randint(0, 128, (2, 128))
    tgt = rs.randint(0, 128, (2, 128))
    with mx.precision.matmul_precision("float32"):
        steps, states = {}, {}
        for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            init_fn, steps[name] = T.make_train_step(cfg, learning_rate=0.1,
                                                     ctx=ctx)
            states[name] = init_fn(0)
        # the same weights on both sides: the CPU's, copied to the card
        with torch.no_grad():
            for a, b in zip(states["card"][0].parameters(),
                            states["cpu"][0].parameters()):
                a.copy_(b)
        before = dict(FA.LAUNCHES)
        losses = {name: [float(steps[name](states[name], tok, tgt)[1])
                         for _ in range(2)] for name in steps}
    torch.cuda.synchronize()
    assert {n: FA.LAUNCHES[n] - before[n] for n in before} == \
        {"fwd": 8, "dq": 4, "dkv": 4}
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-5)
    for a, b in zip(states["card"][0].parameters(),
                    states["cpu"][0].parameters()):
        a, b = a.detach().cpu(), b.detach()
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def _qmm_operands(M, K, N, seed):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randint(-128, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rs.randint(-127, 128, (N, K)).astype(np.int8))
    s = torch.from_numpy((rs.rand(N) * 1e-3 + 1e-6).astype(np.float32))
    return x.cuda(), w.cuda().t(), s.cuda()


def _qmm_launches():
    return (QM.LAUNCHES_MM, QM.LAUNCHES_MM_SCALED, QM.LAUNCHES_MM_BYTES,
            QM.LAUNCHES_MM_SCALED_BYTES)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100352, 576, 64), (32, 2048, 1000),
                                   (37, 147, 29), (1, 33, 1000)])
def test_quantized_matmul_kernel_bitwise(shape):
    """Both forms of the int8 kernel (int32 and scaled) against the plain
    version at two int8 ResNet-50 shapes (the wgmma route) and two edge
    shapes (odd K: the byte route), bit for bit; one launch per call."""
    _need_card()
    x, w, s = _qmm_operands(*shape, seed=sum(shape))
    fast = shape[1] % 16 == 0
    before = _qmm_launches()
    out = QM.quantized_matmul(x, w)
    out_s = QM.quantized_matmul(x, w, s)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, _qmm_launches())] == \
        ([1, 1, 0, 0] if fast else [0, 0, 1, 1])
    assert torch.equal(out, QM.quantized_matmul_reference(x, w))
    assert _same_bits(out_s, QM.quantized_matmul_reference(x, w, s))


@pytest.mark.cuda
@pytest.mark.parametrize("n_sm", [None, 5])
@pytest.mark.parametrize("shape", [(1568, 4608, 512), (130, 4608, 72),
                                   (1605, 4624, 520), (32, 2048, 1000),
                                   (257, 1040, 260), (100, 48, 30),
                                   (257, 4608, 200), (257, 9216, 72)])
def test_quantized_matmul_wgmma_route_relaunch_same_bits(shape, n_sm,
                                                         monkeypatch):
    """The wgmma route, both forms, bit for bit against the plain version
    and the same bits on a second launch: deep K split across blocks (M =
    1568, K = 4608), ragged M, N and K tails, M = 32 below the 64-row
    wgmma tile, N = 1000, N % 4 != 0 (guarded stores); also planned for a
    card of 5 SMs, where each persistent block walks several items."""
    _need_card()
    if n_sm is not None:
        monkeypatch.setattr(QM, "_sm_count", lambda dev: n_sm)
    x, w, s = _qmm_operands(*shape, seed=sum(shape))
    before = _qmm_launches()
    outs = [QM.quantized_matmul(x, w, sc) for sc in (None, s, None, s)]
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, _qmm_launches())] == [2, 2, 0, 0]
    assert torch.equal(outs[0], QM.quantized_matmul_reference(x, w))
    assert torch.equal(outs[0], outs[2])
    assert _same_bits(outs[1], QM.quantized_matmul_reference(x, w, s))
    assert _same_bits(outs[1], outs[3])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k147", "k1", "x_misaligned"])
def test_quantized_matmul_byte_route_relaunch_same_bits(case):
    """The byte route, both forms, bit for bit against the plain version
    and the same bits on a second launch: K = 147 unpadded, K = 1, and an
    x view one byte off 16-byte alignment."""
    _need_card()
    M, K, N = {"k147": (300, 147, 200), "k1": (64, 1, 64),
               "x_misaligned": (300, 96, 200)}[case]
    x, w, s = _qmm_operands(M, K, N, seed=M + K + N)
    if case == "x_misaligned":
        wide = torch.zeros(M, 112, dtype=torch.int8, device="cuda")
        wide[:, 1:97] = x
        x = wide[:, 1:97]
    before = _qmm_launches()
    outs = [QM.quantized_matmul(x, w, sc) for sc in (None, s, None, s)]
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, _qmm_launches())] == [0, 0, 2, 2]
    assert torch.equal(outs[0], QM.quantized_matmul_reference(x, w))
    assert torch.equal(outs[0], outs[2])
    assert _same_bits(outs[1], QM.quantized_matmul_reference(x, w, s))
    assert _same_bits(outs[1], outs[3])


@pytest.mark.cuda
def test_quantized_matmul_layouts_and_errors_on_the_card():
    _need_card()
    x, w, s = _qmm_operands(40, 96, 24, seed=1)
    copies = QM.COPIES
    out = QM.quantized_matmul(x, w.contiguous(), s)     # N-contiguous w
    assert QM.COPIES == copies + 1
    assert _same_bits(out, QM.quantized_matmul_reference(x, w, s))
    with pytest.raises(ValueError):
        QM.quantized_matmul(x.t().contiguous().t(), w)  # K-strided x
    with pytest.raises(TypeError):
        QM.quantized_matmul(x.to(torch.int32), w)
    with pytest.raises(ValueError):
        QM.quantized_matmul(x, w.cpu())


@pytest.mark.cuda
def test_narrow_int8_resnet_on_the_card_matches_the_cpu():
    """A narrow NCHW ResNet quantized on the card, its int8 state carried to
    the same network on the CPU: one scaled launch per int8 layer, the
    stem's codes equal, the logits within 1e-3 of their max (a code that
    an ulp of a float activation moves across a rounding boundary is the
    only difference)."""
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    nets = []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1],
                            [16, 32, 64, 128, 256], classes=10)
        net.initialize(ctx=ctx)
        net(torch.zeros(1, 3, 32, 32, device=ctx.device))
        nets.append(net)
    arrays = convert.random_numpy_params(convert.param_shapes(nets[1]),
                                         seed=3)
    for net in nets:
        convert.load_numpy_params(net, arrays)
    rs = np.random.RandomState(2)
    calib = [rs.rand(4, 3, 32, 32).astype("float32") for _ in range(2)]
    Q.quantize_net(nets[0], calib_data=calib)
    Q.quantize_net(nets[1], calib_mode="none")
    convert.load_quantized_state(nets[1], convert.quantized_state(nets[0]))
    x = rs.rand(2, 3, 32, 32).astype("float32")
    before = (QM.LAUNCHES_MM, QM.LAUNCHES_MM_SCALED)
    out = nets[0](torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    assert (QM.LAUNCHES_MM, QM.LAUNCHES_MM_SCALED) == (before[0],
                                                       before[1] + 18)
    ref = nets[1](torch.from_numpy(x))
    stems = [n.features[0] for n in nets]
    codes = [st.quantize_input(torch.from_numpy(x).to(dev))
             for st, dev in zip(stems, ("cuda", "cpu"))]
    assert torch.equal(codes[0].cpu(), codes[1])
    assert (out.cpu() - ref).abs().max() <= 1e-3 * ref.abs().max()



# -- 2-bit compression (rows 14-15) and the packed Adam apply (row 8) ---------

def _codec_case(n, dtype, thr, seed):
    """Gradient and residual on the card, the first values at the codec's
    edges (exactly +-thr, +-0.0, +-inf, NaN)."""
    rs = np.random.RandomState(seed)
    g = (rs.randn(n) * thr * 1.5).astype("float32")
    r = (rs.randn(n) * thr * 0.5).astype("float32")
    sp = np.asarray([thr, -thr, 0.0, -0.0, np.inf, -np.inf, np.nan],
                    "float32")[:n]
    g[:len(sp)] = sp
    r[:len(sp)] = np.where(np.isfinite(sp), 0.0, r[:len(sp)])
    r[3:4] = -0.0
    dt = getattr(torch, dtype)
    return (torch.from_numpy(g).cuda().to(dt),
            torch.from_numpy(r).cuda().to(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.5, 0.3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, 4096, 4097, 100003])
def test_compression_kernels_bitwise(n, dtype, thr):
    """quantize_2bit and dequantize_2bit against their plain versions on
    the card, bit for bit (words, residuals, decoded values), one launch
    each, and the same bits on a second launch."""
    _need_card()
    from mxnet_tpu_torch.kernels import compression as C
    g, r = _codec_case(n, dtype, thr, seed=n % 991)
    before = (C.LAUNCHES_QUANTIZE, C.LAUNCHES_DEQUANTIZE)
    words, res = C.quantize_2bit(g, r, thr)
    deq = C.dequantize_2bit(words, n, thr)
    words2, res2 = C.quantize_2bit(g, r, thr)
    torch.cuda.synchronize()
    assert (C.LAUNCHES_QUANTIZE, C.LAUNCHES_DEQUANTIZE) == (
        before[0] + 2, before[1] + 1)
    rw, rres = C.quantize_2bit_reference(g, r, thr)
    assert torch.equal(words, rw) and torch.equal(words2, rw)
    assert _same_bits(res, rres) and _same_bits(res2, rres)
    assert _same_bits(deq, C.dequantize_2bit_reference(rw, n, thr))
    # an unaligned view takes the scalar path, same bits
    if n > 17:
        wv, rv = C.quantize_2bit(g[1:], r[1:], thr)
        rwv, rrv = C.quantize_2bit_reference(g[1:], r[1:], thr)
        assert torch.equal(wv, rwv) and _same_bits(rv, rrv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_compression_group_kernels_bitwise(dtype):
    """One grouped quantize and one grouped dequantize over the edge sizes,
    an empty segment and a view one element off alignment (the scalar
    route), against the per-tensor plain versions bit for bit: one launch
    each, the non-empty segments counted, the same bits on a second
    launch."""
    _need_card()
    from mxnet_tpu_torch.kernels import compression as C
    ns = [1, 15, 16, 17, 0, 4095, 4096, 4097, 100003, 4097]
    cases = [_codec_case(n + 1, dtype, 0.5, seed=i) for i, n in enumerate(ns)]
    gs = [g[:n] for (g, _), n in zip(cases, ns)]
    rs = [r[:n] for (_, r), n in zip(cases, ns)]
    gs[-1], rs[-1] = cases[-1][0][1:], cases[-1][1][1:]
    before = (C.LAUNCHES_QUANTIZE, C.SEGMENTS_QUANTIZE,
              C.LAUNCHES_DEQUANTIZE, C.SEGMENTS_DEQUANTIZE)
    words, res = C.quantize_2bit_group(gs, rs, 0.5)
    flat, views = C.dequantize_2bit_group(words, ns, 0.5)
    words2, res2 = C.quantize_2bit_group(gs, rs, 0.5)
    torch.cuda.synchronize()
    assert (C.LAUNCHES_QUANTIZE - before[0], C.SEGMENTS_QUANTIZE - before[1],
            C.LAUNCHES_DEQUANTIZE - before[2],
            C.SEGMENTS_DEQUANTIZE - before[3]) == (2, 18, 1, 9)
    for g, r, n, w, w2, nr, nr2, v in zip(gs, rs, ns, words, words2, res,
                                          res2, views):
        rw, rres = C.quantize_2bit_reference(g, r, 0.5)
        assert torch.equal(w, rw) and torch.equal(w2, rw)
        assert _same_bits(nr, rres) and _same_bits(nr2, rres)
        assert _same_bits(v, C.dequantize_2bit_reference(rw, n, 0.5))
    assert flat.shape == (sum(ns),)


@pytest.mark.cuda
def test_compression_kernels_raise_on_unsupported_inputs():
    _need_card()
    from mxnet_tpu_torch.kernels import compression as C
    g = torch.zeros(64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        C.quantize_2bit(g, g.clone())
    g = torch.zeros(64, 2, device="cuda")[:, 0]
    with pytest.raises(ValueError):
        C.quantize_2bit(g, g.clone())


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("steps", [1, 10])
def test_optimizer_apply_adam_kernel_bitwise(steps, clip):
    """The packed Adam kernel against the per-parameter step_fn chain on the
    card, bit for bit, at update counts 1 and 10 (step_lr's bias-corrected
    rate), mixed dtypes and ragged sizes."""
    _need_card()
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.kernels import optimizer_apply as OA
    opt = topt.Adam(learning_rate=1e-3, wd=1e-4, clip_gradient=clip)
    rs = np.random.RandomState(1)
    spec = [((64, 32), "bfloat16"), ((33,), "bfloat16"), ((7, 3), "float32"),
            ((300,), "float32"), ((5,), "bfloat16")]
    ws = [torch.from_numpy(rs.randn(*sh).astype("float32")).cuda()
          .to(getattr(torch, d)) for sh, d in spec]
    gs = [torch.from_numpy(rs.randn(*w.shape).astype("float32")).cuda()
          .to(w.dtype) for w in ws]
    sts = [tuple(torch.from_numpy(a).cuda().to(w.dtype) for a in (
        rs.randn(*w.shape).astype("float32") * 0.1,
        rs.rand(*w.shape).astype("float32") * 0.01)) for w in ws]
    for i in range(len(ws)):
        opt._index_update_count[i] = steps
    lrs = [opt.step_lr(i) for i in range(len(ws))]
    wds = [1e-4] * len(ws)
    want = [opt.step_fn(w, g, st, lr, wd, 1.0 / 32)
            for w, g, st, lr, wd in zip(ws, gs, sts, lrs, wds)]
    before = OA.LAUNCHES
    nw = [w.clone() for w in ws]
    ns = [tuple(t.clone() for t in st) for st in sts]
    OA.packed_apply(opt, nw, gs, ns, lrs, wds, 1.0 / 32)
    torch.cuda.synchronize()
    assert OA.LAUNCHES - before == len(OA.bucketize(ws))
    for (w2, (m2, v2)), w, (m, v) in zip(want, nw, ns):
        assert _same_bits(w, w2) and _same_bits(m, m2) and _same_bits(v, v2)


@pytest.mark.cuda
def test_compressed_push_pull_on_the_card():
    """A compressed bf16 push and pull on the card equals the same on the
    CPU bit for bit, with one quantize and one dequantize launch per push
    of a key at or above the bound and none below it."""
    _need_card()
    from mxnet_tpu_torch.kernels import compression as C
    shapes = {0: (64, 64), 1: (100,), 2: (3, 3, 64, 64)}
    outs = {}
    for dev in ("cuda", "cpu"):
        kv = mx.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        for k, sh in shapes.items():
            kv.init(k, torch.zeros(sh, dtype=torch.bfloat16, device=dev))
        before = (C.LAUNCHES_QUANTIZE, C.LAUNCHES_DEQUANTIZE)
        got = []
        for step in range(3):
            for k, sh in shapes.items():
                g = np.random.RandomState(10 * step + k).randn(*sh) * 0.4
                kv.push(k, torch.from_numpy(g.astype("float32")).to(
                    dev, torch.bfloat16))
                out = torch.empty(sh, dtype=torch.bfloat16, device=dev)
                kv.pull(k, out=out)
                got.append(out.cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (C.LAUNCHES_QUANTIZE - before[0],
                    C.LAUNCHES_DEQUANTIZE - before[1]) == (6, 6)
        outs[dev] = got
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_compressed_list_push_on_the_card():
    """A list push of every key on the card equals the same on the CPU bit
    for bit, with one quantize and one dequantize launch per push over the
    keys at or above the bound."""
    _need_card()
    from mxnet_tpu_torch.kernels import compression as C
    shapes = {0: (64, 64), 1: (100,), 2: (3, 3, 64, 64)}
    outs = {}
    for dev in ("cuda", "cpu"):
        kv = mx.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        for k, sh in shapes.items():
            kv.init(k, torch.zeros(sh, dtype=torch.bfloat16, device=dev))
        before = (C.LAUNCHES_QUANTIZE, C.SEGMENTS_QUANTIZE,
                  C.LAUNCHES_DEQUANTIZE)
        got = []
        for step in range(3):
            gs = [torch.from_numpy((np.random.RandomState(10 * step + k)
                                    .randn(*sh) * 0.4).astype("float32"))
                  .to(dev, torch.bfloat16) for k, sh in shapes.items()]
            kv.push(list(shapes), gs)
            res = [torch.empty(sh, dtype=torch.bfloat16, device=dev)
                   for sh in shapes.values()]
            kv.pull(list(shapes), out=res)
            got += [o.cpu() for o in res]
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (C.LAUNCHES_QUANTIZE - before[0],
                    C.SEGMENTS_QUANTIZE - before[1],
                    C.LAUNCHES_DEQUANTIZE - before[2]) == (3, 6, 3)
        outs[dev] = got
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_ndarray_moves_between_card_and_host():
    _need_card()
    rs = np.random.RandomState(40)
    for dtype in ("float32", "bfloat16", "int32", "uint8"):
        a = (rs.rand(3, 5) * 100).astype("float32")
        h = mx.nd.array(a, ctx=mx.cpu(), dtype=dtype)
        g = h.as_in_context(mx.gpu(0))
        assert g.context == mx.gpu(0) and g._data.is_cuda
        back = g.copyto(mx.cpu())
        assert back.context == mx.cpu() and not back._data.is_cuda
        assert str(back.dtype) == str(h.dtype)
        assert np.array_equal(back.asnumpy().astype("float64"),
                              h.asnumpy().astype("float64"))
        # ops on the card stay there; the results come back equal
        s = (g * 2 + 1).asnumpy().astype("float64")
        assert np.array_equal(s, (h * 2 + 1).asnumpy().astype("float64"))
    pinned = mx.nd.array(a, ctx=mx.cpu_pinned())
    assert pinned._data.is_pinned() and pinned.context == mx.cpu_pinned()
    assert mx.num_gpus() == torch.cuda.device_count() >= 1
    mx.waitall()


@pytest.mark.cuda
def test_nd_save_on_the_card_gives_the_host_bytes(tmp_path):
    _need_card()
    rs = np.random.RandomState(41)
    arrays = {"w": rs.randn(4, 3).astype("float32"),
              "h": rs.randn(5).astype("float16"),
              "i": rs.randint(0, 9, (3,)).astype("int32"),
              "s": np.float32(1.5)}
    fc, fg = str(tmp_path / "cpu.params"), str(tmp_path / "gpu.params")
    card = {k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in arrays.items()}
    card["b"] = mx.nd.array(rs.randn(6).astype("float32"), ctx=mx.gpu(0),
                            dtype="bfloat16")
    mx.nd.save(fg, card)
    host = dict(card)
    host["b"] = card["b"].as_in_context(mx.cpu())
    mx.nd.save(fc, {k: v.as_in_context(mx.cpu()) for k, v in host.items()})
    with open(fc, "rb") as a, open(fg, "rb") as b:
        assert a.read() == b.read()
    loaded = mx.nd.load(fg, ctx=mx.gpu(0))
    assert all(v.context == mx.gpu(0) for v in loaded.values())
    assert np.array_equal(loaded["w"].asnumpy(), arrays["w"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batchnorm_c3_input_matches_plain(dtype):
    """ResNet V2's input BatchNorm on the card: C = 3 channels-last (row
    pitch 6 or 12 bytes, the kernels' non-TMA route) at R = 16 x 224 x
    224, through the four kernels: out, mean and var bit for bit against
    the plain versions, each fold the same bits on a second launch, the
    backward within 2e-4 of its largest magnitude."""
    _need_card()
    rs = np.random.RandomState(3)
    dt = getattr(torch, dtype)
    R = 16 * 224 * 224
    x2 = torch.from_numpy(rs.rand(R, 3).astype("float32")).cuda().to(dt)
    g, b = torch.ones(3, device="cuda"), torch.zeros(3, device="cuda")
    dy = torch.from_numpy(rs.randn(R, 3).astype("float32")).cuda().to(dt)
    mean, var = BNF.stats(x2)
    mean2, var2 = BNF.stats(x2)
    rmean, rvar = BNF.stats_reference(x2)
    out = BNF.apply(x2, g, b, rmean, rvar, 1e-5)
    rout = BNF.apply_reference(x2, g, b, rmean, rvar, 1e-5)
    db, dg = BNF.bwd_reduce(x2, dy, g, b, rmean, rvar, 1e-5)
    db2, dg2 = BNF.bwd_reduce(x2, dy, g, b, rmean, rvar, 1e-5)
    rdb, rdg = BNF.bwd_reduce_reference(x2, dy, g, b, rmean, rvar, 1e-5)
    dx = BNF.bwd_dx(x2, dy, g, b, rmean, rvar, rdb, rdg, 1e-5)
    rdx = BNF.bwd_dx_reference(x2, dy, g, b, rmean, rvar, rdb, rdg, 1e-5)
    torch.cuda.synchronize()
    assert _same_bits(mean, rmean) and _same_bits(var, rvar)
    assert _same_bits(mean2, mean) and _same_bits(var2, var)
    assert _same_bits(out, rout)
    assert _same_bits(db2, db) and _same_bits(dg2, dg)
    for got, want in ((db, rdb), (dg, rdg), (dx, rdx)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-4 * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_dropout_mask_on_the_card_repeats_under_one_seed():
    """Dropout on a CUDA tensor draws from the card's own generator: the
    same mx.random.seed gives the same mask twice, another seed another
    one, torch's global CUDA generator is left alone, and every kept value
    is x / (1 - p)."""
    _need_card()
    x = torch.rand(512, 1024, device="cuda") + 1.0
    glob = torch.cuda.get_rng_state()
    outs = []
    for seed in (7, 7, 8):
        mx.random.seed(seed)
        with mx.autograd.train_mode():
            outs.append(mx.nd.Dropout(x, p=0.5))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert torch.equal(torch.cuda.get_rng_state(), glob)
    kept = outs[0] != 0
    assert torch.equal(outs[0][kept], (x / 0.5)[kept])
    share = kept.float().mean().item()
    assert abs(share - 0.5) <= 6 * (0.25 / x.numel()) ** 0.5
    assert mx.random.generator(x.device).device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workers,threads", [(0, True), (3, True),
                                             (2, False)])
def test_dataloader_pins_and_lands_on_the_card(workers, threads):
    """Batches of a pinned DataLoader land on gpu(0) with the values the
    CPU loader gives; the host side stacks straight into pinned memory
    (or rebuilds from shared memory into it) and copies without
    blocking."""
    _need_card()
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.data import dataloader as DL
    from mxnet_tpu_torch.gluon.data.vision import transforms as Tr
    rs = np.random.RandomState(3)
    x = rs.randint(0, 256, (10, 6, 5, 3)).astype(np.uint8)
    y = rs.randint(0, 7, 10)
    ds = ArrayDataset(x, y).transform_first(Tr.Cast("float32"))
    with mx.cpu():
        want = [(a.asnumpy(), b.asnumpy())
                for a, b in DataLoader(ds, batch_size=4)]
    loader = DataLoader(ds, batch_size=4, num_workers=workers,
                        thread_pool=threads, pin_memory=True)
    got = list(loader)
    assert len(got) == len(want) == 3
    for (a, b), (wa, wb) in zip(got, want):
        assert a.context == mx.gpu(0) and b.context == mx.gpu(0)
        np.testing.assert_array_equal(a.asnumpy(), wa)
        np.testing.assert_array_equal(b.asnumpy(), wb)
    batch = DL._batchify([ds[i] for i in range(4)], True)
    assert batch[0]._data.is_pinned() and batch[1]._data.is_pinned()
    loader._shutdown_pool()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_device_prefetch_batches_equal_the_host(tmp_path, depth):
    """ImageRecordIter through DevicePrefetchIter onto gpu(0), two epochs:
    every batch the host iterator's bytes (the copy finished before use,
    the pinned ring reused across batches and a reset)."""
    _need_card()
    from mxnet_tpu_torch import recordio
    rs = np.random.RandomState(0)
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(40):
        img = rs.randint(0, 256, (48, 40, 3)).astype(np.uint8)
        w.write_idx(i, recordio.pack_raw_img(
            recordio.IRHeader(0, float(i % 10), i, 0), img))
    w.close()
    args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 32, 32),
                batch_size=8, shuffle=True, rand_crop=True,
                rand_mirror=True, dtype="uint8")
    host_it = mx.io.ImageRecordIter(**args)
    want = []
    for epoch in range(2):
        if epoch:
            host_it.reset()
        want += [(b.data[0].asnumpy(), b.label[0].asnumpy())
                 for b in host_it]
    pf = mx.io.DevicePrefetchIter(mx.io.ImageRecordIter(**args),
                                  depth=depth, sharding=mx.gpu(0))
    got = []
    for epoch in range(2):
        if epoch:
            pf.reset()
        for b in pf:
            x = b.data[0]
            assert x.context == mx.gpu(0) and x._data.is_cuda
            got.append((x.asnumpy(), b.label[0].asnumpy()))
    assert len(got) == len(want) == 10
    for (x, y), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)


def _sorted_boxes(rs, B, n, scale=1.0):
    b = rs.uniform(0, 0.7, (B, n, 2)).astype("float32")
    wh = rs.uniform(0.02, 0.3, (B, n, 2)).astype("float32")
    return torch.from_numpy(np.concatenate([b, b + wh], -1) * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n,classes,plus_one", [(1, 0, False), (63, 0, False),
                                                (64, 3, False),
                                                (130, 0, True),
                                                (2000, 20, False)])
def test_box_nms_kernel_matches_plain(n, classes, plus_one):
    """The keep mask on the card against keep_reference, bit for bit:
    prefixes ending inside, at and past a 64-bit word, class-aware and
    not, the Proposal form; one launch pair a call, no host sync."""
    _need_card()
    from mxnet_tpu_torch.kernels import box_nms as NMS
    rs = np.random.RandomState(n)
    B = 3
    boxes = _sorted_boxes(rs, B, n, 30.0 if plus_one else 1.0)
    ids = torch.from_numpy(rs.randint(0, classes, (B, n)).astype(
        "float32")) if classes else None
    nvalid = torch.tensor([n, max(0, n - 1), n // 2])
    want = NMS.keep_reference(boxes, ids, nvalid, 0.45, plus_one)
    before = NMS.LAUNCHES
    dev = [t.cuda() if t is not None else None for t in (boxes, ids,
                                                         nvalid)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = NMS.keep(*dev, 0.45, plus_one)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert NMS.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_detection_ops_on_the_card_match_the_cpu():
    """box_nms, MultiBoxPrior, MultiBoxTarget and MultiBoxDetection on the
    card against the CPU: kept sets and targets exactly, coordinates
    within 1e-5 of max."""
    _need_card()
    C = mx.nd.contrib
    rs = np.random.RandomState(0)
    B, L, K = 4, 6, 5
    feat = np.zeros((1, 1, 10, 10), "float32")
    labels = np.full((B, L, 5), -1.0, "float32")
    for i in range(B - 1):
        k = rs.randint(1, L + 1)
        xy = rs.uniform(0, 0.6, (k, 2))
        labels[i, :k, 0] = rs.randint(0, K - 1, k)
        labels[i, :k, 1:3] = xy
        labels[i, :k, 3:5] = xy + rs.uniform(0.1, 0.4, (k, 2))
    A = 10 * 10 * 4
    r = np.random.RandomState(1)
    cls = torch.from_numpy(r.randn(B, K, A).astype("float32"))
    prob = torch.softmax(cls, 1)        # one set of scores for both devices
    loc = torch.from_numpy(r.randn(B, A * 4).astype("float32") * 0.3)
    out = {}
    for d in ("cuda", "cpu"):
        anchors = C.MultiBoxPrior(torch.from_numpy(feat).to(d),
                                  sizes=(0.2, 0.4), ratios=(1.0, 2.0, 0.5))
        out[d] = (anchors,) + C.MultiBoxTarget(
            anchors, torch.from_numpy(labels).to(d), cls.to(d),
            negative_mining_ratio=3.0) + (C.MultiBoxDetection(
                prob.to(d), loc.to(d), anchors, nms_threshold=0.45),)
    for g, w in zip(out["cuda"], out["cpu"]):
        g = g.cpu()
        assert g.shape == w.shape
        assert (g - w).abs().max() <= 1e-5 * max(1.0, float(w.abs().max()))
    assert torch.equal(out["cuda"][2].cpu(), out["cpu"][2])
    assert torch.equal(out["cuda"][3].cpu(), out["cpu"][3])
    assert torch.equal(out["cuda"][4].cpu()[..., :2], out["cpu"][4][..., :2])


@pytest.mark.cuda
def test_image_ops_run_on_the_card():
    """The nd.image ops on the card against the CPU; the random ones at a
    degenerate range, drawn on the card's generator."""
    _need_card()
    from mxnet_tpu_torch.ops import registry
    rs = np.random.RandomState(2)
    img = torch.from_numpy(rs.randint(0, 256, (2, 6, 7, 3)).astype(
        "float32"))
    cases = [("_image_to_tensor", {}), ("_image_flip_left_right", {}),
             ("_image_resize", dict(size=(9, 4))),
             ("_image_random_brightness", dict(min_factor=0.5,
                                               max_factor=0.5)),
             ("_image_random_contrast", dict(min_factor=0.5,
                                             max_factor=0.5)),
             ("_image_random_hue", dict(min_factor=0.2, max_factor=0.2)),
             ("_image_random_lighting", dict(alpha_std=0.0))]
    for name, kw in cases:
        fn = registry.get_op(name).fn
        g, w = fn(img.cuda(), **kw), fn(img, **kw)
        assert g.device.type == "cuda", name
        assert (g.cpu() - w).abs().max() <= 1e-5 * float(w.abs().max()), \
            name


def _narrow_nchw_resnet(prefix):
    return tres.ResNetV1(tres.BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                         classes=10, thumbnail=True, prefix=prefix)


@pytest.mark.cuda
def test_module_step_on_the_card_matches_the_cpu():
    """A narrow NCHW ResNet traced into a symbol, one Module step on the
    card and on the CPU from the same parameters and batch (f32, TF32
    off): outputs, parameters and moving statistics within 1e-4."""
    _need_card()
    sym = mx.sym.SoftmaxOutput(_narrow_nchw_resnet("m_")(
        mx.sym.var("data")), name="softmax")
    rs = np.random.RandomState(0)
    shapes = {"data": (8, 3, 32, 32), "softmax_label": (8,)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    arg = {n: rs.uniform(-0.2, 0.2, s).astype("float32")
           for n, s in zip(sym.list_arguments(), arg_shapes)
           if n not in shapes}
    x = rs.uniform(-1, 1, shapes["data"]).astype("float32")
    y = rs.randint(0, 10, 8).astype("float32")
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind([("data", shapes["data"])], [("softmax_label", (8,))])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in arg.items()},
                        allow_missing=True)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                    [mx.nd.array(y, ctx=ctx)]))
        mod.backward()
        mod.update()
        a, aux = mod.get_params()
        res.append((mod.get_outputs()[0].asnumpy(),
                    {k: v.asnumpy() for k, v in a.items()},
                    {k: v.asnumpy() for k, v in aux.items()}))
    for got, want in ((res[0][0], res[1][0]),
                      *((res[0][1][k], res[1][1][k]) for k in res[1][1]),
                      *((res[0][2][k], res[1][2][k]) for k in res[1][2])):
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-4, err


@pytest.mark.cuda
def test_symbolblock_step_on_the_card_launches_the_batchnorm_kernels():
    """A channels-last ResNet-18 v1 as a SymbolBlock on the card: one
    training step launches each BatchNorm kernel once per BatchNorm
    (20), and its loss and gradients equal the zoo net's own eager step
    from the same parameters (bf16, cuDNN deterministic)."""
    _need_card()
    import os
    import tempfile
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    net = mx.gluon.model_zoo.vision.resnet18_v1(layout="NHWC", classes=10,
                                                prefix="sb_")
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (8, 3, 32, 32)).astype("float32")).cuda()
    net(x)
    net.cast("bfloat16")
    d = tempfile.mkdtemp()
    net(mx.sym.var("data")).save(os.path.join(d, "g.json"))
    net.export(os.path.join(d, "n"))
    blk = mx.gluon.SymbolBlock.imports(os.path.join(d, "g.json"), ["data"],
                                       os.path.join(d, "n-0000.params"),
                                       ctx=mx.gpu(0))
    blk.cast("bfloat16")
    y = torch.arange(8, device="cuda")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for block in (net, blk):
        before = BNF.LAUNCHES_STATS, BNF.LAUNCHES_BWD_DX
        with mx.autograd.record():
            loss = loss_fn(block(x.to(torch.bfloat16)), y)
        loss.backward()
        torch.cuda.synchronize()
        assert (BNF.LAUNCHES_STATS - before[0],
                BNF.LAUNCHES_BWD_DX - before[1]) == (20, 20)
        ps = block.collect_params()
        out.append((loss.float().cpu(),
                    {n: p._grad_tensor().float().cpu()
                     for n, p in ps.items() if p.grad_req != "null"}))
    assert torch.equal(out[0][0], out[1][0])
    assert sorted(out[0][1]) == sorted(out[1][1])
    for n, g in out[0][1].items():
        assert torch.equal(out[1][1][n], g), n


# CUDA kernel names of the BatchNorm and conv_fused launch counters: a
# device-trace kernel whose name holds every part of one alternative
# belongs to the counter.
_DEVICE_NAMES = {
    "LAUNCHES_STATS": (("bn_fold_kernel", "StatsOp"),),
    "LAUNCHES_APPLY": (("bn_apply_kernel",),),
    "LAUNCHES_BWD_REDUCE": (("bn_fold_kernel", "BwdOp"),),
    "LAUNCHES_BWD_DX": (("bn_bwd_dx_kernel",),),
    "LAUNCHES_FINALIZE": (("bn_finalize_kernel",),),
    "CF.LAUNCHES": (("conv_fused_fwd_bf16_kernel",),
                    ("conv_fused_f32_kernel",)),
    "CF.LAUNCHES_BWD_DX": (("conv_bwd_dx_bf16_kernel",),
                           ("conv_bwd_dx_f32_kernel",)),
    "CF.LAUNCHES_BWD_DW": (("conv_bwd_dw_bf16_kernel",),
                           ("conv_bwd_dw_f32_kernel",)),
}


@pytest.mark.cuda
def test_profiler_device_trace_counts_equal_launch_counters(tmp_path):
    """Two fused steps of a narrow NHWC ResNet in bf16 under the port's
    profiler: its torch.profiler session loses no launch (matched by
    correlation id), and each kernel counted by its CUDA name in the
    device trace equals its launch counter over the window."""
    _need_card()
    from mxnet_tpu_torch import profiler as prof
    net = tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1],
                        [16, 32, 64, 128, 256], classes=10, thumbnail=True,
                        layout="NHWC", fuse=True)
    net.initialize(ctx=mx.gpu(0))
    net(torch.zeros(1, 3, 32, 32, device="cuda"))
    net.cast("bfloat16")
    net.hybridize()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.01, "momentum": 0.9})
    step = mx.gluon.train_step(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               tr)
    x = torch.randn(8, 3, 32, 32, device="cuda", dtype=torch.bfloat16)
    y = torch.arange(8, device="cuda").float()
    step(x, y)
    torch.cuda.synchronize()
    prof._reset()
    prof.set_config(filename=str(tmp_path / "p.json"), xprof=True,
                    xprof_dir=str(tmp_path / "x"))
    for name in [n for n in _DEVICE_NAMES if not n.startswith("CF.")]:
        setattr(BNF, name, 0)
    CF.LAUNCHES = CF.LAUNCHES_BWD_DX = CF.LAUNCHES_BWD_DW = 0
    try:
        prof.set_state("run")
        for _ in range(2):
            step(x, y)
        prof.set_state("stop")
        dev = prof.metrics()["profiler"]
    finally:
        prof._reset()
        prof.set_config(xprof=True, filename="profile.json")
        prof._state["xprof_dir"] = None
    assert dev["error"] is None and dev["lost"] == 0, dev
    device = dict.fromkeys(_DEVICE_NAMES, 0)
    for kname, n in dev["kernels"].items():
        for key, alts in _DEVICE_NAMES.items():
            if any(all(p in kname for p in alt) for alt in alts):
                device[key] += n
    counters = {k: (getattr(CF, k[3:]) if k.startswith("CF.")
                    else getattr(BNF, k)) for k in _DEVICE_NAMES}
    assert device == counters
    assert counters["CF.LAUNCHES"] > 0 and counters["LAUNCHES_STATS"] > 0


def _chip_smoke_module():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_health_summary_on_the_card_matches_the_cpu():
    """The sentinels' packed vector (_debug/healthmon.graph_summary) on the
    card against its CPU value: sums within 1e-5, the same buckets
    flagged."""
    _need_card()
    from mxnet_tpu_torch._debug import healthmon
    from mxnet_tpu_torch.parallel.overlap import bucket_plan
    rs = np.random.RandomState(0)
    shapes = [(64, 3, 3, 3), (64,), (256, 64), (10, 256), (10,)]
    dts = [torch.bfloat16, torch.bfloat16, torch.float32, torch.float32,
           torch.float32]
    for poison in (None, 2):
        gs = [torch.from_numpy(rs.randn(*s).astype("float32")).to(d)
              for s, d in zip(shapes, dts)]
        ws = [torch.from_numpy(rs.randn(*s).astype("float32")).to(d)
              for s, d in zip(shapes, dts)]
        if poison is not None:
            gs[poison].view(-1)[7] = float("nan")
        loss = torch.from_numpy(rs.rand(32).astype("float32"))
        plan = [list(b) for b in bucket_plan(gs, bucket_bytes=20000)]
        cpu, _ = healthmon.graph_summary(plan, gs, ws, loss)
        card, ok = healthmon.graph_summary(
            plan, [g.cuda() for g in gs], [w.cuda() for w in ws],
            loss.cuda())
        card = card.cpu().numpy()
        cpu = cpu.numpy()
        assert bool(ok) == (poison is None)
        np.testing.assert_array_equal(np.isfinite(card), np.isfinite(cpu))
        fin = np.isfinite(cpu)
        np.testing.assert_allclose(card[fin], cpu[fin], rtol=1e-5)


@pytest.mark.cuda
def test_kernel_costs_give_chip_smoke_bounds():
    """One cost() per kernel against chip_smoke.py's bound for the same
    shapes on this card: the bound is max(operations / peak, bytes / rate)
    of the kernel's own count."""
    _need_card()
    from mxnet_tpu_torch._debug import perfmodel
    from mxnet_tpu_torch.kernels import compression as CMP
    from mxnet_tpu_torch.kernels import optimizer_apply as OA
    cs = _chip_smoke_module()
    card = cs.peaks(torch.cuda.get_device_name(0))
    _, (bf16, f32, bw) = card
    shape = (128, 28, 28, 128, 128)
    f, b = CF.cost(shape, 2)
    assert cs.bound(shape, 2, card)[0] == max(f / bf16, b / bw)
    f, b = CF.cost(shape, 2, "bwd_dx")
    assert cs.conv_bwd_bound(shape, "bwd_dx", 2, card)[0] \
        == max(f / bf16, b / bw)
    f, b = BNF.cost((128, 56, 56, 256), "bwd_dx", 2)
    assert cs.bn_bound((128, 56, 56, 256), "bwd_dx", 2, card)[0] \
        == max(f / f32, b / bw)
    f, b = QM.cost(1568, 4608, 512, True)
    assert cs.qmm_bound(1568, 4608, 512, True, card)[0] \
        == max(f / perfmodel.INT8_PEAKS[card[0]], b / bw)
    f, b = FA.cost("dkv", cs.LM_BATCH, 32, cs.LM_SEQ, cs.LM_SEQ, 128, True, 2)
    assert cs.flash_bound("dkv", card)[0] == max(f / bf16, b / bw)
    f, b = OA.cost("sgd_momentum", 25557032, 161, 2)
    assert (f, b) == (7 * 25557032, 2 * 5 * 25557032 + 8 * 161)
    f, b = CMP.cost("quantize", 1000, CMP.num_words(1000), 2)
    assert (f, b) == (6 * 1000, 3 * 2 * 1000 + 4 * CMP.num_words(1000))


@pytest.mark.cuda
def test_step_cost_count_on_the_card_equals_the_cpu():
    """The fused step's cost count of a narrow NHWC ResNet: flops and
    bytes the same on the card as on the CPU, flops the analytic count;
    the card's row carries the card table's peak."""
    _need_card()
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch._debug import perfmodel
    cs = _chip_smoke_module()
    rs = np.random.RandomState(1)
    x = rs.rand(4, 3, 32, 32).astype("float32")
    y = rs.randint(0, 10, (4,)).astype("float32")
    recs = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        net = tres.ResNetV1(tres.BottleneckV1, [1, 1, 1, 1],
                            [16, 32, 64, 128, 256], classes=10,
                            thumbnail=True, layout="NHWC", fuse=True)
        net.initialize(ctx=ctx)
        net(torch.zeros(1, 3, 32, 32, device=ctx.device))
        net.hybridize()
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.01, "momentum": 0.9})
        step = mx.gluon.train_step(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), tr)
        profiler._reset()
        with ctx:
            step(torch.from_numpy(x).to(ctx.device),
                 torch.from_numpy(y).to(ctx.device))
        recs[ctx.device_type] = dict(profiler.compile_stats()["fused_step"])
    profiler._reset()
    want = cs.resnet_v1_step_flops([1, 1, 1, 1], [16, 32, 64, 128, 256], 4,
                                   32, 10, thumbnail=True)
    assert recs["gpu"]["flops"] == recs["cpu"]["flops"] == want
    assert recs["gpu"]["bytes_accessed"] == recs["cpu"]["bytes_accessed"]
    assert perfmodel._assumptions()["chip"] in torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_word_lm_step_on_the_card_matches_the_cpu():
    """chip_smoke.py's word LM (a tied 2-layer LSTM over the fused RNN op),
    narrow: one f32 step (dropout 0, TF32 off) on the card against the
    CPU from the same weights: the loss within 1e-5 relative, every
    gradient within 1e-4 and every updated weight within 1e-5 of its
    tensor's largest value."""
    _need_card()
    cs = _chip_smoke_module()
    kw = dict(vocab=500, embed=32, hidden=32, layers=2)
    model, _, _ = cs.wlm_setup(mx, mx.cpu(), 0.0, **kw)
    arrays = {n: p.data().asnumpy()
              for n, p in model.collect_params().items()}
    stream = torch.from_numpy(cs.wlm_stream(steps=1, batch=8, bptt=12,
                                            vocab=500))
    (lg, gg, wg), (lc, gc, wc) = cs.wlm_card_vs_cpu(
        mx, arrays, stream[:12], stream[1:13], **kw)
    assert cs._rel(lg, lc) <= cs.WLM_LOSS_RTOL
    assert cs._worst(gg, gc)[0] <= cs.WLM_GRAD_RTOL
    assert cs._worst(wg, wc)[0] <= cs.WLM_WEIGHT_RTOL


@pytest.mark.cuda
def test_bucketing_module_step_on_the_card_matches_the_cpu():
    """lstm_bucketing.py's model, narrow: one BucketingModule
    forward/backward/update per bucket key on the card and on the CPU
    from the same parameters (f32, TF32 off): outputs within 1e-4 and
    parameters within 1e-5 of each tensor's largest value."""
    _need_card()
    cs = _chip_smoke_module()
    it, vocab = cs.bucket_data(mx)
    _, sym_gen = cs.bucket_lm(mx, vocab, hidden=24, embed=16)
    batches = {}
    for b in it:
        batches.setdefault(b.bucket_key, b)
    results = []
    with mx.precision.matmul_precision("float32"):
        for ctx in (mx.gpu(0), mx.cpu()):
            mod = mx.mod.BucketingModule(
                sym_gen, default_bucket_key=it.default_bucket_key,
                context=ctx)
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params(initializer=mx.init.Zero())
            if not results:
                rs = np.random.RandomState(0)
                params = {k: (rs.rand(*v.shape) * 0.2 - 0.1).astype("f")
                          for k, v in sorted(mod.get_params()[0].items())}
            mod.set_params({k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in params.items()}, {})
            mod.init_optimizer(optimizer="sgd", optimizer_params={
                "learning_rate": 0.01, "momentum": 0.9})
            outs = []
            for key in sorted(batches):
                b = batches[key]
                batch = mx.io.DataBatch(
                    [mx.nd.array(b.data[0].asnumpy(), ctx=ctx)],
                    [mx.nd.array(b.label[0].asnumpy(), ctx=ctx)],
                    bucket_key=key, provide_data=b.provide_data,
                    provide_label=b.provide_label)
                mod.forward(batch, is_train=True)
                outs.append(mod.get_outputs()[0].asnumpy())
                mod.backward()
                mod.update()
            results.append((outs, {k: v.asnumpy() for k, v in
                                   mod.get_params()[0].items()}))
    (og, pg), (oc, pc) = results
    for a, b in zip(og, oc):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    for k in pc:
        assert np.abs(pg[k] - pc[k]).max() <= 1e-5 * np.abs(pc[k]).max(), k
