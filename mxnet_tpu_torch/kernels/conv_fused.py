"""Fused scale-bias-ReLU + 3x3 convolution: the Hopper kernels and their
plain PyTorch versions (counterpart of mxnet_tpu/pallas_kernels/conv_fused.py).

    y = conv3x3(relu(x * s + b), W)        # stride 1, SAME padding, NHWC

``fused_scale_relu_conv3x3`` is differentiable: a ``torch.library`` custom
op whose forward is the forward kernel and whose backward is the d-input
kernel (dx, with the ds/db partials and a finalize launch that folds them)
and the d-weight kernel (dW partials and a reduce launch), all in
``csrc/conv_fused.cu``. In bf16 all three kernels are persistent: one
block per SM walks the work items of ``fwd_plan``, ``dx_plan`` or
``dw_plan``. A CPU
tensor runs ``fused_conv_reference`` forward and
``fused_conv_backward_reference`` backward; a CUDA tensor launches the
kernels or raises. There is no other route. The kernels' design note is in
their source.

Layouts are the JAX package's: x (N, H, W, Ci) NHWC, s and b (Ci,) float32
(the folded BatchNorm scale and bias), w (3, 3, Ci, Co) HWIO.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as tF

from ..base import MXNetError

__all__ = ["fused_scale_relu_conv3x3", "fused_conv_reference",
           "fused_conv_backward_reference", "backward_input_reference",
           "backward_weight_reference", "fused_conv_backward",
           "compute_dtype", "fwd_plan", "dx_plan", "dw_plan", "LAUNCHES",
           "LAUNCHES_BWD_DX", "LAUNCHES_BWD_DW",
           "LAUNCHES_FINALIZE", "LAUNCHES_REDUCE", "COPIES"]

# Kernel launches in this process: LAUNCHES counts the forward kernel,
# LAUNCHES_BWD_DX and LAUNCHES_BWD_DW the two backward kernels,
# LAUNCHES_FINALIZE the launch that folds the d-input kernel's ds/db
# partials and LAUNCHES_REDUCE the one that adds the d-weight partials.
# COPIES counts dy tensors that had to be made contiguous for the backward.
LAUNCHES = 0
LAUNCHES_BWD_DX = 0
LAUNCHES_BWD_DW = 0
LAUNCHES_FINALIZE = 0
LAUNCHES_REDUCE = 0
COPIES = 0

# The kernels' output tile (virtual rows x columns; csrc/conv_fused.cu).
_TH, _TW = 16, 8
# d-weight work items: input channels per item (bf16 and f32 kernels) and
# output channels per item.
_DW_CK = {torch.bfloat16: 64, torch.float32: 16}
_DW_BN = 64
# The bf16 planner's cost model, estimates that only weigh one against the
# other: device us for one pixel tile of one item (128 pixels x 64 x 64 x
# 9 taps, about 9.4 MFLOP), and the rate at which the f32 partials are
# written and read back by the reduce (bytes per us).
_DW_TILE_US = 2.0
_DW_PART_BYTES_PER_US = 2.5e6

DwPlan = collections.namedtuple("DwPlan", "nsplit tps items grid")
# The bf16 d-input and forward kernels' channels per box (a block of result
# channels is one or two boxes).
_DX_BOX = 64
DxPlan = collections.namedtuple("DxPlan",
                                "nb cblocks pairs items grid resident")
FwdPlan = collections.namedtuple("FwdPlan",
                                 "nb cblocks pairs items grid resident")


def compute_dtype(dtype):
    """The dtype the convolution runs in: bf16 and f32 as they are, other
    half types as bf16, wider floats as f32 (``_compute_dtype`` of the JAX
    module)."""
    if dtype in (torch.bfloat16, torch.float32):
        return dtype
    if not dtype.is_floating_point:
        raise TypeError("fused_scale_relu_conv3x3: floating input "
                        "required, got %s" % dtype)
    return torch.bfloat16 if dtype.itemsize <= 2 else torch.float32


def _pre(x, s, b):
    """x*s + b in the compute dtype, each op rounded there (``_act``)."""
    cdt = compute_dtype(x.dtype)
    return x.to(cdt) * s.to(cdt) + b.to(cdt)


def fused_conv_reference(x, s, b, w, relu=True):
    """Plain PyTorch semantics of the fused op: the activation in the
    compute dtype, the convolution in float32 on the upcast operands, the
    result cast to ``x.dtype``. On a CUDA tensor the caller decides TF32
    (``torch.backends.cudnn.allow_tf32``)."""
    cdt = compute_dtype(x.dtype)
    pre = _pre(x, s, b)
    z = torch.clamp_min(pre, 0) if relu else pre
    out = tF.conv2d(z.float().permute(0, 3, 1, 2),
                    w.to(cdt).float().permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def fused_conv_backward_reference(x, s, b, w, dy, relu=True):
    """Plain PyTorch backward of the fused op, the semantics of the JAX
    package's ``_pallas_backward``. Returns ``(dx, ds, db, dw)``:

        dz   = conv3x3(dy, W flipped in space, transposed)   # f32
        dpre = dz * (pre > 0) if relu else dz,  pre = x*s + b (compute dtype)
        dx   = dpre * s                                       # x.dtype
        ds   = sum(dpre * x),  db = sum(dpre)                 # s/b dtype
        dw   = sum over pixels of patches(relu(pre))^T dy     # f32 -> w.dtype

    The mask compares ``pre`` in f32 after rounding it in the compute
    dtype; ``ds`` multiplies by ``x`` (upcast), not by ``pre``; padding is
    zero in activated space. The two halves are
    ``backward_input_reference`` (the d-input kernel's function) and
    ``backward_weight_reference`` (the d-weight kernel's)."""
    dx, ds, db = backward_input_reference(x, s, b, w, dy, relu)
    return dx, ds, db, backward_weight_reference(x, s, b, w, dy, relu)


def backward_input_reference(x, s, b, w, dy, relu=True):
    """``(dx, ds, db)`` of ``fused_conv_backward_reference``."""
    cdt = compute_dtype(x.dtype)
    pre = _pre(x, s, b)
    dyc = dy.to(cdt).float().permute(0, 3, 1, 2)
    wf = torch.flip(w.to(cdt).float(), (0, 1)).permute(2, 3, 0, 1)
    dz = tF.conv2d(dyc, wf, padding=1).permute(0, 2, 3, 1)
    dpre = dz * (pre.float() > 0) if relu else dz
    dx = (dpre * s.float()).to(x.dtype)
    ds = (dpre * x.float()).sum(dim=(0, 1, 2)).to(s.dtype)
    db = dpre.sum(dim=(0, 1, 2)).to(b.dtype)
    return dx, ds, db


def backward_weight_reference(x, s, b, w, dy, relu=True):
    """``dw`` of ``fused_conv_backward_reference``."""
    cdt = compute_dtype(x.dtype)
    pre = _pre(x, s, b)
    z = torch.clamp_min(pre, 0) if relu else pre
    dyc = dy.to(cdt).float().permute(0, 3, 1, 2)
    ci, co = w.shape[2], w.shape[3]
    dw = torch.nn.grad.conv2d_weight(
        z.float().permute(0, 3, 1, 2), (co, ci, 3, 3), dyc, padding=1)
    return dw.permute(2, 3, 1, 0).to(w.dtype)


def _check(x, s, b, w):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[-1]:
        raise ValueError("fused_scale_relu_conv3x3: need NHWC x and "
                         "(3,3,Ci,Co) w, got %s / %s"
                         % (tuple(x.shape), tuple(w.shape)))
    ci = x.shape[-1]
    if tuple(s.shape) != (ci,) or tuple(b.shape) != (ci,):
        raise ValueError("fused_scale_relu_conv3x3: s and b must be (%d,), "
                         "got %s / %s" % (ci, tuple(s.shape),
                                          tuple(b.shape)))
    for t in (s, b, w):
        if t.device != x.device:
            raise ValueError("fused_scale_relu_conv3x3: operands on %s and "
                             "%s" % (x.device, t.device))
        if not t.dtype.is_floating_point:
            raise TypeError("fused_scale_relu_conv3x3: floating operands "
                            "required, got %s" % t.dtype)
    compute_dtype(x.dtype)
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise MXNetError("fused_scale_relu_conv3x3: no kernel for device %s"
                         % x.device)


@torch.library.custom_op("mxnet_tpu_torch::fused_scale_relu_conv3x3",
                         mutates_args=())
def _fused_conv(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
                w: torch.Tensor, relu: bool) -> torch.Tensor:
    """The forward as one dispatcher op, so that a selective checkpoint
    policy sees it (and keeps its output, "conv_out", instead of
    launching the kernel again in a recompute; ``remat.py``)."""
    if x.device.type == "cpu":
        return fused_conv_reference(x, s, b, w, relu)
    return _launch(x, s, b, w, relu)


@_fused_conv.register_fake
def _fused_conv_fake(x, s, b, w, relu):
    return x.new_empty(tuple(x.shape[:3]) + (w.shape[-1],))


def _fused_conv_setup(ctx, inputs, output):
    x, s, b, w, relu = inputs
    ctx.relu = relu
    ctx.save_for_backward(x, s, b, w)


def _fused_conv_backward(ctx, dy):
    x, s, b, w = ctx.saved_tensors
    dx, ds, db, dw = fused_conv_backward(x, s, b, w, dy, ctx.relu)
    return dx, ds, db, dw, None


_fused_conv.register_autograd(_fused_conv_backward,
                              setup_context=_fused_conv_setup)


def fused_scale_relu_conv3x3(x, s, b, w, relu=True):
    """conv3x3(relu(x*s + b), w) with the normalize/ReLU chain applied on
    the kernel's operand load. ``relu=False`` gives conv3x3(x*s + b, w).
    Differentiable in x, s, b and w.

    A CPU tensor runs ``fused_conv_reference`` (and the plain backward). A
    CUDA tensor launches the kernels on the current stream, or raises:
    non-contiguous ``x``, an unsupported dtype, mismatched shapes or a
    failed launch are errors. A ``meta`` tensor (shape inference) gives an
    empty output of the right shape and dtype.
    """
    _check(x, s, b, w)
    if x.device.type == "meta":
        return x.new_empty(tuple(x.shape[:3]) + (w.shape[-1],))
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("fused_scale_relu_conv3x3: x must be contiguous "
                         "NHWC")
    return _fused_conv(x, s, b, w, bool(relu))


def fused_conv_backward(x, s, b, w, dy, relu=True):
    """``(dx, ds, db, dw)`` of the fused op for the output gradient
    ``dy``. A CPU tensor runs ``fused_conv_backward_reference``; a CUDA
    tensor launches the d-input kernel and its finalize launch, then the
    d-weight kernel and its reduce launch, or raises. A non-contiguous
    ``dy`` is copied first (counted in ``COPIES``)."""
    global COPIES
    _check(x, s, b, w)
    if tuple(dy.shape) != tuple(x.shape[:3]) + (w.shape[-1],) \
            or dy.device != x.device:
        raise ValueError("fused_conv_backward: dy %s on %s, want %s on %s"
                         % (tuple(dy.shape), dy.device,
                            tuple(x.shape[:3]) + (w.shape[-1],), x.device))
    if x.device.type == "cpu":
        return fused_conv_backward_reference(x, s, b, w, dy, relu)
    if x.device.type == "meta":
        return (torch.empty_like(x), torch.empty_like(s),
                torch.empty_like(b), torch.empty_like(w))
    if not x.is_contiguous():
        raise ValueError("fused_conv_backward: x must be contiguous NHWC")
    if not dy.is_contiguous():
        dy = dy.contiguous()
        COPIES += 1
    return _launch_backward(x, s, b, w, dy, bool(relu))


# -- launch plumbing ----------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "conv_fused_fwd": [_P] * 5 + [_I] * 6 + [_P],
    "conv_fused_fwd_bf16": [_P] * 5 + [_I] * 9 + [_P],
    "conv_fused_bwd_dx": [_P] * 7 + [_I] * 6 + [_P],
    "conv_fused_bwd_dx_bf16": [_P] * 7 + [_I] * 9 + [_P],
    "conv_fused_bwd_dw_f32": [_P] * 5 + [_I] * 8 + [_P],
    "conv_fused_bwd_dw_bf16": [_P] * 5 + [_I] * 9 + [_P],
    "conv_fused_bwd_finalize": [_P, _I, _I, _P, _P, _P],
    "conv_fused_dw_reduce": [_P, _I, ctypes.c_longlong, _P, _P],
}


def _fn(name, dtype=None):
    from . import _build
    sym = name if dtype is None else "%s_%s" % (
        name, "bf16" if dtype == torch.bfloat16 else "f32")
    fn = getattr(_build.load("conv_fused"), sym)
    if fn.argtypes is None:
        fn.argtypes = _SIGS.get(sym, _SIGS.get(name))
        fn.restype = _I
    return fn


def _call(what, shape, fn, *args):
    err = fn(*args)
    if err != 0:
        raise MXNetError("conv_fused %s launch failed: cudaError %d "
                         "(N, H, W, Ci, Co = %s)" % (what, err, shape))


def tiles(N, H, W):
    """Output tiles of the kernels' grid over the virtual tall image (one
    zero separator row between images): the f32 d-input kernel writes one
    ds/db partial per tile; the bf16 one takes them in pairs (``dx_plan``)."""
    return -(-(N * (H + 1) - 1) // _TH) * -(-W // _TW)


@functools.lru_cache(maxsize=256)
def fwd_plan(N, H, W, Ci, Co, n_sm):
    """The bf16 forward kernel's work partition on a card of ``n_sm`` SMs,
    for channel counts already padded to multiples of 8: a
    ``FwdPlan(nb, cblocks, pairs, items, grid, resident)``.

    An item is (tile pair, co block): the block's two consumer warpgroups
    take tiles 2*pair and 2*pair + 1 of ``tiles(N, H, W)`` (past the last
    tile, a tile is all padding) for ``64*nb`` output channels, every input
    channel and tap. Items are numbered co-block-major (item = cb * pairs +
    pair), so that the blocks in flight read the same weights; ``grid``
    persistent blocks, at most one per SM, take items ``i, i + grid, ...``.
    ``nb`` (1 or 2) makes the busiest block's work least: its rounds of
    items times the 64*nb channels of an item, ties going to 2, whose x
    halo serves twice the channels. ``resident``: every item reads the same
    nine weight pieces (Ci <= 64 and Co <= 64), which the kernel then loads
    once."""
    pairs = -(-tiles(N, H, W) // 2)
    best = None
    for nb in (2, 1):
        cblocks = -(-Co // (_DX_BOX * nb))
        items = pairs * cblocks
        grid = min(items, n_sm)
        cost = -(-items // grid) * nb
        if best is None or cost < best[0]:
            best = (cost, FwdPlan(nb, cblocks, pairs, items, grid,
                                  nb == 1 and cblocks == 1
                                  and Ci <= _DX_BOX))
    return best[1]


@functools.lru_cache(maxsize=256)
def dx_plan(N, H, W, Ci, Co, n_sm):
    """The bf16 d-input kernel's work partition on a card of ``n_sm`` SMs,
    for channel counts already padded to multiples of 8: a
    ``DxPlan(nb, cblocks, pairs, items, grid, resident)``.

    An item is (tile pair, ci block): the block's two consumer warpgroups
    take tiles 2*pair and 2*pair + 1 of ``tiles(N, H, W)`` (past the last
    tile, a tile is all padding) for ``64*nb`` input channels, every dy
    channel and tap. Items are numbered ci-block-major (item = cb * pairs +
    pair), so that the blocks in flight read the same weights; ``grid``
    persistent blocks, at most one per SM, take items ``i, i + grid, ...``,
    and each of a block's two consumers adds its items' ds/db sums to its
    own row of the partials in that order (``2 * grid`` rows for the
    finalize). ``nb`` is 2 where Ci exceeds 64, so that a dy halo serves 128
    input channels. ``resident``: every item reads the same nine weight
    pieces (one ci block of 64, Co <= 64), which the kernel then loads
    once."""
    nb = 1 if Ci <= _DX_BOX else 2
    cblocks = -(-Ci // (_DX_BOX * nb))
    pairs = -(-tiles(N, H, W) // 2)
    items = pairs * cblocks
    return DxPlan(nb, cblocks, pairs, items, min(items, n_sm),
                  nb == 1 and cblocks == 1 and Co <= _DX_BOX)


@functools.lru_cache(maxsize=256)
def dw_plan(N, H, W, Ci, Co, dtype, n_sm):
    """The d-weight kernel's work partition on a card of ``n_sm`` SMs: a
    ``DwPlan(nsplit, tps, items, grid)``. The pixel tiles are cut into
    ``nsplit`` K-splits of ``tps`` tiles (every split non-empty); an item is
    (split, input-channel chunk, output-channel block), numbered
    split-major, and ``grid`` blocks take items ``i, i + grid, ...``.

    bf16: one persistent block per SM. ``nsplit`` minimises the cost
    model's time: the most tiles any block walks (rounds of ``grid`` items
    times ``tps``) plus the partials' round trip through the reduce, so the
    item count lands on a whole multiple of the SM count, or close to it.
    f32: one block per item, about two waves of the card."""
    t = tiles(N, H, W)
    per_split = -(-Ci // _DW_CK[dtype]) * -(-Co // _DW_BN)

    def split(ns):
        tps = -(-t // ns)
        return -(-t // tps), tps

    if dtype != torch.bfloat16:
        nsplit, tps = split(max(1, min(t, -(-2 * n_sm // per_split))))
        items = nsplit * per_split
        return DwPlan(nsplit, tps, items, items)
    best = None
    for ns in range(1, min(t, max(1, 8 * n_sm // per_split)) + 1):
        nsplit, tps = split(ns)
        items = nsplit * per_split
        rounds = -(-items // min(items, n_sm))
        cost = rounds * tps * _DW_TILE_US \
            + nsplit * 9 * Ci * Co * 8 / _DW_PART_BYTES_PER_US
        if best is None or cost < best[0]:
            best = (cost, DwPlan(nsplit, tps, items, min(items, n_sm)))
    return best[1]


def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(x, s, b, w, relu):
    """The forward kernel: the result in x's dtype. The bf16 kernel reads x
    and the weights in boxes of 16-byte rows and stores the result in boxes
    of 16-byte rows: where Ci or Co is not a multiple of 8, or a base is not
    16-byte aligned, the operands are first copied into zero-padded ones
    (x, s and b pad with zeros, so the extra channels activate to 0*0 + 0)
    and the result is cut back. Its weights go as (9, Ci, co64), the rows
    padded with zeros to a multiple of 64 output channels."""
    global LAUNCHES
    N, H, W_, Ci = x.shape
    Co = w.shape[-1]
    cdt = compute_dtype(x.dtype)
    xc = x if x.dtype == cdt else x.to(cdt)
    s2 = s.to(torch.float32).contiguous()
    b2 = b.to(torch.float32).contiguous()
    out = torch.empty((N, H, W_, Co), dtype=cdt, device=x.device)
    if out.numel() == 0:
        return out.to(x.dtype)
    if Ci == 0:
        return out.zero_().to(x.dtype)
    shape = (N, H, W_, Ci, Co)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if cdt == torch.bfloat16:
            out = _launch_bf16(xc, s2, b2, w.to(cdt), relu, shape, stream)
        else:
            w2 = w.reshape(9 * Ci, Co).to(cdt).contiguous()
            _call("forward", shape, _fn("conv_fused_fwd", cdt),
                  xc.data_ptr(), s2.data_ptr(), b2.data_ptr(), w2.data_ptr(),
                  out.data_ptr(), N, H, W_, Ci, Co, int(relu), stream)
    LAUNCHES += 1
    return out if out.dtype == x.dtype else out.to(x.dtype)


def _launch_bf16(x, s, b, w, relu, shape, stream):
    N, H, W, Ci, Co = shape
    ci8, co8 = -(-Ci // 8) * 8, -(-Co // 8) * 8
    if (ci8, co8) != (Ci, Co) or x.data_ptr() % 16:
        x = tF.pad(x, (0, ci8 - Ci))
        s, b = tF.pad(s, (0, ci8 - Ci)), tF.pad(b, (0, ci8 - Ci))
    co64 = -(-co8 // _DX_BOX) * _DX_BOX
    if (ci8, co64) != (Ci, Co):
        w = tF.pad(w, (0, co64 - Co, 0, ci8 - Ci))
    w = w.reshape(9, ci8, co64)
    if not w.is_contiguous() or w.data_ptr() % 16:
        w = w.clone(memory_format=torch.contiguous_format)
    out = torch.empty((N, H, W, co8), dtype=x.dtype, device=x.device)
    plan = fwd_plan(N, H, W, ci8, co8, _sm_count(x.device))
    _call("forward", shape, _fn("conv_fused_fwd", torch.bfloat16),
          x.data_ptr(), s.data_ptr(), b.data_ptr(), w.data_ptr(),
          out.data_ptr(), N, H, W, ci8, co8, int(relu), plan.nb, plan.grid,
          int(plan.resident), stream)
    return out if co8 == Co else out[..., :Co].contiguous()


def _launch_backward(x, s, b, w, dy, relu):
    N, H, W_, Ci = x.shape
    Co = w.shape[-1]
    cdt = compute_dtype(x.dtype)
    dev = x.device
    if x.numel() == 0 or Co == 0:
        z = torch.zeros(Ci, dtype=torch.float32, device=dev)
        return (torch.zeros_like(x), z.to(s.dtype), z.to(b.dtype),
                torch.zeros_like(w))
    xc = x if x.dtype == cdt else x.to(cdt)
    dyc = dy if dy.dtype == cdt else dy.to(cdt)
    s2 = s.to(torch.float32).contiguous()
    b2 = b.to(torch.float32).contiguous()
    wc = w.to(cdt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        dx, ds, db = _launch_dx(xc, s2, b2, wc, dyc, relu, stream)
        dw = _launch_dw(xc, s2, b2, dyc, relu, stream)
    return (dx if dx.dtype == x.dtype else dx.to(x.dtype), ds.to(s.dtype),
            db.to(b.dtype), dw.to(w.dtype))


def _launch_dx(x, s, b, w, dy, relu, stream):
    """The d-input kernel and its finalize: dx in the compute dtype, ds and
    db (Ci,) float32. The weights go flipped in space and transposed to (9,
    Co, Ci), as _pallas_backward does. The bf16 kernel reads dy and the
    weights in boxes of 16-byte rows and x and dx 16 bytes at a time: where
    Ci or Co is not a multiple of 8, or a base is not 16-byte aligned, the
    operands are first copied into zero-padded ones (x, s and b pad with
    zeros, so the extra channels' pre is 0 and their dpre 0) and the
    results are cut back. Its weight rows are padded with zeros to a
    multiple of 64 channels."""
    global LAUNCHES_BWD_DX, LAUNCHES_FINALIZE
    N, H, W, Ci = x.shape
    Co = dy.shape[-1]
    shape = (N, H, W, Ci, Co)
    dev = x.device
    if x.dtype == torch.bfloat16:
        ci8, co8 = -(-Ci // 8) * 8, -(-Co // 8) * 8
        if (ci8, co8) != (Ci, Co) or x.data_ptr() % 16 or dy.data_ptr() % 16:
            x, dy = tF.pad(x, (0, ci8 - Ci)), tF.pad(dy, (0, co8 - Co))
            s, b = tF.pad(s, (0, ci8 - Ci)), tF.pad(b, (0, ci8 - Ci))
            w = tF.pad(w, (0, co8 - Co, 0, ci8 - Ci))
    cip, cop = x.shape[-1], dy.shape[-1]
    wt = torch.flip(w, (0, 1)).permute(0, 1, 3, 2)
    if x.dtype == torch.bfloat16:
        # the kernel reads wt's rows in blocks of 64 input channels
        wt = tF.pad(wt, (0, -(-cip // _DX_BOX) * _DX_BOX - cip))
    wt = wt.reshape(9 * cop, -1).contiguous()
    dx = torch.empty((N, H, W, cip), dtype=x.dtype, device=dev)
    ds = torch.empty(cip, dtype=torch.float32, device=dev)
    db = torch.empty_like(ds)
    args = [dy.data_ptr(), wt.data_ptr(), x.data_ptr(), s.data_ptr(),
            b.data_ptr(), dx.data_ptr()]
    if x.dtype == torch.bfloat16:
        plan = dx_plan(N, H, W, cip, cop, _sm_count(dev))
        rows = 2 * plan.grid
        part = torch.empty((2, rows, cip), dtype=torch.float32, device=dev)
        args += [part.data_ptr(), N, H, W, cip, cop, int(relu), plan.nb,
                 plan.grid, int(plan.resident)]
    else:
        rows = tiles(N, H, W)
        part = torch.empty((2, rows, cip), dtype=torch.float32, device=dev)
        args += [part.data_ptr(), N, H, W, cip, cop, int(relu)]
    _call("d-input", shape, _fn("conv_fused_bwd_dx", x.dtype), *args,
          stream)
    LAUNCHES_BWD_DX += 1
    _call("finalize", shape, _fn("conv_fused_bwd_finalize"),
          part.data_ptr(), rows, cip, ds.data_ptr(), db.data_ptr(), stream)
    LAUNCHES_FINALIZE += 1
    if cip != Ci:
        return dx[..., :Ci].contiguous(), ds[:Ci], db[:Ci]
    return dx, ds, db


def _launch_dw(x, s, b, dy, relu, stream):
    """The d-weight kernel and its reduce: dW (3, 3, Ci, Co) float32. The
    bf16 kernel reads x and dy in boxes of 16-byte rows: where Ci or Co is
    not a multiple of 8, or a base is not 16-byte aligned, the operands are
    first copied into zero-padded ones (s and b pad with zeros, so the
    extra channels activate to 0) and the result is cut back."""
    global LAUNCHES_BWD_DW, LAUNCHES_REDUCE
    N, H, W, Ci = x.shape
    Co = dy.shape[-1]
    cdt = x.dtype
    if cdt == torch.bfloat16:
        ci8, co8 = -(-Ci // 8) * 8, -(-Co // 8) * 8
        if (ci8, co8) != (Ci, Co) or x.data_ptr() % 16 or dy.data_ptr() % 16:
            x, dy = tF.pad(x, (0, ci8 - Ci)), tF.pad(dy, (0, co8 - Co))
            s, b = tF.pad(s, (0, ci8 - Ci)), tF.pad(b, (0, ci8 - Ci))
    cip, cop = x.shape[-1], dy.shape[-1]
    plan = dw_plan(N, H, W, cip, cop, cdt, _sm_count(x.device))
    part = torch.empty((plan.nsplit, 9 * cip, cop), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((3, 3, cip, cop), dtype=torch.float32, device=x.device)
    args = [x.data_ptr(), s.data_ptr(), b.data_ptr(), dy.data_ptr(),
            part.data_ptr(), N, H, W, cip, cop, int(relu), plan.nsplit,
            plan.tps]
    if cdt == torch.bfloat16:
        args.append(plan.grid)
    shape = (N, H, W, Ci, Co)
    _call("d-weight", shape, _fn("conv_fused_bwd_dw", cdt), *args, stream)
    LAUNCHES_BWD_DW += 1
    _call("d-weight reduce", shape, _fn("conv_fused_dw_reduce"),
          part.data_ptr(), plan.nsplit, 9 * cip * cop, dw.data_ptr(), stream)
    LAUNCHES_REDUCE += 1
    return dw if (cip, cop) == (Ci, Co) else \
        dw[:, :, :Ci, :Co].contiguous()
