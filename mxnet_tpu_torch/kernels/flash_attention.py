"""Flash attention: the Hopper kernels and their plain PyTorch versions
(counterpart of mxnet_tpu/pallas_kernels/flash_attention.py).

    o = softmax(q k^T * scale, causal: col > row masked) v      q,k,v [B,H,S,D]

``flash_attention`` is differentiable: a ``torch.library`` custom op whose
forward is the forward kernel (it also returns the per-row logsumexp, which
the op saves with q, k, v and o) and whose backward is the flash-2 pair,
the dQ kernel and the dK/dV kernel, all in ``csrc/flash_attention.cu``. As
one dispatcher op, its (o, lse) can be kept by a selective checkpoint
policy, so that a recompute does not launch the forward again.
A CPU tensor runs ``flash_forward_reference`` and
``flash_backward_reference`` (the kernels' plain versions); a CUDA tensor
launches the kernels or raises. There is no other route. The kernels'
design note is in their source.

``_flash_forward`` and ``_flash_backward`` are the entry points that return
or take the logsumexp, as the JAX package's ``_pallas_forward`` and
``_pallas_backward`` are for its ring-flash attention.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "attention_reference", "flash_forward_reference",
           "flash_backward_reference", "backward_dq_reference",
           "backward_dkv_reference", "LAUNCHES", "COPIES"]

# Kernel launches in this process, by kernel: "fwd" (forward), "dq" and
# "dkv" (the backward pair). COPIES counts output gradients dO that had to
# be made contiguous for the backward.
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}
COPIES = 0

_HEAD_DIMS = (64, 128)
_DTYPES = (torch.bfloat16, torch.float32)


def _f32_matmul(a, b):
    """``a @ b`` accumulated in float32 (``preferred_element_type=f32``).
    Half-precision operands are upcast, which is exact, so the float32
    product of the upcast values is the JAX semantics; on the card TF32 may
    then run it, since a bf16 value is exact in TF32. Float32 (and float64)
    operands keep the caller's TF32 setting."""
    if a.dtype == b.dtype and a.dtype in (torch.float32, torch.float64):
        return torch.matmul(a, b)
    a32, b32 = a.float(), b.float()
    if not a32.is_cuda:
        return torch.matmul(a32, b32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(a32, b32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _scores(q, k, causal, scale):
    """(q . k) * scale in float32, causal entries (col > row) at -inf."""
    s = _f32_matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(mask, float("-inf"))
    return s


def attention_reference(q, k, v, causal=False, scale=None):
    """Plain O(S^2) attention. q,k,v: [B, H, S, D]. Scores and softmax in
    float32 whatever the input dtype; the probabilities are rounded to
    ``v.dtype`` before the product with v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def flash_forward_reference(q, k, v, causal=False, scale=None):
    """The forward kernel's function: ``(o, lse)`` with lse the float32 row
    logsumexp of the scaled, masked scores, shape [B*H, Sq]. As the kernel
    does, the unnormalised probabilities exp(s - max) are rounded to
    ``v.dtype`` before the product with v, and the float32 result is divided
    by the row sum before the cast to ``q.dtype``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, sq, _ = q.shape
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = _f32_matmul(e.to(v.dtype), v) / l
    lse = (m + torch.log(l)).reshape(b * h, sq)
    return o.to(q.dtype), lse


def _recompute_p_ds(q, k, v, o, lse, do, causal, scale):
    """The flash-2 recompute shared by the backward's plain versions:
    ``(p, dS)`` with p = exp(s - lse) in f32 and dS = p * (dP - delta) *
    scale rounded to q.dtype, dP = dO v^T, delta = rowsum(dO * O) in f32."""
    b, h, sq, _ = q.shape
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = _f32_matmul(do, v.transpose(-1, -2))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    return p, (p * (dp - delta) * scale).to(q.dtype)


def flash_backward_reference(q, k, v, o, lse, do, causal=False, scale=None):
    """The backward pair's function, the flash-2 recompute of the JAX
    package's ``_recompute_p_ds``: ``(dq, dk, dv)`` from the saved output
    ``o`` and row logsumexp ``lse`` [B*H, Sq].

        p     = exp(s - lse)                      f32, s as in the forward
        delta = rowsum(dO * O)                    f32
        dS    = p * (dP - delta) * scale,  dP = dO v^T,  rounded to q.dtype
        dq    = dS @ k,  dk = dS^T @ q,  dv = p(do.dtype)^T @ dO   (f32 sums)

    ``backward_dq_reference`` and ``backward_dkv_reference`` are its two
    halves, the functions of the dQ and the dK/dV kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p, ds = _recompute_p_ds(q, k, v, o, lse, do, causal, scale)
    return (_f32_matmul(ds, k).to(q.dtype),) + _dkv(q, do, p, ds, k, v)


def _dkv(q, do, p, ds, k, v):
    dk = _f32_matmul(ds.transpose(-1, -2), q).to(k.dtype)
    dv = _f32_matmul(p.to(do.dtype).transpose(-1, -2), do).to(v.dtype)
    return dk, dv


def backward_dq_reference(q, k, v, o, lse, do, causal=False, scale=None):
    """dq of ``flash_backward_reference``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _, ds = _recompute_p_ds(q, k, v, o, lse, do, causal, scale)
    return _f32_matmul(ds, k).to(q.dtype)


def backward_dkv_reference(q, k, v, o, lse, do, causal=False, scale=None):
    """(dk, dv) of ``flash_backward_reference``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p, ds = _recompute_p_ds(q, k, v, o, lse, do, causal, scale)
    return _dkv(q, do, p, ds, k, v)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, S, D], got "
                         "%s / %s / %s" % (tuple(q.shape), tuple(k.shape),
                                           tuple(v.shape)))
    b, h, _, d = q.shape
    if tuple(k.shape[:2]) != (b, h) or k.shape[3] != d \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError("flash_attention: shapes q %s, k %s, v %s do not "
                         "agree" % (tuple(q.shape), tuple(k.shape),
                                    tuple(v.shape)))
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention: q, k, v must share device and "
                             "dtype, got %s/%s, %s/%s" % (
                                 q.device, q.dtype, t.device, t.dtype))
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError("flash_attention: no kernel for device %s"
                         % q.device)
    if q.device.type == "cuda":
        if q.dtype not in _DTYPES:
            raise TypeError("flash_attention: the kernels take bfloat16 or "
                            "float32, got %s" % q.dtype)
        if d not in _HEAD_DIMS:
            raise ValueError("flash_attention: the kernels take head dim 64 "
                             "or 128, got %d" % d)
        if k.shape[2] == 0:
            raise ValueError("flash_attention: no keys (Sk = 0)")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not _kernel_layout(t):
                raise ValueError(
                    "flash_attention: %s has strides %s; the kernels need a "
                    "contiguous last dim and 16-byte aligned rows"
                    % (name, tuple(t.stride())))


def _kernel_layout(t):
    """Whether the kernels can read ``t`` [B, H, S, D] as it is: unit last
    stride, the other strides and the base 16-byte aligned."""
    align = 16 // t.element_size()
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        s % align == 0 or n == 1 for s, n in zip(t.stride()[:3],
                                                  t.shape[:3]))


def _flash_forward(q, k, v, causal, scale):
    """``(o, lse)``: the forward kernel for a CUDA tensor,
    ``flash_forward_reference`` for a CPU one."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, scale)
    return _launch_forward(q, k, v, causal, scale)


def _flash_backward(q, k, v, o, lse, do, causal, scale):
    """``(dq, dk, dv)``: the dQ and dK/dV kernels for a CUDA tensor,
    ``flash_backward_reference`` for a CPU one. A ``do`` whose layout the
    kernels cannot read is copied first (counted in ``COPIES``)."""
    global COPIES
    _check(q, k, v)
    if tuple(do.shape) != tuple(q.shape) or do.device != q.device:
        raise ValueError("flash_attention backward: dO %s on %s, want %s on "
                         "%s" % (tuple(do.shape), do.device, tuple(q.shape),
                                 q.device))
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, o, lse, do.to(q.dtype),
                                        causal, scale)
    if do.dtype != q.dtype:
        do = do.to(q.dtype)
    if not _kernel_layout(do):
        do = do.contiguous()
        COPIES += 1
    return _launch_backward(q, k, v, o, lse, do, causal, scale)


@torch.library.custom_op("mxnet_tpu_torch::flash_forward", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The forward as one dispatcher op, so that a selective checkpoint
    policy sees it and keeps (o, lse) instead of launching the kernel again
    in a recompute (``remat.py``; the LM's ``remat_save=("attn_o",)``)."""
    return _flash_forward(q, k, v, causal, scale)


@_flash_op.register_fake
def _flash_op_fake(q, k, v, causal, scale):
    b, h, sq, _ = q.shape
    return _like(q), q.new_empty((b * h, sq), dtype=torch.float32)


def _flash_op_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    o, lse = output
    ctx.causal, ctx.scale = causal, scale
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.mark_non_differentiable(lse)


def _flash_op_backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = _flash_backward(q, k, v, o, lse, do, ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


_flash_op.register_autograd(_flash_op_backward, setup_context=_flash_op_setup)


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None):
    """Tiled attention, differentiable in q, k and v. q,k,v: [B, H, S, D];
    returns o [B, H, Sq, D] in q's dtype. ``scale`` defaults to D**-0.5.

    A CPU tensor runs the kernels' plain versions. A CUDA tensor launches
    the forward kernel (and, in the backward, the dQ and dK/dV kernels) on
    the current stream, or raises: dtypes other than bfloat16 and float32,
    head dims other than 64 and 128, and a last dim that is not contiguous
    are errors. Inputs may be strided views (as [B, S, H, D] tensors
    transposed); o is laid out as q is when q is such a view.

    ``block_q`` and ``block_k`` are accepted for the JAX package's API and
    not used: the CUDA kernels pick their own tiles (the bf16 forward 128
    query rows by 128 keys, dQ the same, dK/dV 128 keys by 64 query rows;
    the f32 kernels 8 rows by 32).
    """
    del block_q, block_k
    if causal and q.shape[2] != k.shape[2]:
        # the causal mask is left-aligned (col > row masked), right only
        # when q and kv index the same positions; decode-style calls
        # against a longer cache would be silently mis-masked
        raise ValueError(
            "flash_attention(causal=True) requires equal q/kv lengths "
            "(got %d vs %d): the causal mask is left-aligned, so "
            "decode-style q-against-longer-kv calls would be silently "
            "mis-masked; use attention_reference or slice the cache"
            % (q.shape[2], k.shape[2]))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _flash_op(q, k, v, bool(causal), float(scale))[0]


# -- launch plumbing ----------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "flash_fwd": [_I] + [_P] * 5 + [_I] * 6 + [ctypes.c_float, _P, _P],
    "flash_dq": [_I] + [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P, _P],
    "flash_dkv": [_I] + [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P, _P],
}


def _fn(name):
    from . import _build
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = _I
    return fn


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _call(what, shape, fn, *args):
    err = fn(*args)
    if err != 0:
        raise MXNetError("flash_attention %s launch failed: cudaError %d "
                         "(B, H, Sq, Sk, D = %s)" % (what, err, shape))


def _like(t):
    """An empty [B, H, S, D] tensor laid out as ``t``: a [B, S, H, D]
    buffer seen transposed when ``t`` is such a view, else contiguous."""
    b, h, s, d = t.shape
    if t.stride(1) < t.stride(2):       # heads inner: [B, S, H, D] buffer
        return torch.empty(b, s, h, d, dtype=t.dtype,
                           device=t.device).transpose(1, 2)
    return torch.empty(b, h, s, d, dtype=t.dtype, device=t.device)


def _tma_view(t):
    """``t``, or a contiguous copy where a dimension longer than 1 has
    stride 0 (an expanded view): the bf16 kernels read through TMA tensor
    maps, whose strides are nonzero multiples of 16 bytes."""
    if any(s == 0 and n > 1 for s, n in zip(t.stride()[:3], t.shape[:3])):
        return t.contiguous()
    return t


def _tma_layout(t):
    """Whether a TMA tensor map can hold ``t`` [B, H, S, D]: the kernels'
    layout, with no zero stride along a dimension longer than 1."""
    return _kernel_layout(t) and all(
        s != 0 or n == 1 for s, n in zip(t.stride()[:3], t.shape[:3]))


def _launch_forward(q, k, v, causal, scale):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype == torch.bfloat16:
        q, k, v = _tma_view(q), _tma_view(k), _tma_view(v)
    o = _like(q)
    lse = torch.empty(b * h, sq, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    shape = (b, h, sq, sk, d)
    with torch.cuda.device(q.device):
        _call("forward", shape, _fn("flash_fwd"), int(q.dtype == torch.float32),
              q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), b * h, h, sq, sk, d, int(causal), scale,
              _strides(q, k, v, o),
              torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES["fwd"] += 1
    return o, lse


def _launch_backward(q, k, v, o, lse, do, causal, scale):
    """dQ and dK/dV launches. bf16 q, k, v and dO pass through
    ``_tma_view``: both kernels read them through TMA tensor maps, which
    cannot hold an expanded (stride 0) view, and store dQ (and dK, dV)
    through maps too, whose strides must be nonzero multiples of 16 bytes."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_tma_view(t) for t in (q, k, v, do))
    dq, dk, dv = _like(q), _like(k), _like(v)
    if q.dtype == torch.bfloat16 and not _tma_layout(dq):
        raise MXNetError("flash_attention backward: dq has strides %s, which "
                         "a TMA tensor map cannot hold" % (dq.stride(),))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    # delta = rowsum(dO * O) in f32, outside the kernels as on the TPU
    delta = (do.float() * o.float()).sum(dim=-1).reshape(b * h, sq)
    lse = lse.contiguous()
    shape = (b, h, sq, sk, d)
    f32 = int(q.dtype == torch.float32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _call("dq", shape, _fn("flash_dq"), f32, q.data_ptr(), k.data_ptr(),
              v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dq.data_ptr(), b * h, h, sq, sk, d, int(causal), scale,
              _strides(q, k, v, do, dq), stream)
        LAUNCHES["dq"] += 1
        _call("dk/dv", shape, _fn("flash_dkv"), f32, q.data_ptr(),
              k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, h, sq,
              sk, d, int(causal), scale, _strides(q, k, v, do, dk, dv),
              stream)
        LAUNCHES["dkv"] += 1
    return dq, dk, dv
