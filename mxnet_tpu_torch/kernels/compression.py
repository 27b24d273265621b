"""2-bit gradient compression with error feedback: the Hopper kernels and
their plain PyTorch versions (counterpart of
mxnet_tpu/pallas_kernels/compression.py; ref:
src/kvstore/gradient_compression-inl.h quantize_2bit).

    words, new_residual = quantize_2bit(grad, residual, threshold)
    values = dequantize_2bit(words, n, threshold)

Each value of ``r = residual + grad`` becomes 2 bits: ``11`` where ``r >=
threshold`` (decodes to +threshold), ``10`` where ``r <= -threshold``
(decodes to -threshold), else ``00`` (decodes to 0); the new residual
keeps what the code did not carry. 16 values pack into one int32 word,
value ``i`` of a group at bit-pair ``15 - i``, so a word whose value 0
fires +threshold is negative; there are ``ceil(n / 16)`` words and the
tail pads with zero codes. This is the JAX package's wire format, so words
made by either package decode in the other.

Types follow ``quantize_2bit_jnp``: ``r`` and the new residual are in the
gradient's dtype (bf16 or float32), the threshold a weak scalar rounded to
it (``base.weak_scalar``), and the new residual is ``(r - pos * thr) + neg
* thr`` op by op, zero terms included (for code 0 and ``r = -0.0`` that is
+0.0). The JAX package's Pallas form declares a float32 residual and
rejects a bf16 gradient; its jnp form, which runs off the TPU, takes bf16
and is what the port follows. ``dequantize_2bit`` returns float32, as both
JAX forms do; the caller casts.

The grouped forms take a list of tensors (segments) at once:

    words_list, new_residuals = quantize_2bit_group(grads, residuals, thr)
    flat, views = dequantize_2bit_group(words_list, ns, thr)

each segment exactly as the single call would encode or decode it, the
decoded values back to back in one float32 buffer ``flat`` (``views`` its
per-segment slices). A compressed store encodes every gradient of a push
with one call.

One CUDA source (``csrc/compression.cu``) holds both kernels:
``quantize_2bit_group_{bf16,f32}`` replaces the TPU kernel
``_quant_kernel`` and ``dequantize_2bit_group_f32`` replaces
``_dequant_kernel``. Each launch takes up to ``MAX_SEGMENTS`` segments,
walked by a persistent grid in chunks of whole words (``codec_plan`` and
``codec_walk`` model the walk; the CPU tests hold the model), so a grouped
call of up to 64 tensors is one launch; the single calls launch the same
kernels with one segment. ``LAUNCHES_QUANTIZE`` and
``LAUNCHES_DEQUANTIZE`` count launches, ``SEGMENTS_QUANTIZE`` and
``SEGMENTS_DEQUANTIZE`` the non-empty tensors they carried. A CPU tensor
runs the plain version (the grouped plain versions loop over the single
ones); a CUDA tensor launches the kernel or raises (a dtype other than
bf16/f32 gradients and int32 words, gradients of two dtypes in one call,
operands on two devices, a non-contiguous or non-1-D operand, a failed
launch). The kernels' design note is in the source.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..base import MXNetError, weak_scalar

__all__ = ["quantize_2bit", "dequantize_2bit", "quantize_2bit_group",
           "dequantize_2bit_group", "quantize_2bit_reference",
           "dequantize_2bit_reference", "quantize_2bit_group_reference",
           "dequantize_2bit_group_reference", "num_words", "chunk_words",
           "codec_plan", "codec_walk", "CodecLaunch", "LAUNCHES_QUANTIZE",
           "LAUNCHES_DEQUANTIZE", "SEGMENTS_QUANTIZE", "SEGMENTS_DEQUANTIZE"]

# Kernel launches in this process (one per launch of up to MAX_SEGMENTS
# tensors), and the non-empty tensors those launches carried.
LAUNCHES_QUANTIZE = 0
LAUNCHES_DEQUANTIZE = 0
SEGMENTS_QUANTIZE = 0
SEGMENTS_DEQUANTIZE = 0

_GROUP = 16   # values per 32-bit word

# The kernels' walk (csrc/compression.cu): warps a block, blocks an SM,
# segments a launch, bytes of a gradient a quantize chunk, words a
# dequantize chunk.
WARPS = 4
BLOCKS_PER_SM = 3
MAX_SEGMENTS = 64
SLAB_BYTES = 4096
DEQUANT_CHUNK_WORDS = 128


def num_words(n):
    """Words that carry ``n`` values: ``ceil(n / 16)``."""
    return -(-int(n) // _GROUP)


def chunk_words(kernel, itemsize=2):
    """Words a chunk of the "quantize" kernel (gradients of ``itemsize``
    bytes: 128 in bf16, 64 in float32) or of the "dequantize" kernel
    (128)."""
    if kernel == "dequantize":
        return DEQUANT_CHUNK_WORDS
    return SLAB_BYTES // (_GROUP * itemsize)


class CodecLaunch(NamedTuple):
    """One launch: the indices of its segments in the caller's list, each
    one's first chunk, the chunks in all, and the grid's blocks."""
    segments: tuple
    first: tuple
    chunks: int
    grid: int


def codec_plan(ns, words_per_chunk, n_sm):
    """The launches that encode or decode tensors of ``ns`` values: the
    non-empty ones in order, ``MAX_SEGMENTS`` a launch, each launch's
    chunks numbered across its segments, and a grid of ``BLOCKS_PER_SM``
    blocks an SM capped at one warp a chunk."""
    live = [i for i, n in enumerate(ns) if n > 0]
    launches = []
    for k in range(0, len(live), MAX_SEGMENTS):
        segs = tuple(live[k:k + MAX_SEGMENTS])
        first, chunks = [], 0
        for i in segs:
            first.append(chunks)
            chunks += -(-num_words(ns[i]) // words_per_chunk)
        grid = max(1, min(BLOCKS_PER_SM * n_sm, -(-chunks // WARPS)))
        launches.append(CodecLaunch(segs, tuple(first), chunks, grid))
    return launches


def codec_walk(launch, ns, words_per_chunk):
    """The kernel's walk of one launch: for each warp of the grid, the
    chunks it takes in order, each as (segment index, first word, words).
    Warp w takes chunks w, w + W, ... of the W warps, and finds a chunk's
    segment by advancing a cursor over ``launch.first``."""
    step = launch.grid * WARPS
    walk = []
    for w in range(step):
        mine, s = [], 0
        for c in range(w, launch.chunks, step):
            while s + 1 < len(launch.segments) and c >= launch.first[s + 1]:
                s += 1
            seg = launch.segments[s]
            w0 = (c - launch.first[s]) * words_per_chunk
            mine.append((seg, w0,
                         min(words_per_chunk, num_words(ns[seg]) - w0)))
        walk.append(mine)
    return walk


def _shifts(device):
    return 2 * (15 - torch.arange(_GROUP, dtype=torch.int64, device=device))


def quantize_2bit_reference(grad, residual, threshold=0.5):
    """Plain PyTorch ``quantize_2bit_jnp``: ``(words, new_residual)``, int32
    ``[ceil(n/16)]`` and ``[n]`` in the gradient's dtype. The packing shifts
    and sums in int64 and wraps to int32 (the JAX form sums int32 with
    wraparound; the bit-pairs are disjoint, so the sum is their or)."""
    n = grad.shape[0]
    r = residual + grad
    thr = weak_scalar(float(threshold), r.dtype)
    pos = r >= thr
    neg = r <= -thr
    codes = torch.where(pos, 3, torch.where(neg, 2, 0)).to(torch.int64)
    new_residual = r - pos.to(r.dtype) * thr + neg.to(r.dtype) * thr
    pad = num_words(n) * _GROUP - n
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    words = (codes.reshape(-1, _GROUP) << _shifts(r.device)).sum(dim=1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), new_residual


def dequantize_2bit_reference(words, n, threshold=0.5):
    """Plain PyTorch ``dequantize_2bit_jnp``: int32 words -> float32
    ``[n]``."""
    codes = (words.to(torch.int64)[:, None] >> _shifts(words.device)) & 3
    thr = torch.tensor(float(threshold), dtype=torch.float32,
                       device=words.device)
    zero = torch.zeros((), dtype=torch.float32, device=words.device)
    vals = torch.where(codes == 3, thr, torch.where(codes == 2, -thr, zero))
    return vals.reshape(-1)[:n]


def quantize_2bit_group_reference(grads, residuals, threshold=0.5):
    """``quantize_2bit_reference`` of each pair: ``(words_list,
    new_residuals_list)``."""
    out = [quantize_2bit_reference(g, r, threshold)
           for g, r in zip(grads, residuals)]
    return [w for w, _ in out], [r for _, r in out]


def dequantize_2bit_group_reference(words_list, ns, threshold=0.5):
    """``dequantize_2bit_reference`` of each segment, back to back:
    ``(flat, views)``, one float32 buffer and its per-segment slices."""
    ns = [int(n) for n in ns]
    parts = [dequantize_2bit_reference(w, n, threshold)
             for w, n in zip(words_list, ns)]
    flat = torch.cat(parts) if parts else torch.zeros(0)
    return flat, list(flat.split(ns))


def _check_flat(name, *ts):
    for t in ts:
        if t.dim() != 1:
            raise ValueError("%s: 1-D operands, got shape %s"
                             % (name, tuple(t.shape)))
        if t.device != ts[0].device:
            raise ValueError("%s: operands on %s and %s"
                             % (name, ts[0].device, t.device))


def _check_pairs(name, grads, residuals):
    if len(grads) != len(residuals):
        raise ValueError("%s: %d gradients and %d residuals"
                         % (name, len(grads), len(residuals)))
    _check_flat(name, *grads, *residuals)
    for g, r in zip(grads, residuals):
        if g.dtype != grads[0].dtype:
            raise ValueError("%s: one gradient dtype per call, got %s and "
                             "%s" % (name, grads[0].dtype, g.dtype))
        if g.shape != r.shape or g.dtype != r.dtype:
            raise ValueError("%s: grad %s %s and residual %s %s"
                             % (name, tuple(g.shape), g.dtype,
                                tuple(r.shape), r.dtype))


def _check_words(name, words_list, ns):
    if len(words_list) != len(ns):
        raise ValueError("%s: %d word tensors for %d sizes"
                         % (name, len(words_list), len(ns)))
    _check_flat(name, *words_list)
    for w, n in zip(words_list, ns):
        if w.dtype != torch.int32 or w.shape[0] != num_words(n):
            raise ValueError("%s: need %d int32 words for %d values, got "
                             "%s %s" % (name, num_words(n), n,
                                        tuple(w.shape), w.dtype))


def _device_kind(name, device):
    if device.type not in ("cpu", "cuda"):
        raise MXNetError("%s: no kernel for device %s" % (name, device))
    return device.type


def quantize_2bit(grad, residual, threshold=0.5):
    """2-bit quantize with error feedback: ``(words, new_residual)`` for
    ``[n]`` ``grad`` and ``residual`` of one dtype. A CPU tensor runs
    ``quantize_2bit_reference``; a CUDA tensor launches the kernel with one
    segment on the current stream (bf16 or float32, contiguous) or
    raises."""
    _check_pairs("quantize_2bit", [grad], [residual])
    if _device_kind("quantize_2bit", grad.device) == "cpu":
        return quantize_2bit_reference(grad, residual, threshold)
    words, new_res = _launch_quantize([grad], [residual], threshold)
    return words[0], new_res[0]


def dequantize_2bit(words, n, threshold=0.5):
    """Inverse of ``quantize_2bit``: ``[ceil(n/16)]`` int32 words -> float32
    ``[n]``. A CPU tensor runs ``dequantize_2bit_reference``; a CUDA tensor
    launches the kernel with one segment on the current stream or
    raises."""
    _check_words("dequantize_2bit", [words], [n])
    if _device_kind("dequantize_2bit", words.device) == "cpu":
        return dequantize_2bit_reference(words, n, threshold)
    return _launch_dequantize([words], [int(n)], threshold)


def quantize_2bit_group(grads, residuals, threshold=0.5):
    """``quantize_2bit`` of every pair of a list: ``(words_list,
    new_residuals_list)``. One dtype (bf16 or float32 on the card) and one
    device for the whole list; empty tensors allowed. A CUDA list takes one
    launch per ``MAX_SEGMENTS`` non-empty tensors."""
    grads, residuals = list(grads), list(residuals)
    if not grads and not residuals:
        return [], []
    _check_pairs("quantize_2bit_group", grads, residuals)
    if _device_kind("quantize_2bit_group", grads[0].device) == "cpu":
        return quantize_2bit_group_reference(grads, residuals, threshold)
    return _launch_quantize(grads, residuals, threshold)


def dequantize_2bit_group(words_list, ns, threshold=0.5):
    """``dequantize_2bit`` of every segment of a list: ``(flat, views)``,
    the float32 values of all segments back to back in ``flat`` and
    ``views`` its per-segment slices. A CUDA list takes one launch per
    ``MAX_SEGMENTS`` non-empty segments."""
    words_list, ns = list(words_list), [int(n) for n in ns]
    _check_words("dequantize_2bit_group", words_list, ns)
    if not words_list:
        flat = torch.zeros(0)
        return flat, []
    if _device_kind("dequantize_2bit_group", words_list[0].device) == "cpu":
        return dequantize_2bit_group_reference(words_list, ns, threshold)
    flat = _launch_dequantize(words_list, ns, threshold)
    return flat, list(flat.split(ns))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {name: [_P, _I, _F, _I, _P] for name in (
    "quantize_2bit_group_bf16", "quantize_2bit_group_f32",
    "dequantize_2bit_group_f32")}
_KERNEL_DTYPES = {torch.bfloat16: "quantize_2bit_group_bf16",
                  torch.float32: "quantize_2bit_group_f32"}


class _QSeg(ctypes.Structure):
    _fields_ = [("grad", _P), ("res", _P), ("new_res", _P), ("words", _P),
                ("n", ctypes.c_longlong), ("first", ctypes.c_longlong)]


class _DSeg(ctypes.Structure):
    _fields_ = [("words", _P), ("out", _P), ("n", ctypes.c_longlong),
                ("first", ctypes.c_longlong)]


def _fn(name):
    from . import _build
    fn = getattr(_build.load("compression"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
    return fn


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_quantize(grads, residuals, threshold):
    global LAUNCHES_QUANTIZE, SEGMENTS_QUANTIZE
    dtype = grads[0].dtype
    name = _KERNEL_DTYPES.get(dtype)
    if name is None:
        raise TypeError("quantize_2bit: the kernel takes bf16 or float32 "
                        "gradients, got %s" % dtype)
    if not all(t.is_contiguous() for t in grads + residuals):
        raise ValueError("quantize_2bit: grad and residual must be "
                         "contiguous")
    dev = grads[0].device
    ns = [g.shape[0] for g in grads]
    words = [torch.empty(num_words(n), dtype=torch.int32, device=dev)
             for n in ns]
    new_res = [torch.empty_like(r) for r in residuals]
    thr = weak_scalar(float(threshold), dtype)
    plan = codec_plan(ns, chunk_words("quantize", grads[0].element_size()),
                      _sm_count(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for launch in plan:
            segs = (_QSeg * len(launch.segments))(*[
                _QSeg(grads[i].data_ptr(), residuals[i].data_ptr(),
                      new_res[i].data_ptr(), words[i].data_ptr(), ns[i], f)
                for i, f in zip(launch.segments, launch.first)])
            err = _fn(name)(segs, len(segs), thr, launch.grid, stream)
            if err != 0:
                raise MXNetError("quantize_2bit launch failed: cudaError %d "
                                 "(%d segments, %s)" % (err, len(segs),
                                                        dtype))
            LAUNCHES_QUANTIZE += 1
            SEGMENTS_QUANTIZE += len(segs)
    return words, new_res


def _launch_dequantize(words_list, ns, threshold):
    global LAUNCHES_DEQUANTIZE, SEGMENTS_DEQUANTIZE
    if not all(w.is_contiguous() for w in words_list):
        raise ValueError("dequantize_2bit: words must be contiguous")
    dev = words_list[0].device
    flat = torch.empty(sum(ns), dtype=torch.float32, device=dev)
    offsets = [0]
    for n in ns:
        offsets.append(offsets[-1] + n)
    base = flat.data_ptr()
    plan = codec_plan(ns, chunk_words("dequantize"), _sm_count(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for launch in plan:
            segs = (_DSeg * len(launch.segments))(*[
                _DSeg(words_list[i].data_ptr(), base + 4 * offsets[i], ns[i],
                      f) for i, f in zip(launch.segments, launch.first)])
            err = _fn("dequantize_2bit_group_f32")(
                segs, len(segs), float(threshold), launch.grid, stream)
            if err != 0:
                raise MXNetError("dequantize_2bit launch failed: cudaError "
                                 "%d (%d segments)" % (err, len(segs)))
            LAUNCHES_DEQUANTIZE += 1
            SEGMENTS_DEQUANTIZE += len(segs)
    return flat
