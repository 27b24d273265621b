"""Greedy non-maximum suppression: the Hopper kernel and its plain version.

``keep(boxes, ids, nvalid, thresh)`` is the keep mask of the greedy pass
that ``box_nms``, ``MultiBoxDetection``, ``Proposal`` and
``MultiProposal`` run over boxes already sorted by score: box i of the
valid prefix is kept unless a kept box before it overlaps it by an IoU
above ``thresh`` (with ``ids``: a kept box of its own class). The JAX
package runs this pass as a ``lax.scan`` over every box
(mxnet_tpu/ops/extended.py:418, detection.py:350); no Pallas kernel
computes it. On a CUDA tensor ``csrc/box_nms.cu`` computes it in two
launches for the whole batch (its design note is in the source), with the
prefix lengths read on the card: no host synchronisation. On a CPU tensor
``keep_reference`` computes the same bits: the IoU rows in float32 numpy
ops (the same IEEE operations, without torch's thread pool, which costs
more than it gains on these small arrays), packed into 64-bit words, and the same walk in numpy (class by class
where the pass is class-aware).

``LAUNCHES`` counts the calls that launched the kernel pair.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["keep", "keep_reference", "LAUNCHES"]

LAUNCHES = 0

_ROWS = 1024            # IoU rows per chunk of the plain version
_MAX_WORDS = 227 * 1024 // 8


def iou_rows(a, b, plus_one=False):
    """IoU of each box of ``a`` [r, 4] with each of ``b`` [m, 4] (corner
    boxes, float32 numpy), [r, m]: the JAX package's expression, op for
    op (``plus_one``: the Proposal form with +1 pixel widths)."""
    ax1, ay1, ax2, ay2 = (a[:, k, None] for k in range(4))
    bx1, by1, bx2, by2 = (b[None, :, k] for k in range(4))
    if plus_one:
        iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1) + 1.0,
                        0.0)
        ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1) + 1.0,
                        0.0)
        inter = iw * ih
        area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
        area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            return inter / (area_a + area_b - inter)
    iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0.0)
    ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0.0)
    inter = iw * ih
    area_a = np.maximum(ax2 - ax1, 0.0) * np.maximum(ay2 - ay1, 0.0)
    area_b = np.maximum(bx2 - bx1, 0.0) * np.maximum(by2 - by1, 0.0)
    union = area_a + area_b - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, np.float32(0.0))


def _greedy(bx, thresh, plus_one):
    """The greedy pass over sorted boxes ``bx`` [n, 4] (host float32): the
    upper triangle of "IoU above thresh" packed into 64-bit words, then
    the walk."""
    n = bx.shape[0]
    width = -(-n // 64) * 64
    words = np.empty((n, width // 64), np.uint64)
    for r0 in range(0, n, _ROWS):
        r1 = min(n, r0 + _ROWS)
        sup = iou_rows(bx[r0:r1], bx[r0:], plus_one) > thresh
        sup &= np.arange(r0, n)[None, :] > np.arange(r0, r1)[:, None]
        bits = np.zeros((r1 - r0, width), bool)
        bits[:, r0:n] = sup
        words[r0:r1] = np.packbits(bits, axis=1, bitorder="little") \
            .view("<u8")
    kept = np.zeros(n, bool)
    removed = np.zeros(words.shape[1], np.uint64)
    for i in range(n):
        if not (int(removed[i >> 6]) >> (i & 63)) & 1:
            kept[i] = True
            removed |= words[i]
    return kept


def keep_reference(boxes, ids, nvalid, thresh, plus_one=False):
    """The plain version of ``keep``, on the host: boxes [B, n, 4], ids
    [B, n] or None, nvalid [B] ints -> keep [B, n] bool. With ``ids`` a
    box suppresses only boxes of its own class, so each class's boxes (in
    score order) take their own greedy pass: the same bits, with far fewer
    IoUs."""
    B, n = boxes.shape[0], boxes.shape[1]
    boxes = boxes.detach().to("cpu", torch.float32).numpy()
    ids = None if ids is None else \
        ids.detach().to("cpu", torch.float32).numpy()
    thresh = np.float32(thresh)
    out = np.zeros((B, n), bool)
    for b, nv in enumerate(torch.as_tensor(nvalid).tolist()):
        nv = int(nv)
        if nv <= 0:
            continue
        bx = boxes[b, :nv]
        if ids is None:
            out[b, :nv] = _greedy(bx, thresh, plus_one)
            continue
        cls = ids[b, :nv]
        for c in np.unique(cls):
            idx = np.nonzero(cls == c)[0]
            out[b, idx[_greedy(bx[idx], thresh, plus_one)]] = True
    return torch.from_numpy(out)


def keep(boxes, ids, nvalid, thresh, plus_one=False):
    """The greedy keep mask [B, n] (bool) of sorted boxes [B, n, 4] whose
    first ``nvalid[b]`` rows are valid (the module docstring). A CUDA
    tensor launches the kernel or raises; a CPU tensor runs
    ``keep_reference``; a meta tensor (shape inference) gives an empty
    mask of the right shape."""
    if boxes.device.type == "cpu":
        return keep_reference(boxes, ids, nvalid, thresh, plus_one)
    if boxes.device.type == "meta":
        return torch.empty(tuple(boxes.shape[:2]), dtype=torch.bool,
                           device="meta")
    if boxes.device.type != "cuda":
        raise MXNetError("box_nms: no kernel for device %s" % boxes.device)
    return _launch(boxes, ids, nvalid, thresh, plus_one)


def _launch(boxes, ids, nvalid, thresh, plus_one):
    global LAUNCHES
    from . import _build
    B, n = int(boxes.shape[0]), int(boxes.shape[1])
    words = -(-n // 64)
    if words > _MAX_WORDS:
        raise MXNetError("box_nms kernel: %d boxes per image exceed its "
                         "shared-memory walk (at most %d)"
                         % (n, _MAX_WORDS * 64))
    dev = boxes.device
    bx = boxes.to(torch.float32).contiguous()
    idt = None if ids is None else ids.to(torch.float32).contiguous()
    nv = nvalid.to(device=dev, dtype=torch.int32).contiguous()
    mask = torch.empty((max(B * n * words, 1),), dtype=torch.int64,
                       device=dev)
    out = torch.empty((B, n), dtype=torch.uint8, device=dev)
    fn = _build.load("box_nms").box_nms_keep
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, p, p, p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bx.data_ptr(), 0 if idt is None else idt.data_ptr(),
                 nv.data_ptr(), B, n, float(np.float32(thresh)),
                 int(plus_one), mask.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise MXNetError("box_nms kernel launch failed: cudaError %d "
                         "(batch %d, %d boxes)" % (err, B, n))
    LAUNCHES += 1
    return out.bool()
