"""Part of the operator long tail (counterpart of mxnet_tpu/ops/extended.py):
the multi-tensor and AMP helpers (``all_finite``, ``multi_all_finite``,
``multi_sum_sq``, ``amp_multicast``) and the legacy aliases of ported ops
(``BatchNorm_v1``, ``Convolution_v1``, ``Pooling_v1``, ``CuDNNBatchNorm``,
``SyncBatchNorm``, ``_contrib_SyncBatchNorm``, ``_contrib_SparseEmbedding``),
the same computation under the reference's older names; the box group
(``box_iou``, ``box_nms``, ``bipartite_matching``, ``MultiBoxPrior``,
``MultiBoxDetection``, ``ROIAlign``, ``ROIPooling``) and the vision layers
(``SpatialTransformer``, ``BilinearResize2D``, ``AdaptiveAvgPooling2D``,
``Correlation``). The rest of the JAX module (FFT, the linalg extras, ...)
is not ported yet.

Every op runs on its input's device with no host synchronisation. The
greedy passes that the JAX package runs as scans with one step per box or
pair run here over the batch at once: ``box_nms``'s on the ``box_nms``
kernel (``kernels/box_nms.py``; its plain version on the CPU) over the
sorted valid prefix, ``bipartite_matching``'s as min(n, m) rounds of "the
best remaining pair whose row and column are both free", which is the
scan's result (ties to the first flat index, the stable sort's order).
Ops the JAX package registers ``no_grad`` run under ``torch.no_grad()``.
"""
from __future__ import annotations

import math

import torch

from .registry import register, _OPS


@register("all_finite")
def all_finite(data, init_output=True):
    """[1.0] if every entry is finite, else [0.0] (float32)."""
    return torch.isfinite(data.float()).all().reshape(1).float()


@register("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=1, init_output=True):
    """[1.0] if every entry of every array is finite, else [0.0]."""
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a.float()).all()
    return ok.reshape(1).float()


@register("multi_sum_sq")
def multi_sum_sq(*arrays, num_arrays=1):
    """Per-array sum of squares in float32 (LARS's trust-ratio input)."""
    return tuple(torch.sum(torch.square(a.float())) for a in arrays)


@register("amp_multicast")
def amp_multicast(*arrays, num_outputs=1, cast_narrow=False):
    """Every input cast to one dtype: the widest by item size (the first
    of equal width), or the narrowest with ``cast_narrow``."""
    dts = [a.dtype for a in arrays]
    pick = min if cast_narrow else max
    target = pick(dts, key=lambda d: d.itemsize)
    return tuple(a.to(target) for a in arrays)


for _new, _old in [("BatchNorm", "BatchNorm_v1"),
                   ("Convolution", "Convolution_v1"),
                   ("Pooling", "Pooling_v1"),
                   ("BatchNorm", "CuDNNBatchNorm"),
                   ("BatchNorm", "SyncBatchNorm"),
                   ("BatchNorm", "_contrib_SyncBatchNorm"),
                   ("Embedding", "_contrib_SparseEmbedding")]:
    if _new in _OPS and _old not in _OPS:
        _OPS[_old] = _OPS[_new]


# ---------------------------------------------------------------------------
# bounding boxes / anchors / ROI
# ---------------------------------------------------------------------------

def _corner(boxes, fmt):
    if fmt == "center":
        x, y, w, h = boxes.unbind(-1)
        return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)
    return boxes


def _center(boxes):
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def _iou_corner(a, b):
    """a [..., N, 4], b [..., M, 4] corner boxes -> [..., N, M]."""
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


@register("box_iou", aliases=("_contrib_box_iou",))
def box_iou(lhs, rhs, format="corner"):
    """IoU of two box arrays (ref: src/operator/contrib/bounding_box.cc
    _contrib_box_iou)."""
    return _iou_corner(_corner(lhs, format), _corner(rhs, format))


@register("box_nms", aliases=("_contrib_box_nms",
                               "box_non_maximum_suppression"))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS; suppressed and invalid records become -1 rows after the
    survivors, which keep their score order (ref: bounding_box.cc
    _contrib_box_nms)."""
    from ..kernels import box_nms as _nms
    cs, si, ii = int(coord_start), int(score_index), int(id_index)
    flat = data.reshape((-1,) + tuple(data.shape[-2:]))       # [B, N, E]
    B, n = flat.shape[0], flat.shape[1]
    scores = flat[..., si]
    valid = scores > valid_thresh
    if ii >= 0 and int(background_id) >= 0:
        valid = valid & (flat[..., ii] != background_id)
    # descending, ties in index order: JAX's stable argsort of the negation
    order = torch.sort(torch.where(valid, scores, torch.full_like(
        scores, -math.inf)), dim=-1, descending=True, stable=True)[1]
    rows = torch.gather(flat, 1, order[..., None].expand(-1, -1,
                                                         flat.shape[-1]))
    nvalid = valid.sum(-1)
    if int(topk) > 0:
        nvalid = torch.clamp(nvalid, max=int(topk))
    boxes = _corner(rows[..., cs:cs + 4], in_format)
    ids = rows[..., ii] if (ii >= 0 and not force_suppress) else None
    with torch.no_grad():
        keep = _nms.keep(boxes.detach(), None if ids is None
                         else ids.detach(), nvalid, overlap_thresh)
    keep = keep.to(data.device)
    if out_format != in_format:
        conv = boxes if out_format == "corner" else _center(
            rows[..., cs:cs + 4])
        rows = torch.cat([rows[..., :cs], conv, rows[..., cs + 4:]], -1)
    rows = torch.where(keep[..., None], rows, torch.full_like(rows, -1.0))
    # survivors first, -1 rows after, each group in score order
    order2 = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True)[1]
    out = torch.gather(rows, 1, order2[..., None].expand(-1, -1,
                                                         rows.shape[-1]))
    return out.reshape(data.shape)


@register("bipartite_matching", aliases=("_contrib_bipartite_matching",))
@torch.no_grad()
def bipartite_matching(data, threshold=1e-12, is_ascend=False, topk=-1):
    """Greedy bipartite matching of a score matrix [..., N, M]: (row
    matches [..., N], column matches [..., M]), -1 where unmatched
    (ref: bounding_box.cc _contrib_bipartite_matching)."""
    flat = data.reshape((-1,) + tuple(data.shape[-2:]))
    B, n, m = flat.shape
    dev = data.device
    sign = 1.0 if is_ascend else -1.0
    ok_val = flat >= threshold if is_ascend else flat > threshold
    # the scan takes pairs in the order of argsort(sign * scores); the
    # first free pair that passes the threshold is the extreme one
    key = torch.where(ok_val, sign * flat.float(),
                      torch.full_like(flat, math.inf, dtype=torch.float32))
    rounds = min(n, m) if int(topk) <= 0 else min(int(topk), n, m)
    row_match = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    row_used = torch.zeros((B, n), dtype=torch.bool, device=dev)
    col_used = torch.zeros((B, m), dtype=torch.bool, device=dev)
    bidx = torch.arange(B, device=dev)
    for _ in range(rounds):
        free = ~(row_used[:, :, None] | col_used[:, None, :])
        k = torch.where(free, key, torch.full_like(key, math.inf))
        best = torch.argmin(k.reshape(B, -1), dim=1)
        ok = torch.isfinite(k.reshape(B, -1)[bidx, best])
        i, j = best // m, best % m
        row_match[bidx, i] = torch.where(ok, j, row_match[bidx, i])
        row_used[bidx, i] |= ok
        col_used[bidx, j] |= ok
    col_match = torch.full((B, m + 1), -1, dtype=torch.int64, device=dev)
    tgt = torch.where(row_match >= 0, row_match, torch.full_like(
        row_match, m))
    col_match.scatter_(1, tgt, torch.arange(n, device=dev).expand(B, n))
    col_match = col_match[:, :m]
    return (row_match.to(data.dtype).reshape(data.shape[:-1]),
            col_match.to(data.dtype).reshape(
                tuple(data.shape[:-2]) + (m,)))


@register("MultiBoxPrior", aliases=("_contrib_MultiBoxPrior",
                                    "multibox_prior"))
@torch.no_grad()
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes of a feature map [B, C, H, W] -> [1, H*W*A, 4]
    (ref: src/operator/contrib/multibox_prior.cc)."""
    in_h, in_w = int(data.shape[-2]), int(data.shape[-1])
    sizes = [float(s) for s in (sizes if isinstance(sizes, (tuple, list))
                                else (sizes,))]
    ratios = [float(r) for r in (ratios if isinstance(ratios, (tuple, list))
                                 else (ratios,))]
    step_y = float(steps[0]) if float(steps[0]) > 0 else 1.0 / in_h
    step_x = float(steps[1]) if float(steps[1]) > 0 else 1.0 / in_w
    dev = data.device
    cy = (torch.arange(in_h, dtype=torch.float32, device=dev)
          + float(offsets[0])) * step_y
    cx = (torch.arange(in_w, dtype=torch.float32, device=dev)
          + float(offsets[1])) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    r0 = (ratios[0] ** 0.5) if ratios else 1.0
    whs = [(s * in_h / in_w * r0 / 2, s / r0 / 2) for s in sizes]
    for rr in ratios[1:]:
        rt = rr ** 0.5
        whs.append((sizes[0] * in_h / in_w * rt / 2, sizes[0] / rt / 2))
    out = torch.stack([torch.stack([cxg - w, cyg - h, cxg + w, cyg + h], -1)
                       for (w, h) in whs], 2).reshape(-1, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out[None]


@register("MultiBoxDetection", aliases=("_contrib_MultiBoxDetection",
                                        "multibox_detection"))
@torch.no_grad()
def multibox_detection(cls_pred, loc_pred, anchors, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode SSD predictions into [B, N, 6] (id, score, corners), NMS
    applied (ref: src/operator/contrib/multibox_detection.cc)."""
    B, N = cls_pred.shape[0], anchors.shape[1]
    scores, cls_id = torch.max(cls_pred[:, 1:, :], dim=1)
    cls_id = cls_id.to(torch.float32)
    a = anchors[0]
    acx, acy = (a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2
    aw, ah = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
    loc = loc_pred.reshape(B, N, 4)
    v = [float(x) for x in variances]
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw / 2
    h = torch.exp(loc[..., 3] * v[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], -1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    keep = scores > threshold
    neg = torch.full_like(scores, -1.0)
    recs = torch.cat([torch.where(keep, cls_id, neg)[..., None],
                      torch.where(keep, scores, neg)[..., None], boxes], -1)
    return box_nms(recs, overlap_thresh=float(nms_threshold),
                   valid_thresh=0.0, topk=int(nms_topk), coord_start=2,
                   score_index=1, id_index=0, background_id=-1,
                   force_suppress=bool(force_suppress))


def _bilinear_at(img, y, x):
    """img [R, C, H, W]; y, x [R, ...] float coordinates -> [R, C, ...]:
    bilinear samples, the four taps clamped into the image."""
    H, W = img.shape[-2], img.shape[-1]
    y0, x0 = torch.floor(y), torch.floor(x)
    wy, wx = y - y0, x - x0
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    R, C = img.shape[0], img.shape[1]
    flat = img.reshape(R, C, H * W)

    def tap(yi, xi):
        idx = (yi * W + xi).reshape(R, 1, -1).expand(R, C, -1)
        return torch.gather(flat, 2, idx).reshape((R, C) + tuple(y.shape[1:]))
    wy, wx = wy[:, None], wx[:, None]
    return (tap(y0i, x0i) * (1 - wy) * (1 - wx) + tap(y0i, x1i) * (1 - wy)
            * wx + tap(y1i, x0i) * wy * (1 - wx) + tap(y1i, x1i) * wy * wx)


@register("ROIAlign", aliases=("_contrib_ROIAlign", "roi_align"))
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False, aligned=False):
    """ROI Align with bilinear sampling (ref: src/operator/contrib/
    roi_align.cc); rois [R, 5] = (batch index, x1, y1, x2, y2)."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    ns = 2 if int(sample_ratio) <= 0 else int(sample_ratio)
    off = 0.5 if aligned else 0.0
    img = data[rois[:, 0].to(torch.int64)]                     # [R, C, H, W]
    x1, y1, x2, y2 = (rois[:, k] * spatial_scale - off for k in range(1, 5))
    rw = torch.clamp(x2 - x1, min=1.0 if not aligned else 1e-5)
    rh = torch.clamp(y2 - y1, min=1.0 if not aligned else 1e-5)
    bw, bh = rw / pw, rh / ph
    dev = data.device
    iy = torch.arange(ph, dtype=torch.float32, device=dev)
    ix = torch.arange(pw, dtype=torch.float32, device=dev)
    sy = torch.arange(ns, dtype=torch.float32, device=dev)
    ys = y1[:, None, None] + (iy[:, None] + (sy[None, :] + 0.5) / ns)[None] \
        * bh[:, None, None]                                    # [R, ph, ns]
    xs = x1[:, None, None] + (ix[:, None] + (sy[None, :] + 0.5) / ns)[None] \
        * bw[:, None, None]                                    # [R, pw, ns]
    R = rois.shape[0]
    yy, xx = ys.reshape(R, -1), xs.reshape(R, -1)
    gy = yy[:, :, None].expand(-1, -1, xx.shape[1])
    gx = xx[:, None, :].expand(-1, yy.shape[1], -1)
    vals = _bilinear_at(img, gy, gx)                   # [R, C, ph*ns, pw*ns]
    vals = vals.reshape(R, img.shape[1], ph, ns, pw, ns)
    return vals.mean((3, 5))


@register("ROIPooling", aliases=("roi_pooling",))
def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max pooling over quantized ROI bins (ref: src/operator/
    roi_pooling.cc); rois [R, 5] = (batch index, x1, y1, x2, y2)."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    H, W = data.shape[-2], data.shape[-1]
    dev = data.device
    img = data[rois[:, 0].to(torch.int64)]                     # [R, C, H, W]
    x1, y1, x2, y2 = (torch.round(rois[:, k] * spatial_scale)
                      for k in range(1, 5))
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    bw, bh = rw / pw, rh / ph
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None]
    by = torch.floor((yy - y1[:, None]) / bh[:, None])
    bx = torch.floor((xx - x1[:, None]) / bw[:, None])
    by = torch.where((yy >= y1[:, None]) & (yy <= y2[:, None]), by,
                     torch.full_like(by, -1.0))
    bx = torch.where((xx >= x1[:, None]) & (xx <= x2[:, None]), bx,
                     torch.full_like(bx, -1.0))
    oy = by[:, None, :] == torch.arange(ph, dtype=torch.float32,
                                        device=dev)[None, :, None]
    ox = bx[:, None, :] == torch.arange(pw, dtype=torch.float32,
                                        device=dev)[None, :, None]
    mask = oy[:, :, None, :, None] & ox[:, None, :, None, :]  # R,ph,pw,H,W
    big = torch.where(mask[:, None], img[:, :, None, None],
                      torch.full((), -math.inf, dtype=data.dtype,
                                 device=dev))
    out = big.amax((-1, -2))
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# spatial transform / resize
# ---------------------------------------------------------------------------

@register("SpatialTransformer", aliases=("spatial_transformer",))
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=None):
    """Affine grid and bilinear sampling (ref: src/operator/
    spatial_transformer.cc)."""
    th, tw = int(target_shape[0]), int(target_shape[1])
    dev = data.device
    theta = loc.reshape(-1, 2, 3)
    ys = torch.linspace(-1.0, 1.0, th, device=dev)
    xs = torch.linspace(-1.0, 1.0, tw, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(th * tw, device=dev)], 0)   # [3, th*tw]
    src = torch.einsum("bij,jk->bik", theta, grid)           # [B, 2, th*tw]
    x = (src[:, 0] + 1.0) * (data.shape[-1] - 1) / 2.0
    y = (src[:, 1] + 1.0) * (data.shape[-2] - 1) / 2.0
    return _bilinear_at(data, y, x).reshape(data.shape[0], data.shape[1],
                                            th, tw)


@register("BilinearResize2D", aliases=("_contrib_BilinearResize2D",
                                       "bilinear_resize_2d"))
def bilinear_resize_2d(data, height=1, width=1, scale_height=None,
                       scale_width=None, mode="size"):
    """``jax.image.resize``'s linear resize of the last two axes
    (ref: src/operator/contrib/bilinear_resize.cc)."""
    from .image import jax_resize
    H, W = data.shape[-2], data.shape[-1]
    if scale_height is not None:
        height = int(round(H * float(scale_height)))
        width = int(round(W * float(scale_width or scale_height)))
    return jax_resize(data, tuple(data.shape[:-2]) + (int(height),
                                                      int(width)))


@register("AdaptiveAvgPooling2D", aliases=("_contrib_AdaptiveAvgPooling2D",
                                           "adaptive_avg_pooling_2d"))
def adaptive_avg_pooling_2d(data, output_size=(1, 1)):
    """Mean over equal bins where the size divides, else the linear
    resize (ref: src/operator/contrib/adaptive_avg_pooling.cc)."""
    from .image import jax_resize
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = int(output_size[0]), int(output_size[1])
    H, W = data.shape[-2], data.shape[-1]
    if H % oh == 0 and W % ow == 0:
        x = data.reshape(tuple(data.shape[:-2]) + (oh, H // oh, ow, W // ow))
        return x.mean((-3, -1))
    return jax_resize(data, tuple(data.shape[:-2]) + (oh, ow))


@register("Correlation", aliases=("correlation",))
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation layer (ref: src/operator/correlation.cc
    CorrelationForward; shapes correlation-inl.h:99-108): one output
    channel per displacement, the kernel window anchored top-left."""
    K, md = int(kernel_size), int(max_displacement)
    s1, s2, p = int(stride1), int(stride2), int(pad_size)
    border = md + K // 2
    B, C, H, W = data1.shape
    top_h = -(-(H + 2 * p - 2 * border) // s1)
    top_w = -(-(W + 2 * p - 2 * border) // s1)
    ngr = md // s2
    ngw = 2 * ngr + 1
    sumelems = float(K * K * C)
    pad = torch.nn.functional.pad
    t1 = pad(data1.permute(0, 2, 3, 1), (0, 0, p, p, p, p))
    t2 = pad(data2.permute(0, 2, 3, 1), (0, 0, p, p, p, p))

    def block(src, ys, xs):
        return src[:, ys:ys + (top_h - 1) * s1 + 1:s1,
                   xs:xs + (top_w - 1) * s1 + 1:s1, :]

    outs = []
    for tc in range(ngw * ngw):
        s2o = (tc % ngw - ngr) * s2
        s2p = (tc // ngw - ngr) * s2
        acc = 0.0
        for h in range(K):
            for w in range(K):
                a = block(t1, md + h, md + w)
                b = block(t2, md + h + s2p, md + w + s2o)
                acc = acc + (a * b if is_multiply else torch.abs(a - b))
        outs.append(torch.sum(acc, -1) / sumelems)
    return torch.stack(outs, 1)
