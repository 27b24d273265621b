"""The detection operator family (counterpart of mxnet_tpu/ops/detection.py):
deformable convolution, position-sensitive ROI pooling, RPN proposals, SSD
target assignment, rotated ROI align and the legacy Crop. Reference
sources:
- DeformableConvolution: src/operator/contrib/deformable_convolution.cc:93
  (offset layout nn/deformable_im2col.h:239: per deformable group,
  channel 2*(i*kw+j) is the h-offset, +1 the w-offset)
- PSROIPooling: src/operator/contrib/psroi_pooling.cc:56-110
- DeformablePSROIPooling: src/operator/contrib/deformable_psroi_pooling.cc
- Proposal, MultiProposal: src/operator/contrib/proposal.cc:281-420,
  multi_proposal.cc
- MultiBoxTarget: src/operator/contrib/multibox_target.cc:71-281
- RROIAlign: src/operator/contrib/rroi_align.cc:40-210
- Crop: src/operator/crop.cc

Every op runs on its input's device with static shapes and no host
synchronisation, batched where the JAX package vmaps. The greedy loops the
JAX package runs with one step per box (``Proposal``'s NMS, a fori_loop
over every box) or per ground-truth row (``MultiBoxTarget``'s bipartite
match) run here once for the batch: the NMS on the ``box_nms`` kernel
(``kernels/box_nms.py``) over the sorted valid prefix, the match as L
rounds of a batched argmax. Gradients are autograd's through the same
expressions; ``MultiBoxTarget``'s matches and ranks are discrete, as in
JAX.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import register

__all__ = []


def _gather2d(img, y, x):
    """Sample ``img`` [M, H, W] at float coordinates ``y``, ``x`` [M, ...]:
    zero outside (-1, H) x (-1, W), edge-clamped bilinear inside
    (im2col_bilinear_cpu, ref: contrib/nn/deformable_im2col.h:75)."""
    M, H, W = img.shape
    valid = (y > -1.0) & (y < H) & (x > -1.0) & (x < W)
    y = torch.clamp(y, 0.0, H - 1.0)
    x = torch.clamp(x, 0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly, lx = y - y0, x - x0
    flat = img.reshape(M, H * W)
    shape = y.shape

    def tap(yi, xi):
        return torch.gather(flat, 1, (yi * W + xi).reshape(M, -1)) \
            .reshape(shape)
    out = (tap(y0, x0) * (1 - ly) * (1 - lx) + tap(y0, x1) * (1 - ly) * lx
           + tap(y1, x0) * ly * (1 - lx) + tap(y1, x1) * ly * lx)
    return torch.where(valid, out, torch.zeros_like(out))


def _pair(v, default):
    return (int(v[0]), int(v[1])) if v else default


@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",))
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=1, num_group=1,
                           num_deformable_group=1, no_bias=False,
                           workspace=1024, layout=None):
    """Deformable convolution v1: data [N, C, H, W], offset [N, 2*dg*kh*kw,
    H', W'], weight [F, C/num_group, kh, kw]. The deformable im2col is one
    bilinear gather per kernel tap, then one grouped matmul."""
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = _pair(stride, (1, 1))
    dh, dw = _pair(dilate, (1, 1))
    ph, pw = _pair(pad, (0, 0))
    ng, dg, F = int(num_group), int(num_deformable_group), int(num_filter)
    N, C, H, W = data.shape
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dev = data.device
    hs = (torch.arange(Ho, device=dev) * sh - ph).to(data.dtype)
    ws = (torch.arange(Wo, device=dev) * sw - pw).to(data.dtype)
    off = offset.reshape(N, dg, kh * kw, 2, Ho, Wo)
    cpg = C // dg
    img = data.reshape(N * C, H, W)
    cols = []
    for i in range(kh):
        for j in range(kw):
            t = i * kw + j
            y = hs[None, None, :, None] + i * dh + off[:, :, t, 0]
            x = ws[None, None, None, :] + j * dw + off[:, :, t, 1]
            yb = torch.repeat_interleave(y, cpg, dim=1).reshape(N * C, Ho,
                                                                 Wo)
            xb = torch.repeat_interleave(x, cpg, dim=1).reshape(N * C, Ho,
                                                                 Wo)
            cols.append(_gather2d(img, yb, xb).reshape(N, C, Ho, Wo))
    col = torch.stack(cols, 2)                        # [N, C, kh*kw, Ho, Wo]
    cg = C // ng
    col = col.reshape(N, ng, cg * kh * kw, Ho * Wo)
    wr = weight.reshape(ng, F // ng, cg * kh * kw)
    out = torch.einsum("ngkp,gfk->ngfp", col.float(), wr.float())
    out = out.reshape(N, F, Ho, Wo).to(data.dtype)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, F, 1, 1)
    return out


def _ps_channel_map(OD, G, P):
    """The position-sensitive channel of (ctop, ph, pw): (OD, P, P)."""
    gh = np.minimum(np.maximum(np.floor(np.arange(P) * G / P), 0),
                    G - 1).astype(np.int64)
    return (np.arange(OD)[:, None, None] * G + gh[None, :, None]) * G \
        + gh[None, None, :]


@register("_contrib_PSROIPooling", aliases=("PSROIPooling",))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                  pooled_size=1, group_size=0):
    """Position-sensitive ROI pooling (R-FCN): data [N, OD*G*G, H, W], rois
    [R, 5] = (batch index, x1, y1, x2, y2); each bin the plain mean of its
    integer [floor, ceil) window, 0 where empty."""
    G = int(group_size) or int(pooled_size)
    P, OD = int(pooled_size), int(output_dim)
    N, C, H, W = data.shape
    scale = float(spatial_scale)
    dev, dt = data.device, data.dtype
    batch = rois[:, 0].to(torch.int64)
    x1 = torch.round(rois[:, 1]) * scale
    y1 = torch.round(rois[:, 2]) * scale
    x2 = torch.round(rois[:, 3] + 1.0) * scale
    y2 = torch.round(rois[:, 4] + 1.0) * scale
    bin_h = torch.clamp(y2 - y1, min=0.1) / P
    bin_w = torch.clamp(x2 - x1, min=0.1) / P
    phs = torch.arange(P, dtype=dt, device=dev)
    hstart = torch.clamp(torch.floor(phs[None] * bin_h[:, None]
                                     + y1[:, None]), 0, H)
    hend = torch.clamp(torch.ceil((phs[None] + 1) * bin_h[:, None]
                                  + y1[:, None]), 0, H)
    wstart = torch.clamp(torch.floor(phs[None] * bin_w[:, None]
                                     + x1[:, None]), 0, W)
    wend = torch.clamp(torch.ceil((phs[None] + 1) * bin_w[:, None]
                                  + x1[:, None]), 0, W)
    hidx = torch.arange(H, dtype=dt, device=dev)
    widx = torch.arange(W, dtype=dt, device=dev)
    mh = ((hidx[None, None] >= hstart[:, :, None])
          & (hidx[None, None] < hend[:, :, None])).to(dt)
    mw = ((widx[None, None] >= wstart[:, :, None])
          & (widx[None, None] < wend[:, :, None])).to(dt)
    cmap = torch.as_tensor(_ps_channel_map(OD, G, P), device=dev)
    dsel = data[batch][:, cmap]                    # (R, OD, P, P, H, W)
    num = torch.einsum("rcijhw,rih,rjw->rcij", dsel, mh, mw)
    cnt = torch.einsum("rih,rjw->rij", mh, mw)[:, None]
    out = torch.where(cnt > 0, num / torch.clamp(cnt, min=1.0),
                      torch.zeros_like(num))
    return out.to(dt)


@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",))
def deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                             output_dim=1, group_size=1, pooled_size=1,
                             part_size=0, sample_per_part=1, trans_std=0.0,
                             no_trans=False):
    """Deformable position-sensitive ROI pooling: each bin averages
    sample_per_part^2 bilinear samples shifted by the class's ``trans``
    offsets; samples outside [-0.5, size - 0.5] count in neither sum nor
    count."""
    P, G, OD = int(pooled_size), int(group_size), int(output_dim)
    PS = int(part_size) or P
    SP = int(sample_per_part)
    scale, tstd = float(spatial_scale), float(trans_std)
    N, C, H, W = data.shape
    R = rois.shape[0]
    dev, dt = data.device, data.dtype
    batch = rois[:, 0].to(torch.int64)
    x1 = torch.round(rois[:, 1]) * scale - 0.5
    y1 = torch.round(rois[:, 2]) * scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_h, bin_w = rh / P, rw / P
    sub_h, sub_w = bin_h / SP, bin_w / SP
    part = torch.as_tensor(np.floor(np.arange(P) / P * PS).astype(np.int64),
                           device=dev)
    if no_trans or trans is None:
        n_classes = 1
        tx = torch.zeros((R, 1, P, P), dtype=dt, device=dev)
        ty = torch.zeros((R, 1, P, P), dtype=dt, device=dev)
    else:
        n_classes = trans.shape[1] // 2
        tr = trans.reshape(R, n_classes, 2, PS, PS)
        tx = tr[:, :, 0][:, :, part][:, :, :, part] * tstd
        ty = tr[:, :, 1][:, :, part][:, :, :, part] * tstd
    cls_of = torch.as_tensor(np.arange(OD) // max(1, OD // n_classes),
                             device=dev)
    phs = torch.arange(P, dtype=dt, device=dev)
    ih = torch.arange(SP, dtype=dt, device=dev)
    hstart0 = phs[None] * bin_h[:, None] + y1[:, None]        # (R, P)
    wstart0 = phs[None] * bin_w[:, None] + x1[:, None]
    hstart = hstart0[:, None, :, None] + ty * rh[:, None, None, None]
    wstart = wstart0[:, None, None, :] + tx * rw[:, None, None, None]
    r6 = (slice(None),) + (None,) * 5
    ys = hstart[..., None, None] + ih[:, None] * sub_h[r6]
    xs = wstart[..., None, None] + ih[None, :] * sub_w[r6]
    ys, xs = torch.broadcast_tensors(ys, xs)     # (R, ncls, P, P, SP, SP)
    valid = (ys >= -0.5) & (ys <= H - 0.5) & (xs >= -0.5) & (xs <= W - 0.5)
    yc = torch.clamp(ys, 0.0, H - 1.0)
    xc = torch.clamp(xs, 0.0, W - 1.0)
    cmap = torch.as_tensor(_ps_channel_map(OD, G, P), device=dev)
    dsel = data[batch][:, cmap]                    # (R, OD, P, P, H, W)
    yso, xso, vo = yc[:, cls_of], xc[:, cls_of], valid[:, cls_of]
    M = R * OD * P * P
    vals = _gather2d(dsel.reshape(M, H, W), yso.reshape(M, SP, SP),
                     xso.reshape(M, SP, SP)).reshape(R, OD, P, P, SP, SP)
    vf = vo.to(dt)
    cnt = vf.sum((-1, -2))
    ssum = (vals * vf).sum((-1, -2))
    out = torch.where(cnt > 0, ssum / torch.clamp(cnt, min=1.0),
                      torch.zeros_like(ssum))
    return out.to(dt)


def _generate_anchors(feature_stride, scales, ratios):
    """ref: contrib/proposal-inl.h:213 GenerateAnchors: ratio-major,
    scale-minor."""
    base = [0.0, 0.0, feature_stride - 1.0, feature_stride - 1.0]
    w = base[2] - base[0] + 1.0
    h = base[3] - base[1] + 1.0
    x_ctr = base[0] + 0.5 * (w - 1.0)
    y_ctr = base[1] + 0.5 * (h - 1.0)
    size = w * h
    anchors = []
    for ratio in ratios:
        size_ratios = math.floor(size / ratio)
        new_w = math.floor(math.sqrt(size_ratios) + 0.5)
        new_h = math.floor(new_w * ratio + 0.5)
        for scale in scales:
            sw, sh = new_w * scale, new_h * scale
            anchors.append([x_ctr - 0.5 * (sw - 1.0), y_ctr - 0.5 * (sh - 1.0),
                            x_ctr + 0.5 * (sw - 1.0), y_ctr + 0.5 * (sh - 1.0)])
    return np.array(anchors, dtype=np.float32)


@torch.no_grad()
def _proposals(scores, bbox_deltas, im_info, anchors, feature_stride,
               pre_nms_top_n, post_nms_top_n, threshold, min_size, iou_loss):
    """Every image at once: scores (N, A, H, W) foreground, bbox_deltas
    (N, 4A, H, W), im_info (N, 3) = (height, width, scale) -> (boxes
    (N, post, 4), scores (N, post)): kept boxes first in score order, the
    list cycled to ``post`` rows (ref: proposal.cc:214 and :408-420)."""
    from ..kernels import box_nms as _nms
    N, A, H, W = scores.shape
    dev = scores.device
    fs = float(feature_stride)
    sy, sx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev)
                            * fs, torch.arange(W, dtype=torch.float32,
                                               device=dev) * fs,
                            indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], -1)
    anc = (anchors.to(dev)[None, None] + shifts[:, :, None]).reshape(-1, 4)
    sc = scores.permute(0, 2, 3, 1).reshape(N, -1)
    d = bbox_deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, -1, 4)
    im_h, im_w, im_scale = (im_info[:, k, None] for k in range(3))
    if iou_loss:
        px1, py1, px2, py2 = (anc[None, :, k] + d[..., k] for k in range(4))
    else:
        w = anc[:, 2] - anc[:, 0] + 1.0
        h = anc[:, 3] - anc[:, 1] + 1.0
        cx = anc[:, 0] + 0.5 * (w - 1.0)
        cy = anc[:, 1] + 0.5 * (h - 1.0)
        pcx = d[..., 0] * w + cx
        pcy = d[..., 1] * h + cy
        pw = torch.exp(d[..., 2]) * w
        ph = torch.exp(d[..., 3]) * h
        px1 = pcx - 0.5 * (pw - 1.0)
        py1 = pcy - 0.5 * (ph - 1.0)
        px2 = pcx + 0.5 * (pw - 1.0)
        py2 = pcy + 0.5 * (ph - 1.0)
    zero = torch.zeros_like(im_w)
    px1 = torch.clamp(px1, zero, im_w - 1.0)
    py1 = torch.clamp(py1, zero, im_h - 1.0)
    px2 = torch.clamp(px2, zero, im_w - 1.0)
    py2 = torch.clamp(py2, zero, im_h - 1.0)
    # predictions from the padded region (ref: proposal.cc:362-373)
    real_h = torch.floor(im_h / fs)[..., None, None]
    real_w = torch.floor(im_w / fs)[..., None, None]
    hh = torch.arange(H, dtype=torch.float32, device=dev)
    ww = torch.arange(W, dtype=torch.float32, device=dev)
    pad = ((hh[None, :, None, None] >= real_h)
           | (ww[None, None, :, None] >= real_w)).expand(N, H, W, A)
    neg = torch.full_like(sc, -1.0)
    sc = torch.where(pad.reshape(N, -1), neg, sc)
    # FilterBox (ref: proposal.cc:145): too-small boxes grow and score -1
    ms = min_size * im_scale
    small = (px2 - px1 + 1.0 < ms) | (py2 - py1 + 1.0 < ms)
    px1 = torch.where(small, px1 - ms / 2, px1)
    py1 = torch.where(small, py1 - ms / 2, py1)
    px2 = torch.where(small, px2 + ms / 2, px2)
    py2 = torch.where(small, py2 + ms / 2, py2)
    sc = torch.where(small, neg, sc)
    boxes = torch.stack([px1, py1, px2, py2], -1)
    count = boxes.shape[1]
    pre_n = min(pre_nms_top_n if pre_nms_top_n > 0 else count, count)
    top_sc, top_idx = torch.sort(sc, dim=1, descending=True, stable=True)
    top_sc, top_idx = top_sc[:, :pre_n], top_idx[:, :pre_n]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    keep = _nms.keep(top_boxes, None, (top_sc >= 0).sum(1), threshold,
                     plus_one=True).to(dev)
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True)[1]
    cnt = torch.clamp(keep.sum(1, keepdim=True), min=1)
    pick = torch.gather(order, 1, torch.remainder(
        torch.arange(post_nms_top_n, device=dev)[None], cnt))
    return (torch.gather(top_boxes, 1, pick[..., None].expand(-1, -1, 4)),
            torch.gather(top_sc, 1, pick))


def _proposal_args(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                   rpn_post_nms_top_n, threshold, rpn_min_size, scales,
                   ratios, feature_stride, iou_loss):
    anchors = torch.as_tensor(_generate_anchors(
        float(feature_stride), [float(s) for s in scales],
        [float(r) for r in ratios]))
    A = cls_prob.shape[1] // 2
    return _proposals(cls_prob[:, A:], bbox_pred, im_info, anchors,
                      feature_stride, int(rpn_pre_nms_top_n),
                      int(rpn_post_nms_top_n), float(threshold),
                      float(rpn_min_size), bool(iou_loss))


@register("_contrib_Proposal", aliases=("Proposal",))
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
             feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals of the first image: cls_prob [1, 2A, H, W] (the
    foreground half used), bbox_pred [1, 4A, H, W], im_info [1, 3] ->
    rois [post_nms_top_n, 5] (batch index 0, corners), and the scores
    with ``output_score``."""
    boxes, scores = _proposal_args(
        cls_prob[:1], bbox_pred[:1], im_info[:1], rpn_pre_nms_top_n,
        rpn_post_nms_top_n, threshold, rpn_min_size, scales, ratios,
        feature_stride, iou_loss)
    boxes, scores = boxes[0], scores[0]
    rois = torch.cat([torch.zeros_like(boxes[:, :1]), boxes], 1)
    return (rois, scores[:, None]) if output_score else rois


@register("_contrib_MultiProposal", aliases=("MultiProposal",))
def multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                   rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                   scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                   feature_stride=16, output_score=False, iou_loss=False):
    """Proposal for every image: rois [N*post_nms_top_n, 5] with each
    image's batch index."""
    boxes, scores = _proposal_args(
        cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n, rpn_post_nms_top_n,
        threshold, rpn_min_size, scales, ratios, feature_stride, iou_loss)
    N, P = boxes.shape[:2]
    bidx = torch.arange(N, dtype=boxes.dtype, device=boxes.device)[
        :, None, None].expand(N, P, 1)
    rois = torch.cat([bidx, boxes], -1).reshape(N * P, 5)
    return (rois, scores.reshape(N * P, 1)) if output_score else rois


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",))
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets: anchor [1, A, 4] corners, label [N, L, 5+]
    rows (class, x1, y1, x2, y2) padded with -1 rows, cls_pred [N, n_cls,
    A] -> (loc_target [N, A*4], loc_mask [N, A*4], cls_target [N, A]).
    Greedy bipartite matching (one gt per round, L rounds), then each
    unmatched anchor's best gt above ``overlap_threshold``, then hard
    negatives by background probability."""
    anc = anchor.reshape(-1, 4)
    A = anc.shape[0]
    N, L = label.shape[0], label.shape[1]
    dev = label.device
    vx, vy, vw, vh = (float(v) for v in variances)
    ot, neg_ratio = float(overlap_threshold), float(negative_mining_ratio)
    neg_thresh, ign = float(negative_mining_thresh), float(ignore_label)
    valid = torch.cumprod((label[..., 0] != -1.0).to(torch.int32), 1) > 0
    ax1, ay1, ax2, ay2 = (anc[None, :, k, None] for k in range(4))
    gx1, gy1, gx2, gy2 = (label[:, None, :, k] for k in range(1, 5))
    with torch.no_grad():
        iw = torch.clamp(torch.minimum(ax2, gx2) - torch.maximum(ax1, gx1),
                         min=0.0)
        ih = torch.clamp(torch.minimum(ay2, gy2) - torch.maximum(ay1, gy1),
                         min=0.0)
        inter = iw * ih
        union = (ax2 - ax1) * (ay2 - ay1) + (gx2 - gx1) * (gy2 - gy1) - inter
        iou = torch.where(union > 0, inter / union, torch.zeros_like(union))
        iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
        # phase 1: greedy bipartite matching (ref: multibox_target.cc:112)
        bidx = torch.arange(N, device=dev)
        a_matched = torch.zeros((N, A), dtype=torch.bool, device=dev)
        g_matched = torch.zeros((N, L), dtype=torch.bool, device=dev)
        m_iou = torch.full((N, A), -1.0, dtype=iou.dtype, device=dev)
        m_gt = torch.full((N, A), -1, dtype=torch.int64, device=dev)
        for _ in range(L):
            m = torch.where(a_matched[:, :, None] | g_matched[:, None, :],
                            torch.full_like(iou, -1.0), iou).reshape(N, -1)
            best = torch.argmax(m, 1)
            val = m[bidx, best]
            ok = val > 1e-6
            bi, bk = best // L, best % L
            a_matched[bidx, bi] |= ok
            g_matched[bidx, bk] |= ok
            m_iou[bidx, bi] = torch.where(ok, val, m_iou[bidx, bi])
            m_gt[bidx, bi] = torch.where(ok, bk, m_gt[bidx, bi])
        # phase 2: each unmatched anchor's best gt (cc:150)
        best_iou, best_gt = torch.max(iou, 2)
        unmatched = ~a_matched
        m_iou = torch.where(unmatched, best_iou, m_iou)
        m_gt = torch.where(unmatched, best_gt, m_gt)
        positive = a_matched | (unmatched & (best_iou > ot)) if ot > 0 \
            else a_matched
        # negatives: hard mining (cc:181) or every other anchor
        if neg_ratio > 0:
            c = cls_pred.detach()
            mx = c.max(1).values
            prob_bg = torch.exp(c[:, 0] - mx) / \
                torch.exp(c - mx[:, None]).sum(1)
            cand = ~positive & (m_iou < neg_thresh)
            num_pos = positive.sum(1, keepdim=True).to(torch.int32)
            num_neg = torch.minimum((num_pos.float() * neg_ratio).to(
                torch.int32), A - num_pos)
            score = torch.where(cand, -prob_bg,
                                torch.full_like(prob_bg, -math.inf))
            order = torch.sort(-score, dim=1, stable=True)[1]
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(A, device=dev).expand(N, A))
            negative = cand & (rank < num_neg)
        else:
            negative = ~positive
        has_gt = valid.any(1, keepdim=True)
    # targets (cc:251)
    gl = torch.gather(label, 1, torch.clamp(m_gt, min=0)[..., None].expand(
        -1, -1, label.shape[2]))                      # (N, A, 5+)
    a = anc[None]
    aw, ah = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
    acx, acy = (a[..., 0] + a[..., 2]) * 0.5, (a[..., 1] + a[..., 3]) * 0.5
    gw, gh = gl[..., 3] - gl[..., 1], gl[..., 4] - gl[..., 2]
    gcx = (gl[..., 1] + gl[..., 3]) * 0.5
    gcy = (gl[..., 2] + gl[..., 4]) * 0.5
    lt = torch.stack([(gcx - acx) / aw / vx, (gcy - acy) / ah / vy,
                      torch.log(torch.clamp(gw / aw, min=1e-12)) / vw,
                      torch.log(torch.clamp(gh / ah, min=1e-12)) / vh], -1)
    pos = (positive & has_gt)[..., None]
    loc_t = torch.where(pos, lt, torch.zeros_like(lt)).reshape(N, -1)
    loc_m = pos.expand(N, A, 4).to(lt.dtype).reshape(N, -1)
    cls_t = torch.full((N, A), ign, dtype=gl.dtype, device=dev)
    cls_t = torch.where(negative, torch.zeros_like(cls_t), cls_t)
    cls_t = torch.where(positive, gl[..., 0] + 1.0, cls_t)
    cls_t = torch.where(has_gt, cls_t, torch.full_like(cls_t, ign))
    return loc_t, loc_m, cls_t


@register("_contrib_RROIAlign", aliases=("RROIAlign",))
def rroi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sampling_ratio=-1):
    """Rotated ROI align: rois [R, 6] = (batch index, cx, cy, w, h,
    theta in degrees); a bilinear sample grid rotated about the ROI's
    centre, samples outside the image 0 but counted. sampling_ratio <= 0
    is a grid of 2, as in the JAX package."""
    PH, PW = int(pooled_size[0]), int(pooled_size[1])
    SR = int(sampling_ratio) if int(sampling_ratio) > 0 else 2
    scale = float(spatial_scale)
    N, C, H, W = data.shape
    R = rois.shape[0]
    dev, dt = data.device, data.dtype
    batch = rois[:, 0].to(torch.int64)
    cx, cy = rois[:, 1] * scale, rois[:, 2] * scale
    rw = torch.clamp(rois[:, 3] * scale, min=1.0)
    rh = torch.clamp(rois[:, 4] * scale, min=1.0)
    theta = rois[:, 5] * (math.pi / 180.0)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    bin_h, bin_w = rh / PH, rw / PW
    start_h, start_w = -rh / 2.0, -rw / 2.0
    ph = torch.arange(PH, dtype=dt, device=dev)
    pw = torch.arange(PW, dtype=dt, device=dev)
    iy = torch.arange(SR, dtype=dt, device=dev)
    c3 = (slice(None), None, None)
    yy = (start_h[c3] + ph[None, :, None] * bin_h[c3]
          + (iy[None, None, :] + 0.5) * bin_h[c3] / SR)       # (R, PH, SR)
    xx = (start_w[c3] + pw[None, :, None] * bin_w[c3]
          + (iy[None, None, :] + 0.5) * bin_w[c3] / SR)       # (R, PW, SR)
    c5 = (slice(None),) + (None,) * 4
    xl, yl = xx[:, None, :, None, :], yy[:, :, None, :, None]
    x = xl * cos_t[c5] + yl * sin_t[c5] + cx[c5]        # (R, PH, PW, SR, SR)
    y = yl * cos_t[c5] - xl * sin_t[c5] + cy[c5]
    oob = (y < -1.0) | (y > H) | (x < -1.0) | (x > W)
    yc = torch.clamp(y, 0.0, H - 1.0)
    xc = torch.clamp(x, 0.0, W - 1.0)
    shape = (R, C, PH, PW, SR, SR)
    vals = _gather2d(data[batch].reshape(R * C, H, W),
                     yc[:, None].expand(shape).reshape(R * C, PH, PW, SR, SR),
                     xc[:, None].expand(shape).reshape(R * C, PH, PW, SR, SR))
    vals = vals.reshape(shape)
    vals = torch.where(oob[:, None], torch.zeros_like(vals), vals)
    return (vals.sum((-1, -2)) / (SR * SR)).to(dt)


@register("Crop", aliases=("crop_like",))
def crop(data, *crop_like, num_args=1, offset=(0, 0), h_w=(0, 0),
         center_crop=False):
    """The legacy Crop: the spatial dims of ``data`` [N, C, H, W] cut to
    ``h_w``, or to the H and W of a second input; the window at
    ``offset`` (y, x) or centred."""
    if crop_like and crop_like[0] is not None:
        th, tw = int(crop_like[0].shape[2]), int(crop_like[0].shape[3])
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    H, W = int(data.shape[2]), int(data.shape[3])
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]
