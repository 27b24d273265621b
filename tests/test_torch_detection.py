"""The port's box, anchor, ROI and detection ops and the SSD recipe against
the JAX package's, on the CPU.

- ``box_iou``, ``MultiBoxPrior`` and ``ROIPooling`` within 1e-6.
- ``box_nms``, ``MultiBoxDetection``, ``Proposal``, ``MultiProposal``,
  ``bipartite_matching`` and ``MultiBoxTarget``: the same kept set and
  order, classes, scores and masks exactly, coordinates within 1e-6,
  including cases with tied scores and with an IoU exactly at the
  threshold.
- ``ROIAlign``, ``RROIAlign``, ``PSROIPooling``, ``DeformablePSROIPooling``,
  ``DeformableConvolution``, ``SpatialTransformer``, ``BilinearResize2D``,
  ``AdaptiveAvgPooling2D``, ``Correlation`` and ``Crop``: forward and, where
  the JAX op has one, the gradient (``jax.vjp``) within 1e-5 of the largest
  magnitude.
- The greedy NMS pass's plain version (``kernels/box_nms.keep_reference``)
  against a box-by-box loop, and its bit packing at word edges.
- The SSD recipe of example/ssd/train_ssd.py at the example's size (the
  port's copy lives in chip_smoke.py): the first batch's bytes and labels
  equal, the first loss within 1e-5 with TinySSD's weights carried across,
  two epochs each, and ``detect`` within 1e-5 under one set of weights.
- Every one of the 72 names resolves, and ``nd.contrib`` exposes them.
"""
import importlib.util
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import box_nms as NMS
from mxnet_tpu_torch.ops import registry as treg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax(name, args, kw):
    return jreg.get_op(name).fn(*[jnp.asarray(a) for a in args], **kw)


def _port(name, args, kw):
    return treg.get_op(name).fn(*[torch.from_numpy(np.array(a))
                                  for a in args], **kw)


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size:
        scale = max(float(np.abs(want).max()), 1.0)
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, (what, err, tol * scale)


def _forward(name, args, kw, tol):
    outs = []
    for g, w in zip(_tuple(_port(name, args, kw)),
                    _tuple(_jax(name, args, kw))):
        _close(g.detach().numpy(), w, tol, name)
        outs.append((g.detach().numpy(), np.asarray(w)))
    return outs


def _grad(name, args, kw, diff, tol, seed=0):
    """Gradients of sum(out * ct) w.r.t. the inputs at ``diff``: torch's
    autograd against ``jax.vjp``."""
    def jf(*d):
        full = list(map(jnp.asarray, args))
        for i, v in zip(diff, d):
            full[i] = v
        return jreg.get_op(name).fn(*full, **kw)
    jout, vjp = jax.vjp(jf, *[jnp.asarray(args[i]) for i in diff])
    rs = np.random.RandomState(seed)
    ct = rs.uniform(-1, 1, np.shape(jout)).astype(np.float32)
    jg = vjp(jnp.asarray(ct))
    targs = [torch.from_numpy(np.array(a)) for a in args]
    for i in diff:
        targs[i].requires_grad_(True)
    out = treg.get_op(name).fn(*targs, **kw)
    (out * torch.from_numpy(ct)).sum().backward()
    for i, g in zip(diff, jg):
        tg = targs[i].grad
        tg = np.zeros(np.shape(g), np.float32) if tg is None else tg.numpy()
        _close(tg, g, tol, "%s grad of input %d" % (name, i))


def U(rs, *shape):
    return rs.uniform(-1, 1, shape).astype(np.float32)


def _boxes(rs, n, scale=1.0, batch=()):
    b = rs.uniform(0, 0.6, batch + (n, 4)).astype(np.float32)
    b[..., 2:] = b[..., :2] + rs.uniform(0.05, 0.4, batch + (n, 2))
    return (b * scale).astype(np.float32)


def _records(rs, b=2, n=60, classes=3):
    ids = rs.randint(0, classes, (b, n, 1)).astype(np.float32)
    scores = rs.uniform(0, 1, (b, n, 1)).astype(np.float32)
    return np.concatenate([ids, scores, _boxes(rs, n, batch=(b,))], -1)


# -- box_iou, MultiBoxPrior, ROIPooling ----------------------------------------

@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rs = np.random.RandomState(0)
    _forward("box_iou", (_boxes(rs, 5), _boxes(rs, 7)), {"format": fmt},
             1e-6)
    _forward("box_iou", (_boxes(rs, 4, batch=(2,)),
                         _boxes(rs, 6, batch=(2,))), {"format": fmt}, 1e-6)
    _grad("box_iou", (_boxes(rs, 5), _boxes(rs, 7)), {"format": fmt},
          (0, 1), 1e-5)


PRIORS = [dict(sizes=(0.3, 0.45), ratios=(1.0, 2.0, 0.5)),
          dict(sizes=(0.5,), ratios=(1.0,), clip=True),
          dict(sizes=(0.2, 0.6, 0.9), ratios=(1.0, 3.0), steps=(0.2, 0.125),
               offsets=(0.25, 0.75), clip=True)]


@pytest.mark.parametrize("kw", PRIORS, ids=["ssd", "clip", "steps"])
def test_multibox_prior(kw):
    feat = np.zeros((2, 3, 5, 8), np.float32)
    _forward("MultiBoxPrior", (feat,), kw, 1e-6)


def _rois(rs, n, scale):
    return np.concatenate([rs.randint(0, 2, (n, 1)).astype(np.float32),
                           _boxes(rs, n, scale)], 1)


def test_roi_pooling():
    rs = np.random.RandomState(1)
    x = U(rs, 2, 3, 16, 16)
    rois = _rois(rs, 5, 14.0)
    _forward("ROIPooling", (x, rois), dict(pooled_size=(3, 3)), 1e-6)
    _forward("ROIPooling", (x, rois), dict(pooled_size=(2, 4),
                                           spatial_scale=0.5), 1e-6)
    _grad("ROIPooling", (x, rois), dict(pooled_size=(3, 3)), (0,), 1e-5)


# -- the greedy ops: exact kept sets -------------------------------------------

def _nms_both(data, kw):
    got = _port("box_nms", (data,), kw).numpy()
    want = np.asarray(_jax("box_nms", (data,), kw))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    _close(got, want, 1e-6, "box_nms %s" % kw)
    return got


NMS_CASES = {
    "class_aware": dict(overlap_thresh=0.3, id_index=0),
    "force": dict(overlap_thresh=0.3, id_index=0, force_suppress=True),
    "topk_valid": dict(overlap_thresh=0.5, id_index=0, topk=25,
                       valid_thresh=0.3),
    "background": dict(overlap_thresh=0.4, id_index=0, background_id=1),
    "no_ids": dict(overlap_thresh=0.2),
    "center_in": dict(overlap_thresh=0.3, in_format="center"),
    "center_out": dict(overlap_thresh=0.3, out_format="center"),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_box_nms(case):
    rs = np.random.RandomState(2)
    got = _nms_both(_records(rs), NMS_CASES[case])
    assert (got[..., 1] >= 0).sum() > 0


def test_box_nms_layouts_and_gradient():
    rs = np.random.RandomState(3)
    data = _records(rs, b=3, n=20)
    _nms_both(data[0], dict(overlap_thresh=0.3))              # 2-D input
    _nms_both(data.reshape(3, 1, 20, 6), dict(overlap_thresh=0.3))
    moved = np.concatenate([data[..., 1:2], data[..., 2:], data[..., :1]],
                           -1)                     # score, box, id
    _nms_both(moved, dict(overlap_thresh=0.3, score_index=0,
                          coord_start=1, id_index=5))
    _grad("box_nms", (data,), dict(overlap_thresh=0.3), (0,), 1e-6)


def test_box_nms_ties_and_threshold():
    """Tied scores keep index order; an IoU of exactly the threshold does
    not suppress, one just above it does."""
    box = [[0, 0, 3, 1], [1, 0, 4, 1], [2, 0, 5, 1], [0, 0, 3, 1],
           [10, 10, 11, 11], [10, 10, 11, 11]]      # IoU(0, 1) = 0.5
    scores = [0.9, 0.9, 0.9, 0.9, 0.7, 0.7]
    data = np.array([[[0, s] + b for s, b in zip(scores, box)]],
                    np.float32)
    for thr in (0.5, np.nextafter(np.float32(0.5), np.float32(0)), 0.25):
        got = _nms_both(data, dict(overlap_thresh=float(thr)))
        assert (got[0, :, 1] >= 0).sum() >= 2
    got = _nms_both(data, dict(overlap_thresh=0.5))
    # boxes 0 and 1 overlap by exactly 0.5: both survive; 3 is 0's twin
    np.testing.assert_array_equal(got[0, :4, 2],
                                  np.array([0, 1, 2, 10], np.float32))


def test_nms_plain_version_against_a_loop():
    """keep_reference against a box-by-box greedy loop, prefixes that end
    inside and at the edge of a 64-bit word."""
    rs = np.random.RandomState(4)
    for n, nv in ((130, 130), (130, 64), (130, 63), (70, 65), (5, 0)):
        b = torch.from_numpy(_boxes(rs, n, batch=(1,)))
        ids = torch.from_numpy(rs.randint(0, 2, (1, n)).astype(np.float32))
        for plus_one, idv in ((False, None), (False, ids), (True, None)):
            got = NMS.keep(b * (30 if plus_one else 1), idv,
                           torch.tensor([nv]), 0.3, plus_one)
            bx = (b[0] * (30 if plus_one else 1)).numpy()
            iou = NMS.iou_rows(bx, bx, plus_one)
            want = np.zeros(n, bool)
            for i in range(nv):
                if any(want[k] and iou[k, i] > 0.3 and (
                        idv is None or idv[0, k] == idv[0, i])
                        for k in range(i)):
                    continue
                want[i] = True
            np.testing.assert_array_equal(got[0].numpy(), want)


BIPARTITE = [dict(threshold=0.1), dict(threshold=0.5),
             dict(threshold=0.2, is_ascend=True),
             dict(threshold=0.1, topk=2), dict(threshold=-1.0)]


@pytest.mark.parametrize("kw", BIPARTITE,
                         ids=["t01", "t05", "ascend", "topk", "all"])
def test_bipartite_matching(kw):
    rs = np.random.RandomState(5)
    for shape in ((2, 5, 7), (3, 6, 4), (4, 4)):
        for g, w in _forward("bipartite_matching",
                             (rs.uniform(0, 1, shape).astype(np.float32),),
                             kw, 0.0):
            np.testing.assert_array_equal(g, w)
    ties = np.array([[[0.5, 0.5, 0.2], [0.5, 0.5, 0.5], [0.1, 0.5, 0.5]]],
                    np.float32)
    _forward("bipartite_matching", (ties,), kw, 0.0)


def _ssd_inputs(rs, B=3, classes=4, gt=5, size=(6, 8)):
    feat = np.zeros((1, 1) + size, np.float32)
    anchors = np.asarray(_jax("MultiBoxPrior", (feat,), dict(
        sizes=(0.3, 0.5), ratios=(1.0, 2.0, 0.5))))
    A = anchors.shape[1]
    labels = np.full((B, gt, 5), -1.0, np.float32)
    for i in range(B - 1):                  # the last image has no object
        k = rs.randint(1, gt + 1)
        labels[i, :k, 0] = rs.randint(0, classes - 1, k)
        labels[i, :k, 1:] = _boxes(rs, k)
    cls = U(rs, B, classes, A) * 3
    loc = U(rs, B, A * 4) * 0.5
    return anchors, labels, cls, loc


TARGETS = [dict(overlap_threshold=0.5, negative_mining_ratio=3.0,
                negative_mining_thresh=0.5),
           dict(overlap_threshold=0.5),
           dict(overlap_threshold=0.0, negative_mining_ratio=2.0,
                variances=(0.2, 0.2, 0.1, 0.1), ignore_label=-2.0)]


@pytest.mark.parametrize("kw", TARGETS, ids=["mining", "all_neg", "no_ot"])
def test_multibox_target(kw):
    rs = np.random.RandomState(6)
    anchors, labels, cls, _ = _ssd_inputs(rs)
    outs = _forward("MultiBoxTarget", (anchors, labels, cls), kw, 1e-6)
    for g, w in outs[1:]:
        np.testing.assert_array_equal(g, w)
    assert (outs[2][0] > 0).any()


def test_multibox_target_ties():
    """Twin anchors (equal IoU with every box), twin boxes and equal
    background scores: the first index wins as in JAX."""
    anchors = np.array([[[0.1, 0.1, 0.4, 0.4], [0.1, 0.1, 0.4, 0.4],
                         [0.5, 0.5, 0.9, 0.9], [0.5, 0.5, 0.9, 0.9],
                         [0.0, 0.6, 0.3, 0.9]]], np.float32)
    labels = np.array([[[0, 0.1, 0.1, 0.4, 0.4], [1, 0.1, 0.1, 0.4, 0.4],
                        [2, 0.5, 0.5, 0.8, 0.9], [-1, -1, -1, -1, -1]]],
                      np.float32)
    cls = np.zeros((1, 3, 5), np.float32)
    for kw in TARGETS:
        outs = _forward("MultiBoxTarget", (anchors, labels, cls), kw, 1e-6)
        for g, w in outs[1:]:
            np.testing.assert_array_equal(g, w)


DETECTIONS = [dict(nms_threshold=0.45), dict(nms_threshold=0.3,
                                             force_suppress=True),
              dict(nms_threshold=0.5, nms_topk=20, threshold=0.2),
              dict(nms_threshold=0.45, clip=False, background_id=0,
                   variances=(0.2, 0.2, 0.3, 0.3))]


@pytest.mark.parametrize("kw", DETECTIONS,
                         ids=["ssd", "force", "topk", "noclip"])
def test_multibox_detection(kw):
    rs = np.random.RandomState(7)
    anchors, _, cls, loc = _ssd_inputs(rs)
    prob = np.asarray(jax.nn.softmax(jnp.asarray(cls), axis=1))
    (g, w), = _forward("MultiBoxDetection", (prob, loc, anchors), kw, 1e-6)
    np.testing.assert_array_equal(g[..., :2], w[..., :2])
    assert (g[..., 0] >= 0).sum() > 0


def test_multibox_detection_ties():
    """Twin anchors with equal scores decode to one box twice: the first
    survives, and a pair at IoU exactly 0.5 both survive at 0.5."""
    anchors = np.array([[[0, 0, 0.3, 0.1], [0, 0, 0.3, 0.1],
                         [0.1, 0, 0.4, 0.1], [0.5, 0.5, 0.7, 0.7]]],
                       np.float32)
    prob = np.array([[[0.2, 0.2, 0.2, 0.5], [0.8, 0.8, 0.8, 0.5]]],
                    np.float32)
    loc = np.zeros((1, 16), np.float32)
    for thr in (0.5, 0.3):
        (g, w), = _forward("MultiBoxDetection", (prob, loc, anchors),
                           dict(nms_threshold=thr), 1e-6)
        np.testing.assert_array_equal(g[..., :2], w[..., :2])


def _proposal_inputs(rs, N=2, A=3, H=5, W=6, ties=False):
    cls = rs.uniform(0, 1, (N, 2 * A, H, W)).astype(np.float32)
    if ties:
        cls[:, A:] = np.round(cls[:, A:] * 4) / 4
    deltas = U(rs, N, 4 * A, H, W) * 0.2
    im_info = np.array([[80, 96, 1.0], [64, 90, 1.5]][:N], np.float32)
    return cls, deltas, im_info


PROPOSALS = [dict(rpn_pre_nms_top_n=60, rpn_post_nms_top_n=20,
                  threshold=0.7, rpn_min_size=4, scales=(2, 4, 8),
                  ratios=(1.0,), feature_stride=16),
             dict(rpn_pre_nms_top_n=-1, rpn_post_nms_top_n=120,
                  threshold=0.5, rpn_min_size=16, scales=(1, 2),
                  ratios=(0.5, 1.0, 2.0), feature_stride=16,
                  output_score=True),
             dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=15,
                  threshold=0.6, rpn_min_size=2, scales=(4,),
                  ratios=(0.5, 1.0, 2.0), feature_stride=16, iou_loss=True,
                  output_score=True)]


@pytest.mark.parametrize("kw", PROPOSALS, ids=["plain", "score", "iou_loss"])
@pytest.mark.parametrize("ties", [False, True])
def test_proposal_and_multi_proposal(kw, ties):
    rs = np.random.RandomState(8)
    A = len(kw["scales"]) * len(kw["ratios"])
    cls, deltas, info = _proposal_inputs(rs, A=A, ties=ties)
    for name, args in (("_contrib_Proposal", (cls[:1], deltas[:1],
                                              info[:1])),
                       ("_contrib_MultiProposal", (cls, deltas, info))):
        for g, w in _forward(name, args, kw, 1e-6):
            if g.shape[-1] == 5:
                np.testing.assert_array_equal(g[:, 0], w[:, 0])


def test_proposal_iou_at_threshold():
    """Two proposals of IoU exactly 0.5 (+1 pixel widths) with tied
    scores: both kept at threshold 0.5, one at 0.49."""
    A, H, W = 1, 1, 2
    cls = np.array([[[[0.1, 0.1]], [[0.9, 0.9]]]], np.float32)
    # anchors of stride 16 at x = 0 and 16, size 16; deltas that shift the
    # second onto IoU 0.5 with the first: width 16, offset 16/3
    deltas = np.zeros((1, 4, H, W), np.float32)
    deltas[0, 0, 0, 1] = -(16 - 16 / 3) / 16
    info = np.array([[64, 64, 1.0]], np.float32)
    for thr in (0.5, 0.49):
        kw = dict(rpn_pre_nms_top_n=10, rpn_post_nms_top_n=4,
                  threshold=thr, rpn_min_size=1, scales=(1,), ratios=(1.0,),
                  feature_stride=16, output_score=True)
        _forward("_contrib_Proposal", (cls, deltas, info), kw, 1e-6)
    assert A == 1


# -- the differentiable vision ops ---------------------------------------------

def _vision_cases(rs):
    rois = _rois(rs, 4, 14.0)
    rrois = np.array([[0, 6, 7, 5, 3, 30], [1, 8, 5, 4, 6, -45],
                      [0, 2, 2, 20, 3, 90]], np.float32)
    return {
        "roi_align": ("ROIAlign", (U(rs, 2, 3, 16, 16), rois),
                      dict(pooled_size=(3, 3), sample_ratio=2), (0,)),
        "roi_align_aligned": ("ROIAlign", (U(rs, 2, 3, 16, 16), rois),
                              dict(pooled_size=(2, 3), spatial_scale=0.5,
                                   aligned=True), (0,)),
        "rroi_align": ("RROIAlign", (U(rs, 2, 3, 12, 12), rrois),
                       dict(pooled_size=(2, 3), sampling_ratio=2), (0,)),
        "rroi_align_default": ("RROIAlign", (U(rs, 2, 3, 12, 12), rrois),
                               dict(pooled_size=(3, 3),
                                    spatial_scale=0.5), (0,)),
        "psroi": ("PSROIPooling", (U(rs, 2, 2 * 9, 16, 16), rois),
                  dict(output_dim=2, pooled_size=3, group_size=3,
                       spatial_scale=0.8), (0,)),
        "dpsroi_trans": ("DeformablePSROIPooling",
                         (U(rs, 2, 2 * 9, 16, 16), rois,
                          U(rs, 4, 2, 3, 3) * 0.2),
                         dict(output_dim=2, group_size=3, pooled_size=3,
                              part_size=3, sample_per_part=2,
                              trans_std=0.1), (0, 2)),
        "dpsroi_no_trans": ("DeformablePSROIPooling",
                            (U(rs, 2, 4 * 4, 16, 16), rois),
                            dict(output_dim=4, group_size=2, pooled_size=2,
                                 sample_per_part=3, no_trans=True,
                                 spatial_scale=0.5), (0,)),
        "deform_conv": ("DeformableConvolution",
                        (U(rs, 2, 4, 9, 9), U(rs, 2, 18, 9, 9),
                         U(rs, 6, 4, 3, 3), U(rs, 6)),
                        dict(kernel=(3, 3), pad=(1, 1), num_filter=6),
                        (0, 1, 2, 3)),
        "deform_conv_groups": ("DeformableConvolution",
                               (U(rs, 1, 4, 8, 8), U(rs, 1, 2 * 2 * 4, 4, 4)
                                * 2, U(rs, 4, 2, 2, 2)),
                               dict(kernel=(2, 2), stride=(2, 2),
                                    num_filter=4, num_group=2,
                                    num_deformable_group=2, no_bias=True),
                               (0, 1, 2)),
        "deform_conv_dilate": ("DeformableConvolution",
                               (U(rs, 1, 3, 9, 9), U(rs, 1, 18, 5, 5),
                                U(rs, 2, 3, 3, 3)),
                               dict(kernel=(3, 3), dilate=(2, 2),
                                    num_filter=2, no_bias=True), (0, 1, 2)),
        "spatial_transformer": ("SpatialTransformer",
                                (U(rs, 2, 3, 8, 9), np.array(
                                    [[0.9, 0.1, 0.05, -0.1, 0.8, 0.0],
                                     [1.1, -0.2, 0.1, 0.1, 1.2, -0.1]],
                                    np.float32)),
                                dict(target_shape=(6, 7)), (0, 1)),
        "bilinear_up": ("BilinearResize2D", (U(rs, 2, 3, 5, 6),),
                        dict(height=9, width=13), (0,)),
        "bilinear_down": ("BilinearResize2D", (U(rs, 2, 3, 9, 13),),
                          dict(height=4, width=5), (0,)),
        "bilinear_scale": ("BilinearResize2D", (U(rs, 1, 2, 6, 8),),
                           dict(scale_height=1.5, scale_width=0.75), (0,)),
        "adaptive_even": ("AdaptiveAvgPooling2D", (U(rs, 2, 3, 8, 9),),
                          dict(output_size=(4, 3)), (0,)),
        "adaptive_odd": ("AdaptiveAvgPooling2D", (U(rs, 2, 3, 8, 9),),
                         dict(output_size=(3, 4)), (0,)),
        "adaptive_int": ("AdaptiveAvgPooling2D", (U(rs, 1, 2, 7, 7),),
                         dict(output_size=1), (0,)),
        "correlation": ("Correlation", (U(rs, 2, 3, 9, 9),
                                        U(rs, 2, 3, 9, 9)),
                        dict(kernel_size=3, max_displacement=2,
                             pad_size=2), (0, 1)),
        "correlation_abs": ("Correlation", (U(rs, 1, 2, 10, 10),
                                            U(rs, 1, 2, 10, 10)),
                            dict(kernel_size=1, max_displacement=4,
                                 stride1=2, stride2=2, pad_size=1,
                                 is_multiply=False), (0, 1)),
        "crop_hw": ("Crop", (U(rs, 2, 3, 8, 9),), dict(h_w=(5, 6),
                                                       offset=(1, 2)), (0,)),
        "crop_center": ("Crop", (U(rs, 2, 3, 8, 9),),
                        dict(h_w=(5, 6), center_crop=True), (0,)),
        "crop_like": ("Crop", (U(rs, 2, 3, 8, 9), U(rs, 2, 3, 4, 7)),
                      dict(num_args=2, center_crop=True), (0,)),
    }


VISION = sorted(_vision_cases(np.random.RandomState(0)))


@pytest.mark.parametrize("case", VISION)
def test_vision_op(case):
    name, args, kw, diff = _vision_cases(np.random.RandomState(9))[case]
    _forward(name, args, kw, 1e-5)
    _grad(name, args, kw, diff, 1e-5)


# -- the SSD recipe ---------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_ssd", os.path.join(ROOT, "example", "ssd", "train_ssd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_params(net):
    return {k: np.asarray(p.data().asnumpy()) for k, p in
            net._collect_params_with_prefix().items()}


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def test_ssd_recipe_matches_the_example(tmp_path):
    cs, ex = _chip_smoke(), _example()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jrec, jidx = ex.make_rec_dataset(str(tmp_path / "j" / "s.rec"))
    trec, tidx = cs.ssd_make_rec_dataset(mx, str(tmp_path / "t" / "s.rec"))
    assert open(jrec, "rb").read() == open(trec, "rb").read()
    _seed(0)
    jit = ex.make_det_iter(jrec, jidx)
    jb = next(iter(jit))
    _seed(0)
    with mx.cpu():
        tit = cs.ssd_det_iter(mx, trec, tidx)
        tb = next(iter(tit))
    np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                  jb.data[0].asnumpy())
    np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                  jb.label[0].asnumpy())

    # TinySSD's weights carried across; two epochs of the recipe in each
    jnet = ex.TinySSD()
    jnet.initialize()
    jnet(jb.data[0])
    with mx.cpu():
        tnet = cs.ssd_tiny(mx)
        tnet.initialize()
        tnet(tb.data[0])
        mx.convert.load_numpy_params(tnet, _jax_params(jnet))
        tloss = float(cs.ssd_loss(mx, tnet, tb.data[0], tb.label[0])
                      .asnumpy())
    jloss = float(ex._ssd_loss(jnet, jb.data[0], jb.label[0],
                               cs.SSD_SIZES, cs.SSD_RATIOS).asnumpy())
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss), (tloss, jloss)

    def epochs(pkg, net, it, loss_fn, n=2):
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9})
        out = []
        for _ in range(n):
            it.reset()
            total = []
            for batch in it:
                x, y = batch.data[0], batch.label[0]
                with pkg.autograd.record():
                    loss = loss_fn(net, x, y)
                loss.backward()
                trainer.step(x.shape[0])
                total.append(float(loss.asnumpy()))
            out.append(float(np.mean(total)))
        return out
    _seed(1)
    jl = epochs(mxj, jnet, jit, lambda n, x, y: ex._ssd_loss(
        n, x, y, cs.SSD_SIZES, cs.SSD_RATIOS))
    _seed(1)
    with mx.cpu():
        tl = epochs(mx, tnet, tit, lambda n, x, y: cs.ssd_loss(mx, n, x, y))
    assert np.all(np.isfinite(tl)) and len(tl) == len(jl) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-3)

    # detect under JAX's trained weights
    x, _ = ex.make_batch(np.random.RandomState(99), batch=2)
    want = ex.detect(jnet, x).asnumpy()
    with mx.cpu():
        mx.convert.load_numpy_params(tnet, _jax_params(jnet))
        got = cs.ssd_detect(mx, tnet, mx.nd.array(x.asnumpy())).asnumpy()
    assert got.shape == want.shape == (2, 256, 6)
    np.testing.assert_array_equal(got[..., :1], want[..., :1])
    _close(got, want, 1e-5, "detect")


# -- coverage ---------------------------------------------------------------

NAMES = [
    # ops/extended.py: the box group and the vision layers
    "box_iou", "_contrib_box_iou", "box_nms", "_contrib_box_nms",
    "box_non_maximum_suppression", "bipartite_matching",
    "_contrib_bipartite_matching", "MultiBoxPrior", "_contrib_MultiBoxPrior",
    "multibox_prior", "MultiBoxDetection", "_contrib_MultiBoxDetection",
    "multibox_detection", "ROIAlign", "_contrib_ROIAlign", "roi_align",
    "ROIPooling", "roi_pooling", "SpatialTransformer", "spatial_transformer",
    "BilinearResize2D", "_contrib_BilinearResize2D", "bilinear_resize_2d",
    "AdaptiveAvgPooling2D", "_contrib_AdaptiveAvgPooling2D",
    "adaptive_avg_pooling_2d", "Correlation", "correlation",
]


def test_every_name_is_registered():
    import mxnet_tpu.ops.detection  # noqa: F401
    import mxnet_tpu.ops.image  # noqa: F401
    jnames = set(jreg.list_ops())
    tnames = set(treg.list_ops())
    assert len(NAMES) == 28 and set(NAMES) <= jnames and set(NAMES) <= tnames
    for mod in ("detection", "image"):
        want = {n for n in jnames
                if jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops." + mod}
        assert want and want <= tnames, sorted(want - tnames)
    det = {n for n in jnames
           if jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops.detection"}
    img = {n for n in jnames
           if jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops.image"}
    assert (len(det), len(img)) == (16, 28)


def test_nd_contrib_and_nd_image_resolve():
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "box_nms", "box_iou", "bipartite_matching", "ROIAlign",
                 "Proposal", "MultiProposal", "PSROIPooling",
                 "DeformableConvolution", "DeformablePSROIPooling",
                 "RROIAlign", "BilinearResize2D", "AdaptiveAvgPooling2D"):
        assert callable(getattr(mx.nd.contrib, name)), name
    for name in ("to_tensor", "normalize", "resize", "crop",
                 "random_brightness", "random_lighting", "flip_left_right"):
        assert callable(getattr(mx.nd.image, name)), name
    assert mx.image.ImageDetIter is mx.image_det.ImageDetIter
    with mx.cpu():
        feat = mx.nd.zeros((1, 1, 2, 2))
        anchors = mx.nd.contrib.MultiBoxPrior(feat, sizes=(0.5,))
    assert isinstance(anchors, mx.nd.NDArray) and anchors.shape == (1, 4, 4)
