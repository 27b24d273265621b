"""Part of the operator long tail (counterpart of mxnet_tpu/ops/extended.py):
the multi-tensor and AMP helpers (``all_finite``, ``multi_all_finite``,
``multi_sum_sq``, ``amp_multicast``) and the legacy aliases of ported ops
(``BatchNorm_v1``, ``Convolution_v1``, ``Pooling_v1``, ``CuDNNBatchNorm``,
``SyncBatchNorm``, ``_contrib_SyncBatchNorm``, ``_contrib_SparseEmbedding``),
the same computation under the reference's older names. The rest of the
JAX module (FFT, detection, the linalg extras, ...) is not ported yet.
"""
from __future__ import annotations

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
