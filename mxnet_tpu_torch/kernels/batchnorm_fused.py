"""Deterministic product for the BatchNorm normalize chain (counterpart of
``exact_mul`` in mxnet_tpu/pallas_kernels/batchnorm_fused.py).

Only ``exact_mul`` is needed by the inference path (``ops.nn.batch_norm``
with running statistics). The training-mode batch-statistics kernels of
that module arrive with the training slice.
"""
from __future__ import annotations

import torch

__all__ = ["exact_mul"]


def _hi(t):
    """Keep the top 12 significant bits of each f32 value (mantissa
    masking: pure bit ops)."""
    return (t.view(torch.int32) & -4096).view(torch.float32)


def exact_mul(a, b):
    """``a*b`` of float32 tensors by exact-product splitting: each factor
    is split into a high part with at most 12 significant bits and the
    remainder, so every partial product is exact in f32 and no FMA
    contraction choice can change the result. Non-finite inputs give
    plain ``a*b``. The two may broadcast against each other."""
    ah, bh = _hi(a), _hi(b)
    al, bl = a - ah, b - bh
    t = ah * bh + (ah * bl + (al * bh + al * bl))
    return torch.where(torch.isfinite(a) & torch.isfinite(b), t, a * b)
