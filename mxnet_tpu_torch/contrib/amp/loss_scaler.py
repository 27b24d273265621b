"""Dynamic loss scaling (counterpart of
mxnet_tpu/contrib/amp/loss_scaler.py; ref:
python/mxnet/contrib/amp/loss_scaler.py).

bfloat16, the default target, shares float32's exponent range, so an
overflow is rare there; the scaler still guards the step against inf and
NaN gradients, and float16 needs it. The JAX package also reports each
update to its health monitor (``_debug.healthmon.note_amp``); that monitor
is not ported yet."""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    """Scale up by ``scale_factor`` after ``scale_window`` clean steps,
    divide by it (down to 1) on an overflow."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.05):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self._min_scale = 1.0

    def has_overflow(self, params):
        """Whether any gradient of ``params`` (Parameters; those with
        ``grad_req="null"`` skipped) holds an inf or a NaN: one reduction
        per gradient on the device, stacked, and one host sync for the
        whole set (not one per parameter)."""
        checks = [torch.isfinite(p._grad_tensor()).all() for p in params
                  if p.grad_req != "null"]
        if not checks:
            return False
        return not bool(torch.stack(checks).all())

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self._min_scale,
                                  self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped == self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0
