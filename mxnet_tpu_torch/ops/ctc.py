"""CTC loss (counterpart of mxnet_tpu/ops/ctc.py): ``ctc_loss``, with the
aliases ``CTCLoss`` and ``contrib_ctc_loss``.

The JAX package runs the alpha recursion in log space under ``lax.scan``.
No TPU kernel computes it, so here it is PyTorch's ``ctc_loss``, on CPU and
CUDA tensors alike, called so that it gives the JAX op's numbers:

- the blank is index 0, and a label is valid where it is >= 0 (padding
  is negative), as in the JAX op; ``label_lengths`` overrides that count;
- the log-softmax over classes is taken here, in float32, and the library
  call gets the normalised log-probabilities; its gradient through that
  log-softmax is the JAX op's;
- ``reduction="none"`` (one value per sequence, the caller weights it)
  and ``zero_infinity=False``: an alignment that cannot exist (a label
  sequence longer than its input allows) gives inf here, where the JAX
  op's finite stand-in for minus infinity gives about 1e30.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


@register("ctc_loss", aliases=("CTCLoss", "contrib_ctc_loss"))
def ctc_loss(pred, label, pred_lengths=None, label_lengths=None,
             layout="NTC", label_layout="NT"):
    if layout == "TNC":
        pred = pred.transpose(0, 1)
    if label_layout == "TN":
        label = label.transpose(0, 1)
    N, T, _ = pred.shape
    logp = torch.log_softmax(pred.float(), dim=-1)
    lab = label.to(torch.int32)
    valid = lab >= 0
    lab_len = valid.sum(dim=1, dtype=torch.int64) if label_lengths is None \
        else label_lengths.to(torch.int64)
    pred_len = torch.full((N,), T, dtype=torch.int64, device=pred.device) \
        if pred_lengths is None else pred_lengths.to(torch.int64)
    targets = torch.where(valid, lab, torch.zeros_like(lab)).to(torch.int64)
    loss = F.ctc_loss(logp.transpose(0, 1), targets, pred_len, lab_len,
                      blank=0, reduction="none", zero_infinity=False)
    return loss.to(pred.dtype)
