"""TensorInspector: interactive and value-check debugging for tensors
(counterpart of mxnet_tpu/tensor_inspector.py; ref:
src/common/tensor_inspector.h -- print_string, NaN/inf checks, value
dumping with visit-count tagging).

The checks work on any NDArray, tensor (on the card or the CPU) or numpy
array. Two device-friendly paths:

- :meth:`TensorInspector.snapshot` inspects MANY tensors with one batched
  host transfer per device (the values cast to float32 on the device,
  exact for bf16 and f16, concatenated, copied once).
- :meth:`TensorInspector.print_in_trace` /
  :meth:`TensorInspector.check_in_trace` print shape/dtype plus
  nonfinite/abs-max/L2 (or the nonfinite count) and return the operand
  unchanged, so they drop into any expression. In the JAX package they
  print from inside a jitted trace when it runs; PyTorch runs eagerly, so
  here they print on the tensors as they are computed, at the call (one
  host read of three scalars each). A tag is printed as written, braces
  included.

A bf16 tensor arrives on the host as float32 values (numpy has no
bfloat16); its header keeps the tensor's dtype name.
"""
from __future__ import annotations

import logging

import numpy as _np

__all__ = ["TensorInspector", "host_arrays"]


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def host_arrays(values):
    """numpy copies of ``values`` (NDArrays unwrapped, tensors detached),
    each in its own shape, with one transfer per device and dtype group
    (bf16 and f16 values travel as float32, exact; numpy values pass
    through), and their dtype names."""
    import torch
    from .ndarray.ndarray import NDArray
    datas = [v._data if isinstance(v, NDArray) else v for v in values]
    out = [None] * len(datas)
    names = [None] * len(datas)
    groups = {}
    for i, d in enumerate(datas):
        if isinstance(d, torch.Tensor):
            d = d.detach()
            names[i] = _dtype_name(d)
            low = d.dtype in (torch.bfloat16, torch.float16)
            dt = torch.float32 if low else d.dtype
            groups.setdefault((d.device, dt), []).append(i)
        else:
            out[i] = _np.asarray(d)
            names[i] = str(out[i].dtype)
    for (_dev, dt), idx in groups.items():
        flat = torch.cat([datas[i].detach().reshape(-1).to(dt)
                          for i in idx]).cpu().numpy()
        off = 0
        for i in idx:
            n = datas[i].numel()
            out[i] = flat[off:off + n].reshape(tuple(datas[i].shape))
            off += n
    return out, names


class TensorInspector:
    """ref: tensor_inspector.h TensorInspector(tb, ctx)."""

    _visit_count = {}

    def __init__(self, tensor, tag="", _dtype=None):
        if _dtype is None:
            (self._a,), (_dtype,) = host_arrays([tensor])
        else:
            self._a = _np.asarray(tensor)
        self._dtype = _dtype
        self.tag = tag

    @classmethod
    def snapshot(cls, tensors, tags=None):
        """Build inspectors for many tensors with one batched host transfer
        per device. ``tensors``: an iterable of NDArray/tensor/numpy
        values, or a ``{name: tensor}`` dict (names become the tags).
        ``tags`` optionally labels list input. Returns a list (or dict,
        matching the input) of :class:`TensorInspector`."""
        if isinstance(tensors, dict):
            names = list(tensors)
            vals = [tensors[k] for k in names]
        else:
            names = list(tags) if tags is not None else None
            vals = list(tensors)
        hosts, dtypes = host_arrays(vals)
        out = [cls(h, tag=(names[i] if names is not None else ""),
                   _dtype=dtypes[i])
               for i, h in enumerate(hosts)]
        if isinstance(tensors, dict):
            return dict(zip(names, out))
        return out

    def print_string(self):
        """Formatted dump with shape/dtype header (ref: print_string())."""
        return "<%s %s %s>\n%s" % (self.tag or "Tensor",
                                   "x".join(map(str, self._a.shape)),
                                   self._dtype,
                                   _np.array2string(self._a, threshold=64))

    def check_value(self, checker=None):
        """Return coordinates of values failing the check; default checker
        flags NaN/Inf (ref: check_value w/ CheckerType::NegativeChecker
        etc. -- pass any predicate)."""
        if checker is None:
            def checker(x):
                return ~_np.isfinite(x)
        mask = checker(self._a)
        coords = [tuple(int(i) for i in idx)
                  for idx in _np.argwhere(mask)]
        if coords:
            logging.warning("TensorInspector%s: %d values failed the check "
                            "(first at %s)",
                            " [%s]" % self.tag if self.tag else "",
                            len(coords), coords[0])
        return coords

    def has_nan_or_inf(self):
        return not bool(_np.isfinite(self._a).all())

    def dump_to_file(self, tag, visit=True):
        """Save to '<tag>_<visit>.npy' with a visit counter so repeated
        passes don't overwrite (ref: dump_to_file visit-count naming)."""
        count = TensorInspector._visit_count.get(tag, 0) + 1
        if visit:
            TensorInspector._visit_count[tag] = count
        fname = "%s_%d.npy" % (tag, count)
        _np.save(fname, self._a)
        return fname

    # -- inline variants (the JAX package's in-trace probes) -----------------

    @staticmethod
    def print_in_trace(x, tag=""):
        """Print ``TensorInspector[tag] <shape dtype> nonfinite=.. absmax=..
        l2=..`` (``min=.. max=..`` for an integer tensor) and return ``x``
        unchanged::

            y = TensorInspector.print_in_trace(y, tag="logits")
        """
        import torch
        hdr = "TensorInspector[%s] <%s %s>" % (
            tag or "Tensor", "x".join(map(str, x.shape)), _dtype_name(x))
        t = x.detach()
        if t.is_floating_point() or t.is_complex():
            a = t.abs().float()
            vals = torch.stack([
                (~torch.isfinite(t)).sum().float(),
                a.max() if t.numel() else a.new_zeros(()),
                (a * a).sum().sqrt()]).cpu().numpy()
            print("%s nonfinite=%d absmax=%s l2=%s" % (
                hdr, int(vals[0]), vals[1], vals[2]), flush=True)
        else:
            lo = t.min().item() if t.numel() else 0
            hi = t.max().item() if t.numel() else 0
            print("%s min=%s max=%s" % (hdr, lo, hi), flush=True)
        return x

    @staticmethod
    def check_in_trace(x, tag=""):
        """Print ``TensorInspector[tag] check: nonfinite=N`` (0 on a clean
        tensor) and return ``x`` unchanged: the inline sibling of
        :meth:`check_value`."""
        import torch
        t = x.detach()
        bad = int((~torch.isfinite(t)).sum()) \
            if t.is_floating_point() or t.is_complex() else 0
        print("TensorInspector[%s] check: nonfinite=%d"
              % (tag or "Tensor", bad), flush=True)
        return x
