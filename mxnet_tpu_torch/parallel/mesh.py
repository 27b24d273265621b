"""Device mesh (counterpart of mxnet_tpu/parallel/mesh.py).

A mesh is a numpy array of ``torch.device`` with named axes, outermost
(the data-parallel axis, which a gradient reduction may cross between
hosts) to innermost (the model axes, on the fastest links). The partition
specs of ``sharding.py`` are bookkeeping over the axis sizes, so a mesh of
any shape can be built and its specs read; the port trains on one device
so far (``parallel.train.ShardedTrainStep``), and meshes over several
devices, with ``surviving_devices`` and ``shrink_mesh``, come with the
multi-process slice (M10 in ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["PartitionSpec", "NamedSharding", "DeviceMesh", "create_mesh",
           "current_mesh", "default_mesh_axes", "mesh_scope",
           "surviving_devices", "shrink_mesh"]

# canonical axis order, outermost to innermost
default_mesh_axes = ("dp", "fsdp", "pp", "ep", "sp", "tp")

_MULTI = ("the multi-process slice (M10): meshes over several devices, "
          "their collectives and resharding")

_state = threading.local()


class PartitionSpec(tuple):
    """How an array's dimensions map onto mesh axes: one entry per
    dimension, an axis name, a tuple of axis names, or None (not split);
    missing trailing entries are None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self) if len(self) != 1
                                    else "(%r)" % (self[0],))


class NamedSharding:
    """A PartitionSpec over a DeviceMesh."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


class DeviceMesh:
    """Named axes over a numpy array of ``torch.device``."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self._axis_names = tuple(axis_names)

    @property
    def axis_names(self):
        return self._axis_names

    @property
    def shape(self):
        return dict(zip(self._axis_names, self.devices.shape))

    def size(self, axis=None):
        if axis is None:
            return int(self.devices.size)
        return int(self.shape[axis])

    def sharding(self, *spec):
        """NamedSharding for a PartitionSpec over this mesh."""
        return NamedSharding(self, PartitionSpec(*spec))

    def replicated(self):
        return NamedSharding(self, PartitionSpec())

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False

    def __repr__(self):
        return "DeviceMesh(%s)" % (self.shape,)


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def _all_cuda_devices():
    if not torch.cuda.is_available():
        raise MXNetError(
            "create_mesh: no CUDA device is available. The port runs on the "
            "card by default; pass devices=[torch.device('cpu')] to build a "
            "mesh on the CPU.")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(axes=None, devices=None, **axis_sizes):
    """Create a DeviceMesh.

    create_mesh(dp=2, tp=4)    explicit sizes (their product must divide
                               the device count; the rest goes to 'dp')
    create_mesh()              every device on 'dp'

    ``devices`` defaults to every CUDA device (and raises with none). Axes
    not mentioned get size 1, so a PartitionSpec naming any canonical axis
    is always valid.
    """
    if devices is None:
        devices = _all_cuda_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if axes is None:
        axes = default_mesh_axes
    unknown = set(axis_sizes) - set(axes)
    if unknown:
        raise ValueError("unknown mesh axes %s; valid axes: %s"
                         % (sorted(unknown), list(axes)))
    sizes = {a: int(axis_sizes.get(a, 1)) for a in axes}
    explicit = int(_np.prod([s for s in sizes.values()]))
    if n % explicit != 0:
        raise ValueError("mesh axes %s (product %d) do not divide %d devices"
                         % (sizes, explicit, n))
    if "dp" in sizes and "dp" not in axis_sizes:
        sizes["dp"] = n // explicit
    elif explicit != n:
        raise ValueError("mesh axes %s use %d of %d devices"
                         % (sizes, explicit, n))
    arr = _np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return DeviceMesh(arr.reshape(tuple(sizes[a] for a in axes)), axes)


def current_mesh():
    """Innermost active mesh, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def surviving_devices(dead_processes, devices=None):
    """Devices not owned by a dead process: waits for the multi-process
    slice (M10)."""
    raise NotImplementedError("surviving_devices: " + _MULTI)


def shrink_mesh(mesh, dead_processes=(), devices=None):
    """A mesh rebuilt over the survivors of a host failure: waits for
    the multi-process slice (M10)."""
    raise NotImplementedError("shrink_mesh: " + _MULTI)


@contextlib.contextmanager
def mesh_scope(mesh):
    with mesh:
        yield mesh
