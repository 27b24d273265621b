"""Device mesh (counterpart of mxnet_tpu/parallel/mesh.py).

A mesh is a numpy array of ``torch.device`` with named axes, outermost
(the data-parallel axis, which a gradient reduction may cross between
hosts) to innermost (the model axes, on the fastest links), and beside it
the rank of the process that owns each device.

One device per process: the port runs a mesh over several devices as the
ranks of a ``torch.distributed`` process group (``collectives.
initialize_distributed``; NCCL for CUDA tensors, gloo for CPU tensors).
``create_mesh()`` under an initialized group puts one device per rank
(``cuda:<local rank>``, or the CPU without a card) and builds the
group of every axis with ``torch.distributed.device_mesh.init_device_mesh``;
the mesh keeps them (``group(axis)``). A mesh of several devices can also
be built in one process and its specs read (every device is then owned by
rank 0, as every JAX device of one process has ``process_index`` 0), but a
step or a collective on it raises, naming the launcher.

``surviving_devices`` and ``shrink_mesh`` are the mesh arithmetic of a
host failure: they drop the devices whose owner is dead and rebuild the
axes over the rest (``dp`` absorbs the shrink). The mesh they return
describes the survivors; rebuilding the process group itself belongs to
elastic training (M10b in ROADMAP.md).
"""
from __future__ import annotations

import contextlib
import os
import threading

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["PartitionSpec", "NamedSharding", "DeviceMesh", "create_mesh",
           "current_mesh", "default_mesh_axes", "mesh_scope",
           "surviving_devices", "shrink_mesh"]

# canonical axis order, outermost to innermost
default_mesh_axes = ("dp", "fsdp", "pp", "ep", "sp", "tp")

LAUNCHER = ("one process per device: launch the job with "
            "`python tools/launch.py -n N python script.py` or `torchrun "
            "--nproc-per-node N script.py`, which initialize_distributed() "
            "joins")

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

    @property
    def placements(self):
        """The spec as DTensor placements, one per dimension of the mesh's
        process-group mesh (``DeviceMesh.torch_mesh``; over the mesh's
        axes where it spans none): ``Shard(d)`` where dimension d of the
        array is split over that axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        names = self.mesh.torch_mesh.mesh_dim_names \
            if self.mesh.torch_mesh is not None else self.mesh.axis_names
        out = []
        for name in names:
            dims = [d for d, part in enumerate(self.spec)
                    if part == name or (isinstance(part, (tuple, list))
                                        and name in part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


class DeviceMesh:
    """Named axes over a numpy array of ``torch.device``, the rank that
    owns each device (``owners``) and, for a mesh over the ranks of a
    process group, the group of each axis (``torch_mesh``)."""

    def __init__(self, devices, axis_names, owners=None, torch_mesh=None):
        self.devices = devices
        self._axis_names = tuple(axis_names)
        self.owners = _np.zeros(devices.shape, dtype=_np.int64) \
            if owners is None else _np.asarray(owners).reshape(devices.shape)
        self.torch_mesh = torch_mesh

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

    @property
    def distributed(self):
        """Whether the mesh spans the ranks of a process group (its
        collectives run even where an axis has one rank)."""
        return self.torch_mesh is not None

    def sharding(self, *spec):
        """NamedSharding for a PartitionSpec over this mesh."""
        return NamedSharding(self, PartitionSpec(*spec))

    def replicated(self):
        return NamedSharding(self, PartitionSpec())

    def _coords(self):
        """This process's coordinates: those of the one device it owns."""
        if not self.distributed:
            if self.size() != 1:
                raise MXNetError(
                    "a mesh of %d devices in one process cannot run a step "
                    "or a collective: the port runs %s" % (self.size(),
                                                           LAUNCHER))
            return (0,) * len(self._axis_names)
        mine = _np.argwhere(self.owners == _rank())
        if len(mine) != 1:
            raise MXNetError("rank %d owns %d devices of the mesh; the port "
                             "runs one device per process" % (_rank(),
                                                              len(mine)))
        return tuple(int(i) for i in mine[0])

    def local_device(self):
        """The device of this process (raises for a mesh of several
        devices in one process)."""
        return self.devices[self._coords()]

    def axis_index(self, axis):
        """This process's coordinate along ``axis``."""
        return self._coords()[self._axis_names.index(axis)]

    def group(self, axis):
        """The process group of ``axis`` (None where the mesh spans no
        group, or the axis has one device and is not the outermost)."""
        if self.torch_mesh is None:
            return None
        names = self.torch_mesh.mesh_dim_names
        if axis not in names:
            return None
        return self.torch_mesh.get_group(axis)

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


def _group_up():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _rank():
    if not _group_up():
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def local_device():
    """This process's device under a process group: ``cuda:<local rank>``
    (``LOCAL_RANK``, else the rank modulo the cards) where there is a card,
    else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    n = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", _rank()))
    return torch.device("cuda", local % n)


def _world_devices():
    """(devices, owners) of the process group: each rank's local device,
    gathered (a collective: every rank calls it)."""
    import torch.distributed as dist
    world = dist.get_world_size()
    names = [None] * world
    dist.all_gather_object(names, str(local_device()))
    return [torch.device(n) for n in names], list(range(world))


def create_mesh(axes=None, devices=None, **axis_sizes):
    """Create a DeviceMesh.

    create_mesh(dp=2, tp=4)    explicit sizes (their product must divide
                               the device count; the rest goes to 'dp')
    create_mesh()              every device on 'dp'

    ``devices`` defaults to one device per rank of the initialized process
    group (a collective: every rank calls it), else to every CUDA device
    (and raises with none). A list of as many devices as the group has
    ranks is taken as the ranks' devices in rank order; any other list is
    this process's own. Axes not mentioned get size 1, so a PartitionSpec
    naming any canonical axis is always valid.
    """
    spans = False
    if devices is None:
        if _group_up():
            devices, owners = _world_devices()
            spans = True
        else:
            devices = _all_cuda_devices()
            owners = None
    else:
        devices = [torch.device(d) for d in devices]
        owners = None
        if _group_up():
            import torch.distributed as dist
            world = dist.get_world_size()
            spans = world > 1 and len(devices) == world
            owners = list(range(world)) if spans \
                else [dist.get_rank()] * len(devices)
    if axes is None:
        axes = default_mesh_axes
    sizes = _axis_sizes(axes, len(devices), axis_sizes)
    mesh = _build(axes, devices, owners, sizes)
    if spans:
        mesh.torch_mesh = _torch_mesh(mesh, sizes)
    return mesh


def _axis_sizes(axes, n, axis_sizes):
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
    return sizes


def _build(axes, devices, owners, sizes):
    n = len(devices)
    arr = _np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    shape = tuple(sizes[a] for a in axes)
    return DeviceMesh(arr.reshape(shape), axes,
                      None if owners is None
                      else _np.asarray(owners, dtype=_np.int64).reshape(shape))


def _torch_mesh(mesh, sizes):
    """``init_device_mesh`` over the axes of more than one device (and the
    outermost axis always, so that a one-rank group still runs its
    collectives), in rank order."""
    from torch.distributed.device_mesh import init_device_mesh
    axes = mesh.axis_names
    names = tuple(a for i, a in enumerate(axes) if sizes[a] > 1 or i == 0)
    dev = local_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, tuple(sizes[a] for a in names),
                            mesh_dim_names=names)


def current_mesh():
    """Innermost active mesh, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def _owner(d):
    return int(getattr(d, "process_index", 0))


def surviving_devices(dead_processes, devices=None):
    """Devices not owned by a dead process: the raw material of a mesh
    after a host failure. ``dead_processes`` are ranks; a device's owner
    is its ``process_index`` (0 for a ``torch.device``). ``devices``
    defaults to the process group's devices (every CUDA device without
    one), each owned by its rank."""
    dead = set(int(p) for p in dead_processes)
    if devices is None:
        if _group_up():
            devs, owners = _world_devices()
            return [d for d, o in zip(devs, owners) if o not in dead]
        devices = _all_cuda_devices()
    return [d for d in devices if _owner(d) not in dead]


def shrink_mesh(mesh, dead_processes=(), devices=None):
    """The mesh rebuilt over the survivors of a host failure: every device
    owned by a dead process (by the mesh's owners) is dropped, the axes
    other than ``dp`` keep their sizes and ``dp`` absorbs the shrink.
    Raises ``ValueError`` where the survivors cannot carry the model axes,
    or there are none. The result describes the survivors; it spans no
    process group (M10b rebuilds the group)."""
    if devices is None:
        dead = set(int(p) for p in dead_processes)
        keep = [(d, int(o)) for d, o in zip(mesh.devices.ravel(),
                                            mesh.owners.ravel())
                if int(o) not in dead]
        devices = [d for d, _ in keep]
        owners = [o for _, o in keep]
    else:
        devices = list(devices)
        owners = [_owner(d) for d in devices]
    if not devices:
        raise ValueError("no surviving devices to rebuild the mesh on")
    sizes = {a: int(s) for a, s in mesh.shape.items()
             if a != "dp" and int(s) > 1}
    axes = tuple(mesh.axis_names)
    return _build(axes, devices, owners,
                  _axis_sizes(axes, len(devices), sizes))


@contextlib.contextmanager
def mesh_scope(mesh):
    with mesh:
        yield mesh
