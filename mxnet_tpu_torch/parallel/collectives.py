"""Collectives over the ranks of a process group (counterpart of
mxnet_tpu/parallel/collectives.py), and ``shard_map``.

The JAX package lowers each collective to one XLA collective over a named
mesh axis. The port runs one device per process, so a mesh axis is a
``torch.distributed`` process group (``DeviceMesh.group``: NCCL for CUDA
tensors, gloo for CPU tensors) and each function here is one collective
on it:

    all_reduce(x, "dp", op)        sum, mean (the sum over n ranks, / n),
                                   max, min
    all_gather(x, "dp", axis)      every rank's block, concatenated along
                                   ``axis`` (stacked on a new one with
                                   ``tiled=False``), in rank order
    reduce_scatter(x, "dp", axis)  the sum, cut along ``axis``: rank i
                                   keeps block i
    all_to_all(x, "sp", s, c)      block j of ``x`` along ``s`` goes to
                                   rank j, the received blocks are
                                   concatenated along ``c`` in rank order
    ppermute(x, "sp", perm)        ``(source, destination)`` pairs of axis
                                   indices; a rank no pair sends to gets
                                   zeros
    ring_exchange(x, "sp", shift)  ``ppermute`` by ``shift`` around the ring

An axis name is resolved against the mesh of the enclosing ``shard_map``,
else the innermost ``with mesh:``. An axis of one device needs no group
and the collective is the identity, as a JAX collective over an axis of
size 1 is; a mesh that spans a process group runs its collectives even
where the group has one rank. A mesh of several devices in one process
raises, naming the launcher. A backend that does not take a collective
for a tensor's device or dtype raises ``MXNetError`` naming the backend,
the collective, the dtype and the device; nothing is copied through the
host on the caller's behalf.

``shard_map(fn, mesh, in_specs, out_specs)`` runs ``fn`` on this rank's
block of each input, as its PartitionSpec cuts it, with the collectives
above taking the mesh's axis names inside; each output is assembled by
its spec (``all_gather`` along a split dimension, taken as it is where
replicated).

The host-level helpers (``num_hosts``, ``host_rank``, ``host_allreduce``,
``host_barrier``) read the default process group and degrade to the
identity in a single process; ``initialize_distributed`` joins the job
that ``tools/launch.py`` (``MXTPU_COORDINATOR``, ``MXTPU_NUM_PROCS``,
``MXTPU_PROC_ID``) or ``torchrun`` (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``) describes. The fault point
``collective.allreduce`` fires in ``all_reduce`` and ``host_allreduce``.
"""
from __future__ import annotations

import contextlib
import datetime
import threading

import numpy as _np
import torch

from ..base import MXNetError, getenv
from .mesh import LAUNCHER, PartitionSpec, current_mesh, local_device

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "ppermute", "ring_exchange", "host_allreduce", "host_barrier",
           "num_hosts", "host_rank", "initialize_distributed", "shard_map"]

_manual = threading.local()


def _dist():
    import torch.distributed as dist
    return dist


def _up():
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _fault():
    from .._debug import faultpoint as _faultpoint
    if _faultpoint.ACTIVE:
        _faultpoint.check("collective.allreduce")


def _mesh_of(axis_name):
    stack = getattr(_manual, "stack", None)
    mesh = stack[-1] if stack else current_mesh()
    if mesh is None:
        raise ValueError(
            "collective over axis %r outside shard_map and with no mesh "
            "active (`with mesh:`)" % (axis_name,))
    return mesh


def _axis(axis_name):
    """(group, n) of a mesh axis: group None means the collective is the
    identity (an axis of one device, off any process group)."""
    names = axis_name if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)
    mesh = _mesh_of(axis_name)
    for a in names:
        if a not in mesh.axis_names:
            raise ValueError("unknown mesh axis %r (axes %s)"
                             % (a, list(mesh.axis_names)))
    wide = [a for a in names if mesh.size(a) > 1]
    if len(wide) > 1:
        raise NotImplementedError(
            "a collective over several mesh axes of more than one device "
            "(%s) belongs to the LM's parallel modes (M10c)" % (wide,))
    name = wide[0] if wide else names[0]
    n = mesh.size(name)
    group = mesh.group(name) if mesh.distributed else None
    if group is None and n > 1:
        raise MXNetError("collective over axis %r of %d devices in one "
                         "process: the port runs %s" % (name, n, LAUNCHER))
    return group, n


def _call(what, x, group, fn):
    """Run one torch.distributed call; a failure raises naming the
    backend, the collective, the dtype and the device."""
    try:
        return fn()
    except RuntimeError as e:
        backend = _dist().get_backend(group) if _up() \
            else "none"
        raise MXNetError(
            "%s: the %s backend failed on a %s tensor on %s: %s"
            % (what, backend, str(x.dtype).replace("torch.", ""), x.device,
               e)) from e


def _all_reduce_(t, group, op="sum", what="all_reduce"):
    """In place over ``group`` (sum, max, min); returns ``t``."""
    dist = _dist()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    _call(what, t, group, lambda: dist.all_reduce(t, op=red, group=group))
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group, differentiable: the gradient of every rank's
    copy of the sum reaches each summand, so the backward is the sum of
    the incoming gradients over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce(x, axis_name, op="sum"):
    """psum/pmean/pmax/pmin over a mesh axis. ``mean`` is the sum over the
    axis divided by its size (JAX's ``pmean``). Sum and mean are
    differentiable."""
    _fault()
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError("unknown reduce op %r" % op)
    group, n = _axis(axis_name)
    if group is None:
        return x
    if op in ("sum", "mean"):
        x = x.contiguous()
        out = _AllReduceSum.apply(x, group) if x.requires_grad \
            and torch.is_grad_enabled() else _all_reduce_(x.clone(), group)
        return out / n if op == "mean" else out
    return _all_reduce_(x.contiguous().clone(), group, op)


def _gather(x, group, n):
    """The n blocks of every rank, stacked on a new leading dimension."""
    dist = _dist()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    _call("all_gather", x, group,
          lambda: dist.all_gather(parts, x, group=group))
    return torch.stack(parts)


def all_gather(x, axis_name, axis=0, tiled=True):
    """Every rank's block along ``axis``, in rank order: concatenated
    (``tiled``) or stacked on a new dimension ``axis``."""
    group, n = _axis(axis_name)
    if group is None:
        return x if tiled else x.unsqueeze(axis)
    parts = _gather(x, group, n).unbind(0)
    return torch.cat(parts, dim=axis) if tiled \
        else torch.stack(parts, dim=axis)


def reduce_scatter(x, axis_name, axis=0):
    """The sum over the axis, cut into its size's blocks along ``axis``:
    rank i keeps block i (JAX's tiled ``psum_scatter``)."""
    group, n = _axis(axis_name)
    if group is None:
        return x
    dist = _dist()
    if x.shape[axis] % n:
        raise ValueError("reduce_scatter: dimension %d of size %d does not "
                         "divide into %d blocks" % (axis, x.shape[axis], n))
    xm = x.movedim(axis, 0).contiguous()
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _call("reduce_scatter", xm, group,
          lambda: dist.reduce_scatter_tensor(out, xm, group=group))
    return out.movedim(0, axis)


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True):
    """Block j of ``x`` along ``split_axis`` goes to rank j; the blocks a
    rank receives are concatenated along ``concat_axis`` in rank order
    (``tiled``). Untiled, ``split_axis`` has the axis's size: its entries
    are sent one per rank and the received ones stacked into it."""
    group, n = _axis(axis_name)
    if not tiled:
        if x.shape[split_axis] != n:
            raise ValueError("all_to_all(tiled=False): split axis of size "
                             "%d on an axis of %d devices"
                             % (x.shape[split_axis], n))
        y = all_to_all(x, axis_name, split_axis, split_axis, tiled=True)
        return y.movedim(split_axis, concat_axis)
    if group is None:
        return x
    dist = _dist()
    if x.shape[split_axis] % n:
        raise ValueError("all_to_all: split dimension of size %d does not "
                         "divide into %d blocks" % (x.shape[split_axis], n))
    xm = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(xm)
    _call("all_to_all", xm, group,
          lambda: dist.all_to_all_single(out, xm, group=group))
    blocks = out.movedim(0, split_axis).chunk(n, dim=split_axis)
    return torch.cat(blocks, dim=concat_axis)


def ppermute(x, axis_name, perm):
    """Point-to-point shifts along a mesh axis: for each ``(i, j)`` of
    ``perm`` axis index i sends its ``x`` to j; a rank that receives
    nothing returns zeros."""
    group, n = _axis(axis_name)
    perm = [(int(i), int(j)) for i, j in perm]
    if any(not (0 <= i < n and 0 <= j < n) for i, j in perm):
        raise ValueError("ppermute: %s names an index outside an axis of "
                         "%d devices" % (perm, n))
    if group is None:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    dist = _dist()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        # gloo's send and recv take a CUDA tensor's device address as a
        # host one and fail inside the transport, ending the process
        # (chip_smoke.py phase train_dist probes it)
        raise MXNetError(
            "ppermute: the gloo backend does not send or receive CUDA "
            "tensors (a %s tensor on %s); use NCCL"
            % (str(x.dtype).replace("torch.", ""), x.device))
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for i, j in perm:
        if i == me and j == me:
            out.copy_(x)
        elif i == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, j), group))
        elif j == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, i), group))
    if ops:
        works = _call("ppermute", x, group,
                      lambda: dist.batch_isend_irecv(ops))
        for w in works:
            _call("ppermute", x, group, w.wait)
    return out


def ring_exchange(x, axis_name, shift=1):
    """Shift blocks around the axis's ring by ``shift``."""
    _, n = _axis(axis_name)
    return ppermute(x, axis_name, [(i, (i + shift) % n) for i in range(n)])


# -- shard_map ----------------------------------------------------------------

@contextlib.contextmanager
def manual_axes(mesh):
    """Collectives inside the block resolve axis names against ``mesh``
    (what ``shard_map`` sets around its function)."""
    if not hasattr(_manual, "stack"):
        _manual.stack = []
    _manual.stack.append(mesh)
    try:
        yield mesh
    finally:
        _manual.stack.pop()


def _parts(part):
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def _block(mesh, spec, x):
    """This rank's block of ``x`` under ``spec``."""
    if not isinstance(x, torch.Tensor):
        return x
    for d, part in enumerate(tuple(spec)[:x.dim()]):
        names = _parts(part)
        if not names:
            continue
        n, idx = 1, 0
        for a in names:
            idx = idx * mesh.size(a) + mesh.axis_index(a)
            n *= mesh.size(a)
        if x.shape[d] % n:
            raise ValueError("shard_map: dimension %d of size %d does not "
                             "divide over %s (%d devices)"
                             % (d, x.shape[d], names, n))
        step = x.shape[d] // n
        x = x.narrow(d, idx * step, step)
    return x


def _assemble(mesh, spec, x):
    """A full output from this rank's block under ``spec``."""
    if not isinstance(x, torch.Tensor):
        return x
    for d, part in enumerate(tuple(spec)[:x.dim()]):
        for a in reversed(_parts(part)):
            x = all_gather(x, a, axis=d)
    return x


def _map_spec(spec, tree, fn):
    """``fn(spec, leaf)`` over ``tree``, ``spec`` a PartitionSpec (applied
    to a whole subtree) or a tree of them over a prefix of ``tree``."""
    if isinstance(spec, PartitionSpec) or spec is None:
        spec = PartitionSpec() if spec is None else spec
        if isinstance(tree, dict):
            return {k: _map_spec(spec, v, fn) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_map_spec(spec, v, fn) for v in tree)
        return fn(spec, tree)
    if isinstance(spec, dict):
        return {k: _map_spec(spec[k], v, fn) for k, v in tree.items()}
    return type(tree)(_map_spec(s, v, fn) for s, v in zip(spec, tree))


def shard_map(fn, mesh, in_specs, out_specs, check_vma=True):
    """``fn`` mapped over this rank's blocks of the inputs (see the module
    docstring). ``in_specs`` and ``out_specs`` are PartitionSpecs or trees
    of them over a prefix of the arguments' tuple and of the outputs.
    ``check_vma`` has no counterpart here (nothing is traced)."""
    del check_vma

    def mapped(*args):
        specs = in_specs if not isinstance(in_specs, PartitionSpec) \
            else (in_specs,) * len(args)
        local = _map_spec(tuple(specs), tuple(args),
                          lambda s, x: _block(mesh, s, x))
        with manual_axes(mesh):
            out = fn(*local)
            return _map_spec(out_specs, out,
                             lambda s, x: _assemble(mesh, s, x))
    return mapped


# -- host-level (multi-process) coordination ----------------------------------

def num_hosts():
    """Ranks of the default process group (1 without one)."""
    return _dist().get_world_size() if _up() else 1


def host_rank():
    """This process's rank (0 without a group)."""
    return _dist().get_rank() if _up() else 0


def host_allreduce(arrays):
    """The sum over every process of each value (tensors, summed on their
    device; numpy arrays, returned as numpy); the values themselves in a
    single process. One value or a list."""
    _fault()
    if num_hosts() == 1:
        return arrays
    single = not isinstance(arrays, (list, tuple))
    seq = [arrays] if single else list(arrays)
    out = []
    for a in seq:
        if isinstance(a, torch.Tensor):
            out.append(_all_reduce_(a.detach().contiguous().clone(), None,
                                    what="host_allreduce"))
            continue
        host = _np.asarray(a)
        dev = local_device() if _dist().get_backend() == "nccl" \
            else torch.device("cpu")
        t = torch.from_numpy(_np.ascontiguousarray(host)).to(dev)
        out.append(_all_reduce_(t, None, what="host_allreduce")
                   .cpu().numpy())
    return out[0] if single else out


def host_barrier(name="mxnet_tpu_barrier"):
    """Every process waits for the others (ref: ps::Postoffice::Barrier);
    nothing in a single process."""
    del name
    if num_hosts() == 1:
        return
    dist = _dist()
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[local_device().index])
    else:
        dist.barrier()


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None, timeout=None):
    """Join the job's default process group; returns whether there is
    one. The address, world size and rank come from the arguments, else
    ``MXTPU_COORDINATOR`` (``host:port``, or any ``torch.distributed``
    init URL such as ``file://...``), ``MXTPU_NUM_PROCS`` and
    ``MXTPU_PROC_ID`` (``tools/launch.py``), else torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. The
    backend is ``backend``, else NCCL where there is a card and gloo where
    there is none; ``timeout`` (seconds) bounds every collective. A
    process with a card is bound to ``cuda:<local rank>``."""
    dist = _dist()
    if _up():
        return True
    addr = coordinator_address or getenv("MXTPU_COORDINATOR")
    if addr is not None:
        init = addr if "://" in addr else "tcp://" + addr
        world = int(num_processes if num_processes is not None
                    else getenv("MXTPU_NUM_PROCS", 1))
        rank = int(process_id if process_id is not None
                   else getenv("MXTPU_PROC_ID", 0))
    elif getenv("MASTER_ADDR") and getenv("WORLD_SIZE"):
        init = "env://"
        world = int(getenv("WORLD_SIZE"))
        rank = int(getenv("RANK", 0))
    else:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        local = int(getenv("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=float(timeout))}
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)
    return True
