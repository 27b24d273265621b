"""The port's collectives, ``shard_map`` and gradient buckets
(mxnet_tpu_torch/parallel/collectives.py, overlap.py, mesh.py,
sharding.py) held against the JAX package's on two ranks.

The port runs one device per process, so a two-device mesh is two gloo
processes on the CPU: the module fixture starts one cluster of two ranks
(this file run as a script with ``--worker``; a FileStore under
``tmp_path``, a 60 s process-group timeout and a 120 s subprocess
timeout). Every rank runs every check of ``CHECKS`` and writes its arrays
to ``tmp_path``; each test asserts one result. The JAX goldens run here,
on ``jax.devices()[:2]`` of the 8-device virtual mesh under its own
``shard_map``. A sum of two f32 values is exact, so every collective is
compared bit for bit, and so are the bucketed reduce and the tagged
backward against the per-leaf reduce.

The single-process cases need no cluster: the identity behaviour of the
collectives and host helpers, the mesh arithmetic of ``surviving_devices``
and ``shrink_mesh`` against JAX's, ``named_shardings``, and a mesh of
several devices in one process raising, naming the launcher.

``cluster_fixture``, ``worker_main`` and ``result`` are shared with
test_torch_dist_train.py and test_torch_dist_kvstore.py. A worker
imports neither JAX nor the JAX package.
"""
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
PG_TIMEOUT_S = 60
PROC_TIMEOUT_S = 120


# -- the cluster ----------------------------------------------------------------

def start_cluster(script, tmp, world=WORLD):
    """Start ``script --worker rank world tmp`` as ``world`` processes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(world):
        log = os.path.join(tmp, "stderr.%d" % rank)
        with open(log, "w") as err:
            procs.append((subprocess.Popen(
                [sys.executable, script, "--worker", str(rank), str(world),
                 str(tmp)], env=env, stdout=err, stderr=subprocess.STDOUT),
                log))
    return procs


def finish_cluster(procs, t0):
    """Wait for the processes (all killed once PROC_TIMEOUT_S have passed
    since ``t0``); returns their (returncode, output)."""
    out = []
    for p, log in procs:
        try:
            p.wait(timeout=max(1.0, PROC_TIMEOUT_S - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            p.wait()
        with open(log) as f:
            out.append((p.returncode, f.read()))
    return out


def worker_main(checks):
    """A worker's body: join the cluster, run every check and write its
    arrays (or its traceback), leave the cluster."""
    rank, world, tmp = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch
    torch.set_num_threads(1)
    from mxnet_tpu_torch.parallel import initialize_distributed
    initialize_distributed(
        "file://" + os.path.join(tmp, "store"), world, rank,
        backend="gloo", timeout=PG_TIMEOUT_S)
    for name, fn in checks:
        try:
            arrays = fn(rank, world)
            np.savez(os.path.join(tmp, "%s.%d.npz" % (name, rank)),
                     **arrays)
        except Exception:     # the check's result: its traceback
            with open(os.path.join(tmp, "%s.%d.err" % (name, rank)),
                      "w") as f:
                f.write(traceback.format_exc())
    import torch.distributed as dist
    dist.destroy_process_group()


def cluster_fixture(script, tmp_path_factory, meanwhile=dict):
    """Run the cluster of ``script`` while ``meanwhile()`` (the JAX
    goldens) runs here; returns (the cluster's folder, its value)."""
    tmp = str(tmp_path_factory.mktemp("cluster"))
    t0 = time.time()
    procs = start_cluster(script, tmp)
    try:
        value = meanwhile()
    finally:
        ends = finish_cluster(procs, t0)
    for rc, log in ends:
        assert rc == 0, log[-4000:]
    return tmp, value


def result(tmp, name, rank):
    """The arrays ``name`` wrote on ``rank`` (a failure shows its
    traceback)."""
    path = os.path.join(tmp, "%s.%d" % (name, rank))
    if os.path.exists(path + ".err"):
        with open(path + ".err") as f:
            pytest.fail("rank %d, check %s:\n%s" % (rank, name, f.read()))
    with np.load(path + ".npz") as z:
        return {k: z[k] for k in z.files}


def assert_ranks_equal(tmp, name):
    """Every array of a check the same bits on every rank."""
    a, b = result(tmp, name, 0), result(tmp, name, 1)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the checks (run on each rank) ----------------------------------------------

def global_x(seed=0, shape=(4, 6)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (name, body over the local block a, in spec, out spec); the same bodies
# run under JAX's shard_map with lax collectives (``_jax_ops``)
OPS = ["psum", "pmean", "pmax", "pmin", "all_gather", "all_gather_untiled",
       "reduce_scatter", "all_to_all", "all_to_all_untiled", "ppermute",
       "ppermute_one", "ring_exchange"]


def _port_ops():
    from mxnet_tpu_torch import parallel as P
    return {
        "psum": lambda a: P.all_reduce(a, "dp", "sum"),
        "pmean": lambda a: P.all_reduce(a, "dp", "mean"),
        "pmax": lambda a: P.all_reduce(a, "dp", "max"),
        "pmin": lambda a: P.all_reduce(a, "dp", "min"),
        "all_gather": lambda a: P.all_gather(a, "dp", axis=1),
        "all_gather_untiled": lambda a: P.all_gather(a, "dp", axis=1,
                                                     tiled=False),
        "reduce_scatter": lambda a: P.reduce_scatter(a, "dp", axis=1),
        "all_to_all": lambda a: P.all_to_all(a, "dp", 1, 0),
        "all_to_all_untiled": lambda a: P.all_to_all(a, "dp", 0, 1,
                                                     tiled=False),
        "ppermute": lambda a: P.ppermute(a, "dp", [(0, 1), (1, 0)]),
        "ppermute_one": lambda a: P.ppermute(a, "dp", [(0, 1)]),
        "ring_exchange": lambda a: P.ring_exchange(a, "dp", 1),
    }


def check_collectives(rank, world):
    import torch
    from mxnet_tpu_torch import parallel as P
    mesh = P.create_mesh()
    spec = P.PartitionSpec("dp")
    x = torch.from_numpy(global_x())
    out = {}
    for name, fn in _port_ops().items():
        out[name] = P.shard_map(fn, mesh, in_specs=spec,
                                out_specs=spec)(x).numpy()
    out["axis_index"] = np.array(mesh.axis_index("dp"))
    out["owners"] = mesh.owners.ravel()
    out["devices"] = np.array([str(d) for d in mesh.devices.ravel()])
    return out


SHAPES = [(8, 4), (32,), (4, 4, 2), (128,), (3,)]


def _leaves(seed, shapes=SHAPES):
    import torch
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*s).astype(np.float32))
            for s in shapes]


def check_buckets(rank, world):
    """bucketed_reduce and the tagged backward against the per-leaf
    reduce, on rank-dependent leaves."""
    import torch
    from mxnet_tpu_torch import parallel as P
    from mxnet_tpu_torch.parallel import overlap
    mesh = P.create_mesh()
    leaves = _leaves(10 + rank)
    ws = _leaves(20 + rank)
    xs = _leaves(30)
    with P.mesh_scope(mesh):
        plain = [P.all_reduce(t, "dp") for t in leaves]
        bucketed = P.bucketed_reduce(leaves, "dp", bucket_bytes=256)
        mean_b = P.bucketed_reduce(leaves, "dp", bucket_bytes=256,
                                   op="mean")
        wr = [w.clone().requires_grad_() for w in ws]
        loss = sum(torch.sum(w * x) ** 2 for w, x in zip(wr, xs))
        ref = [P.all_reduce(g, "dp")
               for g in torch.autograd.grad(loss, wr)]
        wt = [w.clone().requires_grad_() for w in ws]
        tagged = P.tag_gradient_buckets(wt, "dp", bucket_bytes=256)
        loss = sum(torch.sum(w * x) ** 2 for w, x in zip(tagged, xs))
        grads = torch.autograd.grad(loss, wt)
        overlap.wait_pending()
    out = {}
    for i in range(len(leaves)):
        out["plain%d" % i] = plain[i].numpy()
        out["bucketed%d" % i] = bucketed[i].numpy()
        out["mean%d" % i] = mean_b[i].numpy()
        out["ref%d" % i] = ref[i].numpy()
        out["tagged%d" % i] = grads[i].numpy()
    return out


def check_host(rank, world):
    import torch
    from mxnet_tpu_torch import parallel as P
    a = global_x(40 + rank, (3, 5))
    t = torch.from_numpy(global_x(50 + rank, (7,)))
    both = P.host_allreduce([a, t])
    one = P.host_allreduce(t)
    P.host_barrier()
    return {"np": both[0], "np_is_numpy": np.array(
        isinstance(both[0], np.ndarray)), "tensor": both[1].numpy(),
        "single": one.numpy(), "n": np.array(P.num_hosts()),
        "rank": np.array(P.host_rank())}


def check_placement(rank, world):
    """create_mesh() over the group: one CPU device per rank, the dp
    group's placements; replicated trees relaid out; a split spec
    raising, naming M10c."""
    import torch
    from mxnet_tpu_torch import parallel as P
    mesh = P.create_mesh()
    shardings = P.named_shardings(mesh, {"w": P.PartitionSpec(),
                                         "x": P.PartitionSpec("dp", None)})
    params = {"w": torch.arange(16.0).reshape(4, 4)}
    placed = P.relayout_params(params, P.data_parallel(mesh))
    msg = ""
    fs_mesh = P.create_mesh(dp=1, fsdp=2)
    try:
        P.relayout_params(params, P.fsdp(fs_mesh, min_size=4))
    except NotImplementedError as e:
        msg = str(e)
    return {"w_placements": np.array([repr(p) for p in
                                      shardings["w"].placements]),
            "x_placements": np.array([repr(p) for p in
                                      shardings["x"].placements]),
            "placed": placed["w"].numpy(),
            "host": P.host_array(placed["w"]),
            "fsdp_raise": np.array(msg),
            "group_size": np.array(
                torch.distributed.get_world_size(mesh.group("dp")))}


CHECKS = [("collectives", check_collectives), ("buckets", check_buckets),
          ("host", check_host), ("placement", check_placement)]


# -- the tests ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return cluster_fixture(os.path.abspath(__file__), tmp_path_factory,
                           _jax_ops)


@pytest.fixture(scope="module")
def cluster(run):
    return run[0]


@pytest.fixture(scope="module")
def jax_ops(run):
    return run[1]


def _jax_ops():
    """JAX's outputs of OPS on global_x() over jax.devices()[:2]."""
    import jax
    from jax import lax
    from mxnet_tpu.parallel import create_mesh, shard_map
    from mxnet_tpu.parallel.compat import PartitionSpec as JP
    mesh = create_mesh(devices=jax.devices()[:2])
    bodies = {
        "psum": lambda a: lax.psum(a, "dp"),
        "pmean": lambda a: lax.pmean(a, "dp"),
        "pmax": lambda a: lax.pmax(a, "dp"),
        "pmin": lambda a: lax.pmin(a, "dp"),
        "all_gather": lambda a: lax.all_gather(a, "dp", axis=1, tiled=True),
        "all_gather_untiled": lambda a: lax.all_gather(a, "dp", axis=1),
        "reduce_scatter": lambda a: lax.psum_scatter(
            a, "dp", scatter_dimension=1, tiled=True),
        "all_to_all": lambda a: lax.all_to_all(a, "dp", 1, 0, tiled=True),
        "all_to_all_untiled": lambda a: lax.all_to_all(a, "dp", 0, 1),
        "ppermute": lambda a: lax.ppermute(a, "dp", [(0, 1), (1, 0)]),
        "ppermute_one": lambda a: lax.ppermute(a, "dp", [(0, 1)]),
        "ring_exchange": lambda a: lax.ppermute(a, "dp", [(0, 1), (1, 0)]),
    }
    x = global_x()
    return {name: np.asarray(shard_map(fn, mesh, in_specs=JP("dp"),
                                       out_specs=JP("dp"),
                                       check_vma=False)(x))
            for name, fn in bodies.items()}


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_jax(cluster, jax_ops, op, rank):
    np.testing.assert_array_equal(result(cluster, "collectives", rank)[op],
                                  jax_ops[op])


def test_mesh_over_the_group(cluster):
    for rank in range(WORLD):
        r = result(cluster, "collectives", rank)
        assert int(r["axis_index"]) == rank
        assert list(r["owners"]) == [0, 1]
        assert list(r["devices"]) == ["cpu", "cpu"]


@pytest.mark.parametrize("form", ["bucketed", "mean", "tagged"])
def test_buckets_equal_the_per_leaf_reduce(cluster, form):
    for rank in range(WORLD):
        r = result(cluster, "buckets", rank)
        for i in range(len(SHAPES)):
            want = r["ref%d" % i] if form == "tagged" else r["plain%d" % i]
            if form == "mean":
                want = want / np.float32(WORLD)
            np.testing.assert_array_equal(r["%s%d" % (form, i)], want)
    assert_ranks_equal(cluster, "buckets")


def test_bucketed_reduce_matches_jax_psum(cluster):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from mxnet_tpu.parallel import create_mesh, shard_map
    from mxnet_tpu.parallel.compat import PartitionSpec as JP
    mesh = create_mesh(devices=jax.devices()[:2])
    r = result(cluster, "buckets", 0)
    for i, shape in enumerate(SHAPES):
        stacked = np.concatenate([_leaves(10 + k)[i].numpy()[None]
                                  for k in range(WORLD)])
        want = shard_map(lambda a: lax.psum(a, "dp"), mesh,
                         in_specs=JP("dp"), out_specs=JP("dp"),
                         check_vma=False)(jnp.asarray(stacked))
        np.testing.assert_array_equal(r["bucketed%d" % i],
                                      np.asarray(want)[0])


def test_host_helpers(cluster):
    for rank in range(WORLD):
        r = result(cluster, "host", rank)
        np.testing.assert_array_equal(
            r["np"], global_x(40, (3, 5)) + global_x(41, (3, 5)))
        np.testing.assert_array_equal(
            r["tensor"], global_x(50, (7,)) + global_x(51, (7,)))
        np.testing.assert_array_equal(r["single"], r["tensor"])
        assert bool(r["np_is_numpy"])
        assert int(r["n"]) == WORLD and int(r["rank"]) == rank


def test_placement_and_relayout(cluster):
    for rank in range(WORLD):
        r = result(cluster, "placement", rank)
        assert list(r["w_placements"]) == ["Replicate()"]
        assert list(r["x_placements"]) == ["Shard(dim=0)"]
        np.testing.assert_array_equal(r["placed"],
                                      np.arange(16.0).reshape(4, 4))
        np.testing.assert_array_equal(r["host"], r["placed"])
        assert "M10c" in str(r["fsdp_raise"])
        assert int(r["group_size"]) == WORLD


# -- one process -------------------------------------------------------------------

def _cpu(n):
    import torch
    return [torch.device("cpu")] * n


def test_one_device_collectives_are_the_identity():
    import torch
    from mxnet_tpu_torch import parallel as P
    mesh = P.create_mesh(devices=_cpu(1))
    x = torch.from_numpy(global_x())
    spec = P.PartitionSpec("dp")
    for name, fn in _port_ops().items():
        mapped = P.shard_map(fn, mesh, in_specs=spec, out_specs=spec)
        if name in ("all_to_all_untiled", "ppermute", "ppermute_one"):
            # as in JAX: the split axis must have the axis's size (1), and
            # a permutation may name no index past it
            with pytest.raises(ValueError):
                mapped(x)
            continue
        got = mapped(x)
        if name == "all_gather_untiled":
            assert torch.equal(got, x.unsqueeze(1)), name
        else:
            assert torch.equal(got, x), name
    ts = _leaves(1)
    with P.mesh_scope(mesh):
        assert all(torch.equal(a, b)
                   for a, b in zip(P.bucketed_reduce(ts, "dp"), ts))


def test_host_helpers_in_one_process(monkeypatch):
    from mxnet_tpu_torch import parallel as P
    for k in ("MXTPU_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    a = global_x()
    assert P.num_hosts() == 1 and P.host_rank() == 0
    assert P.host_allreduce(a) is a
    assert P.host_barrier() is None
    assert P.initialize_distributed() is False


class _Dev:
    """A fake device of a given process (the JAX tests' idiom)."""

    def __init__(self, i, proc):
        self.id, self.process_index = i, proc

    def __repr__(self):
        return "_Dev(%d, %d)" % (self.id, self.process_index)


@pytest.mark.parametrize("dead", [[], [1], [0, 3], [0, 1, 2, 3]])
def test_surviving_devices_match_jax(dead):
    from mxnet_tpu.parallel import surviving_devices as jsurv
    from mxnet_tpu_torch.parallel import surviving_devices
    fake = [_Dev(i, i // 2) for i in range(8)]
    assert surviving_devices(dead, fake) == jsurv(dead, fake)


@pytest.mark.parametrize("sizes,keep", [
    (dict(dp=8), 4), (dict(dp=4, tp=2), 4), (dict(dp=4, tp=2), 6),
    (dict(dp=4, tp=2), 3), (dict(dp=4, tp=2), 0), (dict(dp=2, sp=2, tp=2), 4)])
def test_shrink_mesh_matches_jax(sizes, keep):
    import jax
    from mxnet_tpu.parallel import create_mesh as jcreate
    from mxnet_tpu.parallel import shrink_mesh as jshrink
    from mxnet_tpu_torch.parallel import create_mesh, shrink_mesh
    jm = jcreate(**sizes)
    tm = create_mesh(devices=_cpu(8), **sizes)
    try:
        want = dict(jshrink(jm, devices=list(jax.devices()[:keep])).shape)
    except ValueError as e:
        with pytest.raises(ValueError):
            shrink_mesh(tm, devices=_cpu(keep))
        assert keep == 0 or "divide" in str(e)
        return
    assert shrink_mesh(tm, devices=_cpu(keep)).shape == want


def test_shrink_mesh_drops_dead_owners():
    """By owner: the devices of ranks 1 and 2 go, dp absorbs the shrink
    (JAX's rule on a mesh of four processes of two devices each)."""
    from mxnet_tpu_torch.parallel import create_mesh, shrink_mesh
    mesh = create_mesh(devices=_cpu(8), tp=2)
    mesh.owners = np.repeat(np.arange(4), 2).reshape(mesh.owners.shape)
    small = shrink_mesh(mesh, dead_processes=[1, 2])
    assert small.shape["dp"] == 2 and small.shape["tp"] == 2
    assert sorted(small.owners.ravel()) == [0, 0, 3, 3]
    with pytest.raises(ValueError):
        shrink_mesh(mesh, dead_processes=[0, 1, 2, 3])


def test_named_shardings_match_jax():
    from mxnet_tpu.parallel import create_mesh as jcreate
    from mxnet_tpu.parallel.sharding import named_shardings as jnamed
    from mxnet_tpu.parallel.compat import PartitionSpec as JP
    from mxnet_tpu_torch.parallel import (PartitionSpec, create_mesh,
                                          named_shardings)
    specs = {"a": ("dp", None), "b": (), "c": (None, "tp")}
    j = jnamed(jcreate(dp=4, tp=2), {k: JP(*v) for k, v in specs.items()})
    t = named_shardings(create_mesh(devices=_cpu(8), dp=4, tp=2),
                        {k: PartitionSpec(*v) for k, v in specs.items()})
    for k in specs:
        assert tuple(t[k].spec) == tuple(j[k].spec)
    assert [repr(p) for p in t["c"].placements][-1] == "Shard(dim=1)"


def test_several_devices_in_one_process_raise_naming_the_launcher():
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch import parallel as P
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.loss import L2Loss
    mesh = P.create_mesh(devices=_cpu(2))
    assert mesh.owners.ravel().tolist() == [0, 0]
    x = torch.zeros(4, 3)
    with pytest.raises(MXNetError, match="launch.py"):
        P.shard_map(lambda a: a, mesh, in_specs=P.PartitionSpec("dp"),
                    out_specs=P.PartitionSpec("dp"))(x)
    with pytest.raises(MXNetError, match="launch.py"):
        with P.mesh_scope(mesh):
            P.all_reduce(x, "dp")
    net = nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    with pytest.raises(MXNetError, match="torchrun"):
        P.ShardedTrainStep(net, L2Loss(), mx.optimizer.create("sgd"),
                           mesh=mesh)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker_main(CHECKS)
