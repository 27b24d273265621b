"""The port's device mesh and partition rules (mxnet_tpu_torch/parallel/
mesh.py and sharding.py) held against the JAX package's on its 8-device
virtual CPU platform: create_mesh's shapes and errors, and the
PartitionSpec of every parameter path under data_parallel, fsdp,
tensor_parallel and infer_rules_for_block("auto") on meshes dp=8,
dp=2 x fsdp=4 and dp=2 x tp=4. The specs are bookkeeping over axis sizes,
so the port's mesh holds eight CPU devices here; only its training step
needs one device (test_torch_sharded_step.py)."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu.parallel import sharding as jsh
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import sharding as tsh

CPU8 = [torch.device("cpu")] * 8
MESHES = [dict(dp=8), dict(dp=2, fsdp=4), dict(dp=2, tp=4)]

# a parameter tree with the names the tensor-parallel rules match, shapes
# that the mesh axes divide or not, a scalar and a stacked layer tree
SHAPES = {
    "attn_qkv_weight": (48, 16), "attn_qkv_bias": (48,),
    "attn_out_proj_weight": (16, 16), "ffn_fc1_weight": (64, 16),
    "ffn_fc1_bias": (64,), "ffn_fc2_weight": (16, 64),
    "embed_weight": (100, 16), "odd_weight": (7, 5), "scale": (),
    "norm_gamma": (16,), "big": (1024, 3), "conv_weight": (32, 16, 3, 3),
}
TREE = {"embed": (100, 16), "w_out": (16, 100),
        "layers": {"wq": (4, 16, 8, 2), "wo": (4, 8, 2, 16),
                   "w_gate": (4, 16, 64), "w_down": (4, 64, 16),
                   "norm": (4, 16)},
        "extra": [(8, 8), (3,)], "none": None}


def _meshes(sizes):
    return (tmesh.create_mesh(devices=CPU8, **sizes),
            jmesh.create_mesh(**sizes))


class _Shaped:
    def __init__(self, shape):
        self.shape = shape


def _shaped(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _shaped(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shaped(v) for v in tree]
    return _Shaped(tree)


def _specs(tree):
    """Nested specs as plain tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("sizes", MESHES + [{}, dict(fsdp=2, tp=2)])
def test_create_mesh_shapes_match_jax(sizes):
    """The same axis names and sizes (the rest of the devices on 'dp')."""
    t, j = _meshes(sizes)
    assert t.axis_names == tuple(j.axis_names)
    assert t.shape == j.shape
    assert t.size() == j.size() == 8
    for a in t.axis_names:
        assert t.size(a) == j.size(a)
    assert t.devices.shape == tuple(j.mesh.devices.shape)


@pytest.mark.parametrize("sizes", [dict(bogus=2), dict(dp=3), dict(dp=2),
                                   dict(tp=3), dict(dp=16)])
def test_create_mesh_errors_match_jax(sizes):
    """Unknown axes, sizes that do not divide the device count, explicit
    sizes that use only some of the devices: ValueError on both sides."""
    with pytest.raises(ValueError):
        jmesh.create_mesh(**sizes)
    with pytest.raises(ValueError):
        tmesh.create_mesh(devices=CPU8, **sizes)


def test_mesh_scope_and_defaults():
    t, _ = _meshes(dict(dp=8))
    assert tmesh.current_mesh() is None
    with tmesh.mesh_scope(t):
        assert tmesh.current_mesh() is t
    assert tmesh.current_mesh() is None
    assert tmesh.default_mesh_axes == jmesh.default_mesh_axes
    assert tuple(t.sharding("dp", None).spec) == ("dp", None)
    assert tuple(t.replicated().spec) == ()
    if not torch.cuda.is_available():
        with pytest.raises(mx.MXNetError):
            tmesh.create_mesh(dp=1)
    # every device of a one-process mesh is owned by rank 0 (JAX's
    # process_index 0): with rank 0 dead none survives, in both packages
    assert tmesh.surviving_devices([0], devices=CPU8) == [] == \
        jmesh.surviving_devices([0])
    assert tmesh.surviving_devices([1], devices=CPU8) == CPU8
    assert len(jmesh.surviving_devices([1])) == 8
    for shrink, mesh in ((tmesh.shrink_mesh, t),
                         (jmesh.shrink_mesh, jmesh.create_mesh(dp=8))):
        with pytest.raises(ValueError, match="no surviving devices"):
            shrink(mesh, [0])
        assert dict(shrink(mesh, [1]).shape)["dp"] == 8


def _strategies(t, j):
    return [("data_parallel", tsh.data_parallel(t), jsh.data_parallel(j)),
            ("fsdp", tsh.fsdp(t, min_size=64), jsh.fsdp(j, min_size=64)),
            ("fsdp_default", tsh.fsdp(t), jsh.fsdp(j)),
            ("tensor_parallel", tsh.tensor_parallel(t),
             jsh.tensor_parallel(j)),
            ("tensor_parallel_extra",
             tsh.tensor_parallel(t, extra_rules=[(r"odd", ("tp", None))]),
             jsh.tensor_parallel(j, extra_rules=[(r"odd", ("tp", None))]))]


@pytest.mark.parametrize("sizes", MESHES, ids=["dp8", "dp2fsdp4", "dp2tp4"])
def test_param_specs_match_jax(sizes):
    """Every strategy's spec for every path, its batch spec, and
    match_partition_rules over a nested tree with a stacked layer tree,
    against JAX's on the same mesh sizes."""
    t, j = _meshes(sizes)
    params = {k: _Shaped(s) for k, s in SHAPES.items()}
    for name, ts, js in _strategies(t, j):
        got = ts.param_sharding(params)
        want = js.param_sharding(params)
        for k in SHAPES:
            assert tuple(got[k].spec) == tuple(want[k].spec), (name, k)
        assert tuple(ts.batch_spec()) == tuple(js.batch_spec()), name
        assert tuple(ts.batch_sharding().spec) \
            == tuple(js.batch_sharding().spec), name
        assert (ts.batch_axes, ts.grad_reduce_axes, ts.name) \
            == (js.batch_axes, js.grad_reduce_axes, js.name)
        if name.startswith("tensor"):
            assert ts.param_rules.describe() == tuple(
                (p, tuple(s)) for p, s in js.param_rules.describe())
            tree = _shaped(TREE)
            assert _specs(tsh.match_partition_rules(ts, tree, mesh=t)) \
                == _specs(jsh.match_partition_rules(js, tree, mesh=j))


def test_match_partition_rules_strict_and_raw_rules():
    """A raw rule list, strict mode's error on an unmatched leaf, and specs
    fitted without a mesh (trimmed to rank only)."""
    rules = [(r"w_out$", ("tp", None, "dp")), (r"embed", (None, "tp"))]
    tree = _shaped({"embed": (10, 4), "w_out": (4, 10), "x": (3,)})
    assert _specs(tsh.match_partition_rules(rules, tree)) \
        == _specs(jsh.match_partition_rules(rules, tree))
    for fn in (tsh.match_partition_rules, jsh.match_partition_rules):
        with pytest.raises(ValueError):
            fn(rules, tree, strict=True)
    r = tsh.PartitionRules(rules) + tsh.PartitionRules([(r"x", ("dp",))])
    assert tuple(r.spec_for("x", (4,))) == ("dp",)
    assert tuple(r.spec_for("y")) == ()


def _blocks():
    """A block whose parameter names match the TP rules, and one whose
    names match none, on both sides."""
    out = []
    for nn in (mx.gluon.nn, mxj.gluon.nn):
        tp = nn.HybridSequential(prefix="")
        tp.add(nn.Dense(48, in_units=16, prefix="attn_qkv_"))
        tp.add(nn.Dense(16, in_units=48, prefix="attn_out_proj_"))
        plain = nn.HybridSequential(prefix="")
        plain.add(nn.Dense(8, in_units=16, prefix="head_"))
        out.append((tp, plain))
    return out


@pytest.mark.parametrize("sizes", MESHES, ids=["dp8", "dp2fsdp4", "dp2tp4"])
def test_infer_rules_for_block_matches_jax(sizes):
    """Each strategy name picks the same strategy as JAX's; "auto" picks
    tensor parallelism only on a tp axis over 1 with a matching name; the
    picked rules give every parameter JAX's spec."""
    t, j = _meshes(sizes)
    (ttp, tplain), (jtp, jplain) = _blocks()
    for tb, jb in ((ttp, jtp), (tplain, jplain)):
        for strat in ("dp", "fsdp", "tp", "auto", "3d", "nccl", "zero"):
            ts = tsh.infer_rules_for_block(tb, t, strat)
            js = jsh.infer_rules_for_block(jb, j, strat)
            assert ts.name == js.name, (strat, ts.name, js.name)
            tp_ = {p.name: p.shape for p in tb._all_params_list()}
            jp_ = {p.name: p.shape for p in jb._all_params_list()}
            assert tp_ == jp_
            got = ts.param_sharding(tp_)
            want = js.param_sharding(jp_)
            for k in tp_:
                assert tuple(got[k].spec) == tuple(want[k].spec), (strat, k)
    with pytest.raises(ValueError):
        tsh.infer_rules_for_block(ttp, t, "bogus")
    assert tsh.infer_rules_for_block(ttp, t, "auto").name == (
        "tensor_parallel" if sizes.get("tp", 1) > 1 else "data_parallel")


def test_multi_device_placement_waits_for_m10():
    """Placement over several devices: the specs of named_shardings equal
    JAX's and read as DTensor placements; host_array stages a replicated
    array whole; relayout_params places replicated trees on this
    process's device, and on a mesh of eight devices in one process (the
    port runs one device per process) raises, naming the launcher."""
    t, j = _meshes(dict(dp=8))
    specs = {"w": (), "x": ("dp", None)}
    tn = tsh.named_shardings(t, {k: tmesh.PartitionSpec(*v)
                                 for k, v in specs.items()})
    jn = jsh.named_shardings(j, {k: jsh.P(*v) for k, v in specs.items()})
    for k in specs:
        assert tuple(tn[k].spec) == tuple(jn[k].spec)
    assert [repr(p) for p in tn["x"].placements][0] == "Shard(dim=0)"
    a = np.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(tsh.host_array(torch.from_numpy(a)),
                                  jsh.host_array(jax.numpy.asarray(a)))
    with pytest.raises(mx.MXNetError, match="launch.py"):
        tsh.relayout_params({"w": torch.zeros(2)}, tsh.data_parallel(t))
    one = tmesh.create_mesh(devices=CPU8[:1])
    placed = tsh.relayout_params({"w": torch.from_numpy(a)},
                                 tsh.data_parallel(one))
    assert placed["w"].device.type == "cpu"
    np.testing.assert_array_equal(placed["w"].numpy(), a)
    assert jax.device_count() == 8     # the JAX side saw eight devices
