"""The port's ``mx.sym`` held against the JAX package's on the CPU.

- Every op name both registries have: a node built with its default
  inputs gives the same arguments, auxiliary states, outputs and JSON.
- Graphs built the same way give the same ``tojson()`` byte for byte (a
  traced ``resnet18_v1()``, the MNIST example's MLP and LeNet), and each
  package loads the other's JSON (and the reference's fixture files) to
  the same graph.
- ``infer_shape``/``infer_type`` equal JAX's on ResNet-18/50 v1 NCHW at
  224 with a SoftmaxOutput head and on the LeNet; the NHWC trace raises in
  both (the hint table's ``cin = data[1]``).
- ``NameManager``, ``Prefix`` and ``AttrScope`` give the same names and
  attrs; Symbol's operators, indexing and introspection agree.
- ``sym.contrib.foreach``, ``while_loop`` and ``cond`` give JAX's JSON and
  outputs (1e-5, f32), on the port's CPU executor.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu.operator  # noqa: F401  (registers "Custom", as the port does)
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.symbol import register as jsreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.symbol import register as tsreg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED_OPS = sorted(set(jreg.list_ops()) & set(treg.list_ops()))
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def both(fn):
    """fn(pkg) in each package under a fresh NameManager, so that the
    automatic node names start from 0 on both sides."""
    out = []
    for pkg in (mxj, mx):
        with pkg.name.NameManager():
            out.append(fn(pkg))
    return out


def _default_node(sreg, reg, name):
    try:
        s = sreg.make_symbol_op_func(reg.get_op(name), name)(name="n0")
    except Exception as e:  # noqa: BLE001 -- the same failure on both
        return ("raises", type(e).__name__)
    return (s.list_arguments(), s.list_auxiliary_states(), s.list_outputs(),
            s.tojson())


# JAX's ops/extended.py registers "_arange" again as an op of its own; the
# port keeps ops/tensor.py's alias of arange (as test_torch_elemwise_
# tensor_ops holds it), so its node's op is named "arange". Each package
# loads the other's node (the name resolves in both registries).
OP_RENAMED = {"_arange": "arange"}


def test_registries_share_the_ported_names():
    assert len(SHARED_OPS) == len(treg.list_ops())


@pytest.mark.parametrize("name", SHARED_OPS)
def test_default_node_matches_jax(name):
    want = _default_node(jsreg, jreg, name)
    if name in OP_RENAMED:
        want = want[:3] + (want[3].replace(
            '"op": "%s"' % name, '"op": "%s"' % OP_RENAMED[name]),)
        assert mxj.sym.load_json(_default_node(
            tsreg, treg, name)[3]).list_outputs() == want[2]
    assert _default_node(tsreg, treg, name) == want


def mlp(pkg):
    """example/image-classification/train_mnist.py:22-33."""
    sym = pkg.sym
    data = sym.Variable("data")
    data = sym.Flatten(data)
    fc1 = sym.FullyConnected(data, num_hidden=128, name="fc1")
    act1 = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act1, num_hidden=64, name="fc2")
    act2 = sym.Activation(fc2, act_type="relu", name="relu2")
    fc3 = sym.FullyConnected(act2, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(fc3, sym.Variable("softmax_label"),
                             name="softmax")


def lenet(pkg):
    """example/image-classification/train_mnist.py:36-49."""
    sym = pkg.sym
    data = sym.Variable("data")
    c1 = sym.Convolution(data, kernel=(5, 5), num_filter=20, name="conv1")
    a1 = sym.Activation(c1, act_type="tanh")
    p1 = sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = sym.Convolution(p1, kernel=(5, 5), num_filter=50, name="conv2")
    a2 = sym.Activation(c2, act_type="tanh")
    p2 = sym.Pooling(a2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f = sym.Flatten(p2)
    fc1 = sym.Activation(sym.FullyConnected(f, num_hidden=500, name="fc1"),
                         act_type="tanh")
    fc2 = sym.FullyConnected(fc1, num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.Variable("softmax_label"),
                             name="softmax")


def resnet(pkg, depth=18, layout="NCHW", head=False):
    """resnet<depth>_v1 traced with a Symbol input (a fixed prefix, so the
    names do not depend on how many nets the process made before)."""
    vision = pkg.gluon.model_zoo.vision
    net = getattr(vision, "resnet%d_v1" % depth)(layout=layout,
                                                 prefix="resnet_")
    out = net(pkg.sym.var("data"))
    if head:
        out = pkg.sym.SoftmaxOutput(out, name="softmax")
    return out


GRAPHS = {"mlp": mlp, "lenet": lenet,
          "resnet18_v1": lambda pkg: resnet(pkg, head=True)}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_tojson_equal_and_loads_across(graph):
    js, ts = both(GRAPHS[graph])
    assert ts.tojson() == js.tojson()
    # each package loads the other's JSON to the same graph
    assert mx.sym.load_json(js.tojson()).tojson() == js.tojson()
    assert mxj.sym.load_json(ts.tojson()).tojson() == ts.tojson()
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()


def test_save_and_load_files_across(tmp_path):
    js, ts = both(lenet)
    js.save(str(tmp_path / "j-symbol.json"))
    ts.save(str(tmp_path / "t-symbol.json"))
    assert (tmp_path / "j-symbol.json").read_bytes() == \
        (tmp_path / "t-symbol.json").read_bytes()
    assert mx.sym.load(str(tmp_path / "j-symbol.json")).tojson() == \
        js.tojson()
    assert mxj.sym.load(str(tmp_path / "t-symbol.json")).tojson() == \
        ts.tojson()


@pytest.mark.parametrize("fixture", ["ref_mxnet_1x_symbol.json",
                                     "ref_mxnet_legacy_symbol.json"])
def test_reference_fixture_files_load_alike(fixture):
    with open(os.path.join(ROOT, "tests", "fixtures", fixture)) as f:
        text = f.read()
    j, t = mxj.sym.load_json(text), mx.sym.load_json(text)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()


INFER = {
    "resnet18_v1": (lambda pkg: resnet(pkg, 18, head=True),
                    {"data": (2, 3, 224, 224), "softmax_label": (2,)}),
    "resnet50_v1": (lambda pkg: resnet(pkg, 50, head=True),
                    {"data": (2, 3, 224, 224), "softmax_label": (2,)}),
    "lenet": (lenet, {"data": (4, 1, 28, 28), "softmax_label": (4,)}),
    "mlp": (mlp, {"data": (4, 784), "softmax_label": (4,)}),
}


@pytest.mark.parametrize("graph", sorted(INFER))
def test_infer_shape_and_type_match_jax(graph):
    build, shapes = INFER[graph]
    js, ts = both(build)
    want = js.infer_shape(**shapes)
    got = ts.infer_shape(**shapes)
    assert got == want
    assert ts.infer_shape_partial(data=shapes["data"]) == \
        js.infer_shape_partial(data=shapes["data"])
    jt, tt = js.infer_type(data=np.float32), ts.infer_type(data=np.float32)
    assert [np.dtype(t) for group in tt for t in group] == \
        [np.dtype(t) for group in jt for t in group]
    if graph == "resnet50_v1":
        assert want[1] == [(2, 1000)]
        assert (len(ts.list_arguments()), len(ts.list_auxiliary_states())) \
            == (163, 106)


def test_partial_inference_leaves_unknowns_none():
    js, ts = both(mlp)
    assert ts.infer_shape_partial() == js.infer_shape_partial()
    with pytest.raises(ValueError):
        js.infer_shape()
    with pytest.raises(ValueError):
        ts.infer_shape()


def test_nhwc_trace_does_not_infer_in_either_package():
    """The hint table reads a Convolution's input channels off data[1]
    (mxnet_tpu/symbol/infer.py:52), so the channels-last trace fails in
    both packages."""
    js, ts = both(lambda pkg: resnet(pkg, 18, layout="NHWC"))
    assert ts.tojson() == js.tojson()
    with pytest.raises(Exception):
        js.infer_shape(data=(2, 3, 224, 224))
    with pytest.raises(Exception):
        ts.infer_shape(data=(2, 3, 224, 224))


def _scopes(pkg):
    sym = pkg.sym
    a = sym.var("a", shape=(2, 3), lr_mult=2.0, wd_mult=0.5,
                dtype="float32", init=pkg.init.Uniform(0.1))
    with pkg.name.Prefix("net_"):
        b = sym.FullyConnected(a, num_hidden=4)
        c = sym.Activation(b, act_type="relu", name="act")
    with pkg.AttrScope(ctx_group="dev1", tag="x"):
        d = sym.FullyConnected(c, num_hidden=3)
        with pkg.AttrScope(tag="y"):
            e = sym.relu(d, attr={"note": "n"})
    with pkg.name.NameManager():
        f = sym.FullyConnected(e, num_hidden=2)
    return sym.Group([f, c])


def test_name_manager_prefix_and_attr_scope_match_jax():
    js, ts = both(_scopes)
    assert ts.tojson() == js.tojson()
    assert ts.attr_dict == js.attr_dict
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    with pytest.raises(ValueError):
        mx.AttrScope(tag=1)


def _operators(pkg):
    sym = pkg.sym
    a, b = sym.var("a"), sym.var("b")
    outs = [a + b, a - b, a * b, a / b, a ** b, a % b, a + 2, 2 + a, a - 2,
            2 - a, a * 3, 3 * a, a / 4, 4 / a, a ** 2, -a, a % 3, a == b,
            a != b, a > b, a >= b, a < b, a <= b, a > 1, a == 1, a.sum(),
            a.reshape((2, 3)), sym.zeros((2, 3)), sym.ones((3,))]
    return sym.Group(outs)


def test_symbol_operators_and_introspection_match_jax():
    js, ts = both(_operators)
    assert ts.tojson() == js.tojson()
    assert ts.list_outputs() == js.list_outputs()
    for j, t in ((js[3], ts[3]), (js.get_internals(), ts.get_internals()),
                 (js[1:4], ts[1:4]), (js.get_children(), ts.get_children())):
        assert t.tojson() == j.tojson()
    ji, ti = js.get_internals(), ts.get_internals()
    assert ti.list_outputs() == ji.list_outputs()
    name = ji[5].name
    assert ti[name].tojson() == ji[name].tojson()
    assert ts.debug_str() == js.debug_str()
    assert len(ts) == len(js) and ts.name == js.name is None
    with pytest.raises(TypeError):
        bool(ts[0])
    with pytest.raises(AttributeError):
        ts[0].no_such_op


def test_sub_namespaces_match_jax():
    """JAX's names, but those whose registry op the port lacks yet (M11's
    names: linalg's extracttrian, maketrian and syevd, contrib's
    index_copy and index_array)."""
    have = set(treg.list_ops())
    for ns, op_prefix in (("random", None), ("linalg", "linalg_"),
                          ("image", "_image_")):
        want = [n for n in getattr(mxj.sym, ns).__all__
                if op_prefix is None or op_prefix + n in have]
        assert sorted(getattr(mx.sym, ns).__all__) == sorted(want), ns
    assert sorted(set(mxj.sym.linalg.__all__)
                  - set(mx.sym.linalg.__all__)) == \
        ["extracttrian", "maketrian", "syevd"]
    assert sorted(mx.sym.contrib.__all__) == sorted(
        n for n in mxj.sym.contrib.__all__
        if n in ("foreach", "while_loop", "cond") or n in have)
    for ns in ("random", "contrib"):
        jn, tn = both(lambda pkg: pkg.sym.Group([
            pkg.sym.random.uniform(0, 1, shape=(2, 3)),
            pkg.sym.random.normal(pkg.sym.var("m"), pkg.sym.var("s"),
                                  shape=(2,)),
            pkg.sym.linalg.gemm2(pkg.sym.var("x"), pkg.sym.var("y")),
            pkg.sym.contrib.quantize_v2(pkg.sym.var("x"))]))
        assert tn.tojson() == jn.tojson()
    # sym.Custom (operator.py): the same node and JSON as JAX's
    jn, tn = both(lambda pkg: pkg.sym.Custom(pkg.sym.var("x"),
                                             op_type="sq", name="c"))
    assert tn.tojson() == jn.tojson()


# -- control flow -----------------------------------------------------------

def _foreach(pkg):
    sym = pkg.sym

    def body(x, states):
        h = states[0]
        new = sym.tanh(x * sym.var("w") + h)
        return new * 2, [new]
    outs, states = sym.contrib.foreach(body, sym.var("seq"),
                                       [sym.var("h0")])
    return sym.Group([outs, states[0]])


def _while(pkg):
    sym = pkg.sym

    def cond(i, acc):
        return i < 4

    def func(i, acc):
        return acc * sym.var("w"), [i + 1, acc + sym.var("w")]
    outs, last = sym.contrib.while_loop(cond, func,
                                        [sym.var("i"), sym.var("acc")],
                                        max_iterations=6)
    return sym.Group([outs, last[0], last[1]])


def _cond(pkg):
    sym = pkg.sym
    x = sym.var("x")
    out = sym.contrib.cond(sym.sum(x) > 0, lambda: x * 2, lambda: x - 1)
    return out


CF_INPUTS = {
    "foreach": (_foreach, {"seq": (5, 2, 3), "w": (2, 3), "h0": (2, 3)}),
    "while_loop": (_while, {"i": (1,), "acc": (2, 2), "w": (2, 2)}),
    "cond_then": (_cond, {"x": (3, 4)}),
    "cond_else": (_cond, {"x": (3, 4)}),
}


@pytest.mark.parametrize("case", sorted(CF_INPUTS))
def test_control_flow_matches_jax(case):
    build, shapes = CF_INPUTS[case]
    js, ts = both(build)
    assert ts.tojson() == js.tojson()
    rs = np.random.RandomState(0)
    vals = {k: rs.uniform(-1, 1, s).astype(np.float32)
            for k, s in shapes.items()}
    if case == "while_loop":
        vals["i"] = np.zeros((1,), np.float32)
    if case == "cond_else":
        vals["x"] = -np.abs(vals["x"])
    elif case == "cond_then":
        vals["x"] = np.abs(vals["x"])
    jouts = js.eval(mxj.cpu(), **{k: mxj.nd.array(v)
                                  for k, v in vals.items()})
    touts = ts.eval(mx.cpu(), **{k: mx.nd.array(v)
                                 for k, v in vals.items()})
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL,
                                   atol=RTOL)
    got = ts.infer_shape(**shapes)
    want = js.infer_shape(**shapes)
    assert got[1] == want[1]


def test_while_loop_with_no_step_gives_zeros_like_jax():
    js, ts = both(_while)
    vals = {"i": np.full((1,), 9, np.float32),
            "acc": np.ones((2, 2), np.float32),
            "w": np.ones((2, 2), np.float32)}
    jouts = js.eval(mxj.cpu(), **{k: mxj.nd.array(v)
                                  for k, v in vals.items()})
    touts = ts.eval(mx.cpu(), **{k: mx.nd.array(v)
                                 for k, v in vals.items()})
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_parameter_var_is_a_named_variable():
    p = mx.gluon.Parameter("fc_weight", shape=(4, 3))
    v = p.var()
    assert v.list_arguments() == ["fc_weight"]
    assert v.tojson() == mxj.sym.var("fc_weight", shape=(4, 3)).tojson()
