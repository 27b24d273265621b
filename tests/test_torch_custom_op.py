"""mx.operator (CustomOp, nd.Custom, sym.Custom) and symbol.subgraph of the
port against the JAX package's (mxnet_tpu/operator.py,
mxnet_tpu/symbol/subgraph.py).

The same CustomOp classes (the softmax loss head of MXNet's documentation,
and a two-output op with an auxiliary-free backward that reads its
out_grad) are registered in both packages: eager outputs and gradients
within 1e-6 of the largest value (f32), the same through the Executor and a
Module's steps (1e-5: the graphs around the op differ in summation order
only). partition() gives the same fused nodes and the same JSON as JAX's
(node names up to each package's own region counter), and the partitioned
graph's outputs equal the unfused graph's bit for bit; its BatchNorm
regions drop their moving-statistic updates, as JAX's do.
"""
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu.symbol import subgraph as jsg
from mxnet_tpu_torch.symbol import subgraph as tsg

TOL = 1e-6
GRAPH_TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def register(pkg):
    """The documentation's softmax loss head (forward softmax(x), backward
    y - onehot(label), top gradient not needed) and a scaled split with
    two outputs, registered in ``pkg``."""
    op = pkg.operator

    class Softmax(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], pkg.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], pkg.nd.array(y))

    @op.register("doc_softmax")
    class SoftmaxProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Split(op.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            self.assign(out_data[0], req[0], x * self.scale)
            self.assign(out_data[1], req[1], pkg.nd.tanh(x))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            t = out_data[1]
            g = out_grad[0] * self.scale + out_grad[1] * (1 - t * t)
            self.assign(in_grad[0], req[0], g)

    @op.register("scaled_split")
    class SplitProp(op.CustomOpProp):
        def __init__(self, scale="2.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_outputs(self):
            return ["scaled", "tanh"]

        def create_operator(self, ctx, shapes, dtypes):
            return Split(self.scale)

    return Softmax, Split


for _pkg in (mxj, mx):
    register(_pkg)


def _data(seed=0, n=6, c=5):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, c).astype(np.float32),
            rs.randint(0, c, n).astype(np.float32))


def test_registry_and_props():
    for pkg in (mxj, mx):
        prop = pkg.operator.get_prop("scaled_split")(scale="3")
        assert prop.list_arguments() == ["data"]
        assert prop.infer_shape([[2, 3]]) == ([[2, 3]], [[2, 3], [2, 3]], [])
        assert prop.infer_storage_type(["default"]) == (
            ["default"], ["default", "default"], [])
        assert prop.declare_backward_dependency([1], [2], [3]) == [1, 2, 3]
    with pytest.raises(KeyError, match="not registered"):
        mx.operator.get_prop("nope")


def test_eager_softmax_head_equal_jax():
    x, lab = _data()
    res = []
    for pkg in (mxj, mx):
        xa, la = pkg.nd.array(x), pkg.nd.array(lab)
        xa.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Custom(xa, la, op_type="doc_softmax")
        y.backward()
        res.append((y.asnumpy(), xa.grad.asnumpy()))
    (jy, jg), (ty, tg) = res
    close(ty, jy, TOL)
    close(tg, jg, TOL)
    want = np.exp(x - x.max(1, keepdims=True))
    want /= want.sum(1, keepdims=True)
    close(ty, want, TOL)
    close(tg, want - np.eye(5)[lab.astype(int)], TOL)


def test_eager_two_outputs_with_head_grads_equal_jax():
    x, _ = _data(1)
    rs = np.random.RandomState(2)
    heads = [rs.randn(*x.shape).astype(np.float32) for _ in range(2)]
    res = []
    for pkg in (mxj, mx):
        xa = pkg.nd.array(x)
        xa.attach_grad()
        with pkg.autograd.record():
            a, b = pkg.nd.Custom(xa, op_type="scaled_split", scale=1.5)
            z = a * pkg.nd.array(heads[0]) + b * pkg.nd.array(heads[1])
        z.backward()
        res.append((a.asnumpy(), b.asnumpy(), xa.grad.asnumpy()))
    for t, j in zip(res[1], res[0]):
        close(t, j, TOL)
    # outside record(): no graph, the same values; tensors in, tensors out
    out = mx.nd.Custom(torch.from_numpy(x), op_type="scaled_split")
    assert isinstance(out[0], torch.Tensor) and not out[0].requires_grad
    close(out[0].numpy(), 2.0 * x, TOL)


def mlp_custom(pkg):
    sym = pkg.sym
    fc1 = sym.FullyConnected(sym.var("data"), num_hidden=8, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=5, name="fc2")
    return sym.Custom(fc2, sym.var("softmax_label"), op_type="doc_softmax",
                      name="softmax")


def _values(sym, shapes, seed=3):
    rs = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    out = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        out[n] = (rs.randint(0, 5, s) if n == "softmax_label"
                  else rs.uniform(-0.5, 0.5, s)).astype(np.float32)
    return out


def test_sym_custom_json_and_executor_equal_jax():
    syms = []
    for pkg in (mxj, mx):
        with pkg.name.NameManager():
            syms.append(mlp_custom(pkg))
    js, ts = syms
    assert ts.tojson() == js.tojson()
    shapes = {"data": (6, 7), "softmax_label": (6,)}
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    vals = _values(js, shapes)
    res = []
    for pkg, s in ((mxj, js), (mx, ts)):
        a = {k: pkg.nd.array(v) for k, v in vals.items()}
        g = {k: pkg.nd.zeros(v.shape) for k, v in vals.items()}
        ex = s.bind(pkg.cpu(), args=a, args_grad=g)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res.append((out, {k: ex.grad_dict[k].asnumpy()
                          for k in ("fc1_weight", "fc2_weight", "data")}))
    close(res[1][0], res[0][0], GRAPH_TOL)
    for k in res[0][1]:
        close(res[1][1][k], res[0][1][k], GRAPH_TOL)


def test_module_steps_with_custom_head_equal_jax():
    syms = []
    for pkg in (mxj, mx):
        with pkg.name.NameManager():
            syms.append(mlp_custom(pkg))
    vals = _values(syms[0], {"data": (8, 7), "softmax_label": (8,)}, 4)
    arg = {k: v for k, v in vals.items()
           if k not in ("data", "softmax_label")}
    rs = np.random.RandomState(5)
    batches = [(rs.uniform(-1, 1, (8, 7)).astype(np.float32),
                rs.randint(0, 5, 8).astype(np.float32)) for _ in range(2)]
    mods = []
    for pkg, s in zip((mxj, mx), syms):
        mod = pkg.mod.Module(s, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (8, 7))],
                 label_shapes=[("softmax_label", (8,))])
        mod.set_params({k: pkg.nd.array(v) for k, v in arg.items()}, {})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        for x, y in batches:
            mod.forward(pkg.io.DataBatch([pkg.nd.array(x)],
                                         [pkg.nd.array(y)]), is_train=True)
            mod.backward()
            mod.update()
        mods.append(mod)
    (ja, _), (ta, _) = (m.get_params() for m in mods)
    for n in ja:
        close(ta[n].asnumpy(), ja[n].asnumpy(), GRAPH_TOL)
    close(mods[1].get_outputs()[0].asnumpy(),
          mods[0].get_outputs()[0].asnumpy(), GRAPH_TOL)


def conv_net(pkg):
    sym = pkg.sym
    x = sym.var("data")
    c = sym.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1),
                        name="c0")
    b = sym.BatchNorm(c, fix_gamma=False, momentum=0.8, name="bn0")
    r = sym.Activation(b, act_type="relu", name="r0")
    c2 = sym.Convolution(r, kernel=(1, 1), num_filter=4, name="c1")
    b2 = sym.BatchNorm(c2, fix_gamma=False, name="bn1")
    s = b2 + r                                  # bn1 alone: a 1-node region
    f = sym.FullyConnected(sym.flatten(sym.Activation(s, act_type="relu",
                                                      name="r1")),
                           num_hidden=3, name="fc")
    return f


def _props():
    class P:
        name = "bnrelu"

        def select(self, node):
            return node.op in ("BatchNorm", "Activation")

    class JP(P, jsg.SubgraphProperty):
        pass

    class TP(P, tsg.SubgraphProperty):
        pass
    return JP(), TP()


def _norm(js):
    return re.sub(r"_subgraph_bnrelu_\d+", "_subgraph_bnrelu_N", js)


def test_partition_json_equal_jax():
    jp, tp = _props()
    syms = []
    for pkg in (mxj, mx):
        with pkg.name.NameManager():
            syms.append(conv_net(pkg))
    js, ts = syms
    jf, tf = jsg.partition(js, jp), tsg.partition(ts, tp)
    assert _norm(tf.tojson()) == _norm(jf.tojson())
    ops = [n["op"] for n in __import__("json").loads(tf.tojson())["nodes"]]
    assert sum(o.startswith("_subgraph_bnrelu_") for o in ops) == 3
    assert tf.list_auxiliary_states() == ts.list_auxiliary_states()
    assert tf.infer_shape(data=(2, 3, 6, 6)) == \
        ts.infer_shape(data=(2, 3, 6, 6))

    class Nothing(tsg.SubgraphProperty):
        def select(self, node):
            return False
    assert tsg.partition(ts, Nothing()) is ts


def _bind(pkg, sym, vals, aux):
    a = {k: pkg.nd.array(v) for k, v in vals.items()}
    g = {k: pkg.nd.zeros(v.shape) for k, v in vals.items()}
    x = {k: pkg.nd.array(v) for k, v in aux.items()}
    return sym.bind(pkg.cpu(), args=a, args_grad=g, aux_states=x)


def test_partitioned_graph_equals_unfused_and_drops_aux_like_jax():
    """Outputs and gradients of the partitioned graph equal the unfused
    graph's bit for bit (the same ops in the same order); in training
    mode the fused BatchNorms leave their moving statistics as they were,
    in both packages, where the unfused graph updates them."""
    jp, tp = _props()
    rs = np.random.RandomState(6)
    results = {}
    for pkg, sg, prop in ((mxj, jsg, jp), (mx, tsg, tp)):
        with pkg.name.NameManager():
            base = conv_net(pkg)
        fused = sg.partition(base, prop)
        shapes = {"data": (2, 3, 6, 6)}
        arg_shapes, _, aux_shapes = base.infer_shape(**shapes)
        if not results:
            vals = {n: rs.uniform(-1, 1, s).astype(np.float32)
                    for n, s in zip(base.list_arguments(), arg_shapes)}
            aux = {n: (rs.uniform(0.5, 1.5, s) if n.endswith("var")
                       else rs.uniform(-0.2, 0.2, s)).astype(np.float32)
                   for n, s in zip(base.list_auxiliary_states(),
                                   aux_shapes)}
        per = []
        for s in (base, fused):
            ex = _bind(pkg, s, vals, aux)
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward([pkg.nd.ones(out.shape)])
            per.append((out, {k: ex.grad_dict[k].asnumpy() for k in vals},
                        {k: ex.aux_dict[k].asnumpy() for k in aux}))
        results[pkg.__name__] = per
    for name, ((bo, bg, ba), (fo, fg, fa)) in results.items():
        assert np.array_equal(fo, bo), name
        for k in bg:
            assert np.array_equal(fg[k], bg[k]), (name, k)
        for k in aux:
            assert np.array_equal(fa[k], aux[k]), (name, k)  # dropped
            assert not np.array_equal(ba[k], aux[k]), (name, k)
    (jb, jf), (tb, tf) = results["mxnet_tpu"], results["mxnet_tpu_torch"]
    close(tf[0], jf[0], GRAPH_TOL)
    for k in jf[1]:
        # a convolution bias under a BatchNorm has gradient 0 analytically:
        # both leave float residues of ~1e-6, held absolutely
        if np.abs(jf[1][k]).max() < 1e-4:
            assert np.abs(tf[1][k] - jf[1][k]).max() <= 1e-4, k
        else:
            close(tf[1][k], jf[1][k], 1e-4)


def test_partitioned_symbolblock_step_equal_unfused():
    """A narrow NHWC ResNet traced to a symbol, partitioned and run as a
    SymbolBlock for one training step: its loss and every parameter's
    gradient equal the unpartitioned SymbolBlock's bit for bit."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as R
    net = R.ResNetV1(R.BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                     classes=10, thumbnail=True, layout="NHWC", fuse=False)
    net.initialize()
    x = torch.randn(2, 3, 32, 32)
    y = torch.tensor([1.0, 7.0])
    net(x)
    with mx.name.NameManager():
        sym = net(mx.sym.var("data"))
    _, tp = _props()
    fused = tsg.partition(sym, tp)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    res = []
    for s in (sym, fused):
        blk = mx.gluon.SymbolBlock(s, mx.sym.var("data"))
        src = net.collect_params()
        for name, p in blk.collect_params().items():
            p.set_data(src[name]._tensor().detach())
        with mx.autograd.record():
            loss = loss_fn(blk(x), y)
        loss.backward()
        res.append((loss.detach().clone(),
                    {n: p._tensor().grad.clone()
                     for n, p in blk.collect_params().items()
                     if p.grad_req != "null"}))
    assert torch.equal(res[1][0], res[0][0])
    assert sorted(res[1][1]) == sorted(res[0][1]) and res[0][1]
    for n in res[0][1]:
        assert torch.equal(res[1][1][n], res[0][1][n]), n
