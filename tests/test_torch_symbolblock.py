"""The port's deployment path held against the JAX package's on the CPU:
``gluon.SymbolBlock``, ``HybridBlock.export``/``infer_shape``/
``optimize_for``, ``Predictor`` and ``mx.jit.CachedOp``, and the ``meta``
branches that shape inference takes through the kernel wrappers.

- A channels-last ResNet-18 v1 traced and saved by the JAX package
  (``Symbol.save`` and ``export``) and imported in the port with
  ``SymbolBlock.imports``: inference within 1e-5; a training-mode forward
  and backward at batch 8 (the port's BatchNorm takes the kernel
  wrapper's plain version, single-pass statistics; JAX's its plain
  two-pass tree) with gradients within 1e-4 and moving statistics within
  1e-5 (f32, relative to each tensor's largest value).
- ``Predictor`` from JAX checkpoint bytes against JAX's ``Predictor``,
  with ``output_keys`` and ``reshape``.
- ``CachedOp``'s ``calls``, ``compiles`` and ``static_shape`` as JAX's.
- ``export`` writes JAX's JSON and ``.params`` bytes.
- Each kernel wrapper's meta branch gives empty outputs of the kernel's
  shapes and dtypes.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
from mxnet_tpu_torch.kernels import box_nms as NMS
from mxnet_tpu_torch.kernels import conv_fused as CF

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _zoo_net(pkg, layout):
    net = pkg.gluon.model_zoo.vision.resnet18_v1(layout=layout, classes=10,
                                                 prefix="rn_")
    net.initialize(pkg.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2), ctx=pkg.cpu())
    return net


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """A channels-last ResNet-18 v1 (10 classes), initialized, traced and
    exported by the JAX package; moving statistics made non-trivial."""
    d = tmp_path_factory.mktemp("rn")
    net = _zoo_net(mxj, "NHWC")
    x = mxj.nd.array(np.random.RandomState(0).uniform(
        -1, 1, (2, 3, 32, 32)).astype(np.float32))
    net(x)                                      # finishes deferred init
    rs = np.random.RandomState(1)
    for name, p in net.collect_params().items():
        if name.endswith("running_mean"):
            p.set_data(mxj.nd.array(rs.uniform(-0.1, 0.1, p.shape)))
        elif name.endswith("running_var"):
            p.set_data(mxj.nd.array(rs.uniform(0.5, 1.5, p.shape)))
    with mxj.name.NameManager():
        net(mxj.sym.var("data")).save(str(d / "rn-symbol-graph.json"))
    net.export(str(d / "rn"))
    return d


def _imports(pkg, d, **kw):
    return pkg.gluon.SymbolBlock.imports(str(d / "rn-symbol-graph.json"),
                                         ["data"], str(d / "rn-0000.params"),
                                         **kw)


def test_symbolblock_inference_matches_jax(jax_saved):
    jb = _imports(mxj, jax_saved)
    tb = _imports(mx, jax_saved, ctx=mx.cpu())
    assert sorted(tb.collect_params()) == sorted(jb.collect_params())
    x = np.random.RandomState(2).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    close(tb(mx.nd.array(x)).asnumpy(), jb(mxj.nd.array(x)).asnumpy(),
          FWD_TOL)


def test_symbolblock_training_step_matches_jax(jax_saved):
    x = np.random.RandomState(3).uniform(-1, 1, (8, 3, 32, 32)).astype(
        np.float32)
    y = np.arange(8, dtype=np.float32)
    res = []
    for pkg, kw in ((mxj, {}), (mx, {"ctx": mx.cpu()})):
        blk = _imports(pkg, jax_saved, **kw)
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            loss = loss_fn(blk(pkg.nd.array(x)), pkg.nd.array(y))
        loss.backward()
        params = blk.collect_params()
        grads = {n: p.grad().asnumpy() for n, p in params.items()
                 if p.grad_req != "null"}
        stats = {n: p.data().asnumpy() for n, p in params.items()
                 if n.endswith(("running_mean", "running_var"))}
        res.append((loss.asnumpy(), grads, stats))
    (jl, jg, js), (tl, tg, ts) = res
    close(tl, jl, FWD_TOL)
    assert sorted(tg) == sorted(jg) and len(tg) == 62
    for n in jg:
        close(tg[n], jg[n], GRAD_TOL)
    assert sorted(ts) == sorted(js) and len(ts) == 40
    for n in js:
        close(ts[n], js[n], FWD_TOL)


def test_symbolblock_matches_the_net_it_came_from(jax_saved):
    """The port's own zoo net and a SymbolBlock of its trace give the same
    training step: loss, gradients and moving statistics bit for bit (the
    same ops in the same order)."""
    tnet = _zoo_net(mx, "NHWC")
    x = np.random.RandomState(4).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    tnet(mx.nd.array(x))
    with mx.name.NameManager():
        tnet(mx.sym.var("data")).save(str(jax_saved / "t-graph.json"))
    tnet.export(str(jax_saved / "t"))
    blk = mx.gluon.SymbolBlock.imports(str(jax_saved / "t-graph.json"),
                                       ["data"],
                                       str(jax_saved / "t-0000.params"),
                                       ctx=mx.cpu())
    y = mx.nd.array(np.arange(2, dtype=np.float32))
    out = []
    for net in (tnet, blk):
        with mx.autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                net(mx.nd.array(x)), y)
        loss.backward()
        ps = net.collect_params()
        out.append((loss.asnumpy(),
                    {n: (p.data().asnumpy(), p.grad().asnumpy()
                         if p.grad_req != "null" else None)
                     for n, p in ps.items()}))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert sorted(out[1][1]) == sorted(out[0][1])
    for n, (d, g) in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][n][0], d)
        if g is not None:
            np.testing.assert_array_equal(out[1][1][n][1], g)


def test_export_writes_jax_files(tmp_path):
    """The same parameter values in both nets: export's JSON and .params
    are JAX's byte for byte."""
    nets = [_zoo_net(pkg, "NCHW") for pkg in (mxj, mx)]
    x = np.zeros((1, 3, 32, 32), np.float32)
    nets[0](mxj.nd.array(x))
    nets[1](mx.nd.array(x))
    rs = np.random.RandomState(5)
    jp, tp = nets[0].collect_params(), nets[1].collect_params()
    assert sorted(jp) == sorted(tp)
    for n in jp:
        v = rs.uniform(-1, 1, jp[n].shape).astype(np.float32)
        jp[n].set_data(mxj.nd.array(v))
        tp[n].set_data(mx.nd.array(v))
    nets[0].export(str(tmp_path / "j"), epoch=3)
    nets[1].export(str(tmp_path / "t"), epoch=3)
    for suffix in ("-symbol.json", "-0003.params"):
        assert (tmp_path / ("t" + suffix)).read_bytes() == \
            (tmp_path / ("j" + suffix)).read_bytes(), suffix


def test_infer_shape_and_optimize_for_match_jax():
    """The port's infer_shape finishes deferred initialization with the
    shapes a JAX forward gives. (JAX's own infer_shape leaks a tracer on
    deferred parameters, so its side finishes them by a forward.)"""
    shapes = []
    for pkg in (mxj, mx):
        net = pkg.gluon.nn.HybridSequential(prefix="s_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Conv2D(6, 3), pkg.gluon.nn.BatchNorm(),
                    pkg.gluon.nn.Dense(4))
        net.initialize(ctx=pkg.cpu())
        if pkg is mxj:
            net(pkg.nd.zeros((2, 3, 8, 8)))
        else:
            net.infer_shape(pkg.nd.zeros((2, 3, 8, 8)))
            assert all(p._data is not None
                       for p in net.collect_params().values())
        shapes.append({n: p.shape for n, p in
                       net.collect_params().items()})
        out = net.optimize_for(pkg.nd.ones((2, 3, 8, 8)))
        assert out.shape == (2, 4)
    assert shapes[1] == shapes[0]


def _lenet_checkpoint(d):
    sym = mxj.sym
    data = sym.Variable("data")
    c1 = sym.Convolution(data, kernel=(3, 3), num_filter=6, name="conv1")
    a1 = sym.Activation(c1, act_type="tanh", name="act1")
    p1 = sym.Pooling(a1, pool_type="max", kernel=(2, 2), stride=(2, 2),
                     name="pool1")
    fc1 = sym.FullyConnected(sym.Flatten(p1), num_hidden=10, name="fc1")
    net = sym.SoftmaxOutput(fc1, sym.Variable("softmax_label"),
                            name="softmax")
    rs = np.random.RandomState(6)
    arg_shapes, _, _ = net.infer_shape(data=(2, 1, 12, 12),
                                       softmax_label=(2,))
    arg = {n: mxj.nd.array(rs.uniform(-0.5, 0.5, s).astype(np.float32))
           for n, s in zip(net.list_arguments(), arg_shapes)
           if n not in ("data", "softmax_label")}
    mxj.model.save_checkpoint(str(d / "lenet"), 1, net, arg, {})
    return (open(str(d / "lenet-symbol.json")).read(),
            open(str(d / "lenet-0001.params"), "rb").read())


@pytest.mark.parametrize("output_keys", [None, "act1", ["pool1", "fc1"]])
def test_predictor_matches_jax(tmp_path, output_keys):
    text, params = _lenet_checkpoint(tmp_path)
    x = np.random.RandomState(7).uniform(-1, 1, (2, 1, 12, 12)).astype(
        np.float32)
    jp = mxj.predictor.Predictor(
        text, params, input_shapes={"data": (2, 1, 12, 12)},
        output_keys="act1" if output_keys == "act1" else None)
    tp = mx.Predictor(text, params, dev_type=mx.cpu(),
                      input_shapes={"data": (2, 1, 12, 12)},
                      output_keys=output_keys)
    tp.set_input("data", x)
    tp.forward()
    if output_keys == ["pool1", "fc1"]:
        # JAX's Predictor takes one key; each output against its own
        for i, key in enumerate(output_keys):
            jk = mxj.predictor.Predictor(
                text, params, input_shapes={"data": (2, 1, 12, 12)},
                output_keys=key)
            jk.set_input("data", x)
            jk.forward()
            close(tp.get_output(i), jk.get_output(0), FWD_TOL)
        return
    jp.set_input("data", x)
    jp.forward()
    close(tp.get_output(0), jp.get_output(0), FWD_TOL)
    assert tp.get_output_shape(0) == jp.get_output_shape(0)
    tp.reshape({"data": (3, 1, 12, 12)})
    jp.reshape({"data": (3, 1, 12, 12)})
    x3 = np.concatenate([x, x[:1]])
    for p in (tp, jp):
        p.set_input("data", x3)
        p.forward()
    close(tp.get_output(0), jp.get_output(0), FWD_TOL)
    assert tp.get_output_shape(0) == jp.get_output_shape(0)
    with pytest.raises(ValueError):
        tp.set_input("data", x)
    with pytest.raises(KeyError):
        tp.set_input("nope", x)


def test_predictor_from_checkpoint_and_c_abi(tmp_path):
    _lenet_checkpoint(tmp_path)
    p = mx.Predictor.from_checkpoint(str(tmp_path / "lenet"), 1,
                                     {"data": (2, 1, 12, 12)},
                                     dev_type=mx.cpu())
    with pytest.raises(RuntimeError):
        p.get_output(0)
    p.forward()
    assert p.get_output(0).shape == (2, 10)
    from mxnet_tpu_torch import predictor
    with pytest.raises(mx.MXNetError, match="M11"):
        predictor._c_create("{}", b"", [], [])


def test_cached_op_contract_matches_jax():
    results = []
    for pkg in (mxj, mx):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        op = pkg.jit.CachedOp(pkg.sym.tanh(a * b + 1))
        x = pkg.nd.array(np.linspace(-1, 1, 6).reshape(2, 3))
        y1 = op(x, x)
        op(x, x)
        op(pkg.nd.ones((4, 3)), pkg.nd.ones((4, 3)))
        static = pkg.jit.CachedOp(lambda u: u * 2, static_shape=True)
        static(x)
        with pytest.raises(ValueError):
            static(pkg.nd.ones((5,)))

        @pkg.jit.jit
        def f(u, v):
            return u + v, u - v
        s, d = f(x, x)
        results.append((op.calls, op.compiles, static.calls,
                        static.compiles, y1.asnumpy(), s.asnumpy(),
                        d.asnumpy(), f.calls, f.__name__))
    (j, t) = results
    assert t[:4] == j[:4] == (3, 2, 2, 2)
    close(t[4], j[4], FWD_TOL)
    np.testing.assert_array_equal(t[5], j[5])
    np.testing.assert_array_equal(t[6], j[6])
    assert t[7:] == j[7:]


def test_symbolblock_defaults_to_the_card(jax_saved):
    if torch.cuda.is_available():
        blk = _imports(mx, jax_saved)
        assert next(iter(blk.collect_params().values()))._tensor().is_cuda
        return
    with mx.gpu(0):
        with pytest.raises(mx.MXNetError, match="CUDA"):
            _imports(mx, jax_saved)


def test_get_symbol_and_calib_graph_raise_as_in_jax():
    for pkg in (mxj, mx):
        with pytest.raises(NotImplementedError):
            pkg.autograd.get_symbol(pkg.nd.ones((1,)))
        with pytest.raises(NotImplementedError):
            pkg.contrib.quantization.calib_graph(None, {}, {}, None)


# -- the kernel wrappers' meta branches (shape inference) ---------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_wrappers_meta_branch(dtype):
    R, C = 96, 40
    x2, dy2 = _meta(R, C, dtype=dtype), _meta(R, C, dtype=dtype)
    g, b = _meta(C), _meta(C)
    mean, var = BNF.stats(x2)
    assert (mean.shape, var.shape, mean.dtype, mean.is_meta) == \
        ((C,), (C,), torch.float32, True)
    out = BNF.apply(x2, g, b, mean, var, act="relu")
    assert (out.shape, out.dtype, out.is_meta) == ((R, C), dtype, True)
    db, dg = BNF.bwd_reduce(x2, dy2, g, b, mean, var)
    assert (db.shape, dg.shape, db.dtype) == ((C,), (C,), torch.float32)
    dx = BNF.bwd_dx(x2, dy2, g, b, mean, var, db, dg)
    assert (dx.shape, dx.dtype, dx.is_meta) == ((R, C), dtype, True)
    y, m, v = BNF.fused_batch_norm(_meta(2, 4, 12, C, dtype=dtype), g, b)
    assert (y.shape, y.dtype, m.shape, v.dtype) == \
        ((2, 4, 12, C), dtype, (C,), torch.float32)
    before = (BNF.LAUNCHES_STATS, BNF.LAUNCHES_APPLY)
    assert (BNF.LAUNCHES_STATS, BNF.LAUNCHES_APPLY) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_fused_meta_branch(dtype):
    x = _meta(2, 7, 9, 16, dtype=dtype)
    s, b = _meta(16), _meta(16)
    w = _meta(3, 3, 16, 24, dtype=dtype)
    y = CF.fused_scale_relu_conv3x3(x, s, b, w)
    assert (y.shape, y.dtype, y.is_meta) == ((2, 7, 9, 24), dtype, True)
    dx, ds, db, dw = CF.fused_conv_backward(x, s, b, w,
                                            _meta(2, 7, 9, 24, dtype=dtype))
    assert (dx.shape, ds.shape, db.shape, dw.shape) == \
        ((2, 7, 9, 16), (16,), (16,), (3, 3, 16, 24))


def test_box_nms_meta_branch():
    keep = NMS.keep(_meta(3, 50, 4), None, torch.tensor([50, 20, 0]), 0.5)
    assert (keep.shape, keep.dtype, keep.is_meta) == \
        ((3, 50), torch.bool, True)


def test_a_channels_last_batchnorm_node_infers_through_the_kernel_wrapper():
    """A training-mode BatchNorm over the trailing axis takes the kernel
    wrapper (its meta branch) in shape inference."""
    s = mx.sym.BatchNorm(mx.sym.var("x"), axis=-1, name="bn")
    assert s.infer_shape(x=(2, 5, 5, 8)) == \
        ([(2, 5, 5, 8), (8,), (8,)], [(2, 5, 5, 8)], [(8,), (8,)])
