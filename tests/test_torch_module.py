"""The port's Module API (``mx.mod``, ``mx.model``) held against the JAX
package's on the CPU.

- ``Module`` on the MNIST example's MLP, its LeNet and a narrow NCHW
  ResNet V1 (BatchNorm in training mode), from the same initial parameters
  (``set_params`` from JAX's numpy) and the same batches: outputs,
  parameters, moving statistics and SGD-momentum states after 4
  forward/backward/update steps within 1e-4 (f32, relative to each
  tensor's largest value).
- ``fit`` with ``score`` and ``predict``; ``save_checkpoint`` /
  ``load_checkpoint`` and ``Module.load`` across the packages (the files
  byte for byte), optimizer states through a checkpoint; ``BucketingModule``
  sharing its parameters (JAX ``tests/test_module.py:212-252``); the
  aux-only init; ``rescale_grad = 1/batch``; ``reshape``;
  ``FeedForward``; ``do_checkpoint`` and ``module_checkpoint`` from
  ``fit``; several contexts and the default context without a card raise.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx

TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def np_of(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else \
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else \
        np.asarray(v)


def both(fn):
    out = []
    for pkg in (mxj, mx):
        with pkg.name.NameManager():
            out.append(fn(pkg))
    return out


def mlp(pkg, hidden=32, classes=4):
    sym = pkg.sym
    fc1 = sym.FullyConnected(sym.var("data"), num_hidden=hidden, name="fc1")
    act1 = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act1, num_hidden=classes, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.var("softmax_label"), name="softmax")


def lenet(pkg):
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


def narrow_resnet(pkg):
    """A narrow NCHW ResNet V1 traced into a symbol (BatchNorm in both
    Module steps' training mode)."""
    from importlib import import_module
    res = import_module(pkg.__name__ + ".gluon.model_zoo.vision.resnet")
    net = res.ResNetV1(res.BasicBlockV1, [1, 1, 1, 1], [8, 8, 16, 32, 64],
                       classes=10, thumbnail=True, prefix="narrow_")
    return pkg.sym.SoftmaxOutput(net(pkg.sym.var("data")), name="softmax")


NETS = {"mlp": (mlp, (8, 10), 4), "lenet": (lenet, (8, 1, 28, 28), 10),
        "narrow_resnet": (narrow_resnet, (8, 3, 32, 32), 10)}


def init_values(sym, data_shape, seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"data": data_shape}
    if "softmax_label" in sym.list_arguments():
        shapes["softmax_label"] = data_shape[:1]
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)

    def draw(name, shape):
        if name.endswith("gamma"):
            return rs.uniform(0.8, 1.2, shape)
        if len(shape) == 1:                       # biases, beta
            return rs.uniform(-0.1, 0.1, shape)
        bound = np.sqrt(3.0 / np.prod(shape[1:]))  # variance 1 / fan-in
        return rs.uniform(-bound, bound, shape)
    arg = {n: draw(n, s).astype(np.float32)
           for n, s in zip(sym.list_arguments(), arg_shapes)
           if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if n.endswith("var") else np.zeros(s)).astype(
        np.float32) for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return arg, aux


def batches(data_shape, classes, n, seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(-1, 1, data_shape).astype(np.float32),
             rs.randint(0, classes, data_shape[0]).astype(np.float32))
            for _ in range(n)]


def make_module(pkg, sym, data_shape, arg, aux, optimizer_params):
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", (data_shape[0],))])
    mod.set_params({k: pkg.nd.array(v) for k, v in arg.items()},
                   {k: pkg.nd.array(v) for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=optimizer_params)
    return mod


@pytest.mark.parametrize("net", sorted(NETS))
def test_four_module_steps_match_jax(net):
    build, data_shape, classes = NETS[net]
    js, ts = both(build)
    arg, aux = init_values(js, data_shape)
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
    jm = make_module(mxj, js, data_shape, arg, aux, opt)
    tm = make_module(mx, ts, data_shape, arg, aux, opt)
    for x, y in batches(data_shape, classes, 4):
        for pkg, mod in ((mxj, jm), (mx, tm)):
            mod.forward(pkg.io.DataBatch([pkg.nd.array(x)],
                                         [pkg.nd.array(y)]), is_train=True)
            mod.backward()
            mod.update()
        close(tm.get_outputs()[0].asnumpy(), jm.get_outputs()[0].asnumpy())
    (ja, jx), (ta, tx) = jm.get_params(), tm.get_params()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for n in ja:
        close(ta[n].asnumpy(), ja[n].asnumpy())
    for n in jx:
        close(tx[n].asnumpy(), jx[n].asnumpy())
    assert sorted(tm._updater.states) == sorted(jm._updater.states)
    for i, s in jm._updater.states.items():
        close(np_of(tm._updater.states[i]), np_of(s))
    assert tm._optimizer.rescale_grad == jm._optimizer.rescale_grad \
        == 1.0 / data_shape[0]


def _fit(pkg, sym, arg, aux, x, y, prefix):
    it = pkg.io.NDArrayIter(x, y, batch_size=16)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
            aux_params={k: pkg.nd.array(v) for k, v in aux.items()},
            epoch_end_callback=pkg.callback.do_checkpoint(prefix),
            batch_end_callback=pkg.callback.Speedometer(16, 2))
    return mod, it


def test_fit_score_predict_match_jax(tmp_path):
    js, ts = both(mlp)
    arg, aux = init_values(js, (16, 10))
    rs = np.random.RandomState(2)
    x = rs.uniform(-1, 1, (64, 10)).astype(np.float32)
    y = rs.randint(0, 4, 64).astype(np.float32)
    jm, jit = _fit(mxj, js, arg, aux, x, y, str(tmp_path / "j"))
    tm, tit = _fit(mx, ts, arg, aux, x, y, str(tmp_path / "t"))
    ja, ta = jm.get_params()[0], tm.get_params()[0]
    for n in ja:
        close(ta[n].asnumpy(), ja[n].asnumpy())
    js_, ts_ = dict(jm.score(jit, "acc")), dict(tm.score(tit, "acc"))
    assert ts_ == js_
    close(tm.predict(tit).asnumpy(), jm.predict(jit).asnumpy())
    outs = [o[0].asnumpy() for o, _, _ in tm.iter_predict(tit)]
    close(np.concatenate(outs), jm.predict(jit).asnumpy())
    for name in ("-symbol.json", "-0001.params", "-0002.params"):
        assert os.path.exists(str(tmp_path / "t") + name), name
    assert open(str(tmp_path / "t") + "-symbol.json").read() == \
        open(str(tmp_path / "j") + "-symbol.json").read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_load_across_packages(tmp_path, writer):
    js, ts = both(lenet)
    data_shape = (4, 1, 28, 28)
    arg, aux = init_values(js, data_shape, seed=3)
    wpkg, wsym = (mxj, js) if writer == "jax" else (mx, ts)
    prefix = str(tmp_path / "ck")
    wpkg.model.save_checkpoint(prefix, 7, wsym,
                               {k: wpkg.nd.array(v) for k, v in arg.items()},
                               {})
    x = np.random.RandomState(4).uniform(-1, 1, data_shape).astype(
        np.float32)
    outs = []
    for pkg in (mxj, mx):
        sym, a, x_ = pkg.model.load_checkpoint(prefix, 7)
        assert sorted(a) == sorted(arg) and x_ == {}
        mod = pkg.mod.Module.load(prefix, 7, context=pkg.cpu())
        mod.bind([("data", data_shape)], [("softmax_label", (4,))],
                 for_training=False)
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x)],
                                     [pkg.nd.zeros((4,))]), is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    close(outs[1], outs[0], 1e-5)
    # a checkpoint written by the other package is the same bytes
    other = mx if writer == "jax" else mxj
    osym = ts if writer == "jax" else js
    other.model.save_checkpoint(prefix + "2", 7, osym,
                                {k: other.nd.array(v)
                                 for k, v in arg.items()}, {})
    for suffix in ("-symbol.json", "-0007.params"):
        assert open(prefix + suffix, "rb").read() == \
            open(prefix + "2" + suffix, "rb").read()


def test_module_checkpoint_with_optimizer_states(tmp_path):
    """Module.save_checkpoint with states, Module.load with states: the
    reloaded module's next step equals the original's."""
    sym = mlp(mx)
    arg, aux = init_values(sym, (8, 10), seed=5)
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    mod = make_module(mx, sym, (8, 10), arg, aux, opt)
    data = [(mx.nd.array(x), mx.nd.array(y))
            for x, y in batches((8, 10), 4, 3, seed=6)]

    def step(m, i):
        m.forward(mx.io.DataBatch([data[i][0]], [data[i][1]]))
        m.backward()
        m.update()
    for i in range(2):
        step(mod, i)
    prefix = str(tmp_path / "m")
    cb = mx.callback.module_checkpoint(mod, prefix,
                                       save_optimizer_states=True)
    cb(1)
    assert os.path.exists(prefix + "-0002.states")
    mod2 = mx.mod.Module.load(prefix, 2, load_optimizer_states=True,
                              context=mx.cpu())
    mod2.bind([("data", (8, 10))], [("softmax_label", (8,))])
    mod2.init_optimizer(optimizer="sgd", optimizer_params=opt)
    step(mod, 2)
    step(mod2, 2)
    for n, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(mod2.get_params()[0][n].asnumpy(),
                                      v.asnumpy())


def _bucket_run(pkg):
    def sym_gen(seq_len):
        sym = pkg.sym
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        pooled = sym.mean(data, axis=1, keepdims=True, name="pool")
        fc = sym.FullyConnected(pooled, num_hidden=3, name="fc")
        out = sym.SoftmaxOutput(fc, label, name="softmax")
        return out, ("data",), ("softmax_label",)

    mod = pkg.mod.BucketingModule(sym_gen, default_bucket_key=16,
                                  context=pkg.cpu())
    mod.bind(data_shapes=[("data", (4, 16))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(arg_params={"fc_weight": pkg.nd.array(
        np.linspace(-1, 1, 3).reshape(3, 1).astype(np.float32)),
        "fc_bias": pkg.nd.zeros((3,))})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(0)
    outs = []
    for seq_len in (16, 8, 16, 8):
        batch = pkg.io.DataBatch(
            data=[pkg.nd.array(rng.uniform(size=(4, seq_len)))],
            label=[pkg.nd.array(rng.randint(0, 3, (4,)))],
            bucket_key=seq_len,
            provide_data=[pkg.io.DataDesc("data", (4, seq_len))],
            provide_label=[pkg.io.DataDesc("softmax_label", (4,))])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    return mod, outs


def test_bucketing_module_shares_parameters_like_jax():
    (jm, jo), (tm, to) = both(_bucket_run)
    for t, j in zip(to, jo):
        assert t.shape == (4, 3)
        close(t, j)
    assert len(tm._buckets) == 2
    e16 = tm._buckets[16]._exec_group.executor
    e8 = tm._buckets[8]._exec_group.executor
    assert e16.arg_dict["fc_bias"] is e8.arg_dict["fc_bias"]
    assert e16.arg_dict["fc_weight"] is e8.arg_dict["fc_weight"]
    for n, v in jm.get_params()[0].items():
        close(tm.get_params()[0][n].asnumpy(), v.asnumpy())


def test_init_params_arg_only_initializes_aux():
    def run(pkg):
        d = pkg.sym.Variable("data")
        b = pkg.sym.BatchNorm(pkg.sym.FullyConnected(d, num_hidden=4),
                              name="bn")
        m = pkg.mod.Module(b, label_names=None, context=pkg.cpu())
        m.bind([("data", (2, 8))], for_training=False)
        m.init_params()
        args, _ = m.get_params()
        m2 = pkg.mod.Module(b, label_names=None, context=pkg.cpu())
        m2.bind([("data", (2, 8))], for_training=False)
        m2.init_params(arg_params=dict(args))
        return m2.get_params()[1]
    jx, tx = both(run)
    assert sorted(tx) == sorted(jx)
    np.testing.assert_array_equal(tx["bn_moving_var"].asnumpy(), 1.0)
    np.testing.assert_array_equal(tx["bn_moving_mean"].asnumpy(), 0.0)


def test_init_optimizer_rescales_by_batch_size():
    sym = mlp(mx)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind([("data", (32, 10))], [("softmax_label", (32,))])
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    assert abs(mod._optimizer.rescale_grad - 1.0 / 32) < 1e-12
    assert mod._kvstore is None and not mod._update_on_kvstore
    mod2 = mx.mod.Module(sym, context=mx.cpu())
    mod2.bind([("data", (32, 10))], [("softmax_label", (32,))])
    mod2.init_params()
    mod2.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1,
                                          "rescale_grad": 1.0})
    assert mod2._optimizer.rescale_grad == 1.0


def test_reshape_caches_executors_and_input_grads():
    sym = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=4)
    m = mx.mod.Module(sym, label_names=None, context=mx.cpu())
    m.bind([("data", (8, 6))], for_training=True, inputs_need_grad=True)
    m.init_params()
    g_a = m._exec_group
    m.reshape([("data", (5, 6))])
    g_b = m._exec_group
    assert g_b is not g_a
    m.reshape([("data", (8, 6))])
    assert m._exec_group is g_a
    m.forward(mx.io.DataBatch([mx.nd.ones((3, 6))], None), is_train=True)
    assert m.get_outputs()[0].shape == (3, 4)
    m.backward([mx.nd.ones((3, 4))])
    grads = m.get_input_grads()
    assert grads[0].shape == (3, 6)
    w = m.get_params()[0]
    want = np.ones((3, 4)) @ w[sorted(w)[-1]].asnumpy()
    close(grads[0].asnumpy(), want, 1e-6)


def test_feedforward_matches_jax(tmp_path):
    rs = np.random.RandomState(0)
    x = rs.randn(40, 8).astype("float32")
    y = (x.sum(1) > 0).astype("float32")
    arg = {"fc_weight": rs.uniform(-0.3, 0.3, (2, 8)).astype(np.float32),
           "fc_bias": np.zeros(2, np.float32)}
    preds = []
    for pkg in (mxj, mx):
        net = pkg.sym.SoftmaxOutput(
            pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=2,
                                   name="fc"),
            pkg.sym.var("softmax_label"), name="softmax")
        hits = []
        ff = pkg.model.FeedForward(
            net, ctx=pkg.cpu(), num_epoch=2,
            arg_params={k: pkg.nd.array(v) for k, v in arg.items()})
        ff.fit(x, y, eval_data=(x, y),
               eval_end_callback=lambda *a: hits.append("eval"),
               batch_end_callback=lambda *a: hits.append("batch"))
        assert "eval" in hits and "batch" in hits
        preds.append(ff.predict(x))
        ff.save(str(tmp_path / pkg.__name__))
        ff2 = pkg.model.FeedForward.load(str(tmp_path / pkg.__name__), 2,
                                         ctx=pkg.cpu())
        assert sorted(ff2.arg_params) == sorted(arg)
    close(preds[1], preds[0])


def test_several_contexts_raise_until_several_devices_are_ported():
    sym = mlp(mx)
    mod = mx.mod.Module(sym, context=[mx.cpu(0), mx.cpu(1)])
    with pytest.raises(mx.MXNetError, match="M10"):
        mod.bind([("data", (8, 10))], [("softmax_label", (8,))])


def test_module_defaults_to_the_card():
    """Module runs on gpu(0) unless given a context (the JAX package's
    default is the CPU): with no CUDA device that raises."""
    sym = mlp(mx)
    if torch.cuda.is_available():
        assert mx.mod.Module(sym)._context == [mx.gpu(0)]
        return
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.mod.Module(sym)
    with pytest.raises(mx.MXNetError, match="CUDA"):
        mx.model.FeedForward(sym, num_epoch=1).fit(
            np.zeros((4, 10), np.float32), np.zeros(4, np.float32))
