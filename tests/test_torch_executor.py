"""The port's ``Executor`` held against the JAX package's on the CPU.

The same symbol, bound in both packages to the same seeded numpy
arguments: ``simple_bind``/``bind``, forward in both modes, backward with
``grad_req`` write, add and null, explicit head gradients, ``reshape``,
``copy_params_from``, ``eval``, the monitor callback, and a conv +
BatchNorm graph in training mode with its moving statistics. Outputs and
moving statistics within 1e-5, gradients within 1e-4 (f32, relative to
each tensor's largest value).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx

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


def both(fn):
    out = []
    for pkg in (mxj, mx):
        with pkg.name.NameManager():
            out.append(fn(pkg))
    return out


def mlp(pkg):
    sym = pkg.sym
    fc1 = sym.FullyConnected(sym.var("data"), num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=5, name="fc2")
    return sym.SoftmaxOutput(fc2, sym.var("softmax_label"), name="softmax")


def conv_bn(pkg):
    sym = pkg.sym
    c = sym.Convolution(sym.var("data"), kernel=(3, 3), num_filter=6,
                        pad=(1, 1), no_bias=True, name="conv")
    b = sym.BatchNorm(c, fix_gamma=False, momentum=0.8, eps=1e-3,
                      name="bn")
    r = sym.Activation(b, act_type="relu")
    p = sym.Pooling(r, kernel=(2, 2), stride=(2, 2), pool_type="avg")
    f = sym.FullyConnected(sym.Flatten(p), num_hidden=3, name="fc")
    return sym.SoftmaxOutput(f, sym.var("softmax_label"), name="softmax")


def values(sym, shapes, seed=0, classes=5):
    """Seeded numpy values for every argument and aux state."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n == "softmax_label":
            args[n] = rs.randint(0, classes, s).astype(np.float32)
        else:
            args[n] = rs.uniform(-0.5, 0.5, s).astype(np.float32)
    aux = {}
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = (rs.uniform(0.5, 1.5, s) if n.endswith("var")
                  else rs.uniform(-0.1, 0.1, s)).astype(np.float32)
    return args, aux


def bind(pkg, sym, args, aux, grad_req="write", ctx=None):
    nd = pkg.nd
    ctx = ctx or pkg.cpu()
    a = {k: nd.array(v, ctx=ctx) for k, v in args.items()}
    g = {k: nd.zeros(v.shape, ctx=ctx) for k, v in args.items()}
    x = {k: nd.array(v, ctx=ctx) for k, v in aux.items()}
    return sym.bind(ctx, args=a, args_grad=g, grad_req=grad_req,
                    aux_states=x)


def test_simple_bind_allocates_like_jax():
    js, ts = both(mlp)
    je = js.simple_bind(mxj.cpu(), data=(4, 7), softmax_label=(4,))
    te = ts.simple_bind(mx.cpu(), data=(4, 7), softmax_label=(4,))
    assert sorted(te.arg_dict) == sorted(je.arg_dict)
    assert sorted(te.grad_dict) == sorted(je.grad_dict)
    for n in je.arg_dict:
        assert te.arg_dict[n].shape == je.arg_dict[n].shape
        assert np.all(te.arg_dict[n].asnumpy() == 0)
    assert [a.shape for a in te.arg_arrays] == \
        [a.shape for a in je.arg_arrays]
    te2 = ts.simple_bind(mx.cpu(), grad_req="null", data=(4, 7),
                         softmax_label=(4,))
    assert te2.grad_dict == {}


@pytest.mark.parametrize("is_train", [False, True])
def test_forward_backward_write_matches_jax(is_train):
    js, ts = both(mlp)
    args, aux = values(js, {"data": (6, 7), "softmax_label": (6,)})
    je, te = bind(mxj, js, args, aux), bind(mx, ts, args, aux)
    jo = je.forward(is_train=is_train)
    to = te.forward(is_train=is_train)
    close(to[0].asnumpy(), jo[0].asnumpy(), FWD_TOL)
    assert list(te.output_dict) == list(je.output_dict)
    je.backward()
    te.backward()
    close(te.outputs[0].asnumpy(), je.outputs[0].asnumpy(), FWD_TOL)
    for n in ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias", "data"):
        close(te.grad_dict[n].asnumpy(), je.grad_dict[n].asnumpy(),
              GRAD_TOL)


def test_grad_req_add_and_null_match_jax():
    js, ts = both(mlp)
    args, aux = values(js, {"data": (6, 7), "softmax_label": (6,)}, seed=1)
    req = {"data": "null", "fc1_weight": "add", "fc1_bias": "add",
           "fc2_weight": "write", "fc2_bias": "null",
           "softmax_label": "null"}
    je, te = bind(mxj, js, args, aux, req), bind(mx, ts, args, aux, req)
    for _ in range(3):
        je.forward(is_train=True)
        je.backward()
        te.forward(is_train=True)
        te.backward()
    for n in ("fc1_weight", "fc1_bias", "fc2_weight"):
        close(te.grad_dict[n].asnumpy(), je.grad_dict[n].asnumpy(),
              GRAD_TOL)
    for n in ("data", "fc2_bias"):
        assert np.all(te.grad_dict[n].asnumpy() == 0)
        assert np.all(je.grad_dict[n].asnumpy() == 0)


def test_explicit_head_gradient_matches_jax():
    def net(pkg):
        sym = pkg.sym
        fc = sym.FullyConnected(sym.var("data"), num_hidden=4, name="fc")
        return sym.Group([sym.tanh(fc), fc * 2])
    js, ts = both(net)
    args, aux = values(js, {"data": (3, 5)}, seed=2)
    rs = np.random.RandomState(3)
    heads = [rs.randn(3, 4).astype(np.float32) for _ in range(2)]
    je, te = bind(mxj, js, args, aux), bind(mx, ts, args, aux)
    je.forward(is_train=True)
    je.backward([mxj.nd.array(h) for h in heads])
    te.forward(is_train=True)
    te.backward([mx.nd.array(h) for h in heads])
    for n in ("fc_weight", "fc_bias", "data"):
        close(te.grad_dict[n].asnumpy(), je.grad_dict[n].asnumpy(),
              GRAD_TOL)


def test_backward_without_forward_runs_one():
    js, ts = both(mlp)
    args, aux = values(js, {"data": (4, 7), "softmax_label": (4,)}, seed=4)
    je, te = bind(mxj, js, args, aux), bind(mx, ts, args, aux)
    je.backward()
    te.backward()
    close(te.grad_dict["fc1_weight"].asnumpy(),
          je.grad_dict["fc1_weight"].asnumpy(), GRAD_TOL)
    close(te.outputs[0].asnumpy(), je.outputs[0].asnumpy(), FWD_TOL)


def test_conv_batchnorm_training_matches_jax():
    js, ts = both(conv_bn)
    shapes = {"data": (4, 2, 6, 6), "softmax_label": (4,)}
    args, aux = values(js, shapes, seed=5, classes=3)
    je, te = bind(mxj, js, args, aux), bind(mx, ts, args, aux)
    assert te.aux_dict.keys() == je.aux_dict.keys()
    for _ in range(2):
        jo = je.forward(is_train=True)
        to = te.forward(is_train=True)
        close(to[0].asnumpy(), jo[0].asnumpy(), FWD_TOL)
        je.backward()
        te.backward()
    for n in je.aux_dict:
        close(te.aux_dict[n].asnumpy(), je.aux_dict[n].asnumpy(), FWD_TOL)
    for n in ("conv_weight", "bn_gamma", "bn_beta", "fc_weight", "data"):
        close(te.grad_dict[n].asnumpy(), je.grad_dict[n].asnumpy(),
              GRAD_TOL)
    # inference uses (and leaves) the moving statistics
    before = {n: a.asnumpy() for n, a in te.aux_dict.items()}
    close(te.forward(is_train=False)[0].asnumpy(),
          je.forward(is_train=False)[0].asnumpy(), FWD_TOL)
    for n, a in te.aux_dict.items():
        np.testing.assert_array_equal(a.asnumpy(), before[n])


def test_training_forward_outputs_equal_backward_outputs():
    """The outputs read after forward(is_train=True) are the ones backward
    differentiates (the same Dropout mask), as in the JAX package."""
    sym = mx.sym
    net = sym.Dropout(sym.FullyConnected(sym.var("data"), num_hidden=8),
                      p=0.5)
    exe = net.simple_bind(mx.cpu(), data=(4, 6))
    x = np.random.RandomState(3).randn(4, 6).astype("float32")
    o1 = exe.forward(is_train=True, data=x)[0].asnumpy()
    exe.backward()
    np.testing.assert_array_equal(exe.outputs[0].asnumpy(), o1)
    assert exe._pending is None       # the graph is released


def test_reshape_shares_parameters_like_jax():
    js, ts = both(mlp)
    args, aux = values(js, {"data": (6, 7), "softmax_label": (6,)}, seed=6)
    je, te = bind(mxj, js, args, aux), bind(mx, ts, args, aux)
    je2 = je.reshape(data=(3, 7), softmax_label=(3,))
    te2 = te.reshape(data=(3, 7), softmax_label=(3,))
    assert te2.arg_dict["fc1_weight"] is te.arg_dict["fc1_weight"]
    assert te2.arg_dict["data"] is not te.arg_dict["data"]
    x = np.random.RandomState(7).randn(3, 7).astype(np.float32)
    close(te2.forward(data=x)[0].asnumpy(),
          je2.forward(data=mxj.nd.array(x))[0].asnumpy(), FWD_TOL)


def test_copy_params_from_and_eval_match_jax():
    js, ts = both(mlp)
    args, aux = values(js, {"data": (5, 7), "softmax_label": (5,)}, seed=8)
    je = js.simple_bind(mxj.cpu(), data=(5, 7), softmax_label=(5,))
    te = ts.simple_bind(mx.cpu(), data=(5, 7), softmax_label=(5,))
    je.copy_params_from({k: mxj.nd.array(v) for k, v in args.items()})
    te.copy_params_from({k: mx.nd.array(v) for k, v in args.items()})
    close(te.forward()[0].asnumpy(), je.forward()[0].asnumpy(), FWD_TOL)
    with pytest.raises(mx.MXNetError):
        te.copy_params_from({"nope": mx.nd.zeros((1,))})
    te.copy_params_from({"nope": mx.nd.zeros((1,))},
                        allow_extra_params=True)
    jv = js.eval(mxj.cpu(), **{k: mxj.nd.array(v) for k, v in args.items()})
    tv = ts.eval(mx.cpu(), **{k: mx.nd.array(v) for k, v in args.items()})
    close(tv[0].asnumpy(), jv[0].asnumpy(), FWD_TOL)


def test_monitor_callback_sees_every_output():
    js, ts = both(mlp)
    args, aux = values(js, {"data": (2, 7), "softmax_label": (2,)})
    seen = {"j": [], "t": []}
    je, te = bind(mxj, js, args, aux), bind(mx, ts, args, aux)
    je.set_monitor_callback(lambda n, a: seen["j"].append(n))
    te.set_monitor_callback(lambda n, a: seen["t"].append(n))
    for e in (je, te):
        e.forward()
        e.forward(is_train=True)
    assert seen["t"] == seen["j"] == ["softmax_output"] * 2


def test_unbound_and_unknown_arguments_raise():
    ts = mlp(mx)
    with pytest.raises(mx.MXNetError):
        ts.bind(mx.cpu(), args={"data": mx.nd.zeros((2, 7))})
    exe = ts.simple_bind(mx.cpu(), data=(2, 7), softmax_label=(2,))
    with pytest.raises(mx.MXNetError):
        exe.forward(nope=np.zeros(1))


def test_group2ctx_raises_until_several_devices_are_ported():
    ts = mlp(mx)
    with pytest.raises(mx.MXNetError, match="M10"):
        ts.simple_bind(mx.cpu(), group2ctx={"dev1": mx.cpu(0)},
                       data=(2, 7), softmax_label=(2,))


def test_bind_defaults_to_the_card():
    """The executor runs on gpu(0) unless given a context: with no CUDA
    device that raises instead of running on the host."""
    ts = mlp(mx)
    with mx.gpu(0):
        if torch.cuda.is_available():
            exe = ts.simple_bind(data=(2, 7), softmax_label=(2,))
            assert exe.arg_dict["data"]._data.is_cuda
            return
        with pytest.raises(mx.MXNetError, match="CUDA"):
            ts.simple_bind(data=(2, 7), softmax_label=(2,))


def test_input_less_ops_build_on_the_executor_context():
    """Ops without a tensor input (zeros, ones, random draws, _arange)
    build on the executor's context; shapes and dtypes as JAX's."""
    def net(pkg):
        return pkg.sym.Group([pkg.sym.zeros((2, 3)), pkg.sym.ones((3,)),
                              pkg.sym.random.uniform(0, 1, shape=(4,)),
                              pkg.sym._arange(start=0, stop=5)])
    js, ts = both(net)
    jo, to = js.eval(mxj.cpu()), ts.eval(mx.cpu())
    assert [o.shape for o in to] == [o.shape for o in jo]
    assert [str(o.dtype) for o in to] == [str(o.dtype) for o in jo]
    for i in (0, 1, 3):
        np.testing.assert_array_equal(to[i].asnumpy(), jo[i].asnumpy())
    u = to[2].asnumpy()
    assert ((u >= 0) & (u < 1)).all()
    assert ts.infer_shape() == js.infer_shape()
