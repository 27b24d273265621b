"""Every op name that the JAX package's ``ops/nn.py`` registers, held
against the port's op of that name on the same numpy inputs, with the
gradient against ``jax.vjp`` (the fused ``RNN`` here on one float32 case;
its modes and gradients are in ``test_torch_rnn.py``).

The names come from running the JAX module's source with a recording
``register`` (``test_torch_elemwise_tensor_ops._capture``), so the
reference is the module's own function and a name the port lacks fails
here. Each case runs the port through ``mx.nd.imperative_invoke`` on
NDArrays and the JAX function on jnp arrays, in float32 and, where the op
takes float data, in bf16; an alias, which must be the same op as its
name, runs its first case in float32. Ops that take ``_training`` get it explicitly
(the JAX function's default is True; the port's dispatch reads the
autograd state).

Tolerances, each relative to the largest magnitude of the JAX result:
- float32 forward: 1e-5 (``F32``);
- bf16 forward: 1.6e-2 (``BF16``), a bf16 step of the output. Pooling's
  bf16 sums differ in order (XLA:CPU's reduce_window adds in bf16, torch's
  avg_pool in float32), which stays inside it;
- float32 gradients: 1e-5 (``GRAD_F32``); 1e-4 (``GRAD_NORM``) for the
  normalization layers, whose gradients subtract the mean of products
  over the normalized axes, so two summation orders differ by more;
- index outputs and deterministic shape ops: bit for bit.
Dtypes must agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg
from test_torch_elemwise_tensor_ops import _capture

F32 = 1e-5
BF16 = 1.6e-2
GRAD_F32 = 1e-5
GRAD_NORM = 1e-4
LEFT_OUT = {}


def _names(modname, short):
    """[(module, name, canonical name, fn)] with aliases, the last
    registration of a name winning."""
    last = {}
    for name, aliases, _, fn in _capture(modname):
        for n in (name,) + aliases:
            last[n] = (short, n, name, fn)
    return list(last.values())


NAMES = [e for e in _names("mxnet_tpu.ops.nn", "nn")
         if e[2] not in LEFT_OUT]


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def U(rs, shape, lo=-2.0, hi=2.0):
    return rs.uniform(lo, hi, shape).astype("float32")


class Spec:
    """Cases of one op: ``make(rs)`` gives [(args, kwargs)]; numpy arrays
    among them are the op's arrays (``idx``: positions or keyword names of
    index data, never cast to bf16 or differentiated); ``bf16`` whether
    the op takes bf16 data; ``grad`` whether to hold the gradient;
    ``gtol`` its bound; ``check(got, want, args, kwargs, tol, what)`` in
    place of the elementwise comparison, for results unique only up to
    sign."""

    def __init__(self, make, idx=(), bf16=True, grad=True, gtol=GRAD_F32,
                 exact=False, check=None):
        self.make, self.idx, self.bf16 = make, tuple(idx), bf16
        self.grad, self.gtol, self.exact = grad, gtol, exact
        self.check = check


def _arrays(args, kwargs, spec, dtype, to):
    """args and kwargs with each numpy array converted by ``to(a, dt)``:
    float data in ``dtype``, index data in float32."""
    def conv(key, a):
        if not isinstance(a, np.ndarray):
            return a
        return to(a, "float32" if key in spec.idx else dtype)
    return ([conv(i, a) for i, a in enumerate(args)],
            {k: conv(k, v) for k, v in kwargs.items()})


def _np_out(o):
    if isinstance(o, mx.nd.NDArray):
        return o.asnumpy()
    if isinstance(o, torch.Tensor):
        return o.detach().float().numpy() if o.dtype == torch.bfloat16 \
            else o.detach().numpy()
    return np.asarray(o)


def _as_list(o):
    return list(o) if isinstance(o, (tuple, list)) else [o]


def compare(got, want, tol, what):
    got, want = _as_list(got), _as_list(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        ga, wa = _np_out(g), np.asarray(w)
        assert ga.shape == wa.shape, (what, ga.shape, wa.shape)
        assert str(ga.dtype) == str(wa.dtype), (what, ga.dtype, wa.dtype)
        g64, w64 = ga.astype(np.float64), wa.astype(np.float64)
        if tol == 0.0:
            assert np.array_equal(g64, w64, equal_nan=True), (what, ga, wa)
        else:
            # NaN where the JAX result has it (an avg window over padding
            # alone divides 0 by 0), the rest within the bound
            nan = np.isnan(w64)
            assert np.array_equal(np.isnan(g64), nan), what
            g64, w64 = g64[~nan], w64[~nan]
            scale = max(np.abs(w64).max(initial=0.0), 1e-30)
            err = np.abs(g64 - w64).max(initial=0.0)
            assert err <= tol * scale, (what, err, tol * scale)


def _compare_only(got, want, args, kwargs, tol, what):
    compare(got, want, tol, what)


def grad_check(name, jfn, spec, args, kwargs, what):
    """float32 gradients of sum(out * cot) for the float array arguments,
    against jax.vjp."""
    pos = [i for i, a in enumerate(args)
           if isinstance(a, np.ndarray) and i not in spec.idx]
    if not pos:
        return
    jargs, jkw = _arrays(args, kwargs, spec, "float32", jnp.asarray)

    def f(*xs):
        full = list(jargs)
        for i, x in zip(pos, xs):
            full[i] = x
        return jfn(*full, **jkw)

    jout, vjp = jax.vjp(f, *[jargs[i] for i in pos])
    outs = _as_list(jout)
    rs = np.random.RandomState(11)
    cots = [rs.uniform(-1, 1, np.shape(o)).astype(np.asarray(o).dtype)
            for o in outs]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots)
                 if isinstance(jout, (tuple, list)) else jnp.asarray(cots[0]))
    targs, tkw = _arrays(args, kwargs, spec, "float32",
                         lambda a, dt: mx.nd.array(a, dtype=dt))
    for i in pos:
        targs[i].attach_grad()
    with mx.autograd.record():
        out = mx.nd.imperative_invoke(name, *targs, **tkw)
    heads = _as_list(out)
    mx.autograd.backward(heads, [mx.nd.array(c) for c in cots])
    for i, jg in zip(pos, jgrads):
        compare(targs[i].grad, jg, spec.gtol, what + " grad %d" % i)


def run_spec(name, jfn, spec, seed, full=True):
    """Every case of ``spec``: forward in float32 (and bf16), then the
    float32 gradient; with ``full`` False (an alias of a name held in
    full) the first case's float32 forward only."""
    cases = spec.make(np.random.RandomState(seed))
    if not full:
        cases = cases[:1]
    dtypes = ("float32", "bfloat16") if spec.bf16 and full else ("float32",)
    for dtype in dtypes:
        for n, (args, kwargs) in enumerate(cases):
            what = "%s %s case %d %s" % (name, dtype, n, kwargs)
            jargs, jkw = _arrays(args, kwargs, spec, dtype, jnp.asarray)
            targs, tkw = _arrays(args, kwargs, spec, dtype,
                                 lambda a, dt: mx.nd.array(a, dtype=dt))
            want = jfn(*jargs, **jkw)
            got = mx.nd.imperative_invoke(name, *targs, **tkw)
            tol = 0.0 if spec.exact else (F32 if dtype == "float32"
                                          else BF16)
            (spec.check or _compare_only)(got, want, args, kwargs, tol, what)
    if spec.grad and full:
        for n, (args, kwargs) in enumerate(cases):
            grad_check(name, jfn, spec, args, kwargs,
                       "%s case %d %s" % (name, n, kwargs))


# -- the cases ---------------------------------------------------------------

def _fc(rs):
    return [((U(rs, (2, 3, 4)), U(rs, (5, 12)), U(rs, (5,))),
             {"num_hidden": 5}),
            ((U(rs, (2, 3, 4)), U(rs, (5, 4)), U(rs, (5,))),
             {"num_hidden": 5, "flatten": False}),
            ((U(rs, (3, 6)), U(rs, (4, 6))),
             {"num_hidden": 4, "no_bias": True, "precision": "float32"})]


def _conv(rs):
    return [((U(rs, (2, 3, 7, 7)), U(rs, (4, 3, 3, 3)), U(rs, (4,))),
             {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "num_filter": 4}),
            ((U(rs, (2, 7, 7, 3)), U(rs, (4, 3, 1, 1))),
             {"kernel": (1, 1), "stride": (2, 2), "num_filter": 4,
              "no_bias": True, "layout": "NHWC"}),
            ((U(rs, (2, 6, 6, 4)), U(rs, (4, 2, 3, 3)), U(rs, (4,))),
             {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4,
              "num_group": 2, "layout": "NHWC"}),
            ((U(rs, (2, 4, 9)), U(rs, (6, 2, 3))),
             {"kernel": (3,), "dilate": (2,), "num_filter": 6,
              "num_group": 2, "no_bias": True}),
            ((U(rs, (1, 2, 5, 5, 5)), U(rs, (3, 2, 3, 3, 3)), U(rs, (3,))),
             {"kernel": (3, 3, 3), "pad": (1, 1, 1), "num_filter": 3,
              "precision": "highest"})]


def _deconv(rs):
    return [((U(rs, (2, 4, 5, 5)), U(rs, (4, 3, 3, 3)), U(rs, (3,))),
             {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "adj": (1, 1), "num_filter": 3, "no_bias": False}),
            ((U(rs, (2, 5, 5, 4)), U(rs, (4, 3, 3, 3))),
             {"kernel": (3, 3), "stride": (2, 2), "num_filter": 3,
              "layout": "NHWC"}),
            # adj not below the stride: the fractionally-strided form
            ((U(rs, (2, 4, 4, 4)), U(rs, (4, 3, 3, 3))),
             {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "adj": (2, 2), "num_filter": 3}),
            ((U(rs, (2, 4, 5, 5)), U(rs, (4, 2, 3, 3))),
             {"kernel": (3, 3), "stride": (2, 2), "num_filter": 4,
              "num_group": 2}),
            ((U(rs, (2, 3, 6)), U(rs, (3, 2, 3))),
             {"kernel": (3,), "dilate": (2,), "adj": (1,),
              "num_filter": 2}),
            ((U(rs, (1, 2, 3, 3, 3)), U(rs, (2, 2, 2, 2, 2))),
             {"kernel": (2, 2, 2), "stride": (2, 2, 2), "num_filter": 2})]


def _pool(rs):
    x = U(rs, (2, 3, 7, 8))
    xl = U(rs, (2, 7, 8, 3))
    out = []
    for kw in ({"pool_type": "max", "kernel": (3, 3), "stride": (2, 2),
                "pad": (1, 1)},
               {"pool_type": "max", "kernel": (3, 3), "stride": (2, 2),
                "pooling_convention": "full"},
               {"pool_type": "avg", "kernel": (3, 3), "stride": (2, 2),
                "pad": (1, 1)},
               {"pool_type": "avg", "kernel": (3, 3), "stride": (2, 2),
                "pad": (1, 1), "count_include_pad": False},
               {"pool_type": "avg", "kernel": (3, 2), "stride": (2, 3),
                "pad": (1, 1), "pooling_convention": "full"},
               {"pool_type": "avg", "kernel": (3, 2), "stride": (2, 3),
                "pad": (1, 1), "pooling_convention": "full",
                "count_include_pad": False},
               {"pool_type": "sum", "kernel": (2, 2), "stride": (2, 2)},
               {"pool_type": "sum", "kernel": (3, 3), "stride": (2, 2),
                "pooling_convention": "full"},
               {"pool_type": "lp", "kernel": (2, 2), "stride": (1, 1),
                "pad": (1, 1), "p_value": 2},
               {"pool_type": "lp", "kernel": (3, 3), "stride": (2, 2),
                "pooling_convention": "full", "p_value": 3},
               {"pool_type": "max", "global_pool": True},
               {"pool_type": "avg", "global_pool": True},
               {"pool_type": "sum", "global_pool": True},
               {"pool_type": "lp", "global_pool": True, "p_value": 2}):
        out.append(((x,), kw))
        out.append(((xl,), dict(kw, layout="NHWC")))
    out.append(((U(rs, (2, 3, 9)),), {"pool_type": "avg", "kernel": (3,),
                                      "stride": (2,), "pad": (1,),
                                      "count_include_pad": False}))
    out.append(((U(rs, (1, 2, 5, 6, 7)),),
                {"pool_type": "avg", "kernel": (2, 3, 2),
                 "stride": (2, 2, 2), "pooling_convention": "full"}))
    out.append(((U(rs, (1, 5, 6, 7, 2)),),
                {"pool_type": "max", "kernel": (3, 3, 3),
                 "stride": (2, 2, 2), "pad": (1, 1, 1), "layout": "NDHWC"}))
    return out


def _act(rs):
    return [((U(rs, (3, 5)),), {"act_type": t})
            for t in ("relu", "sigmoid", "tanh", "softrelu", "softsign")]


def _leaky(rs):
    x = U(rs, (2, 3, 4, 4))
    return [((x,), {"act_type": "leaky", "slope": 0.1}),
            ((x, U(rs, (3,), 0.1, 0.5)), {"act_type": "prelu"}),
            ((x,), {"act_type": "elu", "slope": 0.7}),
            ((x,), {"act_type": "selu"}),
            ((x,), {"act_type": "gelu"}),
            ((x,), {"act_type": "rrelu"})]


def _softmax(rs):
    x = U(rs, (2, 5, 3))
    return [((x,), {}), ((x,), {"axis": 1, "temperature": 2.0}),
            ((U(rs, (3, 6)),), {"use_length": True,
                                "length": np.array([2, 6, 4], "float32")})]


def _log_softmax(rs):
    x = U(rs, (2, 5, 3))
    return [((x,), {}), ((x,), {"axis": 1, "temperature": 0.5})]


def _labels(rs, n, classes):
    return rs.randint(0, classes, (n,)).astype("float32")


def _sce(rs):
    return [((U(rs, (4, 5)), _labels(rs, 4, 5)), {})]


def _softmax_output(rs):
    x, lbl = U(rs, (6, 5)), _labels(rs, 6, 5)
    ign = lbl.copy()
    ign[1] = ign[4] = 2.0
    return [((x, lbl), {}),
            ((x, lbl), {"grad_scale": 2.0, "normalization": "batch"}),
            ((x, ign), {"use_ignore": True, "ignore_label": 2.0,
                        "normalization": "valid"}),
            ((x, lbl), {"normalization": "valid"}),
            ((x, lbl), {"smooth_alpha": 0.1}),
            ((x, lbl), {"out_grad": True}),
            ((U(rs, (2, 3, 4)), rs.randint(0, 3, (2, 4)).astype("float32")),
             {"multi_output": True})]


def _regression(rs):
    return [((U(rs, (4, 3)), U(rs, (4, 3))), {}),
            ((U(rs, (4, 3)), U(rs, (12,))), {"grad_scale": 0.5}),
            ((U(rs, (5,)), U(rs, (5,))), {"grad_scale": 3.0})]


def _bn(rs):
    def params(c):
        return (U(rs, (c,), 0.5, 1.5), U(rs, (c,), -0.5, 0.5),
                U(rs, (c,), -0.5, 0.5), U(rs, (c,), 0.5, 2.0))
    return [((U(rs, (4, 3, 5, 5)),) + params(3),
             {"fix_gamma": False, "_training": True}),
            ((U(rs, (4, 5, 5, 3)),) + params(3),
             {"fix_gamma": False, "axis": -1, "_training": True}),
            ((U(rs, (4, 3, 5, 5)),) + params(3),
             {"fix_gamma": True, "_training": False})]


def _layer_norm(rs):
    return [((U(rs, (3, 4, 5)), U(rs, (5,), 0.5, 1.5), U(rs, (5,))), {}),
            ((U(rs, (3, 4, 5)), U(rs, (4,), 0.5, 1.5), U(rs, (4,))),
             {"axis": 1, "eps": 1e-3}),
            ((U(rs, (3, 6)), U(rs, (6,), 0.5, 1.5), U(rs, (6,))),
             {"output_mean_var": True})]


def _instance_norm(rs):
    return [((U(rs, (2, 3, 4, 5)), U(rs, (3,), 0.5, 1.5), U(rs, (3,))),
             {}),
            ((U(rs, (2, 3, 7)), U(rs, (3,), 0.5, 1.5), U(rs, (3,))),
             {"eps": 1e-5})]


def _group_norm(rs):
    return [((U(rs, (2, 6, 4, 4)), U(rs, (6,), 0.5, 1.5), U(rs, (6,))),
             {"num_groups": 3}),
            ((U(rs, (2, 4, 5)), U(rs, (4,), 0.5, 1.5), U(rs, (4,))), {})]


def _l2(rs):
    x = U(rs, (2, 3, 4, 5))
    return [((x,), {}), ((x,), {"mode": "channel"}),
            ((x,), {"mode": "spatial", "eps": 1e-6})]


def _lrn(rs):
    return [((U(rs, (2, 7, 3, 3)),), {}),
            ((U(rs, (2, 4, 3, 3)),), {"nsize": 3, "alpha": 1e-2,
                                      "beta": 0.5, "knorm": 1.0})]


def _dropout(rs):
    # the deterministic forms: outside training, and p = 0 (the masks'
    # law and reproducibility are held in tests/test_torch_random.py)
    x = U(rs, (3, 4))
    return [((x,), {"p": 0.5, "_training": False}),
            ((x,), {"p": 0.0, "_training": True})]


def _upsampling(rs):
    return [((U(rs, (2, 3, 4, 4)),), {"scale": 2}),
            ((U(rs, (2, 3, 4, 4)), U(rs, (2, 2, 2, 2))),
             {"scale": 2, "num_args": 2})]


def _bilinear(rs):
    return [((U(rs, (2, 3, 5, 6)), U(rs, (2, 2, 4, 4), -1.2, 1.2)), {})]


def _grid(rs):
    return [((U(rs, (2, 6), -1.0, 1.0),), {"target_shape": (4, 5)}),
            ((U(rs, (2, 2, 4, 5)),), {"transform_type": "warp"})]


def _rnn(rs):
    # one LSTM layer, T 3, N 2, I 2, H 3: the packed vector is 4 * 3 *
    # (2 + 3 + 2) long
    return [((U(rs, (3, 2, 2)), U(rs, (84,), -0.5, 0.5), U(rs, (1, 2, 3)),
              U(rs, (1, 2, 3))),
             {"mode": "lstm", "state_size": 3, "state_outputs": True})]


SPECS = {
    "FullyConnected": Spec(_fc),
    "Convolution": Spec(_conv),
    "Deconvolution": Spec(_deconv),
    "Pooling": Spec(_pool),
    "Activation": Spec(_act),
    "LeakyReLU": Spec(_leaky),
    "softmax": Spec(_softmax, idx=("length",)),
    "log_softmax": Spec(_log_softmax),
    "softmin": Spec(lambda rs: [((U(rs, (3, 5)),), {}),
                                ((U(rs, (3, 5)),), {"axis": 0})]),
    "softmax_cross_entropy": Spec(_sce, idx=(1,)),
    "SoftmaxOutput": Spec(_softmax_output, idx=(1,)),
    "LinearRegressionOutput": Spec(_regression, idx=(1,)),
    "MAERegressionOutput": Spec(_regression, idx=(1,)),
    "LogisticRegressionOutput": Spec(_regression, idx=(1,)),
    "BatchNorm": Spec(_bn, gtol=GRAD_NORM),
    "LayerNorm": Spec(_layer_norm, gtol=GRAD_NORM),
    "InstanceNorm": Spec(_instance_norm, gtol=GRAD_NORM),
    "GroupNorm": Spec(_group_norm, gtol=GRAD_NORM),
    "L2Normalization": Spec(_l2, gtol=GRAD_NORM),
    "LRN": Spec(_lrn),
    "Dropout": Spec(_dropout, exact=True),
    "UpSampling": Spec(_upsampling, exact=True),
    "BilinearSampler": Spec(_bilinear),
    "GridGenerator": Spec(_grid),
    "RNN": Spec(_rnn, bf16=False, grad=False),
}


@pytest.mark.parametrize("module,name,canon,jfn", NAMES,
                         ids=["%s-%s" % (m, n) for m, n, *_ in NAMES])
def test_port_op_matches_jax(module, name, canon, jfn):
    """A name in full; an alias, the same op as its name, on one case."""
    assert name in treg.list_ops(), name
    assert treg.get_op(name) is treg.get_op(canon)     # the same aliases
    run_spec(name, jfn, SPECS[canon], sum(map(ord, canon)), name == canon)


def test_left_out_names_are_not_registered():
    """The names left for a later slice are JAX names the port lacks."""
    jax_names = {c for _, _, c, _ in _names("mxnet_tpu.ops.nn", "nn")}
    for name in LEFT_OUT:
        assert name in jax_names and name not in treg.list_ops()


# -- the loss heads' gradients against the reference's rules -----------------

def test_softmax_output_backward_ignores_the_head_gradient():
    """A bare backward() on SoftmaxOutput gives (softmax - onehot) *
    grad_scale / batch, whatever gradient the head is given."""
    rs = np.random.RandomState(0)
    x = mx.nd.array(U(rs, (4, 3)))
    lbl = mx.nd.array(np.array([0, 2, 1, 2], "float32"))
    x.attach_grad()
    with mx.autograd.record():
        out = mx.nd.SoftmaxOutput(x, lbl, grad_scale=3.0,
                                  normalization="batch")
    out.backward(mx.nd.array(U(rs, (4, 3))))
    want = (out.asnumpy() - np.eye(3, dtype="float32")[[0, 2, 1, 2]]) \
        * 3.0 / 4
    np.testing.assert_allclose(x.grad.asnumpy(), want, rtol=1e-6, atol=1e-7)


def test_precision_argument_runs_under_the_policy():
    """``precision`` sets the port's policy for the product and restores
    it after."""
    before = mx.precision.get_matmul_precision()
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(mx.precision.get_matmul_precision())
        return real(a, b)
    torch.matmul = spy
    try:
        mx.nd.FullyConnected(torch.ones(2, 3), torch.ones(4, 3), None,
                             num_hidden=4, no_bias=True,
                             precision="float32")
    finally:
        torch.matmul = real
    assert seen == ["float32"]
    assert mx.precision.get_matmul_precision() == before
    with pytest.raises(ValueError):
        mx.nd.FullyConnected(torch.ones(2, 3), torch.ones(4, 3), None,
                             num_hidden=4, no_bias=True, precision="tf16")
