"""Every Gluon loss of the port against the JAX package's, on the CPU: the
per-sample values and the gradients of sum(h * loss) (h a fixed random
head) with respect to each differentiable input, JAX's by ``jax.grad``
through its block, the port's by torch autograd under
``autograd.record()``. Each loss with ``weight``, ``sample_weight``,
``batch_axis`` and its modes; CTC with and without lengths, in both
layouts.

Tolerances, f32: values and gradients within 1e-5 of the largest
magnitude of JAX's (the same formula, other summation orders); CTC within
1e-4 (JAX runs the alpha recursion under ``lax.scan``, the port PyTorch's
``ctc_loss``: the same sums in another order over up to 2L+1 states and T
steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx

RTOL = 1e-5
CTC_RTOL = 1e-4


def _rs(seed):
    return np.random.RandomState(seed)


def _f32(a):
    return np.asarray(a, np.float32)


def _close(got, ref, rtol, what):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, "%s: max err %g against %g" % (
        what, err, rtol * scale)


def _check(name, kwargs, args, extra=(), diff=(0,), rtol=RTOL):
    """Loss ``name``(**kwargs) on the numpy arrays ``args`` (differentiated
    at the positions ``diff``) and then ``extra`` (the forward's optional
    arguments in order, None where not given), in both packages."""
    jblock = getattr(mxj.gluon.loss, name)(**kwargs)
    tblock = getattr(mx.gluon.loss, name)(**kwargs)
    jargs = [jnp.asarray(a) for a in args]
    jextra = [None if v is None else mxj.nd.array(v) for v in extra]

    def jloss(*diffed):
        xs = list(jargs)
        for i, d in zip(diff, diffed):
            xs[i] = d
        return jblock(*[mxj.nd.NDArray(x) for x in xs], *jextra)._data

    jval = np.asarray(jloss(*[jargs[i] for i in diff]))
    head = _f32(_rs(99).rand(*jval.shape) + 0.5)
    jgrads = jax.grad(lambda *d: jnp.sum(jloss(*d) * head),
                      argnums=tuple(range(len(diff))))(
        *[jargs[i] for i in diff])
    targs = [torch.from_numpy(np.array(a)) for a in args]
    for i in diff:
        targs[i].requires_grad_()
    textra = [None if v is None else torch.from_numpy(np.array(v))
              for v in extra]
    with mx.autograd.record():
        tval = tblock(*targs, *textra)
    tgrads = torch.autograd.grad((tval * torch.from_numpy(head)).sum(),
                                 [targs[i] for i in diff])
    _close(tval.detach().numpy(), jval, rtol, name + " value")
    for i, tg, jg in zip(diff, tgrads, jgrads):
        _close(tg.numpy(), np.asarray(jg), rtol, "%s grad %d" % (name, i))


B = 4


def _pred_label(seed, shape=(B, 5)):
    rs = _rs(seed)
    return _f32(rs.randn(*shape)), _f32(rs.randn(*shape))


SW = _f32(_rs(7).rand(B, 1) + 0.5)

ELEMENTWISE = [
    ("L2Loss", {}), ("L2Loss", {"weight": 0.5}),
    ("L1Loss", {}), ("L1Loss", {"weight": 2.0}),
    ("HuberLoss", {}), ("HuberLoss", {"rho": 0.3, "weight": 1.5}),
    ("HingeLoss", {}), ("HingeLoss", {"margin": 0.5}),
    ("SquaredHingeLoss", {}), ("SquaredHingeLoss", {"margin": 2}),
    ("LogisticLoss", {}), ("LogisticLoss", {"label_format": "binary"}),
    ("SigmoidBinaryCrossEntropyLoss", {}),
    ("SigmoidBCELoss", {"weight": 0.7}),
]


@pytest.mark.parametrize("sample_weight", [False, True])
@pytest.mark.parametrize("name,kwargs", ELEMENTWISE,
                         ids=["%s-%s" % (n, sorted(k)) for n, k in
                              ELEMENTWISE])
def test_elementwise_losses(name, kwargs, sample_weight):
    pred, label = _pred_label(1)
    if name in ("HingeLoss", "SquaredHingeLoss") or (
            name == "LogisticLoss" and not kwargs):
        label = np.sign(label)
    elif name.startswith("Sigmoid") or kwargs.get("label_format"):
        label = _f32(label > 0)
    _check(name, kwargs, [pred, label], [SW] if sample_weight else [])


def test_batch_axis_and_label_reshape():
    """batch_axis=1 reduces over the other axes; a label of the right size
    but another shape is viewed in pred's."""
    pred, label = _pred_label(2, (3, B, 2))
    _check("L1Loss", {"batch_axis": 1}, [pred, label])
    pred, label = _pred_label(3, (B, 1))
    _check("L2Loss", {}, [pred, label.reshape(B)])


@pytest.mark.parametrize("pos_weight", [False, True])
@pytest.mark.parametrize("from_sigmoid", [False, True])
def test_sigmoid_bce_modes(from_sigmoid, pos_weight):
    rs = _rs(4)
    pred = _f32(rs.randn(B, 3))
    if from_sigmoid:
        pred = _f32(1 / (1 + np.exp(-pred)))
    label = _f32(rs.rand(B, 3) > 0.4)
    extra = [SW, _f32(rs.rand(1, 3) * 2 + 0.5) if pos_weight else None]
    _check("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": from_sigmoid},
           [pred, label], extra)


@pytest.mark.parametrize("kwargs", [{"sparse_label": True},
                                    {"sparse_label": False},
                                    {"from_logits": True, "weight": 0.5}])
def test_softmax_cross_entropy(kwargs):
    rs = _rs(5)
    pred = _f32(rs.randn(B, 6))
    if kwargs.get("sparse_label", True):
        label = _f32(rs.randint(0, 6, B))
    else:
        label = _f32(rs.dirichlet(np.ones(6), B))
    if kwargs.get("from_logits"):
        pred = _f32(pred - np.log(np.exp(pred).sum(1, keepdims=True)))
    _check("SoftmaxCrossEntropyLoss", kwargs, [pred, label], [SW])


@pytest.mark.parametrize("from_logits", [True, False])
def test_kl_div(from_logits):
    rs = _rs(6)
    pred = _f32(rs.randn(B, 5))
    if from_logits:
        pred = _f32(pred - np.log(np.exp(pred).sum(1, keepdims=True)))
    label = _f32(rs.dirichlet(np.ones(5), B))
    _check("KLDivLoss", {"from_logits": from_logits}, [pred, label], [SW])


@pytest.mark.parametrize("kwargs", [{}, {"margin": 0.3, "weight": 2.0}])
def test_triplet(kwargs):
    rs = _rs(8)
    a, p, n = (_f32(rs.randn(B, 6)) for _ in range(3))
    _check("TripletLoss", kwargs, [a, p, n], [SW[:, 0]], diff=(0, 1, 2))


@pytest.mark.parametrize("compute_full", [False, True])
@pytest.mark.parametrize("from_logits", [True, False])
def test_poisson_nll(from_logits, compute_full):
    rs = _rs(9)
    pred = _f32(rs.randn(B, 5))
    if not from_logits:
        pred = _f32(np.exp(pred))
    target = _f32(rs.poisson(2.0, (B, 5)))
    _check("PoissonNLLLoss", {"from_logits": from_logits,
                              "compute_full": compute_full},
           [pred, target], [SW])


@pytest.mark.parametrize("kwargs", [{}, {"margin": 0.2}])
def test_cosine_embedding(kwargs):
    rs = _rs(10)
    a, b = _f32(rs.randn(B, 3, 2)), _f32(rs.randn(B, 3, 2))
    label = _f32([1, -1, 1, -1])
    _check("CosineEmbeddingLoss", kwargs, [a, b, label], diff=(0, 1))


def _ctc_inputs(seed, N=3, T=9, C=6, L=4):
    rs = _rs(seed)
    pred = _f32(rs.randn(N, T, C))
    label = _f32(rs.randint(1, C, (N, L)))
    label[0, 3:] = -1
    label[1, 2:] = -1
    return pred, label


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("lengths", [False, True])
def test_ctc(layout, lengths):
    pred, label = _ctc_inputs(11)
    extra = [_f32([9, 7, 8]), _f32([3, 2, 4])] if lengths else []
    label_layout = "NT"
    if layout == "TNC":
        pred = np.ascontiguousarray(pred.transpose(1, 0, 2))
        label = np.ascontiguousarray(label.T)
        label_layout = "TN"
    _check("CTCLoss", {"layout": layout, "label_layout": label_layout},
           [pred, label], extra, rtol=CTC_RTOL)


def test_ctc_weights_and_registered_names():
    pred, label = _ctc_inputs(12)
    _check("CTCLoss", {"weight": 0.5}, [pred, label],
           [None, None, _f32([1.0, 2.0, 0.5])], rtol=CTC_RTOL)
    from mxnet_tpu_torch.ops import registry as treg
    for name in ("ctc_loss", "CTCLoss", "contrib_ctc_loss"):
        assert treg.get_op(name) is treg.get_op("ctc_loss")
    with mx.cpu():
        out = mx.nd.ctc_loss(mx.nd.array(pred), mx.nd.array(label))
    ref = mxj.nd.ctc_loss(mxj.nd.array(pred), mxj.nd.array(label))
    _close(out.asnumpy(), ref.asnumpy(), CTC_RTOL, "nd.ctc_loss")


def test_every_jax_loss_is_ported():
    assert set(mxj.gluon.loss.__all__) <= set(mx.gluon.loss.__all__)
    for name in mxj.gluon.loss.__all__:
        assert hasattr(mx.gluon.loss, name), name
