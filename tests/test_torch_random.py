"""The port's random state and sampling ops against the JAX package.

JAX draws through threefry keys and torch through its own generators, so
the streams differ by design. Held here, for every op name JAX's
``ops/random_ops.py`` registers (read with a recording ``register``):
the output's shape and dtype against JAX's function on the same
parameters, the broadcasting of the ``sample_*`` parameters, the law of
the draws (the mean of N = 200,000 draws within 6 standard errors of the
law's mean, the variance within 5% of the law's), and the same draws again
under the same ``mx.random.seed``. Then the ``mx.nd.random`` wrappers
against JAX's, the seed's ``ctx`` forms, torch's global RNG left alone,
Dropout's masks (law, scale, axes, reproducibility) and a Dropout inside
a remat region that redraws the same mask in the recompute.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import remat
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.parallel import (ShardedTrainStep, create_mesh,
                                      data_parallel)
from test_torch_nn_ops import _names

NAMES = _names("mxnet_tpu.ops.random_ops", "random")
N = 200_000


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _t(a):
    return torch.tensor(np.asarray(a, dtype="float32"))


class Law:
    """One op's case: ``port(shape)`` and ``jax(key, shape)`` draw; the
    law's mean and variance per parameter row (``rows`` leading entries
    of the output, the rest the draws)."""

    def __init__(self, port, jax_fn, mean, var, dtype="float32"):
        self.port, self.jax, self.mean, self.var = port, jax_fn, mean, var
        self.dtype = dtype


def _laws():
    P = mx.nd.imperative_invoke

    def rnd(name, **kw):
        return Law(lambda jfn, shape: P(name, shape=shape, ctx=mx.cpu(),
                                        **kw),
                   lambda jfn, key, shape: jfn(key=key, shape=shape, **kw),
                   None, None, kw.get("dtype", "float32"))

    def smp(name, params, **kw):
        return Law(lambda jfn, shape: P(name, *[_t(p) for p in params],
                                        shape=shape, **kw),
                   lambda jfn, key, shape: jfn(
                       *[jax.numpy.asarray(p, "float32") for p in params],
                       key=key, shape=shape, **kw),
                   None, None, kw.get("dtype", "float32"))

    laws = {
        "random_uniform": (rnd("random_uniform", low=-1.0, high=3.0),
                           1.0, 16.0 / 12),
        "random_normal": (rnd("random_normal", loc=1.0, scale=2.0), 1.0,
                          4.0),
        "random_gamma": (rnd("random_gamma", alpha=2.5, beta=1.5), 3.75,
                         2.5 * 1.5 ** 2),
        "random_exponential": (rnd("random_exponential", lam=2.0), 0.5,
                               0.25),
        "random_poisson": (rnd("random_poisson", lam=3.5), 3.5, 3.5),
        "random_negative_binomial": (
            rnd("random_negative_binomial", k=3, p=0.4), 3 * 0.6 / 0.4,
            3 * 0.6 / 0.4 ** 2),
        "random_generalized_negative_binomial": (
            rnd("random_generalized_negative_binomial", mu=2.0, alpha=0.5),
            2.0, 2.0 + 0.5 * 4.0),
        "random_randint": (rnd("random_randint", low=-3, high=5,
                               dtype="int32"), 0.5, (8 ** 2 - 1) / 12.0),
        "sample_uniform": (smp("sample_uniform", ([0.0, 10.0],
                                                  [1.0, 14.0])),
                           [0.5, 12.0], [1.0 / 12, 16.0 / 12]),
        "sample_normal": (smp("sample_normal", ([0.0, 5.0], [1.0, 0.5])),
                          [0.0, 5.0], [1.0, 0.25]),
        "sample_gamma": (smp("sample_gamma", ([1.0, 4.0], [2.0, 0.5])),
                         [2.0, 2.0], [4.0, 1.0]),
    }
    out = {}
    for name, (law, mean, var) in laws.items():
        law.mean, law.var = mean, var
        out[name] = law
    return out


LAWS = _laws()
PROBS = np.array([[0.2, 0.3, 0.5], [0.7, 0.2, 0.1]], "float32")
# the names held outside LAWS, by their own tests below
OWN_TESTS = {"sample_multinomial", "shuffle", "bernoulli"}


def _moments_ok(draws, mean, var, what):
    """draws: (rows, N) or (N,); the mean within 6 standard errors, the
    variance within 5%."""
    d = np.asarray(draws, np.float64).reshape(len(np.atleast_1d(mean)), -1)
    for row, m, v in zip(d, np.atleast_1d(mean), np.atleast_1d(var)):
        assert abs(row.mean() - m) <= 6 * np.sqrt(v / row.size), \
            (what, row.mean(), m)
        assert abs(row.var() - v) <= 0.05 * v, (what, row.var(), v)


def _np(o):
    return o.asnumpy() if isinstance(o, mx.nd.NDArray) else o.numpy()


@pytest.mark.parametrize("module,name,canon,jfn", NAMES,
                         ids=["%s-%s" % (m, n) for m, n, *_ in NAMES])
def test_port_op_draws_like_jax(module, name, canon, jfn):
    """Shape and dtype as JAX's, the law, and the same draws under the
    same seed."""
    assert name in treg.list_ops(), name
    assert treg.get_op(name) is treg.get_op(canon)
    if canon in OWN_TESTS:
        assert canon in {"sample_multinomial", "shuffle", "bernoulli"}
        return
    law = LAWS[canon]
    key = jax.random.PRNGKey(0)
    want = law.jax(jfn, key, (3, 4))
    got = law.port(jfn, (3, 4))
    assert tuple(got.shape) == tuple(want.shape), name
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
    mx.random.seed(7)
    draws = law.port(jfn, (N,))
    _moments_ok(_np(draws), law.mean, law.var, name)
    mx.random.seed(7)
    again = law.port(jfn, (N,))
    assert torch.equal(draws, again), name
    mx.random.seed(8)
    assert not torch.equal(draws, law.port(jfn, (N,))), name


def test_sample_params_broadcast_over_shape():
    """The sample_* draws have the parameters' shape, then ``shape``; each
    parameter applies to its own slice."""
    lo = np.array([[0.0, 10.0], [20.0, 30.0]], "float32")
    out = mx.nd.imperative_invoke("sample_uniform", _t(lo), _t(lo + 1.0),
                                  shape=(5, 6))
    assert tuple(out.shape) == (2, 2, 5, 6)
    o = out.numpy()
    assert np.all((o >= lo[..., None, None]) & (o < lo[..., None, None] + 1))
    j = LAWS["sample_uniform"]
    jout = dict((n, f) for _, n, _, f in NAMES)["sample_uniform"](
        jax.numpy.asarray(lo), jax.numpy.asarray(lo + 1.0),
        key=jax.random.PRNGKey(1), shape=(5, 6))
    assert jout.shape == out.shape and j.dtype == "float32"


def test_multinomial_law_and_log_probability():
    jfn = dict((n, f) for _, n, _, f in NAMES)["sample_multinomial"]
    want = jfn(jax.numpy.asarray(PROBS), key=jax.random.PRNGKey(0),
               shape=(3,), get_prob=True)
    got = mx.nd.imperative_invoke("sample_multinomial", _t(PROBS),
                                  shape=(3,), get_prob=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    one = mx.nd.imperative_invoke("sample_multinomial", _t(PROBS))
    assert tuple(one.shape) == (2,) and one.dtype == torch.int32
    mx.random.seed(3)
    draws, logp = mx.nd.imperative_invoke("sample_multinomial", _t(PROBS),
                                          shape=(N,), get_prob=True)
    d = draws.numpy()
    for row, p in zip(d, PROBS):
        freq = np.bincount(row, minlength=3) / N
        assert np.all(np.abs(freq - p) <= 6 * np.sqrt(p * (1 - p) / N))
    lp = np.log(PROBS / PROBS.sum(-1, keepdims=True))
    np.testing.assert_allclose(logp.numpy(),
                               np.take_along_axis(lp, d, -1), rtol=1e-6)
    mx.random.seed(3)
    assert torch.equal(draws, mx.nd.imperative_invoke(
        "sample_multinomial", _t(PROBS), shape=(N,)))


def test_shuffle_permutes_rows():
    x = np.arange(40, dtype="float32").reshape(20, 2)
    jfn = dict((n, f) for _, n, _, f in NAMES)["shuffle"]
    want = jfn(jax.numpy.asarray(x), key=jax.random.PRNGKey(0))
    mx.random.seed(1)
    got = mx.nd.imperative_invoke("shuffle", _t(x)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(np.sort(got[:, 0]), x[:, 0])
    assert np.array_equal(got[:, 1], got[:, 0] + 1)       # rows stay whole
    mx.random.seed(1)
    assert np.array_equal(mx.nd.imperative_invoke("shuffle", _t(x)).numpy(),
                          got)
    firsts = [mx.nd.imperative_invoke("shuffle", _t(x)).numpy()[0, 0]
              for _ in range(2000)]
    counts = np.bincount(np.asarray(firsts, int) // 2, minlength=20)
    assert counts.min() > 0            # every row reaches the front


def test_bernoulli_law():
    jfn = dict((n, f) for _, n, _, f in NAMES)["bernoulli"]
    p = np.full((N,), 0.3, "float32")
    want = jfn(jax.numpy.asarray(p[:6]), key=jax.random.PRNGKey(0))
    got = mx.nd.imperative_invoke("bernoulli", _t(p[:6]))
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    mx.random.seed(4)
    draws = mx.nd.imperative_invoke("bernoulli", _t(p)).numpy()
    assert set(np.unique(draws)) <= {0.0, 1.0}
    _moments_ok(draws, 0.3, 0.21, "bernoulli")


@pytest.mark.parametrize("short", sorted(mx.nd.random.__all__))
def test_nd_random_wrapper_matches_jax(short):
    """``mx.nd.random.<short>`` gives an NDArray of JAX's shape and dtype
    on the context asked for, the same under the same seed."""
    shape = (4, 3)
    kw = {"randint": ((-2, 5), {}), "multinomial": ((), {}),
          "shuffle": ((), {})}.get(short, ((), {}))
    args = kw[0]
    if short == "multinomial":
        jargs, targs = [mxj.nd.array(PROBS)], [mx.nd.array(PROBS)]
    elif short == "shuffle":
        x = np.arange(12, dtype="float32").reshape(4, 3)
        jargs, targs = [mxj.nd.array(x)], [mx.nd.array(x)]
    else:
        jargs = targs = list(args)
    extra = {} if short in ("multinomial", "shuffle") else {"shape": shape}
    if short == "randn":
        want = mxj.nd.random.randn(*shape)
        mx.random.seed(2)
        got = mx.nd.random.randn(*shape, ctx=mx.cpu())
        mx.random.seed(2)
        again = mx.nd.random.randn(*shape, ctx=mx.cpu())
    else:
        want = getattr(mxj.nd.random, short)(*jargs, **extra)
        ctx_kw = {} if short in ("multinomial", "shuffle") \
            else {"ctx": mx.cpu()}
        mx.random.seed(2)
        got = getattr(mx.nd.random, short)(*targs, **extra, **ctx_kw)
        mx.random.seed(2)
        again = getattr(mx.nd.random, short)(*targs, **extra, **ctx_kw)
    assert isinstance(got, mx.nd.NDArray)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.context == mx.cpu()
    assert np.array_equal(got.asnumpy(), again.asnumpy())
    assert sorted(mx.nd.random.__all__) == sorted(mxj.nd.random.__all__)


def test_nd_random_sample_form_and_out():
    """An NDArray parameter picks the sample_* form; ``out=`` takes the
    draw."""
    mu = mx.nd.array(np.array([0.0, 100.0], "float32"))
    z = mx.nd.random.normal(mu, mx.nd.array(np.ones(2, "float32")),
                            shape=(1000,))
    assert z.shape == (2, 1000)
    assert abs(z.asnumpy()[1].mean() - 100.0) < 1.0
    out = mx.nd.zeros((3, 2), ctx=mx.cpu())
    res = mx.nd.random.uniform(2.0, 3.0, shape=(3, 2), ctx=mx.cpu(), out=out)
    assert res is out
    assert np.all((out.asnumpy() >= 2.0) & (out.asnumpy() < 3.0))


def test_default_context_is_the_card():
    """With no context a draw goes to the card, which raises here when no
    CUDA device is present."""
    if torch.cuda.is_available():
        assert mx.nd.random.uniform(shape=(2,)).context == mx.gpu(0)
        return
    from mxnet_tpu_torch.context import Context
    prev = getattr(Context._default, "value", None)
    Context._default.value = None
    try:
        with pytest.raises(mx.MXNetError):
            mx.nd.random.uniform(shape=(2,))
        with pytest.raises(mx.MXNetError):
            mx.random.seed(1, ctx=mx.gpu(0))
    finally:
        Context._default.value = prev


def test_seed_contexts_and_global_rng_untouched():
    """``seed(s)`` seeds every generator; ``seed(s, ctx=mx.cpu())`` only the
    host's; no draw moves torch's global RNG."""
    glob = torch.random.get_rng_state()
    mx.random.seed(9)
    a = torch.rand(4, generator=mx.random.generator())
    mx.random.seed(9, ctx=mx.cpu())
    b = torch.rand(4, generator=mx.random.generator(mx.cpu()))
    assert torch.equal(a, b)
    assert mx.random.generator("cpu") is mx.random.generator()
    mx.nd.random.normal(shape=(100,), ctx=mx.cpu())
    mx.nd.Dropout(mx.nd.ones((10, 10)), p=0.5, mode="always")
    assert torch.equal(torch.random.get_rng_state(), glob)


# -- Dropout -----------------------------------------------------------------

def test_dropout_law_scale_and_reproducibility():
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        1.0, 2.0, (400, 500)).astype("float32"))
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        mx.random.seed(5)
        with mx.autograd.train_mode():
            y = mx.nd.Dropout(xd, p=0.3)
        kept = y != 0
        share = kept.float().mean().item()
        assert abs(share - 0.7) <= 6 * np.sqrt(0.21 / x.numel())
        # kept values are x / 0.7, the divisor rounded to x's dtype first
        # (JAX's weak typing)
        keep = 0.7 if dtype == torch.float32 \
            else torch.tensor(0.7).to(dtype)
        assert torch.equal(y[kept], (xd / keep)[kept])
        mx.random.seed(5)
        with mx.autograd.train_mode():
            assert torch.equal(mx.nd.Dropout(xd, p=0.3), y)
    # outside training Dropout is the identity; axes share one mask
    assert torch.equal(mx.nd.Dropout(x, p=0.3), x)
    with mx.autograd.train_mode():
        y = mx.nd.Dropout(torch.ones(8, 6, 5), p=0.5, axes=(1,))
    assert torch.equal(y, y[:, :1, :].expand_as(y))


def test_dropout_layer_in_gluon():
    net = mx.gluon.nn.Dropout(0.5)
    x = torch.ones(50, 40)
    assert torch.equal(net(x), x)
    with mx.autograd.record():
        y = net(x)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    assert torch.equal(mx.gluon.nn.Dropout(0.0)(x), x)


class _DropNet(mx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.dense = mx.gluon.nn.Dense(6, in_units=6)
        self.drop = mx.gluon.nn.Dropout(0.5)
        self.out = mx.gluon.nn.Dense(3, in_units=6)

    def hybrid_forward(self, F, x):
        return self.out(self.drop(F.relu(self.dense(x))))


def _drop_step(remat_policy):
    net = mx.gluon.nn.HybridSequential()
    net.add(_DropNet())
    net.initialize(ctx=mx.cpu())
    rs = np.random.RandomState(0)
    mx.convert.load_numpy_params(net, {
        "0.dense.weight": rs.uniform(-1, 1, (6, 6)).astype("float32"),
        "0.dense.bias": np.full(6, 0.5, "float32"),
        "0.out.weight": rs.uniform(-1, 1, (3, 6)).astype("float32"),
        "0.out.bias": np.zeros(3, "float32")})
    return ShardedTrainStep(
        net, tloss.SoftmaxCrossEntropyLoss(),
        topt.create("sgd", learning_rate=0.1),
        strategy=data_parallel(create_mesh(devices=[torch.device("cpu")],
                                           dp=1)),
        remat_policy=remat_policy)


def test_dropout_redraws_its_mask_in_the_remat_recompute():
    """A Dropout inside a checkpoint region: the backward's recompute
    draws the first run's mask again, so remat gives the losses and
    weights of no remat bit for bit, and the generators move as far."""
    x = torch.from_numpy(np.random.RandomState(1).rand(16, 6)
                         .astype("float32"))
    y = torch.from_numpy(np.random.RandomState(2).randint(0, 3, (16,))
                         .astype("float32"))
    got = []
    for rp in (None, "conv_outs"):
        mx.random.seed(11)
        step = _drop_step(rp)
        losses = [step(x, y) for _ in range(3)]
        got.append((losses, {k: v.detach().clone()
                             for k, v in step.params.items()},
                    torch.rand(3, generator=mx.random.generator())))
    assert got[0][0] == got[1][0]
    assert all(torch.equal(got[0][1][k], got[1][1][k]) for k in got[0][1])
    assert torch.equal(got[0][2], got[1][2])


def test_replay_restores_the_threads_generators():
    mx.random.seed(3)
    state = mx.random.get_state()
    first = torch.rand(5, generator=mx.random.generator())
    with mx.random.replay(state) as gen:
        assert torch.equal(torch.rand(5, generator=gen), first)
        assert mx.random.generator() is gen
    after = torch.rand(5, generator=mx.random.generator())
    assert not torch.equal(after, first)
    with remat.scope(("conv_out",)):
        assert remat.segmenting()
