"""The port's ``ops/misc_tail.py`` held against the JAX package's on the
CPU, from the same numpy inputs: ``hawkesll`` (its value, state and
gradients with respect to mu, alpha, beta and the state, 1e-5 / 1e-4 of
each tensor's largest value), ``count_sketch`` (1e-6),
``index_array`` (exact), ``IdentityAttachKLSparseReg`` (identity forward,
its penalty gradient within 1e-6), the three NumPy windows (1e-6) and
``_rnn_param_concat`` (exact); each under its registered names and as
``nd`` functions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import misc_tail as jmt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import misc_tail as tmt
from mxnet_tpu_torch.ops import registry as treg


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def test_every_name_is_registered():
    names = ["_contrib_hawkesll", "hawkesll", "_contrib_count_sketch",
             "count_sketch", "_contrib_index_array", "index_array",
             "IdentityAttachKLSparseReg", "identity_attach_kl_sparse_reg",
             "_npi_hanning", "hanning", "_npi_hamming", "hamming",
             "_npi_blackman", "blackman", "_rnn_param_concat"]
    for name in names:
        assert jreg.get_op(name).fn.__name__ == \
            treg.get_op(name).fn.__name__, name
        assert callable(getattr(mx.nd, name)) and \
            callable(getattr(mx.sym, name))


def test_hawkesll_and_its_gradient():
    rs = np.random.RandomState(0)
    n, k, t = 3, 2, 6
    arrs = [(rs.rand(n, k) + 0.2).astype("f"), (rs.rand(k) * 0.5).astype("f"),
            (rs.rand(k) + 0.5).astype("f"), rs.rand(n, k).astype("f"),
            (rs.rand(n, t) + 0.1).astype("f"),
            rs.randint(0, k, (n, t)).astype("f"),
            np.array([6, 3, 1], "f"), np.array([5.0, 4.0, 3.0], "f")]
    jout, vjp = jax.vjp(lambda *d: jmt.hawkesll(*d, *map(jnp.asarray,
                                                         arrs[4:])),
                        *map(jnp.asarray, arrs[:4]))
    cots = [rs.randn(n).astype("f"), rs.randn(n, k).astype("f")]
    jgrads = vjp(tuple(map(jnp.asarray, cots)))
    ts = [torch.tensor(a, requires_grad=i < 4) for i, a in enumerate(arrs)]
    tout = tmt.hawkesll(*ts)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(tout, cots)) \
        .backward()
    for a, b in zip(tout, jout):
        close(a.detach().numpy(), np.asarray(b), 1e-5)
    for a, b in zip(ts[:4], jgrads):
        close(a.grad.numpy(), np.asarray(b), 1e-4)
    ll, st = mx.nd.hawkesll(*[mx.nd.array(a) for a in arrs])
    close(ll.asnumpy(), np.asarray(jout[0]), 1e-5)


def test_count_sketch_and_index_array():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 7).astype("f")
    h = rs.randint(0, 5, 7).astype("f")
    s = rs.choice([-1.0, 1.0], 7).astype("f")
    want = np.asarray(jmt.count_sketch(jnp.asarray(x), jnp.asarray(h),
                                       jnp.asarray(s), out_dim=5))
    got = mx.nd.count_sketch(mx.nd.array(x), mx.nd.array(h),
                             mx.nd.array(s), out_dim=5).asnumpy()
    close(got, want, 1e-6)
    for axes in (None, (0, 2), (-1,)):
        want = np.asarray(jmt.index_array(jnp.asarray(x), axes=axes))
        got = tmt.index_array(torch.from_numpy(x), axes=axes)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_kl_sparse_reg():
    rs = np.random.RandomState(2)
    x = (rs.rand(4, 3, 2) * 0.8 + 0.1).astype("f")
    g = rs.randn(4, 3, 2).astype("f")
    kw = dict(sparseness_target=0.2, penalty=0.01, momentum=0.9)
    jout, vjp = jax.vjp(lambda d: jmt.identity_attach_kl_sparse_reg(d, **kw),
                        jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(g))
    t = torch.tensor(x, requires_grad=True)
    out = tmt.identity_attach_kl_sparse_reg(t, **kw)
    out.backward(torch.from_numpy(g))
    assert np.array_equal(out.detach().numpy(), np.asarray(jout))
    close(t.grad.numpy(), np.asarray(jgrad), 1e-6)


def test_windows_and_param_concat():
    for name in ("hanning", "hamming", "blackman"):
        for m in (0, 1, 7):
            want = np.asarray(getattr(jmt, name)(M=m))
            got = getattr(mx.nd, name)(m)
            assert isinstance(got, mx.nd.NDArray)
            if m:
                close(got.asnumpy(), want, 1e-6)
            else:
                assert got.shape == want.shape == (0,)
        half = getattr(mx.nd, "_npi_" + name)(M=5, dtype="float16")
        assert half.dtype == np.float16
    rs = np.random.RandomState(3)
    parts = [rs.randn(6).astype("f"), rs.randn(4).astype("f")]
    want = np.asarray(jmt.rnn_param_concat(*map(jnp.asarray, parts)))
    got = mx.nd._rnn_param_concat(*[mx.nd.array(p) for p in parts], dim=0)
    assert np.array_equal(got.asnumpy(), want)
    sym = mx.sym._rnn_param_concat(mx.sym.var("a"), mx.sym.var("b"), dim=0)
    assert sym.infer_shape(a=(6,), b=(4,))[1] == [(10,)]
    assert mxj.sym._rnn_param_concat(
        mxj.sym.var("a"), mxj.sym.var("b"),
        dim=0).infer_shape(a=(6,), b=(4,))[1] == [(10,)]
