"""Every op name that the JAX package's ``ops/linalg.py`` registers, held
against the port's op of that name (``ops/linalg.py``) on the same numpy
inputs, with the gradient against ``jax.vjp``, and the ``mx.nd.linalg``
wrappers against JAX's. The harness and tolerances are
``test_torch_nn_ops``'s: float32 1e-5 and bf16 1.6e-2 of the largest
magnitude, float32 gradients 1e-5, and 1e-4 (``GRAD_NORM``) for the
factorizations, whose backward solves triangular systems in another order.
The products take bf16; torch's factorizations do not, so those run in
float32 only. ``linalg_gelqf``'s factors are unique only up to the signs of
L's columns (and Q's rows), so it is held by reconstruction, orthonormal
rows, a lower-triangular L, and |L| and |Q| against JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg
from test_torch_nn_ops import (F32, GRAD_NORM, Spec, U, _names, compare,
                               run_spec)

NAMES = _names("mxnet_tpu.ops.linalg", "linalg")


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _spd(rs, *batch, n=4):
    m = rs.uniform(-1, 1, batch + (n, n))
    return (m @ np.swapaxes(m, -1, -2) + n * np.eye(n)).astype("float32")


def _lower(rs, *batch, n=4):
    a = np.tril(rs.uniform(-1, 1, batch + (n, n)))
    idx = np.arange(n)
    a[..., idx, idx] = rs.uniform(1.0, 2.0, batch + (n,))
    return a.astype("float32")


def _gelqf_check(got, want, args, kwargs, tol, what):
    (L32, Q32), (jL, jQ) = [g.asnumpy() for g in got], want
    L, Q = L32.astype(np.float64), Q32.astype(np.float64)
    a = args[0].astype(np.float64)
    scale = np.abs(a).max()
    assert np.abs(L @ Q - a).max() <= 10 * tol * scale, what
    eye = np.eye(Q.shape[-2])
    assert np.abs(Q @ np.swapaxes(Q, -1, -2) - eye).max() <= 10 * tol, what
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L)), what
    compare([np.abs(L32), np.abs(Q32)], [np.abs(np.asarray(jL)),
                                     np.abs(np.asarray(jQ))], tol, what)


SPECS = {
    "dot": Spec(lambda rs: [((U(rs, (3, 4)), U(rs, (4, 5))), {}),
                            ((U(rs, (4,)), U(rs, (4,))), {}),
                            ((U(rs, (4, 3)), U(rs, (5, 4))),
                             {"transpose_a": True, "transpose_b": True}),
                            ((U(rs, (2, 3, 4)), U(rs, (4, 2))),
                             {"precision": "float32"})]),
    "batch_dot": Spec(lambda rs: [
        ((U(rs, (2, 3, 4)), U(rs, (2, 4, 5))), {}),
        ((U(rs, (2, 4, 3)), U(rs, (2, 5, 4))),
         {"transpose_a": True, "transpose_b": True})]),
    "khatri_rao": Spec(lambda rs: [((U(rs, (2, 3)), U(rs, (4, 3))), {}),
                                   ((U(rs, (2, 3)), U(rs, (2, 3)),
                                     U(rs, (3, 3))), {})]),
    "linalg_gemm": Spec(lambda rs: [
        ((U(rs, (2, 3, 4)), U(rs, (2, 4, 5)), U(rs, (2, 3, 5))),
         {"alpha": 0.5, "beta": 2.0}),
        ((U(rs, (4, 3)), U(rs, (5, 4)), U(rs, (3, 5))),
         {"transpose_a": True, "transpose_b": True})]),
    "linalg_gemm2": Spec(lambda rs: [
        ((U(rs, (2, 3, 4)), U(rs, (2, 4, 5))), {"alpha": 1.5}),
        ((U(rs, (4, 3)), U(rs, (4, 5))), {"transpose_a": True})]),
    "linalg_potrf": Spec(lambda rs: [((_spd(rs),), {}),
                                     ((_spd(rs, 2),), {"lower": False})],
                         bf16=False, gtol=GRAD_NORM),
    "linalg_potri": Spec(lambda rs: [((_lower(rs),), {}),
                                     ((np.swapaxes(_lower(rs, 2), -1, -2)
                                       .copy(),), {"lower": False})],
                         bf16=False, gtol=GRAD_NORM),
    "linalg_trmm": Spec(lambda rs: [
        ((_lower(rs), U(rs, (4, 3))), {"alpha": 2.0}),
        ((_lower(rs, 2), U(rs, (2, 3, 4))),
         {"rightside": True, "transpose": True})]),
    "linalg_trsm": Spec(lambda rs: [
        ((_lower(rs), U(rs, (4, 3))), {"alpha": 0.5}),
        ((_lower(rs), U(rs, (4, 3))), {"transpose": True}),
        ((_lower(rs, 2), U(rs, (2, 3, 4))), {"rightside": True}),
        ((_lower(rs), U(rs, (3, 4))),
         {"rightside": True, "transpose": True}),
        ((np.swapaxes(_lower(rs), -1, -2).copy(), U(rs, (4, 2))),
         {"lower": False})], bf16=False, gtol=GRAD_NORM),
    "linalg_sumlogdiag": Spec(lambda rs: [((_spd(rs, 2),), {})]),
    "linalg_extractdiag": Spec(lambda rs: [((U(rs, (2, 4, 4)),), {}),
                                           ((U(rs, (4, 5)),),
                                            {"offset": 1}),
                                           ((U(rs, (4, 4)),),
                                            {"offset": -2})]),
    "linalg_makediag": Spec(lambda rs: [((U(rs, (4,)),), {}),
                                        ((U(rs, (2, 3)),), {"offset": 1}),
                                        ((U(rs, (3,)),), {"offset": -1})]),
    "linalg_syrk": Spec(lambda rs: [((U(rs, (2, 3, 4)),), {"alpha": 0.5}),
                                    ((U(rs, (4, 3)),),
                                     {"transpose": True})]),
    "linalg_gelqf": Spec(lambda rs: [((U(rs, (3, 5)),), {}),
                                     ((U(rs, (2, 4, 6)),), {})],
                         bf16=False, grad=False, check=_gelqf_check),
    "linalg_inverse": Spec(lambda rs: [((_spd(rs, 2),), {})], bf16=False,
                           gtol=GRAD_NORM),
    "linalg_det": Spec(lambda rs: [((U(rs, (2, 3, 3)),), {})], bf16=False,
                       gtol=GRAD_NORM),
    "linalg_slogdet": Spec(lambda rs: [((U(rs, (2, 4, 4)),), {})],
                           bf16=False, gtol=GRAD_NORM),
    "norm_fro": Spec(lambda rs: [((U(rs, (3, 4)),), {}),
                                 ((U(rs, (2, 3, 4)),), {})]),
}


@pytest.mark.parametrize("module,name,canon,jfn", NAMES,
                         ids=["%s-%s" % (m, n) for m, n, *_ in NAMES])
def test_port_op_matches_jax(module, name, canon, jfn):
    assert name in treg.list_ops(), name
    assert treg.get_op(name) is treg.get_op(canon)
    run_spec(name, jfn, SPECS[canon], sum(map(ord, canon)), name == canon)


@pytest.mark.parametrize("short", sorted(mx.nd.linalg.__all__))
def test_nd_linalg_wrapper_matches_jax(short):
    """``mx.nd.linalg.<short>`` on NDArrays against JAX's wrapper, on the
    first case of its op."""
    canon = "linalg_" + short
    args, kwargs = SPECS[canon].make(np.random.RandomState(5))[0]
    got = getattr(mx.nd.linalg, short)(*[mx.nd.array(a) for a in args],
                                      **kwargs)
    want = getattr(mxj.nd.linalg, short)(*[mxj.nd.array(a) for a in args],
                                        **kwargs)
    want = [w.asnumpy() for w in want] if isinstance(want, (tuple, list)) \
        else want.asnumpy()
    assert isinstance(got, (mx.nd.NDArray, tuple))
    if canon == "linalg_gelqf":
        _gelqf_check(got, want, args, kwargs, F32, short)
    else:
        compare(got, want, F32, short)
    assert sorted(mx.nd.linalg.__all__) == sorted(mxj.nd.linalg.__all__)


def test_potrf_reconstructs_and_dot_keeps_nd_dot():
    """potrf's factor rebuilds A (lower and upper forms), and ``nd.dot`` is
    the registry's ``dot`` behind the sparse check."""
    a = _spd(np.random.RandomState(1), n=6)
    lo = mx.nd.linalg.potrf(mx.nd.array(a)).asnumpy()
    up = mx.nd.linalg.potrf(mx.nd.array(a), lower=False).asnumpy()
    np.testing.assert_allclose(lo @ lo.T, a, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(up.T @ up, a, rtol=1e-5, atol=1e-5)
    x = np.arange(6, dtype="float32").reshape(2, 3)
    got = mx.nd.dot(mx.nd.array(x), mx.nd.array(x), transpose_b=True)
    np.testing.assert_array_equal(got.asnumpy(), x @ x.T)
    assert mx.nd.dot.__name__ == "dot" and "dot" in treg.list_ops()
    assert jnp.allclose(jnp.asarray(got.asnumpy()), x @ x.T)
