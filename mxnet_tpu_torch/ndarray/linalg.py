"""``mx.nd.linalg`` (counterpart of mxnet_tpu/ndarray/linalg.py): the
``linalg_*`` ops of ``ops/linalg.py`` under the reference's short names,
on tensors or NDArrays."""
from __future__ import annotations

from .register import invoke_by_name as _inv

__all__ = ["gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "sumlogdiag",
           "extractdiag", "makediag", "syrk", "gelqf", "inverse", "det",
           "slogdet"]


def gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0,
         axis=-2, **kw):
    return _inv("linalg_gemm", A, B, C, transpose_a=transpose_a,
                transpose_b=transpose_b, alpha=alpha, beta=beta, axis=axis)


def gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0, axis=-2,
          **kw):
    return _inv("linalg_gemm2", A, B, transpose_a=transpose_a,
                transpose_b=transpose_b, alpha=alpha, axis=axis)


def potrf(A, lower=True, **kw):
    return _inv("linalg_potrf", A, lower=lower)


def potri(A, lower=True, **kw):
    return _inv("linalg_potri", A, lower=lower)


def trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0,
         **kw):
    return _inv("linalg_trmm", A, B, transpose=transpose,
                rightside=rightside, lower=lower, alpha=alpha)


def trsm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0,
         **kw):
    return _inv("linalg_trsm", A, B, transpose=transpose,
                rightside=rightside, lower=lower, alpha=alpha)


def sumlogdiag(A, **kw):
    return _inv("linalg_sumlogdiag", A)


def extractdiag(A, offset=0, **kw):
    return _inv("linalg_extractdiag", A, offset=offset)


def makediag(d, offset=0, **kw):
    return _inv("linalg_makediag", d, offset=offset)


def syrk(A, transpose=False, alpha=1.0, **kw):
    return _inv("linalg_syrk", A, transpose=transpose, alpha=alpha)


def gelqf(A, **kw):
    return _inv("linalg_gelqf", A)


def inverse(A, **kw):
    return _inv("linalg_inverse", A)


def det(A, **kw):
    return _inv("linalg_det", A)


def slogdet(A, **kw):
    return _inv("linalg_slogdet", A)
