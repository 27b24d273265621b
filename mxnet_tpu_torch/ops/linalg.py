"""Linear algebra ops (counterpart of mxnet_tpu/ops/linalg.py): ``dot``,
``batch_dot``, ``khatri_rao``, the ``linalg_*`` family and ``norm_fro``,
over ``torch.matmul`` and ``torch.linalg`` (cuBLAS and cuSOLVER on the
card).

Triangular arguments follow the JAX package: ``potrf`` returns the lower
Cholesky factor (or its transpose with ``lower=False``), ``trsm`` reads
only the named triangle of ``A``, ``trmm`` multiplies by ``A`` as given,
and ``gelqf`` returns ``(L, Q)`` with ``A = L Q`` from the QR of ``A^T``
(unique up to the signs of L's columns and Q's rows). ``precision``
(None, "default", "float32" or "highest") runs a product under the port's
``precision.matmul_precision``; None defers to the global policy.
"""
from __future__ import annotations

import torch

from ..precision import matmul_precision
from .registry import register

__all__ = ["dot", "batch_dot", "khatri_rao", "linalg_gemm", "linalg_gemm2",
           "linalg_potrf", "linalg_potri", "linalg_trmm", "linalg_trsm",
           "linalg_sumlogdiag", "linalg_extractdiag", "linalg_makediag",
           "linalg_syrk", "linalg_gelqf", "linalg_inverse", "linalg_det",
           "linalg_slogdet", "norm_fro"]


def _t(a):
    return a.transpose(-1, -2)


@register("dot")
def dot(a, b, transpose_a=False, transpose_b=False, precision=None):
    """MXNet's dot: the last axis of ``a`` against the first of ``b``."""
    if transpose_a and a.dim() > 1:
        a = torch.movedim(a, 0, -1)
    if transpose_b and b.dim() > 1:
        b = torch.movedim(b, -1, 0)
    with matmul_precision(precision):
        if a.dim() == 1 and b.dim() == 1:
            return torch.dot(a, b)
        return torch.tensordot(a, b, dims=1)


@register("batch_dot")
def batch_dot(a, b, transpose_a=False, transpose_b=False, precision=None):
    a = _t(a) if transpose_a else a
    b = _t(b) if transpose_b else b
    with matmul_precision(precision):
        return torch.matmul(a, b)


@register("khatri_rao")
def khatri_rao(*mats):
    """Column-wise Kronecker product of the matrices."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            out.shape[0] * m.shape[0], *out.shape[1:])
    return out


# -- linalg_* family ----------------------------------------------------------

@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2, precision=None):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    with matmul_precision(precision):
        return alpha * torch.matmul(a, b) + beta * C


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2, precision=None):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    with matmul_precision(precision):
        return alpha * torch.matmul(a, b)


@register("linalg_potrf")
def linalg_potrf(A, lower=True):
    L = torch.linalg.cholesky(A)
    return L if lower else _t(L)


def _solve_tri(a, b, lower, trans):
    """Solve ``a x = b`` (``a^T x = b`` with ``trans``) reading only the
    ``lower`` (or upper) triangle of ``a``."""
    if trans:
        return torch.linalg.solve_triangular(_t(a), b, upper=lower)
    return torch.linalg.solve_triangular(a, b, upper=not lower)


@register("linalg_potri")
def linalg_potri(A, lower=True):
    """The inverse of ``L L^T`` from its Cholesky factor ``A``."""
    L = A if lower else _t(A)
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device).expand(L.shape)
    Linv = _solve_tri(L, eye, True, False)
    return torch.matmul(_t(Linv), Linv)


@register("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True, alpha=1.0,
                precision=None):
    a = _t(A) if transpose else A
    with matmul_precision(precision):
        return alpha * (torch.matmul(B, a) if rightside
                        else torch.matmul(a, B))


@register("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    if rightside:
        # X A = alpha B  <=>  A^T X^T = alpha B^T
        return _t(_solve_tri(_t(A), _t(alpha * B), not lower, transpose))
    return _solve_tri(A, alpha * B, lower, transpose)


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_extractdiag")
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(d, offset=0):
    return torch.diag_embed(d, offset=offset)


@register("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0, precision=None):
    a = _t(A) if transpose else A
    with matmul_precision(precision):
        return alpha * torch.matmul(a, _t(a))


@register("linalg_gelqf")
def linalg_gelqf(A):
    """LQ factorization ``A = L Q`` through the QR of ``A^T``."""
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("linalg_inverse")
def linalg_inverse(A):
    return torch.linalg.inv(A)


@register("linalg_det")
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_slogdet")
def linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("norm_fro")
def norm_fro(A):
    return torch.sqrt(torch.sum(torch.square(A)))
