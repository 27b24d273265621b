"""Training-mode BatchNorm over the trailing axis: the Hopper kernels and their
plain PyTorch versions (counterpart of
mxnet_tpu/pallas_kernels/batchnorm_fused.py).

    mean, var = moments(x)           # f32, deterministic tree sums
    y = exact_mul(x - mean, inv * gamma) + beta,  inv = 1 / sqrt(var + eps)
    out = act(y)                     # act None or "relu"

Four kernels in ``csrc/batchnorm_fused.cu``, one wrapper each over (R, C)
row-major tensors: ``stats`` (with a second "finalize" launch that folds
its partial sums into mean and var), ``apply``, ``bwd_reduce`` (with its
finalize launch: dbeta and dgamma) and ``bwd_dx``; the two folds (stats
and bwd_reduce) are persistent blocks that walk ``fold_plan``'s items.
Beside each is its plain version (``stats_reference``,
``apply_reference``, ...). A wrapper runs the plain version for a CPU
tensor and launches its kernel for a CUDA tensor, or raises; there is no
other route. ``fused_batch_norm`` is the
``torch.autograd.Function`` over the four; ``batchnorm_reference`` and
``batchnorm_backward_reference`` compose the plain versions on whole
tensors. The kernels' design note is in their source.

The reduction is the JAX package's, piece for piece: ``fold_blocks`` folds
fixed 64-row blocks by contiguous halves, ``fold_partials`` folds the block
partials (padded with exact zeros to a power of two) the same way, and
squares and products use exact-product splitting (``exact_sq``,
``exact_mul``), so every op is correctly rounded and the statistics and the
output have the same bits on the CPU and on the card. The inverse standard
deviation is taken as two IEEE ops (sqrt, then divide).

``cost`` gives one launch's element-wise operations and bytes: each
kernel's roofline bound and its share of the step's roofline join
(``kernels/_cost.py``).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ..base import MXNetError
from . import _cost

__all__ = ["cost", "OPS", "FOLD_BLOCK", "fold_blocks", "fold_partials", "tree_fold_rows",
           "FOLD_WARPS", "MAX_LOG_K", "SLAB_BYTES", "FoldPlan", "fold_plan",
           "exact_sq", "exact_mul", "inv_std", "max0", "div_count",
           "stats_reference", "apply_reference", "bwd_reduce_reference",
           "bwd_dx_reference", "batchnorm_reference",
           "batchnorm_backward_reference", "fused_batch_norm",
           "combine_moments", "stats",
           "apply", "bwd_reduce", "bwd_dx",
           "LAUNCHES_STATS", "LAUNCHES_APPLY", "LAUNCHES_BWD_REDUCE",
           "LAUNCHES_BWD_DX", "LAUNCHES_FINALIZE", "COPIES"]

# Kernel launches made by fused_batch_norm in this process, one counter per
# TPU kernel replaced; LAUNCHES_FINALIZE counts the second launch of the
# stats and of the backward reduce. COPIES counts x or dy that had to be made
# contiguous before a launch.
LAUNCHES_STATS = 0
LAUNCHES_APPLY = 0
LAUNCHES_BWD_REDUCE = 0
LAUNCHES_BWD_DX = 0
LAUNCHES_FINALIZE = 0
COPIES = 0

FOLD_BLOCK = 64

# f32 operations per element of each kernel (sum and exact_sq's split;
# exact_mul's split; xhat and dy'*xhat; xhat and the dx chain), on the CUDA
# cores: all far below the bytes they move.
OPS = {"stats": 9, "apply": 11, "bwd_reduce": 5, "bwd_dx": 6}
# (R, C) tensors each kernel reads or writes once (stats reads x; apply
# reads x, writes out; bwd_reduce reads x, dy; bwd_dx reads x, dy, writes
# dx) and its f32 (C,) vectors.
_BIG = {"stats": 1, "apply": 2, "bwd_reduce": 2, "bwd_dx": 3}
_SMALL = {"stats": 2, "apply": 4, "bwd_reduce": 6, "bwd_dx": 6}


def cost(shape, kernel, dtype_bytes):
    """``(operations, bytes)`` of one launch of ``kernel`` over a tensor of
    ``shape`` (its last axis the channels) with ``dtype_bytes``-byte
    elements: ``OPS[kernel]`` f32 operations per element; its (R, C)
    tensors read or written once plus its (C,) f32 vectors."""
    C = shape[-1]
    n = 1
    for d in shape:
        n *= int(d)
    return (OPS[kernel] * n,
            dtype_bytes * n * _BIG[kernel] + 4 * C * _SMALL[kernel])


def _launch_scope(kernel, x2):
    return _cost.launch("batchnorm_fused." + kernel, cost, tuple(x2.shape),
                        kernel, x2.element_size(), tensor_core=False)


# -- the deterministic reduction ---------------------------------------------

def _fold_pow2(v, dim):
    """Contiguous-halves fold of a power-of-two dim down to length 1."""
    p = v.shape[dim]
    while p > 1:
        p //= 2
        v = v.narrow(dim, 0, p) + v.narrow(dim, p, p)
    return v


def fold_blocks(v):
    """(R, C) -> (ceil(R/64), C): per-64-row-block column sums, each block
    folded by contiguous halves; rows pad to a block multiple with exact
    zeros."""
    n, c = v.shape
    nb = -(-n // FOLD_BLOCK)
    if nb * FOLD_BLOCK != n:
        v = torch.cat([v, v.new_zeros(nb * FOLD_BLOCK - n, c)])
    return _fold_pow2(v.reshape(nb, FOLD_BLOCK, c), 1).reshape(nb, c)


def fold_partials(parts):
    """(NB, C) block partials -> (1, C): NB padded to the next power of two
    with exact zeros (they are added: -0.0 + 0.0 is +0.0), then folded by
    contiguous halves."""
    n = parts.shape[0]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        parts = torch.cat([parts, parts.new_zeros((p - n,) + parts.shape[1:])])
    return _fold_pow2(parts, 0)


def tree_fold_rows(v):
    """Deterministic column sum of a float32 (R, C) tensor -> (1, C)."""
    return fold_partials(fold_blocks(v))


# -- the fold kernels' plan ---------------------------------------------------
#
# The stats and backward-reduce kernels split the tree above without changing
# it. Their persistent blocks of FOLD_WARPS warps walk items: an item is a
# slab of channels (SLAB_BYTES of each row) times one of G' = 2^logg partial
# rows c; warp h of the item folds the 64-row blocks {c + G'h + G'Hk : k < K}
# (H = 2^logh, K = 2^logk, G'HK = P, the block count padded to a power of
# two), each block by contiguous halves and the K blocks by contiguous halves
# in k; the H warps' sums fold by contiguous halves in h into partial row c,
# and the finalize launch folds the G' rows by contiguous halves. Each of
# these sets of blocks is a subtree of fold_partials' tree, so the result is
# tree_fold_rows bit for bit.

FOLD_WARPS = 8          # warps of a fold block (csrc: FOLD_WARPS)
MAX_LOG_K = 10          # blocks per warp and item: at most 2^10 (csrc)
# Bytes of each row an item reads: 64 bf16 or 32 f32 channels for the stats
# (one tensor), half that for the backward reduce (x and dy).
SLAB_BYTES = {"stats": 128, "bwd_reduce": 64}

FoldPlan = collections.namedtuple(
    "FoldPlan", "nb logp slab ns logg logh logk items grid")


def fold_plan(R, C, n_sm, slab):
    """The work partition of one fold launch over (R, C) with ``slab``
    channels per item, for a card of ``n_sm`` SMs (one persistent block
    each): nb 64-row blocks padded to 2^logp; ns slabs; G' = 2^logg partial
    rows, the fewest that give every SM an item, but at most 2^MAX_LOG_K
    blocks per warp; H = 2^logh warps (fewer than FOLD_WARPS only when P
    is smaller); K = 2^logk blocks per warp and item; ``items`` = ns * G',
    ``grid`` persistent blocks."""
    nb = -(-R // FOLD_BLOCK)
    logp = (nb - 1).bit_length()
    ns = -(-C // slab)
    logh = min(FOLD_WARPS.bit_length() - 1, logp)
    room = logp - logh
    logg = 0
    while logg < room and (ns << logg) < n_sm:
        logg += 1
    logg = max(logg, room - MAX_LOG_K)
    items = ns << logg
    return FoldPlan(nb, logp, slab, ns, logg, logh, room - logg, items,
                    min(items, n_sm))


def _hi(t):
    """The top 12 significant bits of each f32 value (mantissa masking).
    Detached: the split point carries no gradient, as in the JAX
    package, where the bitcast is not differentiated."""
    return (t.detach().view(torch.int32) & -4096).view(torch.float32)


def exact_sq(x):
    """x*x by exact-product splitting: x = xh + xl with at most 12
    significant bits each, so xh^2, 2*xh*xl and xl^2 are exact and no FMA
    contraction can change the sum. Non-finite inputs give plain x*x."""
    xh = _hi(x)
    xl = x - xh
    t = xh * xh + (2.0 * (xh * xl) + xl * xl)
    return torch.where(torch.isfinite(x), t, x * x)


def exact_mul(a, b):
    """``a*b`` of float32 tensors by the same exact-product splitting; the
    two may broadcast against each other. Non-finite inputs give ``a*b``."""
    ah, bh = _hi(a), _hi(b)
    al, bl = a - ah, b - bh
    t = ah * bh + (ah * bl + (al * bh + al * bl))
    return torch.where(torch.isfinite(a) & torch.isfinite(b), t, a * b)


def inv_std(var32, eps):
    """``1/sqrt(var + eps)`` in f32 as two IEEE ops, eps rounded to f32: the
    same bits on the CPU and the card."""
    return 1.0 / torch.sqrt(var32 + torch.tensor(eps, dtype=torch.float32))


def max0(v):
    """max(v, 0) keeping NaN, and +0.0 for a zero of either sign: the
    kernels' select, spelled so that the CPU and the card agree."""
    return torch.where((v > 0) | torch.isnan(v), v, torch.zeros_like(v))


def div_count(total, r):
    """``total / r`` as an f32 division by a full tensor (a CUDA division
    by a host scalar multiplies by the reciprocal instead)."""
    return total / torch.full_like(total, float(r))


def _check(x, gamma, beta, act):
    if x.dim() < 2 or tuple(gamma.shape) != (x.shape[-1],) \
            or tuple(beta.shape) != (x.shape[-1],):
        raise ValueError("fused_batch_norm: need (..., C) x and (C,) "
                         "gamma/beta, got %s / %s / %s"
                         % (tuple(x.shape), tuple(gamma.shape),
                            tuple(beta.shape)))
    if act not in (None, "relu"):
        raise ValueError("fused_batch_norm: act must be None or 'relu', "
                         "got %r" % (act,))
    for t in (x, gamma, beta):
        if not t.dtype.is_floating_point:
            raise TypeError("fused_batch_norm: floating operands required, "
                            "got %s" % t.dtype)
        if t.device != x.device:
            raise ValueError("fused_batch_norm: operands on %s and %s"
                             % (x.device, t.device))


# -- plain versions -----------------------------------------------------------

def stats_reference(x2):
    """(R, C) -> (mean32, var32): tree-fold sums, single-pass variance
    clamped at 0 (plain version of the stats kernel and its finalize)."""
    xf = x2.float()
    R = xf.shape[0]
    mean = div_count(tree_fold_rows(xf)[0], R)
    var = max0(div_count(tree_fold_rows(exact_sq(xf))[0], R)
               - exact_sq(mean))
    return mean, var


def apply_reference(x2, gamma, beta, mean, var, eps=1e-3, act=None):
    """act(exact_mul(x - mean, inv * gamma) + beta) in f32, cast to
    x2.dtype (plain version of the apply kernel)."""
    y = exact_mul(x2.float() - mean, inv_std(var, eps) * gamma.float()) \
        + beta.float()
    if act == "relu":
        y = max0(y)
    return y.to(x2.dtype)


def _xhat_dy(x2, dy2, gamma, beta, mean, inv, act):
    xhat = (x2.float() - mean) * inv
    dyf = dy2.float()
    if act == "relu":
        dyf = dyf * ((xhat * gamma.float() + beta.float()) > 0).float()
    return xhat, dyf


def bwd_reduce_reference(x2, dy2, gamma, beta, mean, var, eps=1e-3,
                         act=None):
    """(dbeta, dgamma) in f32: tree-fold sums of dy' and dy' * xhat
    (plain version of the backward reduce kernel and its finalize)."""
    xhat, dyf = _xhat_dy(x2, dy2, gamma, beta, mean, inv_std(var, eps), act)
    return tree_fold_rows(dyf)[0], tree_fold_rows(dyf * xhat)[0]


def bwd_dx_reference(x2, dy2, gamma, beta, mean, var, dbeta, dgamma,
                     eps=1e-3, act=None):
    """gamma*inv * ((dy' - dbeta/R) - xhat * (dgamma/R)), cast to x2.dtype
    (plain version of the backward dx kernel)."""
    R = x2.shape[0]
    inv = inv_std(var, eps)
    xhat, dyf = _xhat_dy(x2, dy2, gamma, beta, mean, inv, act)
    dx = gamma.float() * inv * ((dyf - div_count(dbeta, R))
                                - xhat * div_count(dgamma, R))
    return dx.to(x2.dtype)


def batchnorm_reference(x, gamma, beta, eps=1e-3, act=None):
    """Plain PyTorch semantics of the fused op (the JAX package's
    ``batchnorm_reference``). x: (..., C) channels-last; gamma, beta: (C,).
    Returns ``(out[x.dtype], mean32, var32)`` with (C,) f32 statistics:
    tree-fold sums, single-pass variance clamped at 0."""
    x2 = x.reshape(-1, x.shape[-1])
    mean, var = stats_reference(x2)
    out = apply_reference(x2, gamma, beta, mean, var, eps, act)
    return out.reshape(x.shape), mean, var


def batchnorm_backward_reference(x, gamma, beta, mean, var, dy, eps=1e-3,
                                 act=None):
    """Plain PyTorch batch-statistics backward, the math of the JAX
    package's ``_bwd_reduce_kernel`` and ``_bwd_dx_kernel`` on whole
    tensors:

        xhat = (x - mean) * inv,    dy' = dy * (act(y) > 0 if relu)
        dbeta = sum dy',  dgamma = sum dy' * xhat      (tree_fold_rows)
        dx = gamma*inv * ((dy' - dbeta/R) - xhat * (dgamma/R))

    Returns ``(dx[x.dtype], dgamma[gamma.dtype], dbeta[beta.dtype])``."""
    C = x.shape[-1]
    x2, dy2 = x.reshape(-1, C), dy.reshape(-1, C)
    db, dg = bwd_reduce_reference(x2, dy2, gamma, beta, mean, var, eps, act)
    dx = bwd_dx_reference(x2, dy2, gamma, beta, mean, var, db, dg, eps, act)
    return dx.reshape(x.shape), dg.to(gamma.dtype), db.to(beta.dtype)


# -- the autograd op ----------------------------------------------------------

def _rows(t, C):
    """(R, C) contiguous view of a channels-last tensor, copying (and
    counting the copy) only when the layout needs it."""
    global COPIES
    t2 = t.reshape(-1, C)
    if not t2.is_contiguous():
        t2 = t2.contiguous()
        COPIES += 1
    return t2


def combine_moments(mean, var, across):
    """The moments of a batch whose rows lie on several ranks, each holding
    as many: ``across(t)`` is the mean of t over the ranks. Chan's
    combination in two reductions: ``mean = across(mean_r)`` and ``var =
    across(var_r + (mean_r - mean)^2)``. With one rank and ``across`` the
    identity they are the rank's own, bit for bit."""
    g = across(mean)
    d = mean - g
    return g, across(var + d * d)


class _FusedBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act, across):
        ctx.set_materialize_grads(False)
        x2 = _rows(x, x.shape[-1])
        mean, var = stats(x2)
        if across is not None:
            mean, var = combine_moments(mean, var, across)
        out = apply(x2, gamma, beta, mean, var, eps, act)
        ctx.save_for_backward(x2, gamma, beta, mean, var)
        ctx.eps, ctx.act, ctx.across, ctx.shape = eps, act, across, x.shape
        return out.reshape(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, gmean, gvar):
        x2, gamma, beta, mean, var = ctx.saved_tensors
        C = x2.shape[1]
        if dy is None:
            dx = torch.zeros_like(x2)
            dgamma, dbeta = torch.zeros_like(gamma), torch.zeros_like(beta)
        else:
            dy2 = _rows(dy, C)
            db, dg = bwd_reduce(x2, dy2, gamma, beta, mean, var, ctx.eps,
                                ctx.act)
            dbx, dgx = db, dg
            if ctx.across is not None:
                # the dx kernel divides the sums by its own rows: the
                # global batch's sums, averaged over the ranks, stand in
                both = ctx.across(torch.cat([db, dg]))
                dbx, dgx = both[:C], both[C:]
            dx = bwd_dx(x2, dy2, gamma, beta, mean, var, dbx, dgx, ctx.eps,
                        ctx.act)
            # this rank's sums: the step's gradient reduction adds them up
            dgamma, dbeta = dg.to(gamma.dtype), db.to(beta.dtype)
        if gmean is not None or gvar is not None:
            # cotangents of the statistics (zero in a training loop, where
            # the running-statistic update stays outside the graph):
            # d mean/dx = 1/R, d var/dx = 2(x - mean)/R; across ranks, every
            # rank's cotangents reach the statistics they share
            if ctx.across is not None:
                zero = torch.zeros_like(mean)
                cts = ctx.across(torch.cat([
                    zero if gmean is None else gmean.float(),
                    zero if gvar is None else gvar.float()]))
                gmean, gvar = cts[:C], cts[C:]
            xf = x2.float()
            ct = torch.zeros_like(xf)
            if gmean is not None:
                ct = ct + gmean
            if gvar is not None:
                ct = ct + 2.0 * (xf - mean) * gvar
            dx = dx + (ct / xf.shape[0]).to(x2.dtype)
        return dx.reshape(ctx.shape), dgamma, dbeta, None, None, None


def fused_batch_norm(x, gamma, beta, eps=1e-3, act=None, across=None):
    """Training-mode BatchNorm over the trailing axis with fused statistics,
    normalize and optional activation (``act=None|"relu"``).

    x: (..., C) channels-last; gamma, beta: (C,). Returns ``(out, mean,
    var)`` with f32 (C,) batch statistics; the running-statistic update
    belongs to the caller. Differentiable in x, gamma and beta, and through
    the statistics. A CPU tensor runs the plain versions; a CUDA tensor
    launches the kernels, or raises on a dtype other than bf16/f32, a
    non-float operand, operands on two devices or a failed launch. A
    ``meta`` tensor (shape inference) gives empty outputs of the right
    shapes and dtypes.

    ``across`` is for a batch whose rows lie on several ranks, x holding
    this rank's: a function giving the mean over the ranks of an f32
    tensor. The statistics become the whole batch's (``combine_moments``),
    and the backward's dbeta and dgamma pass through it before the dx
    kernel; the gamma and beta gradients returned stay this rank's sums.
    """
    _check(x, gamma, beta, act)
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise MXNetError("fused_batch_norm: no kernel for device %s"
                         % x.device)
    return _FusedBatchNorm.apply(x, gamma, beta, float(eps), act, across)


# -- the four kernels, one wrapper each ---------------------------------------
#
# Each takes (R, C) row-major tensors: x2 and dy2 in bf16 or f32, gamma and
# beta of any float dtype, the statistics and sums (C,) float32. A CPU
# tensor runs the plain version; a CUDA tensor launches the kernel (the
# wrapper counts the launch) or raises; a meta tensor (shape inference,
# no data) gives empty outputs of the kernel's shapes and dtypes.

def _meta_stats(x2):
    C = x2.shape[1]
    return (torch.empty(C, dtype=torch.float32, device="meta"),
            torch.empty(C, dtype=torch.float32, device="meta"))


def stats(x2):
    """(mean32, var32) of x2's columns: the stats kernel, then the finalize
    launch that folds its partial sums."""
    if x2.device.type == "meta":
        return _meta_stats(x2)
    with _launch_scope("stats", x2):
        if x2.device.type == "cpu":
            return stats_reference(x2)
        return _launch_stats(x2)


def _launch_stats(x2):
    global LAUNCHES_STATS, LAUNCHES_FINALIZE
    R, C = _launchable("stats", x2)
    mean = torch.empty(C, dtype=torch.float32, device=x2.device)
    var = torch.empty_like(mean)
    plan = _plan("stats", x2)
    scratch = _scratch(plan, C, x2.device)
    with torch.cuda.device(x2.device):
        _call("bn_stats", x2.dtype, (R, C), x2.data_ptr(),
              scratch.data_ptr(), mean.data_ptr(), var.data_ptr(), R, C,
              plan.logg, plan.logh, plan.logk, plan.grid, _stream(x2))
        LAUNCHES_STATS += 1
        LAUNCHES_FINALIZE += 1
    return mean, var


def apply(x2, gamma, beta, mean, var, eps=1e-3, act=None):
    """act(exact_mul(x - mean, inv * gamma) + beta) in x2.dtype."""
    if x2.device.type == "meta":
        return torch.empty_like(x2)
    with _launch_scope("apply", x2):
        if x2.device.type == "cpu":
            return apply_reference(x2, gamma, beta, mean, var, eps, act)
        return _launch_apply(x2, gamma, beta, mean, var, eps, act)


def _launch_apply(x2, gamma, beta, mean, var, eps, act):
    global LAUNCHES_APPLY
    R, C = _launchable("apply", x2, mean, var)
    g32, b32 = _f32(gamma, beta, x2)
    out = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        _call("bn_apply", x2.dtype, (R, C), x2.data_ptr(), g32.data_ptr(),
              b32.data_ptr(), mean.data_ptr(), var.data_ptr(), eps,
              int(act == "relu"), out.data_ptr(), R, C, _stream(x2))
        LAUNCHES_APPLY += 1
    return out


def bwd_reduce(x2, dy2, gamma, beta, mean, var, eps=1e-3, act=None):
    """(dbeta, dgamma) in f32: the backward reduce kernel, then the
    finalize launch."""
    if x2.device.type == "meta":
        return _meta_stats(x2)
    with _launch_scope("bwd_reduce", x2):
        if x2.device.type == "cpu":
            return bwd_reduce_reference(x2, dy2, gamma, beta, mean, var, eps,
                                        act)
        return _launch_bwd_reduce(x2, dy2, gamma, beta, mean, var, eps, act)


def _launch_bwd_reduce(x2, dy2, gamma, beta, mean, var, eps, act):
    global LAUNCHES_BWD_REDUCE, LAUNCHES_FINALIZE
    R, C = _launchable("bwd_reduce", x2, mean, var, dy2)
    g32, b32 = _f32(gamma, beta, x2)
    db = torch.empty(C, dtype=torch.float32, device=x2.device)
    dg = torch.empty_like(db)
    plan = _plan("bwd_reduce", x2)
    scratch = _scratch(plan, C, x2.device)
    with torch.cuda.device(x2.device):
        _call("bn_bwd_reduce", x2.dtype, (R, C), x2.data_ptr(),
              dy2.data_ptr(), g32.data_ptr(), b32.data_ptr(), mean.data_ptr(),
              var.data_ptr(), eps, int(act == "relu"), scratch.data_ptr(),
              db.data_ptr(), dg.data_ptr(), R, C, plan.logg, plan.logh,
              plan.logk, plan.grid, _stream(x2))
        LAUNCHES_BWD_REDUCE += 1
        LAUNCHES_FINALIZE += 1
    return db, dg


def bwd_dx(x2, dy2, gamma, beta, mean, var, dbeta, dgamma, eps=1e-3,
           act=None):
    """dx in x2.dtype from the sums of ``bwd_reduce``."""
    if x2.device.type == "meta":
        return torch.empty_like(x2)
    with _launch_scope("bwd_dx", x2):
        if x2.device.type == "cpu":
            return bwd_dx_reference(x2, dy2, gamma, beta, mean, var, dbeta,
                                    dgamma, eps, act)
        return _launch_bwd_dx(x2, dy2, gamma, beta, mean, var, dbeta,
                              dgamma, eps, act)


def _launch_bwd_dx(x2, dy2, gamma, beta, mean, var, dbeta, dgamma, eps,
                   act):
    global LAUNCHES_BWD_DX
    R, C = _launchable("bwd_dx", x2, mean, var, dbeta, dgamma, dy2)
    g32, b32 = _f32(gamma, beta, x2)
    dx = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        _call("bn_bwd_dx", x2.dtype, (R, C), x2.data_ptr(), dy2.data_ptr(),
              g32.data_ptr(), b32.data_ptr(), mean.data_ptr(), var.data_ptr(),
              dbeta.data_ptr(), dgamma.data_ptr(), eps, int(act == "relu"),
              float(R), dx.data_ptr(), R, C, _stream(x2))
        LAUNCHES_BWD_DX += 1
    return dx


# -- launch plumbing ----------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGS = {
    "bn_stats": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    "bn_apply": [_P, _P, _P, _P, _P, _F, _I, _P, _L, _I, _P],
    "bn_bwd_reduce": [_P, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P, _L, _I,
                      _I, _I, _I, _I, _P],
    "bn_bwd_dx": [_P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _F, _P, _L, _I,
                  _P],
}


def _launchable(name, x2, *others):
    """(R, C) of x2 after checking what the kernel takes: a CUDA tensor
    of bf16 or f32, 2-D, contiguous and not empty; the (C,) statistics
    float32 and the (R, C) dy like x2, all on x2's device."""
    if x2.device.type != "cuda":
        raise MXNetError("batchnorm_fused %s: no kernel for device %s"
                         % (name, x2.device))
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("batchnorm_fused %s: the kernels take bf16 or f32, "
                        "got %s" % (name, x2.dtype))
    if x2.dim() != 2 or x2.numel() == 0 or not x2.is_contiguous():
        raise ValueError("batchnorm_fused %s: need a contiguous, non-empty "
                         "(R, C) tensor, got %s" % (name, tuple(x2.shape)))
    R, C = x2.shape
    for t in others:
        want = (x2.dtype, (R, C)) if t.dim() == 2 else (torch.float32, (C,))
        if t.device != x2.device or (t.dtype, tuple(t.shape)) != want \
                or not t.is_contiguous():
            raise ValueError("batchnorm_fused %s: operand %s %s on %s, want "
                             "%s %s on %s" % (name, t.dtype, tuple(t.shape),
                                              t.device, want[0], want[1],
                                              x2.device))
    return R, C


def _f32(gamma, beta, x2):
    C = x2.shape[1]
    for t in (gamma, beta):
        if t.device != x2.device or tuple(t.shape) != (C,):
            raise ValueError("batchnorm_fused: gamma/beta must be (%d,) on "
                             "%s, got %s on %s" % (C, x2.device,
                                                   tuple(t.shape), t.device))
    return gamma.float().contiguous(), beta.float().contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fn(name, dtype):
    from . import _build
    lib = _build.load("batchnorm_fused")
    sym = "%s_%s" % (name, "bf16" if dtype == torch.bfloat16 else "f32")
    fn = getattr(lib, sym)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = _I
    return fn


def _call(name, dtype, shape, *args):
    err = _fn(name, dtype)(*args)
    if err != 0:
        raise MXNetError("batchnorm_fused %s launch failed: cudaError %d "
                         "(R, C = %s, %s)" % (name, err, shape, dtype))


def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _plan(kernel, x2):
    """``fold_plan`` of the stats or backward-reduce launch over x2."""
    R, C = x2.shape
    return fold_plan(R, C, _sm_count(x2.device),
                     SLAB_BYTES[kernel] // x2.element_size())


def _scratch(plan, C, device):
    """Room for the two (G', C) float32 arrays of partial rows that a fold
    launch under ``plan`` writes."""
    return torch.empty(2 * (1 << plan.logg) * C, dtype=torch.float32,
                       device=device)
