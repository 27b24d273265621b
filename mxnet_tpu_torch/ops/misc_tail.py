"""The operator long tail (counterpart of mxnet_tpu/ops/misc_tail.py):
the marked Hawkes process log-likelihood, the count sketch, per-element
coordinates, the KL sparseness regulariser, NumPy's window functions and
the concat that packs fused-RNN parameters.

``hawkesll`` walks the time axis in a Python loop over the whole batch
(the JAX package's ``lax.scan`` under ``vmap``); its gradients come from
autograd through the loop.
"""
from __future__ import annotations

import math

import torch

from ..base import canonical_dtype
from ..context import as_device
from .registry import register

__all__ = []


# -- Hawkes process log-likelihood -------------------------------------------

@register("_contrib_hawkesll", aliases=("hawkesll",))
def hawkesll(mu, alpha, beta, state, lags, marks, valid_length, max_time):
    """Log-likelihood of a marked self-exciting Hawkes process with an
    exponential decay kernel, one sequence per row. Inputs: mu (N, K),
    alpha (K,), beta (K,), state (N, K), lags (N, T) interarrival times,
    marks (N, T), valid_length (N,), max_time (N,). Returns (loglike (N,),
    out_state (N, K))."""
    n, k = mu.shape
    marks = marks.to(torch.int64)
    ks = torch.arange(k, device=mu.device)
    ll = torch.zeros((n,), dtype=mu.dtype, device=mu.device)
    st = state
    last = torch.zeros((n, k), dtype=mu.dtype, device=mu.device)
    t = torch.zeros((n,), dtype=mu.dtype, device=mu.device)
    for j in range(lags.shape[1]):
        onehot = ks[None, :] == marks[:, j, None]
        t_new = t + lags[:, j]
        d = t_new[:, None] - last
        ed = torch.exp(-beta * d)
        lda = mu + alpha * beta * st * ed
        comp = mu * d + alpha * st * (1.0 - ed)
        active = j < valid_length
        contrib = torch.where(onehot, torch.log(lda) - comp, 0.0).sum(-1)
        ll = ll + torch.where(active, contrib, 0.0)
        hit = active[:, None] & onehot
        st = torch.where(hit, 1.0 + st * ed, st)
        last = torch.where(hit, t_new[:, None], last)
        t = torch.where(active, t_new, t)
    # the compensator left up to max_time
    d = max_time[:, None] - last
    ed = torch.exp(-beta * d)
    rem = mu * d + alpha * st * (1.0 - ed)
    return ll - rem.sum(-1), ed * st


# -- count sketch --------------------------------------------------------------

@register("_contrib_count_sketch", aliases=("count_sketch",))
def count_sketch(data, h, s, out_dim=1, processing_batch_size=32):
    """out[n, h[i]] += s[i] * data[n, i]; h gives each input column its
    bucket, s its sign. Leading dimensions are kept."""
    d = data.shape[-1]
    lead = tuple(data.shape[:-1])
    x = data.reshape(-1, d)
    hh = h.reshape(-1).to(torch.int64)[:d]
    ss = s.reshape(-1)[:d]
    out = torch.zeros((x.shape[0], int(out_dim)), dtype=data.dtype,
                      device=data.device)
    out = out.index_add(1, hh, x * ss[None, :])
    return out.reshape(lead + (int(out_dim),))


# -- index_array ---------------------------------------------------------------

@register("_contrib_index_array", aliases=("index_array",))
def index_array(data, axes=None):
    """out[i0, ..., ik, :] = (i0, ..., ik), or the coordinates of ``axes``
    only; int32, as the JAX package gives them."""
    shape = tuple(data.shape)
    nd = len(shape)
    ax = list(range(nd)) if axes is None else [int(a) % nd for a in axes]
    coords = []
    for a in ax:
        view = [1] * nd
        view[a] = shape[a]
        coords.append(torch.arange(shape[a], dtype=torch.int32,
                                   device=data.device)
                      .view(view).expand(shape))
    return torch.stack(coords, dim=-1)


# -- IdentityAttachKLSparseReg -------------------------------------------------

class _KLSparseReg(torch.autograd.Function):
    """Identity forward; the KL sparseness penalty added to the gradient.
    rho_hat is the batch mean of each unit (the reference's moving average
    with momentum 0, as in the JAX package)."""

    @staticmethod
    def forward(ctx, data, sparseness_target, penalty):
        ctx.save_for_backward(data)
        ctx.target = sparseness_target
        ctx.penalty = penalty
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        (data,) = ctx.saved_tensors
        rho_hat = data.reshape(data.shape[0], -1).mean(0)
        reg = ctx.penalty * (-ctx.target / rho_hat
                             + (1.0 - ctx.target) / (1.0 - rho_hat))
        return (g + reg.reshape((1,) + tuple(data.shape[1:])).to(g.dtype),
                None, None)


@register("IdentityAttachKLSparseReg",
          aliases=("identity_attach_kl_sparse_reg",))
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """Identity forward; on the way back it adds the gradient of the KL
    sparseness penalty KL(rho || rho_hat)."""
    return _KLSparseReg.apply(data, float(sparseness_target), float(penalty))


# -- NumPy window functions ----------------------------------------------------

def _window(m, dtype, ctx, terms):
    """sum_j c_j cos(2 pi j n / (M - 1)) over n < M, computed in float32
    and cast to ``dtype`` (NumPy's values at M of 0 and 1)."""
    m = int(m)
    dt = canonical_dtype(dtype)
    dev = as_device(ctx)
    if m < 1:
        return torch.zeros((0,), dtype=dt, device=dev)
    if m == 1:
        return torch.ones((1,), dtype=dt, device=dev)
    n = torch.arange(m, dtype=torch.float32, device=dev)
    w = terms[0]
    for j, c in enumerate(terms[1:], 1):
        w = w + c * torch.cos(2.0 * j * math.pi * n / (m - 1))
    return w.to(dt)


@register("_npi_hanning", aliases=("hanning",))
def hanning(M=1, dtype="float32", ctx=None):
    return _window(M, dtype, ctx, (0.5, -0.5))


@register("_npi_hamming", aliases=("hamming",))
def hamming(M=1, dtype="float32", ctx=None):
    return _window(M, dtype, ctx, (0.54, -0.46))


@register("_npi_blackman", aliases=("blackman",))
def blackman(M=1, dtype="float32", ctx=None):
    return _window(M, dtype, ctx, (0.42, -0.5, 0.08))


# -- _rnn_param_concat ---------------------------------------------------------

@register("_rnn_param_concat")
def rnn_param_concat(*args, dim=0, num_args=None):
    """Concat, as used to pack fused-RNN parameter blobs."""
    return torch.cat([a.reshape(-1) if a.dim() == 1 else a for a in args],
                     dim=int(dim))
