"""Blockwise attention on one device (counterpart of
mxnet_tpu/parallel/ring_attention.py ``_attn_block`` :27 and
``blockwise_attention`` :109).

Memory-efficient exact attention: the keys and values are walked in blocks
with flash attention's online softmax, a running row max m, row sum l and
unnormalised output o (Liu et al., arXiv:2310.01889). As in the JAX
package, m, l and o are carried in ``q.dtype`` (bfloat16 for a bfloat16
model), a ragged last block is padded with zero keys that the mask
excludes, and a row whose keys are all masked gives zeros. It is plain
PyTorch, as the JAX package's is plain jnp (no kernel of its own).

``ring_attention`` and ``ring_self_attention``, which rotate the blocks
around a sequence-parallel mesh axis, arrive with the multi-GPU slice.
"""
from __future__ import annotations

import torch

from ..base import weak_scalar

__all__ = ["blockwise_attention"]


def _attn_block(q, k, v, bias, m_prev, l_prev, o_prev, scale):
    """One query block x key block step of the online softmax.
    q: [B, H, Sq, D]; k, v: [B, H, Sk, D]; bias: [B, 1|H, Sq, Sk] (0 or
    -inf, in q's dtype) or None; m, l: [B, H, Sq]; o: [B, H, Sq, D]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    s = s * weak_scalar(scale, s.dtype)
    if bias is not None:
        s = s + bias
    m_cur = torch.amax(s, dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    # a row masked so far has m == -inf: exp must not see -inf - -inf
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    ninf = torch.full((), float("-inf"), dtype=s.dtype, device=s.device)
    m_safe = torch.where(torch.isneginf(m_new), zero, m_new)
    p = torch.exp(s - m_safe[..., None])
    if bias is not None:
        p = torch.where(torch.isneginf(s), zero, p)
    prev_masked = torch.isneginf(m_prev)
    corr = torch.exp(torch.where(prev_masked, ninf, m_prev - m_safe))
    corr = torch.where(prev_masked, zero, corr)
    l_new = corr * l_prev + torch.sum(p, dim=-1)
    o_new = corr[..., None] * o_prev + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, o_new


def blockwise_attention(q, k, v, block_size=512, causal=False, scale=None):
    """Exact attention over key/value blocks of ``block_size``, on one
    device. q, k, v: [B, H, S, D] -> [B, H, S, D] in q's dtype; ``scale``
    defaults to 1 / sqrt(D). Differentiable through autograd."""
    return _normalize(*_accumulate(q, k, v, block_size, causal, scale))


def _accumulate(q, k, v, block_size=512, causal=False, scale=None):
    """The online softmax over every block: the unnormalised output o and
    the row sums l."""
    B, H, S, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    nblk = -(-S // block_size)
    pad = nblk * block_size - S
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    dev, dt = q.device, q.dtype
    q_pos = torch.arange(S, device=dev)
    m = torch.full((B, H, S), float("-inf"), dtype=dt, device=dev)
    l = torch.zeros((B, H, S), dtype=dt, device=dev)
    o = torch.zeros((B, H, S, D), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    ninf = torch.full((), float("-inf"), dtype=dt, device=dev)
    for idx in range(nblk):
        lo = idx * block_size
        k_pos = lo + torch.arange(block_size, device=dev)
        valid = k_pos < S
        if causal:
            ok = (q_pos[:, None] >= k_pos[None, :]) & valid[None, :]
        else:
            ok = valid[None, :].expand(S, block_size)
        bias = torch.where(ok, zero, ninf)[None, None]
        m, l, o = _attn_block(q, k[:, :, lo:lo + block_size],
                              v[:, :, lo:lo + block_size], bias, m, l, o,
                              scale)
    return o, l


def _normalize(o, l):
    """o / l, with the zeros of a fully masked row (l == 0) kept."""
    one = torch.ones((), dtype=l.dtype, device=l.device)
    return o / torch.where(l == 0, one, l)[..., None]
