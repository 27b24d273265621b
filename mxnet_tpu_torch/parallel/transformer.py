"""Decoder-only transformer LM on one device (counterpart of
mxnet_tpu/parallel/transformer.py, its GSPMD mode with ``pp == 1``).

RoPE positions, RMSNorm, SwiGLU FFN, a chunked cross-entropy, per-layer
activation recompute, and a fused SGD-momentum step. Attention
(``attn_mode="local"``) runs the flash kernels
(``kernels/flash_attention.py``) whenever the sequence length is a
multiple of 128, the JAX package's own dispatch rule; other lengths take
``attention_reference``. ``attn_mode="blockwise"`` runs
``ring_attention.blockwise_attention`` with its default 512-key blocks
(plain PyTorch, as in the JAX package).

Recompute. With ``remat`` each layer is one non-reentrant checkpoint
region: its forward runs again in the backward. ``remat_save`` names the
intermediates the backward keeps instead, as JAX's
``save_only_these_names`` policy does: ``"attn_o"``, the attention's
output (on the flash route the forward kernel's (o, lse), so that its
recompute does not launch the kernel again), and ``"ffn_prod"``, the
SwiGLU product. They are ``remat.checkpoint_name`` tags read by a
selective checkpoint policy (``remat.policy``); the values are the same
bits as full recompute's.

The parameter structure is the JAX package's (``embed``, ``layers``,
``ln_f``, ``w_out``, with the per-layer names and shapes ``wq [D,H,Dh]``,
``wo [H,Dh,D]`` ...), held as ``nn.Module``s: one module per layer instead
of tensors stacked on a leading layer axis, since autograd's backward of a
slice of a stacked tensor would allocate a full-size gradient per layer.
``params["layers"][i]["wq"]`` reads as the JAX tree does. Weights cross over
with ``convert.transformer_params_from_numpy``.

Not yet ported: the sequence-parallel attention modes (``ring``,
``ring_flash`` and ``ulysses`` wait for the multi-GPU slice), MoE layers,
pipeline stages (``pp > 1``) and the single-reduction chunked
cross-entropy of a batch-sharded mesh. Each raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..base import MXNetError, canonical_dtype, weak_scalar
from ..context import as_device
from ..kernels.flash_attention import (_f32_matmul, attention_reference,
                                       flash_attention)
from ..remat import checkpoint_name, policy as _remat_policy
from .ring_attention import _accumulate as _blockwise_accumulate
from .ring_attention import _normalize as _blockwise_normalize

__all__ = ["TransformerConfig", "TransformerParams", "LayerParams",
           "init_params", "apply", "loss_fn", "make_train_step",
           "ce_local_accum_active", "n_params"]

# The intermediates a layer tags for ``remat_save``.
_SAVE_NAMES = ("attn_o", "ffn_prod")
_LAYER_SHAPES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up",
                 "w_down")


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    ffn_hidden: int = 1376
    max_seq_len: int = 2048
    dtype: str = "float32"
    # parallelism
    attn_mode: str = "local"          # 'local' | 'blockwise' (| 'ring' | 'ulysses')
    pp: int = 1                        # pipeline stages (>1 = explicit mode)
    n_microbatch: int = 1
    # MoE: every `moe_every`-th layer is an expert layer when num_experts > 0
    num_experts: int = 0
    moe_k: int = 2
    causal: bool = True
    # recompute each layer in the backward (activation recompute)
    remat: bool = True
    # selective recompute: names of intermediates the backward may keep
    # ("ffn_prod", "attn_o"); empty = full recompute
    remat_save: tuple = ()
    # >1: the final projection and cross-entropy run in this many sequence
    # chunks, each recomputed in the backward, so the [B, S, vocab] f32
    # logits never exist at once
    loss_chunks: int = 1
    # the single-reduction chunked CE of a batch-sharded mesh (None = auto;
    # True is not ported yet and raises)
    ce_local_accum: Optional[bool] = None

    @property
    def head_dim(self):
        return self.dim // self.n_heads


def _layer_shapes(cfg):
    D, H, Dh, F = cfg.dim, cfg.n_heads, cfg.head_dim, cfg.ffn_hidden
    return {"ln1": (D,), "wq": (D, H, Dh), "wk": (D, H, Dh),
            "wv": (D, H, Dh), "wo": (H, Dh, D), "ln2": (D,),
            "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}


def _check_supported(cfg):
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "MoE layers (num_experts > 0) are not ported yet: they wait for "
            "parallel/expert.py in the multi-GPU slice")
    if cfg.pp != 1:
        raise NotImplementedError(
            "pipeline stages (pp > 1) are not ported yet: the explicit "
            "shard_map mode waits for the multi-GPU slice")
    unknown = set(cfg.remat_save) - set(_SAVE_NAMES)
    if unknown:
        raise ValueError("remat_save names %s; the layer tags %s"
                         % (sorted(unknown), list(_SAVE_NAMES)))
    if cfg.ce_local_accum:
        raise NotImplementedError(
            "the single-reduction chunked CE (ce_local_accum=True) waits for "
            "the multi-GPU slice; one device runs the plain chunked CE")


class LayerParams(nn.Module):
    """One layer's parameters, named as the JAX tree's ``layers`` leaves;
    ``lp["wq"]`` reads like the JAX dict."""

    def __init__(self, tensors):
        super().__init__()
        for name in _LAYER_SHAPES:
            setattr(self, name, nn.Parameter(tensors[name]))

    def __getitem__(self, name):
        return getattr(self, name)


class TransformerParams(nn.Module):
    """The model's parameters: ``embed`` [V, D], ``layers`` (one
    ``LayerParams`` per layer), ``ln_f`` [D], ``w_out`` [D, V]."""

    def __init__(self, embed, layers, ln_f, w_out):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(LayerParams(t) for t in layers)
        self.ln_f = nn.Parameter(ln_f)
        self.w_out = nn.Parameter(w_out)

    def __getitem__(self, name):
        return getattr(self, name)


def n_params(params):
    """Number of scalar parameters."""
    return sum(p.numel() for p in params.parameters())


def _resolve_device(ctx, mesh=None):
    if mesh is not None:
        devs = list(mesh) if isinstance(mesh, (list, tuple)) else None
        if devs is None or len(devs) != 1:
            raise NotImplementedError(
                "make_train_step: mesh must be None or one device; a "
                "multi-device mesh waits for the multi-GPU slice (got %r)"
                % (mesh,))
        if ctx is None:
            ctx = devs[0]
    return as_device(ctx)


def init_params(generator_or_seed, cfg: TransformerConfig, ctx=None):
    """Random parameters with the JAX package's structure and scales:
    weights ~ N(0, 1/fan_in) drawn in float32 and cast to ``cfg.dtype``;
    the embedding scaled by D**0.5 in ``cfg.dtype`` (a weakly typed scalar,
    as in JAX); norms at one. ``generator_or_seed`` is a ``torch.Generator``
    on the target device or an int seed. The values are not JAX's (another
    generator); ``convert.transformer_params_from_numpy`` carries JAX's."""
    _check_supported(cfg)
    dev = as_device(ctx)
    dt = canonical_dtype(cfg.dtype)
    if isinstance(generator_or_seed, torch.Generator):
        gen = generator_or_seed
    else:
        gen = torch.Generator(device=dev).manual_seed(int(generator_or_seed))
    D, V = cfg.dim, cfg.vocab_size

    def norm(shape, fan_in):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * fan_in ** -0.5).to(dt)

    fan_in = {"wq": D, "wk": D, "wv": D, "wo": D, "w_gate": D, "w_up": D,
              "w_down": cfg.ffn_hidden}
    layers = []
    for _ in range(cfg.n_layers):
        t = {}
        for name, shape in _layer_shapes(cfg).items():
            t[name] = torch.ones(shape, dtype=dt, device=dev) \
                if name in ("ln1", "ln2") else norm(shape, fan_in[name])
        layers.append(t)
    embed = norm((V, D), D)
    embed = embed * weak_scalar(D ** 0.5, dt)
    w_out = norm((D, V), D)
    return TransformerParams(embed, layers,
                             torch.ones(D, dtype=dt, device=dev), w_out)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _rms_norm(x, scale, eps=1e-6):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _rope(x, positions):
    """Rotary position embedding in float32, cast back to x's dtype.
    x: [B, S, H, Dh] (the JAX package transposes to [B, H, S, Dh] and back
    around it; the values are the same); positions: [S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    ang = positions[:, None].float() * freqs[None, :]          # [S, half]
    ang = ang[:, None, :]                                      # [S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return rot.to(x.dtype)


def _attention(cfg, mesh, q, k, v, positions):
    """q/k/v: [B, S, H, Dh] -> [B, S, H, Dh]. ``local`` mode: the flash
    kernels when S is a multiple of 128, else ``attention_reference`` (the
    JAX package's dispatch); ``blockwise`` mode: ``blockwise_attention``.
    The op that makes the output is tagged ``"attn_o"``: the flash
    forward, the reference as a whole, blockwise's final normalisation."""
    del mesh, positions
    if cfg.attn_mode in ("ring", "ring_flash", "ulysses"):
        raise NotImplementedError(
            "attn_mode=%r is not ported yet: sequence-parallel attention "
            "waits for the multi-GPU slice" % cfg.attn_mode)
    if cfg.attn_mode not in ("local", "blockwise"):
        raise ValueError("unknown attn_mode %r" % cfg.attn_mode)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # [B, H, S, Dh]
    if cfg.attn_mode == "blockwise":
        o, l = _blockwise_accumulate(qt, kt, vt, causal=cfg.causal)
        with checkpoint_name("attn_o"):
            ot = _blockwise_normalize(o, l)
    elif qt.shape[2] % 128 == 0:
        with checkpoint_name("attn_o"):
            ot = flash_attention(qt, kt, vt, causal=cfg.causal)
    else:
        with checkpoint_name("attn_o"):
            ot = attention_reference(qt, kt, vt, causal=cfg.causal)
    return ot.transpose(1, 2)


def _proj(x, w):
    """x [..., K] @ w [K, *out] -> [..., *out] (an einsum over x's last and
    w's first axis)."""
    out = torch.matmul(x.reshape(-1, x.shape[-1]), w.reshape(w.shape[0], -1))
    return out.reshape(tuple(x.shape[:-1]) + tuple(w.shape[1:]))


def _layer_body(cfg, mesh, positions, x, lp):
    """One transformer layer. x: [B, S, D]; lp: this layer's params."""
    h = _rms_norm(x, lp["ln1"])
    q = _rope(_proj(h, lp["wq"]), positions)                # [B, S, H, Dh]
    k = _rope(_proj(h, lp["wk"]), positions)
    v = _proj(h, lp["wv"])
    o = _attention(cfg, mesh, q, k, v, positions)
    x = x + _proj(o.reshape(o.shape[0], o.shape[1], -1),
                  lp["wo"].reshape(-1, cfg.dim))
    h = _rms_norm(x, lp["ln2"])
    g = torch.nn.functional.silu(_proj(h, lp["w_gate"]))
    u = _proj(h, lp["w_up"])
    with checkpoint_name("ffn_prod"):
        prod = g * u
    return x + _proj(prod, lp["w_down"])


def _remat_context(cfg):
    """The checkpoint regions' context: full recompute, or with
    ``cfg.remat_save`` a selective policy keeping the tagged values."""
    from torch.utils.checkpoint import (create_selective_checkpoint_contexts,
                                        noop_context_fn)
    if not cfg.remat_save:
        return noop_context_fn
    names = tuple(cfg.remat_save)
    return lambda: create_selective_checkpoint_contexts(_remat_policy(names))


def _hidden(params, tokens, cfg, mesh):
    """Trunk forward up to (but excluding) the output projection; returns
    (x [B, S, D], summed aux loss: 0 without MoE)."""
    _check_supported(cfg)
    # embedding's backward sums repeated tokens in a fixed order
    x = torch.nn.functional.embedding(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    context_fn = _remat_context(cfg)
    for lp in params["layers"]:
        if cfg.remat:
            x = checkpoint(_layer_body, cfg, mesh, positions, x, lp,
                           use_reentrant=False, context_fn=context_fn)
        else:
            x = _layer_body(cfg, mesh, positions, x, lp)
    return _rms_norm(x, params["ln_f"]), 0.0


def apply(params, tokens, cfg: TransformerConfig, mesh=None,
          return_aux=False):
    """Forward: tokens [B, S] int -> logits [B, S, V] in the model dtype.
    With return_aux, also returns the summed MoE aux loss (0 here)."""
    x, aux = _hidden(params, tokens, cfg, mesh)
    logits = _proj(x, params["w_out"])
    if return_aux:
        return logits, aux
    return logits


class _LogitsF32(torch.autograd.Function):
    """x [N, D] @ w [D, V] with a float32 result whatever the operands'
    dtype (``preferred_element_type=f32``); the gradients come back in the
    operands' dtypes, products accumulated in float32."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _f32_matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _f32_matmul(g, w.t()).to(x.dtype)
        dw = _f32_matmul(x.t(), g).to(w.dtype)
        return dx, dw


def _chunk_nll(xi, ti, w_out):
    b, c, d = xi.shape
    logits = _LogitsF32.apply(xi.reshape(b * c, d), w_out)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, ti.reshape(-1, 1))[:, 0]
    return torch.sum(lse - tgt)


def _chunked_ce(x, w_out, targets, n_chunks):
    """Mean token NLL with the vocab projection done per sequence chunk:
    chunks run one after the other, and each is recomputed in the backward
    instead of saving its [B, S/n, V] f32 logits."""
    B, S, _ = x.shape
    C = S // n_chunks
    total = []
    for i in range(n_chunks):
        xi = x[:, i * C:(i + 1) * C]
        ti = targets[:, i * C:(i + 1) * C]
        total.append(checkpoint(_chunk_nll, xi, ti, w_out,
                                use_reentrant=False))
    return torch.sum(torch.stack(total)) / (B * S)


def _mesh_sizes(mesh):
    if mesh is None:
        return {}
    if isinstance(mesh, (list, tuple)) and len(mesh) == 1:
        return {"dp": 1, "sp": 1, "tp": 1}
    raise NotImplementedError("a multi-device mesh waits for the multi-GPU "
                              "slice (got %r)" % (mesh,))


def ce_local_accum_active(cfg, mesh, batch, seq):
    """Whether this (cfg, mesh, batch shape) runs the single-reduction
    chunked CE. The JAX package selects it only when the mesh shards the
    batch (dp*sp > 1) or ``cfg.ce_local_accum`` forces it; on one device,
    the only mesh ported, it is off. ``ce_local_accum=True`` raises
    NotImplementedError (``_check_supported``) until the multi-GPU slice
    ports it."""
    del batch, seq
    _check_supported(cfg)
    _mesh_sizes(mesh)
    return False


def loss_fn(params, tokens, targets, cfg, mesh=None, aux_weight=0.01):
    """Mean next-token cross-entropy (float32 scalar)."""
    del aux_weight                       # MoE only
    if cfg.loss_chunks > 1:
        if tokens.shape[1] % cfg.loss_chunks != 0:
            raise ValueError(
                "loss_chunks=%d does not divide seq_len=%d; pick a divisor "
                "or set loss_chunks=1" % (cfg.loss_chunks, tokens.shape[1]))
        x, _ = _hidden(params, tokens, cfg, mesh)
        return _chunked_ce(x, params["w_out"], targets, cfg.loss_chunks)
    logits = apply(params, tokens, cfg, mesh)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -torch.mean(ll)


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

@torch.no_grad()
def _sgd_momentum(ps, gs, ms, mu, lr):
    """In place: m = mu*m + g, then p = p - lr*m, each op rounded to the
    tensors' dtype (mu and lr already rounded as JAX's weak typing does)."""
    torch._foreach_mul_(ms, mu)
    torch._foreach_add_(ms, gs)
    torch._foreach_sub_(ps, torch._foreach_mul(ms, lr))


def make_train_step(cfg: TransformerConfig, mesh=None, learning_rate=1e-3,
                    ctx=None):
    """Return (init_fn, step_fn) for one device.

    init_fn(generator_or_seed) -> (params, momentum): parameters on the
    device (``ctx``, or the one device of ``mesh``; default ``gpu(0)``) and
    a zero momentum per parameter ({name: tensor}).
    step_fn(state, tokens, targets) -> (state, loss): one SGD-momentum step,
    ``m = 0.9*m + g; p = p - lr*m``, with 0.9 and lr rounded to the
    parameter dtype first (JAX's weak typing). The update is in place on
    the state's tensors: it replaces the JAX step's buffer donation, and the
    returned state is the one passed in.

    ``mesh`` is None or a one-element sequence holding a device; a
    multi-device mesh raises NotImplementedError, as do pipeline stages
    and MoE."""
    _check_supported(cfg)
    dev = _resolve_device(ctx, mesh)
    one_mesh = None if mesh is None else [dev]

    def init_fn(generator_or_seed):
        params = init_params(generator_or_seed, cfg, ctx=dev)
        momentum = {n: torch.zeros_like(p)
                    for n, p in params.named_parameters()}
        return params, momentum

    dt = canonical_dtype(cfg.dtype)
    mu, lr = weak_scalar(0.9, dt), weak_scalar(learning_rate, dt)

    def step_fn(state, tokens, targets):
        params, mom = state
        named = list(params.named_parameters())
        for _, p in named:
            p.grad = None
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        loss = loss_fn(params, tokens, targets, cfg, one_mesh)
        loss.backward()
        ps = [p.data for _, p in named]
        gs = [p.grad for _, p in named]
        ms = [mom[n] for n, _ in named]
        missing = [n for (n, _), g in zip(named, gs) if g is None]
        if missing:
            raise MXNetError("no gradient for %s" % missing)
        _sgd_momentum(ps, gs, ms, mu, lr)
        for _, p in named:
            p.grad = None
        return (params, mom), loss.detach()

    return init_fn, step_fn
