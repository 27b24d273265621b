"""The port's transformer LM (mxnet_tpu_torch/parallel/transformer.py) held
against the JAX package's (mxnet_tpu/parallel/transformer.py), GSPMD mode
with pp == 1, on the CPU.

Weights cross over with ``convert.transformer_params_from_numpy``. Two tiny
configurations: S = 16 takes the dense ``attention_reference`` in both
packages; S = 128 (a multiple of 128) takes ``flash_attention``, whose CPU
route is the kernels' plain versions in the port and the jnp reference in
the JAX package.

``attn_mode="blockwise"``: ``ring_attention.blockwise_attention`` against
JAX's, causal and not, S not a multiple of the block, float32 and
bfloat16 (m, l and o carried in q's dtype), with ``jax.vjp`` gradients,
and the LM's loss and gradients in that mode. ``remat_save`` ("attn_o",
"ffn_prod", both): the same bits as full recompute, and JAX's
``save_only_these_names`` results within the float32 bound; with
"attn_o" saved the backward runs no attention forward (its CPU calls
counted).
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.parallel import create_mesh
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.kernels import flash_attention as FA
from mxnet_tpu_torch.parallel import ring_attention as RA
from mxnet_tpu_torch.parallel import transformer as T

JT = importlib.import_module("mxnet_tpu.parallel.transformer")
JRA = importlib.import_module("mxnet_tpu.parallel.ring_attention")

# f32: logits and loss agree to float32 rounding of two summation orders
# through a few layers; gradients, momentum and weights likewise, relative
# to each tensor's largest magnitude.
F32_RTOL = 2e-5
# bf16: a compiled JAX step keeps excess precision inside fused bf16 ops
# (XLA may skip a rounding the port performs), so single values flip by a
# bf16 step and the flips propagate through the layers. Logits and losses:
# within 2^-5 of the largest magnitude (a few bf16 steps); gradients, the
# first step's momentum: 2^-4 of the largest magnitude.
BF16_RTOL = {"logits": 2.0 ** -5, "loss": 2.0 ** -7, "grad": 2.0 ** -4}

CFGS = {
    # tests/test_parallel.py's _tiny_cfg: the dense attention branch
    "s16": (dict(vocab_size=64, dim=16, n_layers=2, n_heads=4,
                 ffn_hidden=32), 16),
    # S = 128: the flash branch, head dim 64
    "s128": (dict(vocab_size=64, dim=128, n_layers=2, n_heads=2,
                  ffn_hidden=64), 128),
}


def _setup(name, dtype="float32", **kw):
    base, S = CFGS[name]
    base = dict(base, dtype=dtype, **kw)
    jc, tc = JT.TransformerConfig(**base), T.TransformerConfig(**base)
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    tree = _tree_np(jp)
    tp = convert.transformer_params_from_numpy(tree, tc, ctx=mx.cpu())
    rs = np.random.RandomState(1)
    tok = rs.randint(0, base["vocab_size"], (2, S)).astype("int32")
    tgt = rs.randint(0, base["vocab_size"], (2, S)).astype("int32")
    return jc, tc, jp, tp, tok, tgt


def _tree_np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_tree(params, what=None):
    """{"embed": a, "layers": {name: [L, ...]}, ...} of the port's
    parameters (or of ``what``: {structural name: tensor})."""
    vals = dict(params.named_parameters()) if what is None else what
    L = len(params["layers"])
    out = {k: _np(vals[k]) for k in ("embed", "ln_f", "w_out")}
    out["layers"] = {k: np.stack([_np(vals["layers.%d.%s" % (i, k)])
                                  for i in range(L)])
                     for k in T._LAYER_SHAPES}
    return out


def _worst(port, jax_tree):
    flat_p = jax.tree_util.tree_leaves(port)
    flat_j = jax.tree_util.tree_leaves(jax_tree)
    return max(_rel(a, b) for a, b in zip(flat_p, flat_j))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_apply_matches_jax(name):
    for dtype in ("float32", "bfloat16"):
        jc, tc, jp, tp, tok, _ = _setup(name, dtype)
        want = JT.apply(jp, jnp.asarray(tok), jc)
        got = T.apply(tp, torch.from_numpy(tok).long(), tc)
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == tuple(want.shape)
        bound = F32_RTOL if dtype == "float32" else BF16_RTOL["logits"]
        assert _rel(got, want) <= bound, (dtype, _rel(got, want))


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_loss_and_grads_match_jax_f32(name, chunks):
    jc, tc, jp, tp, tok, tgt = _setup(name, loss_chunks=chunks)
    jl, jg = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(tok),
                                            jnp.asarray(tgt), jc)
    loss = T.loss_fn(tp, torch.from_numpy(tok).long(),
                     torch.from_numpy(tgt).long(), tc)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - float(jl)) <= F32_RTOL * abs(float(jl))
    grads = {n: p.grad for n, p in tp.named_parameters()}
    assert _worst(_port_tree(tp, grads), _tree_np(jg)) <= F32_RTOL


@pytest.mark.parametrize("name", sorted(CFGS))
def test_loss_and_grads_match_jax_bf16(name):
    jc, tc, jp, tp, tok, tgt = _setup(name, "bfloat16", loss_chunks=2)
    jl, jg = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(tok),
                                            jnp.asarray(tgt), jc)
    loss = T.loss_fn(tp, torch.from_numpy(tok).long(),
                     torch.from_numpy(tgt).long(), tc)
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(loss.item() - float(jl)) <= BF16_RTOL["loss"] * abs(float(jl))
    for n, p in tp.named_parameters():
        assert p.grad.dtype == torch.bfloat16, n
    grads = {n: p.grad for n, p in tp.named_parameters()}
    assert _worst(_port_tree(tp, grads), _tree_np(jg)) <= BF16_RTOL["grad"]


def _jax_steps(jc, jp, tok, tgt, lr, steps):
    mesh = create_mesh(devices=jax.devices()[:1], dp=1)
    _, step_fn = JT.make_train_step(jc, mesh, learning_rate=lr)
    state = (jp, jax.tree_util.tree_map(jnp.zeros_like, jp))
    losses = []
    with mesh.mesh:
        for _ in range(steps):
            state, loss = step_fn(state, jnp.asarray(tok), jnp.asarray(tgt))
            losses.append(float(loss))
    return state, losses


def _port_steps(tc, tp, tok, tgt, lr, steps):
    init_fn, step_fn = T.make_train_step(tc, mesh=[mx.cpu()],
                                         learning_rate=lr)
    mom = {n: torch.zeros_like(p) for n, p in tp.named_parameters()}
    state = (tp, mom)
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, tok, tgt)
        losses.append(float(loss))
    return state, losses


@pytest.mark.parametrize("name", sorted(CFGS))
def test_train_step_matches_jax_f32(name):
    """Three SGD-momentum steps against the JAX step on a one-device mesh:
    losses, weights and momentum."""
    jc, tc, jp, tp, tok, tgt = _setup(name, loss_chunks=2)
    (jparams, jmom), jlosses = _jax_steps(jc, jp, tok, tgt, 0.1, 3)
    (params, mom), losses = _port_steps(tc, tp, tok, tgt, 0.1, 3)
    np.testing.assert_allclose(losses, jlosses, rtol=F32_RTOL)
    assert losses[-1] < losses[0]
    assert _worst(_port_tree(params), _tree_np(jparams)) <= F32_RTOL
    assert _worst(_port_tree(params, mom), _tree_np(jmom)) <= 5 * F32_RTOL


@pytest.mark.parametrize("name", sorted(CFGS))
def test_train_step_matches_jax_bf16(name):
    """Three bf16 steps from the same weights: the losses, and the momentum
    (a sum of gradients) within the bf16 gradient bound; the updated
    weights within one bf16 step of their magnitude (lr * m is small
    beside w)."""
    jc, tc, jp, tp, tok, tgt = _setup(name, "bfloat16", loss_chunks=2)
    (jparams, jmom), jlosses = _jax_steps(jc, jp, tok, tgt, 1e-3, 3)
    (params, mom), losses = _port_steps(tc, tp, tok, tgt, 1e-3, 3)
    np.testing.assert_allclose(losses, jlosses, rtol=BF16_RTOL["loss"])
    for t in list(mom.values()) + list(params.parameters()):
        assert t.dtype == torch.bfloat16
    assert _worst(_port_tree(params, mom), _tree_np(jmom)) \
        <= BF16_RTOL["grad"]
    assert _worst(_port_tree(params), _tree_np(jparams)) <= 2.0 ** -7


def test_bf16_update_rounds_scalars_like_jax():
    """The update's weakly typed scalars: from the same gradients, bf16
    momentum and weights equal JAX's op-by-op update bit for bit."""
    rs = np.random.RandomState(2)
    p, m, g = (rs.randn(4096).astype("float32") for _ in range(3))
    jp, jm, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (p, m, g))
    jm = 0.9 * jm + jg
    jp = jp - 0.01 * jm
    tp, tm, tg = (torch.from_numpy(a).bfloat16() for a in (p, m, g))
    T._sgd_momentum([tp], [tg], [tm], T.weak_scalar(0.9, torch.bfloat16),
                    T.weak_scalar(0.01, torch.bfloat16))
    np.testing.assert_array_equal(_np(tm), _np(jm))
    np.testing.assert_array_equal(_np(tp), _np(jp))


def test_flash_branch_is_taken_at_multiples_of_128(monkeypatch):
    calls = []
    real = T.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(T, "flash_attention", spy)
    for name, want in (("s16", 0), ("s128", 2)):
        _, tc, _, tp, tok, _ = _setup(name)
        T.apply(tp, torch.from_numpy(tok).long(), tc)
        assert len(calls) == want, (name, calls)


def test_remat_does_not_change_results():
    _, tc, _, tp, tok, tgt = _setup("s128", loss_chunks=2)
    grads = []
    for remat in (True, False):
        tc.remat = remat
        for p in tp.parameters():
            p.grad = None
        T.loss_fn(tp, torch.from_numpy(tok).long(),
                  torch.from_numpy(tgt).long(), tc).backward()
        grads.append([p.grad.clone() for p in tp.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_init_params_structure_matches_jax():
    kw = dict(CFGS["s16"][0], dtype="bfloat16")
    jp = JT.init_params(jax.random.PRNGKey(0), JT.TransformerConfig(**kw))
    tp = T.init_params(0, T.TransformerConfig(**kw), ctx=mx.cpu())
    want = _tree_np(jp)
    got = _port_tree(tp)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape
    assert all(p.dtype == torch.bfloat16 for p in tp.parameters())
    assert T.n_params(tp) == sum(a.size for a in
                                 jax.tree_util.tree_leaves(want))
    # scales: the embedding ~ N(0, 1) after * D**0.5, weights ~ 1/sqrt(D)
    assert 0.8 < float(tp.embed.float().std()) < 1.2
    assert 0.8 < float(tp.layers[0].wq.float().std()) * 16 ** 0.5 < 1.2


def test_ce_local_accum_matches_jax_single_device(monkeypatch):
    """Off on one device, as in JAX; the port reads no environment
    variable, so JAX's ``MXTPU_CE_LOCAL_ACCUM`` settings that keep it off
    agree with the port."""
    mesh = create_mesh(devices=jax.devices()[:1], dp=1)
    for env in ("auto", "0"):
        monkeypatch.setenv("MXTPU_CE_LOCAL_ACCUM", env)
        for chunks, forced in ((1, None), (2, None), (2, False)):
            kw = dict(CFGS["s16"][0], loss_chunks=chunks,
                      ce_local_accum=forced)
            jc, tc = JT.TransformerConfig(**kw), T.TransformerConfig(**kw)
            for jm, tm in ((None, None), (mesh, [mx.cpu()])):
                assert T.ce_local_accum_active(tc, tm, 2, 16) == \
                    JT.ce_local_accum_active(jc, jm, 2, 16)


@pytest.mark.parametrize("kw", [dict(attn_mode="ring"),
                                dict(attn_mode="ulysses"),
                                dict(attn_mode="ring_flash"),
                                dict(attn_mode="ring", causal=False),
                                dict(num_experts=4),
                                dict(pp=2, n_microbatch=2),
                                dict(num_experts=2, moe_k=1)])
def test_unported_modes_raise(kw):
    _, tc, _, tp, tok, tgt = _setup("s16")
    tc = T.TransformerConfig(**dict(CFGS["s16"][0], **kw))
    with pytest.raises(NotImplementedError):
        T.loss_fn(tp, torch.from_numpy(tok).long(),
                  torch.from_numpy(tgt).long(), tc)


def test_multi_device_mesh_and_forced_local_ce_raise(monkeypatch):
    tc = T.TransformerConfig(**CFGS["s16"][0])
    with pytest.raises(NotImplementedError):
        T.make_train_step(tc, mesh=[mx.cpu(), mx.cpu()], ctx=mx.cpu())
    with pytest.raises(NotImplementedError):
        T.make_train_step(tc, mesh="dp=2", ctx=mx.cpu())
    _, tc, _, tp, tok, tgt = _setup("s16", loss_chunks=2)
    forced = T.TransformerConfig(**dict(CFGS["s16"][0], loss_chunks=2,
                                        ce_local_accum=True))
    for mesh in (None, [mx.cpu()]):
        with pytest.raises(NotImplementedError):
            T.loss_fn(tp, torch.from_numpy(tok).long(),
                      torch.from_numpy(tgt).long(), forced, mesh=mesh)
        with pytest.raises(NotImplementedError):
            T.ce_local_accum_active(forced, mesh, 2, 16)
    with pytest.raises(ValueError, match="loss_chunks"):
        T.loss_fn(tp, torch.from_numpy(tok[:, :15]).long(),
                  torch.from_numpy(tgt[:, :15]).long(), tc)


def test_converter_is_strict():
    kw = CFGS["s16"][0]
    tc = T.TransformerConfig(**kw)
    tree = _tree_np(JT.init_params(jax.random.PRNGKey(0),
                                   JT.TransformerConfig(**kw)))
    bad = dict(tree)
    del bad["ln_f"]
    with pytest.raises(KeyError):
        convert.transformer_params_from_numpy(bad, tc, ctx=mx.cpu())
    bad = dict(tree, extra=np.zeros(1))
    with pytest.raises(KeyError):
        convert.transformer_params_from_numpy(bad, tc, ctx=mx.cpu())
    bad = dict(tree, layers=dict(tree["layers"]))
    del bad["layers"]["wq"]
    with pytest.raises(KeyError):
        convert.transformer_params_from_numpy(bad, tc, ctx=mx.cpu())
    bad = dict(tree, layers=dict(tree["layers"],
                                 wq=tree["layers"]["wq"][:1]))
    with pytest.raises(ValueError):
        convert.transformer_params_from_numpy(bad, tc, ctx=mx.cpu())
    bad = dict(tree, w_out=tree["w_out"].T)
    with pytest.raises(ValueError):
        convert.transformer_params_from_numpy(bad, tc, ctx=mx.cpu())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tc = T.TransformerConfig(**CFGS["s16"][0])
    with pytest.raises(mx.MXNetError):
        T.init_params(0, tc)
    with pytest.raises(mx.MXNetError):
        T.make_train_step(tc)


# -- blockwise attention and selective recompute ------------------------------

BLOCKWISE_CASES = [(37, 16, True), (37, 16, False), (64, 32, True),
                   (20, 512, True), (48, 48, False)]


@pytest.mark.parametrize("S,block,causal", BLOCKWISE_CASES,
                         ids=["s%d-b%d-%s" % (S, b, "causal" if c else "full")
                              for S, b, c in BLOCKWISE_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_attention_matches_jax(S, block, causal, dtype):
    rs = np.random.RandomState(S + block)
    q, k, v, do = (rs.randn(2, 3, S, 16).astype(np.float32)
                   for _ in range(4))
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    want, vjp = jax.vjp(lambda a, b, c: JRA.blockwise_attention(
        a, b, c, block_size=block, causal=causal), jq, jk, jv)
    jgrads = vjp(jdo)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  .requires_grad_() for a in (q, k, v))
    got = RA.blockwise_attention(tq, tk, tv, block_size=block,
                                 causal=causal)
    assert got.dtype == getattr(torch, dtype) and str(want.dtype) == dtype
    got.backward(torch.from_numpy(do).to(getattr(torch, dtype)))
    bound = F32_RTOL if dtype == "float32" else BF16_RTOL["logits"]
    assert _rel(got, want) <= bound, _rel(got, want)
    gbound = F32_RTOL if dtype == "float32" else BF16_RTOL["grad"]
    for t, g in zip((tq, tk, tv), jgrads):
        assert t.grad.dtype == t.dtype
        assert _rel(t.grad, g) <= gbound, _rel(t.grad, g)
    o, l = RA._accumulate(tq.detach(), tk.detach(), tv.detach(), block,
                          causal)
    assert o.dtype == l.dtype == getattr(torch, dtype)


def test_attn_block_fully_masked_row_gives_zeros_as_jax():
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(1, 2, 4, 8).astype(np.float32) for _ in range(3))
    bias = np.zeros((1, 1, 4, 4), np.float32)
    bias[..., 1, :] = -np.inf                   # row 1 sees no key
    bias[..., 2, 3] = -np.inf
    m0 = np.full((1, 2, 4), -np.inf, np.float32)
    l0 = np.zeros((1, 2, 4), np.float32)
    o0 = np.zeros((1, 2, 4, 8), np.float32)
    want = JRA._attn_block(*(jnp.asarray(a) for a in
                             (q, k, v, bias, m0, l0, o0)), 8 ** -0.5)
    got = RA._attn_block(*(torch.from_numpy(a) for a in
                           (q, k, v, bias, m0, l0, o0)), 8 ** -0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-7)
    out = RA._normalize(got[2], got[1])
    assert torch.all(out[:, :, 1] == 0) and torch.isfinite(out).all()
    assert torch.all(torch.isneginf(got[0][:, :, 1]))


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_lm_matches_jax(name, dtype):
    jc, tc, jp, tp, tok, tgt = _setup(name, dtype, attn_mode="blockwise",
                                      loss_chunks=2)
    jl, jg = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(tok),
                                            jnp.asarray(tgt), jc)
    calls = []
    real = T.flash_attention
    T.flash_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        loss = T.loss_fn(tp, torch.from_numpy(tok).long(),
                         torch.from_numpy(tgt).long(), tc)
        loss.backward()
    finally:
        T.flash_attention = real
    assert calls == []
    f32 = dtype == "float32"
    lb = F32_RTOL if f32 else BF16_RTOL["loss"]
    assert abs(loss.item() - float(jl)) <= lb * abs(float(jl))
    grads = {n: p.grad for n, p in tp.named_parameters()}
    gb = F32_RTOL if f32 else BF16_RTOL["grad"]
    assert _worst(_port_tree(tp, grads), _tree_np(jg)) <= gb


def _loss_grads(tc, tp, tok, tgt):
    for p in tp.parameters():
        p.grad = None
    loss = T.loss_fn(tp, torch.from_numpy(tok).long(),
                     torch.from_numpy(tgt).long(), tc)
    loss.backward()
    return loss.detach().clone(), {n: p.grad.clone()
                                   for n, p in tp.named_parameters()}


SAVES = [(), ("attn_o",), ("ffn_prod",), ("attn_o", "ffn_prod")]


@pytest.mark.parametrize("save", SAVES[1:],
                         ids=["+".join(s) for s in SAVES[1:]])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_remat_save_same_bits_as_full_remat_and_matches_jax(name, save):
    jc, tc, jp, tp, tok, tgt = _setup(name, loss_chunks=2)
    full = _loss_grads(tc, tp, tok, tgt)
    tc.remat_save = save
    got = _loss_grads(tc, tp, tok, tgt)
    assert torch.equal(got[0], full[0])
    for n in full[1]:
        assert torch.equal(got[1][n], full[1][n]), n
    jc.remat_save = save
    jl, jg = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(tok),
                                            jnp.asarray(tgt), jc)
    assert abs(got[0].item() - float(jl)) <= F32_RTOL * abs(float(jl))
    assert _worst(_port_tree(tp, got[1]), _tree_np(jg)) <= F32_RTOL


@pytest.mark.parametrize("save,backward_calls", [
    ((), 2), (("attn_o",), 0), (("ffn_prod",), 2),
    (("attn_o", "ffn_prod"), 0)])
def test_attn_o_skips_the_attention_forward_in_the_backward(
        monkeypatch, save, backward_calls):
    """S = 128, two layers: the forward runs the flash forward (its CPU
    plain version) once per layer; full recompute runs it again per layer
    in the backward, and with "attn_o" kept it does not."""
    calls = [0]
    real = FA.flash_forward_reference

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    monkeypatch.setattr(FA, "flash_forward_reference", counting)
    _, tc, _, tp, tok, tgt = _setup("s128", loss_chunks=2,
                                    remat_save=save)
    loss = T.loss_fn(tp, torch.from_numpy(tok).long(),
                     torch.from_numpy(tgt).long(), tc)
    assert calls[0] == 2
    loss.backward()
    assert calls[0] - 2 == backward_calls


def test_remat_save_rejects_unknown_names():
    _, tc, _, tp, tok, tgt = _setup("s16")
    tc = T.TransformerConfig(**dict(CFGS["s16"][0], remat_save=("conv",)))
    with pytest.raises(ValueError, match="remat_save"):
        T.loss_fn(tp, torch.from_numpy(tok).long(),
                  torch.from_numpy(tgt).long(), tc)
