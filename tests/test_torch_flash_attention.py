"""The port's flash attention (mxnet_tpu_torch/kernels/flash_attention.py)
held against the JAX package's (mxnet_tpu/pallas_kernels/flash_attention.py).

On the CPU the JAX side runs its Pallas kernels in interpret mode
(``_pallas_forward``, ``_pallas_backward``) and its jnp reference; the port
runs its plain versions, which are what its wrappers take for a CPU tensor.
The CUDA kernels run only on the card: tests/test_torch_cuda.py holds them
against the plain versions there (``python3 chip_smoke.py`` does the same
at the transformer LM's shape).
"""
import functools
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as FA

JFA = importlib.import_module("mxnet_tpu.pallas_kernels.flash_attention")

# f32: the JAX suite's own bounds (tests/test_pallas.py: forward 1e-5,
# gradients 1e-4 against the dense reference); both sides keep f32
# products and differ only by summation order.
F32_ATOL = {"fwd": 1e-5, "bwd": 1e-4}
# bf16 outputs: one bf16 rounding step (2^-7 relative) of the output's
# magnitude, for a last-bit difference of two f32 accumulation orders.
BF16_RTOL = 2.0 ** -7

# (B, H, Sq, Sk, D, causal): causal and not, Sq != Sk, D 64 and 128,
# B*H <= 8, S <= 256, so that interpret mode stays quick
CASES = [(2, 2, 128, 128, 64, True), (1, 2, 128, 128, 128, False),
         (2, 1, 64, 128, 64, False), (1, 1, 256, 256, 64, True)]


def _qkv(B, H, Sq, Sk, D, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, Sq, D).astype("float32"),
            rs.randn(B, H, Sk, D).astype("float32"),
            rs.randn(B, H, Sk, D).astype("float32"),
            rs.randn(B, H, Sq, D).astype("float32"))


def _t(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _j(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_bf16(got, want):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    assert err <= BF16_RTOL * np.abs(want).max(), err


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_pallas_interpret_f32(case):
    B, H, Sq, Sk, D, causal = case
    q, k, v, _ = _qkv(B, H, Sq, Sk, D)
    scale = D ** -0.5
    o, lse = FA.flash_forward_reference(_t(q, torch.float32),
                                        _t(k, torch.float32),
                                        _t(v, torch.float32), causal, scale)
    jo, jl = JFA._pallas_forward(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, scale, 64, 128,
                                 True)
    assert tuple(lse.shape) == (B * H, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo),
                               atol=F32_ATOL["fwd"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[:, :, 0],
                               atol=F32_ATOL["fwd"])


@pytest.mark.parametrize("case", CASES[:2])
def test_forward_matches_pallas_interpret_bf16(case):
    B, H, Sq, Sk, D, causal = case
    q, k, v, _ = _qkv(B, H, Sq, Sk, D, seed=1)
    scale = D ** -0.5
    o, lse = FA.flash_forward_reference(*(_t(a, torch.bfloat16)
                                          for a in (q, k, v)), causal, scale)
    jo, jl = JFA._pallas_forward(*(_j(a, jnp.bfloat16) for a in (q, k, v)),
                                 causal, scale, 64, 128, True)
    assert o.dtype == torch.bfloat16
    _close_bf16(o, jo)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[:, :, 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_pallas_interpret_f32(case):
    B, H, Sq, Sk, D, causal = case
    q, k, v, do = _qkv(B, H, Sq, Sk, D, seed=2)
    scale = D ** -0.5
    tq, tk, tv, tdo = (_t(a, torch.float32) for a in (q, k, v, do))
    o, lse = FA.flash_forward_reference(tq, tk, tv, causal, scale)
    got = FA.flash_backward_reference(tq, tk, tv, o, lse, tdo, causal, scale)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jl = JFA._pallas_forward(jq, jk, jv, causal, scale, 64, 128, True)
    want = JFA._pallas_backward(jq, jk, jv, jo, jl[:, :, 0], jdo, causal,
                                scale, 64, 128, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=F32_ATOL["bwd"])


@pytest.mark.parametrize("case", CASES[:3])
def test_backward_matches_jax_vjp_of_reference_f32(case):
    B, H, Sq, Sk, D, causal = case
    q, k, v, do = _qkv(B, H, Sq, Sk, D, seed=3)
    tq, tk, tv, tdo = (_t(a, torch.float32) for a in (q, k, v, do))
    o, lse = FA._flash_forward(tq, tk, tv, causal, D ** -0.5)
    got = FA._flash_backward(tq, tk, tv, o, lse, tdo, causal, D ** -0.5)
    _, vjp = jax.vjp(lambda a, b, c: JFA.attention_reference(
        a, b, c, causal=causal), *(jnp.asarray(a) for a in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=F32_ATOL["bwd"])


def test_backward_matches_pallas_interpret_bf16():
    B, H, Sq, Sk, D, causal = CASES[0]
    q, k, v, do = _qkv(B, H, Sq, Sk, D, seed=4)
    scale = D ** -0.5
    tq, tk, tv, tdo = (_t(a, torch.bfloat16) for a in (q, k, v, do))
    o, lse = FA.flash_forward_reference(tq, tk, tv, causal, scale)
    got = FA.flash_backward_reference(tq, tk, tv, o, lse, tdo, causal, scale)
    jq, jk, jv, jdo = (_j(a, jnp.bfloat16) for a in (q, k, v, do))
    jo, jl = JFA._pallas_forward(jq, jk, jv, causal, scale, 64, 128, True)
    want = JFA._pallas_backward(jq, jk, jv, jo, jl[:, :, 0], jdo, causal,
                                scale, 64, 128, True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close_bf16(g, w)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    q, k, v, _ = _qkv(2, 2, 64, 64, 64, seed=5)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = FA.attention_reference(*(_t(a, dt) for a in (q, k, v)),
                                     causal=causal)
        want = JFA.attention_reference(*(_j(a, jdt) for a in (q, k, v)),
                                       causal=causal)
        assert got.dtype == dt
        if dt == torch.bfloat16:
            _close_bf16(got, want)
        else:
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_autograd_of_reference(causal):
    """flash_attention's gradient (the Function's plain backward) against
    torch.autograd through attention_reference, f32."""
    q, k, v, do = _qkv(1, 2, 128, 128, 64, seed=6)
    ins = [_t(a, torch.float32).requires_grad_() for a in (q, k, v)]
    ref = [_t(a, torch.float32).requires_grad_() for a in (q, k, v)]
    tdo = _t(do, torch.float32)
    FA.flash_attention(*ins, causal=causal).backward(tdo)
    FA.attention_reference(*ref, causal=causal).backward(tdo)
    for a, b in zip(ins, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=F32_ATOL["bwd"])


def test_flash_attention_matches_jax_public_call():
    """The public entry, causal and cross-attention, against the JAX
    package's flash_attention in interpret mode (f32)."""
    for (B, H, Sq, Sk, D, causal) in (CASES[0], CASES[2]):
        q, k, v, _ = _qkv(B, H, Sq, Sk, D, seed=7)
        got = FA.flash_attention(*(_t(a, torch.float32) for a in (q, k, v)),
                                 causal=causal, block_q=64, block_k=64)
        want = JFA.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=causal, block_q=64, block_k=64,
                                   interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_ATOL["fwd"])


def test_causal_unequal_lengths_raise_like_jax():
    q, k, v, _ = _qkv(1, 1, 64, 128, 64)
    with pytest.raises(ValueError, match="equal q/kv lengths"):
        FA.flash_attention(*(_t(a, torch.float32) for a in (q, k, v)),
                           causal=True)
    with pytest.raises(ValueError, match="equal q/kv lengths"):
        JFA.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                            causal=True, interpret=True)


def test_wrapper_rejects_bad_inputs():
    q, k, v, _ = _qkv(1, 2, 16, 16, 64)
    tq, tk, tv = (_t(a, torch.float32) for a in (q, k, v))
    with pytest.raises(ValueError):
        FA.flash_attention(tq, tk[:, :1], tv[:, :1])
    with pytest.raises(ValueError):
        FA.flash_attention(tq, tk.bfloat16(), tv)
    with pytest.raises(ValueError):
        FA.flash_attention(tq[0], tk[0], tv[0])
    with pytest.raises(MXNetError):
        FA._flash_forward(tq.to("meta"), tk.to("meta"), tv.to("meta"),
                          False, 0.125)


def test_strided_views_give_the_same_result():
    """[B, S, H, D] tensors seen as [B, H, S, D] (the transformer's layout)
    give what contiguous ones give, forward and backward."""
    q, k, v, do = _qkv(2, 2, 128, 128, 64, seed=8)
    cont = [_t(a, torch.float32).requires_grad_() for a in (q, k, v)]
    strd = [_t(a, torch.float32).transpose(1, 2).contiguous()
            .requires_grad_() for a in (q, k, v)]
    o1 = FA.flash_attention(*cont, causal=True)
    o2 = FA.flash_attention(*(t.transpose(1, 2) for t in strd), causal=True)
    o1.backward(_t(do, torch.float32))
    o2.backward(_t(do, torch.float32))
    np.testing.assert_array_equal(o1.detach().numpy(), o2.detach().numpy())
    for a, b in zip(cont, strd):
        np.testing.assert_array_equal(a.grad.numpy(),
                                      b.grad.transpose(1, 2).numpy())


def test_backward_halves_equal_the_whole():
    """backward_dq_reference and backward_dkv_reference (the dQ and the
    dK/dV kernel's plain functions) give flash_backward_reference's bits."""
    q, k, v, do = _qkv(1, 2, 64, 128, 64, seed=9)
    for dt in (torch.float32, torch.bfloat16):
        tq, tk, tv, tdo = (_t(a, dt) for a in (q, k, v, do))
        o, lse = FA.flash_forward_reference(tq, tk, tv, False, 0.125)
        dq, dk, dv = FA.flash_backward_reference(tq, tk, tv, o, lse, tdo)
        assert torch.equal(dq, FA.backward_dq_reference(tq, tk, tv, o, lse,
                                                        tdo))
        hk, hv = FA.backward_dkv_reference(tq, tk, tv, o, lse, tdo)
        assert torch.equal(dk, hk) and torch.equal(dv, hv)


# -- the bf16 forward kernel's decomposition ----------------------------------
# csrc/flash_attention.cu's bf16 forward: a block per TILE query rows of one
# (batch, head), split into two halves of HALF rows (one per consumer
# warpgroup); k tiles of TILE keys in order, up to the causal diagonal; the
# mask applied only where a tile crosses the half's diagonal or Sk; rows and
# keys past S read as zeros (TMA's fill) and rows past Sq never stored.
TILE, HALF = 128, 64


def _kernel_model(q, k, v, causal, scale):
    """The kernel's work in plain torch, at its rounding points: s =
    (q.k)*scale in f32, the running max m, p = exp(s - m) rounded to
    v.dtype before P@V, o = corr*o + p@v and l = corr*l + rowsum(p) in f32,
    o / l cast last, lse = m + log(l). Returns (o, lse, visits): visits
    maps (q tile, half) to its k tiles, each with whether it was masked."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nq, nkt = -(-sq // TILE), -(-sk // TILE)

    def pad(t, n):
        out = torch.zeros(b, h, n * TILE, d, dtype=t.dtype)
        out[:, :, :t.shape[2]] = t
        return out

    qp, kp, vp = pad(q, nq), pad(k, nkt), pad(v, nkt)
    o = torch.empty(b, h, sq, d, dtype=q.dtype)
    lse = torch.empty(b, h, sq, dtype=torch.float32)
    visits = {}
    for qt in range(nq):
        q0 = qt * TILE
        nk = nkt if not causal else min(nkt, (min(q0 + TILE, sq) - 1)
                                        // TILE + 1)
        for w in range(2):
            r0 = q0 + w * HALF
            rows = torch.arange(r0, r0 + HALF)
            qa = qp[:, :, r0:r0 + HALF].float()
            m = torch.full((b, h, HALF), float("-inf"))
            l = torch.zeros(b, h, HALF)
            acc = torch.zeros(b, h, HALF, d)
            visits[(qt, w)] = []
            for j in range(nk):
                cols = torch.arange(j * TILE, (j + 1) * TILE)
                kt, vt = kp[:, :, cols].float(), vp[:, :, cols]
                s = (qa @ kt.transpose(-1, -2)) * scale
                edge = (j + 1) * TILE > sk or \
                    (causal and (j + 1) * TILE - 1 > r0)
                if edge:
                    mask = cols[None, :] >= sk
                    if causal:
                        mask = mask | (cols[None, :] > rows[:, None])
                    s = s.masked_fill(mask, float("-inf"))
                visits[(qt, w)].append((j, edge))
                mx = torch.maximum(m, s.amax(dim=-1))
                corr = torch.exp(m - mx)
                p = torch.exp(s - mx[..., None])
                l = corr * l + p.sum(dim=-1)
                acc = acc * corr[..., None] + p.to(v.dtype).float() @ \
                    vt.float()
                m = mx
            keep = min(HALF, max(0, sq - r0))
            o[:, :, r0:r0 + keep] = (acc / l[..., None])[:, :, :keep] \
                .to(q.dtype)
            lse[:, :, r0:r0 + keep] = (m + torch.log(l))[:, :, :keep]
    return o, lse.reshape(b * h, sq), visits


def _check_visits(visits, sq, sk, causal):
    """Every (row < Sq, key < Sk) pair a half needs lies in a visited tile,
    a tile left out is wholly masked, and an unmasked tile needs no mask:
    skipping and masking lose nothing."""
    nkt = -(-sk // TILE)
    for (qt, w), tiles in visits.items():
        r0 = qt * TILE + w * HALF
        rows = [r for r in range(r0, r0 + HALF) if r < sq] or [r0]
        seen = [j for j, _ in tiles]
        assert seen == list(range(len(seen)))
        for j in range(nkt):
            cols = range(j * TILE, min((j + 1) * TILE, sk))
            needed = any(c <= r for c in cols for r in rows) \
                if causal else True
            if j not in seen:
                assert not needed, (qt, w, j)
        for j, edge in tiles:
            needs_mask = (j + 1) * TILE > sk or (
                causal and any(c > r for c in range(j * TILE, (j + 1)
                                                       * TILE)
                               for r in range(r0, r0 + HALF)))
            assert edge == needs_mask, (qt, w, j)


# (Sq, Sk): S in {100, 128, 257, 384} with Sq == Sk, causal and not; and
# cross-attention shapes (non-causal) with Sq != Sk.
MODEL_CASES = [(s, s, d, c) for s in (100, 128, 257, 384) for d in (64, 128)
               for c in (False, True)] + \
    [(sq, sk, d, False) for sq, sk in ((100, 257), (257, 128), (384, 100))
     for d in (64, 128)]


@pytest.mark.parametrize("sq,sk,d,causal", MODEL_CASES)
def test_forward_kernel_model_matches_reference_and_pallas(sq, sk, d,
                                                           causal):
    """The bf16 forward kernel's decomposition (128-key tiles, 64-row
    halves, the diagonal-tile mask, the ragged last tile) against
    flash_forward_reference and JAX's _pallas_forward in interpret mode,
    at the file's bf16 forward tolerances."""
    q, k, v, _ = _qkv(1, 2, sq, sk, d, seed=10)
    scale = d ** -0.5
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    o, lse, visits = _kernel_model(tq, tk, tv, causal, scale)
    _check_visits(visits, sq, sk, causal)
    if causal:
        # only the diagonal tile of each half is masked
        assert all([j for j, e in ts if e] == [qt] for (qt, _), ts in
                   visits.items())
    ro, rlse = FA.flash_forward_reference(tq, tk, tv, causal, scale)
    assert o.dtype == torch.bfloat16 and o.shape == ro.shape
    _close_bf16(o, ro)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), rtol=1e-5,
                               atol=1e-5)
    jo, jl = JFA._pallas_forward(*(_j(a, jnp.bfloat16) for a in (q, k, v)),
                                 causal, scale, TILE, TILE, True)
    _close_bf16(o, jo)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[:, :, 0],
                               rtol=1e-5, atol=1e-5)


# -- the bf16 dK/dV kernel's decomposition ------------------------------------
# csrc/flash_attention.cu's bf16 dK/dV: a block per KT keys of one (batch,
# head), split into two halves of HALF keys (one per consumer warpgroup); q
# tiles of QT rows in order, from the first that holds a query at or past
# the block's first key (causal), where the first tile (queries k0 ..
# k0+63) passes the second half by with no products; the mask applied only
# where a tile crosses the half's diagonal or Sq; rows past Sq and keys past
# Sk read as zeros (TMA's fill), lse and delta past Sq as zeros, and keys
# past Sk never stored.
KT, QT = 128, 64


def _dkv_model(q, k, v, o, lse, do, causal, scale):
    """The kernel's work in plain torch, at its rounding points: s^T =
    (k.q)*scale in f32, p^T = exp(s^T - lse) in f32, dS^T = p^T * (dP^T -
    delta) * scale, dV += bf16(p^T) dO and dK += bf16(dS^T) Q in f32 tile by
    tile, both cast last. Returns (dk, dv, visits): visits maps (key block,
    half) to its q tiles, each with whether it was masked, or None where the
    tile passed with no products."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nkb, nq = -(-sk // KT), -(-sq // QT)

    def pad(t, n):
        out = torch.zeros(t.shape[:2] + (n,) + t.shape[3:], dtype=t.dtype)
        out[:, :, :t.shape[2]] = t
        return out

    qp, dop = pad(q, nq * QT).float(), pad(do, nq * QT).float()
    kp, vp = pad(k, nkb * KT).float(), pad(v, nkb * KT).float()
    delta = (do.float() * o.float()).sum(dim=-1)
    lsep = pad(lse.reshape(b, h, sq, 1), nq * QT)[..., 0]
    deltap = pad(delta[..., None], nq * QT)[..., 0]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    visits = {}
    for kb in range(nkb):
        k0 = kb * KT
        t0 = k0 // QT if causal else 0
        for w in range(2):
            r0 = k0 + w * HALF
            keys = torch.arange(r0, r0 + HALF)
            ka, va = kp[:, :, r0:r0 + HALF], vp[:, :, r0:r0 + HALF]
            acc_k = torch.zeros(b, h, HALF, d)
            acc_v = torch.zeros(b, h, HALF, d)
            visits[(kb, w)] = []
            for tq in range(t0, nq):
                if causal and w == 1 and tq == t0:
                    visits[(kb, w)].append((tq, None))
                    continue
                rows = torch.arange(tq * QT, (tq + 1) * QT)
                qt, dot = qp[:, :, rows], dop[:, :, rows]
                st = (ka @ qt.transpose(-1, -2)) * scale
                edge = (tq + 1) * QT > sq or \
                    (causal and tq * QT < r0 + HALF)
                if edge:
                    mask = (rows[None, :] >= sq).expand(HALF, QT)
                    if causal:
                        mask = mask | (keys[:, None] > rows[None, :])
                    st = st.masked_fill(mask, float("-inf"))
                visits[(kb, w)].append((tq, edge))
                p = torch.exp(st - lsep[:, :, None, rows])
                dpt = va @ dot.transpose(-1, -2)
                ds = p * (dpt - deltap[:, :, None, rows]) * scale
                acc_v = acc_v + p.to(v.dtype).float() @ dot
                acc_k = acc_k + ds.to(q.dtype).float() @ qt
            keep = min(HALF, max(0, sk - r0))
            dk[:, :, r0:r0 + keep] = acc_k[:, :, :keep].to(k.dtype)
            dv[:, :, r0:r0 + keep] = acc_v[:, :, :keep].to(v.dtype)
    return dk, dv, visits


def _check_dkv_visits(visits, sq, sk, causal):
    """Every (key < Sk, row < Sq) pair a half needs lies in a tile it
    computed, a tile left out or passed is wholly masked for the half, and
    a tile computed unmasked needs no mask: skipping and masking lose
    nothing."""
    nq = -(-sq // QT)
    for (kb, w), tiles in visits.items():
        r0 = kb * KT + w * HALF
        keys = range(r0, min(r0 + HALF, sk))
        seen = [tq for tq, _ in tiles]
        assert seen == list(range(seen[0], nq)), (kb, w, seen)
        done = [tq for tq, e in tiles if e is not None]
        for tq in range(nq):
            rows = range(tq * QT, min((tq + 1) * QT, sq))
            needed = any(c <= r for c in keys for r in rows) \
                if causal else bool(keys)
            if tq not in done:
                assert not needed, (kb, w, tq)
                assert causal and all(c > r for c in range(r0, r0 + HALF)
                                      for r in range(tq * QT,
                                                     (tq + 1) * QT))
        for tq, edge in tiles:
            if edge is None:
                continue
            needs_mask = (tq + 1) * QT > sq or (causal and any(
                c > r for c in range(r0, r0 + HALF)
                for r in range(tq * QT, (tq + 1) * QT)))
            assert edge == needs_mask, (kb, w, tq)


@pytest.mark.parametrize("sq,sk,d,causal", MODEL_CASES)
def test_dkv_kernel_model_matches_reference_and_pallas(sq, sk, d, causal):
    """The bf16 dK/dV kernel's decomposition (128-key blocks, 64-key halves,
    64-row q tiles from the first the block needs, the diagonal-tile and
    ragged-tile masks, the tile passed by the second half, zero-filled rows
    past Sq and Sk) against backward_dkv_reference and JAX's
    _pallas_backward in interpret mode on the same o and lse, at the file's
    bf16 tolerance."""
    q, k, v, do = _qkv(1, 2, sq, sk, d, seed=11)
    scale = d ** -0.5
    tq, tk, tv, tdo = (_t(a, torch.bfloat16) for a in (q, k, v, do))
    o, lse = FA.flash_forward_reference(tq, tk, tv, causal, scale)
    dk, dv, visits = _dkv_model(tq, tk, tv, o, lse, tdo, causal, scale)
    _check_dkv_visits(visits, sq, sk, causal)
    if causal:
        # only the half's diagonal tile and a ragged last tile are masked;
        # the second half passes the block's first tile
        nq = -(-sq // QT)
        for (kb, w), tiles in visits.items():
            t0 = kb * KT // QT
            assert tiles[0] == (t0, None if w else True)
            masked = {tq for tq, e in tiles if e}
            assert masked - {nq - 1} <= {t0 + w} <= masked | {nq}
    rk, rv = FA.backward_dkv_reference(tq, tk, tv, o, lse, tdo, causal,
                                       scale)
    for got, want in ((dk, rk), (dv, rv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _close_bf16(got, want)
    _, jk, jv = JFA._pallas_backward(
        *(_j(_np(a), jnp.bfloat16) for a in (tq, tk, tv, o)),
        jnp.asarray(lse.numpy()), _j(do, jnp.bfloat16), causal, scale, KT,
        KT, True)
    _close_bf16(dk, jk)
    _close_bf16(dv, jv)


# -- the bf16 dQ kernel's decomposition ---------------------------------------
# csrc/flash_attention.cu's bf16 dQ: a block per TILE query rows of one
# (batch, head), split into two halves of HALF rows (one per consumer
# warpgroup); k tiles of bk keys (DQ_BN: 128, and 64 in
# chip_flash_probe.py's step_a and step_b) from 0 up to the last the block
# needs (causal) or all of them; a half skips the tiles wholly above its
# diagonal (at 64-key tiles the first half skips the block's last tile,
# where its rows end before it) and masks only the tile that crosses its
# diagonal and a ragged last tile; rows past Sq and keys past Sk read as
# zeros (TMA's fill), lse and delta past Sq as zeros, and rows past Sq never
# stored.
DQ_BN = 128


def _dq_model(q, k, v, o, lse, do, causal, scale, bk=DQ_BN):
    """The kernel's work in plain torch, at its rounding points: s =
    (q.k)*scale in f32, p = exp(s - lse) in f32, dS = p * (dP - delta) *
    scale, dQ += bf16(dS) K in f32 tile by tile, cast last. Returns (dq,
    visits): visits maps (query block, half) to the block's k tiles, each
    with whether it was masked, or None where the half skipped it."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nqb, nkt = -(-sq // TILE), -(-sk // bk)

    def pad(t, n):
        out = torch.zeros(t.shape[:2] + (n,) + t.shape[3:], dtype=t.dtype)
        out[:, :, :t.shape[2]] = t
        return out

    qp, dop = pad(q, nqb * TILE).float(), pad(do, nqb * TILE).float()
    kp, vp = pad(k, nkt * bk).float(), pad(v, nkt * bk).float()
    delta = (do.float() * o.float()).sum(dim=-1)
    lsep = pad(lse.reshape(b, h, sq, 1), nqb * TILE)[..., 0]
    deltap = pad(delta[..., None], nqb * TILE)[..., 0]
    dq = torch.empty_like(q)
    visits = {}
    for qb in range(nqb):
        q0 = qb * TILE
        nk = nkt if not causal else min(nkt, (min(q0 + TILE, sq) - 1)
                                        // bk + 1)
        for w in range(2):
            r0 = q0 + w * HALF
            rows = torch.arange(r0, r0 + HALF)
            nw = min(nk, (r0 + HALF - 1) // bk + 1) if causal else nk
            qa, doa = qp[:, :, r0:r0 + HALF], dop[:, :, r0:r0 + HALF]
            acc = torch.zeros(b, h, HALF, d)
            visits[(qb, w)] = []
            for j in range(nk):
                if j >= nw:
                    visits[(qb, w)].append((j, None))
                    continue
                cols = torch.arange(j * bk, (j + 1) * bk)
                kt, vt = kp[:, :, cols], vp[:, :, cols]
                s = (qa @ kt.transpose(-1, -2)) * scale
                edge = (j + 1) * bk > sk or \
                    (causal and j * bk + bk - 1 > r0)
                if edge:
                    mask = (cols[None, :] >= sk).expand(HALF, bk)
                    if causal:
                        mask = mask | (cols[None, :] > rows[:, None])
                    s = s.masked_fill(mask, float("-inf"))
                visits[(qb, w)].append((j, edge))
                p = torch.exp(s - lsep[:, :, r0:r0 + HALF, None])
                dp = doa @ vt.transpose(-1, -2)
                ds = p * (dp - deltap[:, :, r0:r0 + HALF, None]) * scale
                acc = acc + ds.to(q.dtype).float() @ kt
            keep = min(HALF, max(0, sq - r0))
            dq[:, :, r0:r0 + keep] = acc[:, :, :keep].to(q.dtype)
    return dq, visits


def _check_dq_visits(visits, sq, sk, causal, bk):
    """Every (row < Sq, key < Sk) pair a half needs lies in a tile it
    computed, a tile it skipped or the block left out is wholly masked for
    the half, and a tile computed unmasked needs no mask: skipping and
    masking lose nothing."""
    nkt = -(-sk // bk)
    for (qb, w), tiles in visits.items():
        r0 = qb * TILE + w * HALF
        rows = range(r0, min(r0 + HALF, sq))
        seen = [j for j, _ in tiles]
        assert seen == list(range(len(seen))), (qb, w, seen)
        done = [j for j, e in tiles if e is not None]
        for j in range(nkt):
            cols = range(j * bk, min((j + 1) * bk, sk))
            needed = any(c <= r for c in cols for r in rows) \
                if causal else bool(rows)
            if j not in done:
                assert not needed, (qb, w, j)
            if j in seen and j not in done:
                assert causal and all(c > r for c in range(j * bk,
                                                           (j + 1) * bk)
                                      for r in range(r0, r0 + HALF))
        for j, edge in tiles:
            if edge is None:
                continue
            needs_mask = (j + 1) * bk > sk or (causal and any(
                c > r for c in range(j * bk, (j + 1) * bk)
                for r in range(r0, r0 + HALF)))
            assert edge == needs_mask, (qb, w, j)


# MODEL_CASES and causal S = 130, whose last block holds two rows: all in
# its first half, so that the second half holds no row at all.
DQ_CASES = MODEL_CASES + [(130, 130, d, True) for d in (64, 128)]


@functools.lru_cache(maxsize=None)
def _dq_case(sq, sk, d, causal):
    """bf16 q, k, v, dO, the plain forward's o and lse, and JAX's dq from
    _pallas_backward in interpret mode on them."""
    q, k, v, do = _qkv(1, 2, sq, sk, d, seed=12)
    scale = d ** -0.5
    tq, tk, tv, tdo = (_t(a, torch.bfloat16) for a in (q, k, v, do))
    o, lse = FA.flash_forward_reference(tq, tk, tv, causal, scale)
    jq, _, _ = JFA._pallas_backward(
        *(_j(_np(a), jnp.bfloat16) for a in (tq, tk, tv, o)),
        jnp.asarray(lse.numpy()), _j(do, jnp.bfloat16), causal, scale, TILE,
        TILE, True)
    return tq, tk, tv, tdo, o, lse, _np(jq)


@pytest.mark.parametrize("bk", [DQ_BN, 64])
@pytest.mark.parametrize("sq,sk,d,causal", DQ_CASES)
def test_dq_kernel_model_matches_reference_and_pallas(sq, sk, d, causal,
                                                      bk):
    """The bf16 dQ kernel's decomposition (128-row blocks, 64-row halves,
    bk-key tiles from 0, the per-half causal skip, the diagonal-tile and
    ragged-tile masks, zero-filled rows past Sq and keys past Sk) against
    backward_dq_reference and JAX's _pallas_backward in interpret mode on
    the same o and lse, at the file's bf16 tolerance: at the kernel's
    128-key tiles and the probe's 64."""
    tq, tk, tv, tdo, o, lse, jq = _dq_case(sq, sk, d, causal)
    scale = d ** -0.5
    dq, visits = _dq_model(tq, tk, tv, o, lse, tdo, causal, scale, bk)
    _check_dq_visits(visits, sq, sk, causal, bk)
    nkt = -(-sk // bk)
    for (qb, w), tiles in visits.items():
        r0 = qb * TILE + w * HALF
        masked = {j for j, e in tiles if e}
        skipped = [j for j, e in tiles if e is None]
        # only the half's diagonal tile and a ragged last tile are masked;
        # only the first half skips, only the block's last tile, and only
        # where a tile is narrower than the block
        assert masked <= ({r0 // bk} if causal else set()) | (
            {nkt - 1} if sk % bk else set()), (qb, w, masked)
        if causal and r0 // bk < len(tiles):
            assert r0 // bk in masked
        assert skipped in ([], [len(tiles) - 1]) and (w == 0 or not skipped)
        assert bk < TILE or not skipped
    if (sq, causal) == (130, True):
        assert all(r >= sq for r in range(TILE + HALF, 2 * TILE))
        assert [j for j, e in visits[(1, 1)]] == list(range(nkt))
    rq = FA.backward_dq_reference(tq, tk, tv, o, lse, tdo, causal, scale)
    assert dq.dtype == torch.bfloat16 and dq.shape == rq.shape
    _close_bf16(dq, rq)
    _close_bf16(dq, jq)
