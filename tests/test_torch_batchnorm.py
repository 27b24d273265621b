"""The port's training-mode BatchNorm
(mxnet_tpu_torch/kernels/batchnorm_fused.py and the training branch of
ops/nn.py:batch_norm) held against the JAX package's
(mxnet_tpu/pallas_kernels/batchnorm_fused.py, mxnet_tpu/ops/nn.py) on the
same numpy inputs, on the CPU.

The reduction is made of correctly rounded f32 adds in a fixed tree, so
the statistics compare bit for bit, and so does the output of the JAX
reference run eagerly (op by op it too takes ``1.0 / jnp.sqrt`` as two
IEEE ops). Under ``jax.jit`` XLA:CPU rewrites that inverse into its own
rsqrt and a division by a constant count into a product with its
reciprocal; the comparisons with jitted JAX code allow for that.
Gradients compare within 2e-4, the JAX suite's own bound for its kernel
against autodiff of its reference (tests/test_pallas_kernels.py). On the
CPU the port's wrapper runs its plain versions; the CUDA kernels are held
against those on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.pallas_kernels import batchnorm_fused as JBN
from mxnet_tpu_torch.kernels import batchnorm_fused as BN
from mxnet_tpu_torch.ops import nn as tnn


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)) \
        .view(np.uint32)


def _same_bits(port, ref):
    return np.array_equal(_bits(port.detach().float().numpy()),
                          _bits(np.asarray(ref).astype(np.float32)))


def _mats(*shape, seed=0, dtype="float32"):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 2.0 + 0.5).astype("float32")
    c = shape[-1]
    g = (rs.rand(c) + 0.5).astype("float32")
    b = (rs.randn(c) * 0.1).astype("float32")
    if dtype == "bfloat16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x, g, b


def _jx(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _tx(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


# -- the deterministic reduction ----------------------------------------------

@pytest.mark.parametrize("rows", [1, 63, 64, 65, 130, 64 * 5 + 17])
def test_fold_pieces_bitwise(rows):
    """fold_blocks (R not a multiple of 64), fold_partials (NB not a power
    of two) and tree_fold_rows, with a channel of signed zeros (the padding
    adds +0.0) and non-finite entries."""
    rs = np.random.RandomState(rows)
    v = (rs.randn(rows, 7) * 10.0 ** rs.randint(-3, 4, (rows, 7))) \
        .astype("float32")
    v[:, 0] = -0.0                          # the sign of zero
    v[:, 1] = 0.0
    v[rows // 2, 2] = np.inf
    v[0, 3] = np.nan
    v[rows - 1, 4] = -np.inf
    t = torch.from_numpy(v)
    blocks = BN.fold_blocks(t)
    assert _same_bits(blocks, JBN.fold_blocks(jnp.asarray(v)))
    assert _same_bits(BN.fold_partials(blocks),
                      JBN.fold_partials(JBN.fold_blocks(jnp.asarray(v))))
    assert _same_bits(BN.tree_fold_rows(t), JBN.tree_fold_rows(
        jnp.asarray(v)))


def test_fold_partials_adds_the_zero_padding():
    """Three partials of -0.0 pad to four: -0.0 + -0.0 + -0.0 + 0.0 is
    +0.0, which skipping the padded add would get wrong."""
    parts = torch.full((3, 2), -0.0)
    out = BN.fold_partials(parts)
    ref = JBN.fold_partials(jnp.full((3, 2), -0.0))
    assert _same_bits(out, ref)
    assert not torch.signbit(out).any()


def test_exact_sq_bitwise():
    """Magnitudes stay where no partial product is subnormal: XLA:CPU
    flushes subnormals to zero, PyTorch and the card keep them."""
    rs = np.random.RandomState(5)
    x = (rs.randn(2000) * 10.0 ** rs.randint(-8, 8, 2000)) \
        .astype("float32")
    x[:4] = [np.inf, -np.inf, np.nan, -0.0]
    out = BN.exact_sq(torch.from_numpy(x))
    assert _same_bits(out, JBN.exact_sq(jnp.asarray(x)))


# -- the fold kernels' plan ---------------------------------------------------
#
# A plain-torch model of csrc/batchnorm_fused.cu's bn_fold_kernel and
# bn_finalize_kernel under fold_plan, level by level in the kernels' own
# order and grouping: a lane's rows {j + JR m} of a 64-row block in
# bit-reversed streaming order (JR row classes: 1 for the stats' 128-byte
# slabs, 2 for the backward's 64-byte ones), the row classes by shuffles, a
# warp's K blocks {c + G'h + G'Hk} in bit-reversed streaming order, the H
# warps by contiguous halves, then the finalize's lanes and its shared-memory
# halves. It must give tree_fold_rows bit for bit: the plan only regroups
# the JAX package's tree.

# (slab channels, row classes JR) of each fold kernel and dtype.
FOLD_KINDS = {"stats-bf16": (64, 1), "stats-f32": (32, 1),
              "bwd-bf16": (32, 2), "bwd-f32": (16, 2)}
FOLD_ROWS = [1, 63, 65, 4097, 64 * 25088 + 17]


def _trailing_ones(j):
    n = 0
    while j & 1:
        n, j = n + 1, j >> 1
    return n


def _brev(j, bits):
    return int(format(j, "0%db" % bits)[::-1], 2) if bits else 0


def _stream_fold(visits):
    """The kernels' binary-counter stack over visits J = 0 .. 2^L - 1:
    visit J is folded with the stack's levels below trailing_ones(J) and
    stored at that level; the last visit leaves the whole fold."""
    stack = {}
    for J, v in enumerate(visits):
        t = _trailing_ones(J)
        for level in range(t):
            v = stack[level] + v
        stack[t] = v
    return v


def _halves(v):
    """Contiguous halves over dim 0 of a power-of-two length."""
    while v.shape[0] > 1:
        n = v.shape[0] // 2
        v = v[:n] + v[n:]
    return v


def _fold_like_the_kernel(v, plan, jr):
    """(R, c) float32 -> the (G', c) partial rows bn_fold_kernel writes
    under ``plan`` (channels are independent: c may be fewer than the
    plan's C)."""
    R, c = v.shape
    rows = torch.cat([v, v.new_zeros(plan.nb * 64 - R, c)])  # masked: +0
    b = rows.reshape(plan.nb, 64 // jr, jr, c)               # m * jr + j
    lm = (64 // jr).bit_length() - 1
    lanes = _stream_fold([b[:, _brev(J, lm)] for J in range(64 // jr)])
    o = jr // 2
    while o >= 1:                                   # __shfl_down_sync
        lanes = lanes[:, :o] + lanes[:, o:2 * o]
        o //= 2
    blocks = torch.cat([lanes[:, 0],                # padding blocks: +0
                        v.new_zeros((1 << plan.logp) - plan.nb, c)])
    K, H, G = 1 << plan.logk, 1 << plan.logh, 1 << plan.logg
    units = blocks.reshape(K, H, G, c)              # c + G h + G H k
    warps = _stream_fold([units[_brev(J, plan.logk)] for J in range(K)])
    return _halves(warps)[0]                        # (G', c)


def _finalize_like_the_kernel(parts):
    """bn_finalize_kernel's fold of (G', c) partial rows -> (1, c): lane t
    of T = min(G', 64) streams rows {t + T k}, then halves over t."""
    G = parts.shape[0]
    T = min(G, 64)
    kf = G // T
    lanes = parts.reshape(kf, T, parts.shape[1])
    return _halves(_stream_fold([lanes[_brev(J, kf.bit_length() - 1)]
                                 for J in range(kf)]))


def _fold_values(rows, seed):
    """(rows, 3) float32 over many magnitudes: a channel of -0.0 (the
    padding's +0 must win), and inf and NaN entries beside finite ones."""
    rs = np.random.RandomState(seed)
    v = (rs.randn(rows, 3) * 10.0 ** rs.randint(-6, 6, (rows, 3))) \
        .astype("float32")
    v[:, 0] = -0.0
    if rows > 64:
        v[rows // 3, 2] = np.inf
        v[rows - 1, 2] = np.nan
    return torch.from_numpy(v)


@pytest.mark.parametrize("n_sm", [132, 5])
@pytest.mark.parametrize("kind", sorted(FOLD_KINDS))
@pytest.mark.parametrize("rows", FOLD_ROWS)
def test_fold_plan_regroups_the_tree(rows, kind, n_sm):
    """Sums and exact_sq sums folded by the plan's items (for C of 3, 64
    and 2048 channels) and then by the finalize's tree equal
    tree_fold_rows bit for bit, padding, masked rows and the sign of zero
    included."""
    slab, jr = FOLD_KINDS[kind]
    v = _fold_values(rows, rows % 97)
    for q in (v, BN.exact_sq(v)):
        want = BN.tree_fold_rows(q)
        for C in (3, 64, 2048):
            plan = BN.fold_plan(rows, C, n_sm, slab)
            got = _finalize_like_the_kernel(_fold_like_the_kernel(q, plan,
                                                                  jr))
            assert _same_bits(got, want.numpy()), (C, plan)


@pytest.mark.parametrize("kind", sorted(FOLD_KINDS))
@pytest.mark.parametrize("rows", [65, 64 * 10 + 17])
def test_fold_plan_regroups_jax_tree(rows, kind):
    """The same model against JAX's fold_blocks and fold_partials."""
    slab, jr = FOLD_KINDS[kind]
    v = _fold_values(rows, 11)
    plan = BN.fold_plan(rows, 130, 5, slab)
    got = _finalize_like_the_kernel(_fold_like_the_kernel(v, plan, jr))
    ref = JBN.fold_partials(JBN.fold_blocks(jnp.asarray(v.numpy())))
    assert _same_bits(got, ref)


def _walk(plan, R):
    """The loads of every warp of every persistent block, in the kernel's
    order (csrc: block_of and cursor_next): [(item, block)]."""
    nb, K = -(-R // 64), 1 << plan.logk
    loads = []
    for cta in range(plan.grid):
        for h in range(1 << plan.logh):
            for item in range(cta, plan.items, plan.grid):
                c = item // plan.ns
                for J in range(K):
                    blk = c + (h << plan.logg) \
                        + (_brev(J, plan.logk) << (plan.logg + plan.logh))
                    if blk < nb:
                        loads.append((item, blk))
    return loads


@pytest.mark.parametrize("n_sm", [132, 5])
@pytest.mark.parametrize("slab", [64, 32])
@pytest.mark.parametrize("rows", FOLD_ROWS)
def test_fold_walk_loads_every_block_once(rows, slab, n_sm):
    """Every (slab, 64-row block) is loaded exactly once, every item (slab,
    partial row) is walked by one persistent block, and with 5 SMs each
    block walks several items."""
    C = 130
    plan = BN.fold_plan(rows, C, n_sm, slab)
    loads = _walk(plan, rows)
    seen = sorted((item % plan.ns, blk) for item, blk in loads)
    assert seen == [(s, b) for s in range(plan.ns) for b in range(plan.nb)]
    assert plan.grid <= n_sm and plan.items == plan.ns << plan.logg
    if n_sm == 5 and plan.items > 5:
        assert plan.items > plan.grid


@pytest.mark.parametrize("C", [1, 64, 2048, 100000])
@pytest.mark.parametrize("rows", [1, 2, 64 * 2 ** 20 + 1, 2 ** 31 - 64])
def test_fold_plan_limits(rows, C):
    """The plan stays inside what the kernel checks: K <= 2^MAX_LOG_K,
    H <= FOLD_WARPS, G' H K = P, items fit an int, 1 <= grid <= items."""
    for slab in (64, 32, 16):
        p = BN.fold_plan(rows, C, 132, slab)
        assert p.logg + p.logh + p.logk == p.logp
        assert (1 << p.logp) >= p.nb > (1 << p.logp) // 2 or p.nb == 1
        assert 0 <= p.logk <= BN.MAX_LOG_K
        assert (1 << p.logh) <= BN.FOLD_WARPS
        assert 1 <= p.grid <= p.items < 2 ** 31


def test_bf16_square_is_exact_sq():
    """Every bf16 value's square in f32 is exact (8 significant bits), so
    the bf16 stats kernel's plain product equals exact_sq bit for bit."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16).float()
    assert torch.equal(BN.exact_sq(x).view(torch.int32),
                       (x * x).view(torch.int32))


# -- the plain forward against the JAX reference ------------------------------

@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 6, 6, 16), (3, 5, 7, 6), (130, 9),
                                   (1, 4)])
def test_reference_forward_bitwise(shape, dtype, act):
    x, g, b = _mats(*shape, dtype=dtype)
    x[..., 0] = 0.0                         # an all-zero channel
    ref, rm, rv = JBN.batchnorm_reference(_jx(x, dtype), jnp.asarray(g),
                                          jnp.asarray(b), 1e-3, act)
    out, mean, var = BN.batchnorm_reference(
        _tx(x, dtype), torch.from_numpy(g), torch.from_numpy(b), 1e-3, act)
    assert out.dtype == getattr(torch, dtype)
    assert mean.dtype == var.dtype == torch.float32
    assert _same_bits(mean, rm) and _same_bits(var, rv)
    assert _same_bits(out, ref.astype(jnp.float32))


def test_variance_clamps_and_nonfinite_stats():
    """|mean| >> std: the single-pass variance cancels below zero and
    clamps to +0; an inf entry gives NaN statistics, as in JAX."""
    x, g, b = _mats(256, 3)
    x[:, 0] = 1e4 + np.float32(1e-3) * np.arange(256, dtype=np.float32)
    x[7, 1] = np.inf
    _, rm, rv = JBN.batchnorm_reference(jnp.asarray(x), jnp.asarray(g),
                                        jnp.asarray(b))
    _, mean, var = BN.batchnorm_reference(*map(torch.from_numpy, (x, g, b)))
    assert _same_bits(mean, rm) and _same_bits(var, rv)
    assert var[0].item() == 0.0 and not torch.signbit(var[0])
    assert torch.isnan(var[1]) and np.isnan(np.asarray(rv)[1])


# -- gradients ----------------------------------------------------------------

@pytest.mark.parametrize("act", [None, "relu"])
def test_gradients_match_jax_autodiff(act):
    """The port's plain backward (through fused_batch_norm's autograd
    Function on the CPU) against jax.grad of the JAX reference: the JAX
    suite's 2e-4 bound."""
    x, g, b = _mats(4, 6, 6, 16, seed=7)

    def loss(x_, g_, b_):
        return jnp.sum(JBN.batchnorm_reference(x_, g_, b_, act=act)[0] ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, g, b)))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    out = BN.fused_batch_norm(tx, tg, tb, act=act)[0]
    (out ** 2).sum().backward()
    for port, r in zip((tx.grad, tg.grad, tb.grad), ref):
        np.testing.assert_allclose(port.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=2e-4)


def test_backward_reference_is_the_function_backward():
    """fused_batch_norm's CPU backward is batchnorm_backward_reference."""
    x, g, b = _mats(2, 5, 5, 8, seed=3)
    dy = np.random.RandomState(4).randn(*x.shape).astype("float32")
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    out, mean, var = BN.fused_batch_norm(tx, tg, tb, act="relu")
    out.backward(torch.from_numpy(dy))
    dx, dg, db = BN.batchnorm_backward_reference(
        tx.detach(), tg.detach(), tb.detach(), mean.detach(), var.detach(),
        torch.from_numpy(dy), act="relu")
    assert torch.equal(tx.grad, dx)
    assert torch.equal(tg.grad, dg) and torch.equal(tb.grad, db)


def test_stat_output_cotangents():
    """Differentiating through the mean/var outputs matches the JAX
    reference's autodiff (the d mean/dx and d var/dx terms)."""
    x, g, b = _mats(4, 6, 6, 16, seed=9)

    def loss(x_):
        _, m, v = JBN.batchnorm_reference(x_, jnp.asarray(g), jnp.asarray(b))
        return jnp.sum(m * 3.0) + jnp.sum(v * 0.5)

    ref = jax.grad(loss)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    _, m, v = BN.fused_batch_norm(tx, torch.from_numpy(g),
                                  torch.from_numpy(b))
    ((m * 3.0).sum() + (v * 0.5).sum()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("act", [None, "relu"])
def test_across_identity_is_one_device_bit_for_bit(act):
    """``across`` over one rank (the identity) leaves the op's outputs,
    its gradients and the statistics' cotangent terms bit for bit as
    without it."""
    x, g, b = _mats(2, 5, 5, 8, seed=11)
    dy = np.random.RandomState(12).randn(*x.shape).astype("float32")
    res = []
    for across in (None, lambda t: t):
        tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
        out, m, v = BN.fused_batch_norm(tx, tg, tb, act=act, across=across)
        ((out * torch.from_numpy(dy)).sum() + (m * 3.0).sum()
         + (v * 0.5).sum()).backward()
        res.append([out, m, v, tx.grad, tg.grad, tb.grad])
    for a, b_ in zip(*res):
        assert np.array_equal(_bits(a.detach()), _bits(b_.detach()))


def test_across_two_ranks_is_the_whole_batch():
    """Two ranks (threads), each with half of the rows and ``across`` the
    mean over both: the outputs, statistics and x gradients are the whole
    batch's, and the ranks' gamma and beta gradients add up to it."""
    import threading
    x, g, b = _mats(4, 4, 4, 8, seed=13)
    dy = np.random.RandomState(14).randn(*x.shape).astype("float32")
    bar, slots = threading.Barrier(2), [None, None]

    def across(rank):
        def mean(t):
            slots[rank] = t
            bar.wait()
            out = (slots[0] + slots[1]) / 2
            bar.wait()
            return out
        return mean

    res = [None, None]

    def run(rank):
        rows = slice(2 * rank, 2 * rank + 2)
        tx, tg, tb = (torch.from_numpy(np.ascontiguousarray(a))
                      .requires_grad_() for a in (x[rows], g, b))
        out, m, v = BN.fused_batch_norm(tx, tg, tb, act="relu",
                                        across=across(rank))
        (out * torch.from_numpy(dy[rows])).sum().backward()
        res[rank] = [t.detach() for t in (out, m, v, tx.grad, tg.grad,
                                          tb.grad)]

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    out, m, v = BN.fused_batch_norm(tx, tg, tb, act="relu")
    (out * torch.from_numpy(dy)).sum().backward()
    got = [torch.cat([res[0][0], res[1][0]]), res[0][1], res[0][2],
           torch.cat([res[0][3], res[1][3]]), res[0][4] + res[1][4],
           res[0][5] + res[1][5]]
    assert torch.equal(res[0][1], res[1][1])
    assert torch.equal(res[0][2], res[1][2])
    for a, want in zip(got, (out, m, v, tx.grad, tg.grad, tb.grad)):
        np.testing.assert_allclose(a.numpy(), want.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_bf16_grads_keep_dtypes():
    x, g, b = _mats(2, 4, 4, 8, dtype="bfloat16")
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tg = torch.from_numpy(g).bfloat16().requires_grad_()
    tb = torch.from_numpy(b).bfloat16().requires_grad_()
    out, mean, var = BN.fused_batch_norm(tx, tg, tb)
    assert out.dtype == torch.bfloat16 and mean.dtype == torch.float32
    out.float().sum().backward()
    assert tx.grad.dtype == tg.grad.dtype == tb.grad.dtype == torch.bfloat16


# -- the op, training mode ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis,fix_gamma", [(-1, False), (-1, True),
                                            (1, False)])
def test_batch_norm_training_matches_jax(axis, fix_gamma, dtype,
                                         monkeypatch):
    """ops.nn.batch_norm in training mode. Channels-last: the JAX op runs
    its Pallas kernel in interpret mode (MXTPU_FUSED_BN=interpret), the
    port fused_batch_norm's plain version; statistics bit for bit.
    Channels-first: both take batch_moments (two-pass for f32,
    single-pass for bf16) and the normalize chain; the sums are the same
    bits, but the JAX package's jitted moments multiply by 1/R where the
    port divides by R, so the statistics agree within 2 ulp. Outputs
    within the gap that an inverse standard deviation 2 ulp off leaves
    (tests/test_torch_ops.py)."""
    monkeypatch.setenv("MXTPU_FUSED_BN", "interpret")
    x, g, beta = _mats(2, 5, 6, 8, seed=11, dtype=dtype)
    c = x.shape[axis]
    g, beta = g[:c], beta[:c]
    rm, rv = np.zeros(c, "float32"), np.ones(c, "float32")
    kw = dict(eps=1e-5, fix_gamma=fix_gamma, axis=axis, _training=True)
    ref, jm, jv = jnn.batch_norm(_jx(x, dtype), *map(jnp.asarray,
                                                     (g, beta, rm, rv)), **kw)
    out, m, v = tnn.batch_norm(_tx(x, dtype), *map(torch.from_numpy,
                                                   (g, beta, rm, rv)), **kw)
    assert m.dtype == v.dtype == out.dtype == getattr(torch, dtype)
    if axis == -1:
        assert _same_bits(m, jm.astype(jnp.float32))
        assert _same_bits(v, jv.astype(jnp.float32))
    else:
        for port, stat in ((m, jm), (v, jv)):
            np.testing.assert_allclose(port.float().numpy(), np.asarray(
                stat.astype(jnp.float32)), rtol=2.0 ** -22, atol=0)
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(out.float().numpy() - ref)
    if dtype == "float32":
        shape = [1] * x.ndim
        shape[axis] = c
        gg = np.ones_like(g) if fix_gamma else g
        inv = 1.0 / np.sqrt(v.numpy().astype(np.float64) + 1e-5)
        terms = np.abs(x - m.numpy().reshape(shape)) \
            * (inv * gg).reshape(shape) + np.abs(beta).reshape(shape)
        assert np.all(err <= 2.0 ** -21 * terms)
    else:       # one bf16 step where the inverse moves a rounding
        assert np.all(err <= 2.0 ** -7 * np.abs(ref) + 1e-30)


def test_channels_first_training_is_differentiable():
    """The plain channels-first path backpropagates through the tree
    statistics (exact-product splits carry no gradient of their own)."""
    x, g, beta = _mats(4, 3, 5, 5, seed=2)
    g, beta = g[:3], beta[:3]

    def loss(x_, g_, b_):
        out = jnn.batch_norm(x_, g_, b_, jnp.zeros(3), jnp.ones(3),
                             fix_gamma=False, axis=1, _training=True)[0]
        return jnp.sum(out ** 2 * jnp.arange(out.size).reshape(out.shape))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, g, beta)))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, beta))
    out = tnn.batch_norm(tx, tg, tb, torch.zeros(3), torch.ones(3),
                         fix_gamma=False, axis=1, _training=True)[0]
    (out ** 2 * torch.arange(out.numel()).reshape(out.shape)).sum() \
        .backward()
    for port, r in zip((tx.grad, tg.grad, tb.grad), ref):
        scale = np.abs(np.asarray(r)).max()
        np.testing.assert_allclose(port.numpy(), np.asarray(r),
                                   atol=1e-4 * scale, rtol=0)


def test_counters_stay_zero_on_cpu():
    before = (BN.LAUNCHES_STATS, BN.LAUNCHES_APPLY, BN.LAUNCHES_BWD_REDUCE,
              BN.LAUNCHES_BWD_DX, BN.LAUNCHES_FINALIZE)
    x, g, b = _mats(2, 4, 4, 8)
    tx = torch.from_numpy(x).requires_grad_()
    out = tnn.batch_norm(tx, torch.from_numpy(g), torch.from_numpy(b),
                         torch.zeros(8), torch.ones(8), axis=-1,
                         fix_gamma=False, _training=True)[0]
    out.sum().backward()
    assert (BN.LAUNCHES_STATS, BN.LAUNCHES_APPLY, BN.LAUNCHES_BWD_REDUCE,
            BN.LAUNCHES_BWD_DX, BN.LAUNCHES_FINALIZE) == before


@pytest.mark.parametrize("case", ["gamma_len", "act", "int_x", "x1d",
                                  "meta"])
def test_wrapper_raises_on_what_it_does_not_take(case):
    x, g, b = (torch.from_numpy(a) for a in _mats(2, 4, 4, 8))
    act, err = None, ValueError
    if case == "gamma_len":
        g = g[:4]
    elif case == "act":
        act = "gelu"
    elif case == "int_x":
        x, err = x.to(torch.int32), TypeError
    elif case == "x1d":
        x = x.reshape(-1)[:8]
    else:
        # a meta tensor (shape inference) takes the wrapper's meta branch,
        # which still refuses what the kernels do not take
        x, g, b = (t.to("meta") for t in (x, g[:4], b))
    with pytest.raises(err):
        BN.fused_batch_norm(x, g, b, act=act)
