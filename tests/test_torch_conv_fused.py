"""The port's fused BN->ReLU->conv3x3 (mxnet_tpu_torch/kernels/conv_fused.py)
held against the JAX package's (mxnet_tpu/pallas_kernels/conv_fused.py).

On the CPU the JAX side runs its Pallas kernels in interpret mode and its
jnp reference (forward, and ``jax.vjp`` of it for the backward); the port
runs its plain PyTorch versions, which are what its wrappers take for a CPU
tensor. The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py holds them against the plain versions there
(``python3 chip_smoke.py`` does the same at the ResNet-50 shapes).
"""
import collections

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.pallas_kernels import conv_fused as JCF
from mxnet_tpu_torch.kernels import conv_fused as CF

SHAPES = [(3, 8, 8, 16, 24), (4, 4, 4, 8, 8), (2, 7, 7, 24, 40)]
BF16_EPS = 2.0 ** -8   # one bf16 ulp relative to the value's magnitude


def _mats(N, H, W, Ci, Co, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, H, W, Ci).astype("float32")
    s = (rs.rand(Ci) + 0.5).astype("float32")
    b = (rs.randn(Ci) * 0.1).astype("float32")
    w = (rs.randn(3, 3, Ci, Co) * 0.1).astype("float32")
    return x, s, b, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_f32(shape, relu):
    """f32 at the JAX suite's own bound (tests/test_conv_fused.py: atol
    1e-5): against the Pallas kernel in interpret mode and against the jnp
    reference."""
    x, s, b, w = _mats(*shape)
    out = CF.fused_conv_reference(*_t(x, s, b, w), relu=relu).numpy()
    jx = [jnp.asarray(a) for a in (x, s, b, w)]
    pallas = JCF.fused_scale_relu_conv3x3(*jx, relu=relu, interpret=True)
    ref = JCF.fused_conv_reference(*jx, relu=relu)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_bf16(shape, relu):
    """bf16 in, bf16 out, activation in bf16: the two frameworks may round
    the final f32 sum differently by one bf16 step, so the bound is one
    bf16 ulp of the output's magnitude."""
    x, s, b, w = _mats(*shape, seed=1)
    xb = torch.from_numpy(x).bfloat16()
    out = CF.fused_conv_reference(xb, *_t(s, b, w), relu=relu)
    assert out.dtype == torch.bfloat16
    ref = JCF.fused_conv_reference(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s), jnp.asarray(b),
        jnp.asarray(w), relu=relu)
    ref = np.asarray(ref.astype(jnp.float32))
    diff = np.abs(out.float().numpy() - ref).max()
    assert diff <= BF16_EPS * np.abs(ref).max(), diff


def test_padding_is_zero_after_activation():
    """The halo is zero in activated space: with x = 0 and b > 0 every
    interior tap sees relu(b), but border pixels see fewer taps."""
    x = torch.zeros(1, 3, 3, 1)
    s, b = torch.ones(1), torch.ones(1)
    w = torch.ones(3, 3, 1, 1)
    out = CF.fused_scale_relu_conv3x3(x, s, b, w)[0, :, :, 0]
    expect = torch.tensor([[4.0, 6.0, 4.0], [6.0, 9.0, 6.0],
                           [4.0, 6.0, 4.0]])
    assert torch.equal(out, expect)


def test_cpu_tensor_takes_plain_version():
    x, s, b, w = _t(*_mats(2, 5, 6, 8, 16))
    before = CF.LAUNCHES
    out = CF.fused_scale_relu_conv3x3(x, s, b, w)
    assert CF.LAUNCHES == before
    assert torch.equal(out, CF.fused_conv_reference(x, s, b, w))


@pytest.mark.parametrize("dtype,cdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.bfloat16), (torch.float64, torch.float32)])
def test_compute_dtype(dtype, cdt):
    """Other half types promote to bf16 and wider floats to f32, as the
    JAX module's _compute_dtype does; the result keeps x's dtype."""
    assert CF.compute_dtype(dtype) == cdt
    x, s, b, w = _t(*_mats(1, 4, 4, 8, 8))
    assert CF.fused_scale_relu_conv3x3(x.to(dtype), s, b, w).dtype == dtype


@pytest.mark.parametrize("case", ["int_x", "w5x5", "w_ci", "s_len",
                                  "x3d", "meta"])
def test_wrapper_raises_on_what_it_does_not_take(case):
    x, s, b, w = _t(*_mats(1, 4, 4, 8, 8))
    if case == "int_x":
        x, err = x.to(torch.int32), TypeError
    elif case == "w5x5":
        w, err = torch.zeros(5, 5, 8, 8), ValueError
    elif case == "w_ci":
        w, err = torch.zeros(3, 3, 4, 8), ValueError
    elif case == "s_len":
        s, err = torch.ones(7), ValueError
    elif case == "x3d":
        x, err = x[0], ValueError
    else:
        # a meta tensor (shape inference) takes the wrapper's meta branch,
        # which still refuses what the kernel does not take
        x, s, b, w = (t.to("meta") for t in (x, s, b, w[:, :, :4]))
        err = ValueError
    with pytest.raises(err):
        CF.fused_scale_relu_conv3x3(x, s, b, w)


# -- the backward -------------------------------------------------------------

def _dy(N, H, W, Co, seed=7):
    return np.random.RandomState(seed).randn(N, H, W, Co).astype("float32")


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_reference_matches_jax(shape, relu):
    """dx, ds, db, dw of the plain backward against the JAX package's
    ``_pallas_backward`` in interpret mode and against ``jax.vjp`` of its
    ``fused_conv_reference``, f32, at the JAX suite's bound
    (tests/test_conv_fused.py: atol 2e-3, rtol 1e-3). The measured gap is
    about 2e-5 at outputs up to ~50: summation order only."""
    x, s, b, w = _mats(*shape)
    dy = _dy(*shape[:3], shape[4])
    got = CF.fused_conv_backward_reference(*_t(x, s, b, w, dy), relu=relu)
    jx = [jnp.asarray(a) for a in (x, s, b, w)]
    pallas = JCF._pallas_backward(*jx, relu, True, jnp.asarray(dy))
    _, vjp = jax.vjp(lambda *a: JCF.fused_conv_reference(*a, relu=relu),
                     *jx)
    ref = vjp(jnp.asarray(dy))
    for g, p, r in zip(got, pallas, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=2e-3,
                                   rtol=1e-3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_matches_torch_autograd_of_reference(shape, relu):
    """The autograd Function's CPU gradients against torch autograd through
    the differentiable plain forward (f32; the same ops in another order,
    so within 1e-5 of the largest gradient)."""
    x, s, b, w = _mats(*shape)
    dy = torch.from_numpy(_dy(*shape[:3], shape[4]))
    grads = []
    for fn in (CF.fused_scale_relu_conv3x3, CF.fused_conv_reference):
        leaves = [t.requires_grad_() for t in _t(x, s, b, w)]
        fn(*leaves, relu=relu).backward(dy)
        grads.append([t.grad for t in leaves])
    for g, r in zip(*grads):
        assert (g - r).abs().max() <= 1e-5 * r.abs().max()


@pytest.mark.parametrize("bias", [1.0, -1.0])
def test_backward_padding_is_zero_after_activation(bias):
    """With x = 0 every interior tap sees relu(b) and the halo sees 0, so
    with dy = 1 each weight tap counts the output pixels whose shifted
    input lies inside the image, and dx counts the taps that reach each
    input pixel. With b < 0 the ReLU kills everything."""
    x = torch.zeros(1, 3, 3, 1)
    s, b = torch.ones(1), torch.full((1,), bias)
    w, dy = torch.ones(3, 3, 1, 1), torch.ones(1, 3, 3, 1)
    dx, ds, db, dw = CF.fused_conv_backward(x, s, b, w, dy)
    count = torch.tensor([[4.0, 6.0, 4.0], [6.0, 9.0, 6.0],
                          [4.0, 6.0, 4.0]])
    on = 1.0 if bias > 0 else 0.0
    assert torch.equal(dw[:, :, 0, 0], count * on)
    assert torch.equal(dx[0, :, :, 0], count * on)
    assert torch.equal(db, torch.tensor([49.0 * on]))
    assert torch.equal(ds, torch.zeros(1))


def test_cpu_backward_takes_plain_version():
    x, s, b, w = _t(*_mats(2, 5, 6, 8, 16))
    dy = torch.from_numpy(_dy(2, 5, 6, 16))
    before = (CF.LAUNCHES_BWD_DX, CF.LAUNCHES_BWD_DW, CF.LAUNCHES_FINALIZE,
              CF.LAUNCHES_REDUCE, CF.COPIES)
    got = CF.fused_conv_backward(x, s, b, w, dy)
    want = CF.fused_conv_backward_reference(x, s, b, w, dy)
    assert (CF.LAUNCHES_BWD_DX, CF.LAUNCHES_BWD_DW, CF.LAUNCHES_FINALIZE,
            CF.LAUNCHES_REDUCE, CF.COPIES) == before
    assert all(torch.equal(g, r) for g, r in zip(got, want))


def test_backward_dtypes_follow_the_operands():
    """dx in x's dtype, ds/db in s/b's, dw in w's (the JAX backward's
    casts), with the mask and the convolutions in the compute dtype."""
    x, s, b, w = _t(*_mats(2, 4, 4, 8, 8))
    dy = torch.from_numpy(_dy(2, 4, 4, 8))
    dx, ds, db, dw = CF.fused_conv_backward(
        x.bfloat16(), s, b.double(), w.half(), dy.bfloat16())
    assert (dx.dtype, ds.dtype, db.dtype, dw.dtype) == (
        torch.bfloat16, torch.float32, torch.float64, torch.float16)
    with pytest.raises(ValueError):
        CF.fused_conv_backward(x, s, b, w, dy[:, :3])


def test_dw_split_covers_every_tile():
    """The d-weight kernel's K-split (``dw_plan``): splits x tiles per
    split cover every pixel tile with no empty split, and the bf16 items
    fill 132 SMs, the f32 blocks about two waves, where the tiles allow."""
    for N, H, W, C in ((128, 56, 56, 64), (128, 28, 28, 128),
                       (128, 14, 14, 256), (128, 7, 7, 512), (1, 1, 1, 8)):
        for dt in (torch.bfloat16, torch.float32):
            t = CF.tiles(N, H, W)
            plan = CF.dw_plan(N, H, W, C, C, dt, 132)
            assert (plan.nsplit - 1) * plan.tps < t <= plan.nsplit * plan.tps
            if t >= 264:
                assert plan.grid >= (128 if dt == torch.bfloat16 else 264)


# -- the d-weight kernel's work partition, modelled on the CPU ----------------
#
# The bf16 d-weight kernel (csrc/conv_fused.cu, conv_bwd_dw_bf16_kernel)
# walks the items of ``dw_plan``: block i of ``grid`` takes items i, i +
# grid, ...; item = (split ks * ci_chunks + cc) * co_blocks + cb sums the
# pixel tiles of split ks for input channels cc*64 .. +64 and output
# channels cb*64 .. +64, all nine taps, into part[ks]; a reduce adds the
# partials in split order. The model below walks the same loops in plain
# torch, on the tall virtual image (one zero separator row between images)
# and each tile's halo shifted by the tap, so that an indexing fault shows
# on the CPU.

TRAIN_SHAPES = [(128, 56, 56, 64, 64), (128, 28, 28, 128, 128),
                (128, 14, 14, 256, 256), (128, 7, 7, 512, 512)]
# chip_smoke.py's EDGE_SHAPES
EDGE_SHAPES = [(3, 8, 8, 16, 24), (2, 7, 7, 24, 40), (5, 9, 13, 24, 40),
               (1, 1, 1, 8, 8), (3, 17, 9, 32, 72), (2, 5, 3, 3, 5),
               (4, 15, 17, 40, 129)]
TH, TW, CK, BN = 16, 8, 64, 64


def _walk(shape, plan):
    """[(block, ks, cc, cb, tile)] in the order the kernel's blocks take
    them."""
    N, H, W, Ci, Co = shape
    t = CF.tiles(N, H, W)
    ci_chunks, co_blocks = -(-Ci // CK), -(-Co // BN)
    per_split = ci_chunks * co_blocks
    out = []
    for block in range(plan.grid):
        for item in range(block, plan.nsplit * per_split, plan.grid):
            ks, rem = divmod(item, per_split)
            cc, cb = divmod(rem, co_blocks)
            for tile in range(ks * plan.tps, min(t, (ks + 1) * plan.tps)):
                out.append((block, ks, cc, cb, tile))
    return out


@pytest.mark.parametrize("n_sm", [132, 114, 7])
@pytest.mark.parametrize("shape", TRAIN_SHAPES + EDGE_SHAPES)
def test_dw_plan_partition(shape, n_sm):
    """Every (ci chunk, co block, pixel tile) is summed exactly once; the
    walk is fixed (the plan is a function of the shape and the SM count);
    and the items fit the SMs: no more blocks than SMs or items; on the
    H100's 132 SMs the busiest block walks within 5% of an even share of the
    tiles at the training shapes. Elsewhere the planner trades that share
    against fewer partials for the reduce, within 30% (at 7 SMs, several
    items per block)."""
    N, H, W, Ci, Co = shape
    plan = CF.dw_plan(N, H, W, Ci, Co, torch.bfloat16, n_sm)
    assert plan == CF.dw_plan.__wrapped__(N, H, W, Ci, Co, torch.bfloat16,
                                          n_sm)
    t = CF.tiles(N, H, W)
    per_split = -(-Ci // CK) * -(-Co // BN)
    assert plan.items == plan.nsplit * per_split
    assert (plan.nsplit - 1) * plan.tps < t <= plan.nsplit * plan.tps
    assert plan.grid == min(plan.items, n_sm)
    walk = _walk(shape, plan)
    keys = [(cc, cb, tile) for _, _, cc, cb, tile in walk]
    assert len(keys) == len(set(keys)) == per_split * t
    assert walk == _walk(shape, plan)
    per_block = collections.Counter(blk for blk, *_ in walk)
    assert len(per_block) == plan.grid
    even = t * per_split / n_sm
    if t * per_split >= n_sm:
        slack = 1.05 if n_sm == 132 and shape in TRAIN_SHAPES else 1.3
        assert max(per_block.values()) <= slack * even + 1
    else:
        assert plan.tps == 1


def _emulate_dw(x, s, b, dy, relu, plan):
    """dW (3, 3, Ci, Co) f32 by the kernel's decomposition: per item, per
    tile, per tap the halo window shifted by the tap against the tile's dy
    rows; per-item partials; the reduce in split order. Every partial entry
    must be written (they start as NaN)."""
    N, H, W, Ci, Co = x.shape[0], x.shape[1], x.shape[2], x.shape[3], \
        dy.shape[3]
    z = x * s + b
    z = torch.clamp_min(z, 0) if relu else z
    V = N * (H + 1) - 1
    cip, cop = -(-Ci // CK) * CK, -(-Co // BN) * BN
    # virtual image: image n at rows n*(H+1) ..; separator rows stay zero;
    # one row and column of padding before, a tile's worth after
    zp = torch.zeros(V + 2 + TH, W + 2 + TW, cip)
    dp = torch.zeros(V + TH, W + TW, cop)
    for n in range(N):
        r = n * (H + 1)
        zp[1 + r:1 + r + H, 1:1 + W, :Ci] = z[n]
        dp[r:r + H, :W, :Co] = dy[n]
    col_tiles = -(-W // TW)
    part = torch.full((plan.nsplit, 9, Ci, Co), float("nan"))
    acc, cur = None, None
    for _, ks, cc, cb, tile in _walk((N, H, W, Ci, Co), plan):
        if cur != (ks, cc, cb):
            if cur is not None:
                _store(part, cur, acc, Ci, Co)
            cur, acc = (ks, cc, cb), torch.zeros(9, CK, BN)
        rt, ct = divmod(tile, col_tiles)
        r0, c0 = rt * TH, ct * TW
        halo = zp[r0:r0 + TH + 2, c0:c0 + TW + 2, cc * CK:(cc + 1) * CK]
        d = dp[r0:r0 + TH, c0:c0 + TW, cb * BN:(cb + 1) * BN].reshape(-1, BN)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            a = halo[ky:ky + TH, kx:kx + TW].reshape(-1, CK)
            acc[tap] += a.T @ d
    _store(part, cur, acc, Ci, Co)
    assert not torch.isnan(part).any()
    dw = torch.zeros(9, Ci, Co)
    for ks in range(plan.nsplit):
        dw = dw + part[ks]
    return dw.reshape(3, 3, Ci, Co)


def _store(part, item, acc, Ci, Co):
    ks, cc, cb = item
    ci = min(CK, Ci - cc * CK)
    co = min(BN, Co - cb * BN)
    part[ks, :, cc * CK:cc * CK + ci, cb * BN:cb * BN + co] = acc[:, :ci, :co]


@pytest.mark.parametrize("n_sm", [132, 3])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", EDGE_SHAPES + [(4, 14, 14, 64, 128)])
def test_dw_emulation_matches_reference(shape, relu, n_sm):
    """The CPU model of the bf16 d-weight kernel's partition against
    ``backward_weight_reference``, f32: the same sums in another order, so
    within 1e-5 of max |reference| (measured: a few 1e-7). At 3 SMs the
    blocks walk several items each."""
    N, H, W, Ci, Co = shape
    x, s, b, w = _t(*_mats(*shape, seed=3))
    dy = torch.from_numpy(_dy(N, H, W, Co, seed=4))
    plan = CF.dw_plan(N, H, W, Ci, Co, torch.bfloat16, n_sm)
    got = _emulate_dw(x, s, b, dy, relu, plan)
    ref = CF.backward_weight_reference(x, s, b, w, dy, relu)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


# -- the d-input kernel's work partition, modelled on the CPU -----------------
#
# The bf16 d-input kernel (csrc/conv_fused.cu, conv_bwd_dx_bf16_kernel)
# walks the items of ``dx_plan``: block i of ``grid`` takes items i, i +
# grid, ...; item = cb * pairs + pair gives consumer warpgroup g (0, 1) tile
# 2*pair + g and input channels cb*64*nb .. +64*nb. Its K order is (dy
# chunk of 64 channels, tap, channel); each chunk's halo is 18 TMA boxes of
# the virtual image whose zero fill is the padding, and each (chunk, tap)
# weight piece a box of the flipped, transposed W whose zero fill covers
# the channels past Co and Ci. A consumer adds each item's ds/db sums to its
# own row of the partials; the finalize folds the 2*grid rows in order.
# Channel counts reach the kernel padded to multiples of 8 (the wrapper).

def _pad8(c):
    return -(-c // 8) * 8


def _dx_walk(plan):
    """[(block, item, pair, cb)] in the order the kernel's blocks take
    them."""
    out = []
    for block in range(plan.grid):
        for item in range(block, plan.items, plan.grid):
            cb, pair = divmod(item, plan.pairs)
            out.append((block, item, pair, cb))
    return out


@pytest.mark.parametrize("n_sm", [132, 114, 7])
@pytest.mark.parametrize("shape", TRAIN_SHAPES + EDGE_SHAPES)
def test_dx_plan_partition(shape, n_sm):
    """Every output pixel and input channel is written by exactly one item
    (each (tile, channel) once, and the tiles partition the pixels); the
    plan and each block's item list are fixed, so is the order in which a
    consumer adds its items to its row of partials; no block is idle and
    none walks more than its even share of items, rounded up."""
    N, H, W, Ci, Co = shape
    ci8, co8 = _pad8(Ci), _pad8(Co)
    plan = CF.dx_plan(N, H, W, ci8, co8, n_sm)
    assert plan == CF.dx_plan.__wrapped__(N, H, W, ci8, co8, n_sm)
    t = CF.tiles(N, H, W)
    cw = 64 * plan.nb
    assert plan.nb == (1 if ci8 <= 64 else 2)
    assert plan.cblocks == -(-ci8 // cw) and plan.pairs == -(-t // 2)
    assert plan.items == plan.pairs * plan.cblocks
    assert plan.grid == min(plan.items, n_sm)
    assert plan.resident == (plan.cblocks == 1 and co8 <= 64
                             and plan.nb == 1)
    walk = _dx_walk(plan)
    assert walk == _dx_walk(plan)
    per_block = collections.defaultdict(list)
    for block, item, _, _ in walk:
        per_block[block].append(item)
    assert sorted(per_block) == list(range(plan.grid))
    assert all(items == sorted(items) for items in per_block.values())
    assert max(map(len, per_block.values())) == -(-plan.items // plan.grid)
    cover = torch.zeros(2 * plan.pairs, plan.cblocks * cw, dtype=torch.int32)
    for _, _, pair, cb in walk:
        cover[2 * pair:2 * pair + 2, cb * cw:(cb + 1) * cw] += 1
    assert bool((cover[:t, :ci8] == 1).all())
    # each pixel's tile and place in it: all tiles exist, no place twice
    vr = torch.arange(N).view(N, 1, 1) * (H + 1) + torch.arange(H).view(
        1, H, 1)
    col = torch.arange(W).view(1, 1, W)
    tile = (vr // TH) * -(-W // TW) + col // TW
    place = tile * TH * TW + (vr % TH) * TW + col % TW
    assert int(tile.max()) < t
    assert place.unique().numel() == N * H * W


def _emulate_dx(x, s, b, w, dy, relu, n_sm):
    """(dx, ds, db) f32 by the bf16 d-input kernel's decomposition: the
    wrapper's padding to multiples of 8; per item and consumer, the tile's
    halo boxes of each dy chunk (the virtual image with zero fill), the
    tap windows against the (chunk, tap) weight pieces in K order; the
    epilogue on the tile's pixels that lie in an image; per-consumer rows
    of partials added in item order, folded in row order. Every dx element
    must be written exactly once (it starts as NaN)."""
    N, H, W, Ci = x.shape
    Co = dy.shape[3]
    ci8, co8 = _pad8(Ci), _pad8(Co)
    xp = torch.nn.functional.pad(x, (0, ci8 - Ci))
    sp = torch.nn.functional.pad(s, (0, ci8 - Ci))
    bp = torch.nn.functional.pad(b, (0, ci8 - Ci))
    dyp = torch.nn.functional.pad(dy, (0, co8 - Co))
    wp = torch.nn.functional.pad(w, (0, co8 - Co, 0, ci8 - Ci))
    wt = torch.flip(wp, (0, 1)).permute(0, 1, 3, 2).reshape(9, co8, ci8)
    plan = CF.dx_plan(N, H, W, ci8, co8, n_sm)
    cw, kc = 64 * plan.nb, -(-co8 // 64)
    V = N * (H + 1) - 1
    col_tiles = -(-W // TW)
    row_tiles = -(-V // TH)
    # the boxes' view of dy: image n at virtual rows n*(H+1) .., one row and
    # column before, and room for a pair's second tile past the last one
    dp = torch.zeros((row_tiles + 1) * TH + 2, col_tiles * TW + 2, kc * 64)
    for n in range(N):
        r = 1 + n * (H + 1)
        dp[r:r + H, 1:1 + W, :co8] = dyp[n]
    wz = torch.zeros(9, kc * 64, plan.cblocks * cw)
    wz[:, :co8, :ci8] = wt
    dx = torch.full((N, H, W, ci8), float("nan"))
    part = torch.zeros(2, 2 * plan.grid, ci8)
    trow = torch.arange(TH).view(TH, 1).expand(TH, TW).reshape(-1)
    tcol = torch.arange(TW).view(1, TW).expand(TH, TW).reshape(-1)
    for block, _, pair, cb in _dx_walk(plan):
        ch = slice(cb * cw, min(ci8, (cb + 1) * cw))
        nch = ch.stop - ch.start
        for g in range(2):
            rt, ct = divmod(2 * pair + g, col_tiles)
            r0, c0 = rt * TH, ct * TW
            acc = torch.zeros(TH * TW, cw)
            for c in range(kc):
                halo = dp[r0:r0 + TH + 2, c0:c0 + TW + 2, c * 64:(c + 1) * 64]
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    a = halo[ky:ky + TH, kx:kx + TW].reshape(-1, 64)
                    acc += a @ wz[tap, c * 64:(c + 1) * 64, cb * cw:(cb + 1)
                                  * cw]
            vr, cc = r0 + trow, c0 + tcol
            n, h = vr // (H + 1), vr % (H + 1)
            ok = (vr < V) & (cc < W) & (h < H)
            n, h, cc = n[ok], h[ok], cc[ok]
            dz = acc[ok][:, :nch]
            xv = xp[n, h, cc][:, ch]
            pre = xv * sp[ch] + bp[ch]
            dpre = dz * (pre > 0) if relu else dz
            assert bool(torch.isnan(dx[n, h, cc][:, ch]).all())
            dx[n, h, cc, ch] = dpre * sp[ch]
            part[0, 2 * block + g, ch] += (dpre * xv).sum(0)
            part[1, 2 * block + g, ch] += dpre.sum(0)
    assert not bool(torch.isnan(dx).any())
    ds, db = torch.zeros(ci8), torch.zeros(ci8)
    for row in range(2 * plan.grid):
        ds, db = ds + part[0, row], db + part[1, row]
    return dx[..., :Ci], ds[:Ci], db[:Ci]


@pytest.mark.parametrize("n_sm", [132, 3])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", EDGE_SHAPES + [(4, 14, 14, 64, 128),
                                                 (2, 7, 7, 136, 72)])
def test_dx_emulation_matches_reference(shape, relu, n_sm):
    """The CPU model of the bf16 d-input kernel's decomposition against
    ``backward_input_reference``, f32: the same sums in another order, so
    within 1e-5 of max |reference| (measured: up to 1.4e-6). At 3 SMs the
    blocks walk several items each; (2, 7, 7, 136, 72) has two ci blocks of
    128 (the second ragged) and two dy chunks."""
    N, H, W, Ci, Co = shape
    x, s, b, w = _t(*_mats(*shape, seed=5))
    dy = torch.from_numpy(_dy(N, H, W, Co, seed=6))
    got = _emulate_dx(x, s, b, w, dy, relu, n_sm)
    ref = CF.backward_input_reference(x, s, b, w, dy, relu)
    for name, g, r in zip(("dx", "ds", "db"), got, ref):
        assert g.shape == r.shape, name
        assert (g - r).abs().max() <= 1e-5 * r.abs().max(), name


# -- the forward kernel's work partition, modelled on the CPU -----------------
#
# The bf16 forward kernel (csrc/conv_fused.cu, conv_fused_fwd_bf16_kernel)
# walks the items of ``fwd_plan``: block i of ``grid`` takes items i, i +
# grid, ...; item = cb * pairs + pair gives consumer warpgroup g (0, 1) tile
# 2*pair + g and output channels cb*64*nb .. +64*nb. Its K order is (x chunk
# of 64 channels, tap, channel); each chunk's halo is TMA boxes of the
# virtual image of x whose zero fill is the padding. The block's 96
# activator threads activate the halo in place -- thread at, pass j:
# 16-byte chunk at % 8 of halo pixel at // 8 + 12j (row p // 10, slot p %
# 10) -- only where the pixel lies in an image, by the bf16 rule, with s
# and b zero past Ci.
# Each (chunk, tap) weight piece is a box of W laid out (9, Ci, co64). The
# epilogue stores a box per tile row and 64 channels, skipping rows that lie
# in no image; TMA clips columns past W and channels past Co. Channel counts
# reach the kernel padded to multiples of 8 (the wrapper).

SERVE_SHAPES = [(32, 56, 56, 64, 64), (32, 28, 28, 128, 128),
                (32, 14, 14, 256, 256), (32, 7, 7, 512, 512)]
HALO_W, HALO_P = TW + 2, (TH + 2) * (TW + 2)


def _fwd_cost(items, nb, n_sm):
    """The busiest block's work: rounds of items times an item's 64*nb
    channels (in units of 64)."""
    return -(-items // min(items, n_sm)) * nb


@pytest.mark.parametrize("n_sm", [132, 114, 7])
@pytest.mark.parametrize("shape", SERVE_SHAPES + TRAIN_SHAPES + EDGE_SHAPES)
def test_fwd_plan_partition(shape, n_sm):
    """Every output pixel and channel is written by exactly one item (each
    (tile, channel) once, and the tiles partition the pixels); the plan and
    each block's item list are fixed; no block is idle and none walks more
    than its even share of items, rounded up; nb makes the busiest block's
    work least, ties going to 2 (so at least as little as d-input's rule,
    nb 2 wherever C > 64); the weights are resident exactly where Ci and Co
    are at most 64."""
    N, H, W, Ci, Co = shape
    ci8, co8 = _pad8(Ci), _pad8(Co)
    plan = CF.fwd_plan(N, H, W, ci8, co8, n_sm)
    assert plan == CF.fwd_plan.__wrapped__(N, H, W, ci8, co8, n_sm)
    t = CF.tiles(N, H, W)
    cw = 64 * plan.nb
    items = {nb: -(-t // 2) * -(-co8 // (64 * nb)) for nb in (1, 2)}
    cost = {nb: _fwd_cost(items[nb], nb, n_sm) for nb in (1, 2)}
    assert plan.nb == (2 if cost[2] <= cost[1] else 1)
    assert cost[plan.nb] <= cost[1 if co8 <= 64 else 2]
    assert plan.cblocks == -(-co8 // cw) and plan.pairs == -(-t // 2)
    assert plan.items == plan.pairs * plan.cblocks == items[plan.nb]
    assert plan.grid == min(plan.items, n_sm)
    assert plan.resident == (ci8 <= 64 and co8 <= 64)
    walk = _dx_walk(plan)
    assert walk == _dx_walk(plan)
    per_block = collections.defaultdict(list)
    for block, item, _, _ in walk:
        per_block[block].append(item)
    assert sorted(per_block) == list(range(plan.grid))
    assert max(map(len, per_block.values())) == -(-plan.items // plan.grid)
    cover = torch.zeros(2 * plan.pairs, plan.cblocks * cw, dtype=torch.int32)
    for _, _, pair, cb in walk:
        cover[2 * pair:2 * pair + 2, cb * cw:(cb + 1) * cw] += 1
    assert bool((cover[:t, :co8] == 1).all())


def test_fwd_plan_halves_the_deep_serving_shapes():
    """At the serving shapes on 132 SMs: the 56x56 link keeps its weights
    resident, 28x28 takes nb 2, and at 14x14 and 7x7 nb 1 halves the busiest
    block's work against nb 2 (d-input's rule), which would leave 72 and 100
    SMs idle."""
    plans = [CF.fwd_plan(*shape, 132) for shape in SERVE_SHAPES]
    assert [(p.nb, p.items, p.resident) for p in plans] == [
        (1, 399, True), (2, 116, False), (1, 120, False), (1, 64, False)]
    for shape, plan in zip(SERVE_SHAPES[2:], plans[2:]):
        pairs = -(-CF.tiles(*shape[:3]) // 2)
        two = pairs * -(-shape[4] // 128)
        assert 132 - two in (72, 100)
        assert 2 * _fwd_cost(plan.items, 1, 132) == _fwd_cost(two, 2, 132)


ACTIVATORS, ACT_BATCH = 96, 3      # csrc/conv_fused.cu: warps 9-11


def _act_passes():
    """(p, v) of each activator thread's passes, thread-major: thread at,
    pass j -> halo pixel at // 8 + 12j, chunk at % 8."""
    at = torch.arange(ACTIVATORS).view(-1, 1)
    j = torch.arange(HALO_P * 8 // ACTIVATORS).view(1, -1)
    p = (at // 8 + ACTIVATORS // 8 * j).reshape(-1)
    v = (at % 8).expand(-1, j.shape[1]).reshape(-1)
    return p, v


def test_fwd_activation_passes_cover_each_window_chunk_once():
    """The 96 activator threads' 15 passes, in batches of 3, reach each
    16-byte chunk of the 10 slots x 18 rows a tap window reads exactly
    once, and no pixel past them."""
    p, v = _act_passes()
    assert int(p.max()) < HALO_P
    seen = torch.zeros(HALO_P, 8, dtype=torch.int32)
    seen.index_put_((p, v), torch.ones_like(p, dtype=torch.int32),
                    accumulate=True)
    assert bool((seen == 1).all())
    assert HALO_P * 8 % ACTIVATORS == 0
    assert HALO_P * 8 // ACTIVATORS % ACT_BATCH == 0


def _emulate_fwd(x, s, b, w, relu, n_sm):
    """out (N, H, W, Co) f32 by the bf16 forward kernel's decomposition: the
    wrapper's padding to multiples of 8 and w to (9, ci8, co64); per item
    and consumer, each x chunk's halo boxes (the virtual image with zero
    fill), activated in place by the activator threads' passes only where
    the pixel lies in an image (the bf16 rule, s and b rounded to bf16,
    zero past Ci), the tap windows against the (chunk, tap) pieces in K
    order; the epilogue on the tile's rows that lie in an image and its
    columns inside W. Every output element must be written exactly once (it
    starts as NaN)."""
    N, H, W, Ci = x.shape
    Co = w.shape[3]
    ci8, co8 = _pad8(Ci), _pad8(Co)
    xp = torch.nn.functional.pad(x, (0, ci8 - Ci))
    s16 = torch.nn.functional.pad(s, (0, ci8 - Ci)).bfloat16()
    b16 = torch.nn.functional.pad(b, (0, ci8 - Ci)).bfloat16()
    plan = CF.fwd_plan(N, H, W, ci8, co8, n_sm)
    cw, kc = 64 * plan.nb, -(-ci8 // 64)
    co64 = -(-co8 // 64) * 64
    wz = torch.zeros(9, kc * 64, plan.cblocks * cw)
    wz[:, :Ci, :Co] = w.reshape(9, Ci, Co)
    assert plan.cblocks * cw >= co64
    V = N * (H + 1) - 1
    col_tiles = -(-W // TW)
    row_tiles = -(-V // TH)
    # the boxes' view of x: image n at virtual rows n*(H+1) .., one row and
    # column before, and room for a pair's second tile past the last one
    rows = (row_tiles + 1) * TH + 2
    xv = torch.zeros(rows, col_tiles * TW + 2, kc * 64)
    for n in range(N):
        r = 1 + n * (H + 1)
        xv[r:r + H, 1:1 + W, :ci8] = xp[n]
    sv = torch.zeros(kc * 64, dtype=torch.bfloat16)
    bv = torch.zeros(kc * 64, dtype=torch.bfloat16)
    sv[:ci8], bv[:ci8] = s16, b16
    p, v = _act_passes()
    hr, hc = p // HALO_W, p % HALO_W
    out = torch.full((N, H, W, co8), float("nan"))
    trow = torch.arange(TH).view(TH, 1).expand(TH, TW).reshape(-1)
    tcol = torch.arange(TW).view(1, TW).expand(TH, TW).reshape(-1)
    for _, _, pair, cb in _dx_walk(plan):
        ch = slice(cb * cw, min(co8, (cb + 1) * cw))
        for g in range(2):
            rt, ct = divmod(2 * pair + g, col_tiles)
            r0, c0 = rt * TH, ct * TW
            vr = r0 - 1 + torch.arange(TH + 2)
            row_in = (vr >= 0) & (vr < V) & (vr % (H + 1) != H)
            col_in = (c0 - 1 + torch.arange(HALO_W) >= 0) & \
                (c0 - 1 + torch.arange(HALO_W) < W)
            acc = torch.zeros(TH * TW, cw)
            for c in range(kc):
                halo = xv[r0:r0 + TH + 2, c0:c0 + HALO_W,
                          c * 64:(c + 1) * 64]
                # the 16-byte chunks the passes activate, as channels
                on = row_in[hr] & col_in[hc]
                hit = torch.zeros(TH + 2, HALO_W, 8, dtype=torch.bool)
                hit[hr[on], hc[on], v[on]] = True
                z = halo.bfloat16() * sv[c * 64:(c + 1) * 64] \
                    + bv[c * 64:(c + 1) * 64]
                z = (torch.clamp_min(z, 0) if relu else z).float()
                halo = torch.where(hit.repeat_interleave(8, dim=2), z, halo)
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    a = halo[ky:ky + TH, kx:kx + TW].reshape(-1, 64)
                    acc += a @ wz[tap, c * 64:(c + 1) * 64,
                                  cb * cw:(cb + 1) * cw]
            vr, cc = r0 + trow, c0 + tcol
            n, h = vr // (H + 1), vr % (H + 1)
            ok = (vr < V) & (cc < W) & (h < H)
            n, h, cc = n[ok], h[ok], cc[ok]
            assert bool(torch.isnan(out[n, h, cc][:, ch]).all())
            out[n, h, cc, ch] = acc[ok][:, :ch.stop - ch.start]
    assert not bool(torch.isnan(out).any())
    return out[..., :Co]


@pytest.mark.parametrize("n_sm", [132, 3])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", EDGE_SHAPES + [(2, 7, 7, 136, 72)])
def test_fwd_emulation_matches_reference(shape, relu, n_sm):
    """The CPU model of the bf16 forward kernel's decomposition, in f32 on
    bf16-valued inputs, against the plain version and JAX's Pallas forward
    in interpret mode, each given the plain version's bf16 activation z =
    relu(x*s + b) (bf16 rule) with s = 1, b = 0 and no ReLU, in f32: the
    same sums in another order, so within 1e-5 of max |reference|. And
    against JAX's forward on the bf16 inputs themselves (its own bf16
    activation, bf16 out), within one bf16 ulp of the output's magnitude.
    At 3 SMs the blocks walk several items each; (2, 7, 7, 136, 72) has
    three x chunks (the last ragged) and a ragged co block."""
    N, H, W, Ci, Co = shape
    x, s, b, w = _mats(*shape, seed=8)
    xb, sb, bb, wb = (torch.from_numpy(a).bfloat16() for a in (x, s, b, w))
    s, b = sb.float(), bb.float()
    got = _emulate_fwd(xb.float(), s, b, wb.float(), relu, n_sm)
    pre = CF._pre(xb, s, b)
    z = (torch.clamp_min(pre, 0) if relu else pre).float()
    ones, zeros = torch.ones(Ci), torch.zeros(Ci)
    ref = CF.fused_conv_reference(z, ones, zeros, wb.float(), relu=False)
    jref = np.asarray(JCF.fused_scale_relu_conv3x3(
        *(jnp.asarray(t.numpy()) for t in (z, ones, zeros, wb.float())),
        relu=False, interpret=True))
    for r in (ref.numpy(), jref):
        assert got.shape == r.shape
        assert np.abs(got.numpy() - r).max() <= 1e-5 * np.abs(r).max()
    j16 = JCF.fused_scale_relu_conv3x3(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s.numpy()),
        jnp.asarray(b.numpy()), jnp.asarray(w).astype(jnp.bfloat16),
        relu=relu, interpret=True)
    j16 = np.asarray(j16.astype(jnp.float32))
    assert np.abs(got.numpy() - j16).max() <= BF16_EPS * np.abs(j16).max()
