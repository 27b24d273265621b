"""The port's int8 matrix product (mxnet_tpu_torch/kernels/quantized_matmul.py)
held against the JAX package's (mxnet_tpu/pallas_kernels/quantized_matmul.py).

On the CPU the wrapper runs its plain version (a float64 product cast to
int32, exact for these sizes); the JAX side runs its Pallas kernel in
interpret mode and its ``quantized_matmul_reference``. Integer sums are
exact, and the scaled output is one float32 multiply of the same converted
sum, so every comparison is bit for bit. tests/test_torch_cuda.py holds the
CUDA kernel against the plain version on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

# the function names, not the package attribute: mxnet_tpu.pallas_kernels
# re-exports the quantized_matmul function under the module's name
from mxnet_tpu.pallas_kernels.quantized_matmul import (
    quantized_matmul as jax_qmm, quantized_matmul_reference as jax_qmm_ref)
from mxnet_tpu_torch.kernels import quantized_matmul as QM


def _ints(M, K, N, seed, lo=-127, hi=128):
    rs = np.random.RandomState(seed)
    return (rs.randint(lo, hi, (M, K)).astype(np.int8),
            rs.randint(lo, hi, (K, N)).astype(np.int8),
            (rs.rand(N) * 1e-3 + 1e-5).astype(np.float32))


def _jax(x, w, scales=None, interpret=True):
    j = [jnp.asarray(a) for a in (x, w)]
    js = None if scales is None else jnp.asarray(scales)
    if interpret:
        return np.asarray(jax_qmm(*j, js, interpret=True))
    return np.asarray(jax_qmm_ref(*j, js))


def _bits(a):
    return np.asarray(a).view(np.int32)


SHAPES = [(32, 64, 48), (256, 256, 256), (50, 147, 1000)]


@pytest.mark.parametrize("interpret", [True, False],
                         ids=["interpret", "reference"])
@pytest.mark.parametrize("scaled", [False, True], ids=["int32", "scaled"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_bit_for_bit(shape, scaled, interpret):
    x, w, s = _ints(*shape, seed=sum(shape))
    ref = _jax(x, w, s if scaled else None, interpret)
    out = QM.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(s) if scaled else None)
    assert out.dtype == (torch.float32 if scaled else torch.int32)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("scaled", [False, True], ids=["int32", "scaled"])
@pytest.mark.parametrize("fill", [(-128, -128), (127, -128), (127, 127),
                                  (-127, 127)])
def test_int8_extremes(fill, scaled):
    """All -128 / +-127 operands: the largest sums (K * 2^14), still
    exact."""
    M, K, N = 16, 512, 24
    x = np.full((M, K), fill[0], np.int8)
    w = np.full((K, N), fill[1], np.int8)
    s = np.linspace(1e-6, 3e-3, N).astype(np.float32)
    ref = _jax(x, w, s if scaled else None, interpret=False)
    out = QM.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(s) if scaled else None)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
    if not scaled:
        assert int(out[0, 0]) == K * fill[0] * fill[1]


def test_random_extremes_mixed():
    x, w, s = _ints(40, 96, 72, seed=5, lo=-128, hi=128)
    for sc in (None, s):
        ref = _jax(x, w, sc, interpret=True)
        out = QM.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  None if sc is None else torch.from_numpy(sc))
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


def test_transposed_w_and_views():
    """A w given as ``weight.T`` of an (N, K) weight (the callers' layout)
    and a row-sliced x view give the same bits as contiguous operands."""
    x, w, s = _ints(33, 80, 40, seed=9)
    ref = _jax(x, w, s, interpret=False)
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).t()     # (K, N) view
    assert wt.stride(0) == 1
    wide = torch.zeros(33, 96, dtype=torch.int8)
    wide[:, :80] = torch.from_numpy(x)
    xv = wide[:, :80]
    assert xv.stride() == (96, 1)
    out = QM.quantized_matmul(xv, wt, torch.from_numpy(s))
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


def test_shape_and_dtype_errors():
    x, w, _ = _ints(8, 32, 16, seed=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError):
        QM.quantized_matmul(tx, tw.t())                  # mismatched K
    with pytest.raises(ValueError):
        QM.quantized_matmul(tx.reshape(-1), tw)
    with pytest.raises(ValueError):
        QM.quantized_matmul(tx, tw, torch.ones(15))      # scales shape
    with pytest.raises(TypeError):
        QM.quantized_matmul(tx.to(torch.int32), tw)
    with pytest.raises(TypeError):
        QM.quantized_matmul(tx, tw, torch.ones(16, dtype=torch.float64))
    # the JAX module raises the same error on a mismatch
    with pytest.raises(ValueError):
        jax_qmm(jnp.asarray(x), jnp.asarray(w).T)


def test_engaged_and_cpu_route_counts_no_launch():
    x, w, _ = _ints(8, 32, 16, seed=2)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert QM.engaged(tx, tw)
    assert not QM.engaged(tx.to(torch.int32), tw)
    assert not QM.engaged(tx, tw[:16])
    counters = ("LAUNCHES_MM", "LAUNCHES_MM_SCALED", "LAUNCHES_MM_BYTES",
                "LAUNCHES_MM_SCALED_BYTES", "COPIES")
    before = [getattr(QM, c) for c in counters]
    QM.quantized_matmul(tx, tw)
    QM.quantized_matmul(tx, tw, torch.ones(16))
    assert [getattr(QM, c) for c in counters] == before


# -- the wgmma route's plan and route (kernels/quantized_matmul.py) --------

# int8 ResNet-50 v1's distinct (M, K, N) products at batch 32 (im2col pads
# the stem's K from 147 to 160).
RESNET50_B32 = [
    (32, 2048, 1000), (1568, 512, 2048), (1568, 1024, 512),
    (1568, 1024, 2048), (1568, 2048, 512), (1568, 4608, 512),
    (6272, 256, 1024), (6272, 512, 256), (6272, 512, 1024),
    (6272, 1024, 256), (6272, 2304, 256), (25088, 128, 512),
    (25088, 256, 128), (25088, 256, 512), (25088, 512, 128),
    (25088, 1152, 128), (100352, 64, 64), (100352, 64, 256),
    (100352, 256, 64), (100352, 576, 64), (401408, 160, 64)]
# Edge shapes: M, K or N of 1, ragged tails of the 128-row tiles, the 64-
# and 128-column tiles and the 128-byte K blocks, M below 64, N % 4 != 0,
# deep K over few tiles (split), and batch 256's tallest product.
PLAN_EDGE = [(1, 64, 64), (64, 64, 1), (1, 16, 1), (5, 16, 1000),
             (1000, 160, 3), (130, 4608, 72), (1605, 4624, 520),
             (257, 1040, 260), (31, 96, 1000), (100, 48, 30),
             (200, 4608, 38), (129, 64, 64), (257, 4608, 200),
             (257, 9216, 72), (3211264, 160, 64)]
PLAN_SHAPES = RESNET50_B32 + PLAN_EDGE
N_SMS = [132, 5]


def _shape_id(s):
    return "x".join(map(str, s))


def _tile_rows(plan):
    """The rows of the first and the last row tile: where the numeric
    checks run (the plan's other tiles differ from these only in m0)."""
    last = (plan.tiles_m - 1) * 128
    rows = list(range(0, min(plan.M, 128)))
    return rows + [r for r in range(max(last, 128), plan.M)]


@pytest.mark.parametrize("n_sm", N_SMS)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_shape_id)
def test_plan_covers_every_output_and_k_once(shape, n_sm):
    """The blocks' (tile, K range) items cover each output tile once per
    128-byte K block, the tiles partition the (M, N) output and each
    tile's K ranges partition [0, K); at most one block per SM, every
    block busy, the items spread evenly."""
    M, K, N = shape
    plan = QM.qmm_plan(M, K, N, n_sm)
    assert plan.bn == (64 if N <= 64 else 128)
    assert 1 <= plan.grid <= min(n_sm, plan.items)
    assert plan.items == plan.tiles_m * plan.tiles_n * plan.nsplit
    assert (plan.nsplit - 1) * plan.kps < plan.kb <= plan.nsplit * plan.kps
    blocks = QM.qmm_blocks(plan)
    assert len(blocks) == plan.grid
    per = -(-plan.items // plan.grid)
    assert all(per - 1 <= len(b) <= per for b in blocks)
    cover = np.zeros((plan.tiles_m, plan.tiles_n, plan.kb), np.int64)
    ranges = {}
    for items in blocks:
        for m0, m1, n0, n1, k0, k1 in items:
            assert m0 % 128 == 0 and m1 == min(M, m0 + 128)
            assert n0 % plan.bn == 0 and n1 == min(N, n0 + plan.bn)
            assert k0 % 128 == 0 and k0 < k1 <= K
            tm, tn = m0 // 128, n0 // plan.bn
            cover[tm, tn, k0 // 128:-(-k1 // 128)] += 1
            ranges.setdefault((tm, tn), []).append((k0, k1))
    assert (cover == 1).all()
    for rs in ranges.values():
        rs.sort()
        assert rs[0][0] == 0 and rs[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))


@pytest.mark.parametrize("n_sm", N_SMS)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_shape_id)
def test_planned_partials_sum_to_the_reference(shape, n_sm):
    """A plain-torch model of the wgmma route: each item's partial product
    over its K range (exact in float64) summed in int64 per tile gives
    quantized_matmul_reference's int32 sum and scaled output bit for bit,
    in the first and the last row tile (at 132 SMs also JAX's Pallas
    kernel in interpret mode)."""
    M, K, N = shape
    plan = QM.qmm_plan(M, K, N, n_sm)
    rows = _tile_rows(plan)
    pos = {r: i for i, r in enumerate(rows)}
    x, w, s = _ints(len(rows), K, N, seed=M + K + N, lo=-128)
    tx = torch.from_numpy(x).double()
    tw = torch.from_numpy(w).double()
    acc = torch.zeros((len(rows), N), dtype=torch.int64)
    for items in QM.qmm_blocks(plan):
        for m0, m1, n0, n1, k0, k1 in items:
            if m0 not in pos:
                continue
            r0, r1 = pos[m0], pos[m0] + (m1 - m0)
            acc[r0:r1, n0:n1] += (tx[r0:r1, k0:k1] @ tw[k0:k1, n0:n1]) \
                .to(torch.int64)
    got = acc.to(torch.int32)
    ref = QM.quantized_matmul_reference(torch.from_numpy(x),
                                        torch.from_numpy(w))
    assert torch.equal(got, ref)
    scaled = got.to(torch.float32) * torch.from_numpy(s)
    ref_s = QM.quantized_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))
    np.testing.assert_array_equal(_bits(scaled.numpy()), _bits(ref_s.numpy()))
    if n_sm == N_SMS[0]:
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(_jax(x, w)))
        np.testing.assert_array_equal(_bits(scaled.numpy()),
                                      _bits(_jax(x, w, s)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("nsplit", [2, 3, 7])
def test_split_partials_same_bits_in_any_order(nsplit, seed):
    """A split tile's int32 partials added in any order (the kernel's last
    split adds the others to its own) give the same bits: integer
    addition is exact and associative while no value leaves int32."""
    rs = np.random.RandomState(seed)
    M, K, N = 96, 128 * nsplit + 48, 40
    x = torch.from_numpy(rs.randint(-128, 128, (M, K)).astype(np.int8))
    w = torch.from_numpy(rs.randint(-128, 128, (K, N)).astype(np.int8))
    cuts = [0] + sorted(rs.choice(np.arange(1, K // 16), nsplit - 1,
                                  replace=False) * 16) + [K]
    parts = [(x[:, a:b].double() @ w[a:b, :].double()).to(torch.int32)
             for a, b in zip(cuts, cuts[1:])]
    want = QM.quantized_matmul_reference(x, w)
    for _ in range(5):
        order = rs.permutation(nsplit)
        acc = parts[order[0]].clone()
        for i in order[1:]:
            acc += parts[i]
        assert torch.equal(acc, want)


@pytest.mark.parametrize("case,want", [
    ((100, 160, 64, 160, 160, 0, 0), "wgmma"),
    ((1, 64, 64, 64, 64, 512, 256), "wgmma"),
    ((300, 96, 200, 112, 96, 0, 16), "wgmma"),      # row-strided x view
    ((64, 64, 1, 64, 64, 0, 0), "wgmma"),           # N = 1: guarded stores
    ((100, 147, 64, 147, 147, 0, 0), "bytes"),      # K = 147 unpadded
    ((100, 147, 64, 160, 160, 0, 0), "wgmma"),      # K = 147 in padded rows
    ((64, 1, 64, 1, 1, 0, 0), "bytes"),
    ((300, 96, 200, 112, 96, 1, 0), "bytes"),       # x 1 byte off
    ((300, 96, 200, 96, 96, 0, 8), "bytes"),        # w 8 bytes off
    ((300, 96, 200, 104, 96, 0, 0), "bytes"),       # x rows 104 bytes apart
    ((0, 64, 64, 64, 64, 0, 0), "bytes"),
    ((64, 0, 64, 0, 0, 0, 0), "bytes"),
    ((64, 64, 64, 0, 64, 0, 0), "bytes"),           # rows of x repeated
])
def test_route_predicate(case, want):
    """The wgmma route takes operands that TMA can describe: non-empty,
    row strides and base addresses multiples of 16 bytes; the byte route
    every other."""
    assert QM.route(*case) == want


@pytest.mark.parametrize("shape", RESNET50_B32, ids=_shape_id)
def test_int8_path_operands_take_the_wgmma_route(shape):
    """The operands the int8 path gives the kernel at every ResNet-50 b32
    product (im2col's padded columns, a weight.T view) take the wgmma
    route: K-contiguous rows of a multiple of 16 bytes."""
    M, K, N = shape
    x = torch.zeros((2, K), dtype=torch.int8)
    w = torch.zeros((N, K), dtype=torch.int8).t()
    assert QM.route(M, K, N, x.stride(0), w.stride(1), 0, 0) == "wgmma"
