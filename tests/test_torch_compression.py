"""The port's 2-bit gradient codec (mxnet_tpu_torch/kernels/compression.py)
held against the JAX package's (mxnet_tpu/pallas_kernels/compression.py).

The same gradients and residuals, drawn with numpy from fixed seeds and
seeded with the values where the codec's edges lie (exactly +-threshold,
+-0.0, +-inf, NaN), go through ``quantize_2bit_jnp`` and the port's plain
version in bf16 and float32: words and new residuals must be equal bit for
bit (a NaN matches a NaN). In float32 the JAX Pallas form, run in
interpret mode, gives the same words and residuals. Words made by either
package decode in the other. The Pallas form rejects a bf16 gradient (its
residual output is declared float32); the port follows the jnp form,
which keeps the residual in the gradient's dtype.

The CUDA kernels are checked against these plain versions on the card
(``chip_smoke.py`` phase ``kernel``, ``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.pallas_kernels import compression as jc
from mxnet_tpu_torch.kernels import compression as tc

# The edge sizes: below, at and around one word and the default
# size_lower_bound of 4096, and a large odd size.
EDGE_N = (1, 15, 16, 17, 4095, 4096, 4097, 100003)
# The distinct element counts of ResNet-50 v1's 54 compressed parameters
# (its 53 convolution weights and the classifier's weight).
RN50_N = (4096, 9408, 16384, 32768, 36864, 65536, 131072, 147456, 262144,
          524288, 589824, 1048576, 2048000, 2097152, 2359296)
THRESHOLDS = (0.5, 0.3)
DTYPES = ("bfloat16", "float32")


def _special(thr):
    return np.asarray([thr, -thr, 0.0, -0.0, np.inf, -np.inf, np.nan,
                       thr * 0.999, -thr * 1.001, 2 * thr], np.float32)


def _case(n, dtype, thr, seed):
    """(grad, residual) as (jax, torch) pairs of the same values. The first
    values hit the edges: r exactly +-thr (the threshold rounded to the
    dtype), +-0.0 (-0.0 + -0.0 keeps the sign), +-inf, NaN."""
    rs = np.random.RandomState(seed)
    g = (rs.randn(n) * thr * 1.5).astype(np.float32)
    r = (rs.randn(n) * thr * 0.5).astype(np.float32)
    sp = _special(thr)[:n]
    g[:len(sp)] = sp
    r[:len(sp)] = np.where(np.isfinite(sp), 0.0, r[:len(sp)])
    r[3:4] = -0.0
    tdt = getattr(torch, dtype)
    tg, tr = (torch.from_numpy(a).to(tdt) for a in (g, r))
    jg, jr = (jnp.asarray(t.float().numpy()).astype(dtype) for t in (tg, tr))
    return (jg, tg), (jr, tr)


def _bits(a):
    """Integer bits of a JAX or torch array, and its NaN mask."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        nan = torch.isnan(a.float()).numpy() if a.is_floating_point() \
            else np.zeros(a.shape, bool)
        return (a.view(view[a.dtype]).numpy() if a.dtype in view
                else a.numpy()), nan
    a = np.asarray(a)
    view = {"bfloat16": np.int16, "float32": np.int32}
    if str(a.dtype) in view:
        return a.view(view[str(a.dtype)]), np.isnan(a.astype(np.float32))
    return a, np.zeros(a.shape, bool)


def _assert_same_bits(out, ref):
    (ob, on), (rb, rn) = _bits(out), _bits(ref)
    assert ob.dtype == rb.dtype and ob.shape == rb.shape
    np.testing.assert_array_equal(on, rn)
    np.testing.assert_array_equal(ob[~on], rb[~rn])


@pytest.mark.parametrize("n", EDGE_N + RN50_N)
@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_matches_jnp(dtype, thr, n):
    (jg, tg), (jr, tr) = _case(n, dtype, thr, seed=n % 1000)
    jw, jres = jc.quantize_2bit_jnp(jg, jr, thr)
    tw, tres = tc.quantize_2bit(tg, tr, thr)
    assert tw.shape == (tc.num_words(n),) and tres.dtype == tg.dtype
    _assert_same_bits(tw, jw)
    _assert_same_bits(tres, jres)


@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("thr", THRESHOLDS)
def test_quantize_matches_pallas_f32(thr, n):
    """In float32 the Pallas form (interpret mode) and the jnp form agree,
    and so does the port."""
    (jg, tg), (jr, tr) = _case(n, "float32", thr, seed=n % 1000 + 1)
    pw, pres = jc.quantize_2bit(jg, jr, thr, interpret=True)
    tw, tres = tc.quantize_2bit(tg, tr, thr)
    _assert_same_bits(tw, pw)
    _assert_same_bits(tres, pres)
    _assert_same_bits(tc.dequantize_2bit(tw, n, thr),
                      jc.dequantize_2bit(pw, n, thr, interpret=True))


@pytest.mark.parametrize("n", EDGE_N + RN50_N[-1:])
@pytest.mark.parametrize("thr", THRESHOLDS)
def test_dequantize_matches_jnp(thr, n):
    """Arbitrary words, codes 1 included (it decodes to 0)."""
    words = np.random.RandomState(n % 997).randint(
        -2 ** 31, 2 ** 31, tc.num_words(n), dtype=np.int64).astype(np.int32)
    out = tc.dequantize_2bit(torch.from_numpy(words), n, thr)
    ref = jc.dequantize_2bit_jnp(jnp.asarray(words), n, thr)
    assert out.dtype == torch.float32 and out.shape == (n,)
    _assert_same_bits(out, ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_words_cross_decode(dtype):
    """Words the JAX side encoded decode on the port's side, and the
    reverse (one wire format)."""
    n, thr = 4097, 0.5
    (jg, tg), (jr, tr) = _case(n, dtype, thr, seed=11)
    jw, _ = jc.quantize_2bit_jnp(jg, jr, thr)
    tw, _ = tc.quantize_2bit(tg, tr, thr)
    _assert_same_bits(tc.dequantize_2bit(torch.from_numpy(np.array(jw)),
                                         n, thr),
                      jc.dequantize_2bit_jnp(jw, n, thr))
    _assert_same_bits(jc.dequantize_2bit_jnp(jnp.asarray(tw.numpy()), n, thr),
                      tc.dequantize_2bit(tw, n, thr))


def test_wire_format():
    """Value i of a group at bit-pair 15 - i, so +thr at value 0 makes a
    negative word; the tail pads with zero codes; -0.0 with code 0 leaves
    +0.0 in the residual."""
    g = torch.zeros(37)
    g[0], g[1], g[16], g[36] = 0.5, -0.5, 0.7, -0.2
    res = torch.zeros(37)
    res[5] = -0.0
    g[5] = -0.0
    words, new_res = tc.quantize_2bit(g, res, 0.5)
    assert words.tolist() == [(3 << 30 | 2 << 28) - 2 ** 32,
                              (3 << 30) - 2 ** 32, 0]
    assert new_res[16].item() == pytest.approx(0.2)
    assert new_res[36].item() == pytest.approx(-0.2)
    assert str(new_res[5].item()) == "0.0"
    back = tc.dequantize_2bit(words, 37, 0.5)
    assert back[:2].tolist() == [0.5, -0.5] and back[16].item() == 0.5
    assert back.shape == (37,) and float(back[17:].abs().sum()) == 0.0


def test_pallas_form_rejects_bf16():
    """Finding pinned: the JAX package's Pallas quantize declares its
    residual output float32 but computes it in the gradient's dtype, so a
    bf16 gradient raises in interpret mode; the jnp form takes it."""
    g = jnp.ones((64,), jnp.bfloat16)
    with pytest.raises(ValueError, match="Invalid dtype"):
        jc.quantize_2bit(g, jnp.zeros_like(g), 0.5, interpret=True)
    words, res = jc.quantize_2bit_jnp(g, jnp.zeros_like(g), 0.5)
    assert res.dtype == jnp.bfloat16 and words.shape == (4,)


def test_operand_checks():
    g = torch.zeros(32)
    with pytest.raises(ValueError):
        tc.quantize_2bit(g, torch.zeros(32, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tc.quantize_2bit(g.reshape(4, 8), g.reshape(4, 8))
    with pytest.raises(ValueError):
        tc.dequantize_2bit(torch.zeros(3, dtype=torch.int32), 32)
    with pytest.raises(ValueError):
        tc.dequantize_2bit(torch.zeros(2, dtype=torch.int64), 32)


# -- the grouped entry points and the kernels' walk ----------------------------

# ResNet-50 v1's 54 compressed parameters (its 53 convolution weights and the
# classifier's weight), as (element count, how many), 25,502,912 elements.
RN50_COUNTS = ((4096, 1), (9408, 1), (16384, 6), (32768, 1), (36864, 3),
               (65536, 7), (131072, 2), (147456, 4), (262144, 11),
               (524288, 2), (589824, 6), (1048576, 5), (2048000, 1),
               (2097152, 1), (2359296, 3))
RN50_54 = tuple(n for n, k in RN50_COUNTS for _ in range(k))
# One group: the edge sizes around a word and the size bound, and an empty
# segment.
EDGE_GROUP = (1, 15, 16, 17, 4095, 0, 4096, 4097)
GROUPS = {"rn50": RN50_54, "edge": EDGE_GROUP,
          # over MAX_SEGMENTS non-empty segments: two launches
          "rn50_edge_edge": RN50_54 + EDGE_GROUP + EDGE_GROUP}


def test_rn50_sizes():
    assert len(RN50_54) == 54 and sum(RN50_54) == 25502912
    assert set(RN50_54) == set(RN50_N)


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_group_references_match_jnp(dtype, thr):
    """The grouped plain versions against quantize_2bit_jnp and
    dequantize_2bit_jnp segment by segment, bit for bit: words, new
    residuals, and the decoded values in flat and in each view."""
    cases = [_case(n, dtype, thr, seed=50 + i) if n else
             ((jnp.zeros(0, dtype), torch.zeros(0, dtype=getattr(torch,
                                                                 dtype))),) * 2
             for i, n in enumerate(EDGE_GROUP)]
    words, res = tc.quantize_2bit_group([tg for (_, tg), _ in cases],
                                        [tr for _, (_, tr) in cases], thr)
    flat, views = tc.dequantize_2bit_group(words, EDGE_GROUP, thr)
    assert flat.dtype == torch.float32 and flat.shape == (sum(EDGE_GROUP),)
    assert [v.shape[0] for v in views] == list(EDGE_GROUP)
    start = 0
    for ((jg, _), (jr, _)), n, w, r, v in zip(cases, EDGE_GROUP, words, res,
                                               views):
        jw, jres = jc.quantize_2bit_jnp(jg, jr, thr)
        _assert_same_bits(w, jw)
        _assert_same_bits(r, jres)
        jd = jc.dequantize_2bit_jnp(jw, n, thr)
        _assert_same_bits(v, jd)
        _assert_same_bits(flat[start:start + n], jd)
        start += n


@pytest.mark.parametrize("dtype", DTYPES)
def test_group_of_one_equals_single_call(dtype):
    (_, tg), (_, tr) = _case(4097, dtype, 0.5, seed=7)
    words, res = tc.quantize_2bit_group([tg], [tr], 0.5)
    w1, r1 = tc.quantize_2bit(tg, tr, 0.5)
    _assert_same_bits(words[0], w1)
    _assert_same_bits(res[0], r1)
    flat, views = tc.dequantize_2bit_group(words, [4097], 0.5)
    _assert_same_bits(flat, tc.dequantize_2bit(w1, 4097, 0.5))
    _assert_same_bits(views[0], flat)


def test_group_operand_checks():
    g32, g16 = torch.zeros(32), torch.zeros(32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one gradient dtype"):
        tc.quantize_2bit_group([g32, g16], [g32, g16])
    with pytest.raises(ValueError):
        tc.quantize_2bit_group([g32], [g32, g32])
    with pytest.raises(ValueError):
        tc.quantize_2bit_group([g32], [g16])
    with pytest.raises(ValueError):
        tc.dequantize_2bit_group([torch.zeros(2, dtype=torch.int32)], [33])
    assert tc.quantize_2bit_group([], []) == ([], [])
    flat, views = tc.dequantize_2bit_group([], [])
    assert flat.numel() == 0 and views == []


def test_chunk_words():
    assert tc.chunk_words("quantize", 2) == 128
    assert tc.chunk_words("quantize", 4) == 64
    assert tc.chunk_words("dequantize") == 128


@pytest.mark.parametrize("n_sm", [132, 5])
@pytest.mark.parametrize("words_per_chunk", [128, 64])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_plan_walk_covers_every_word_once(group, words_per_chunk, n_sm):
    """codec_plan and the kernel's walk (codec_walk): launches of at most
    MAX_SEGMENTS non-empty segments, in order; a grid within BLOCKS_PER_SM
    blocks an SM and one warp a chunk; every chunk inside one segment, and
    every word of every segment taken exactly once."""
    ns = GROUPS[group]
    plan = tc.codec_plan(ns, words_per_chunk, n_sm)
    live = [i for i, n in enumerate(ns) if n]
    assert [i for launch in plan for i in launch.segments] == live
    assert len(plan) == -(-len(live) // tc.MAX_SEGMENTS)
    seen = {i: np.zeros(tc.num_words(ns[i]), np.int64) for i in live}
    for launch in plan:
        assert 1 <= len(launch.segments) <= tc.MAX_SEGMENTS
        assert launch.first[0] == 0
        assert 1 <= launch.grid <= tc.BLOCKS_PER_SM * n_sm
        assert (launch.grid - 1) * tc.WARPS < launch.chunks
        walk = tc.codec_walk(launch, ns, words_per_chunk)
        assert len(walk) == launch.grid * tc.WARPS
        assert sum(map(len, walk)) == launch.chunks
        for chunks in walk:
            for seg, w0, cnt in chunks:
                assert seg in launch.segments
                assert 0 < cnt <= words_per_chunk
                assert w0 % words_per_chunk == 0
                assert w0 + cnt <= tc.num_words(ns[seg])
                seen[seg][w0:w0 + cnt] += 1
    assert all((s == 1).all() for s in seen.values())


def _codes(g, r, thr):
    """Each value's 2-bit code, from the plain version's words."""
    words, _ = tc.quantize_2bit_reference(g, r, thr)
    shifts = 2 * (15 - np.arange(16))
    codes = (words.numpy().astype(np.int64)[:, None] >> shifts) & 3
    return codes.reshape(-1)[:g.shape[0]]


def _kernel_quantize_words(codes, n, aligned, cw, itemsize, walk):
    """The words as the quantize kernel assembles them over its walk, and
    how often each value was taken. Bulk route (an aligned segment's whole
    words): lane l of a pass holds 16-byte unit u = base + l, VPU values
    from value 16 w0 + VPU u, each at bit-pair 15 - (u % UPW) VPU - k; the
    UPW lanes of a word OR their bits. Scalar route (the rest): lane l
    holds value v0 + l at bit-pair 15 - l % 16; 16 lanes OR theirs."""
    vpu = 16 // itemsize
    upw = 16 // vpu
    words = np.full(tc.num_words(n), -1, np.int64)
    taken = np.zeros(n, np.int64)
    for w0, _ in walk:
        fw = min(max(n // 16 - w0, 0), cw)
        bulk = aligned and fw > 0
        if bulk:
            for base in range(0, fw * upw, 32):
                u = base + np.arange(32)
                u = u[u < fw * upw]
                k = np.arange(vpu)
                v = 16 * w0 + vpu * u[:, None] + k
                bits = (codes[v] << (2 * (15 - (u[:, None] % upw) * vpu - k))
                        ).sum(axis=1)
                np.add.at(taken, v.reshape(-1), 1)
                for j in range(0, len(u), upw):
                    assert u[j] % upw == 0
                    words[w0 + u[j] // upw] = bits[j:j + upw].sum()
        v1 = min((w0 + cw) * 16, n)
        for v0 in range(16 * (w0 + (fw if bulk else 0)), v1, 32):
            lane = np.arange(32)
            v = v0 + lane
            ok = v < v1
            bits = np.where(ok, codes[np.minimum(v, n - 1)]
                            << (2 * (15 - lane % 16)), 0)
            np.add.at(taken, v[ok], 1)
            for half in (0, 16):
                if v0 + half < v1:
                    words[(v0 + half) // 16] = bits[half:half + 16].sum()
    words = np.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words, taken


def _kernel_dequantize(words, n, aligned, thr, walk):
    """The values as the dequantize kernel writes them over its walk. Bulk
    route: lane l loads words l + 32 k of the chunk; pass i's unit 32 i + l
    takes word 8 i + l // 4 from lane 8 (i % 4) + l // 4 of register
    i // 4 and expands its quarter l % 4. Scalar route: value v from word
    v // 16."""
    cw = tc.chunk_words("dequantize")
    out = np.full(n, np.nan, np.float32)
    taken = np.zeros(n, np.int64)
    codes_of = (lambda w, k: (w.astype(np.int64) >> (2 * (15 - k))) & 3)
    dec = (lambda c: np.where(c == 3, np.float32(thr),
                              np.where(c == 2, -np.float32(thr),
                                       np.float32(0))))
    lane = np.arange(32)
    for w0, _ in walk:
        fw = min(max(n // 16 - w0, 0), cw)
        bulk = aligned and fw > 0
        if bulk:
            wd = [np.where(lane + 32 * k < fw,
                           words[np.minimum(w0 + lane + 32 * k,
                                            len(words) - 1)], 0)
                  for k in range(cw // 32)]
            for i in range(cw // 8):
                if 8 * i >= fw:
                    break
                word = wd[i // 4][8 * (i % 4) + lane // 4]
                ok = 8 * i + lane // 4 < fw
                for j in range(4):
                    v = 16 * w0 + 4 * (32 * i + lane) + j
                    out[v[ok]] = dec(codes_of(word, 4 * (lane % 4) + j))[ok]
                    np.add.at(taken, v[ok], 1)
        v1 = min((w0 + cw) * 16, n)
        for v0 in range(16 * (w0 + (fw if bulk else 0)), v1, 32):
            v = v0 + lane
            v = v[v < v1]
            out[v] = dec(codes_of(words[v // 16], v % 16))
            np.add.at(taken, v, 1)
    return out, taken


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_model_matches_reference(dtype, aligned):
    """A model of both kernels' routes over their walk (132 and 5 SMs)
    gives the plain versions' words and values bit for bit, taking every
    value once: the bulk route's 16-byte units and word shuffles where the
    segment is aligned, the scalar route for a misaligned segment and for
    the last partial word."""
    ns = EDGE_GROUP + (100003,)
    itemsize = 2 if dtype == "bfloat16" else 4
    cw = tc.chunk_words("quantize", itemsize)
    for n_sm in (132, 5):
        for kernel, wpc in (("quantize", cw),
                            ("dequantize", tc.chunk_words("dequantize"))):
            for launch in tc.codec_plan(ns, wpc, n_sm):
                items = [it for chunks in tc.codec_walk(launch, ns, wpc)
                         for it in chunks]
                for seg in launch.segments:
                    n = ns[seg]
                    walk = [(w0, cnt) for s, w0, cnt in items if s == seg]
                    (_, tg), (_, tr) = _case(n, dtype, 0.5, seed=seg)
                    rw, _ = tc.quantize_2bit_reference(tg, tr, 0.5)
                    if kernel == "quantize":
                        words, taken = _kernel_quantize_words(
                            _codes(tg, tr, 0.5), n, aligned, cw, itemsize,
                            walk)
                        np.testing.assert_array_equal(words, rw.numpy())
                    else:
                        vals, taken = _kernel_dequantize(
                            rw.numpy(), n, aligned, 0.5, walk)
                        _assert_same_bits(
                            torch.from_numpy(vals),
                            tc.dequantize_2bit_reference(rw, n, 0.5))
                    assert (taken == 1).all()
