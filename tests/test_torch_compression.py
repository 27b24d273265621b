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
