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
    before = (QM.LAUNCHES_MM, QM.LAUNCHES_MM_SCALED, QM.COPIES)
    QM.quantized_matmul(tx, tw)
    QM.quantized_matmul(tx, tw, torch.ones(16))
    assert (QM.LAUNCHES_MM, QM.LAUNCHES_MM_SCALED, QM.COPIES) == before
