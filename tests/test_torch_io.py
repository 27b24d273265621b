"""The port's ``io`` iterators held against the JAX package's on the CPU,
batch for batch: data and label values, shapes and dtypes, ``pad``,
``provide_data``/``provide_label``, over two epochs with ``reset()``.

- ``NDArrayIter``: numpy, NDArray, list and dict inputs; ``pad``,
  ``discard`` and ``roll_over`` last batches; shuffling under one numpy
  seed; no label.
- ``CSVIter`` (``round_batch`` on and off), ``LibSVMIter`` and
  ``MNISTIter`` (flat and not, shuffled) from files the tests write.
- ``ResizeIter`` (shorter and longer than its source) and
  ``PrefetchingIter`` (reset mid-epoch, then two full epochs); the
  prefetched batches are made on the host and moved to the caller's
  context on the caller's thread.
"""
import struct

import numpy as np
import pytest

import mxnet_tpu as mxj
from mxnet_tpu import io as jio
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as tio


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _arr(x):
    return x.asnumpy()


def _batches(it, epochs=2, seed=None):
    out = []
    for _ in range(epochs):
        if seed is not None:
            np.random.seed(seed)
        it.reset()
        ep = []
        for b in it:
            ep.append(([_arr(d) for d in b.data],
                       [_arr(l) for l in (b.label or [])], b.pad))
        out.append(ep)
    return out


def _same(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        for (gd, gl, gp), (wd, wl, wp) in zip(ge, we):
            assert gp == wp
            for g, w in zip(gd + gl, wd + wl):
                assert g.shape == w.shape and g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def _descs(it):
    return [(d.name, tuple(d.shape), np.dtype(d.dtype).name)
            for d in it.provide_data + it.provide_label]


DATA = np.arange(60, dtype=np.float32).reshape(15, 4)
LABEL = np.arange(15, dtype=np.float32)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("batch", [4, 5, 15, 16])
def test_ndarray_iter(handle, shuffle, batch):
    def make(io):
        return io.NDArrayIter(DATA, LABEL, batch_size=batch, shuffle=shuffle,
                              last_batch_handle=handle)
    np.random.seed(3)
    jit = make(jio)
    np.random.seed(3)
    tit = make(tio)
    assert _descs(tit) == _descs(jit)
    _same(_batches(tit, 3, seed=5), _batches(jit, 3, seed=5))


def test_ndarray_iter_inputs():
    rs = np.random.RandomState(0)
    a = rs.randn(7, 2, 3).astype(np.float32)
    b = rs.randint(0, 9, (7,)).astype(np.int64)
    cases = [
        (lambda io, nd: (nd.array(a), nd.array(b)), {}),
        (lambda io, nd: ([a, a * 2], [b]), {}),
        (lambda io, nd: ({"x": a, "y": a + 1}, {"lab": b}), {}),
        (lambda io, nd: (a, None), {"last_batch_handle": "discard"}),
        (lambda io, nd: (a, b), {"data_name": "img",
                                 "label_name": "cls"}),
    ]
    for make, kw in cases:
        jd, jl = make(jio, mxj.nd)
        td, tl = make(tio, mx.nd)
        jit = jio.NDArrayIter(jd, jl, batch_size=3, **kw)
        tit = tio.NDArrayIter(td, tl, batch_size=3, **kw)
        assert _descs(tit) == _descs(jit)
        _same(_batches(tit), _batches(jit))
        tit.reset()
        jit.reset()
        batch = next(tit)
        assert batch.data[0].context == mx.cpu()
        assert str(batch) == str(next(jit))


def test_csv_iter(tmp_path):
    rs = np.random.RandomState(1)
    data = rs.rand(11, 6).astype(np.float32)
    label = rs.randint(0, 3, (11, 1)).astype(np.float32)
    df, lf = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(df, data, delimiter=",")
    np.savetxt(lf, label, delimiter=",")
    for kw in ({"data_shape": (6,)}, {"data_shape": (2, 3),
                                      "label_csv": lf},
               {"data_shape": (6,), "round_batch": False}):
        jit = jio.CSVIter(data_csv=df, batch_size=4, **kw)
        tit = tio.CSVIter(data_csv=df, batch_size=4, **kw)
        assert _descs(tit) == _descs(jit)
        _same(_batches(tit), _batches(jit))


def test_libsvm_iter(tmp_path):
    f = tmp_path / "d.libsvm"
    f.write_text("1 0:0.5 3:1.5\n0 2:2.0\n\n2 1:-1 4:3.25 5:1\n1\n"
                 "0 0:1 5:2\n")
    jit = jio.LibSVMIter(data_libsvm=str(f), data_shape=(6,), batch_size=2)
    tit = tio.LibSVMIter(data_libsvm=str(f), data_shape=(6,), batch_size=2)
    assert _descs(tit) == _descs(jit)
    _same(_batches(tit), _batches(jit))


def _write_mnist(tmp_path, n=10):
    rs = np.random.RandomState(2)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    ip, lp = str(tmp_path / "img"), str(tmp_path / "lab")
    with open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return ip, lp


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_mnist_iter(tmp_path, flat, shuffle):
    ip, lp = _write_mnist(tmp_path)
    np.random.seed(4)
    jit = jio.MNISTIter(image=ip, label=lp, batch_size=4, flat=flat,
                        shuffle=shuffle)
    np.random.seed(4)
    tit = tio.MNISTIter(image=ip, label=lp, batch_size=4, flat=flat,
                        shuffle=shuffle)
    assert _descs(tit) == _descs(jit)
    _same(_batches(tit, seed=6), _batches(jit, seed=6))


@pytest.mark.parametrize("size", [2, 7])
def test_resize_iter(size):
    jit = jio.ResizeIter(jio.NDArrayIter(DATA, LABEL, batch_size=4), size)
    tit = tio.ResizeIter(tio.NDArrayIter(DATA, LABEL, batch_size=4), size)
    assert _descs(tit) == _descs(jit)
    _same(_batches(tit), _batches(jit))
    for reset_internal in (True, False):
        jit = jio.ResizeIter(jio.NDArrayIter(DATA, None, batch_size=4), 3,
                             reset_internal=reset_internal)
        tit = tio.ResizeIter(tio.NDArrayIter(DATA, None, batch_size=4), 3,
                             reset_internal=reset_internal)
        _same(_batches(tit, 3), _batches(jit, 3))


def test_prefetching_iter():
    jit = jio.PrefetchingIter(jio.NDArrayIter(DATA, LABEL, batch_size=4))
    tit = tio.PrefetchingIter(tio.NDArrayIter(DATA, LABEL, batch_size=4),
                              prefetch_depth=3)
    assert _descs(tit) == _descs(jit)
    next(tit)
    next(jit)               # reset in the middle of an epoch
    _same(_batches(tit), _batches(jit))
    tit.reset()
    batch = next(tit)
    assert batch.data[0].context == mx.cpu() and batch.pad == 0
    with pytest.raises(AssertionError):
        tio.PrefetchingIter([tio.NDArrayIter(DATA), tio.NDArrayIter(DATA)])


def test_prefetching_makes_batches_on_the_host():
    """The background thread runs its source under ``with mx.cpu():``: a
    source that reads the current context sees the CPU there, while the
    caller's ``with`` (a GPU here, which has no card) decides where
    ``next()`` puts the batch, and raises."""
    seen = []

    class Probe(tio.DataIter):
        def __init__(self):
            super().__init__(2)
            self.left = 2

        def next(self):
            if not self.left:
                raise StopIteration
            self.left -= 1
            seen.append(mx.current_context())
            return tio.DataBatch([mx.nd.array(DATA[:2])])

        def reset(self):
            self.left = 2

    it = tio.PrefetchingIter(Probe())
    assert next(it).data[0].context == mx.cpu()
    assert seen[0] == mx.cpu()
    try:
        import torch
        has_card = torch.cuda.is_available()
    except ImportError:
        has_card = False
    if not has_card:
        with mx.gpu(0):
            with pytest.raises(mx.MXNetError):
                next(it)


def test_data_desc_and_batch():
    jd = jio.DataDesc("x", (2, 3), layout="NHWC")
    td = tio.DataDesc("x", (2, 3), layout="NHWC")
    assert repr(td) == repr(jd)
    assert tio.DataDesc.get_batch_axis("NHWC") == \
        jio.DataDesc.get_batch_axis("NHWC") == 0
    assert tio.DataDesc.get_batch_axis("HWNC") == 2
    assert tio.DataDesc.get_batch_axis(None) == 0
    tb = tio.DataBatch(mx.nd.array(DATA[:2]), mx.nd.array(LABEL[:2]),
                       pad=1)
    jb = jio.DataBatch(mxj.nd.array(DATA[:2]), mxj.nd.array(LABEL[:2]),
                       pad=1)
    assert str(tb) == str(jb)
    assert isinstance(tb.data, list) and tb.pad == 1
    assert sorted(tio.__all__) == sorted(
        ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
         "LibSVMIter", "ResizeIter", "PrefetchingIter", "MNISTIter",
         "ImageRecordIter", "DevicePrefetchIter", "DevicePrefetcher"])
    assert set(tio.__all__) <= set(jio.__all__)
