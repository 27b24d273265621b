"""The port's ImageRecordIter, DevicePrefetchIter and DataLoaderIter against
the JAX package's, on the CPU.

- ``ImageRecordIter`` over one raw-pixel record file, two epochs, byte for
  byte: the shuffled order (``Random(seed + epoch)``), the per-sample crop
  and flip seeds, ``round_batch`` with a count that the batch does not
  divide (``pad``, and the short batch dropped without it), uint8 and
  float32 with mean and std, ``label_width``, with and without the .idx
  file and the producer thread. ``resize`` and the upscale of small images
  are OpenCV's in both packages: byte for byte too (JPEG and PNG records:
  test_torch_image.py).
- A record that does not decode raises, again on the next call; without
  OpenCV raw records that need no resize still run, and a resize raises
  ImportError naming cv2.
- ``DevicePrefetchIter`` to the CPU passes batches through unchanged,
  restarts with ``reset()`` and hands a worker's exception over once.
- ``DataLoaderIter`` against JAX's, padded last batch included.
"""
import sys

import numpy as np
import pytest

import mxnet_tpu as mxj
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec


def _records(tmp_path, n=11, small=(), seed=0, label_width=1):
    """A raw-pixel .rec/.idx of ``n`` images of varied sizes (those in
    ``small`` below the 8x8 crop); labels ``i % 10``, or arrays of
    ``label_width`` values."""
    rs = np.random.RandomState(seed)
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        h, w_ = (5, 6) if i in small else (10 + i % 3, 12 + i % 2)
        img = rs.randint(0, 256, (h, w_, 3)).astype(np.uint8)
        label = float(i % 10) if label_width == 1 else \
            [float(i % 10)] + [float(i)] * (label_width - 1)
        w.write_idx(i, trec.pack_raw_img(trec.IRHeader(0, label, i, 0), img))
    w.close()
    return rec, idx


def _epochs(it, n_epochs=2):
    out = []
    for _ in range(n_epochs):
        it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    return out


def _both(rec, idx, **kw):
    args = dict(path_imgrec=rec, data_shape=(3, 8, 8), batch_size=4,
                seed=3, **kw)
    if idx is not None:
        args["path_imgidx"] = idx
    return _epochs(tio.ImageRecordIter(**args)), \
        _epochs(jio.ImageRecordIter(**args))


def _same(t, j, tol=0):
    assert len(t) == len(j)
    for te, je in zip(t, j):
        assert len(te) == len(je) > 0
        for (td, tl, tp), (jd, jl, jp) in zip(te, je):
            assert td.dtype == jd.dtype and td.shape == jd.shape
            if tol:
                assert np.abs(td.astype(np.int32) - jd.astype(np.int32)) \
                    .max() <= tol
            else:
                np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
            assert tp == jp


CASES = {
    "plain": {},
    "shuffle": {"shuffle": True},
    "crop_mirror": {"shuffle": True, "rand_crop": True, "rand_mirror": True},
    "uint8": {"shuffle": True, "rand_crop": True, "rand_mirror": True,
              "dtype": "uint8"},
    "mean_std": {"rand_crop": True, "mean_r": 123.68, "mean_g": 116.78,
                 "mean_b": 103.94, "std_r": 58.4, "std_g": 57.1,
                 "std_b": 57.4},
    "no_round_batch": {"shuffle": True, "round_batch": False},
    "no_prefetch": {"shuffle": True, "rand_mirror": True,
                    "prefetch_buffer": 0, "preprocess_threads": 1},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_record_iter_matches_jax(tmp_path, case):
    rec, idx = _records(tmp_path)
    t, j = _both(rec, idx, **CASES[case])
    _same(t, j)
    assert [b[2] for b in t[0]] == ([0, 0] if case == "no_round_batch"
                                    else [0, 0, 1])
    if CASES[case].get("shuffle"):
        assert not all(np.array_equal(a[1], b[1])
                       for a, b in zip(t[0], t[1]))


def test_image_record_iter_without_index(tmp_path):
    rec, _ = _records(tmp_path)
    t, j = _both(rec, None, shuffle=True, rand_crop=True)
    _same(t, j)


def test_image_record_iter_label_width(tmp_path):
    rec, idx = _records(tmp_path, label_width=3)
    t, j = _both(rec, idx, shuffle=True, label_width=3)
    _same(t, j)
    it = tio.ImageRecordIter(rec, (3, 8, 8), 4, path_imgidx=idx,
                             label_width=3)
    assert it.provide_label[0].shape == (4,)
    assert it.provide_data[0].shape == (4, 3, 8, 8)


@pytest.mark.parametrize("kw", [{"resize": 9}, {"resize": 14},
                                {"resize": 9, "rand_crop": True,
                                 "rand_mirror": True}, {}])
def test_image_record_iter_resize_within_one(tmp_path, kw):
    """Resize and the upscale of images below the crop (records 2 and 7):
    OpenCV's INTER_LINEAR in both packages, so byte for byte."""
    rec, idx = _records(tmp_path, small=(2, 7))
    t, j = _both(rec, idx, dtype="uint8", shuffle=True, **kw)
    _same(t, j)


def test_image_record_iter_reset_mid_epoch(tmp_path):
    """A reset mid-epoch stops and joins the producer: the next epoch
    starts at its own first batch."""
    rec, idx = _records(tmp_path)
    args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 8, 8),
                batch_size=4, shuffle=True, seed=5)
    t, j = tio.ImageRecordIter(**args), jio.ImageRecordIter(**args)
    next(t), next(j)
    t.reset(), j.reset()
    for _ in range(3):
        np.testing.assert_array_equal(next(t).data[0].asnumpy(),
                                      next(j).data[0].asnumpy())


def test_encoded_record_raises(tmp_path):
    """A JPEG record that does not decode raises IOError, and again on the
    next call rather than hanging."""
    rec, idx = str(tmp_path / "e.rec"), str(tmp_path / "e.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    w.write_idx(0, trec.pack(trec.IRHeader(0, 1.0, 0, 0),
                             b"\xff\xd8\xff\xe0" + bytes(32)))
    w.close()
    it = tio.ImageRecordIter(rec, (3, 8, 8), 1, path_imgidx=idx)
    with pytest.raises(IOError, match="decode"):
        next(it)
    with pytest.raises(IOError):    # raised again, not hung
        next(it)


def test_port_never_imports_cv2(tmp_path, monkeypatch):
    """With ``cv2`` unimportable the raw-record path that needs no resize
    runs (JAX's needs cv2 for every record), and a resize raises
    ImportError naming cv2: OpenCV is imported only where it is used."""
    rec, idx = _records(tmp_path)
    monkeypatch.setitem(sys.modules, "cv2", None)
    it = tio.ImageRecordIter(rec, (3, 8, 8), 4, path_imgidx=idx,
                             rand_crop=True, rand_mirror=True)
    assert len(_epochs(it, 1)[0]) == 3
    with pytest.raises(ImportError, match="cv2"):
        next(tio.ImageRecordIter(rec, (3, 8, 8), 4, path_imgidx=idx,
                                 resize=9))
    with pytest.raises(ImportError):
        jio.ImageRecordIter(rec, (3, 8, 8), 4, path_imgidx=idx).next()


def test_device_prefetch_on_cpu_passes_batches_through(tmp_path):
    rec, idx = _records(tmp_path)
    args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 8, 8),
                batch_size=4, shuffle=True, rand_crop=True, dtype="uint8")
    host = _epochs(tio.ImageRecordIter(**args))
    with mx.cpu():
        pf = tio.DevicePrefetchIter(tio.ImageRecordIter(**args))
        placed = []
        for _ in range(2):
            pf.reset()
            epoch = []
            for b in pf:
                assert b.data[0].context == mx.cpu()
                epoch.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                              b.pad))
            placed.append(epoch)
    _same(placed, host)
    with mx.cpu():
        pairs = [(np.arange(6).reshape(2, 3) + i, np.float32(i))
                 for i in range(3)]
        out = list(tio.DevicePrefetchIter(pairs, depth=1))
    assert len(out) == 3
    for (x, y), (px, py) in zip(pairs, out):
        np.testing.assert_array_equal(px.numpy(), x)
        assert py == y
    pf = tio.DevicePrefetchIter(
        pairs, place_fn=lambda b: (b[0] * 2, b[1]), sharding=mx.cpu())
    assert [int(b[0].sum()) for b in pf] == [2 * int(x.sum())
                                             for x, _ in pairs]


def test_device_prefetch_worker_error_once_then_reset():
    class Source:
        def __init__(self):
            self.n = 0

        def __iter__(self):
            self.n += 1
            yield np.zeros(2)
            if self.n == 1:
                raise RuntimeError("bad batch")

        def reset(self):
            pass

    with mx.cpu():
        pf = tio.DevicePrefetchIter(Source())
        next(pf)
        with pytest.raises(RuntimeError, match="bad batch"):
            next(pf)
        with pytest.raises(StopIteration):
            next(pf)
        pf.reset()
        assert len(list(pf)) == 1


def test_data_loader_iter_matches_jax():
    from mxnet_tpu.contrib.io import DataLoaderIter as JIter
    from mxnet_tpu_torch.contrib.io import DataLoaderIter as TIter
    X = np.arange(70, dtype=np.float32).reshape(10, 7)
    Y = np.arange(10, dtype=np.float32) % 3
    with mx.cpu():
        t = TIter(mx.gluon.data.DataLoader(
            mx.gluon.data.ArrayDataset(X, Y), batch_size=4))
        tb = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
              for b in t]
        t.reset()
        assert len(list(t)) == 3
    j = JIter(mxj.gluon.data.DataLoader(
        mxj.gluon.data.ArrayDataset(X, Y), batch_size=4))
    jb = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in j]
    _same([tb], [jb])
    assert [b[2] for b in tb] == [0, 0, 2]
    assert t.provide_data[0].shape == (4, 7)
    assert t.provide_label[0].name == "softmax_label"
