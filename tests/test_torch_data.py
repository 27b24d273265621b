"""The port's ``gluon.data`` held against the JAX package's on the CPU.

- Samplers: the same indices and batches; under one numpy seed the same
  shuffled order; ``last_batch`` keep, discard and rollover (across two
  epochs) and the lengths.
- Datasets: ``ArrayDataset``, ``SimpleDataset``, ``transform``,
  ``transform_first``, ``filter``, ``shard``, ``take`` item for item.
- ``DataLoader``: with no workers, a thread pool and worker processes the
  batches equal JAX's bit for bit (values, shapes, dtypes), shuffled under
  one numpy seed and with each ``last_batch``; a custom ``batchify_fn``;
  ``pin_memory`` with a CPU target leaves batches on the host; batches
  land on the caller's context.
- Transforms: the numpy ones bit for bit under the same Python and numpy
  seeds; the resizing ones (``Resize``, ``CenterCrop`` growing an image,
  ``RandomResizedCrop``, ``CropResize``) bit for bit too, uint8 and
  float32, every interpolation code 0-4: both packages call OpenCV's
  ``cv2.resize``; a code OpenCV does not have raises in both.
- Vision datasets read from files the tests write (idx files plain and
  gzipped, CIFAR's pickles) and the synthetic sets item for item; a
  record that does not decode raises IOError, and a record file without
  its index raises as in the JAX package (raw-pixel records:
  test_torch_recordio.py; JPEG and PNG records and image folders:
  test_torch_image.py).
"""
import gzip
import os
import pickle
import random
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jT
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as tT



@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _np(x):
    if isinstance(x, (mxj.nd.NDArray, mx.nd.NDArray)):
        return x.asnumpy()
    return np.asarray(x)


def _same(got, want):
    """Equal values, shapes and dtypes, through tuples."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape,
                                                       g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


# -- samplers ------------------------------------------------------------------

def test_sequential_and_random_samplers():
    assert list(tdata.SequentialSampler(7)) == \
        list(jdata.SequentialSampler(7))
    np.random.seed(11)
    want = list(jdata.RandomSampler(10))
    np.random.seed(11)
    got = list(tdata.RandomSampler(10))
    assert got == want and sorted(got) == list(range(10))
    assert len(tdata.RandomSampler(10)) == 10


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler(last_batch):
    js = jdata.BatchSampler(jdata.SequentialSampler(10), 3, last_batch)
    ts = tdata.BatchSampler(tdata.SequentialSampler(10), 3, last_batch)
    for _ in range(2):                  # rollover carries across epochs
        assert len(ts) == len(js)
        assert list(ts) == list(js)
    with pytest.raises(ValueError):
        list(tdata.BatchSampler(tdata.SequentialSampler(4), 3, "bogus"))


# -- datasets ------------------------------------------------------------------

def _arrays():
    rs = np.random.RandomState(0)
    return (rs.randint(0, 255, (11, 6, 5, 3)).astype(np.uint8),
            rs.randint(0, 10, 11).astype(np.int64))


def test_dataset_api_matches_jax():
    x, y = _arrays()
    jd, td = jdata.ArrayDataset(x, y), tdata.ArrayDataset(x, y)
    assert len(td) == len(jd) == 11
    _same(td[3], jd[3])
    _same(tdata.ArrayDataset(x)[2], jdata.ArrayDataset(x)[2])
    with pytest.raises(AssertionError):
        tdata.ArrayDataset(x, y[:3])

    def fn(a, b):
        return a.astype(np.float32) * 2, b + 1

    for lazy in (True, False):
        jt, tt = jd.transform(fn, lazy), td.transform(fn, lazy)
        for i in (0, 5, 10):
            _same(tt[i], jt[i])
        jf = jd.transform_first(lambda a: a[::-1], lazy)
        tf = td.transform_first(lambda a: a[::-1], lazy)
        _same(tf[4], jf[4])
    sd = tdata.SimpleDataset(list(range(9)))
    jsd = jdata.SimpleDataset(list(range(9)))
    assert [sd.filter(lambda v: v % 3)[i] for i in range(6)] == \
        [jsd.filter(lambda v: v % 3)[i] for i in range(6)]
    assert list(sd.shard(4, 1)._data) == list(jsd.shard(4, 1)._data)
    assert list(sd.take(4)._data) == list(jsd.take(4)._data)
    assert len(sd.take(40)) == len(jsd.take(40)) == 9


def test_record_file_dataset_raises(tmp_path):
    """A record file without its .idx sidecar raises in both packages."""
    rec = tmp_path / "data.rec"
    rec.write_bytes(b"")
    with pytest.raises(FileNotFoundError):
        jdata.RecordFileDataset(str(rec))
    with pytest.raises(FileNotFoundError):
        tdata.RecordFileDataset(str(rec))


# -- DataLoader ----------------------------------------------------------------

def _flip_cast():
    return (jT.Compose([jT.RandomFlipLeftRight(), jT.Cast("float32")]),
            tT.Compose([tT.RandomFlipLeftRight(), tT.Cast("float32")]))


def _loaders(shuffle, last_batch, **tkw):
    x, y = _arrays()
    jt, tt = _flip_cast()
    jd = jdata.ArrayDataset(x, y).transform_first(jt)
    td = tdata.ArrayDataset(x, y).transform_first(tt)
    return (jdata.DataLoader(jd, batch_size=4, shuffle=shuffle,
                             last_batch=last_batch),
            tdata.DataLoader(td, batch_size=4, shuffle=shuffle,
                             last_batch=last_batch, **tkw))


def _epoch(loader, seed):
    """One epoch under fixed seeds: the sampler's numpy draws, the flip's
    Python draws (one per sample, in order: the no-worker form)."""
    np.random.seed(seed)
    random.seed(seed)
    return [tuple(_np(a) for a in b) for b in loader]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_without_workers_matches_jax(shuffle, last_batch):
    jl, tl = _loaders(shuffle, last_batch)
    for epoch in range(2):              # rollover carries across epochs
        assert len(tl) == len(jl)
        want, got = _epoch(jl, epoch), _epoch(tl, epoch)
        assert len(got) == len(want)
        _same(got, want)


@pytest.mark.parametrize("thread_pool", [True, False])
def test_worker_modes_give_the_same_batches(thread_pool):
    """Batches of a deterministic transform through 3 workers equal the
    no-worker loader's and JAX's, in order; labels narrowed to int32 as
    JAX's arrays are."""
    x, y = _arrays()
    jd = jdata.ArrayDataset(x, y).transform_first(jT.ToTensor())
    td = tdata.ArrayDataset(x, y).transform_first(tT.ToTensor())
    want = _epoch(jdata.DataLoader(jd, batch_size=3, last_batch="keep"), 0)
    loader = tdata.DataLoader(td, batch_size=3, last_batch="keep",
                              num_workers=3, thread_pool=thread_pool,
                              prefetch=2)
    for _ in range(2):                  # the process pool is reused
        got = _epoch(loader, 0)
        _same(got, want)
    assert got[0][1].dtype == np.int32
    loader._shutdown_pool()


def test_loader_batchify_fn_and_placement():
    x, y = _arrays()
    td = tdata.ArrayDataset(x, y)

    def stack_first(samples):
        return np.stack([s[0] for s in samples])

    for kw in ({}, {"num_workers": 2}, {"num_workers": 2,
                                         "thread_pool": False}):
        batches = list(tdata.DataLoader(td, batch_size=5,
                                        batchify_fn=stack_first, **kw))
        assert [b.shape for b in batches] == [(5, 6, 5, 3), (5, 6, 5, 3),
                                              (1, 6, 5, 3)]
        got = batches[1] if isinstance(batches[1], np.ndarray) \
            else batches[1].asnumpy()
        np.testing.assert_array_equal(got, x[5:10])
    for batch in tdata.DataLoader(td, batch_size=4, pin_memory=True,
                                  num_workers=2):
        assert batch[0].context == mx.cpu()
        assert not batch[0]._data.is_pinned()   # a CPU target pins nothing
    with pytest.raises(ValueError):
        tdata.DataLoader(td)
    with pytest.raises(ValueError):
        tdata.DataLoader(td, batch_size=2,
                         sampler=tdata.SequentialSampler(11), shuffle=True)
    with pytest.raises(ValueError):
        tdata.DataLoader(td, batch_size=2, batch_sampler=tdata.BatchSampler(
            tdata.SequentialSampler(11), 2))


def test_loader_with_no_card_and_no_cpu_context_raises():
    """Outside ``with mx.cpu():`` the batches' target is gpu(0), which
    raises here rather than landing on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: gpu(0) resolves")
    x, y = _arrays()
    loader = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4)
    with mx.gpu(0):
        with pytest.raises(mx.MXNetError):
            next(iter(loader))


# -- transforms ----------------------------------------------------------------

def _img(h=13, w=17, c=3, dtype=np.uint8, seed=0):
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rs.randint(0, 256, (h, w, c)).astype(np.uint8)
    return (rs.rand(h, w, c) * 255).astype(dtype)


DETERMINISTIC = [
    ("Cast", (), {}), ("Cast", ("float16",), {}), ("ToTensor", (), {}),
    ("Normalize", ((10.0, 20.0, 30.0), (2.0, 4.0, 8.0)), {}),
    ("CenterCrop", ((5, 7),), {}), ("CropResize", (2, 3, 6, 4), {}),
    ("RandomFlipLeftRight", (), {}), ("RandomFlipTopBottom", (), {}),
    ("RandomFlipLeftRight", (1.0,), {}), ("RandomBrightness", (0.3,), {}),
    ("RandomContrast", (0.3,), {}), ("RandomSaturation", (0.3,), {}),
    ("RandomHue", (0.2,), {}), ("RandomLighting", (0.1,), {}),
    ("RandomColorJitter", (), {"brightness": 0.2, "contrast": 0.2,
                               "saturation": 0.2, "hue": 0.1}),
]


@pytest.mark.parametrize("name,args,kw", DETERMINISTIC,
                         ids=["%s%d" % (d[0], i)
                              for i, d in enumerate(DETERMINISTIC)])
@pytest.mark.parametrize("source", ["numpy", "ndarray"])
def test_numpy_transforms_bit_for_bit(name, args, kw, source):
    img = _img()
    if name == "Normalize":
        img = np.ascontiguousarray(img.transpose(2, 0, 1)).astype(
            np.float32)
    for seed in range(3):
        random.seed(seed)
        np.random.seed(seed)
        jin = mxj.nd.array(img) if source == "ndarray" else img
        want = getattr(jT, name)(*args, **kw)(jin)
        random.seed(seed)
        np.random.seed(seed)
        tin = mx.nd.array(img) if source == "ndarray" else img
        got = getattr(tT, name)(*args, **kw)(tin)
        assert isinstance(got, mx.nd.NDArray) and got.context == mx.cpu()
        _same(got, want)


def test_compose_bit_for_bit():
    img = _img(20, 24)
    random.seed(4)
    want = jT.Compose([jT.RandomFlipLeftRight(), jT.CenterCrop(16),
                       jT.ToTensor(), jT.Normalize(0.5, 0.25)])(img)
    random.seed(4)
    got = tT.Compose([tT.RandomFlipLeftRight(), tT.CenterCrop(16),
                      tT.ToTensor(), tT.Normalize(0.5, 0.25)])(img)
    _same(got, want)


def _close(got, want):
    """Bit for bit: both packages resize with OpenCV."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


RESIZES = [((8, 8), {}), ((20, 11), {}), ((17, 13), {}), ((5, 40), {}),
           ((34, 26), {}), ((9, 6), {}), ((16, 16), {"keep_ratio": True}),
           ((30, 7), {"keep_ratio": True}), ((8, 8), {"interpolation": 0}),
           ((33, 5), {"interpolation": 0}), (7, {}), ((1, 1), {}),
           ((17, 13), {"interpolation": 0}), ((20, 11), {"interpolation": 2}),
           ((9, 6), {"interpolation": 3}), ((34, 26), {"interpolation": 3}),
           ((20, 11), {"interpolation": 4}),
           ((16, 16), {"keep_ratio": True, "interpolation": 2})]


@pytest.mark.parametrize("size,kw", RESIZES,
                         ids=["r%d" % i for i in range(len(RESIZES))])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_as_opencv(size, kw, dtype, channels):
    img = _img(13, 17, channels, dtype)
    _close(tT.Resize(size, **kw)(img), jT.Resize(size, **kw)(img))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resizing_crops_as_opencv(dtype):
    img = _img(13, 17, 3, dtype, seed=2)
    _close(tT.CenterCrop((20, 30))(img), jT.CenterCrop((20, 30))(img))
    _close(tT.CropResize(1, 2, 9, 7, size=(12, 5))(img),
           jT.CropResize(1, 2, 9, 7, size=(12, 5))(img))
    for seed in range(6):
        random.seed(seed)
        want = jT.RandomResizedCrop((10, 8))(img)
        random.seed(seed)
        got = tT.RandomResizedCrop((10, 8))(img)
        _close(got, want)
    random.seed(0)      # ten misses (an impossible ratio): CenterCrop
    want = jT.RandomResizedCrop(8, scale=(0.9, 1.0), ratio=(50, 60))(img)
    random.seed(0)
    got = tT.RandomResizedCrop(8, scale=(0.9, 1.0), ratio=(50, 60))(img)
    _close(got, want)


def test_unported_interpolation_raises():
    """Codes 2-4 (cubic, area, Lanczos), which the port once lacked, give
    JAX's bytes; a code OpenCV does not have raises in both packages."""
    img = _img()
    for code in (2, 3, 4):
        _close(tT.Resize(8, interpolation=code)(img),
               jT.Resize(8, interpolation=code)(img))
        _close(tT.CropResize(0, 0, 4, 4, size=8, interpolation=code)(img),
               jT.CropResize(0, 0, 4, 4, size=8, interpolation=code)(img))
    for T in (tT, jT):
        with pytest.raises(Exception, match="nterpolation|resize"):
            T.Resize(8, interpolation=99)(img)


def test_transforms_module_exports_jax_names():
    assert sorted(tT.__all__) == sorted(jT.__all__)


# -- vision datasets -----------------------------------------------------------

def _write_idx(root, prefix, n, gz):
    rs = np.random.RandomState(n)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    ext = ".gz" if gz else ""
    with op(os.path.join(root, "%s-images-idx3-ubyte%s" % (prefix, ext)),
            "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with op(os.path.join(root, "%s-labels-idx1-ubyte%s" % (prefix, ext)),
            "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar(root, hundred):
    rs = np.random.RandomState(7)

    def batch(n, keys):
        d = {b"data": rs.randint(0, 256, (n, 3072)).astype(np.uint8)}
        for k in keys:
            d[k] = rs.randint(0, 100 if hundred else 10, n).tolist()
        return d
    if hundred:
        base = os.path.join(root, "cifar-100-python")
        os.makedirs(base)
        for name, n in (("train", 6), ("test", 4)):
            with open(os.path.join(base, name), "wb") as f:
                pickle.dump(batch(n, (b"fine_labels", b"coarse_labels")), f)
    else:
        base = os.path.join(root, "cifar-10-batches-py")
        os.makedirs(base)
        for name in ["data_batch_%d" % i for i in range(1, 6)] \
                + ["test_batch"]:
            with open(os.path.join(base, name), "wb") as f:
                pickle.dump(batch(3, (b"labels",)), f)


def _same_dataset(td, jd):
    assert len(td) == len(jd)
    for i in range(len(jd)):
        (tx, ty), (jx, jy) = td[i], jd[i]
        _same(tx, jx)
        assert tx.context == mx.cpu()
        assert int(ty) == int(jy) and np.asarray(ty).dtype == \
            np.asarray(jy).dtype


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_files(tmp_path, cls, gz):
    _write_idx(str(tmp_path), "train", 5, gz)
    _write_idx(str(tmp_path), "t10k", 3, gz)
    from mxnet_tpu.gluon.data import vision as jv
    for train in (True, False):
        td = getattr(tdata.vision, cls)(root=str(tmp_path), train=train)
        jd = getattr(jv, cls)(root=str(tmp_path), train=train)
        _same_dataset(td, jd)
    td = tdata.vision.MNIST(root=str(tmp_path),
                            transform=lambda x, y: (x.astype("float32"),
                                                    y + 1))
    jd = jv.MNIST(root=str(tmp_path),
                  transform=lambda x, y: (x.astype("float32"), y + 1))
    _same(td[2][0], jd[2][0])
    assert td[2][1] == jd[2][1]


@pytest.mark.parametrize("hundred", [False, True])
def test_cifar_files(tmp_path, hundred):
    _write_cifar(str(tmp_path), hundred)
    from mxnet_tpu.gluon.data import vision as jv
    name = "CIFAR100" if hundred else "CIFAR10"
    kws = [{"fine_label": True}, {"fine_label": False}] if hundred else [{}]
    for kw in kws:
        for train in (True, False):
            td = getattr(tdata.vision, name)(root=str(tmp_path),
                                             train=train, **kw)
            jd = getattr(jv, name)(root=str(tmp_path), train=train, **kw)
            _same_dataset(td, jd)


def test_synthetic_sets_and_missing_files(tmp_path, monkeypatch):
    from mxnet_tpu.gluon.data import vision as jv
    for cls in ("MNIST", "CIFAR10"):
        with pytest.raises(IOError):
            getattr(tdata.vision, cls)(root=str(tmp_path))
    monkeypatch.setenv("MXTPU_SYNTHETIC_DATA", "1")
    for cls in ("MNIST", "CIFAR10"):
        td = getattr(tdata.vision, cls)(root=str(tmp_path), train=False)
        jd = getattr(jv, cls)(root=str(tmp_path), train=False)
        assert len(td) == len(jd) == 256
        for i in (0, 100, 255):
            _same(td[i][0], jd[i][0])
            assert td[i][1] == jd[i][1]


def test_decoding_datasets_raise(tmp_path):
    """A record that holds no decodable image raises IOError, as does a
    folder's file that is not an image (JPEG/PNG decoding against JAX:
    test_torch_image.py)."""
    from mxnet_tpu_torch import recordio as trec
    rec, idx = str(tmp_path / "x.rec"), str(tmp_path / "x.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    w.write_idx(0, trec.pack(trec.IRHeader(0, 1.0, 0, 0),
                             b"\xff\xd8\xff\xe0" + bytes(60)))
    w.close()
    ds = tdata.vision.ImageRecordDataset(rec)
    with pytest.raises(IOError, match="decod"):
        ds[0]
    (tmp_path / "cls").mkdir()
    (tmp_path / "cls" / "a.jpg").write_bytes(b"not a jpeg")
    folder = tdata.vision.ImageFolderDataset(str(tmp_path))
    assert folder.synsets == ["cls"] and len(folder) == 1
    with pytest.raises(IOError, match="cannot read"):
        folder[0]


def test_port_runs_without_cv2():
    """Without OpenCV the package imports and the transforms that need no
    resize run; a resize raises ImportError naming cv2 (no numpy stand-in
    takes over)."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['cv2'] = None\n"
            "import numpy as np, mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch.gluon.data.vision import transforms as T\n"
            "img = np.arange(60, dtype=np.uint8).reshape(4, 5, 3)\n"
            "with mx.cpu():\n"
            "    out = T.Compose([T.CenterCrop(2), T.ToTensor()])(img)\n"
            "    assert out.shape == (3, 2, 2), out.shape\n"
            "    try:\n"
            "        T.Resize((7, 3))(img)\n"
            "    except ImportError as e:\n"
            "        assert 'cv2' in str(e), e\n"
            "    else:\n"
            "        raise AssertionError('a resize ran without cv2')\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
