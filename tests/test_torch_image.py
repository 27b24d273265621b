"""The port's image slice against the JAX package's, on the CPU: OpenCV
decoding and encoding, ``mx.image``, ``ImageRecordIter`` on encoded records,
the encoded-image datasets, ``ImageDetIter`` and the ``nd.image`` ops.

- Decoding, encoding and resizes (all five interpolation codes, uint8 and
  float32) bit for bit: both packages call the same OpenCV.
- ``ImageRecordIter`` on JPEG and PNG records: every batch byte for byte
  over two epochs; so are ``ImageIter`` on ``.rec`` and on ``.lst``,
  ``ImageFolderDataset`` and ``ImageRecordDataset``.
- Each augmenter and ``CreateAugmenter`` list under the same Python and
  numpy seeds: uint8 bit for bit, float within 1e-6 of the largest
  magnitude; their ``dumps()``.
- ``ImageDetIter`` with ``CreateDetAugmenter`` and each ``Det*`` augmenter:
  the same images and padded labels within 1e-6.
- The ``nd.image`` ops: the deterministic ones within 1e-6; the random ones
  by law, shape, dtype and seed (they draw from the port's generators, JAX
  from threefry keys), and each at a degenerate range against JAX within
  1e-6.
- ``import mxnet_tpu_torch`` imports neither cv2, jax nor mxnet_tpu; no
  module of the port imports example/; without cv2 an encoded-image call
  raises ImportError naming it.
"""
import ast
import os
import random
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu import image as jimg
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon.data import vision as jvision
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.gluon.data import vision as tvision
from mxnet_tpu_torch.ops import registry as treg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_RTOL = 1e-6


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(got, want, rtol=FLOAT_RTOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if g.dtype == np.uint8 or rtol == 0:
        np.testing.assert_array_equal(g, w)
    elif w.size:
        err = np.abs(g.astype(np.float64) - w).max()
        assert err <= rtol * max(1.0, float(np.abs(w).max())), err


def _picture(h=37, w=45, seed=0):
    """A smooth colour picture with noise: JPEG keeps it recognisable."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                    ((xx + yy) * 3) % 256], -1).astype(np.int32)
    img += rs.randint(-20, 21, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _seed(s):
    random.seed(s)
    np.random.seed(s)


# -- decoding, encoding, resizing ------------------------------------------------

@pytest.mark.parametrize("fmt,quality", [(".jpg", 90), (".jpg", 95),
                                         (".png", 3), (".png", 9)])
def test_pack_and_unpack_img(fmt, quality):
    img = _picture()
    header = jrec.IRHeader(0, [1.0, 2.5], 7, 0)
    s = trec.pack_img(header, img, quality=quality, img_fmt=fmt)
    assert s == jrec.pack_img(header, img, quality=quality, img_fmt=fmt)
    for iscolor in (1, 0, -1):
        th, ti = trec.unpack_img(s, iscolor)
        jh, ji = jrec.unpack_img(s, iscolor)
        np.testing.assert_array_equal(th.label, jh.label)
        _same(ti, ji)
        assert ti.flags.writeable


@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_and_imread(tmp_path, flag, to_rgb):
    img = _picture(seed=1)
    for ext in (".jpg", ".png"):
        ok, buf = cv2.imencode(ext, img)
        assert ok
        with mx.cpu():
            got = timg.imdecode(buf.tobytes(), flag, to_rgb)
            got_nd = timg.imdecode(mx.nd.array(buf), flag, to_rgb)
        want = jimg.imdecode(buf.tobytes(), flag, to_rgb)
        _same(got, want)
        _same(got_nd, want)
        assert got.context == mx.cpu()
        path = str(tmp_path / ("p" + ext))
        cv2.imwrite(path, img)
        _same(timg.imread(path, flag, to_rgb), jimg.imread(path, flag,
                                                           to_rgb))
    with pytest.raises(IOError):
        timg.imdecode(b"not an image")
    with pytest.raises(IOError):
        timg.imread(str(tmp_path / "missing.jpg"))


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("channels", [3, 1])
def test_resizes_as_opencv(interp, dtype, channels):
    img = _picture(13, 17, seed=2)[..., :channels].astype(dtype)
    if dtype == np.float32:
        img = img / 7.0
    for w, h in ((8, 8), (30, 7), (17, 13), (40, 29), (5, 33)):
        _same(timg.imresize(img, w, h, interp),
              jimg.imresize(img, w, h, interp), 0)
    _same(timg.resize_short(img, 9, interp), jimg.resize_short(img, 9,
                                                               interp), 0)


def test_crops_and_normalize():
    img = _picture(20, 24, seed=3)
    _same(timg.fixed_crop(img, 2, 3, 10, 8), jimg.fixed_crop(img, 2, 3,
                                                             10, 8), 0)
    _same(timg.fixed_crop(img, 2, 3, 10, 8, size=(7, 5)),
          jimg.fixed_crop(img, 2, 3, 10, 8, size=(7, 5)), 0)
    t, tb = timg.center_crop(img, (9, 11))
    j, jb = jimg.center_crop(img, (9, 11))
    _same(t, j, 0)
    assert tb == jb
    for s in range(4):
        _seed(s)
        t, tb = timg.random_crop(img, (9, 11))
        _seed(s)
        j, jb = jimg.random_crop(img, (9, 11))
        _same(t, j, 0)
        assert tb == jb
    _same(timg.color_normalize(img, (120, 110, 100), (50, 60, 70)),
          jimg.color_normalize(img, (120, 110, 100), (50, 60, 70)))


# -- augmenters -----------------------------------------------------------------

EIG = (np.array([55.46, 4.794, 1.148]),
       np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                 [-0.5836, -0.6948, 0.4203]]))
AUGS = {
    "resize": ("ResizeAug", (14,), {}),
    "resize_cubic": ("ResizeAug", (30,), {"interp": 2}),
    "force_resize": ("ForceResizeAug", ((11, 19),), {"interp": 3}),
    "random_crop": ("RandomCropAug", ((9, 7),), {}),
    "center_crop": ("CenterCropAug", ((9, 7),), {}),
    "flip": ("HorizontalFlipAug", (0.5,), {}),
    "cast": ("CastAug", (), {}),
    "normalize": ("ColorNormalizeAug", ((120.0, 110.0, 100.0),
                                        (50.0, 60.0, 70.0)), {}),
    "brightness": ("BrightnessJitterAug", (0.4,), {}),
    "contrast": ("ContrastJitterAug", (0.4,), {}),
    "saturation": ("SaturationJitterAug", (0.4,), {}),
    "lighting": ("LightingAug", (0.1,) + EIG, {}),
    "gray": ("RandomGrayAug", (0.5,), {}),
    "hue": ("HueJitterAug", (0.3,), {}),
    "color_jitter": ("ColorJitterAug", (0.3, 0.3, 0.3), {}),
}


@pytest.mark.parametrize("case", sorted(AUGS))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_augmenter(case, dtype):
    cls, args, kw = AUGS[case]
    img = _picture(20, 24, seed=4).astype(dtype)
    taug, jaug = getattr(timg, cls)(*args, **kw), getattr(jimg, cls)(*args,
                                                                     **kw)
    if cls not in ("LightingAug", "RandomGrayAug", "HueJitterAug"):
        assert taug.dumps() == jaug.dumps()
    for s in range(6):
        _seed(s)
        with mx.cpu():
            got = taug(mx.nd.array(img, ctx=mx.cpu()))
        _seed(s)
        want = jaug(mxj.nd.array(img))
        _same(got, want)


CREATE = [dict(), dict(resize=30, rand_crop=True, rand_mirror=True),
          dict(rand_crop=True, brightness=0.2, contrast=0.2, saturation=0.2,
               pca_noise=0.1, mean=True, std=True),
          dict(resize=26, mean=np.array([1.0, 2.0, 3.0]), inter_method=1)]


@pytest.mark.parametrize("kw", CREATE, ids=["plain", "crop", "jitter",
                                            "mean"])
def test_create_augmenter(kw):
    tl = timg.CreateAugmenter((3, 16, 18), **kw)
    jl = jimg.CreateAugmenter((3, 16, 18), **kw)
    assert [type(a).__name__ for a in tl] == [type(a).__name__ for a in jl]
    assert [a.dumps() for a in tl if not isinstance(a, timg.LightingAug)] \
        == [a.dumps() for a in jl if not isinstance(a, jimg.LightingAug)]
    img = _picture(23, 29, seed=5)
    for s in range(4):
        _seed(s)
        got = mx.nd.array(img, ctx=mx.cpu())
        for a in tl:
            got = a(got)
        _seed(s)
        want = mxj.nd.array(img)
        for a in jl:
            want = a(want)
        _same(got, want)


# -- the encoded record and file paths ------------------------------------------

def _encoded_records(tmp_path, n=11, fmt=".jpg", small=()):
    rs = np.random.RandomState(0)
    rec, idx = str(tmp_path / "e.rec"), str(tmp_path / "e.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        h, w_ = (5, 6) if i in small else (14 + i % 3, 16 + i % 2)
        img = _picture(h, w_, seed=int(rs.randint(1000)))
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i % 10), i, 0),
                                     img, quality=90, img_fmt=fmt))
    w.close()
    return rec, idx


def _epochs(it, n_epochs=2):
    out = []
    for _ in range(n_epochs):
        it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    return out


def _same_epochs(t, j):
    assert len(t) == len(j)
    for te, je in zip(t, j):
        assert len(te) == len(je) > 0
        for (td, tl, tp), (jd, jl, jp) in zip(te, je):
            _same(td, jd, 0)
            np.testing.assert_array_equal(tl, jl)
            assert tp == jp


RECORD_ITER = {
    "plain": {},
    "crop_mirror_u8": {"shuffle": True, "rand_crop": True,
                       "rand_mirror": True, "dtype": "uint8"},
    "resize": {"shuffle": True, "resize": 12, "rand_crop": True},
    "mean_std": {"rand_crop": True, "mean_r": 123.68, "mean_g": 116.78,
                 "mean_b": 103.94, "std_r": 58.4, "std_g": 57.1,
                 "std_b": 57.4},
    "no_prefetch": {"shuffle": True, "rand_mirror": True,
                    "prefetch_buffer": 0, "preprocess_threads": 1},
}


@pytest.mark.parametrize("case", sorted(RECORD_ITER))
@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_image_record_iter_on_encoded_records(tmp_path, case, fmt):
    rec, idx = _encoded_records(tmp_path, fmt=fmt, small=(3,))
    args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 8, 8),
                batch_size=4, seed=3, **RECORD_ITER[case])
    _same_epochs(_epochs(tio.ImageRecordIter(**args)),
                 _epochs(jio.ImageRecordIter(**args)))


def _lst(tmp_path, n=9):
    root = tmp_path / "imgs"
    root.mkdir()
    lines = []
    for i in range(n):
        name = "im%d.%s" % (i, "png" if i % 3 == 0 else "jpg")
        cv2.imwrite(str(root / name), _picture(18 + i % 4, 20, seed=i))
        lines.append("%d\t%d\t%s" % (i, i % 4, name))
    lst = tmp_path / "imgs.lst"
    lst.write_text("\n".join(lines) + "\nbad line\n")
    return str(lst), str(root)


ITER_KW = [dict(), dict(resize=20, rand_crop=True, rand_mirror=True),
           dict(rand_crop=True, brightness=0.2, mean=True, std=True)]


@pytest.mark.parametrize("kw", ITER_KW, ids=["plain", "crop", "jitter"])
def test_image_iter_on_rec_and_lst(tmp_path, kw):
    rec, _ = _encoded_records(tmp_path)
    lst, root = _lst(tmp_path)
    for src in (dict(path_imgrec=rec), dict(path_imglist=lst,
                                            path_root=root)):
        args = dict(batch_size=4, data_shape=(3, 12, 14), shuffle=True,
                    **src, **kw)
        _seed(0)
        t = _epochs(timg.ImageIter(**args))
        _seed(0)
        j = _epochs(jimg.ImageIter(**args))
        _same_epochs(t, j)
    it = timg.ImageIter(4, (3, 12, 14), path_imgrec=rec)
    assert it.provide_data[0].shape == (4, 3, 12, 14)
    assert it.provide_label[0].shape == (4,)
    with pytest.raises(ValueError):
        timg.ImageIter(4, (3, 12, 14))


@pytest.mark.parametrize("flag", [1, 0])
def test_encoded_datasets(tmp_path, flag):
    rec, idx = _encoded_records(tmp_path)
    td, jd = tvision.ImageRecordDataset(rec, flag=flag), \
        jvision.ImageRecordDataset(rec, flag=1)
    assert len(td) == len(jd) == 11
    reader = jrec.MXIndexedRecordIO(idx, rec, "r")
    for i in (0, 5, 10):
        (ti, tl), (ji, jl) = td[i], jd[i]
        # JAX's dataset converts every image BGR -> RGB, which OpenCV
        # refuses for a gray one: flag 0 is held to JAX's unpack_img
        _same(ti, ji if flag else jrec.unpack_img(
            reader.read_idx(i), 0)[1][..., None])
        assert tl == jl
    root = tmp_path / "folder"
    for c, cls in enumerate(("cat", "dog")):
        (root / cls).mkdir(parents=True)
        for k in range(3):
            ext = (".jpg", ".png", ".JPEG")[k]
            cv2.imwrite(str(root / cls / ("x%d%s" % (k, ext))),
                        _picture(15, 17, seed=10 * c + k))
        (root / cls / "notes.txt").write_text("skip")
    (root / "stray.jpg").write_text("not a class folder")
    td = tvision.ImageFolderDataset(str(root), flag=flag)
    jd = jvision.ImageFolderDataset(str(root), flag=flag)
    assert td.synsets == jd.synsets == ["cat", "dog"]
    assert [os.path.basename(p) for p, _ in td.items] == \
        [os.path.basename(p) for p, _ in jd.items]
    for i in range(len(jd)):
        (ti, tl), (ji, jl) = td[i], jd[i]
        _same(ti, ji)
        assert tl == jl
    only_png = tvision.ImageFolderDataset(str(root), exts=(".png",))
    assert len(only_png) == 2


# -- detection ------------------------------------------------------------------

def _det_records(tmp_path, n=10, seed=0):
    rs = np.random.RandomState(seed)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = _picture(40 + i % 3, 48, seed=i)
        k = 1 + i % 3
        boxes = rs.uniform(0, 0.5, (k, 2))
        boxes = np.concatenate([boxes, boxes + rs.uniform(0.2, 0.5, (k, 2))],
                               1).clip(0, 1)
        objs = np.concatenate([rs.randint(0, 3, (k, 1)), boxes], 1)
        label = [2.0, 5.0] + objs.ravel().tolist()
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, label, i, 0), img,
                                     quality=95))
    w.close()
    return rec, idx


DET_KW = [dict(),
          dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
               min_object_covered=0.5, std=np.array([255.0, 255.0, 255.0])),
          dict(resize=50, rand_crop=1, rand_pad=1, rand_gray=0.5,
               brightness=0.2, contrast=0.2, saturation=0.2, pca_noise=0.1,
               hue=0.1, mean=True, std=True, area_range=(0.1, 2.0),
               max_attempts=20)]


@pytest.mark.parametrize("kw", DET_KW, ids=["plain", "ssd", "all"])
def test_image_det_iter(tmp_path, kw):
    rec, idx = _det_records(tmp_path)
    args = dict(batch_size=4, data_shape=(3, 24, 24), path_imgrec=rec,
                path_imgidx=idx, shuffle=True, **kw)
    _seed(2)
    t = timg.ImageDetIter(**args)
    _seed(2)
    j = jimg.ImageDetIter(**args)
    assert t.label_shape == j.label_shape == (3, 5)
    assert t.provide_label[0].shape == (4, 3, 5)
    assert [a.dumps() for a in t.auglist
            if "lighting" not in str(a.dumps())] == \
        [a.dumps() for a in j.auglist if "lighting" not in str(a.dumps())]
    for _ in range(2):
        _seed(3)
        te = _epochs(t, 1)[0]
        _seed(3)
        je = _epochs(j, 1)[0]
        assert len(te) == len(je) == 3
        for (td, tl, tp), (jd, jl, jp) in zip(te, je):
            _same(td, jd)
            _same(tl, jl)
            assert tp == jp


def test_det_augmenters_and_label_shape(tmp_path):
    label = np.array([[0, 0.1, 0.2, 0.5, 0.6], [1, 0.4, 0.3, 0.9, 0.8]],
                     np.float32)
    img = _picture(30, 40, seed=6)
    augs = [("DetHorizontalFlipAug", (0.5,), {}),
            ("DetRandomCropAug", (), dict(min_object_covered=0.3)),
            ("DetRandomPadAug", (), dict(area_range=(1.0, 2.0))),
            ("CreateMultiRandCropAugmenter", (),
             dict(min_object_covered=[0.1, 0.5], area_range=(0.2, 1.0)))]
    for name, args, kw in augs:
        ta, ja = getattr(timg, name)(*args, **kw), getattr(jimg, name)(
            *args, **kw)
        assert ta.dumps() == ja.dumps()
        for s in range(5):
            _seed(s)
            ti, tl = ta(mx.nd.array(img, ctx=mx.cpu()), label)
            _seed(s)
            ji, jl = ja(mxj.nd.array(img), label)
            _same(ti, ji)
            _same(np.asarray(tl), np.asarray(jl))
    borrow = timg.DetBorrowAug(timg.CastAug())
    assert borrow.dumps() == jimg.DetBorrowAug(jimg.CastAug()).dumps()
    with pytest.raises(TypeError):
        timg.DetBorrowAug(lambda x: x)
    with pytest.raises(ValueError):
        timg.CreateMultiRandCropAugmenter(min_object_covered=[0.1, 0.2],
                                          max_attempts=[1, 2, 3])
    rec, idx = _det_records(tmp_path)
    a = timg.ImageDetIter(2, (3, 16, 16), path_imgrec=rec)
    (tmp_path / "b").mkdir()
    rec2, _ = _det_records(tmp_path / "b", n=3)
    b = timg.ImageDetIter(2, (3, 16, 16), path_imgrec=rec2)
    b.label_shape = (5, 6)
    a.sync_label_shape(b)
    assert a.label_shape == b.label_shape == (5, 6)
    assert next(a).label[0].shape == (2, 5, 6)
    with pytest.raises(RuntimeError):
        timg.ImageDetIter._parse_label([2, 5, 0, 0.5, 0.5, 0.1, 0.1])


# -- the nd.image ops -----------------------------------------------------------

def _jax_op(name, data, **kw):
    return np.asarray(jreg.get_op(name).fn(jnp.asarray(data), **kw))


def _port_op(name, data, **kw):
    return treg.get_op(name).fn(torch.from_numpy(np.array(data)),
                                **kw).numpy()


IMAGE_OPS = [
    ("_image_to_tensor", "u8", {}), ("_image_to_tensor", "u8b", {}),
    ("_image_normalize", "chw", dict(mean=(0.4, 0.5, 0.6),
                                     std=(0.2, 0.3, 0.25))),
    ("_image_normalize", "nchw", dict(mean=0.5, std=0.25)),
    ("_image_normalize", "chw", dict(mean=0.5, std=(0.2, 0.3, 0.25))),
    ("_image_flip_left_right", "f32", {}),
    ("_image_flip_top_bottom", "u8b", {}),
    ("_image_resize", "f32", dict(size=(9, 4))),
    ("_image_resize", "f32", dict(size=(40, 30))),
    ("_image_resize", "f32", dict(size=5, keep_ratio=True)),
    ("_image_resize", "f32b", dict(size=(11, 6), interp=0)),
    ("_image_resize", "f32", dict(size=(8, 0), interp=0)),
    ("_image_crop", "f32", dict(x=1, y=2, width=4, height=3)),
    ("_image_crop", "u8b", dict(x=0, y=1, width=5, height=2)),
]


def _image_input(kind, rs):
    u8 = rs.randint(0, 256, (6, 7, 3)).astype(np.uint8)
    return {"u8": u8, "u8b": np.stack([u8, u8[::-1]]),
            "f32": u8.astype(np.float32) / 3.0,
            "f32b": np.stack([u8, u8[:, ::-1]]).astype(np.float32),
            "chw": u8.transpose(2, 0, 1).astype(np.float32) / 255.0,
            "nchw": np.stack([u8, u8]).transpose(0, 3, 1, 2)
            .astype(np.float32) / 255.0}[kind]


@pytest.mark.parametrize("i", range(len(IMAGE_OPS)))
def test_deterministic_image_ops(i):
    name, kind, kw = IMAGE_OPS[i]
    data = _image_input(kind, np.random.RandomState(i))
    got, want = _port_op(name, data, **kw), _jax_op(name, data, **kw)
    assert got.dtype == want.dtype
    _same(got, want)


RANDOM_OPS = {
    "_image_random_brightness": dict(min_factor=0.7, max_factor=0.7),
    "_image_random_contrast": dict(min_factor=0.6, max_factor=0.6),
    "_image_random_saturation": dict(min_factor=1.3, max_factor=1.3),
    "_image_random_hue": dict(min_factor=0.1, max_factor=0.1),
    "_image_random_color_jitter": dict(brightness=0.0, contrast=0.0,
                                       saturation=0.0, hue=0.0),
    "_image_random_flip_left_right": dict(p=1.0),
    "_image_random_flip_top_bottom": dict(p=0.0),
    "_image_random_lighting": dict(alpha_std=0.0),
}


@pytest.mark.parametrize("name", sorted(RANDOM_OPS))
@pytest.mark.parametrize("kind", ["f32", "f32b", "u8"])
def test_random_image_op_at_a_degenerate_range(name, kind):
    data = _image_input(kind, np.random.RandomState(1))
    kw = RANDOM_OPS[name]
    got = _port_op(name, data, **kw)
    want = _jax_op(name, data, key=jax.random.PRNGKey(0), **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "u8" and name not in ("_image_random_flip_left_right",
                                     "_image_random_flip_top_bottom",
                                     "_image_random_color_jitter"):
        # float -> uint8 truncates; a factor's last bit may cross a whole
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        _same(got, want)


def _draws(name, kw, data, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.from_numpy(data)
    fn = treg.get_op(name).fn
    return [fn(x, key=gen, **kw) for _ in range(n)]


def test_random_image_ops_laws_and_seeds():
    data = np.full((2, 3, 3), 100.0, np.float32)
    data[..., 1] = 50.0
    # brightness: out / in = a ~ U(0.5, 1.5)
    a = np.array([float(o[0, 0, 0]) / 100.0 for o in _draws(
        "_image_random_brightness", dict(min_factor=0.5, max_factor=1.5),
        data, 4000)])
    assert a.min() >= 0.5 and a.max() <= 1.5
    assert abs(a.mean() - 1.0) < 0.02 and abs(a.var() - 1 / 12) < 0.01
    # flips: a coin of probability p
    grid = np.arange(18, dtype=np.float32).reshape(2, 3, 3)
    flips = [not np.array_equal(o.numpy(), grid) for o in _draws(
        "_image_random_flip_left_right", dict(p=0.3), grid, 4000)]
    assert abs(np.mean(flips) - 0.3) < 0.03
    # lighting: delta = eigvec @ (N(0, s) * eigval)
    d = np.array([o.numpy()[0, 0] - data[0, 0] for o in _draws(
        "_image_random_lighting", dict(alpha_std=0.1), data, 4000)])
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    cov = eigvec @ np.diag((0.1 * eigval) ** 2) @ eigvec.T
    np.testing.assert_allclose(np.cov(d.T), cov, rtol=0.1, atol=0.05)
    # contrast, saturation, hue: the factor stays in its range
    for name, kw in (("_image_random_contrast", dict(min_factor=0.2,
                                                     max_factor=0.4)),
                     ("_image_random_saturation", dict(min_factor=0.2,
                                                       max_factor=0.4)),
                     ("_image_random_hue", dict(min_factor=-0.2,
                                                max_factor=0.2))):
        lo = _port_op(name, data, min_factor=kw["min_factor"],
                      max_factor=kw["min_factor"])
        hi = _port_op(name, data, min_factor=kw["max_factor"],
                      max_factor=kw["max_factor"])
        for o in _draws(name, kw, data, 50):
            o = o.numpy()
            assert o.shape == data.shape and o.dtype == np.float32
            if name != "_image_random_hue":
                lo_, hi_ = np.minimum(lo, hi), np.maximum(lo, hi)
                assert np.all(o >= lo_ - 1e-3) and np.all(o <= hi_ + 1e-3)
    # seeds: one seed, one stream; the op's default is the device's own
    for name, kw in (("_image_random_color_jitter",
                      dict(brightness=0.3, contrast=0.3, saturation=0.3,
                           hue=0.1)),
                     ("_image_random_lighting", dict(alpha_std=0.1))):
        a = _draws(name, kw, data, 3, seed=5)
        b = _draws(name, kw, data, 3, seed=5)
        c = _draws(name, kw, data, 3, seed=6)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not all(torch.equal(x, y) for x, y in zip(a, c))
        mx.random.seed(11)
        with mx.cpu():
            d1 = mx.nd.image.__dict__[name[len("_image_"):]](
                mx.nd.array(data), **kw).asnumpy()
        mx.random.seed(11)
        with mx.cpu():
            d2 = mx.nd.image.__dict__[name[len("_image_"):]](
                mx.nd.array(data), **kw).asnumpy()
        np.testing.assert_array_equal(d1, d2)
    u8 = _port_op("_image_random_brightness",
                  data.astype(np.uint8), min_factor=0.5, max_factor=0.9)
    assert u8.dtype == np.uint8


def test_transforms_and_ops_share_the_jitters():
    """gluon.data.vision.transforms, mx.image's augmenters and the
    nd.image ops compute each jitter with one function."""
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    from mxnet_tpu_torch.ops import image as OI
    assert T.contrast is OI.contrast and T.saturation is OI.saturation
    assert T.hue_matrix is OI.hue_matrix and timg.contrast is OI.contrast
    img = _picture(5, 6).astype(np.float32)
    np.testing.assert_allclose(OI.contrast(torch.from_numpy(img), 0.7)
                               .numpy(), OI.contrast(img, 0.7), rtol=1e-6)


# -- import hygiene and the missing-decoder path ---------------------------------

def _run(code):
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stdout[-2000:] + r.stderr[-2000:]


def test_import_loads_no_cv2_jax_or_jax_package():
    _run("import sys, mxnet_tpu_torch as mx\n"
         "mx.image.ImageDetIter; mx.nd.image.resize\n"
         "bad = [m for m in ('cv2', 'jax', 'mxnet_tpu') if m in sys.modules]\n"
         "assert not bad, bad\n"
         "print('ok')\n")


def test_no_port_module_imports_example():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) else []
            for m in mods:
                assert not m.split(".")[0] in ("example", "mxnet_tpu",
                                               "jax"), (path, m)
        assert "example/ssd" not in open(path).read() or \
            path.endswith("chip_smoke.py"), path


def test_missing_cv2_raises_naming_it():
    _run("import sys; sys.modules['cv2'] = None\n"
         "import numpy as np, mxnet_tpu_torch as mx\n"
         "from mxnet_tpu_torch import recordio as R\n"
         "img = np.zeros((4, 5, 3), np.uint8)\n"
         "raw = R.pack_img(R.IRHeader(0, 1.0, 0, 0), img, img_fmt='.raw')\n"
         "assert R.unpack_img(raw)[1].shape == (4, 5, 3)\n"
         "for call in (lambda: R.pack_img(R.IRHeader(0, 1.0, 0, 0), img),\n"
         "             lambda: mx.image.imdecode(b'abc'),\n"
         "             lambda: mx.image.imresize(img, 3, 3)):\n"
         "    try:\n"
         "        call()\n"
         "    except ImportError as e:\n"
         "        assert 'cv2' in str(e), e\n"
         "    else:\n"
         "        raise AssertionError('no ImportError')\n"
         "print('ok')\n")
