"""The port's RecordIO (mxnet_tpu_torch/recordio.py) and record datasets
against the JAX package's: files written by either package are read by
both, byte for byte, sequentially and by index; split records (a payload
holding the magic word is written in parts, as dmlc's writer does); array
labels; raw-pixel images; and ``RecordFileDataset`` /
``ImageRecordDataset`` item for item. The JAX package writes through its
native library where it is built (which splits records as dmlc's writer
does), and in Python otherwise (which writes every record whole, so only
payloads without the magic word give the same bytes there).
"""
import pickle
import sys
import struct

import numpy as np
import pytest

from mxnet_tpu import _native
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon import data as jdata
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.gluon import data as tdata

MAGIC = struct.pack("<I", 0xced7230a)


def _payloads():
    rs = np.random.RandomState(0)
    return [b"", b"a", b"abcd" * 3, b"AAAA" + MAGIC + b"BBBB", MAGIC,
            b"x" + MAGIC + b"yyy", MAGIC + MAGIC + b"zz" + MAGIC,
            b"abc" + MAGIC + b"d" + MAGIC, rs.bytes(1001), rs.bytes(4096)]


def _write(mod, path, payloads, indexed=True):
    if indexed:
        w = mod.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
        for i, p in enumerate(payloads):
            w.write_idx(i, p)
    else:
        w = mod.MXRecordIO(path + ".rec", "w")
        for p in payloads:
            w.write(p)
    w.close()


def _read_seq(mod, path):
    r = mod.MXRecordIO(path + ".rec", "r")
    out = []
    while True:
        rec = r.read()
        if rec is None:
            break
        out.append(rec)
    r.close()
    return out


@pytest.mark.parametrize("indexed", [True, False])
def test_files_equal_and_read_both_ways(tmp_path, indexed):
    payloads = _payloads()
    if not _native.native_available():
        payloads = [p for p in payloads if MAGIC not in p]
    paths = {"jax": str(tmp_path / "j"), "port": str(tmp_path / "t")}
    _write(jrec, paths["jax"], payloads, indexed)
    _write(trec, paths["port"], payloads, indexed)
    with open(paths["jax"] + ".rec", "rb") as a, \
            open(paths["port"] + ".rec", "rb") as b:
        assert a.read() == b.read()
    if indexed:
        with open(paths["jax"] + ".idx") as a, \
                open(paths["port"] + ".idx") as b:
            assert a.read() == b.read()
    for mod in (jrec, trec):
        for path in paths.values():
            assert _read_seq(mod, path) == payloads
            if indexed:
                r = mod.MXIndexedRecordIO(path + ".idx", path + ".rec", "r")
                assert r.keys == list(range(len(payloads)))
                for i in (len(payloads) - 1, 0, 3, 2, 3):
                    assert r.read_idx(i) == payloads[i]
                r.seek(4)
                assert r.read() == payloads[4]
                r.close()


def test_split_records_rejoin_as_written(tmp_path):
    """A payload holding the magic word at 4-byte-aligned offsets is
    written in parts (cflag 1, 2, 3) with the word dropped; unaligned
    occurrences stay inside a part."""
    path = str(tmp_path / "s.rec")
    payload = b"AAAA" + MAGIC + b"BBBBCC" + MAGIC + b"D"
    w = trec.MXRecordIO(path, "w")
    w.write(payload)
    w.close()
    with open(path, "rb") as f:
        raw = f.read()
    words = struct.unpack("<%dI" % (len(raw) // 4), raw)
    kinds = [words[i + 1] >> 29 for i in (0, 3)]
    assert kinds == [1, 3]
    assert jrec.MXRecordIO(path, "r").read() == payload
    assert trec.MXRecordIO(path, "r").read() == payload
    # a dmlc file split in three parts, read by the port
    path3 = str(tmp_path / "s3.rec")
    with open(path3, "wb") as f:
        for cflag, part in ((1, b"AAAA"), (2, b"BB"), (3, b"CCC")):
            f.write(struct.pack("<II", 0xced7230a, (cflag << 29) | len(part)))
            f.write(part + b"\x00" * ((4 - len(part) % 4) % 4))
    assert trec.MXRecordIO(path3, "r").read() == \
        b"AAAA" + MAGIC + b"BB" + MAGIC + b"CCC"


def test_truncated_split_record_raises(tmp_path):
    path = str(tmp_path / "t.rec")
    with open(path, "wb") as f:
        f.write(struct.pack("<II", 0xced7230a, (1 << 29) | 4) + b"AAAA")
    with pytest.raises(IOError):
        trec.MXRecordIO(path, "r").read()


@pytest.mark.parametrize("label", [3.0, 7, [1.5, 2.5, -1.0],
                                   np.arange(4, dtype=np.float32)])
def test_pack_unpack_match(label):
    header = (0, label, 11, 0)
    body = b"payload bytes"
    assert trec.pack(header, body) == jrec.pack(header, body)
    th, tb = trec.unpack(jrec.pack(header, body))
    jh, jb = jrec.unpack(trec.pack(header, body))
    assert tb == jb == body
    assert th.flag == jh.flag and th.id == jh.id and th.id2 == jh.id2
    np.testing.assert_array_equal(np.asarray(th.label),
                                  np.asarray(jh.label))


def test_raw_images_and_gray():
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (9, 7, 3)).astype(np.uint8)
    header = jrec.IRHeader(0, 4.0, 2, 0)
    s = trec.pack_raw_img(header, img)
    assert s == jrec.pack_raw_img(header, img)
    assert trec.pack_img(header, img, img_fmt=".raw") == s
    np.testing.assert_array_equal(trec.decode_raw_img(trec.unpack(s)[1]),
                                  img)
    assert trec.decode_raw_img(b"\xff\xd8 not raw") is None
    for flag in (1, 0):
        th, timg = trec.unpack_img(s, flag)
        jh, jimg = jrec.unpack_img(s, flag)
        assert th.label == jh.label
        np.testing.assert_array_equal(timg, jimg)
        assert timg.flags.writeable


def test_encoded_images_raise_naming_the_decoder(monkeypatch):
    """JPEG and PNG go through OpenCV (bytes against JAX's:
    test_torch_image.py); without cv2 they raise ImportError naming it,
    while raw pixels need no decoder."""
    header = trec.IRHeader(0, 1.0, 0, 0)
    img = np.zeros((4, 4, 3), np.uint8)
    jpeg = trec.pack_img(header, img)
    assert jpeg == jrec.pack_img(header, img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        trec.pack_img(header, img)
    with pytest.raises(ImportError, match="cv2"):
        trec.unpack_img(jpeg)
    raw = trec.pack_img(header, img, img_fmt=".raw")
    np.testing.assert_array_equal(trec.unpack_img(raw)[1], img)


def test_pickle_and_closed_file(tmp_path):
    path = str(tmp_path / "p")
    _write(trec, path, [b"one", b"two"])
    r = trec.MXIndexedRecordIO(path + ".idx", path + ".rec", "r")
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.read_idx(1) == b"two" and r2.keys == [0, 1]
    r.close()
    with pytest.raises(ValueError):
        r.read()


def test_pid_check_reopens(tmp_path):
    """A reader used in another process (after a fork) reopens its file."""
    path = str(tmp_path / "f")
    _write(trec, path, [b"first", b"second"])
    r = trec.MXRecordIO(path + ".rec", "r")
    assert r.read() == b"first"
    r.pid = -1              # as in a forked child
    assert r.read() == b"first"


def _image_file(mod, path, n=6, seed=0):
    rs = np.random.RandomState(seed)
    imgs = []
    w = mod.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i in range(n):
        img = rs.randint(0, 256, (5 + i, 4 + i, 3)).astype(np.uint8)
        label = float(i % 3) if i % 2 else [float(i), 0.5]
        w.write_idx(i, mod.pack_raw_img(mod.IRHeader(0, label, i, 0), img))
        imgs.append(img)
    w.close()
    return imgs


def test_record_file_dataset_matches_jax(tmp_path):
    path = str(tmp_path / "d")
    _image_file(jrec, path)
    td = tdata.RecordFileDataset(path + ".rec")
    jd = jdata.RecordFileDataset(path + ".rec")
    assert len(td) == len(jd) == 6
    for i in range(6):
        assert td[i] == jd[i]


def test_image_record_dataset_matches_jax(tmp_path):
    from mxnet_tpu.gluon.data import vision as jv
    path = str(tmp_path / "i")
    imgs = _image_file(trec, path)
    td = tdata.vision.ImageRecordDataset(path + ".rec")
    jd = jv.ImageRecordDataset(path + ".rec")
    assert len(td) == len(jd) == len(imgs)
    for i in range(len(imgs)):
        (tx, tl), (jx, jl) = td[i], jd[i]
        assert tx.context == mx.cpu()
        np.testing.assert_array_equal(tx.asnumpy(), jx.asnumpy())
        np.testing.assert_array_equal(tx.asnumpy(), imgs[i][..., ::-1])
        np.testing.assert_array_equal(np.asarray(tl), np.asarray(jl))
    tt = tdata.vision.ImageRecordDataset(path + ".rec",
                                         transform=lambda x, y: (x, y * 2))
    assert np.all(np.asarray(tt[1][1]) == 2 * np.asarray(td[1][1]))
    gray = tdata.vision.ImageRecordDataset(path + ".rec", flag=0)[2][0]
    assert gray.shape == imgs[2].shape[:2] + (1,)
