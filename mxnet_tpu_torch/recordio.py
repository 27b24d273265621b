"""RecordIO: the dmlc record file format (counterpart of
mxnet_tpu/recordio.py), in Python over ``struct`` and numpy. Files are
byte for byte those of the JAX package and of MXNet. Each record is

    uint32 magic = 0xced7230a
    uint32 lrec  = cflag << 29 | length      (cflag: 0 whole, 1/2/3 split)
    data[length], zero-padded to a 4-byte boundary

A payload that holds the magic word at a 4-byte-aligned offset is written
split there, as dmlc's writer does: the word is dropped, the parts carry
cflag 1 (first), 2 (middle) and 3 (last), and the reader puts the word
back between them.

Images: ``pack_raw_img`` / ``decode_raw_img`` store and read pre-decoded
uint8 HWC (BGR) pixels behind the ``RAWP`` magic, which needs no decoder.
``pack_img`` and ``unpack_img`` encode and decode JPEG and PNG through
OpenCV (``base.cv2``, imported at the first call), as the JAX package
does, so a record's bytes and pixels are that package's on the same
OpenCV build.
``ThreadedRecordReader`` (the JAX package's C++ reader thread behind its
native library) is not ported.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as np

from .base import cv2 as _cv2

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "pack_raw_img", "decode_raw_img",
           "RAW_MAGIC"]

_kMagic = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", _kMagic)
_LREC_KIND_BITS = 29
_LREC_LEN_MASK = (1 << _LREC_KIND_BITS) - 1

def _split_points(buf):
    """Offsets of the magic word at 4-byte-aligned positions of ``buf``."""
    out = []
    i = buf.find(_MAGIC_BYTES)
    while i >= 0:
        if i % 4 == 0:
            out.append(i)
            i = buf.find(_MAGIC_BYTES, i + 4)
        else:
            i = buf.find(_MAGIC_BYTES, i + 1)
    return out


class MXRecordIO:
    """Sequential .rec reader (``flag="r"``) or writer (``"w"``). The
    object pickles (a reader reopens where it is unpickled) and reopens its
    file in a forked child."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.writable = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.writable = True
        elif self.flag == "r":
            self.writable = False
        else:
            raise ValueError("invalid flag %s" % self.flag)
        self.handle = open(self.uri, "wb" if self.writable else "rb")
        self.pid = os.getpid()

    def close(self):
        if self.handle is not None:
            self.handle.close()
            self.handle = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.flag = "w" if self.writable else "r"
        self.open()

    def _check_pid(self):
        if self.handle is None:
            raise ValueError("I/O operation on closed RecordIO file")
        if self.pid != os.getpid():
            self.open()

    def reset(self):
        self.close()
        self.open()

    def seek_pos(self, pos):
        """Seek a reader to byte offset ``pos``."""
        if self.writable:
            raise ValueError("seek_pos on a RecordIO writer")
        self._check_pid()
        self.handle.seek(pos)

    def tell(self):
        return self.handle.tell()

    def _write_chunk(self, data, cflag):
        n = len(data)
        if n > _LREC_LEN_MASK:
            raise IOError("RecordIO chunk exceeds 2^29-1 bytes")
        self.handle.write(struct.pack("<II", _kMagic,
                                      (cflag << _LREC_KIND_BITS) | n))
        self.handle.write(data)
        pad = (4 - n % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def write(self, buf):
        if not self.writable:
            raise ValueError("write on a RecordIO reader")
        self._check_pid()
        buf = bytes(buf)
        splits = _split_points(buf)
        if not splits:
            self._write_chunk(buf, 0)
            return
        begin = 0
        for k, at in enumerate(splits):
            self._write_chunk(buf[begin:at], 1 if k == 0 else 2)
            begin = at + 4                  # the dropped magic word
        self._write_chunk(buf[begin:], 3)

    def read(self):
        """The next record's bytes, or None at the end of the file."""
        if self.writable:
            raise ValueError("read on a RecordIO writer")
        self._check_pid()
        parts = []
        while True:
            head = self.handle.read(8)
            if len(head) < 8:
                if parts:
                    raise IOError("truncated split RecordIO record")
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _kMagic:
                raise IOError("invalid RecordIO magic at offset %d"
                              % (self.handle.tell() - 8))
            cflag = lrec >> _LREC_KIND_BITS
            length = lrec & _LREC_LEN_MASK
            data = self.handle.read(length)
            if len(data) < length:
                raise IOError("truncated RecordIO record")
            pad = (4 - length % 4) % 4
            if pad:
                self.handle.read(pad)
            if parts:
                parts.append(_MAGIC_BYTES)
            parts.append(data)
            if cflag in (0, 3):
                return b"".join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """A .rec with a .idx sidecar ("<key>\\t<byte offset>\\n" per record)
    for random access by key."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            self.fidx = open(self.idx_path, "w")
            return
        self.fidx = None
        with open(self.idx_path) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) != 2:
                    continue
                key = self.key_type(parts[0])
                self.idx[key] = int(parts[1])
                self.keys.append(key)

    def close(self):
        super().close()
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def __getstate__(self):
        d = super().__getstate__()
        d["fidx"] = None
        return d

    def seek(self, idx):
        self.seek_pos(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


# the header of a packed image record; flag > 0 means ``label`` is a float
# array of that length stored after the fixed header
IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """A record payload from an IRHeader (a scalar or array label) and
    bytes."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        header = header._replace(label=float(header.label))
        return struct.pack(_IR_FORMAT, *header) + s
    label = np.asarray(header.label, dtype=np.float32)
    header = header._replace(flag=label.size, label=0.0)
    return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s


def unpack(s):
    """(IRHeader, payload bytes) of a record; an array label comes back as
    float32."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


# Raw-pixel payload: the magic, u16 height, u16 width, u8 channels, then
# H*W*C uint8 pixels in HWC BGR order (OpenCV's channel order). JPEG
# streams begin FF D8 and PNG \x89PNG, so the magic cannot collide.
RAW_MAGIC = b"RAWP"
_RAW_DIMS = struct.Struct("<HHB")


def pack_raw_img(header, img):
    """A record payload holding a uint8 HWC image uncompressed."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3:
        raise ValueError("pack_raw_img wants HWC uint8, got shape %s"
                         % (img.shape,))
    h, w, c = img.shape
    return pack(header, RAW_MAGIC + _RAW_DIMS.pack(h, w, c) + img.tobytes())


def decode_raw_img(img_bytes):
    """The uint8 HWC view behind a raw payload (read-only: it shares the
    bytes), or None if the payload is not raw."""
    if not img_bytes.startswith(RAW_MAGIC):
        return None
    off = len(RAW_MAGIC)
    h, w, c = _RAW_DIMS.unpack_from(img_bytes, off)
    return np.frombuffer(img_bytes, np.uint8, count=h * w * c,
                         offset=off + _RAW_DIMS.size).reshape(h, w, c)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image: ``img_fmt=".raw"`` stores its pixels, any other
    format is ``cv2.imencode``'s (JPEG at ``quality``; PNG at compression
    level ``quality``)."""
    if img_fmt == ".raw":
        return pack_raw_img(header, img)
    cv2 = _cv2()
    if img_fmt in (".jpg", ".jpeg"):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    else:
        params = None
    ok, buf = cv2.imencode(img_fmt, img, params)
    if not ok:
        raise IOError("cv2.imencode(%r) failed" % (img_fmt,))
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=1):
    """(IRHeader, BGR uint8 image) of a record, writable; ``iscolor`` is
    ``cv2.imdecode``'s flag (1 colour, 0 2-D gray, -1 as stored). A
    raw-pixel record needs OpenCV only for ``iscolor=0``."""
    header, s = unpack(s)
    raw = decode_raw_img(s)
    if raw is not None:
        if iscolor == 0:
            return header, _cv2().cvtColor(raw, _cv2().COLOR_BGR2GRAY)
        return header, raw.copy()
    return header, _cv2().imdecode(np.frombuffer(s, np.uint8), iscolor)
