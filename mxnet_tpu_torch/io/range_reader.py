"""RecordIO over a range-read primitive: the object-storage reader
(counterpart of mxnet_tpu/io/range_reader.py).

``MXRecordIO`` assumes a seekable local file handle; an object store offers
only *ranged GETs* that can fail transiently and can return corrupt bytes.
:class:`RecordIORangeReader` reads the same dmlc-recordio byte format
through a pluggable ``fetch(offset, nbytes) -> bytes`` primitive and
hardens both failure modes:

- **transient read failure**: every fetch attempt runs under the unified
  ``_retry`` policy (exponential backoff + jitter + deadline, the
  ``MXTPU_PS_RETRY_*`` knobs), counted ``io.read_retries``; the
  ``io.shard.read`` fault point fires per attempt, exactly where a dropped
  connection would surface.
- **corrupt record**: every record is validated (magic word, whole cflag,
  sane length, full payload, optional crc32 sidecar) before it is
  returned. A corrupt record raises :class:`CorruptRecordError` from
  :meth:`read_record`; the skip-and-count form :meth:`read` swallows it,
  counts ``io.corrupt_records`` and returns ``None`` -- until the
  per-reader budget (``MXTPU_IO_CORRUPT_BUDGET``, default 8) is exhausted,
  when corruption becomes a hard error. The ``io.record.corrupt`` fault
  point is woven INTO the validation seam, so injected chaos is handled
  exactly as real bit rot.

Checksums: dmlc recordio has no payload checksum, so the write side grows
one as a sidecar -- :func:`build_crc_sidecar` walks a .rec file and writes
``<uri>.crc`` (``offset\\tcrc32`` per record, published via temp+rename).
When the sidecar exists the reader validates every payload against it;
without it, validation is structural only (magic/length/truncation).
"""
from __future__ import annotations

import os
import struct
import zlib

from .. import _retry
from ..base import atomic_write
from .._debug import faultpoint as _faultpoint
from .._debug import locktrace as _locktrace
from . import _stats
from ..base import getenv as _getenv

__all__ = ["RecordIORangeReader", "CorruptRecordError",
           "build_crc_sidecar"]

_kMagic = 0xced7230a
_HEAD = struct.Struct("<II")
_LREC_KIND_BITS = 29
_LREC_LEN_MASK = (1 << _LREC_KIND_BITS) - 1


class CorruptRecordError(RuntimeError):
    """A record failed validation (bad magic, truncated payload, crc
    mismatch, or an injected ``io.record.corrupt`` fault). Deliberately
    NOT an ``OSError`` subclass: corruption is a *data* verdict and
    must never enter the transient-retry set -- refetching corrupt
    bytes returns the same corrupt bytes."""


def _corrupt_budget():
    return int(_getenv("MXTPU_IO_CORRUPT_BUDGET", "8"))


class RecordIORangeReader:
    """Random-access recordio reads over ``fetch(offset, nbytes)``.

    Parameters
    ----------
    uri : str, optional
        Local file path (the default fetch is ``os.pread`` over it --
        the test/bench stand-in for a ranged GET).
    fetch : callable(offset, nbytes) -> bytes, optional
        The object-storage primitive; may return fewer bytes at EOF
        and may raise ``ConnectionError``/``OSError``/``TimeoutError``
        transiently (retried under ``retry_policy``).
    index : sequence of int, or path to a ``.idx`` sidecar, optional
        Record byte offsets. When omitted, the file is scanned once
        through ``fetch`` (header-hopping, no payload reads).
    crc_path : str, optional
        Checksum sidecar (default ``<uri>.crc`` when it exists).
    corrupt_budget : int, optional
        Corrupt records to skip-and-count before :meth:`read` trips to
        a hard error. Default ``MXTPU_IO_CORRUPT_BUDGET`` (8).
    retry_policy : `_retry.RetryPolicy`, optional
        Backoff budget for transient fetch failures.
    """

    def __init__(self, uri=None, fetch=None, index=None, crc_path=None,
                 corrupt_budget=None, retry_policy=None):
        if fetch is None and uri is None:
            raise ValueError("RecordIORangeReader needs a uri or a "
                             "fetch(offset, nbytes) callable")
        self.uri = uri
        self._fd = None
        if fetch is None:
            self._fd = os.open(uri, os.O_RDONLY)

            def fetch(offset, nbytes):
                return os.pread(self._fd, nbytes, offset)
        self._fetch = fetch
        self._policy = retry_policy or _retry.RetryPolicy()
        self._budget = _corrupt_budget() if corrupt_budget is None \
            else int(corrupt_budget)
        # one reader is shared across DecodePool workers
        # (ShardService.iter_batches): the budget's read-modify-write
        # must not race, or two threads can both observe budget-1 and
        # sail past the documented hard-trip threshold
        self._corrupt = 0
        self._corrupt_lock = _locktrace.named_lock("io.range_reader")
        if isinstance(index, str):
            offsets = []
            with open(index) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        offsets.append(int(parts[1]))
            self._offsets = offsets
        elif index is not None:
            self._offsets = [int(o) for o in index]
        else:
            self._offsets = self._scan_offsets()
        self._crcs = None
        if crc_path is None and uri is not None \
                and os.path.exists(uri + ".crc"):
            crc_path = uri + ".crc"
        if crc_path is not None:
            self._crcs = {}
            with open(crc_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        self._crcs[int(parts[0])] = int(parts[1])

    # -- transport ----------------------------------------------------------
    def _fetch_retry(self, offset, nbytes):
        """One ranged read under the unified retry policy; the
        ``io.shard.read`` faultpoint fires per ATTEMPT (like
        ``kvstore.send``), so chaos exercises the backoff loop."""

        def attempt():
            if _faultpoint.ACTIVE:
                _faultpoint.check("io.shard.read")
            return self._fetch(offset, nbytes)

        def on_retry(n, exc, delay):
            _stats.bump("read_retries")

        return _retry.call(
            attempt, retryable=(ConnectionError, OSError, TimeoutError),
            policy=self._policy, on_retry=on_retry)

    def _scan_offsets(self):
        """Header-hop the file once: offsets of every record without
        reading payloads (the index build for index-less uris)."""
        offsets, off = [], 0
        while True:
            head = self._fetch_retry(off, _HEAD.size)
            if len(head) < _HEAD.size:
                return offsets
            magic, lrec = _HEAD.unpack(head)
            if magic != _kMagic:
                raise CorruptRecordError(
                    "bad RecordIO magic 0x%08x at offset %d while "
                    "scanning %r" % (magic, off, self.uri))
            length = lrec & _LREC_LEN_MASK
            offsets.append(off)
            off += _HEAD.size + length + (4 - length % 4) % 4

    # -- records ------------------------------------------------------------
    def __len__(self):
        return len(self._offsets)

    @property
    def corrupt_skipped(self):
        return self._corrupt

    def read_record(self, i):
        """Record ``i``'s payload bytes, fully validated. Raises
        :class:`CorruptRecordError` on any validation failure --
        callers that prefer skip-and-count use :meth:`read`."""
        off = self._offsets[i]
        head = self._fetch_retry(off, _HEAD.size)
        if len(head) < _HEAD.size:
            raise CorruptRecordError(
                "truncated header at offset %d (record %d)" % (off, i))
        magic, lrec = _HEAD.unpack(head)
        if magic != _kMagic:
            raise CorruptRecordError(
                "bad magic 0x%08x at offset %d (record %d)"
                % (magic, off, i))
        cflag = lrec >> _LREC_KIND_BITS
        if cflag != 0:
            # range reads address records independently; dmlc split
            # records (payload contained the magic word) would need the
            # writer-side split protocol -- our writers write whole
            raise CorruptRecordError(
                "split record (cflag=%d) at offset %d -- the range "
                "reader only addresses whole records" % (cflag, off))
        length = lrec & _LREC_LEN_MASK
        payload = self._fetch_retry(off + _HEAD.size, length)
        if len(payload) < length:
            raise CorruptRecordError(
                "truncated payload at offset %d: wanted %d got %d"
                % (off, length, len(payload)))
        if _faultpoint.ACTIVE:
            # woven INTO the validation seam: an injected raise here is
            # handled exactly like real bit rot (skip-and-count budget)
            try:
                _faultpoint.check("io.record.corrupt")
            except Exception as e:
                raise CorruptRecordError(
                    "injected corrupt record %d: %s" % (i, e))
        if self._crcs is not None:
            want = self._crcs.get(off)
            got = zlib.crc32(payload) & 0xffffffff
            if want is not None and got != want:
                raise CorruptRecordError(
                    "crc mismatch at offset %d (record %d): sidecar "
                    "%08x, payload %08x" % (off, i, want, got))
        return payload

    def read(self, i):
        """Skip-and-count form: a corrupt record returns ``None`` (the
        caller drops the sample) and counts ``io.corrupt_records`` --
        until the budget trips, after which the error is hard: past
        ``MXTPU_IO_CORRUPT_BUDGET`` corruptions this store is broken,
        not noisy."""
        try:
            return self.read_record(i)
        except CorruptRecordError as e:
            with self._corrupt_lock:
                self._corrupt += 1
                tripped = self._corrupt > self._budget
                count = self._corrupt
            _stats.bump("corrupt_records")
            if tripped:
                raise CorruptRecordError(
                    "corrupt-record budget exhausted: %d corrupt "
                    "records > MXTPU_IO_CORRUPT_BUDGET=%d (last: %s)"
                    % (count, self._budget, e))
            return None

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # mxlint: disable=MX009 (interpreter teardown -- os may already be gone)
            pass


def build_crc_sidecar(rec_path, out_path=None):
    """Walk ``rec_path`` and publish ``<rec_path>.crc`` -- one
    ``offset\\tcrc32`` line per record, written through the temp+rename
    contract so a crash mid-build never leaves a half sidecar that
    silently validates only a prefix. Returns the sidecar path."""
    out_path = out_path or rec_path + ".crc"
    lines = []
    with open(rec_path, "rb") as f:
        off = 0
        while True:
            head = f.read(_HEAD.size)
            if len(head) < _HEAD.size:
                break
            magic, lrec = _HEAD.unpack(head)
            if magic != _kMagic:
                raise IOError("bad RecordIO magic at offset %d in %r"
                              % (off, rec_path))
            length = lrec & _LREC_LEN_MASK
            payload = f.read(length)
            if len(payload) < length:
                raise IOError("truncated record at offset %d in %r"
                              % (off, rec_path))
            f.read((4 - length % 4) % 4)
            lines.append("%d\t%d" % (off, zlib.crc32(payload)
                                     & 0xffffffff))
            off += _HEAD.size + length + (4 - length % 4) % 4
    with atomic_write(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out_path
