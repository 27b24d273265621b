"""Fault-tolerant sharded streaming input service (counterpart of
mxnet_tpu/io/shard_service.py).

An input pipeline feeding a preemption-tolerant trainer must itself
survive worker crashes, corrupt records and elastic resizes without
breaking epoch determinism. The design splits into pure math and thin
state (the tf.data-service idea: the "distributed epoch" is a function,
not a conversation).

**Pure assignment math** (free functions: survivors agree without
talking, because every input is committed state or a constant):

- :func:`epoch_order`: THE global sample sequence for ``(seed, epoch)``,
  a numpy permutation, identical at every world size and element for
  element the JAX package's.
- :func:`assign_shards` / :func:`reassign_shards`: which contiguous
  slices ("shards") of that sequence each live rank streams; round-robin
  over the *sorted* live world, rotated by epoch. After a rank dies,
  every survivor computes the same reassignment of the dead rank's
  **unconsumed** shards from ``(epoch, survivors, committed offset)``.
- :func:`batch_slices`: the per-step split of a global batch
  ``[offset, offset+B)`` over the live world (contiguous, in sorted rank
  order: ``parallel.elastic.shard_for_rank``).

**Committed sample cursor**: ``(epoch, offset)``, how far the global
sequence has been consumed, is published through
``parallel.elastic.CheckpointManager`` and inherits its crash-consistency
contract (temp+rename publication, truncated-pickle probes,
walk-past-corrupt restore). Restore + replay from the cursor is bit for
bit an uninterrupted run, because the sequence never depended on who was
alive.

**The service object** composes these with the hardened io plane:
:class:`~mxnet_tpu_torch.io.range_reader.RecordIORangeReader` for the
bytes (retry + corrupt budget) and
:class:`~mxnet_tpu_torch.io.worker_pool.DecodePool` for decode
(restart-or-die x N). :meth:`ShardService.resize` takes the new world
after a reshard; the elastic training loop that calls it comes with the
multi-GPU slice (ROADMAP M10).

Fault points woven here: ``io.service.fetch`` (the service RPC seam); the
reader and pool carry ``io.shard.read`` / ``io.record.corrupt`` /
``io.worker.decode``. Accounting: ``profiler.metrics()['io']``.
"""
from __future__ import annotations

import os

import numpy as np

from .. import profiler as _profiler
from .._debug import faultpoint as _faultpoint
from .._debug import flightrec as _flightrec
from . import _stats
from .worker_pool import DecodePool
from ..base import getenv as _getenv

__all__ = ["epoch_order", "num_shards", "shard_positions",
           "assign_shards", "reassign_shards", "unconsumed_shards",
           "batch_slices", "ShardService"]


# -- pure assignment math ----------------------------------------------------

def epoch_order(n_samples, epoch, seed=0):
    """THE global sample sequence for ``(seed, epoch)`` -- a permutation
    of ``range(n_samples)`` that depends on NOTHING else. Identical at
    every world size, before and after any reshard: elasticity changes
    who fetches a sample, never which sample comes next."""
    n = int(n_samples)
    # fold (seed, epoch) into one 32-bit stream key; RandomState's
    # MT19937 permutation is platform-stable, so every host computes
    # the identical order without communicating
    key = (int(seed) * 1000003 + int(epoch) * 7919) % (2 ** 32)
    return np.random.RandomState(key).permutation(n)


def num_shards(n_samples, shard_size):
    """Shards per epoch: contiguous ``shard_size`` slices of the
    global sequence (last one ragged)."""
    if shard_size <= 0:
        raise ValueError("shard_size must be positive, got %r"
                         % (shard_size,))
    return -(-int(n_samples) // int(shard_size))


def shard_positions(shard, n_samples, shard_size):
    """Global positions (indices INTO the epoch order) shard ``shard``
    covers: ``range(lo, hi)``."""
    lo = int(shard) * int(shard_size)
    hi = min(lo + int(shard_size), int(n_samples))
    return range(lo, hi)


def assign_shards(epoch, world, rank, n_shards, seed=0):
    """Shard ids ``rank`` owns for ``epoch`` -- a pure function of its
    arguments, so survivors agree without talking. Round-robin in
    shard order over the SORTED live world, rotated by ``(epoch,
    seed)`` so the rank↔shard pairing rebalances across epochs."""
    world = sorted(int(r) for r in world)
    if int(rank) not in world:
        raise ValueError("rank %r not in world %s" % (rank, world))
    idx = world.index(int(rank))
    n = len(world)
    rot = (int(epoch) + int(seed)) % n
    return tuple(s for s in range(int(n_shards))
                 if (s + rot) % n == idx)


def reassign_shards(epoch, world, rank, shards, seed=0):
    """Deterministically redistribute an explicit shard set (the
    *unconsumed* shards at reshard time) over a new live world. Same
    round-robin discipline as :func:`assign_shards`, applied to the
    sorted survivor list and the sorted shard list -- every survivor
    computes the identical split from committed state alone."""
    world = sorted(int(r) for r in world)
    if int(rank) not in world:
        raise ValueError("rank %r not in world %s" % (rank, world))
    idx = world.index(int(rank))
    n = len(world)
    rot = (int(epoch) + int(seed)) % n
    return tuple(s for i, s in enumerate(sorted(int(x) for x in shards))
                 if (i + rot) % n == idx)


def unconsumed_shards(offset, n_samples, shard_size):
    """Shard ids with at least one position >= ``offset`` (the
    committed cursor) -- what a reshard must redistribute."""
    ns = num_shards(n_samples, shard_size)
    first = min(int(offset) // int(shard_size), ns)
    return tuple(range(first, ns))


def batch_slices(offset, batch_size, world):
    """Per-rank slices of the global batch ``[offset, offset+B)`` --
    contiguous split in SORTED rank order (the fixed reduction-order
    convention), ragged remainder to the lowest ranks. Returns
    ``{rank: range(lo, hi)}`` of global positions. Delegates to
    ``parallel.elastic.shard_for_rank`` so there is exactly ONE copy of
    the partition convention (the reduction order of the multi-GPU
    slice's host gradient reducer)."""
    from ..parallel.elastic import shard_for_rank
    off = int(offset)
    out = {}
    for r in sorted(int(x) for x in world):
        s = shard_for_rank(int(batch_size), world, r)
        out[r] = range(off + s.start, off + s.stop)
    return out


# -- the service -------------------------------------------------------------

class ShardService:
    """Per-rank view of the sharded streaming input service.

    Parameters
    ----------
    n_samples : int
        Epoch size (records in the dataset).
    shard_size : int, default ``MXTPU_IO_SHARD_SIZE`` (64)
        Samples per shard -- the unit of reassignment on a resize.
    seed : int -- shuffle seed (part of the pure sequence key).
    world, rank : the committed live world and this process's rank.
    reader : optional ``RecordIORangeReader``-like with ``read(i)``
        (skip-and-count: ``None`` for a corrupt record).
    decode_fn : optional callable(payload) -> sample, run in the
        decode pool by :meth:`iter_batches`.
    cursor_dir : optional directory for the committed sample cursor
        (a ``parallel.elastic.CheckpointManager`` store: the temp+rename
        contract). Without it the cursor is process-local only (tests,
        single-host runs).
    """

    def __init__(self, n_samples, shard_size=None, seed=0, world=(0,),
                 rank=0, reader=None, decode_fn=None, cursor_dir=None,
                 keep=3):
        self.n_samples = int(n_samples)
        if shard_size is None:
            shard_size = int(_getenv("MXTPU_IO_SHARD_SIZE",
                                            "64") or 64)
        self.shard_size = int(shard_size)
        self.seed = int(seed)
        self.rank = int(rank)
        self.world = sorted(int(r) for r in world)
        self.reader = reader
        self.decode_fn = decode_fn
        self.epoch = 0
        self.offset = 0  # committed global positions consumed
        self._ckpt = None
        if cursor_dir is not None:
            from ..parallel.elastic import CheckpointManager
            # the cursor rides the SAME crash-consistency contract as
            # the train state: temp+rename publication, completeness
            # probes, walk-past-corrupt restore
            self._ckpt = CheckpointManager(cursor_dir, keep=keep)
        self._derive_shards()
        self._publish()

    # -- pure views ----------------------------------------------------------
    @property
    def n_shards(self):
        return num_shards(self.n_samples, self.shard_size)

    def global_sequence(self, epoch=None):
        """The world-independent sample-id sequence for ``epoch``."""
        return epoch_order(self.n_samples,
                           self.epoch if epoch is None else epoch,
                           self.seed)

    @property
    def my_shards(self):
        """This rank's current shard assignment (reflects any
        mid-epoch reassignment a :meth:`resize` committed)."""
        return self._shards

    def _derive_shards(self):
        """THE canonical ownership rule: this rank's shards are always
        ``reassign_shards(epoch, world, rank, unconsumed(committed
        offset))`` -- a pure function of committed state. At epoch
        start (offset 0) this reduces exactly to the full-epoch
        :func:`assign_shards` round-robin; after a resize it is the
        redistribution of the dead rank's unconsumed shards. Derivation
        happens only at the protocol's anchor points (epoch start,
        seek, resize), which every rank reaches with the same committed
        cursor -- so every rank derives the identical partition."""
        remaining = unconsumed_shards(self.offset, self.n_samples,
                                      self.shard_size)
        self._shards = reassign_shards(self.epoch, self.world,
                                       self.rank, remaining, self.seed)

    def _publish(self):
        _stats.set_gauge("service_epoch", self.epoch)
        _stats.set_gauge("service_offset", self.offset)
        _stats.set_gauge("service_shards_owned", len(self._shards))
        _flightrec.set_context("io_shard_service", {
            "rank": self.rank, "world": list(self.world),
            "epoch": self.epoch, "offset": self.offset,
            "shards": list(self._shards),
        })

    # -- epoch / cursor lifecycle --------------------------------------------
    def begin_epoch(self, epoch):
        """Enter ``epoch`` at offset 0 with the full-epoch pure
        assignment over the current world."""
        self.epoch = int(epoch)
        self.offset = 0
        self._derive_shards()
        self._publish()

    def advance(self, n):
        """Move the (uncommitted) cursor: ``n`` more global positions
        consumed. Rolls into the next epoch at the boundary."""
        self.offset += int(n)
        while self.offset >= self.n_samples:
            extra = self.offset - self.n_samples
            self.begin_epoch(self.epoch + 1)
            self.offset = extra
        self._publish()

    def cursor(self):
        """The committed-state blob: everything replay needs."""
        return {"epoch": int(self.epoch), "offset": int(self.offset),
                "world": list(self.world)}

    def commit(self, step):
        """Publish the cursor for train step ``step`` through the
        service's own crash-consistent store (standalone use -- a data
        plane checkpointing independently of a trainer). A trainer that
        checkpoints its own state gets a STRICTLY atomic pairing instead
        by embedding :meth:`cursor_for_checkpoint` in its checkpoint
        payload, so one temp+rename publishes (or vanishes) both. No-op
        without a ``cursor_dir``."""
        _stats.bump("cursor_commits")
        if self._ckpt is not None:
            self._ckpt.save(int(step), self.cursor())

    def cursor_for_checkpoint(self):
        """The cursor blob to embed in a trainer's checkpoint payload
        (counted as a commit) -- ONE atomic publish covers params and
        cursor, closing the torn-pair window two separate stores would
        leave between their renames."""
        _stats.bump("cursor_commits")
        return self.cursor()

    def apply_cursor(self, cur):
        """Adopt a cursor blob recovered from a trainer's checkpoint
        (counted as a restore). Values may be checkpoint-round-tripped
        host arrays; the recorded world is informational -- the CURRENT
        world stands, so applying an old cursor after a reshard cannot
        resurrect a dead rank."""
        self.epoch = int(cur["epoch"])
        self.offset = int(cur["offset"])
        self._derive_shards()
        _stats.bump("cursor_restores")
        self._publish()

    def seek(self, step=None):
        """Restore the newest committed cursor at or before ``step``
        (newest overall when ``step`` is None); fresh-epoch-0 cursor
        when nothing was ever committed. Returns the cursor dict."""
        cur = None
        if self._ckpt is not None:
            steps = self._ckpt.all_steps()
            if step is not None:
                steps = [s for s in steps if s <= int(step)]
            if steps:
                raw, _ = self._ckpt.restore(steps[-1])
                # CheckpointManager round-trips leaves as host arrays;
                # normalize back to the plain-int cursor contract
                cur = {"epoch": int(raw["epoch"]),
                       "offset": int(raw["offset"]),
                       "world": [int(r) for r in raw["world"]]}
        if cur is None:
            cur = {"epoch": 0, "offset": 0, "world": list(self.world)}
        self.epoch = int(cur["epoch"])
        self.offset = int(cur["offset"])
        # NOTE: the cursor's recorded world is informational -- the
        # CURRENT world (the elastic controller's province) stands, so
        # seeking after a reshard cannot resurrect a dead rank
        self._derive_shards()
        _stats.bump("cursor_restores")
        self._publish()
        return dict(cur)

    def resize(self, world):
        """Commit an elastic resize: the new live world takes over the
        **unconsumed** shards (everything at or past the committed
        cursor), via the pure :func:`reassign_shards` -- so every
        survivor lands on the identical assignment without a word on
        the wire. Positions below the cursor stay consumed; the global
        sequence is untouched."""
        self.world = sorted(int(r) for r in world)
        self._derive_shards()
        _stats.bump("service_resizes")
        _profiler.marker("io.service.resize", lane="io",
                         args={"world": list(self.world),
                               "offset": int(self.offset)})
        self._publish()

    # -- streaming -----------------------------------------------------------
    def iter_samples(self, start=None):
        """This rank's stream: ``(global_pos, sample_id)`` for every
        position in its shards at or past ``start`` (default: the
        committed cursor), in global-position order."""
        start = self.offset if start is None else int(start)
        order = self.global_sequence()
        for s in self._shards:
            span = shard_positions(s, self.n_samples, self.shard_size)
            if span.stop <= start:
                continue  # fully consumed before the cursor
            for pos in span:
                if pos < start:
                    continue
                yield pos, int(order[pos])

    def fetch_batch(self, sample_ids):
        """Fetch (and optionally decode, inline) a list of records --
        the disaggregated-service RPC seam (``io.service.fetch``).
        Corrupt records were already skip-and-counted by the reader
        (``None`` entries are dropped here, counted
        ``io.samples_dropped``)."""
        if _faultpoint.ACTIVE:
            _faultpoint.check("io.service.fetch")
        _stats.bump("samples_streamed", len(sample_ids))
        if self.reader is None:
            payloads = list(sample_ids)
        else:
            payloads = [self.reader.read(i) for i in sample_ids]
            dropped = sum(1 for p in payloads if p is None)
            if dropped:
                _stats.bump("samples_dropped", dropped)
            payloads = [p for p in payloads if p is not None]
        if self.decode_fn is not None:
            payloads = [self.decode_fn(p) for p in payloads]
        return payloads

    def iter_batches(self, batch_size, start=None, workers=0,
                     **pool_kwargs):
        """Batches of this rank's stream: yields ``(positions,
        samples)`` with ``len(samples) == len(positions)`` minus any
        corrupt-skipped records. ``workers > 0`` routes fetch+decode
        through a :class:`DecodePool` (order preserved by the pool's
        sequence slots); ``workers == 0`` stays inline."""
        batch_size = int(batch_size)

        def batched():
            buf = []
            for pos_id in self.iter_samples(start):
                buf.append(pos_id)
                if len(buf) == batch_size:
                    yield buf
                    buf = []
            if buf:
                yield buf

        if workers <= 0:
            for group in batched():
                ids = [sid for _, sid in group]
                yield [p for p, _ in group], self.fetch_batch(ids)
            return

        def fetch_one(group):
            return ([p for p, _ in group],
                    self.fetch_batch([sid for _, sid in group]))

        # fully streaming: the pool claims groups lazily from the
        # generator and its sequence slots keep batch order no matter
        # how many workers race the fetches
        pool = DecodePool(batched(), fetch_one, workers=workers,
                          name="shard_service", **pool_kwargs)
        try:
            for positions, samples in pool:
                yield positions, samples
        finally:
            # generator finalization (break / GC / .close()) must not
            # leave N workers polling forever
            pool.close()
