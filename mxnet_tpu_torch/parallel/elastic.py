"""Crash-consistent checkpoints and the data split of elastic training,
single-process part (counterpart of mxnet_tpu/parallel/elastic.py).

- ``CheckpointManager``: save/restore of any tree of tensors (params,
  optimizer state, step, a data cursor) with a monotonically increasing
  step. Publication is temp write + atomic rename; completeness is provable
  after the fact (a pickle ends with its STOP opcode), so an incomplete
  checkpoint is never a restore candidate and ``restore()`` walks past a
  corrupt step to the newest complete one; corrupt leftovers are pruned on
  the next ``save()``. Async persist (``MXTPU_CKPT_ASYNC``: only the
  device-to-host copy blocks ``save()``) and delta dedup
  (``MXTPU_CKPT_DELTA``: a save changing at most half the leaves writes
  only those, against the last full snapshot) are the JAX package's. The
  leaves are copied to the host with ``Tensor.cpu()`` and pickled; the
  tree structure is ``torch.utils._pytree``'s.
- ``shard_for_rank``: the deterministic contiguous split of a batch over
  the sorted live world (``io.shard_service.batch_slices`` delegates to
  it).
- ``ReshardRequired``: the error of a reshard policy that forbids
  shrinking.

The fault points ``checkpoint.save`` (between the temp write and the
rename), ``checkpoint.persist`` (on the persist thread, before the
publish) and ``elastic.restore`` (at restore's entry) make the cycle
chaos-testable; every event counts into ``profiler.metrics()['elastic']``.

Orbax is a non-goal of the port: ``use_orbax=True`` raises. The
preemption guard, the elastic controller, the host gradient reducer, the
peer snapshots and ``elastic_train_loop`` are multi-process and come with
the multi-GPU slice (ROADMAP M10).
"""
from __future__ import annotations

import hashlib
import os
import pickle
import threading
import time

import numpy as np
import torch
from torch.utils import _pytree as _tree

from .. import profiler as _profiler
from .._debug import faultpoint as _faultpoint
from .._debug import goodput as _goodput
from ..base import getenv as _getenv

__all__ = ["CheckpointManager", "ReshardRequired", "shard_for_rank"]


class ReshardRequired(RuntimeError):
    """A rank vanished and the reshard policy forbids shrinking
    (``MXTPU_ELASTIC_RESHARD=fail``): the job must stop and wait for a
    replacement instead of limping on fewer hosts."""

    def __init__(self, dead_ranks, survivors):
        self.dead_ranks = sorted(dead_ranks)
        self.survivors = sorted(survivors)
        super().__init__(
            "dead ranks %s; reshard policy 'fail' forbids shrinking to "
            "survivors %s" % (self.dead_ranks, self.survivors))


class CheckpointManager:
    """Save/restore trees of tensors with a monotonically increasing step.

    Directory layout: <dir>/step_<N>.ckpt (a pickle of the host tree).
    Keeps the newest `keep` checkpoints. Crash-consistent: publication is
    temp-write + atomic rename, completeness is provable after the fact
    (the pickle's STOP opcode), and `restore()` walks past corrupt
    candidates to the newest complete step.

    Zero-badput legs:

    - ``async_persist`` (``MXTPU_CKPT_ASYNC``): ``save()`` splits into
      snapshot-then-persist. The blocking half is only the device→host
      copy (``Tensor.cpu()`` waits for the card to produce the values) --
      and the temp-write +
      atomic rename + prune run on a background persist thread. At most
      ONE persist is in flight: when the writer falls behind, the next
      ``save()`` blocks on it (visible backpressure, counted as
      ``elastic.checkpoint_backpressure``) instead of queueing
      snapshots without bound. A persist failure is remembered and
      raised from the NEXT ``save()``/``flush()``; the ``checkpoint.
      persist`` faultpoint fires on the persist thread between snapshot
      and publish, so chaos tests prove a crash there loses only the
      unpublished step.
    - ``delta`` (``MXTPU_CKPT_DELTA``): a save
      whose pytree structure matches the previous FULL snapshot and
      whose changed-leaf fraction is ≤ 1/2 writes only the changed
      leaves plus a one-hop base reference (never delta-of-delta). The
      base step is pinned by a ``.base`` sidecar so ``_prune`` keeps it
      alive as long as any kept delta needs it.
    """

    # a delta payload referencing a base whose changed-leaf fraction
    # exceeds this writes a full snapshot instead (a delta carrying
    # most of the state costs full price plus a restore indirection)
    _DELTA_MAX_CHANGED = 0.5

    def __init__(self, directory, keep=3, use_orbax=None,
                 async_persist=None, delta=None):
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.keep = int(keep)
        if use_orbax:
            raise NotImplementedError(
                "CheckpointManager(use_orbax=True): Orbax is a JAX library "
                "and not a goal of the port; its checkpoints are pickles "
                "of the host tree")
        if async_persist is None:
            async_persist = _getenv("MXTPU_CKPT_ASYNC", "0") \
                not in ("0", "false", "off")
        self.async_persist = bool(async_persist)
        if delta is None:
            delta = _getenv("MXTPU_CKPT_DELTA", "0") \
                not in ("0", "false", "off")
        self.delta = bool(delta)
        self._persist_thread = None
        self._persist_step = None   # step an in-flight persist publishes
        self._persist_exc = None    # surfaced on the next save()/flush()
        self._persist_lock = threading.Lock()
        self.backpressure_waits = 0
        # delta state: step + per-leaf digests + structure of the last
        # successfully PUBLISHED full snapshot (adopted by the persist,
        # never by the snapshot, so a failed publish can't become a base)
        self._base_step = None
        self._base_digests = None
        self._base_treedef = None

    # -- paths --------------------------------------------------------------
    def _step_path(self, step):
        return os.path.join(self.directory, "step_%d.ckpt" % int(step))

    def _is_complete(self, path):
        """Cheap completeness probe -- no deserialization: a checkpoint
        file is complete iff it is non-empty and ends with the pickle STOP
        opcode (a truncated write cannot)."""
        try:
            size = os.path.getsize(path)
            if size == 0:
                return False
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                return f.read(1) == b"."
        except OSError:
            return False

    def all_steps(self):
        """Steps with a COMPLETE checkpoint, ascending. `.tmp` leftovers
        (partial save interrupted mid-write) and incomplete entries
        (empty or truncated pickle) are never restore
        candidates."""
        steps = []
        for n in os.listdir(self.directory):
            if not n.startswith("step_") or n.endswith(".tmp"):
                continue
            try:
                s = int(n[5:].split(".")[0])
            except ValueError:
                continue
            if self._is_complete(os.path.join(self.directory, n)):
                steps.append(s)
        return sorted(set(steps))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save/restore -------------------------------------------------------
    def save(self, step, state):
        """Write `state` (a tree of tensors, arrays, numbers) for `step`;
        prunes old ones.

        Crash-consistent both ways: the full state lands on a `.tmp`
        sibling first and is atomically renamed into place, with the
        `checkpoint.save` fault point firing between write and rename --
        an injected (or real) crash mid-save leaves every previously
        published step restorable and at worst a `.tmp` leftover,
        which `all_steps()` never considers and the
        next `save()` prunes.

        With ``async_persist`` only the device→host snapshot (plus any
        backpressure wait on a still-running previous persist) blocks
        here; the write/rename/prune half runs on the persist thread
        and a failure there surfaces from the NEXT call."""
        t0 = time.monotonic()
        self._raise_persist_error()
        if self.async_persist:
            # at-most-one in-flight persist: block on the previous one
            # BEFORE taking the snapshot, so the backpressure wait is
            # visible badput on this save, never an unbounded queue
            t = self._persist_thread
            if t is not None and t.is_alive():
                self.backpressure_waits += 1
                _profiler.bump_elastic("checkpoint_backpressure",
                                       args={"step": int(step)})
                t.join()
                self._raise_persist_error()
        host_state = self._snapshot(state)
        job = self._encode(step, host_state)
        if not self.async_persist:
            self._persist(step, job)
            self._prune()
            dur_s = time.monotonic() - t0
            _profiler.record_op("elastic.checkpoint_save", dur_s * 1e6,
                                category="elastic", lane="user",
                                args={"step": int(step)})
            if _goodput.OPEN:
                _goodput.note_checkpoint(dur_s, "save")
            return self._step_path(step)
        with self._persist_lock:
            self._persist_step = int(step)
        th = threading.Thread(target=self._persist_bg,
                              args=(int(step), job),
                              name="mxtpu-ckpt-persist", daemon=True)
        self._persist_thread = th
        th.start()
        # only the blocking half books under 'checkpoint': the persist
        # overlaps training and reports through note_checkpoint(persist)
        dur_s = time.monotonic() - t0
        _profiler.record_op("elastic.checkpoint_snapshot", dur_s * 1e6,
                            category="elastic", lane="user",
                            args={"step": int(step)})
        if _goodput.OPEN:
            _goodput.note_checkpoint(dur_s, "save")
        return self._step_path(step)

    def _snapshot(self, state):
        """Device-to-host copy of every leaf (``Tensor.cpu()``, detached).
        Async mode also copies leaves already on the host (a CPU tensor or
        a numpy array is otherwise passed through by reference, and the
        persist thread must never race the caller mutating it). The host
        copies register under the memory ledger's ``checkpoint`` tag."""
        def _leaf(a):
            if isinstance(a, torch.Tensor):
                h = a.detach().cpu()
                if self.async_persist and a.device.type == "cpu":
                    h = h.clone()
                return h
            if self.async_persist and isinstance(a, np.ndarray):
                return np.array(a, copy=True)
            return a
        host_state = _tree.tree_map(_leaf, state)
        try:
            from .. import storage as _storage
            _storage.ledger_register_tree(
                [l for l in _tree.tree_leaves(host_state)
                 if isinstance(l, torch.Tensor)],
                "checkpoint", site="elastic.snapshot")
        except Exception:
            pass  # attribution only; the snapshot itself is committed
        return host_state

    @staticmethod
    def _digest(leaf):
        try:
            if isinstance(leaf, torch.Tensor):
                raw = leaf.reshape(-1).contiguous().view(torch.uint8) \
                    .numpy().tobytes()
                meta = (tuple(leaf.shape), str(leaf.dtype))
            else:
                a = np.asarray(leaf)
                raw, meta = a.tobytes(), (a.shape, a.dtype)
            return hashlib.sha1(raw + str(meta).encode()).hexdigest()
        except Exception:
            return hashlib.sha1(pickle.dumps(leaf)).hexdigest()

    def _encode(self, step, host_state):
        """Decide the payload for one save: ``(payload, kind, base,
        treedef, digests)``. Delta mode compares per-leaf digests to
        the last published FULL snapshot; a structure change or a
        changed fraction beyond the cap falls back to a full write."""
        if not self.delta:
            return (host_state, "full", None, None, None)
        leaves, treedef = _tree.tree_flatten(host_state)
        digests = [self._digest(l) for l in leaves]
        if self._base_digests is not None \
                and treedef == self._base_treedef \
                and len(digests) == len(self._base_digests):
            changed = {i: leaves[i] for i, d in enumerate(digests)
                       if d != self._base_digests[i]}
            if len(changed) <= self._DELTA_MAX_CHANGED * max(
                    1, len(leaves)):
                payload = {"__mxtpu_delta__": 1,
                           "base": int(self._base_step),
                           "n": len(leaves), "leaves": changed}
                return (payload, "delta", int(self._base_step),
                        treedef, None)
        return (host_state, "full", None, treedef, digests)

    def _write_sidecar(self, step, base):
        """Pin a delta's base step in a crash-safe ``.base`` sidecar --
        written BEFORE the delta publishes (an orphan sidecar of an
        unpublished step is inert and pruned), read by ``_prune`` so a
        kept delta's base survives the keep policy."""
        p = self._step_path(step) + ".base"
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            f.write("%d\n" % int(base))
        os.replace(tmp, p)

    def _delta_base_of(self, step):
        try:
            with open(self._step_path(step) + ".base") as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _persist(self, step, job):
        """The durable half: temp-write + atomic rename + commit
        marker. Runs inline (sync mode) or on the persist thread."""
        payload, kind, base, treedef, digests = job
        path = self._step_path(step)
        tmp = path + ".tmp"
        try:
            if kind == "delta":
                self._write_sidecar(step, base)
            with open(tmp, "wb") as f:
                pickle.dump(payload, f)
            if _faultpoint.ACTIVE:
                _faultpoint.check("checkpoint.save")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        # base bookkeeping only AFTER the publish committed -- a failed
        # persist must never become the base a later delta references
        if kind == "full" and digests is not None:
            self._base_step = int(step)
            self._base_digests = digests
            self._base_treedef = treedef
        _profiler.bump_elastic("checkpoint_saves",
                               args={"step": int(step), "kind": kind})

    def _persist_bg(self, step, job):
        """Persist-thread body: faultpoint (the snapshot→persist gap --
        a crash here loses exactly one unpublished step), publish,
        clear the in-flight marker, then re-prune (the prune that was
        skipped while this step was in flight)."""
        t0 = time.monotonic()
        try:
            if _faultpoint.ACTIVE:
                _faultpoint.check("checkpoint.persist")
            self._persist(step, job)
        except BaseException as e:  # surfaced on next save()/flush()
            with self._persist_lock:
                self._persist_exc = e
                self._persist_step = None
            _profiler.bump_elastic("persist_failures",
                                   args={"step": int(step)})
            return
        with self._persist_lock:
            self._persist_step = None
        dur_s = time.monotonic() - t0
        _profiler.record_op("elastic.checkpoint_persist", dur_s * 1e6,
                            category="elastic", lane="user",
                            args={"step": int(step)})
        if _goodput.OPEN:
            _goodput.note_checkpoint(dur_s, "persist")
        self._prune()

    def flush(self, raise_error=True):
        """Block until any in-flight persist published (or failed);
        with ``raise_error`` re-raise a recorded persist failure. Call
        before relying on ``latest_step()`` durability (loop exits,
        preemption drains)."""
        t = self._persist_thread
        if t is not None:
            t.join()
            self._persist_thread = None
        if raise_error:
            self._raise_persist_error()

    def _raise_persist_error(self):
        with self._persist_lock:
            e, self._persist_exc = self._persist_exc, None
        if e is not None:
            raise RuntimeError(
                "async checkpoint persist failed: %s: %s"
                % (type(e).__name__, e)) from e

    def restore(self, step=None):
        """Load the pytree for `step` (newest when None); (None, None)
        when nothing restorable exists. With `step=None` the walk skips
        entries that fail to load (corruption the cheap completeness
        probe missed) and falls back to the next-older complete step --
        counted as ``elastic.incomplete_skipped``. An in-flight async
        persist is drained first so the newest step is visible; a
        recorded persist FAILURE does not fail the restore (the walk
        simply lands on the newest step that did publish)."""
        self.flush(raise_error=False)
        if _faultpoint.ACTIVE:
            # the restore seam: an injected raise here exercises the
            # caller's recovery path exactly where a real read failure
            # (lost filesystem, corrupt bytes) would surface
            _faultpoint.check("elastic.restore")
        t0 = time.monotonic()

        def _done(state, s):
            dur_s = time.monotonic() - t0
            _profiler.record_op("elastic.checkpoint_restore",
                                dur_s * 1e6, category="elastic",
                                lane="user", args={"step": s})
            if _goodput.OPEN:
                # inside a recovery interval the interval's own clock
                # covers this time; note_checkpoint only counts then
                _goodput.note_checkpoint(dur_s, "restore")
            return state, s

        if step is not None:
            path = self._step_path(step)
            if not self._is_complete(path):
                # same clear verdict the step=None walk gives: an
                # incomplete candidate is NOT restorable --
                # without this probe a raw deserialize error (pickle
                # EOF) leaks instead
                raise FileNotFoundError(
                    "checkpoint step %d is incomplete or missing (%s): "
                    "empty or truncated payload -- it was "
                    "never published; pass step=None to restore the "
                    "newest complete step" % (int(step), path))
            state = self._load(path)
            _profiler.bump_elastic("restores", args={"step": int(step)})
            return _done(state, int(step))
        for s in reversed(self.all_steps()):
            try:
                state = self._load(self._step_path(s))
            except Exception:
                # complete-looking but unreadable (e.g. corruption past
                # the STOP byte): skip to the previous step
                _profiler.bump_elastic("incomplete_skipped",
                                       args={"step": int(s)})
                continue
            _profiler.bump_elastic("restores", args={"step": int(s)})
            return _done(state, int(s))
        return None, None

    def _load(self, path):
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if isinstance(obj, dict) and obj.get("__mxtpu_delta__") == 1:
            # one-hop delta: the base is always a FULL snapshot
            with open(self._step_path(obj["base"]), "rb") as f:
                base_state = pickle.load(f)
            if isinstance(base_state, dict) \
                    and base_state.get("__mxtpu_delta__") == 1:
                raise ValueError(
                    "delta checkpoint base step %d is itself a delta "
                    "(corrupt chain; deltas are one-hop by contract)"
                    % obj["base"])
            leaves, treedef = _tree.tree_flatten(base_state)
            if len(leaves) != obj["n"]:
                raise ValueError(
                    "delta checkpoint leaf count %d does not match "
                    "base %d" % (obj["n"], len(leaves)))
            for i, v in obj["leaves"].items():
                leaves[int(i)] = v
            return _tree.tree_unflatten(treedef, leaves)
        return obj

    def _prune(self):
        """Drop steps beyond `keep` AND every incomplete leftover -- a
        `.tmp` from an interrupted save, a
        truncated fallback file (the crashed sibling of the step that
        just published). Two steps are NEVER touched: the step a
        concurrent async persist is about to publish (its `.tmp` is
        being written right now; the persist re-prunes on completion),
        and the full base any kept delta references (pinned by its
        `.base` sidecar -- pruning it would orphan the delta)."""
        def _rm(p):
            try:
                os.remove(p)
            except OSError:
                pass

        with self._persist_lock:
            inflight = self._persist_step
        complete = set(self.all_steps())
        kept = set(sorted(complete)[-self.keep:]) if self.keep > 0 \
            else set(complete)
        if inflight is not None:
            kept.add(inflight)
        protected = set(kept)
        for s in list(kept):
            b = self._delta_base_of(s)
            if b is not None:
                protected.add(b)
        for n in os.listdir(self.directory):
            if not n.startswith("step_"):
                continue
            p = os.path.join(self.directory, n)
            try:
                s = int(n[5:].split(".")[0])
            except ValueError:
                continue
            if s == inflight:
                continue
            if n.endswith(".tmp"):
                _rm(p)
                continue
            if s not in complete and not n.endswith(".base"):
                _rm(p)
        for s in sorted(complete):
            if s in protected:
                continue
            _rm(self._step_path(s))
            _rm(self._step_path(s) + ".base")
        # sidecars whose step vanished (pruned above or crashed before
        # publishing) are dead weight once no kept step needs them
        for n in os.listdir(self.directory):
            if not n.endswith(".base"):
                continue
            try:
                s = int(n[5:].split(".")[0])
            except ValueError:
                continue
            if s != inflight and s not in complete:
                _rm(os.path.join(self.directory, n))


def shard_for_rank(n_items, world, rank):
    """Deterministic contiguous split of ``n_items`` over the sorted
    live world — the data-assignment half of resharding. A pure
    function of ``(n_items, world, rank)``, so the assignment is
    epoch-reproducible under elastic resize: survivors agree on the new
    split without talking. Returns ``range(start, stop)``."""
    world = sorted(int(r) for r in world)
    idx = world.index(int(rank))
    n = len(world)
    base, extra = divmod(int(n_items), n)
    start = idx * base + min(idx, extra)
    stop = start + base + (1 if idx < extra else 0)
    return range(start, stop)
