"""The port's streaming input (mxnet_tpu_torch/io/shard_service.py,
range_reader.py, worker_pool.py) and the single-process part of
parallel/elastic.py against the JAX package's modules of the same names.

The assignment math (epoch_order, num_shards, shard_positions,
assign_shards, reassign_shards, unconsumed_shards, batch_slices,
shard_for_rank) is element for element the JAX package's. The decode pool
keeps source order at 1 and 4 workers under the io.worker.decode fault
point; the range reader on one file under one fault spec and seed skips
the same records and counts the same retries as the JAX reader; the
service's committed cursor and the checkpoint store behave as the JAX
package's do.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu._debug.faultpoint as jfault
import mxnet_tpu.io as jio
import mxnet_tpu.io._stats as jstats
import mxnet_tpu.io.shard_service as jss
import mxnet_tpu.parallel.elastic as jel
import mxnet_tpu_torch as mx
import mxnet_tpu_torch._debug.faultpoint as tfault
import mxnet_tpu_torch.io._stats as tstats
import mxnet_tpu_torch.io.shard_service as tss
import mxnet_tpu_torch.parallel.elastic as tel
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch._retry import RetryPolicy


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_FLIGHTREC_DIR", str(tmp_path / "frec"))
    for m in (jfault, tfault, jstats, tstats):
        m.reset()
    yield
    for m in (jfault, tfault, jstats, tstats):
        m.reset()


# -- the pure assignment math ---------------------------------------------------

@pytest.mark.parametrize("n,epoch,seed", [(1, 0, 0), (97, 3, 7), (2048, 1, 0),
                                          (1000, 12, 123456)])
def test_epoch_order_equals_jax(n, epoch, seed):
    np.testing.assert_array_equal(tss.epoch_order(n, epoch, seed),
                                  jss.epoch_order(n, epoch, seed))


@pytest.mark.parametrize("world", [(0,), (0, 1), (3, 1, 2, 0), (5, 2, 9)])
def test_assignment_math_equals_jax(world):
    for n, size in ((100, 7), (2048, 64), (5, 10)):
        assert tss.num_shards(n, size) == jss.num_shards(n, size)
        ns = tss.num_shards(n, size)
        for s in range(ns):
            assert tss.shard_positions(s, n, size) \
                == jss.shard_positions(s, n, size)
        for epoch in range(3):
            for rank in world:
                assert tss.assign_shards(epoch, world, rank, ns, seed=4) \
                    == jss.assign_shards(epoch, world, rank, ns, seed=4)
                left = tss.unconsumed_shards(n // 3, n, size)
                assert left == jss.unconsumed_shards(n // 3, n, size)
                assert tss.reassign_shards(epoch, world, rank, left) \
                    == jss.reassign_shards(epoch, world, rank, left)
    for offset, batch in ((0, 10), (37, 128), (5, 3)):
        assert tss.batch_slices(offset, batch, world) \
            == jss.batch_slices(offset, batch, world)
        for rank in world:
            assert tel.shard_for_rank(batch, world, rank) \
                == jel.shard_for_rank(batch, world, rank)
    with pytest.raises(ValueError):
        tss.assign_shards(0, world, 99, 4)
    with pytest.raises(ValueError):
        tss.num_shards(10, 0)


# -- the decode pool ---------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 4])
def test_decode_pool_keeps_source_order_under_faults(workers):
    tfault.configure({"io.worker.decode": "raise:RuntimeError@p=0.2"},
                     seed=3)
    pool = mx.io.DecodePool(range(200), lambda i: i * i, workers=workers,
                            item_retries=12, name="test")
    assert list(pool) == [i * i for i in range(200)]
    snap = tstats.snapshot()
    deaths = sum(v for k, v in snap.items()
                 if k.startswith("worker_deaths."))
    assert deaths > 0 and snap.get("pool_failures", 0) == 0
    pool.close()


def test_decode_pool_poison_item_raises_once_in_order():
    def decode(i):
        if i == 5:
            raise ValueError("poison")
        return i
    pool = mx.io.DecodePool(range(10), decode, workers=3, item_retries=2)
    got = []
    with pytest.raises(ValueError, match="poison"):
        for v in pool:
            got.append(v)
    assert got == list(range(5))
    assert list(pool) == []
    pool.reset()
    assert next(pool) == 0
    pool.close()


# -- the range reader ----------------------------------------------------------------

def _rec(tmp_path, n=40):
    path = str(tmp_path / "data.rec")
    w = recordio.MXRecordIO(path, "w")
    rs = np.random.RandomState(0)
    for i in range(n):
        w.write(recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                              rs.bytes(int(rs.randint(1, 300)))))
    w.close()
    return path


@pytest.mark.parametrize("sidecar", [False, True])
def test_range_reader_counts_equal_jax(tmp_path, sidecar):
    """One file, one fault spec and seed, one reading thread: the same
    records skipped, the same payloads, the same io counters."""
    path = _rec(tmp_path)
    if sidecar:
        assert mx.io.build_crc_sidecar(path) == path + ".crc"
        with open(path + ".crc") as a, \
                open(jio.build_crc_sidecar(path, str(tmp_path / "j.crc"))) \
                as b:
            assert a.read() == b.read()
    spec = {"io.shard.read": "raise:ConnectionError@p=0.2",
            "io.record.corrupt": "raise:RuntimeError@p=0.1"}
    from mxnet_tpu._retry import RetryPolicy as JPolicy
    out = []
    for io_mod, fault, stats, policy in (
            (jio, jfault, jstats, JPolicy),
            (mx.io, tfault, tstats, RetryPolicy)):
        fault.configure(spec, seed=11)
        reader = io_mod.RecordIORangeReader(
            path, corrupt_budget=100, retry_policy=policy(base=0.0, cap=0.0))
        got = [reader.read(i) for i in range(len(reader))]
        out.append((got, reader.corrupt_skipped,
                    {k: v for k, v in stats.snapshot().items()}))
        reader.close()
        fault.reset()
    assert out[1] == out[0]
    assert 0 < out[1][1] < 40 and out[1][2]["read_retries"] > 0


def test_range_reader_validates_and_trips_its_budget(tmp_path):
    path = _rec(tmp_path, n=6)
    mx.io.build_crc_sidecar(path)
    with open(path, "r+b") as f:      # flip a payload byte of record 0
        f.seek(30)
        b = f.read(1)
        f.seek(30)
        f.write(bytes([b[0] ^ 1]))
    reader = mx.io.RecordIORangeReader(path, corrupt_budget=0)
    with pytest.raises(mx.io.CorruptRecordError, match="crc mismatch"):
        reader.read_record(0)
    with pytest.raises(mx.io.CorruptRecordError, match="budget exhausted"):
        reader.read(0)
    assert reader.read(1) is not None
    assert not issubclass(mx.io.CorruptRecordError, OSError)


# -- the service and its committed cursor ----------------------------------------

def test_service_stream_and_cursor_equal_jax(tmp_path):
    path = _rec(tmp_path, n=50)
    runs = []
    for io_mod, name in ((jio, "jax"), (mx.io, "torch")):
        svc = io_mod.ShardService(50, shard_size=8, seed=2, world=(0, 1),
                                  rank=1, cursor_dir=str(tmp_path / name),
                                  reader=io_mod.RecordIORangeReader(path),
                                  decode_fn=lambda p: recordio.unpack(p)[0]
                                  .label)
        first = [(p, s) for p, s in svc.iter_samples()]
        batches = list(svc.iter_batches(5, workers=2))
        svc.advance(16)
        svc.commit(3)
        svc.advance(16)
        svc.commit(4)
        svc.resize((1, 2))
        after = svc.my_shards
        fresh = io_mod.ShardService(50, shard_size=8, seed=2, world=(1,),
                                    rank=1, cursor_dir=str(tmp_path / name))
        runs.append((first, [(p, [float(x) for x in s])
                             for p, s in batches], after,
                     fresh.seek(3), fresh.seek(), fresh.my_shards))
    assert runs[1] == runs[0]
    assert runs[1][3]["offset"] == 16 and runs[1][4]["offset"] == 32


# -- the checkpoint store -------------------------------------------------------------

def _tree(step):
    g = torch.Generator().manual_seed(step)
    return {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
            "m": [torch.zeros(5), np.arange(3) + step], "step": step}


@pytest.mark.parametrize("async_persist,delta", [(False, False),
                                                 (True, False), (False, True)])
def test_checkpoint_round_trip_and_prune(tmp_path, async_persist, delta):
    m = tel.CheckpointManager(str(tmp_path), keep=2,
                              async_persist=async_persist, delta=delta)
    for s in range(4):
        m.save(s, _tree(s if s < 2 else 1))
    m.flush()
    state, step = m.restore()
    assert step == 3
    want = _tree(1)
    assert torch.equal(state["w"], want["w"]) and state["step"] == 1
    np.testing.assert_array_equal(state["m"][1], want["m"][1])
    assert m.all_steps()[-2:] == [2, 3]
    if delta:   # steps 2 and 3 repeat step 1's leaves: deltas on base 1
        assert 1 in m.all_steps()


def test_checkpoint_walks_past_a_corrupt_step(tmp_path):
    m = tel.CheckpointManager(str(tmp_path), keep=5)
    for s in range(3):
        m.save(s, _tree(s))
    with open(m._step_path(2), "r+b") as f:   # complete-looking, unreadable
        f.seek(10)
        f.write(b"\x00" * 20)
    state, step = m.restore()
    assert step == 1 and state["step"] == 1
    with open(m._step_path(1), "r+b") as f:
        f.truncate(20)                         # torn: never a candidate
    assert m.all_steps() == [0, 2]
    with pytest.raises(FileNotFoundError):
        m.restore(1)
    with pytest.raises(NotImplementedError, match="Orbax"):
        tel.CheckpointManager(str(tmp_path / "o"), use_orbax=True)


def test_checkpoint_persist_fault_surfaces_on_the_next_save(tmp_path):
    m = tel.CheckpointManager(str(tmp_path), async_persist=True)
    tfault.configure({"checkpoint.persist": "raise:OSError@n=1"})
    m.save(0, _tree(0))
    with pytest.raises(RuntimeError, match="async checkpoint persist failed"):
        m.save(1, _tree(1))
    tfault.reset()
    m.save(2, _tree(2))
    m.flush()
    assert m.latest_step() == 2
    with open(m._step_path(2), "rb") as f:
        assert pickle.load(f)["step"] == 2
    assert os.listdir(str(tmp_path)) == ["step_2.ckpt"]
