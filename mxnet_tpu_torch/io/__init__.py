"""Data IO: the iterators that feed a training loop (counterpart of
mxnet_tpu/io/). One Python layer over numpy: ``NDArrayIter`` and the
readers built on it (``CSVIter``, ``LibSVMIter``, ``MNISTIter``),
``ResizeIter``, ``PrefetchingIter``, which prepares batches on a
background thread on the host and moves each to the caller's context on
the caller's thread, ``ImageRecordIter`` (augmented images from a RecordIO
file of raw-pixel, JPEG or PNG records) and ``DevicePrefetchIter`` /
``DevicePrefetcher``, which copy batch N+1 to the card through pinned
memory on a side stream while batch N computes.

The scale-out half is the fault-tolerant sharded streaming service: a
deterministic global shard assignment with a committed sample cursor
(``shard_service``: ``ShardService``, ``epoch_order``,
``assign_shards``, ...), an N-worker restart-or-die decode pool
(``worker_pool.DecodePool``) and a range-read RecordIO reader with retry
and corrupt-record budgets (``range_reader.RecordIORangeReader``), which
stand on ``_retry``, the fault points and ``parallel.elastic``'s
checkpoint store.

``PrefetchingIter``, ``DevicePrefetchIter`` and ``DecodePool`` carry the
JAX package's profiler spans, ``io.prefetch_wait`` latencies and goodput
input-wait accounting; ``io/_stats.py`` owns the counters and gauges of
``profiler.metrics()['io']``.
"""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, CSVIter,
                 LibSVMIter, ResizeIter, PrefetchingIter, MNISTIter)
from .image_iter import ImageRecordIter
from .prefetch import DevicePrefetchIter, DevicePrefetcher
from .range_reader import (RecordIORangeReader, CorruptRecordError,
                           build_crc_sidecar)
from .worker_pool import DecodePool
from .shard_service import (ShardService, epoch_order, assign_shards,
                            reassign_shards, unconsumed_shards,
                            batch_slices)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ResizeIter", "PrefetchingIter", "MNISTIter",
           "ImageRecordIter", "DevicePrefetchIter", "DevicePrefetcher",
           "RecordIORangeReader", "CorruptRecordError",
           "build_crc_sidecar", "DecodePool", "ShardService",
           "epoch_order", "assign_shards", "reassign_shards",
           "unconsumed_shards", "batch_slices"]
