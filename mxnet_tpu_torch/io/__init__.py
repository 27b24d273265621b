"""Data IO: the iterators that feed a training loop (counterpart of
mxnet_tpu/io/). One Python layer over numpy: ``NDArrayIter`` and the
readers built on it (``CSVIter``, ``LibSVMIter``, ``MNISTIter``),
``ResizeIter``, ``PrefetchingIter``, which prepares batches on a
background thread on the host and moves each to the caller's context on
the caller's thread, ``ImageRecordIter`` (augmented images from a RecordIO
file of raw-pixel, JPEG or PNG records) and ``DevicePrefetchIter`` /
``DevicePrefetcher``, which copy batch N+1 to the card through pinned
memory on a side stream while batch N computes.

Not ported yet: the RecordIO range reader, the decode pool and the shard
service (``RecordIORangeReader``, ``DecodePool``, ``ShardService``, ...),
and the profiler and goodput accounting of the JAX package's iterators
(``io/_stats.py``), all of the observability slice (ROADMAP M9).
"""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, CSVIter,
                 LibSVMIter, ResizeIter, PrefetchingIter, MNISTIter)
from .image_iter import ImageRecordIter
from .prefetch import DevicePrefetchIter, DevicePrefetcher

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ResizeIter", "PrefetchingIter", "MNISTIter",
           "ImageRecordIter", "DevicePrefetchIter", "DevicePrefetcher"]
