"""Data IO: the iterators that feed a training loop (counterpart of
mxnet_tpu/io/). One Python layer over numpy: ``NDArrayIter`` and the
readers built on it (``CSVIter``, ``LibSVMIter``, ``MNISTIter``),
``ResizeIter``, and ``PrefetchingIter``, which prepares batches on a
background thread on the host and moves each to the caller's context on
the caller's thread.

The image pipeline (``ImageRecordIter``), the device prefetchers, the
RecordIO range reader, the decode pool and the shard service arrive with
the rest of the data slice; the profiler and goodput accounting of the JAX
package's iterators arrive with the observability slice.
"""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, CSVIter,
                 LibSVMIter, ResizeIter, PrefetchingIter, MNISTIter)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ResizeIter", "PrefetchingIter", "MNISTIter"]
