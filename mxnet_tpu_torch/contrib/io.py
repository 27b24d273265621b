"""Contributed data iterators (counterpart of mxnet_tpu/contrib/io.py; ref:
python/mxnet/contrib/io.py): ``DataLoaderIter`` runs a Gluon DataLoader
behind the DataIter interface."""
from __future__ import annotations

from .. import ndarray as nd
from ..io import DataDesc, DataIter

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    """A ``gluon.data.DataLoader`` as a DataIter. A short last batch is
    padded with zeros to the full batch size, and ``pad`` counts the
    filler, so every batch has one shape."""

    def __init__(self, loader, data_name="data",
                 label_name="softmax_label", dtype="float32"):
        super().__init__()
        self._loader = loader
        self._iter = iter(loader)
        data, label = next(self._iter)
        self.batch_size = data.shape[0]
        self.dtype = dtype
        self.provide_data = [DataDesc(data_name, tuple(data.shape), dtype)]
        self.provide_label = [DataDesc(label_name, tuple(label.shape),
                                       dtype)]
        self._current_batch = None
        self.reset()

    def reset(self):
        self._iter = iter(self._loader)

    def iter_next(self):
        try:
            self._current_batch = next(self._iter)
        except StopIteration:
            self._current_batch = None
        return self._current_batch is not None

    def _padded(self, arr):
        pad = self.getpad()
        arr = arr.astype(self.dtype)
        if not pad:
            return [arr]
        full = nd.zeros((self.batch_size,) + tuple(arr.shape[1:]),
                        ctx=arr.context, dtype=self.dtype)
        full[:arr.shape[0]] = arr
        return [full]

    def getdata(self):
        return self._padded(self._current_batch[0])

    def getlabel(self):
        return self._padded(self._current_batch[1])

    def getpad(self):
        return self.batch_size - self._current_batch[0].shape[0]

    def getindex(self):
        return None
