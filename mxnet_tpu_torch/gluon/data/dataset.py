"""Datasets (counterpart of mxnet_tpu/gluon/data/dataset.py; ref:
python/mxnet/gluon/data/dataset.py)."""
from __future__ import annotations

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        kept = []
        for i in range(len(self)):
            item = self[i]
            if fn(item):
                kept.append(item)
        return SimpleDataset(kept)

    def shard(self, num_shards, index):
        assert 0 <= index < num_shards
        return SimpleDataset([self[i] for i in range(index, len(self),
                                                     num_shards)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        """A dataset of ``fn(*item)`` (``fn(item)`` for a non-tuple item);
        ``lazy=False`` applies it to every item now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``transform`` of the first element of each item only (the
        data, not the label)."""
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    """Any sized, indexable object as a dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """The zip of equal-length arrays (numpy arrays, NDArrays, lists):
    item i is the tuple of their i-th elements, or the element itself for
    one array."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for d in args:
            assert len(d) == self._length, \
                "All arrays must have the same length"
            self._data.append(d)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """The raw records of a RecordIO file, by position, through its .idx
    sidecar (``filename`` with the extension replaced by ``.idx``)."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO
        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
