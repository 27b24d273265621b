"""Gluon data API (counterpart of mxnet_tpu/gluon/data/; ref:
python/mxnet/gluon/data/__init__.py)."""
from .dataset import (Dataset, ArrayDataset, SimpleDataset,
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,
                      BatchSampler)
from .dataloader import DataLoader
from . import vision

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "vision"]
