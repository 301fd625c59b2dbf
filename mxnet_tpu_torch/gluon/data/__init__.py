"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data/``, reference
``python/mxnet/gluon/data/``).  ``vision`` and ``RecordFileDataset``
come with the data slice."""
from .dataset import Dataset, ArrayDataset, SimpleDataset, RecordFileDataset
from .sampler import Sampler, SequentialSampler, RandomSampler, BatchSampler
from .dataloader import DataLoader

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader"]
