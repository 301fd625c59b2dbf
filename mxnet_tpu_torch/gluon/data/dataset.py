"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``,
reference ``python/mxnet/gluon/data/dataset.py``)."""
from __future__ import annotations

from ...base import later_slice

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        def first(*items):
            if len(items) == 1:
                return fn(items[0])
            return (fn(items[0]),) + items[1:]
        return self.transform(first, lazy)


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
    """A dataset over one indexable object (a list, an array)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """The zip of arrays or lists of one length (reference
    ``ArrayDataset``)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, \
                "All arrays must have the same length"
            self._data.append(a)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """A dataset over a RecordIO file: with the data slice."""

    def __init__(self, filename):
        raise later_slice("gluon.data.RecordFileDataset", filename)
