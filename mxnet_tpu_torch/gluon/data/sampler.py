"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``,
reference ``python/mxnet/gluon/data/sampler.py``).  ``RandomSampler``
draws from a numpy stream seeded once per instance, so its epoch orders
are the JAX package's, index for index."""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """Shuffled indices from a per-instance seeded stream: the order is
    a pure function of (seed, epoch), never of global-RNG call order."""

    def __init__(self, length, seed=0):
        self._length = length
        self._rng = np.random.RandomState(seed)

    def __iter__(self):
        return iter(self._rng.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Groups a sampler into batches; last_batch in keep/discard/rollover
    (reference ``BatchSampler``)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    "last_batch must be one of keep, discard, or rollover")

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError(
            "last_batch must be one of keep, discard, or rollover")
