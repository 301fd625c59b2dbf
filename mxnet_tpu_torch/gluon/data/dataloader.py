"""DataLoader.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py`` (reference
``python/mxnet/gluon/data/dataloader.py``).  Batches are stacked on the
host by ``batchify_fn`` and handed out as NDArrays on the current
context.  With ``prefetch=N`` a staging thread builds the next N batches
on the host, copies them into pinned memory and from there onto the card
on a side CUDA stream; the consumer's stream waits on the copy's event
before a batch is handed out and every staged tensor is
``record_stream``-ed on it (the pattern of ``io.DevicePrefetchIter``).
``device`` None means ``gpu(0)``, which raises without a card and names
``mx.cpu()``; a CPU device stages nothing.  A worker error surfaces at
``next()``; ``close()`` stops and joins the worker.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ...ndarray import NDArray, array
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference ``default_batchify_fn``)."""
    if isinstance(data[0], NDArray):
        return array(np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    return array(np.asarray(data))


class _Stop:
    pass


class _Raised:
    def __init__(self, exc):
        self.exc = exc


def _device_of(device):
    """The ``torch.device`` batches are staged onto."""
    import torch

    from ...base import resolve_device
    from ...context import Context

    if isinstance(device, Context) or device is None:
        return (device or Context("gpu", 0)).torch_device
    return resolve_device(torch.device(device), "DataLoader")


class _DevicePrefetchingIter:
    """A staging thread over a batch generator: host batches are built on
    the worker (under ``mx.cpu()``), pinned and copied to the card on a
    side stream; ``next()`` makes the consumer's stream wait for the copy
    before it returns the batch."""

    def __init__(self, source, depth, device):
        import torch

        self._device = _device_of(device)
        self._stream = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" else None
        self._queue = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, args=(source,), daemon=True,
            name="mxtpu-gluon-prefetch")
        self._thread.start()

    def _stage(self, item):
        import torch

        if isinstance(item, NDArray):
            t = item._data
            if self._stream is None:
                return t
            with torch.cuda.stream(self._stream):
                return t.pin_memory().to(self._device, non_blocking=True)
        return [self._stage(x) for x in item]

    def _wrap(self, staged):
        from ...context import context_of

        if isinstance(staged, list):
            return [self._wrap(x) for x in staged]
        return NDArray(staged, context_of(staged.device))

    def _worker(self, source):
        import torch

        from ...context import cpu

        try:
            with cpu():
                for batch in source:
                    if self._stop.is_set():
                        return
                    staged = self._stage(batch)
                    event = None
                    if self._stream is not None:
                        event = torch.cuda.Event()
                        event.record(self._stream)
                    self._put((staged, event))
        except Exception as exc:  # surface at the consumer's next()
            self._put(_Raised(exc))
        finally:
            self._put(_Stop)

    def _put(self, item):
        """A bounded put that a close() can always unblock."""
        while True:
            try:
                self._queue.put(item, timeout=0.05)
                return
            except queue.Full:
                if self._stop.is_set():
                    return

    def close(self, timeout=5):
        """Stop the staging worker: raise the stop flag, drain the queue
        so a blocked put exits, and join with ``timeout``."""
        self._stop.set()
        self._closed = True
        t = self._thread
        while t is not None and t.is_alive():
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
            timeout -= 0.05
            if timeout <= 0:
                break
        self._thread = None

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()

    def __iter__(self):
        return self

    def __next__(self):
        import torch

        if self._closed:
            raise StopIteration
        item = self._queue.get()
        if item is _Stop:
            self._closed = True
            raise StopIteration
        if isinstance(item, _Raised):
            raise item.exc
        staged, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in _flat(staged):
                t.record_stream(consumer)
        return self._wrap(staged)


def _flat(staged):
    if isinstance(staged, list):
        return [t for x in staged for t in _flat(x)]
    return [staged]


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, prefetch=0, device=None,
                 seed=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset), seed=seed) \
                    if shuffle else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size/shuffle/sampler/last_batch must not be "
                "specified if batch_sampler is")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        # prefetch=N overlaps batchify and the host-to-card copy of the
        # next N batches with the current step
        self._prefetch = int(prefetch)
        self._device = device

    def _batches(self):
        for batch in self._batch_sampler:
            yield self._batchify_fn([self._dataset[i] for i in batch])

    def __iter__(self):
        if self._prefetch > 0:
            return _DevicePrefetchingIter(self._batches(), self._prefetch,
                                          self._device)
        return self._batches()

    def __len__(self):
        return len(self._batch_sampler)
