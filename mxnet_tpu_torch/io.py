"""Data iterators.

Counterpart of ``mxnet_tpu/io.py`` (reference ``python/mxnet/io.py``) for
what ``Module.fit`` drives: ``DataDesc``, ``DataBatch``, the ``DataIter``
ABC, ``NDArrayIter`` (shuffle with ``seed=``, ``last_batch_handle``) and
the single-device staging prefetcher :class:`DevicePrefetchIter` with
:func:`prefetch_to_device`.

``NDArrayIter`` hands out host (CPU) NDArrays: a batch is host data until
something places it.  ``DevicePrefetchIter`` is that something: one
staging thread copies each host batch into pinned memory and onto the
card on a side CUDA stream, and records an event that the consumer's
stream waits on, so batch n+1 moves while batch n's step runs (the JAX
package's ``device_put`` plus ``block_until_ready`` on its staging
thread).  A mesh and ``steps_per_call > 1`` come with later slices.  The
readers of the rest of the reference's ``io.py`` (CSV, MNIST, RecordIO,
the data service) come with the data slice.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import namedtuple

import numpy as np

from .base import MXNetError, later_slice
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "DevicePrefetchIter", "prefetch_to_device"]


def _queue_get_or_die(q, thread, what, poll_s=0.2):
    """``queue.get`` that survives worker death: while the queue stays
    empty, check that the worker lives, and raise the moment it does not
    (after one last drain for the put-then-exit race)."""
    while True:
        try:
            return q.get(timeout=poll_s)
        except queue.Empty:
            if thread is None or not thread.is_alive():
                try:
                    return q.get_nowait()
                except queue.Empty:
                    raise MXNetError(
                        "%s worker thread died without delivering a "
                        "batch, an error, or end-of-data; the input "
                        "pipeline is broken (worker crashed or was "
                        "killed)" % what) from None


def _fault_hook(site, out_queue, stop_event):
    """Fault-injection hook of a worker loop.  True when the worker must
    die: silently for an injected ``kill`` (the consumer's dead-worker
    check is what is under test), through the queue for ``raise``."""
    from .testing import faults

    try:
        faults.inject(site)
    except faults.WorkerKilled:
        return True
    except Exception as exc:
        if not stop_event.is_set():
            out_queue.put(exc)
        return True
    return False


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Data description (reference ``DataDesc``: name, shape, dtype,
    layout)."""

    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), np.dtype(dtype),
                               layout)

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One batch (reference ``DataBatch``: data/label lists, pad, index)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator ABC (reference ``io.py:175``)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """Normalize data/label inputs to a list of (name, numpy array)
    (reference ``io.py`` ``_init_data``)."""
    if data is None:
        if not allow_empty:
            raise MXNetError("NDArrayIter: data must be given")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise MXNetError("NDArrayIter: data must not be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays with shuffle/pad semantics
    (reference ``NDArrayIter``, ``io.py:514``).  ``seed`` gives the
    shuffle a private RNG, so the order is a pure function of (seed,
    reset count).  Batches are CPU NDArrays."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if self.num_data < batch_size:
            raise MXNetError("batch_size needs to be smaller than data size.")
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError("last_batch_handle %r: want pad, discard or "
                             "roll_over" % (last_batch_handle,))
        self.idx = np.arange(self.num_data)
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed) if seed is not None \
            else np.random
        self._seed = seed
        self.last_batch_handle = last_batch_handle
        if last_batch_handle == "discard":
            self.num_data = (self.num_data // batch_size) * batch_size
        self.cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.shuffle:
            self._rng.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data)
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        sel = self.idx[self.cursor:self.cursor + self.batch_size]
        if len(sel) < self.batch_size:  # pad: wrap around
            sel = np.concatenate([sel, self.idx[:self.batch_size - len(sel)]])
        return [array(x[1][sel], ctx=cpu()) for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class DevicePrefetchIter(DataIter):
    """Stage host batches onto ``context``'s device ahead of the consumer.

    One staging thread pulls batches from the inner iterator(s), copies
    each array into pinned host memory and from there onto the card on a
    side CUDA stream, and records an event; a batch is handed out only
    after the consumer's current stream has been made to wait on that
    event, and every staged tensor is ``record_stream``-ed on it, so the
    caching allocator never reuses its memory early.  A CPU context
    stages nothing (the batches are already host arrays).  Worker errors
    surface at ``next()`` and at ``close()``; the ``device_prefetch``
    fault site of ``testing/faults.py`` is in the worker loop.  Emitted
    batches carry ``staged=True``."""

    def __init__(self, iters, prefetch_depth=2, mesh=None, context=None,
                 steps_per_call=1):
        if mesh is not None:
            raise later_slice("DevicePrefetchIter(mesh)", mesh)
        if int(steps_per_call) != 1:
            raise later_slice("steps_per_call", steps_per_call)
        if prefetch_depth < 1:
            raise MXNetError("prefetch_depth must be >= 1")
        iters = iters if isinstance(iters, list) else [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.context = context or cpu()
        self._queue = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = None
        self.current_batch = None
        self._worker_error = None
        self._exhausted = False
        # consumer-side wait on the ring, for input-bound attribution
        self.stage_wait_s = 0.0
        self.batches_delivered = 0
        self._start()

    @property
    def provide_data(self):
        return sum([i.provide_data for i in self.iters], [])

    @property
    def provide_label(self):
        return sum([i.provide_label for i in self.iters], [])

    # -- staging (worker thread) ------------------------------------------
    def _stage(self, batches):
        import torch

        dev = self.context.torch_device
        data = sum([list(b.data) for b in batches], [])
        label = sum([list(b.label or []) for b in batches], [])
        event = None
        if dev.type == "cuda":
            stream = self._stream
            with torch.cuda.stream(stream):
                moved = []
                for arr in data + label:
                    host = arr._data if isinstance(arr, NDArray) else \
                        torch.from_numpy(np.asarray(arr))
                    host = host.pin_memory()
                    moved.append(host.to(dev, non_blocking=True))
                event = torch.cuda.Event()
                event.record(stream)
        else:
            moved = [arr._data if isinstance(arr, NDArray)
                     else torch.from_numpy(np.asarray(arr))
                     for arr in data + label]
        out = [NDArray(t, self.context) for t in moved]
        first = batches[0]
        batch = DataBatch(data=out[:len(data)], label=out[len(data):],
                          pad=first.pad, index=first.index,
                          bucket_key=first.bucket_key,
                          provide_data=first.provide_data,
                          provide_label=first.provide_label)
        batch.staged = True
        return batch, event

    def _worker(self):
        while not self._stop.is_set():
            if _fault_hook("device_prefetch", self._queue, self._stop):
                return
            try:
                batches = [i.next() for i in self.iters]
            except StopIteration:
                self._queue.put(None)
                return
            except Exception as exc:  # surface at next()
                if not self._stop.is_set():
                    self._queue.put(exc)
                return
            try:
                staged = self._stage(batches)
            except Exception as exc:
                if not self._stop.is_set():
                    self._queue.put(exc)
                return
            self._queue.put(staged)

    def _start(self):
        import torch

        self._stream = None
        if self.context.torch_device.type == "cuda":
            self._stream = torch.cuda.Stream(self.context.torch_device)
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mxtpu-device-prefetch")
        self._thread.start()

    # -- teardown ---------------------------------------------------------
    def _drain(self, capture_error=False):
        pending = None
        try:
            while True:
                item = self._queue.get_nowait()
                if capture_error and pending is None and \
                        isinstance(item, Exception):
                    pending = item
        except queue.Empty:
            pass
        return pending

    def _halt(self):
        """Stop the worker without restarting it; drain before and after
        the join so no stale batch survives into a restarted stream."""
        self._stop.set()
        self._drain()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._drain()
        self._worker_error = None
        self._exhausted = False

    def close(self, timeout=5):
        """Stop the worker without restarting it and re-raise any worker
        error the consumer never saw.  After ``close`` the iterator
        reports exhaustion until ``reset``."""
        self._stop.set()
        pending = self._drain(capture_error=True)
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                import logging

                logging.warning("%s worker did not exit within %ss on "
                                "close()", type(self).__name__, timeout)
            self._thread = None
        pending = pending or self._drain(capture_error=True)
        self._exhausted = True
        if pending is not None and pending is not self._worker_error:
            self._worker_error = pending
            raise pending

    def reset(self):
        self._halt()
        for i in self.iters:
            i.reset()
        self._start()

    # -- consumer -----------------------------------------------------------
    def iter_next(self):
        import torch

        if self._worker_error is not None:
            raise self._worker_error
        if self._exhausted:
            return False
        t0 = time.perf_counter()
        try:
            item = _queue_get_or_die(self._queue, self._thread,
                                     "DevicePrefetchIter")
        except MXNetError as e:
            self._worker_error = e
            raise
        if item is None:
            self._exhausted = True
            return False
        if isinstance(item, Exception):
            self._worker_error = item
            raise item
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.context.torch_device)
            consumer.wait_event(event)
            for arr in batch.data + batch.label:
                arr._data.record_stream(consumer)
        self.stage_wait_s += time.perf_counter() - t0
        self.batches_delivered += 1
        self.current_batch = batch
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()


def prefetch_to_device(iters, prefetch_depth=2, mesh=None, context=None,
                       steps_per_call=1):
    """Wrap an iterator (or a list of them) in a
    :class:`DevicePrefetchIter`; one that already stages is returned as
    it is."""
    if isinstance(iters, DevicePrefetchIter):
        return iters
    return DevicePrefetchIter(iters, prefetch_depth=prefetch_depth,
                              mesh=mesh, context=context,
                              steps_per_call=steps_per_call)
