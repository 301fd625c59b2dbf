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
thread).  With ``steps_per_call=K`` it packs K consecutive batches into
one ``(K, batch, ...)`` super-batch, staged in one copy, for the
multi-step ``TrainStep``.  A mesh comes with the multi-device slice.

The file readers: ``CSVIter``, ``LibSVMIter`` (its data batches are dense
NDArrays: the port has no CSR storage yet) and ``MNISTIter``; the
wrappers ``ResizeIter`` and the host prefetcher ``PrefetchingIter``.
RecordIO, the image iterators and the data service come with the data
slice.
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
           "ResizeIter", "PrefetchingIter", "DevicePrefetchIter",
           "prefetch_to_device", "CSVIter", "LibSVMIter", "MNISTIter"]


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


class ResizeIter(DataIter):
    """Resize an iterator to ``size`` batches per epoch (reference
    ``ResizeIter``), wrapping around the inner one."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _ThreadedPrefetchTeardown:
    """Drain, stop and join for the queue-and-thread prefetchers
    (:class:`PrefetchingIter`, :class:`DevicePrefetchIter`)."""

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

    def _next_item(self):
        """The next queue item for the consumer: None at the end of the
        stream; a worker error is raised, now and at every later call."""
        if self._worker_error is not None:
            raise self._worker_error
        if self._exhausted:
            return None
        try:
            item = _queue_get_or_die(self._queue, self._thread,
                                     type(self).__name__)
        except MXNetError as e:
            self._worker_error = e
            raise
        if item is None:
            self._exhausted = True
            return None
        if isinstance(item, Exception):
            self._worker_error = item
            raise item
        return item

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


class PrefetchingIter(_ThreadedPrefetchTeardown, DataIter):
    """Background-thread prefetcher over one or more iterators (reference
    ``PrefetchingIter``): the host half of the input pipeline.  Batches
    of several iterators are concatenated; ``rename_data`` and
    ``rename_label`` (one dict per iterator) rename their descriptors."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        iters = iters if isinstance(iters, list) else [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._queue = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = None
        self.current_batch = None
        self._worker_error = None
        self._exhausted = False
        self._start()

    @staticmethod
    def _renamed(renames, descs_of):
        if renames is None:
            return sum(descs_of, [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r, dict) else x for x in descs]
                    for r, descs in zip(renames, descs_of)], [])

    @property
    def provide_data(self):
        return self._renamed(self.rename_data,
                             [i.provide_data for i in self.iters])

    @property
    def provide_label(self):
        return self._renamed(self.rename_label,
                             [i.provide_label for i in self.iters])

    def _worker(self):
        while not self._stop.is_set():
            if _fault_hook("prefetch", self._queue, self._stop):
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
            self._queue.put(batches)

    def _start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mxtpu-prefetch")
        self._thread.start()

    def iter_next(self):
        batches = self._next_item()
        if batches is None:
            return False
        self.current_batch = DataBatch(
            data=sum([b.data for b in batches], []),
            label=sum([(b.label or []) for b in batches], []),
            pad=batches[0].pad, index=batches[0].index)
        return True


def _host_tensor(arr):
    import torch

    return arr._data if isinstance(arr, NDArray) else \
        torch.from_numpy(np.asarray(arr))


class DevicePrefetchIter(_ThreadedPrefetchTeardown, DataIter):
    """Stage host batches onto ``context``'s device ahead of the consumer.

    One staging thread pulls batches from the inner iterator(s), copies
    each array into pinned host memory and from there onto the card on a
    side CUDA stream, and records an event; a batch is handed out only
    after the consumer's current stream has been made to wait on that
    event, and every staged tensor is ``record_stream``-ed on it, so the
    caching allocator never reuses its memory early.  A CPU context
    stages nothing (the batches are already host arrays).

    ``steps_per_call=K`` packs K consecutive batches into one super-batch
    with a leading K axis, stacked on the host and staged in one copy an
    array, for the multi-step ``TrainStep``.  The last ``len(epoch) % K``
    batches of an epoch are dropped, with one warning (a partial pack
    would be a new signature to capture); ``provide_data`` and
    ``provide_label`` keep the per-step shapes.

    Worker errors surface at ``next()`` and at ``close()``; the
    ``device_prefetch`` fault site of ``testing/faults.py`` is in the
    worker loop.  Emitted batches carry ``staged=True``."""

    def __init__(self, iters, prefetch_depth=2, mesh=None, context=None,
                 steps_per_call=1):
        if mesh is not None:
            raise later_slice("DevicePrefetchIter(mesh)", mesh)
        if prefetch_depth < 1:
            raise MXNetError("prefetch_depth must be >= 1")
        if int(steps_per_call) < 1:
            raise MXNetError("steps_per_call must be >= 1")
        iters = iters if isinstance(iters, list) else [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.context = context or cpu()
        self._pack = int(steps_per_call)
        self._warned_drop = False
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
    def _host_slots(self, group, get_arrays, pin):
        """The host tensors of one staged batch: per iterator and array,
        the batch's own tensor, or the K batches' stacked (straight into
        pinned memory when ``pin``)."""
        import torch

        out = []
        for it_idx in range(len(self.iters)):
            for j in range(len(get_arrays(group[0][it_idx]))):
                if self._pack == 1:
                    out.append(_host_tensor(get_arrays(group[0][it_idx])[j]))
                    continue
                parts = [_host_tensor(get_arrays(g[it_idx])[j])
                         for g in group]
                buf = torch.empty((len(parts),) + tuple(parts[0].shape),
                                  dtype=parts[0].dtype, pin_memory=pin)
                out.append(torch.stack(parts, out=buf))
        return out

    def _stage(self, group):
        """``group``: K lists of the iterators' batches -> one staged
        batch and the event its copies recorded (None on the CPU)."""
        import torch

        dev = self.context.torch_device
        pin = dev.type == "cuda"
        data = self._host_slots(group, lambda b: b.data, pin)
        label = self._host_slots(group, lambda b: b.label or [], pin)
        event = None
        if pin:
            with torch.cuda.stream(self._stream):
                # pin_memory() returns a pinned tensor as it is
                moved = [host.pin_memory().to(dev, non_blocking=True)
                         for host in data + label]
                event = torch.cuda.Event()
                event.record(self._stream)
        else:
            moved = data + label
        out = [NDArray(t, self.context) for t in moved]
        first = group[0][0]
        single = self._pack == 1
        batch = DataBatch(data=out[:len(data)], label=out[len(data):],
                          pad=first.pad if single else 0,
                          index=first.index if single else None,
                          bucket_key=first.bucket_key,
                          provide_data=first.provide_data,
                          provide_label=first.provide_label)
        batch.staged = True
        return batch, event

    def _worker(self):
        while not self._stop.is_set():
            if _fault_hook("device_prefetch", self._queue, self._stop):
                return
            group = []
            try:
                for _ in range(self._pack):
                    group.append([i.next() for i in self.iters])
            except StopIteration:
                if group and not self._warned_drop:
                    self._warned_drop = True
                    import logging

                    logging.warning(
                        "DevicePrefetchIter(steps_per_call=%d): dropping "
                        "%d trailing batch(es) that do not fill a pack",
                        self._pack, len(group))
                self._queue.put(None)
                return
            except Exception as exc:  # surface at next()
                if not self._stop.is_set():
                    self._queue.put(exc)
                return
            try:
                staged = self._stage(group)
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

    # -- consumer -----------------------------------------------------------
    def iter_next(self):
        import torch

        t0 = time.perf_counter()
        item = self._next_item()
        if item is None:
            return False
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


def prefetch_to_device(iters, prefetch_depth=2, mesh=None, context=None,
                       steps_per_call=1):
    """Wrap an iterator (or a list of them) in a
    :class:`DevicePrefetchIter`; one that already stages with the same
    pack is returned as it is."""
    if isinstance(iters, DevicePrefetchIter) and \
            iters._pack == int(steps_per_call):
        return iters
    return DevicePrefetchIter(iters, prefetch_depth=prefetch_depth,
                              mesh=mesh, context=context,
                              steps_per_call=steps_per_call)


class CSVIter(NDArrayIter):
    """CSV source (reference ``src/io/iter_csv.cc``), parsed with numpy
    and batched by :class:`NDArrayIter`."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype="float32")
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype="float32")
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[1:] == (1,):
                label = label.ravel()
        super().__init__(data, label, batch_size=batch_size, **kwargs)


class LibSVMIter(DataIter):
    """LibSVM-format source (reference ``src/io/iter_libsvm.cc``): lines
    of ``label idx:val idx:val ...``; ``label_libsvm`` names a separate
    label file.  The tail batch wraps around like NDArrayIter's (``pad``
    rows from the front); ``num_parts``/``part_index`` read one shard.
    The data batches are dense NDArrays of ``(batch_size, ncol)``: the
    JAX package's are CSR, which the port has no storage for yet."""

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, label_shape=None, data_name="data",
                 label_name="softmax_label", part_index=0, num_parts=1,
                 **kwargs):
        super().__init__(batch_size)
        self._data_name = data_name
        self._label_name = label_name
        ncol = int(data_shape[-1] if isinstance(
            data_shape, (tuple, list)) else data_shape)
        vals, cols, indptr, labels = self._parse(data_libsvm)
        if label_libsvm is not None:
            lcol = int(label_shape[-1] if isinstance(
                label_shape, (tuple, list)) else (label_shape or 1))
            lv, lc, lp, _ = self._parse(label_libsvm)
            dense_lab = np.zeros((len(lp) - 1, lcol), "float32")
            for r in range(len(lp) - 1):
                dense_lab[r, lc[lp[r]:lp[r + 1]]] = lv[lp[r]:lp[r + 1]]
            labels = dense_lab.squeeze()
        n = len(indptr) - 1
        if num_parts > 1:
            per = n // num_parts
            lo = part_index * per
            hi = (part_index + 1) * per if part_index < num_parts - 1 \
                else n
            vals, cols, indptr, labels = self._take(
                vals, cols, indptr, labels, range(lo, hi))
            n = len(indptr) - 1
        self._vals, self._cols, self._indptr = vals, cols, indptr
        self._labels = np.asarray(labels, "float32")
        self._ncol = ncol
        self._num = n
        self.reset()

    @staticmethod
    def _parse(path):
        vals, cols, indptr, labels = [], [], [0], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    cols.append(int(i))
                    vals.append(float(v))
                indptr.append(len(cols))
        return (np.asarray(vals, "float32"), np.asarray(cols, "int32"),
                np.asarray(indptr, "int64"), np.asarray(labels, "float32"))

    @staticmethod
    def _take(vals, cols, indptr, labels, rows):
        nv, nc, nptr = [], [], [0]
        for r in rows:
            nv.extend(vals[indptr[r]:indptr[r + 1]])
            nc.extend(cols[indptr[r]:indptr[r + 1]])
            nptr.append(len(nc))
        return (np.asarray(nv, "float32"), np.asarray(nc, "int32"),
                np.asarray(nptr, "int64"), labels[list(rows)])

    @property
    def provide_data(self):
        return [DataDesc(self._data_name, (self.batch_size, self._ncol))]

    @property
    def provide_label(self):
        lshape = (self.batch_size,) + tuple(self._labels.shape[1:])
        return [DataDesc(self._label_name, lshape)]

    def reset(self):
        self._cursor = 0

    def next(self):
        if self._cursor >= self._num:
            raise StopIteration
        rows = [(self._cursor + i) % self._num
                for i in range(self.batch_size)]
        pad = max(0, self._cursor + self.batch_size - self._num)
        vals, cols, indptr, labels = self._take(
            self._vals, self._cols, self._indptr, self._labels, rows)
        dense = np.zeros((self.batch_size, self._ncol), "float32")
        for r in range(self.batch_size):
            dense[r, cols[indptr[r]:indptr[r + 1]]] = \
                vals[indptr[r]:indptr[r + 1]]
        self._cursor += self.batch_size
        return DataBatch(data=[array(dense, ctx=cpu())],
                         label=[array(labels, ctx=cpu())], pad=pad)


class MNISTIter(NDArrayIter):
    """MNIST source (reference ``src/io/iter_mnist.cc``): reads the
    idx-format files (``.gz`` too) at the paths given; pixels scaled to
    [0, 1], images ``(1, 28, 28)`` or flat."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, **kwargs):
        images = _read_idx(image).astype("float32") / 255.0
        labels = _read_idx(label).astype("float32")
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1,
                                    images.shape[1], images.shape[2])
        super().__init__(images, labels, batch_size=batch_size,
                         shuffle=shuffle, **kwargs)


def _read_idx(path):
    import gzip
    import os
    import struct

    opener = gzip.open if path.endswith(".gz") else open
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path, opener = path + ".gz", gzip.open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)
