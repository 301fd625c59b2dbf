"""Checkpoints: atomic, sharded and checksummed snapshots, asynchronous
writes, restore from any shard layout.

Counterpart of ``mxnet_tpu/checkpoint.py``, writing the same on-disk
format, so a directory written by either package loads in the other:

* **Atomicity** — every file is written under a temp name and published
  with ``os.replace`` (:func:`atomic_replace`); the fault site
  ``checkpoint_io`` fires between the two.
* **v2 format** — ``prefix-NNNN.shard<R>.params`` (an ``.npz`` of
  pieces), a per-rank sidecar ``prefix-NNNN.shard<R>.json`` (SHA-256,
  bytes, each piece's parameter and index window) and, written LAST,
  ``prefix-NNNN.manifest.json`` (global shapes and dtype names, the
  merged sidecars, the step metadata).  ``MXNET_CKPT_FORMAT=1`` writes
  the legacy ``prefix-NNNN.params`` + ``.meta.json`` pair instead.
* **Extension dtypes without ml_dtypes** — numpy has no bfloat16 or
  float8, and the card's machine has no ``ml_dtypes``.  A bf16 or e4m3
  tensor is written as raw same-width bytes (a void array, as the JAX
  package's files hold it) and read back from the manifest's dtype
  name by reinterpreting the bytes as an integer view and then
  ``torch.bfloat16`` / ``torch.float8_*``; no value is ever cast, so
  the bytes round-trip equal both ways.
* **Verified loads + quarantine** — ``load()`` re-hashes every shard
  (``MXNET_CKPT_VERIFY``, default on); a truncated or bit-flipped shard
  quarantines the epoch (every file renamed ``*.corrupt``) and the load
  falls back to the previous good epoch.  :meth:`CheckpointManager.
  fsck` audits a directory offline.
* **Any shard layout** — pieces carry index windows, so a manifest
  written by an N-process run assembles into whole tensors here
  (:func:`assemble_pieces`), placed on the caller's device (default:
  the card).
* **Async writes** — ``MXNET_CKPT_ASYNC=1`` or ``async_writes=True``:
  the device-to-host snapshot runs on the calling thread, serialisation
  and publish on a ``mxtpu-ckpt-writer`` thread (depth 1); a writer's
  error surfaces at the next ``save()``/``flush()``.
* **Retention** — ``keep=N`` keeps the newest N certified epochs,
  never counting quarantined ones and never collecting the epoch a
  load just pinned.

This slice writes and reads as one process.  A kvstore, the
coordinator env (``MXNET_COORDINATOR``/``MXNET_NUM_WORKERS``), and
``mesh=``, ``sharding=``, ``zero_states=``, ``zero_params=`` and
``plan=`` raise :func:`~mxnet_tpu_torch.base.later_slice`: the
multi-device layer is ROADMAP queue 1 step 8.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import threading

import numpy as np

from .base import MXNetError, get_env, later_slice, logger, \
    resolve_device

__all__ = ["atomic_replace", "assemble_pieces", "CheckpointManager",
           "CheckpointState", "CorruptCheckpoint", "resolve_resume"]


class CorruptCheckpoint(MXNetError):
    """A checkpoint epoch failed checksum/coverage verification (it has
    been quarantined on disk as ``*.corrupt``)."""


def atomic_replace(path, write_cb):
    """Write ``path`` atomically: ``write_cb(tmp_path)`` writes under a
    temp name (returning the path it actually wrote, for writers that
    append a suffix), then one ``os.replace`` publishes it.  On any
    failure the temp file is removed and ``path`` is untouched.  Fault
    site ``checkpoint_io`` fires between write and publish."""
    from .testing import faults

    tmp = "%s.tmp-%d" % (path, os.getpid())
    actual = None
    try:
        actual = write_cb(tmp) or tmp
        faults.inject("checkpoint_io")
        os.replace(actual, path)
    except BaseException:
        for leftover in {tmp, actual}:
            if leftover and os.path.exists(leftover):
                try:
                    os.remove(leftover)
                except OSError:
                    pass
        raise
    return path


# dtypes numpy holds natively; every other name (bfloat16, float8_*) is
# an extension dtype, crossing numpy as raw bytes whether or not some
# other library registered it with numpy in this process
_NATIVE = frozenset(["bool", "int8", "uint8", "int16", "uint16", "int32",
                     "uint32", "int64", "uint64", "float16", "float32",
                     "float64", "complex64", "complex128"])


def _np_dtype(name):
    """``np.dtype`` for a manifest dtype name, or None for an extension
    dtype (read through :func:`_torch_dtype` instead)."""
    return np.dtype(name) if str(name) in _NATIVE else None


def _torch_dtype(name):
    """The torch dtype of a manifest dtype name (``"float32"``,
    ``"bfloat16"``, ``"float8_e4m3fn"``, ...)."""
    import torch

    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise MXNetError("checkpoint dtype %r has no torch counterpart"
                         % (name,))
    return dt


# integer views of the same width: how extension dtypes cross numpy
_INT_OF_SIZE = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def _to_host(value):
    """A value to save as ``(numpy array for npz, dtype name)``.
    Tensors leave the device here (the snapshot); a dtype numpy cannot
    hold goes as raw void bytes of its width, the layout the JAX
    package's ``np.savez`` gives an ``ml_dtypes`` array."""
    import torch

    value = getattr(value, "_data", value)
    if not torch.is_tensor(value):
        arr = np.asarray(value)
        return arr, str(arr.dtype)
    t = value.detach()
    # numpy's dtype name, which torch's matches once its prefix is
    # dropped (the JAX package writes str(np.dtype(...)))
    name = str(t.dtype).replace("torch.", "")
    if _np_dtype(name) is not None:
        return t.cpu().contiguous().numpy(), name
    width = t.element_size()
    ints = t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}[width])
    return ints.cpu().numpy().view("V%d" % width), name


def _piece_tensor(piece, name):
    """One piece (numpy, possibly void bytes) as a CPU tensor of the
    manifest dtype ``name``: standard dtypes convert, extension dtypes
    are reinterpreted through a same-width integer view (never cast)."""
    import torch

    want = _torch_dtype(name)
    piece = np.asarray(piece)
    np_want = _np_dtype(name)
    if np_want is not None:
        if piece.dtype != np_want:
            if piece.dtype.itemsize != np_want.itemsize:
                raise MXNetError("checkpoint piece of dtype %s cannot hold "
                                 "%s" % (piece.dtype, name))
            piece = piece.view(np_want)
        return torch.from_numpy(np.ascontiguousarray(piece))
    width = torch.empty((), dtype=want).element_size()
    if piece.dtype.itemsize != width:
        raise MXNetError("checkpoint piece of dtype %s (%d bytes) cannot "
                         "hold %s (%d bytes)"
                         % (piece.dtype, piece.dtype.itemsize, name, width))
    ints = np.ascontiguousarray(piece).view(_INT_OF_SIZE[width])
    return torch.from_numpy(ints).view(want)


def _sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def assemble_pieces(pieces, params_meta, arrays=None):
    """Merge piece windows into whole CPU tensors.

    ``pieces`` iterates ``(key, index_windows_or_None, piece)`` triples:
    ``index_windows`` is a ``[[start, stop], ...]`` window per
    dimension, or ``None`` for a whole-array piece.  ``params_meta``
    maps each key to its global ``{"shape", "dtype"}``.  Pass ``arrays``
    to accumulate across calls (one per shard file); a whole piece
    replaces an earlier entry, and windowed pieces write into a zeroed
    tensor of the global shape."""
    import torch

    arrays = {} if arrays is None else arrays
    for key, idx, piece in pieces:
        meta = params_meta[key]
        piece = _piece_tensor(piece, meta["dtype"])
        if idx is None:
            arrays[key] = piece
            continue
        dst = arrays.get(key)
        if dst is None:
            dst = torch.zeros(tuple(int(s) for s in meta["shape"]),
                              dtype=piece.dtype)
            arrays[key] = dst
        dst[tuple(slice(int(a), int(b)) for a, b in idx)] = piece
    return arrays


class CheckpointState:
    """Everything a resume needs: the position, the symbol, and the
    parameters as NDArrays over whole tensors on the load's device."""

    def __init__(self, epoch, nbatch, num_update, symbol, arg_params,
                 aux_params, states_path=None, prefix=None, manifest=None,
                 opt_states=None, hstate=None):
        self.epoch = int(epoch)          # completed epochs
        self.nbatch = int(nbatch)        # extra batches into epoch `epoch`
        self.num_update = int(num_update)
        self.symbol = symbol
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.states_path = states_path   # optimizer states file, or None
        self.prefix = prefix
        self.manifest = manifest         # v2 manifest dict, or None (v1)
        self.opt_states = opt_states     # ZeRO states: a later slice
        # the fused step's carried health state (loss scale, its streak,
        # the fp8 amax history) as lists, or None
        self.hstate = hstate

    def __repr__(self):
        return ("CheckpointState(epoch=%d, nbatch=%d, num_update=%d, "
                "states=%r)" % (self.epoch, self.nbatch, self.num_update,
                                self.states_path))


def _single_process():
    """This slice writes as one process: the coordinator env names a
    multi-process run, whose rank and barrier paths come with the
    multi-device layer."""
    for var in ("MXNET_COORDINATOR", "MXNET_NUM_WORKERS"):
        if os.environ.get(var):
            raise later_slice(var, os.environ[var])


class CheckpointManager:
    """Atomic, shard-verified checkpoint store over a directory.

    ``keep=N`` retains only the newest N epochs;
    ``save_optimizer_states=False`` drops the states file;
    ``async_writes``/``verify`` override ``MXNET_CKPT_ASYNC``/
    ``MXNET_CKPT_VERIFY`` (None: read the env).  ``kvstore`` (the JAX
    package's rank and barrier source) is a later slice."""

    def __init__(self, directory, prefix="model", keep=None, kvstore=None,
                 save_optimizer_states=True, async_writes=None, verify=None):
        if keep is not None and int(keep) < 1:
            raise MXNetError("CheckpointManager keep must be >= 1 or None "
                             "(got %r)" % (keep,))
        if kvstore is not None:
            raise later_slice("kvstore", kvstore)
        self.directory = str(directory)
        self.prefix_name = prefix
        self.keep = None if keep is None else int(keep)
        self.save_optimizer_states = save_optimizer_states
        self.async_writes = bool(get_env("MXNET_CKPT_ASYNC", False, bool)) \
            if async_writes is None else bool(async_writes)
        self.verify = bool(get_env("MXNET_CKPT_VERIFY", True, bool)) \
            if verify is None else bool(verify)
        self._writer = None        # in-flight async write (depth 1)
        self._writer_error = None  # surfaced at the next save()/flush()
        self._pinned_epoch = None  # epoch a load pinned; GC-exempt

    @property
    def prefix(self):
        return os.path.join(self.directory, self.prefix_name)

    # -- paths ----------------------------------------------------------
    def _params_path(self, epoch):
        return "%s-%04d.params" % (self.prefix, epoch)

    def _states_path(self, epoch):
        return "%s-%04d.states" % (self.prefix, epoch)

    def _meta_path(self, epoch):
        return "%s-%04d.meta.json" % (self.prefix, epoch)

    def _manifest_path(self, epoch):
        return "%s-%04d.manifest.json" % (self.prefix, epoch)

    def _shard_path(self, epoch, rank):
        return "%s-%04d.shard%d.params" % (self.prefix, epoch, rank)

    def _sidecar_path(self, epoch, rank):
        return "%s-%04d.shard%d.json" % (self.prefix, epoch, rank)

    def _epoch_tag(self, epoch):
        return "%s-%04d." % (self.prefix_name, epoch)

    # -- save -----------------------------------------------------------
    def save(self, module=None, epoch=0, nbatch=0, symbol=None,
             arg_params=None, aux_params=None, zero_states=None,
             zero_params=None, num_update=None, plan=None):
        """Write one checkpoint.  Pass a bound ``module`` (params, aux,
        symbol and optimizer states are pulled from it) or explicit
        ``symbol``/``arg_params``/``aux_params`` (NDArrays, tensors or
        numpy arrays).  ``epoch`` counts completed epochs; ``nbatch > 0``
        marks a mid-epoch position.  Returns the epoch tag.

        With async writes on, only the device-to-host snapshot happens on
        this thread.  A failure of the previous async write is raised
        here, before the new snapshot is taken."""
        for name, value in (("zero_states", zero_states),
                            ("zero_params", zero_params), ("plan", plan)):
            if value is not None:
                raise later_slice(name, value)
        _single_process()
        self._raise_writer_error()

        epoch = int(epoch)
        if module is not None:
            if symbol is None:
                symbol = module.symbol
            if arg_params is None:
                arg_params, aux_params = module.get_params()
        if arg_params is None:
            raise MXNetError("CheckpointManager.save needs a module or "
                             "explicit arg_params")
        aux_params = aux_params or {}

        if int(get_env("MXNET_CKPT_FORMAT", 2, int)) < 2:
            return self._save_v1(module, epoch, nbatch, symbol,
                                 arg_params, aux_params)
        os.makedirs(self.directory, exist_ok=True)
        snap = self._snapshot(module, epoch, nbatch, symbol, arg_params,
                              aux_params, num_update)
        if self.async_writes:
            self._join_writer()  # depth 1: one write in flight
            t = threading.Thread(target=self._commit_guarded, args=(snap,),
                                 name="mxtpu-ckpt-writer", daemon=True)
            self._writer = t
            t.start()
        else:
            self._commit(snap)
        return epoch

    def _snapshot(self, module, epoch, nbatch, symbol, arg_params,
                  aux_params, num_update):
        """Device-to-host snapshot, on the calling thread: after this
        returns the caller may change its tensors freely.  One process
        owns every parameter whole (rank 0, no index window)."""
        params_meta, pieces, piece_map = {}, {}, {}
        for tag, params in (("arg", arg_params), ("aux", aux_params)):
            for name, value in params.items():
                key = "%s:%s" % (tag, name)
                arr, dtype = _to_host(value)
                params_meta[key] = {"shape": [int(s) for s in arr.shape],
                                    "dtype": dtype, "spec": None}
                pieces[key + "/0"] = arr
                piece_map[key + "/0"] = {"param": key, "index": None}
        states = None
        if self.save_optimizer_states and module is not None and \
                getattr(module, "optimizer_initialized", False):
            states = _states_blob(module)
        if num_update is None:
            opt = getattr(module, "_optimizer", None) \
                if module is not None else None
            num_update = int(getattr(opt, "num_update", 0) or 0)
        return {"epoch": epoch, "nbatch": int(nbatch),
                "hstate": _module_hstate(module),
                "num_update": int(num_update),
                "symbol_json": symbol.tojson() if symbol is not None
                else None,
                "rank": 0, "nproc": 1,
                "params_meta": params_meta, "pieces": pieces,
                "piece_map": piece_map, "states": states}

    def _commit_guarded(self, snap):
        try:
            self._commit(snap)
        except BaseException as e:  # surfaced at the next save()/flush()
            self._writer_error = e
            logger.error("async checkpoint write for epoch %d failed: %s",
                         snap["epoch"], e)

    def _commit(self, snap):
        """Serialise and publish one snapshot: the shard, its sidecar,
        the symbol and states, then the manifest LAST — its presence
        certifies the set, so a crash anywhere earlier leaves the
        previous epoch as ``latest()``."""
        from .testing import faults

        epoch = snap["epoch"]
        sidecar = {"rank": snap["rank"], "file": None, "sha256": None,
                   "bytes": 0, "pieces": {}}
        if snap["pieces"]:
            shard_path = self._shard_path(epoch, snap["rank"])
            digest = {}

            def _write(tmp):
                with open(tmp, "wb") as f:
                    np.savez(f, **snap["pieces"])
                    f.flush()
                    os.fsync(f.fileno())
                digest["sha256"] = _sha256_file(tmp)
                digest["bytes"] = os.path.getsize(tmp)
                faults.inject("shard_write")
                return tmp

            atomic_replace(shard_path, _write)
            # post-publish corruption hook (bitflip/truncate)
            faults.inject("checkpoint_corrupt", path=shard_path)
            sidecar = {"rank": snap["rank"],
                       "file": os.path.basename(shard_path),
                       "sha256": digest["sha256"],
                       "bytes": digest["bytes"],
                       "pieces": snap["piece_map"]}
        atomic_replace(self._sidecar_path(epoch, snap["rank"]),
                       lambda tmp: _write_json(tmp, sidecar))
        if snap["symbol_json"] is not None:
            atomic_replace(
                "%s-symbol.json" % self.prefix,
                lambda tmp: _write_text(tmp, snap["symbol_json"]))
        states_entry = None
        if snap["states"] is not None:
            spath = self._states_path(epoch)
            atomic_replace(spath,
                           lambda tmp: _write_bytes(tmp, snap["states"]))
            states_entry = {
                "file": os.path.basename(spath),
                "sha256": hashlib.sha256(snap["states"]).hexdigest(),
                "bytes": len(snap["states"])}
        manifest = {
            "format": 2, "epoch": epoch, "nbatch": snap["nbatch"],
            "num_update": snap["num_update"],
            "have_states": states_entry is not None,
            "num_processes": snap["nproc"],
            "params": snap["params_meta"],
            "shards": self._merge_sidecars(epoch, snap["nproc"]),
            "states": states_entry,
            "zero_states": None, "zero_params": None, "plan": None}
        if snap.get("hstate") is not None:
            manifest["hstate"] = snap["hstate"]
        atomic_replace(self._manifest_path(epoch),
                       lambda tmp: _write_json(tmp, manifest))
        self._gc()

    def _merge_sidecars(self, epoch, nproc):
        """Merge the sidecars of ranks ``< nproc`` for ``epoch``.  Shard
        files and sidecars an earlier save of the same epoch tag left
        under a larger topology are deleted before the manifest
        publishes: merged, their stale windows would shadow the new
        data."""
        pat = re.compile(re.escape(self.prefix_name) +
                         r"-%04d\.shard(\d+)\.(json|params)$" % epoch)
        entries = []
        for name in sorted(os.listdir(self.directory)):
            m = pat.match(name)
            if m:
                entries.append((name, int(m.group(1)), m.group(2)))
        sidecars = []
        for name, rank, kind in entries:
            if kind != "json" or rank >= nproc:
                continue
            with open(os.path.join(self.directory, name)) as f:
                sidecars.append(json.load(f))
        sidecars.sort(key=lambda s: int(s.get("rank", 0)))
        merged = [s for s in sidecars if s.get("file")]
        live = set(s["file"] for s in merged)
        live.update(name for name, rank, kind in entries
                    if kind == "json" and rank < nproc)
        stale = [name for name, rank, kind in entries if name not in live]
        for name in stale:
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                pass
        if stale:
            logger.warning(
                "checkpoint epoch %d: removed %d stale shard file(s) left "
                "by an earlier save of the same tag (current topology: %d "
                "writer(s)): %s", epoch, len(stale), nproc, stale)
        return merged

    # -- legacy v1 writes -----------------------------------------------
    def _save_v1(self, module, epoch, nbatch, symbol, arg_params,
                 aux_params):
        from . import model as model_mod

        os.makedirs(self.directory, exist_ok=True)
        model_mod.save_checkpoint(self.prefix, epoch, symbol,
                                  _as_ndarrays(arg_params),
                                  _as_ndarrays(aux_params))
        have_states = False
        if self.save_optimizer_states and module is not None and \
                getattr(module, "optimizer_initialized", False):
            blob = _states_blob(module)
            atomic_replace(self._states_path(epoch),
                           lambda tmp: _write_bytes(tmp, blob))
            have_states = True
        opt = getattr(module, "_optimizer", None) \
            if module is not None else None
        meta = {"epoch": epoch, "nbatch": int(nbatch),
                "num_update": int(getattr(opt, "num_update", 0) or 0),
                "have_states": have_states}
        hstate = _module_hstate(module)
        if hstate is not None:
            meta["hstate"] = hstate
        # meta goes LAST: its presence certifies the set
        atomic_replace(self._meta_path(epoch),
                       lambda tmp: _write_json(tmp, meta))
        self._gc()
        return epoch

    # -- async plumbing -------------------------------------------------
    def _join_writer(self):
        t = self._writer
        if t is not None and t is not threading.current_thread():
            timeout = get_env("MXNET_CKPT_JOIN_TIMEOUT_S", 600.0, float)
            t.join(timeout=timeout if timeout and timeout > 0 else None)
            if t.is_alive():
                # keep the ref: a later flush() re-waits instead of
                # orphaning the write and losing its error
                raise MXNetError(
                    "async checkpoint writer %r did not finish within "
                    "%.0fs (MXNET_CKPT_JOIN_TIMEOUT_S) — a disk wedge; "
                    "the write is still in flight, flush() again to "
                    "re-wait" % (t.name, timeout))
        self._writer = None

    def _raise_writer_error(self):
        self._join_writer()
        err = self._writer_error
        if err is not None:
            self._writer_error = None
            raise err

    def flush(self):
        """Join any in-flight async write and raise its error, if any."""
        self._raise_writer_error()

    # -- discovery / load ----------------------------------------------
    def epochs(self):
        """Sorted epoch tags with a certified set on disk — a v2
        manifest or a v1 params file; quarantined epochs never appear."""
        pat = re.compile(re.escape(self.prefix_name) +
                         r"-(\d{4})\.(params|manifest\.json)$")
        found = set()
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            m = pat.match(name)
            if m:
                found.add(int(m.group(1)))
        return sorted(found)

    def latest(self):
        """Newest resumable epoch tag, or None."""
        eps = self.epochs()
        return eps[-1] if eps else None

    def load(self, epoch=None, mesh=None, sharding=None, device=None):
        """Load a checkpoint into a :class:`CheckpointState` whose
        parameters are whole tensors on ``device`` (default: the card;
        pass ``device="cpu"`` without one).

        ``epoch=None`` loads the newest epoch, falling back past any
        epoch that fails verification (quarantining it); an explicit
        ``epoch`` that fails is quarantined and raises
        :class:`CorruptCheckpoint`.  ``mesh``/``sharding`` (a restore
        onto several devices) are a later slice."""
        if mesh is not None:
            raise later_slice("mesh", mesh)
        if sharding is not None:
            raise later_slice("sharding", sharding)
        device = resolve_device(device, "CheckpointManager.load")
        self._join_writer()
        if epoch is not None:
            state = self._load_epoch(int(epoch), device)
            self._pinned_epoch = state.epoch
            return state
        failures = []
        for e in reversed(self.epochs()):
            try:
                state = self._load_epoch(e, device)
                if failures:
                    logger.warning(
                        "checkpoint fallback: loaded epoch %d after "
                        "quarantining %s", e,
                        ", ".join("%d (%s)" % f for f in failures))
                self._pinned_epoch = state.epoch
                return state
            except CorruptCheckpoint as err:
                failures.append((e, str(err).splitlines()[0][:120]))
                continue
        if failures:
            raise MXNetError(
                "no loadable checkpoint under %r (prefix %r): every "
                "candidate failed verification and was quarantined: %s"
                % (self.directory, self.prefix_name,
                   "; ".join("epoch %d: %s" % f for f in failures)))
        raise MXNetError("no checkpoint found under %r (prefix %r)"
                         % (self.directory, self.prefix_name))

    def _load_epoch(self, epoch, device):
        from .ndarray import NDArray

        if not os.path.exists(self._manifest_path(epoch)):
            return self._load_v1(epoch, device)
        manifest = self._read_manifest(epoch)
        if self.verify:
            problems = self._verify_epoch(manifest)
            if problems:
                self._quarantine(epoch, problems)
                raise CorruptCheckpoint(
                    "checkpoint epoch %d under %r failed verification "
                    "(quarantined as *.corrupt): %s"
                    % (epoch, self.prefix, "; ".join(problems)))
        if manifest.get("zero_states") or manifest.get("zero_params"):
            raise later_slice("zero_states", "a ZeRO checkpoint")
        arrays = self._assemble(manifest)
        arg_params, aux_params = {}, {}
        for key, t in arrays.items():
            tag, name = key.split(":", 1)
            if tag == "opt":
                continue
            (arg_params if tag == "arg" else aux_params)[name] = \
                NDArray(t.to(device))
        symbol = self._load_symbol()
        states = self._states_path(epoch)
        return CheckpointState(
            epoch=manifest.get("epoch", epoch),
            nbatch=manifest.get("nbatch", 0),
            num_update=manifest.get("num_update", 0), symbol=symbol,
            arg_params=arg_params, aux_params=aux_params,
            states_path=states if os.path.exists(states) else None,
            prefix=self.prefix, manifest=manifest,
            hstate=manifest.get("hstate"))

    def _load_symbol(self):
        path = "%s-symbol.json" % self.prefix
        if not os.path.exists(path):
            return None
        from . import symbol as sym_mod

        return sym_mod.load(path)

    def _load_v1(self, epoch, device):
        from . import model as model_mod
        from .context import context_of

        with context_of(device):
            symbol, arg_params, aux_params = model_mod.load_checkpoint(
                self.prefix, epoch)
        meta = self._read_meta(epoch)
        states = self._states_path(epoch)
        return CheckpointState(
            epoch=meta.get("epoch", epoch), nbatch=meta.get("nbatch", 0),
            num_update=meta.get("num_update", 0), symbol=symbol,
            arg_params=arg_params, aux_params=aux_params,
            states_path=states if os.path.exists(states) else None,
            prefix=self.prefix, hstate=meta.get("hstate"))

    def _read_manifest(self, epoch):
        path = self._manifest_path(epoch)
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            self._quarantine(epoch, ["unreadable manifest: %s" % e])
            raise CorruptCheckpoint(
                "checkpoint manifest %r is corrupt (epoch quarantined): %s"
                % (path, e)) from e

    # -- verification / quarantine --------------------------------------
    def _verify_epoch(self, manifest):
        """Checksum + coverage audit of one v2 epoch: a list of problem
        strings (empty = healthy)."""
        problems = []
        blobs = list(manifest.get("shards") or [])
        if manifest.get("states"):
            blobs.append(manifest["states"])
        for entry in blobs:
            path = os.path.join(self.directory, entry["file"])
            if not os.path.exists(path):
                problems.append("missing file %s" % entry["file"])
                continue
            size = os.path.getsize(path)
            if size != entry["bytes"]:
                problems.append("%s truncated: %d bytes, manifest says %d"
                                % (entry["file"], size, entry["bytes"]))
                continue
            if _sha256_file(path) != entry["sha256"]:
                problems.append("%s checksum mismatch (bit rot or torn "
                                "write)" % entry["file"])
        # coverage: the pieces across all shards must tile each param
        covered = {}
        for shard in manifest.get("shards") or []:
            for info in (shard.get("pieces") or {}).values():
                key, idx = info["param"], info["index"]
                meta = manifest["params"].get(key)
                if meta is None:
                    problems.append("shard piece for unknown param %r"
                                    % key)
                    continue
                if idx is None:
                    n = int(np.prod([int(d) for d in meta["shape"]]))
                else:
                    n = 1
                    for start, stop in idx:
                        n *= max(0, int(stop) - int(start))
                covered[key] = covered.get(key, 0) + n
        for key, meta in (manifest.get("params") or {}).items():
            total = int(np.prod([int(d) for d in meta["shape"]]))
            n = covered.get(key, 0)
            if n < total:
                problems.append(
                    "param %s incomplete: %d of %d elements present"
                    % (key, n, total))
            elif n > total:
                problems.append(
                    "param %s over-covered: %d elements for %d (stale or "
                    "overlapping shard pieces)" % (key, n, total))
        return problems

    def _quarantine(self, epoch, problems):
        """Rename every file of ``epoch`` to ``*.corrupt`` so discovery
        and retention never touch it again; the shared symbol file
        stays.  A concurrently deleted file is fine."""
        tag = self._epoch_tag(epoch)
        moved = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            names = []
        for name in names:
            if not name.startswith(tag) or name.endswith(".corrupt"):
                continue
            path = os.path.join(self.directory, name)
            try:
                os.replace(path, path + ".corrupt")
                moved.append(name)
            except OSError:
                pass
        logger.error(
            "quarantined checkpoint epoch %d under %r (%s): %s",
            epoch, self.prefix, "; ".join(problems), moved)

    def fsck(self, quarantine=False):
        """Offline audit of every epoch under the prefix: manifest
        readability, shard existence/size/SHA-256 and piece coverage
        (v1: params file and metadata readability).  Returns a report
        dict; ``quarantine=True`` renames failing epochs as a failed
        ``load()`` would.  Reads nothing onto a device."""
        report = {"directory": self.directory, "prefix": self.prefix_name,
                  "ok": True, "epochs": []}
        try:
            names = os.listdir(self.directory)
        except OSError as e:
            report["ok"] = False
            report["error"] = str(e)
            return report
        report["quarantined_files"] = sorted(
            n for n in names
            if n.startswith(self.prefix_name + "-")
            and n.endswith(".corrupt"))
        for epoch in self.epochs():
            if os.path.exists(self._manifest_path(epoch)):
                fmt = 2
                try:
                    with open(self._manifest_path(epoch)) as f:
                        manifest = json.load(f)
                    problems = self._verify_epoch(manifest)
                except (OSError, ValueError) as e:
                    problems = ["unreadable manifest: %s" % e]
            else:
                fmt = 1
                problems = []
                try:
                    self._read_meta(epoch)
                except MXNetError as e:
                    problems.append(str(e))
                problems.extend(self._audit_v1(epoch))
            entry = {"epoch": epoch, "format": fmt,
                     "ok": not problems, "problems": problems}
            if problems:
                report["ok"] = False
                if quarantine:
                    self._quarantine(epoch, problems)
                    entry["quarantined"] = True
            report["epochs"].append(entry)
        return report

    def _audit_v1(self, epoch):
        """A v1 epoch's params file and symbol, read on the host."""
        symbol_file = "%s-symbol.json" % self.prefix
        if not os.path.exists(symbol_file):
            return ["checkpoint %r has no symbol file: %s is missing"
                    % (self.prefix, symbol_file)]
        try:
            with np.load(self._params_path(epoch),
                         allow_pickle=False) as f:
                for k in f.keys():
                    f[k]
        except Exception as e:
            return ["checkpoint params file %s is corrupt: %s"
                    % (self._params_path(epoch), e)]
        return []

    # -- reassembly -------------------------------------------------------
    def _assemble(self, manifest):
        """Whole CPU tensors from whatever shard layout the saving run
        used (window merging lives in :func:`assemble_pieces`)."""
        arrays = {}
        for shard in manifest.get("shards") or []:
            path = os.path.join(self.directory, shard["file"])
            try:
                npz = np.load(path, allow_pickle=False)
            except Exception as e:
                # verification off can reach an unreadable shard
                raise CorruptCheckpoint(
                    "checkpoint shard %s is unreadable: %s"
                    % (shard["file"], e)) from e
            with npz as f:
                assemble_pieces(
                    ((info["param"], info["index"], f[pkey])
                     for pkey, info in (shard.get("pieces") or {}).items()),
                    manifest["params"], arrays)
        return arrays

    def _read_meta(self, epoch):
        manifest_path = self._manifest_path(epoch)
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path) as f:
                    return json.load(f)
            except (OSError, ValueError) as e:
                raise MXNetError("checkpoint manifest %r is corrupt: %s"
                                 % (manifest_path, e)) from e
        path = self._meta_path(epoch)
        if not os.path.exists(path):
            # bare save_checkpoint output: resume from the epoch boundary
            return {"epoch": epoch, "nbatch": 0, "num_update": 0}
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise MXNetError("checkpoint metadata %r is corrupt: %s"
                             % (path, e)) from e

    # -- retention ------------------------------------------------------
    def _gc(self):
        if self.keep is None:
            return
        pinned = self._pinned_epoch
        doomed = [e for e in self.epochs()[:-self.keep] if e != pinned]
        if not doomed:
            return
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        removed = []
        for epoch in doomed:
            tag = self._epoch_tag(epoch)
            for name in names:
                if not name.startswith(tag) or name.endswith(".corrupt"):
                    continue
                try:
                    os.remove(os.path.join(self.directory, name))
                except FileNotFoundError:
                    pass  # a concurrent GC/quarantine got there first
                except OSError as e:  # keep going; disk GC can wait
                    logger.warning("checkpoint GC could not remove %s: %s",
                                   name, e)
            removed.append(epoch)
        if removed:
            logger.info("checkpoint GC removed epochs %s (keep=%d)",
                        removed, self.keep)


def _as_ndarrays(params):
    """NDArrays over the values of ``params`` (tensors, numpy arrays or
    NDArrays), for the v1 writer."""
    import torch

    from .ndarray import NDArray

    out = {}
    for name, value in params.items():
        if isinstance(value, NDArray):
            out[name] = value
        elif torch.is_tensor(value):
            out[name] = NDArray(value.detach())
        else:
            out[name] = NDArray(torch.from_numpy(
                np.ascontiguousarray(np.asarray(value))))
    return out


def states_to_blob(states):
    """Optimizer states ({index: a tensor, NDArray, tuple or None}) as
    bytes: tensors leave the device as ``(numpy array, dtype name)``
    pairs (:func:`_to_host`; an extension dtype as raw bytes), so the
    blob loads on any machine, card or not."""
    import torch

    def host(value):
        value = getattr(value, "_data", value)
        if torch.is_tensor(value):
            return _to_host(value)
        if isinstance(value, dict):
            return {k: host(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(host(v) for v in value)
        return value

    return pickle.dumps(host(states))


def states_from_blob(blob):
    """The inverse of :func:`states_to_blob`: the same tree with each
    ``(array, dtype name)`` pair a CPU tensor (pickle: pass only bytes
    this program wrote)."""
    def back(value):
        if isinstance(value, tuple) and len(value) == 2 and \
                isinstance(value[0], np.ndarray) and \
                isinstance(value[1], str):
            return _piece_tensor(value[0], value[1])
        if isinstance(value, dict):
            return {k: back(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(back(v) for v in value)
        return value

    return back(pickle.loads(blob))


def _module_hstate(module):
    """The fused step's carried health state as JSON lists (the loss
    scale, its clean streak, the fp8 amax history), or None: what a
    resume needs, beside the optimizer states, to continue a loss-scaled
    or fp8 run bit for bit."""
    fused = getattr(module, "_fused", None) if module is not None else None
    export = getattr(fused, "export_hstate", None)
    snap = export() if export is not None else None
    if not snap:
        return None
    return {k: np.asarray(v).tolist() for k, v in snap.items()}


def _states_blob(module):
    """A module's optimizer states as bytes, read where the port's
    ``Module`` holds them: the fused step's states by parameter index,
    else the split updater's."""
    fused = getattr(module, "_fused_states", None)
    if fused is not None:
        return states_to_blob({i: fused[n]
                               for i, n in enumerate(module._param_names)})
    return states_to_blob(getattr(module._updater, "states", {}))


def _write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())


def _write_text(path, text):
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def _write_bytes(path, blob):
    with open(path, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())


def resolve_resume(resume_from, kvstore=None, device=None):
    """Normalise a resume target into a :class:`CheckpointState`: a
    :class:`CheckpointState`, a :class:`CheckpointManager` (its latest,
    falling back past quarantined epochs), a ``prefix`` string, or a
    ``(prefix, epoch)`` pair."""
    if isinstance(resume_from, CheckpointState):
        return resume_from
    if isinstance(resume_from, CheckpointManager):
        return resume_from.load(device=device)
    if isinstance(resume_from, str):
        head, tail = os.path.split(resume_from)
        return CheckpointManager(head or ".", tail or "model",
                                 kvstore=kvstore).load(device=device)
    if isinstance(resume_from, (tuple, list)) and len(resume_from) == 2:
        prefix, epoch = resume_from
        head, tail = os.path.split(str(prefix))
        return CheckpointManager(head or ".", tail or "model",
                                 kvstore=kvstore).load(int(epoch),
                                                       device=device)
    raise MXNetError(
        "resume_from must be a CheckpointState, CheckpointManager, prefix "
        "string or (prefix, epoch) pair (got %r)" % (resume_from,))
