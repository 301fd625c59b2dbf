"""Persistent measured autotuner: the serving half.

Counterpart of ``mxnet_tpu/autotune.py``.  :func:`search` runs a
measured greedy coordinate descent over a knob space (the ``measure``
callback reports a throughput metric, higher is better, plus optional
aux metrics that break ties within noise); results persist as one JSON
record per (kind, model fingerprint, mesh, backend) under
``MXNET_AUTOTUNE_DIR``, so a repeat search on the same key is a pure
cache hit.  With ``MXNET_AUTOTUNE`` on, :func:`apply_serve` folds a
cached serve record into an env-derived ``ServeConfig`` when an
``InferenceSession`` is built without an explicit config, and
:func:`provenance` lists every application.

Records are the JAX package's, key for key: :func:`fingerprint` of the
same parameters (numpy arrays or tensors) equals the JAX package's, so
one model keys one record; :func:`backend_name` is the card's name
(``torch.cuda.get_device_name``), or ``"cpu"`` without one.  On a card,
:func:`search` synchronises before each candidate and times it with
CUDA events as well (``event_ms`` beside each trial).

The training half (``apply_train_env``, ``train_key_topology``,
``fingerprint_symbol``, ``mesh_desc``) is ported with the training
robustness step (ROADMAP queue 1 step 4).
"""
from __future__ import annotations

import hashlib
import json
import os
import time

from .base import MXNetError, get_env

__all__ = ["autotune_enabled", "store_dir", "budget_s", "fingerprint",
           "backend_name", "Key", "Knob", "AutotuneStore", "search",
           "apply_serve", "provenance", "note_applied", "clear_applied"]

DEFAULT_REL_TIE = 0.02

_APPLIED = []  # provenance of knob applications in this process


def autotune_enabled():
    """``MXNET_AUTOTUNE``: apply cached tuned knobs at session build
    (default off — searches themselves are always explicit)."""
    return get_env("MXNET_AUTOTUNE", False, bool)


def store_dir():
    """``MXNET_AUTOTUNE_DIR``: where tuning records persist (default
    ``~/.cache/mxnet_tpu/autotune``, the JAX package's)."""
    path = get_env("MXNET_AUTOTUNE_DIR", "", str)
    if not path:
        path = os.path.join(os.path.expanduser("~"), ".cache",
                            "mxnet_tpu", "autotune")
    return path


def budget_s():
    """``MXNET_AUTOTUNE_BUDGET_S``: wall-clock cap for one search's
    measurement passes (0 = unbounded)."""
    return max(0.0, get_env("MXNET_AUTOTUNE_BUDGET_S", 0.0, float))


# -- keys ------------------------------------------------------------------

def _dtype_str(v):
    # a tensor's dtype prints as "torch.float32"; numpy's as "float32"
    return str(getattr(v, "dtype", "?")).replace("torch.", "")


def fingerprint(params):
    """Stable model fingerprint from parameter names, shapes and dtypes
    — 12 hex chars.  Works on numpy arrays, tensors, NDArrays and
    quantized ``{"q", "s"}`` records alike, and equals the JAX
    package's for the same parameters."""
    items = []
    for name in sorted(params):
        v = params[name]
        dtype = None
        if isinstance(v, dict) and "q" in v:
            # a quantized record fingerprints like the float32 weight it
            # dequantizes to
            v, dtype = v["q"], "float32"
        v = getattr(v, "_data", v)
        shape = tuple(int(s) for s in getattr(v, "shape", ()))
        if dtype is None:
            dtype = _dtype_str(v)
        items.append("%s:%r:%s" % (name, shape, dtype))
    blob = ";".join(items).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def backend_name():
    """The device this process measures on: the card's name, or
    ``"cpu"`` without one (a key must not need a device)."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


class Key(object):
    """Identity of one tuning record: what was tuned (``kind``), for
    which model (``fingerprint``), on which topology (``mesh``,
    ``backend``)."""

    __slots__ = ("kind", "fingerprint", "mesh", "backend")

    def __init__(self, kind, fingerprint, mesh="-", backend=None):
        self.kind = str(kind)
        self.fingerprint = str(fingerprint)
        self.mesh = str(mesh or "-")
        self.backend = str(backend if backend is not None
                           else backend_name())

    @property
    def slug(self):
        mesh = hashlib.sha256(self.mesh.encode()).hexdigest()[:8] \
            if self.mesh != "-" else "none"
        return "%s-%s-%s-%s" % (self.kind, self.fingerprint, mesh,
                                self.backend)

    def __repr__(self):
        return ("Key(kind=%r, fingerprint=%r, mesh=%r, backend=%r)"
                % (self.kind, self.fingerprint, self.mesh, self.backend))


class Knob(object):
    """One searchable dimension: ``values[0]`` is the default the
    coordinate descent starts from."""

    __slots__ = ("name", "values")

    def __init__(self, name, values):
        self.name = str(name)
        self.values = tuple(values)
        if not self.values:
            raise MXNetError("Knob %r has no values" % (name,))


def _space_desc(space):
    # through JSON, so equality with a stored record's knob_space is
    # round-trip stable (tuples come back as lists)
    return json.loads(json.dumps({k.name: list(k.values)
                                  for k in space}))


# -- the persistent store --------------------------------------------------

class AutotuneStore(object):
    """One JSON file per record under ``directory``, replaced
    atomically."""

    def __init__(self, directory=None):
        self.directory = directory or store_dir()

    def _path(self, key):
        return os.path.join(self.directory, "autotune-%s.json" % key.slug)

    def get(self, key):
        try:
            with open(self._path(key)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def put(self, key, record):
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(key)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(record, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    def records(self):
        """Every record in the store."""
        out = []
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return out
        for name in names:
            if not (name.startswith("autotune-")
                    and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue
        return out


# -- the search ------------------------------------------------------------

def _measurement(raw):
    if isinstance(raw, dict):
        return {"metric": float(raw["metric"]),
                "aux": dict(raw.get("aux") or {})}
    return {"metric": float(raw), "aux": {}}


def _better(cand, best, rel_tie):
    """Higher metric wins outright; within ``rel_tie`` relative noise,
    lower aux ``temp_bytes`` breaks the tie."""
    m, b = cand["metric"], best["metric"]
    if m > b * (1.0 + rel_tie):
        return True
    if m < b * (1.0 - rel_tie):
        return False
    ca = cand["aux"].get("temp_bytes")
    bb = best["aux"].get("temp_bytes")
    return ca is not None and bb is not None and ca < bb


def _timed(measure, knobs):
    """One candidate's measurement.  On a card the queue is drained
    first (no earlier work lands in this candidate's window), and CUDA
    events bracket the call: ``event_ms`` is the device-side span."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return _measurement(measure(knobs))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    m = _measurement(measure(knobs))
    end.record()
    end.synchronize()
    m["event_ms"] = start.elapsed_time(end)
    return m


def search(measure, space, key, store=None, budget=None,
           rel_tie=DEFAULT_REL_TIE, force=False):
    """Greedy coordinate descent over ``space`` (a list of
    :class:`Knob`), measuring each candidate with ``measure(knobs) ->
    metric | {"metric": ..., "aux": {...}}`` (higher is better).

    The record persists under ``key``; a repeat call with the same key
    and knob space returns the stored record without calling
    ``measure`` (``cache_hit: True``).  ``budget`` seconds (default
    ``MXNET_AUTOTUNE_BUDGET_S``) bounds measurement time: the baseline
    is always measured, later candidates are skipped once it is spent
    (``budget_exhausted``)."""
    space = list(space)
    if not space:
        raise MXNetError("search: empty knob space")
    store = store or AutotuneStore()
    desc = _space_desc(space)
    if not force:
        rec = store.get(key)
        if rec is not None and rec.get("knob_space") == desc:
            rec = dict(rec)
            rec["cache_hit"] = True
            return rec
    if budget is None:
        budget = budget_s()
    t0 = time.perf_counter()
    current = {k.name: k.values[0] for k in space}
    best = _timed(measure, dict(current))
    baseline = best["metric"]
    trials = [{"knobs": dict(current), **best}]
    exhausted = False
    for knob in space:
        for val in knob.values[1:]:
            if budget and time.perf_counter() - t0 > budget:
                exhausted = True
                break
            cand = dict(current)
            cand[knob.name] = val
            m = _timed(measure, dict(cand))
            trials.append({"knobs": dict(cand), **m})
            if _better(m, best, rel_tie):
                best, current = m, cand
        if exhausted:
            break
    record = {
        "kind": key.kind,
        "fingerprint": key.fingerprint,
        "mesh": key.mesh,
        "backend": key.backend,
        "knob_space": desc,
        "knobs": dict(current),
        "metric": best["metric"],
        "aux": best["aux"],
        "baseline_metric": baseline,
        "speedup_vs_default": (best["metric"] / baseline
                               if baseline else 0.0),
        "measurements": len(trials),
        "trials": trials,
        "elapsed_s": round(time.perf_counter() - t0, 3),
        "budget_exhausted": exhausted,
        "created": time.time(),
    }
    store.put(key, record)
    rec = dict(record)
    rec["cache_hit"] = False
    return rec


# -- application + provenance ----------------------------------------------

def note_applied(record, where, applied):
    """Record one knob application."""
    _APPLIED.append({
        "kind": record.get("kind"),
        "fingerprint": record.get("fingerprint"),
        "mesh": record.get("mesh"),
        "backend": record.get("backend"),
        "knobs": dict(record.get("knobs") or {}),
        "applied": list(applied),
        "where": str(where),
        "metric": record.get("metric"),
    })


def provenance():
    """Knob applications this process performed."""
    return [dict(rec) for rec in _APPLIED]


def clear_applied():
    """Drop the provenance log (test hook)."""
    del _APPLIED[:]


def apply_serve(config, params, store=None):
    """Fold a cached serve tuning record into an env-derived
    ``ServeConfig`` (``InferenceSession`` calls this only when the
    caller passed no config): ``quant``, ``kv_quant``, ``buckets``,
    ``prefix_pages``, ``watermark``, ``layers`` and ``window``; a knob
    the record does not carry keeps its env/default value.  No-op
    unless ``MXNET_AUTOTUNE`` is on and a record exists for this
    (model fingerprint, backend)."""
    if not autotune_enabled():
        return config
    import dataclasses

    from .quantize import quant_mode

    store = store or AutotuneStore()
    rec = store.get(Key("serve", fingerprint(params)))
    if not rec:
        return config
    knobs = rec.get("knobs") or {}
    updates = {}
    if "quant" in knobs:
        updates["quant"] = quant_mode(knobs["quant"])
    if "kv_quant" in knobs:
        updates["kv_quant"] = quant_mode(knobs["kv_quant"])
    if "buckets" in knobs:
        updates["buckets"] = tuple(int(b) for b in knobs["buckets"])
    if "prefix_pages" in knobs:
        updates["prefix_pages"] = int(knobs["prefix_pages"])
    if "watermark" in knobs:
        updates["watermark"] = int(knobs["watermark"])
    if "layers" in knobs:
        updates["layers"] = str(knobs["layers"])
    if "window" in knobs:
        updates["window"] = int(knobs["window"])
    if not updates:
        return config
    note_applied(rec, where="InferenceSession",
                 applied=sorted(updates))
    return dataclasses.replace(config, **updates)
