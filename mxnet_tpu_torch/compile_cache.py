"""Recompile guardrails: a process-wide registry of per-owner guards.

Counterpart of the third leg of ``mxnet_tpu/compile_cache.py``
(``signature_of``, ``diff_signatures``, ``RecompileGuard``,
``RecompileRegistry``, ``registry``, ``report``, ``write_artifact``).
Where the JAX package recompiles an XLA program for every new input
signature, the port re-captures a CUDA graph: a multi-step
``fused.TrainStep`` captures its K steps once per signature of shapes
and dtypes, and reports each signature to its guard.  Past
``MXNET_RECOMPILE_WARN`` distinct signatures a guard logs the leaves
that changed, and under ``MXNET_RECOMPILE_ERROR=1`` it raises
:class:`~mxnet_tpu_torch.base.RecompileStorm`.

The persistent-cache leg (``ensure_initialized``, ``cache_stats``,
``sweep_cache``, ``track_lru``) has no counterpart yet: the port's
kernel build cache (``_cuda.py``) keeps no statistics.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time

from .base import RecompileStorm, get_env, logger

__all__ = ["signature_of", "diff_signatures", "RecompileGuard",
           "RecompileRegistry", "RecompileStorm", "registry", "report",
           "write_artifact"]

ARTIFACT_KIND = "mxnet_tpu-compile-report"


def _describe_leaf(x):
    """(shape, dtype, device) identity of one signature leaf; Python
    scalars are named as such."""
    for typ, name in ((bool, "py_bool"), (int, "py_int"),
                      (float, "py_float"), (complex, "py_complex")):
        if isinstance(x, typ):
            return (name, "weak")
    shape = getattr(x, "shape", None)
    if shape is None:
        return (type(x).__name__,)
    return (tuple(shape), str(getattr(x, "dtype", "?")),
            str(getattr(x, "device", "")))


def _flatten(tree, path, out):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            _flatten(tree[k], "%s[%r]" % (path, k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, "%s[%d]" % (path, i), out)
    else:
        out.append((path, _describe_leaf(tree)))


def signature_of(*trees):
    """Hashable (path, leaf identity) signature of a call's inputs, over
    nested dicts, lists and tuples.  Equal signatures replay the same
    captured graph; a new one is a capture."""
    sig = []
    for i, tree in enumerate(trees):
        _flatten(tree, str(i), sig)
    return tuple(sig)


def diff_signatures(old, new):
    """The paths whose leaf identity changed (or appeared/disappeared)
    between two signatures."""
    old_map, new_map = dict(old), dict(new)
    lines = []
    for path in sorted(set(old_map) | set(new_map), key=str):
        a, b = old_map.get(path), new_map.get(path)
        if a == b:
            continue
        if a is None:
            lines.append("%s: (absent) -> %r" % (path, b))
        elif b is None:
            lines.append("%s: %r -> (absent)" % (path, a))
        else:
            lines.append("%s: %r -> %r" % (path, a, b))
    return lines


class RecompileGuard:
    """Per-owner capture counter.

    The owner calls :meth:`observe` with the signature of each call; the
    guard tracks distinct signatures (``signatures``), captures including
    re-captures of a known signature (``traces``), and calls (``calls``).
    Past ``MXNET_RECOMPILE_WARN`` distinct signatures it logs one warning
    per further new signature, naming the leaves that differ from the
    previous one, and raises :class:`RecompileStorm` when
    ``MXNET_RECOMPILE_ERROR=1``."""

    def __init__(self, name):
        self.name = name
        self.calls = 0
        self.traces = 0
        self._seen = {}
        self._last_sig = None
        self._lock = threading.Lock()

    @property
    def signatures(self):
        return len(self._seen)

    def observe(self, sig, force=False):
        """Record one call.  ``force=True`` counts a capture even for a
        signature seen before (a new owner capturing it again).  Returns
        True when this call captured."""
        with self._lock:
            self.calls += 1
            new = sig not in self._seen
            if new:
                self._seen[sig] = self.traces
            traced = new or force
            if traced:
                self.traces += 1
            prev, self._last_sig = self._last_sig, sig
            n = self.signatures
        if not new or n <= 1:
            return traced
        warn_after = get_env("MXNET_RECOMPILE_WARN", 3, int)
        if n > warn_after:
            diff = diff_signatures(prev, sig) if prev is not None else []
            msg = ("recompile guard: %r has met %d distinct input "
                   "signatures (threshold %d); every new signature is a "
                   "new CUDA-graph capture. Changed vs the previous "
                   "signature:\n  %s\nCommon causes: drifting batch "
                   "tails, a dtype or device change between calls."
                   % (self.name, n, warn_after,
                      "\n  ".join(diff) or "(no leaf-level difference: "
                      "the tree structure changed)"))
            if get_env("MXNET_RECOMPILE_ERROR", False, bool):
                raise RecompileStorm(msg, name=self.name, signatures=n,
                                     diff=diff)
            logger.warning(msg)
        return traced

    def snapshot(self):
        return {"name": self.name, "calls": self.calls,
                "traces": self.traces, "signatures": self.signatures}


class RecompileRegistry:
    """Process-wide registry of :class:`RecompileGuard` s: ``guard(name)``
    returns the existing guard for ``name``, so an owner rebuilt with the
    same name keeps counting into one guard."""

    def __init__(self):
        self._guards = {}
        self._lock = threading.Lock()

    def guard(self, name):
        with self._lock:
            g = self._guards.get(name)
            if g is None:
                g = self._guards[name] = RecompileGuard(name)
            return g

    def report(self):
        """{name: {calls, traces, signatures}}, most captures first."""
        with self._lock:
            guards = list(self._guards.values())
        return {g.name: g.snapshot() for g in
                sorted(guards, key=lambda g: -g.traces)}

    def reset(self):
        with self._lock:
            self._guards.clear()


registry = RecompileRegistry()


def report():
    """The process's recompile picture: the registry's guards."""
    return {"kind": ARTIFACT_KIND, "pid": os.getpid(), "time": time.time(),
            "recompiles": registry.report()}


def write_artifact(path=None):
    """Write :func:`report` as JSON; by default under ``$MXNET_HEALTH_DIR``
    or the temp directory.  Returns the path."""
    if path is None:
        base_dir = get_env("MXNET_HEALTH_DIR", "", str) or \
            tempfile.gettempdir()
        path = os.path.join(base_dir, "compile-report-%d-%d.json"
                            % (os.getpid(), int(time.time())))
    with open(path, "w") as f:
        json.dump(report(), f, indent=2, default=repr)
    return path
