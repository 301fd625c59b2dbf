"""Imperative autograd, over torch autograd.

Counterpart of ``mxnet_tpu/autograd.py`` (reference ``AutogradRuntime``,
``src/ndarray/autograd.{h,cc}``; Python ``python/mxnet/autograd.py``).
The JAX package records a tape and replays it under ``jax.vjp``; here
the ops invoked inside ``record()`` run with torch's grad mode on, so
their outputs carry torch's graph, and :func:`backward` is one
``torch.autograd.grad`` over that graph.  Outside a recording, ops run
under ``torch.no_grad()`` and build no graph.

Every floating NDArray that an op reads while recording becomes a leaf
of the graph (its tensor is rebound to a ``requires_grad`` view of the
same storage, no copy), so any array can be differentiated against —
as the JAX package's replay allows.  ``torch.autograd.grad`` runs only
the nodes that lead to the leaves asked for, so a leaf nobody asks
about costs no backward work.  Mutable inputs (BatchNorm's moving
statistics) and ``out=`` targets are rebound detached and never join the
graph.

The gradient semantics are MXNet's, not torch's: :func:`backward` writes
each marked variable's gradient into its grad NDArray by ``grad_req`` —
``write`` overwrites, ``add`` accumulates across calls, ``null`` skips —
and a marked variable the recording read but the heads do not depend on
gets a zero gradient.  ``retain_graph`` keeps the graph for another
backward; without it the recording is spent, and a further backward
raises, as it does in the reference.

API: ``record()``/``pause()``, ``train_mode()``/``predict_mode()``,
``is_recording``/``is_training``, ``set_recording``/``set_training``,
``mark_variables``, ``backward``, ``grad``.
"""
from __future__ import annotations

import threading

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "mark_variables",
           "backward", "grad", "is_recording", "is_training", "set_recording",
           "set_training"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        # the current recording: id(NDArray) -> (NDArray, leaf tensor) for
        # every array an op read, and whether any op was recorded at all
        _state.leaves = {}
        _state.recorded = False
    return _state


def _fresh_graph():
    st = _st()
    st.leaves = {}
    st.recorded = False


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    """Turn recording on or off; an off->on switch starts a fresh graph,
    as entering ``record()`` does.  Returns the previous state."""
    st = _st()
    prev = st.recording
    if is_record and not prev:
        _fresh_graph()
    st.recording = bool(is_record)
    return prev


def set_training(train):
    prev = _st().training
    _st().training = bool(train)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train):
        self._rec, self._train = is_record, train
        self._prev = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._rec and not st.recording:
            # a fresh outermost record() starts a fresh graph and drops
            # the leaves of one whose backward never ran
            _fresh_graph()
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._prev


def record(train_mode=True):
    """``with autograd.record():`` — build the graph (and train mode)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def grad_mode():
    """The torch grad-mode context an imperative op runs under: grad on
    while recording, off otherwise."""
    import torch

    return torch.enable_grad() if is_recording() else torch.no_grad()


def _track(arr):
    """The tensor of NDArray ``arr`` for an op recorded now: a floating
    tensor outside any graph is rebound to a ``requires_grad`` leaf view
    of itself and remembered as a leaf of this recording."""
    st = _st()
    st.recorded = True
    t = arr._data
    if t.grad_fn is None and t.is_floating_point():
        if not t.requires_grad:
            t = t.detach().requires_grad_()
            arr._data = t
        st.leaves.setdefault(id(arr), (arr, t))
    return t


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers (reference ``MXAutogradMarkVariables``):
    each variable's tensor becomes a ``requires_grad`` leaf (and stays
    one across rebinds) unless its ``grad_req`` is ``null``."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null", "inplace"):
            raise MXNetError("unknown grad_req %r" % (req,))
        var._grad = g
        var._grad_req = "write" if req == "inplace" else req
        var._set_data(var._data)


def _head_grads(heads, head_grads):
    import torch

    from .ndarray.ndarray import NDArray

    out = []
    for i, h in enumerate(heads):
        hg = None if head_grads is None or i >= len(head_grads) \
            else head_grads[i]
        if hg is None:
            out.append(torch.ones_like(h._data))
        else:
            t = hg._data if isinstance(hg, NDArray) else torch.as_tensor(hg)
            out.append(t.detach().to(device=h._data.device,
                                     dtype=h._data.dtype))
    return out


def _gradients(heads, head_grads, leaves, retain_graph, create_graph=False):
    """Gradients of ``heads`` (seeded with ``head_grads``, ones by
    default) with respect to the leaf tensors ``leaves``; a leaf the heads
    do not reach gets zeros."""
    import torch

    if not _st().recorded:
        raise MXNetError("autograd.backward called without recorded graph")
    cts = _head_grads(heads, head_grads)
    live = [(h._data, c) for h, c in zip(heads, cts) if h._data.requires_grad]
    grads = [None] * len(leaves)
    if live and leaves:
        with torch.enable_grad():
            grads = torch.autograd.grad(
                [h for h, _ in live], list(leaves), [c for _, c in live],
                retain_graph=retain_graph, create_graph=create_graph,
                allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to every marked variable the
    recording read, written into the variables' grad NDArrays by
    ``grad_req`` (reference ``MXAutogradBackwardEx``)."""
    st = _st()
    marked = [(var, t) for var, t in st.leaves.values()
              if var._grad is not None and var._grad_req in ("write", "add")]
    grads = _gradients(list(heads), head_grads, [t for _, t in marked],
                       retain_graph)
    for (var, _), g in zip(marked, grads):
        g = g.detach()
        if var._grad_req == "add":
            var._grad._set_data(var._grad._data + g)
        else:
            var._grad._set_data(g)
    if not retain_graph:
        _fresh_graph()


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    new NDArrays; the variables' grad buffers are left as they are
    (reference ``autograd.grad``)."""
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if isinstance(variables, NDArray):
        variables = [variables]
    st = _st()
    leaves = [st.leaves[id(v)][1] if id(v) in st.leaves else v._data
              for v in variables]
    reached = [id(v) in st.leaves for v in variables]
    retain = bool(retain_graph or create_graph)
    grads = _gradients(list(heads), head_grads,
                       [t for t, r in zip(leaves, reached) if r], retain,
                       create_graph)
    it = iter(grads)
    out = []
    for v, t, r in zip(variables, leaves, reached):
        g = next(it) if r else None
        if g is None:
            import torch

            g = torch.zeros_like(t)
        out.append(NDArray(g if create_graph else g.detach(), v.context))
    if not retain:
        _fresh_graph()
    return out
