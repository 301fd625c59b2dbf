"""Executor — a bound Symbol, run eagerly with torch autograd.

Counterpart of ``mxnet_tpu/executor.py`` (reference ``GraphExecutor``,
``python/mxnet/executor.py``).  :func:`_trace_fn` turns the graph into one
function over tensors, which both ``fused.TrainStep`` and the
:class:`Executor` run.  Where the JAX package jits a forward that also
returns the VJP, ``forward(is_train=True)`` here runs the graph under
autograd with the gradient arguments as leaves and keeps the graph;
``backward`` seeds it with the head gradients (ones by default; the loss
heads ignore their value) and writes ``grad_dict`` by ``grad_req``
(``write``/``add``/``null``).  The monitor callback and the NaiveEngine
mode come with a later slice.
"""
from __future__ import annotations

from collections import OrderedDict

from .base import MXNetError, get_env, later_slice
from .ops import registry as _registry
from . import random as _random

__all__ = ["Executor"]


def _run_op(node, env, new_aux, rng, is_train, device, fp8_label, aux_set,
            node_hook=None):
    """Run one op node over ``env`` ({(node id, output): tensor}),
    writing its outputs there and its aux-state updates into
    ``new_aux``."""
    ins = [env[(id(src), i)] for (src, i) in node.inputs]
    attrs = dict(node.attrs)
    if node.op.uses_train_mode:
        attrs["__is_train__"] = is_train
    if not ins and device is not None:
        attrs["__device__"] = device
    if fp8_label:
        attrs["__node_name__"] = node.name
    if node.op.needs_rng:
        ins = [rng] + ins
    res = node.op.compute(_registry.FrozenAttrs(attrs), *ins)
    if not isinstance(res, tuple):
        res = (res,)
    for i in range(node.num_outputs):
        env[(id(node), i)] = res[i]
        if node_hook is not None:
            node_hook(node.name, i, res[i])
    # functional aux-state update (reference FMutateInputs)
    for mi, upd in zip(node.op.mutable_inputs, res[node.num_outputs:]):
        src, _ = node.inputs[mi]
        if src.is_variable and src.name in aux_set:
            new_aux[src.name] = upd


def _trace_fn(sym, is_train, node_hook=None):
    """Build the function (args, aux, rng) -> (outputs, new_aux) that runs
    the graph eagerly over tensors.

    ``args``/``aux``: {name: tensor}; ``rng``: a ``torch.Generator`` (or
    None) handed to every op that declares ``needs_rng``.
    ``node_hook(node_name, out_idx, value)``, when given, fires for every
    node output.  Returns ``(fn, arg_names, aux_names)``."""
    topo = sym._topo()
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    aux_set = set(aux_names)
    out_refs = [(id(n), i) for (n, i) in sym._outputs]

    def fn(args, aux, rng):
        from . import quantize as _quantize

        # fp8 sites are labelled by node (MXNET_FP8_LAYERS names them)
        # only under an active fp8 trace: clean runs keep their attrs
        fp8_label = _quantize.fp8_tracing()
        env = {}
        new_aux = dict(aux)
        # where a node without inputs (a creation op) makes its output
        device = next(iter(args.values())).device if args else None
        for node in topo:
            if node.is_variable:
                env[(id(node), 0)] = (aux if node.name in aux_set
                                      else args)[node.name]
                continue
            _run_op(node, env, new_aux, rng, is_train, device, fp8_label,
                    aux_set, node_hook)
        return tuple(env[ref] for ref in out_refs), new_aux

    return fn, arg_names, aux_names


class Segment:
    """A run of consecutive op nodes of the topological order: the env
    keys it reads from before it (``inputs``), the keys of its outputs a
    later segment or the graph reads (``outputs``), the aux states it
    updates (``aux``) and whether an op in it draws random numbers."""

    __slots__ = ("nodes", "inputs", "outputs", "aux", "draws")

    def __init__(self, nodes):
        self.nodes = nodes
        self.inputs, self.outputs, self.aux = [], [], []
        self.draws = any(n.op.needs_rng for n in nodes)


def segment_plan(sym, n_segments):
    """Split the graph's op nodes, in the order ``_trace_fn`` runs them,
    into at most ``n_segments`` contiguous segments of near-equal length
    (the training step checkpoints each for ``remat``, so only the
    tensors that cross a boundary stay alive through the backward)."""
    topo = sym._topo()
    aux_set = set(sym.list_auxiliary_states())
    ops = [n for n in topo if not n.is_variable]
    n = max(1, min(int(n_segments), len(ops)))
    cuts = [round(k * len(ops) / n) for k in range(n + 1)]
    segs = [Segment(ops[a:b]) for a, b in zip(cuts, cuts[1:]) if b > a]
    owner = {}
    for s, seg in enumerate(segs):
        for node in seg.nodes:
            for i in range(node.num_outputs):
                owner[(id(node), i)] = s
    reads = [set() for _ in segs]
    for s, seg in enumerate(segs):
        seen = set()
        for node in seg.nodes:
            for src, i in node.inputs:
                key = (id(src), i)
                if owner.get(key) != s and key not in seen:
                    seen.add(key)
                    seg.inputs.append(key)
                    if key in owner:
                        reads[owner[key]].add(key)
            for mi in node.op.mutable_inputs:
                src, _ = node.inputs[mi]
                if src.is_variable and src.name in aux_set and \
                        src.name not in (a for a, _ in seg.aux):
                    seg.aux.append((src.name, (id(src), 0)))
    for ref in ((id(n), i) for (n, i) in sym._outputs):
        if ref in owner:
            reads[owner[ref]].add(ref)
    for s, seg in enumerate(segs):
        seg.outputs = [(id(node), i) for node in seg.nodes
                       for i in range(node.num_outputs)
                       if (id(node), i) in reads[s]]
    return segs


def run_segment(seg, values, rng, is_train, device, aux_set):
    """Run segment ``seg`` over its input ``values`` (in ``seg.inputs``
    order): its outputs in ``seg.outputs`` order, then its aux states in
    ``seg.aux`` order (an update, or the state as it came in)."""
    from . import quantize as _quantize

    env = dict(zip(seg.inputs, values))
    new_aux = {}
    fp8_label = _quantize.fp8_tracing()
    for node in seg.nodes:
        _run_op(node, env, new_aux, rng, is_train, device, fp8_label,
                aux_set)
    return tuple(env[k] for k in seg.outputs) + tuple(
        new_aux.get(a, env[key]) for a, key in seg.aux)


class Executor:
    """Executor returned by ``Symbol.bind``/``simple_bind``."""

    def __init__(self, sym, ctx, arg_dict, grad_dict, grad_req, aux_dict):
        self._symbol = sym
        self._ctx = ctx
        self.arg_dict = arg_dict          # OrderedDict name -> NDArray
        self.grad_dict = grad_dict        # name -> NDArray
        self.aux_dict = aux_dict
        self._grad_req = grad_req         # name -> str
        self.outputs = []
        self._fwd_eval_fn, self._arg_names, self._aux_names = \
            _trace_fn(sym, is_train=False)
        self._fwd_train_fn, _, _ = _trace_fn(sym, is_train=True)
        self._grad_args = [n for n in self._arg_names
                           if grad_req.get(n, "null") != "null"]
        self._graph = None    # (output tensors, gradient leaves)
        self._train_fwd_ran = False

    @property
    def arg_arrays(self):
        return list(self.arg_dict.values())

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return list(self.aux_dict.values())

    @property
    def output_dict(self):
        return OrderedDict(zip(self._symbol.list_outputs(), self.outputs))

    def forward(self, is_train=False, **kwargs):
        import torch

        from .ndarray.ndarray import NDArray, array

        if get_env("MXNET_ENGINE_TYPE", "", str) == "NaiveEngine":
            raise later_slice("MXNET_ENGINE_TYPE", "NaiveEngine")
        dev = self._ctx.torch_device
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward input %r" % k)
            t = v._data if isinstance(v, NDArray) else \
                array(v, self._ctx)._data
            self.arg_dict[k]._set_data(t.to(dev))
        aux = {n: a._data for n, a in self.aux_dict.items()}
        rng = _random.next_key(self._ctx)
        # drop the previous step's graph before the new forward (holding
        # it would double the peak activation memory)
        self._graph = None
        if is_train and self._grad_args:
            leaves = {n: a._data.detach().requires_grad_(n in self._grad_args)
                      for n, a in self.arg_dict.items()}
            with torch.enable_grad():
                outs, new_aux = self._fwd_train_fn(leaves, aux, rng)
            self._graph = (outs, [leaves[n] for n in self._grad_args])
        else:
            args = {n: a._data for n, a in self.arg_dict.items()}
            with torch.no_grad():
                outs, new_aux = (self._fwd_train_fn if is_train
                                 else self._fwd_eval_fn)(args, aux, rng)
            self._train_fwd_ran = is_train
        if is_train:
            for n, v in new_aux.items():
                self.aux_dict[n]._set_data(v.detach())
        self.outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward into ``grad_dict``,
        by ``grad_req``; the forward is not run again."""
        import torch

        from .ndarray.ndarray import NDArray

        if self._graph is None:
            if not self._grad_args and self._train_fwd_ran:
                return  # every grad_req is 'null': nothing to do
            raise MXNetError("backward called before forward(is_train=True)")
        outs, leaves = self._graph
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        heads = []
        for i, o in enumerate(outs):
            g = None if out_grads is None or i >= len(out_grads) \
                else out_grads[i]
            if g is None:
                heads.append(torch.ones_like(o))
            else:
                g = g._data if isinstance(g, NDArray) else torch.as_tensor(g)
                heads.append(g.to(device=o.device, dtype=o.dtype))
        grads = torch.autograd.grad(outs, leaves, heads, allow_unused=True)
        self._graph = None
        for n, leaf, g in zip(self._grad_args, leaves, grads):
            tgt = self.grad_dict.get(n)
            if tgt is None:
                continue
            g = torch.zeros_like(leaf) if g is None else g.detach()
            if self._grad_req.get(n) == "add":
                tgt._set_data(tgt._data + g)
            else:
                tgt._set_data(g)

    def forward_backward(self, out_grads=None, **kwargs):
        self.forward(is_train=True, **kwargs)
        self.backward(out_grads)
        return self.outputs

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                arr.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise MXNetError("unknown arg %r" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                arr.copyto(self.aux_dict[name])
            elif not allow_extra_params:
                raise MXNetError("unknown aux %r" % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """Rebind with new input shapes, sharing the parameter and aux
        arrays (reference ``Executor.reshape``)."""
        new_shapes = {n: kwargs.get(n, arr.shape)
                      for n, arr in self.arg_dict.items()}
        ex = Executor._simple_bind(
            self._symbol, self._ctx,
            self._grad_req if self.grad_dict else "null", new_shapes)
        for n, arr in self.arg_dict.items():
            if ex.arg_dict[n].shape == arr.shape:
                ex.arg_dict[n] = arr
        for n, arr in self.aux_dict.items():
            ex.aux_dict[n] = arr
        return ex

    def set_monitor_callback(self, callback, monitor_all=False):
        raise later_slice("Executor.set_monitor_callback", "Monitor")

    # -- binding constructors ---------------------------------------------
    @staticmethod
    def _simple_bind(sym, ctx, grad_req, shape_kwargs):
        from .context import current_context
        from .ndarray.ndarray import zeros
        from .symbol.symbol import _infer_param_shapes

        ctx = ctx or current_context()
        arg_names = sym.list_arguments()
        aux_names = sym.list_auxiliary_states()
        shapes = _infer_param_shapes(sym, dict(shape_kwargs))
        missing = [n for n in arg_names + aux_names if n not in shapes]
        if missing:
            raise MXNetError("simple_bind: could not infer shapes for %s"
                             % missing)
        if isinstance(grad_req, str):
            # a uniform req applies to the parameters; the inputs named by
            # shape get no gradient, as in the reference's simple_bind
            grad_req = {n: grad_req for n in arg_names}
            for n in shape_kwargs:
                grad_req[n] = "null"
        elif isinstance(grad_req, list):
            grad_req = dict(zip(arg_names, grad_req))
        else:
            grad_req = dict(grad_req)
            for n in shape_kwargs:
                grad_req.setdefault(n, "null")
        arg_dict = OrderedDict((n, zeros(shapes[n], ctx)) for n in arg_names)
        grad_dict = {n: zeros(shapes[n], ctx) for n in arg_names
                     if grad_req.get(n, "write") != "null"}
        aux_dict = OrderedDict((n, zeros(shapes[n], ctx)) for n in aux_names)
        return Executor(sym, ctx, arg_dict, grad_dict, grad_req, aux_dict)

    @staticmethod
    def _bind(sym, ctx, args, args_grad, grad_req, aux_states):
        from .context import current_context

        ctx = ctx or current_context()
        arg_names = sym.list_arguments()
        aux_names = sym.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            arg_dict = OrderedDict(zip(arg_names, args))
        else:
            arg_dict = OrderedDict((n, args[n]) for n in arg_names)
        if args_grad is None:
            grad_dict = {}
        elif isinstance(args_grad, (list, tuple)):
            grad_dict = {n: g for n, g in zip(arg_names, args_grad)
                         if g is not None}
        else:
            grad_dict = dict(args_grad)
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, list):
            grad_req = dict(zip(arg_names, grad_req))
        if args_grad is None:
            grad_req = {n: "null" for n in arg_names}
        if aux_states is None:
            aux_dict = OrderedDict()
        elif isinstance(aux_states, (list, tuple)):
            aux_dict = OrderedDict(zip(aux_names, aux_states))
        else:
            aux_dict = OrderedDict((n, aux_states[n]) for n in aux_names)
        return Executor(sym, ctx, arg_dict, grad_dict, grad_req, aux_dict)
