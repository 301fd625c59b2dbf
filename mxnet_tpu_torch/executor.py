"""Graph tracing for the port's train step.

Counterpart of ``mxnet_tpu/executor.py``: this slice ports ``_trace_fn``
(:33-92), the function ``fused.TrainStep`` differentiates.  The
``Executor`` class (``bind``/``simple_bind`` with forward and backward)
comes with the Module slice.
"""
from __future__ import annotations

from .ops import registry as _registry

__all__ = []


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
        env = {}
        new_aux = dict(aux)
        for node in topo:
            if node.is_variable:
                env[(id(node), 0)] = (aux if node.name in aux_set
                                      else args)[node.name]
                continue
            ins = [env[(id(src), i)] for (src, i) in node.inputs]
            attrs = dict(node.attrs)
            if node.op.uses_train_mode:
                attrs["__is_train__"] = is_train
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
            for mi, upd in zip(node.op.mutable_inputs,
                               res[node.num_outputs:]):
                src, _ = node.inputs[mi]
                if src.is_variable and src.name in aux_set:
                    new_aux[src.name] = upd
        return tuple(env[ref] for ref in out_refs), new_aux

    return fn, arg_names, aux_names
