"""Custom operators defined in Python.

Counterpart of ``mxnet_tpu/operator.py`` (reference
``python/mxnet/operator.py`` + ``src/operator/custom/custom.cc``): the
user subclasses :class:`CustomOp` (compute) and :class:`CustomOpProp`
(metadata), registers the prop under a name, and invokes
``mx.nd.Custom(..., op_type=name)`` or ``mx.sym.Custom(...)``.

The ``Custom`` registry op is a ``torch.autograd.Function``: its forward
calls the user's ``forward`` on NDArrays over the input tensors, and its
backward calls the user's ``backward``, with ``req`` ``"write"`` for the
inputs autograd wants a gradient of and ``"null"`` for the others, and
with the head gradients as ``out_grad`` (a prop with
``need_top_grad=False`` — a loss layer — ignores them, as in the
reference).  The user's NDArray code runs eagerly on the inputs' device,
outside any recording, so its ``assign`` writes never join the graph; a
forward that calls ``.asnumpy()`` only synchronises with the card.  So
the port has one tier where the JAX package has two (code traced into
XLA, or a host callback), and no ``MXNET_CUSTOM_OP_CALLBACK`` knob.  The
op works imperatively, under ``autograd.record()``, inside a bound
Symbol and under ``Module.fit`` (on the split executor: ``Module`` does
not fuse a graph that holds a Custom node).

As in the reference, ``create_operator`` receives the inputs' context
(the JAX package passes ``cpu()``).  Divergences kept from the JAX
package: one operator instance per call (ops must keep no state between
calls), and no auxiliary states.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_class"]

_CUSTOM_PROPS = {}


class CustomOp:
    """Base class for the compute part (reference ``CustomOp``)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` honoring the request ``req``."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError("unknown req %r" % req)


class CustomOpProp:
    """Base class for the metadata part (reference ``CustomOpProp``)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, (in_shape[0],) * len(self.list_outputs()), ()

    def infer_type(self, in_type):
        return in_type, (in_type[0],) * len(self.list_outputs()), ()

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Register a CustomOpProp subclass under ``op_type`` (reference
    ``mx.operator.register``)."""
    def _do(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls

    return _do


def get_prop_class(op_type):
    try:
        return _CUSTOM_PROPS[op_type]
    except KeyError:
        raise MXNetError(
            "custom op %r is not registered (known: %s)"
            % (op_type, sorted(_CUSTOM_PROPS))) from None


def _make_prop(attrs):
    """Instantiate the prop with the user's kwargs (the reference passes
    every attr to the prop constructor as a string)."""
    if "op_type" not in attrs:
        raise MXNetError("Custom needs an op_type attr")
    kwargs = {k: v for k, v in attrs.items()
              if k != "op_type" and not k.startswith("__")}
    return get_prop_class(attrs["op_type"])(**kwargs)


def _custom_num_outputs(attrs):
    return len(_make_prop(attrs).list_outputs())


def _dtype_names(tensors):
    from .ndarray.ndarray import dtype_name

    return [dtype_name(t.dtype) for t in tensors]


class _Spec:
    """What one Custom call needs besides its tensors."""

    def __init__(self, prop, is_train, out_shapes, out_dtypes):
        self.prop, self.is_train = prop, is_train
        self.out_shapes, self.out_dtypes = out_shapes, out_dtypes


def _nd(t):
    """An NDArray over ``t``, outside any graph, on its device's context."""
    from .context import context_of
    from .ndarray.ndarray import NDArray

    return NDArray(t.detach(), context_of(t.device))


class _CustomFunction(torch.autograd.Function):
    """The user's ``forward``/``backward`` as one autograd node."""

    @staticmethod
    def forward(ctx, spec, *xs):
        from . import autograd
        from .context import context_of
        from .ndarray.ndarray import torch_dtype

        dev = xs[0].device
        op = spec.prop.create_operator(
            context_of(dev), [list(x.shape) for x in xs], _dtype_names(xs))
        out_data = [_nd(torch.zeros(s, dtype=torch_dtype(d), device=dev))
                    for s, d in zip(spec.out_shapes, spec.out_dtypes)]
        with autograd.pause(train_mode=spec.is_train):
            op.forward(is_train=spec.is_train, req=["write"] * len(out_data),
                       in_data=[_nd(x) for x in xs], out_data=out_data,
                       aux=[])
        outs = [o._data.to(torch_dtype(d)).contiguous()
                for o, d in zip(out_data, spec.out_dtypes)]
        ctx.op = op
        ctx.save_for_backward(*xs, *outs)
        ctx.n_in = len(xs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        from . import autograd

        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        req = ["write" if need else "null"
               for need in ctx.needs_input_grad[1:]]
        in_grad = [_nd(torch.zeros_like(x)) for x in xs]
        out_grad = [_nd(torch.zeros_like(o) if g is None else g)
                    for g, o in zip(grads, outs)]
        with autograd.pause():
            ctx.op.backward(req=req, out_grad=out_grad,
                            in_data=[_nd(x) for x in xs],
                            out_data=[_nd(o) for o in outs],
                            in_grad=in_grad, aux=[])
        return (None,) + tuple(
            g._data.to(x.dtype) if r != "null" else None
            for g, x, r in zip(in_grad, xs, req))


def _custom_compute(attrs, *inputs):
    """The Custom registry op (reference ``custom.cc:36``): shapes and
    types from the prop's ``infer_shape``/``infer_type``; on ``meta``
    tensors (shape inference) no user code runs."""
    from .ndarray.ndarray import dtype_name, torch_dtype

    prop = _make_prop(attrs)
    if prop.list_auxiliary_states():
        raise MXNetError("Custom ops with auxiliary states are not "
                         "supported")
    out_shapes = [tuple(int(d) for d in s) for s in
                  prop.infer_shape([list(x.shape) for x in inputs])[1]]
    out_dtypes = [dtype_name(d)
                  for d in prop.infer_type(_dtype_names(inputs))[1]]
    if any(x.device.type == "meta" for x in inputs):
        outs = tuple(torch.empty(s, dtype=torch_dtype(d), device="meta")
                     for s, d in zip(out_shapes, out_dtypes))
    else:
        spec = _Spec(prop, bool(attrs.get("__is_train__", False)),
                     out_shapes, out_dtypes)
        outs = _CustomFunction.apply(spec, *inputs)
    return outs if len(outs) > 1 else outs[0]


def _register_custom_op():
    from .ops.registry import register as reg_op

    reg_op("Custom", num_outputs=_custom_num_outputs,
           uses_train_mode=True)(_custom_compute)


_register_custom_op()
