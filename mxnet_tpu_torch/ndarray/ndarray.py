"""NDArray — the imperative value type, backed by a torch tensor.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py`` (reference
``include/mxnet/ndarray.h``, ``python/mxnet/ndarray/ndarray.py``).  As in
the JAX package, an NDArray holds one tensor and *rebinds* it on
mutation (``_set_data`` bumps ``_version``) instead of writing in place,
so a tensor handed to a step or an executor is never changed under it.
Every operator call goes through :func:`imperative_invoke`, which runs
the op's compute eagerly — under torch's grad mode inside
``autograd.record()``, without it outside (:mod:`..autograd`) — and
threads ``mutable_inputs`` (BatchNorm's moving stats) back into their
NDArrays, detached.

``save``/``load`` use the JAX package's ``.npz`` container with the same
keys, so a file written by either package loads in the other.  bf16
arrays come back from ``asnumpy`` as float32 (numpy has no bfloat16).
``attach_grad``/``grad``/``backward`` are the reference's imperative
autograd surface; a marked array's tensor is a ``requires_grad`` leaf,
and rebinding keeps it one.
"""
from __future__ import annotations

import os

import numpy as _np

from ..base import MXNetError
from ..context import Context, context_of, current_context
from .. import random as _random
from ..ops import registry as _registry

__all__ = ["NDArray", "imperative_invoke", "array", "empty", "zeros", "ones",
           "full", "arange", "concat", "save", "load", "waitall",
           "torch_dtype"]


def torch_dtype(dtype):
    """The torch dtype for a numpy dtype, a dtype name or a torch dtype."""
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    if name == "bfloat16":
        return torch.bfloat16
    try:
        return getattr(torch, _np.dtype(name).name)
    except (AttributeError, TypeError):
        raise MXNetError("unsupported dtype %r" % (dtype,)) from None


def dtype_name(dtype):
    """The name of a numpy dtype, a dtype name or a torch dtype."""
    import torch

    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype
    return _np.dtype(dtype).name


def _host(value, dtype=None):
    """A numpy array of ``value``; float64 becomes float32 unless a dtype
    is given (the reference's default dtype)."""
    arr = _np.asarray(value)
    if dtype is None and arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    return arr


def _as_tensor(value, dtype=None, ctx=None):
    import torch

    dev = (ctx or current_context()).torch_device
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        t = torch.from_numpy(_np.ascontiguousarray(_host(value, dtype)))
    return t.to(device=dev, dtype=torch_dtype(dtype) if dtype else None)


class NDArray:
    """A multidimensional array on a device context: shape/dtype/size,
    ``asnumpy``/``asscalar``, arithmetic, slicing and assignment,
    ``copyto``/``as_in_context``, ``astype``, ``reshape`` and every
    registered op as a method."""

    __slots__ = ("_data", "_ctx", "_version", "_grad", "_grad_req",
                 "__weakref__")

    def __init__(self, data, ctx=None):
        self._data = data
        self._ctx = ctx if ctx is not None else context_of(data.device)
        self._version = 0
        self._grad = None
        self._grad_req = None

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype (``torch.bfloat16`` itself for bf16)."""
        import torch

        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return _np.dtype(str(self._data.dtype).replace("torch.", ""))

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def grad(self):
        """The gradient buffer attached by ``attach_grad`` or
        ``autograd.mark_variables`` (None without one)."""
        return self._grad

    @property
    def handle(self):
        """The tensor (stands in for the C-ABI NDArrayHandle)."""
        return self._data

    # -- sync & host transfer ----------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            import torch

            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        import torch

        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype):
        return imperative_invoke("Cast", [self],
                                 {"dtype": dtype_name(dtype)})[0]

    def copy(self):
        return imperative_invoke("_copy", [self], {})[0]

    def copyto(self, other):
        """Copy into an NDArray (rebinding it; its dtype is kept) or onto
        a Context (a new NDArray)."""
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype,
                copy=True))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True), other)
        raise MXNetError("copyto target must be NDArray or Context")

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    def detach(self):
        """The same values outside any graph: gradients stop here."""
        return NDArray(self._data.detach(), self._ctx)

    # -- mutation (engine write semantics: rebind, never write in place) --
    def _set_data(self, data):
        """Rebind to ``data``, detached: a write never joins the autograd
        graph.  A marked variable's new tensor is a ``requires_grad`` leaf
        again, so the next recording differentiates against it."""
        data = data.detach()
        if self._grad_req in ("write", "add") and data.is_floating_point():
            data.requires_grad_(True)
        self._data = data
        self._version += 1

    def __setitem__(self, key, value):
        import torch

        if isinstance(value, NDArray):
            value = value._data
        if not isinstance(value, torch.Tensor):
            arr = _np.ascontiguousarray(value)
            if not arr.flags.writeable:  # torch.from_numpy wants writable
                arr = arr.copy()
            value = torch.from_numpy(arr)
        value = value.detach().to(device=self._data.device,
                                  dtype=self._data.dtype)
        if key is Ellipsis or key == slice(None):
            self._set_data(value.expand(self.shape).clone())
            return
        with torch.no_grad():
            new = self._data.clone()
            new[key] = value
        self._set_data(new)

    def __getitem__(self, key):
        """Indexing; inside ``autograd.record()`` it is differentiable."""
        from .. import autograd

        if isinstance(key, NDArray):
            key = key._data.detach()
        if autograd.is_recording():
            with autograd.grad_mode():
                return NDArray(autograd._track(self)[key], self._ctx)
        return NDArray(self._data.detach()[key], self._ctx)

    def reshape(self, shape, **kwargs):
        if isinstance(shape, int):
            shape = (shape,)
        return imperative_invoke("Reshape", [self],
                                 {"shape": tuple(shape), **kwargs})[0]

    def flatten(self):
        return imperative_invoke("Flatten", [self], {})[0]

    def attach_grad(self, grad_req="write"):
        """Allocate a zero gradient buffer and mark this array for autograd
        (reference ``NDArray.attach_grad``)."""
        import torch

        from .. import autograd

        grad = NDArray(torch.zeros_like(self._data.detach()), self._ctx)
        autograd.mark_variables([self], [grad], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array into the marked variables' buffers
        (reference ``NDArray.backward``)."""
        from .. import autograd

        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    def __getattr__(self, name):
        # any registered op is a method with self as first input (the
        # reference generates these from the registry)
        if name.startswith("_") or not _registry.exists(name):
            raise AttributeError(
                "'NDArray' object has no attribute %r" % name)

        def method(*args, **kwargs):
            bad = [a for a in args if not isinstance(a, NDArray)]
            if bad:
                raise TypeError(
                    "NDArray.%s: pass scalar attributes as keywords "
                    "(got positional %r)" % (name, bad[0]))
            res = imperative_invoke(name, [self] + list(args), kwargs)
            return res[0] if len(res) == 1 else res

        method.__name__ = name
        return method

    # -- python protocol ----------------------------------------------------
    def __len__(self):
        return self.shape[0] if self.shape else 0

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(s) for s in self.shape),
            self._ctx)

    def __bool__(self):
        if self.size != 1:
            raise MXNetError("ambiguous truth value of multi-element NDArray")
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def _binary(self, other, op, scalar_op, rop=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if rop else (self, other)
            return imperative_invoke(op, [a, b], {})[0]
        return imperative_invoke(scalar_op, [self],
                                 {"scalar": float(other)})[0]

    def __add__(self, o): return self._binary(o, "elemwise_add", "_plus_scalar")
    def __radd__(self, o): return self._binary(o, "elemwise_add", "_plus_scalar")
    def __sub__(self, o): return self._binary(o, "elemwise_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binary(o, "elemwise_sub", "_rminus_scalar", rop=True)
    def __mul__(self, o): return self._binary(o, "elemwise_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binary(o, "elemwise_mul", "_mul_scalar")
    def __truediv__(self, o): return self._binary(o, "elemwise_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binary(o, "elemwise_div", "_rdiv_scalar", rop=True)
    def __pow__(self, o): return self._binary(o, "elemwise_power", "_power_scalar")
    def __neg__(self): return imperative_invoke("negative", [self], {})[0]
    def __gt__(self, o): return self._binary(o, "elemwise_greater", "_greater_scalar")
    def __ge__(self, o): return self._binary(o, "elemwise_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binary(o, "elemwise_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binary(o, "elemwise_lesser_equal", "_lesser_equal_scalar")
    __hash__ = object.__hash__

    def __iadd__(self, o):
        self._set_data(self.__add__(o)._data)
        return self

    def __isub__(self, o):
        self._set_data(self.__sub__(o)._data)
        return self

    def __imul__(self, o):
        self._set_data(self.__mul__(o)._data)
        return self

    def __itruediv__(self, o):
        self._set_data(self.__truediv__(o)._data)
        return self


# ---------------------------------------------------------------------------
# the imperative invoke path (≈ MXImperativeInvoke)
# ---------------------------------------------------------------------------

def imperative_invoke(op_name, inputs, attrs, out=None):
    """Run one registered op imperatively; returns a list of output
    NDArrays.  Handles the generator for ``needs_rng`` ops, train mode
    (``autograd.is_training()``), recording (inside ``autograd.record()``
    the op runs under torch's grad mode and its inputs join the graph;
    the mutable ones never do), the write-back of ``mutable_inputs`` and
    ``out=`` targets, both rebound detached."""
    from .. import autograd

    op = _registry.get(op_name)
    attrs = dict(attrs)
    op.validate_attrs(attrs)
    if op.uses_train_mode and "__is_train__" not in attrs:
        attrs["__is_train__"] = autograd.is_training()
    ctx = inputs[0]._ctx if inputs and isinstance(inputs[0], NDArray) \
        else current_context()
    recording = autograd.is_recording()
    tensors = []
    for i, x in enumerate(inputs):
        if not isinstance(x, NDArray):
            tensors.append(_as_tensor(x, ctx=ctx))
        elif recording and i not in op.mutable_inputs:
            tensors.append(autograd._track(x))
        else:
            tensors.append(x._data)
    if op.needs_rng:
        tensors = [_random.next_key(ctx)] + tensors
    frozen = _registry.FrozenAttrs(attrs)
    results = _registry.invoke(op, tensors, frozen, record=recording)
    n_out = op.count_outputs(frozen)
    for idx, new_val in zip(op.mutable_inputs, results[n_out:]):
        if isinstance(inputs[idx], NDArray):
            inputs[idx]._set_data(new_val)
    outputs = results[:n_out]
    if out is not None:
        out_list = out if isinstance(out, (list, tuple)) else [out]
        for tgt, val in zip(out_list, outputs):
            tgt._set_data(val)
        return list(out_list)
    return [NDArray(o, ctx) for o in outputs]


# ---------------------------------------------------------------------------
# creation / io helpers (reference ndarray.py module functions)
# ---------------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None):
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    ctx = ctx or current_context()
    return NDArray(_as_tensor(source_array, dtype, ctx), ctx)


def _filled(shape, value, ctx, dtype):
    import torch

    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx or current_context()
    return NDArray(torch.full(tuple(shape), value,
                              dtype=torch_dtype(dtype or "float32"),
                              device=ctx.torch_device), ctx)


def empty(shape, ctx=None, dtype="float32"):
    return _filled(shape, 0, ctx, dtype)


def zeros(shape, ctx=None, dtype="float32", **kwargs):
    return _filled(shape, 0, ctx, dtype)


def ones(shape, ctx=None, dtype="float32", **kwargs):
    return _filled(shape, 1, ctx, dtype)


def full(shape, val, ctx=None, dtype="float32"):
    return _filled(shape, val, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    out = _np.arange(start, stop, step).astype(dtype or "float32")
    if repeat > 1:
        out = _np.repeat(out, repeat)
    return array(out, ctx, dtype)


def concat(*data, **kwargs):
    """Join along ``dim`` (default 1, the reference's ``Concat``)."""
    import torch

    dim = kwargs.get("dim", 1)
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = data[0]
    return NDArray(torch.cat([d._data for d in data], dim=dim), data[0]._ctx)


def waitall():
    """Block until all pending device work completes (reference
    ``MXNDArrayWaitAll``); errors of that work surface here."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# save/load: the JAX package's .npz container, keys and all, so the two
# packages read each other's files (python/mxnet/ndarray/utils.py API:
# dicts or lists round-trip)

def save(fname, data):
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        _np.savez(fname, **{k: v.asnumpy() for k, v in data.items()})
    else:
        _np.savez(fname, **{"__list_%d" % i: v.asnumpy()
                            for i, v in enumerate(data)})


def load(fname):
    path = fname if os.path.exists(fname) or fname.endswith(".npz") \
        else fname + ".npz"
    with _np.load(path, allow_pickle=False) as f:
        keys = list(f.keys())
        if keys and all(k.startswith("__list_") for k in keys):
            return [array(f[k]) for k in sorted(
                keys, key=lambda s: int(s.split("_")[-1]))]
        return {k: array(f[k]) for k in keys}
