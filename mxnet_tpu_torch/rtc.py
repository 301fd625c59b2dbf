"""Runtime-compiled CUDA kernels: the ``MXRtc`` facility.

Counterpart of ``mxnet_tpu/rtc.py`` (``PallasKernel``, which wraps a
user's Pallas body in ``pl.pallas_call`` and ``jax.jit``).  On the card
the facility is the reference's own contract again (``MXRtc``,
``include/mxnet/mxrtc.h:44``; MXNet 0.11's ``mx.rtc.Rtc``): the user
hands over the *body* of a CUDA kernel as a string, and
:class:`CudaKernel` writes the signature around it —

    extern "C" __global__ void name(const float* x, ..., float* y) {
      const int x_ndim = 2; const int x_dims[] = {16, 128};
      ...
      <body>
    }

one pointer per argument, inputs ``const``, in ``arg_names`` order
(inputs, then outputs), with each argument's rank and dimensions as
constants.  Types map float32 → ``float``, bfloat16 → ``__nv_bfloat16``,
float16 → ``__half``, int32 → ``int``.  A generated host entry launches
the kernel on PyTorch's current stream and returns
``cudaGetLastError()``.  The text is compiled by ``nvcc`` for ``sm_90a``
at first use (:func:`._cuda.build_source`, cached on disk by the text's
hash), once per distinct set of input shapes; every launch adds one to
``_cuda.launches["rtc:<name>"]``.

There is no hidden fallback: a CPU tensor raises, for the facility runs
the user's code and has no plain version of it to give.  A user op that
must also run on the CPU chooses by device itself
(``testing/rtc_ops.py``).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib

from . import _cuda
from .base import MXNetError

__all__ = ["CudaKernel", "decorate", "CTYPES"]

# dtype name -> CUDA C type of a pointer's element
CTYPES = {"float32": "float", "bfloat16": "__nv_bfloat16",
          "float16": "__half", "int32": "int"}
THREADS = 256  # threads a block when neither grid nor block is given

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY_ARGTYPES = (_P, _I, _I, _I, _I, _I, _I, _I, _P)


def _dtype_name(dtype):
    from .ndarray.ndarray import dtype_name

    return dtype_name(dtype)


def decorate(name, body, args):
    """The CUDA source for kernel ``name`` around ``body``; ``args`` is a
    list of ``(arg name, shape, dtype name, is_output)``.  Returns
    ``(text, entry)``: the text and the name of its host launch entry."""
    params, consts = [], []
    for arg, shape, dtype, is_out in args:
        if dtype not in CTYPES:
            raise MXNetError("rtc %s: argument %s has dtype %s; the "
                             "facility takes %s" % (name, arg, dtype,
                                                    sorted(CTYPES)))
        params.append("%s%s* %s" % ("" if is_out else "const ",
                                    CTYPES[dtype], arg))
        dims = ", ".join(str(int(d)) for d in shape) or "1"
        consts.append("  const int %s_ndim = %d; const int %s_dims[] = {%s};"
                      % (arg, len(shape), arg, dims))
    kernel = ("extern \"C\" __global__ void %s(%s) {\n%s\n%s\n}\n"
              % (name, ", ".join(params), "\n".join(consts), body))
    entry = "mxt_rtc_" + hashlib.sha256(kernel.encode()).hexdigest()[:16]
    text = (
        "#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n"
        "#include <cuda_fp16.h>\n\n" + kernel + "\n"
        "extern \"C\" int %s(void** args, int gx, int gy, int gz, int bx,\n"
        "                   int by, int bz, int shmem, void* stream) {\n"
        "  cudaError_t e = cudaLaunchKernel((const void*)%s, dim3(gx, gy, "
        "gz),\n      dim3(bx, by, bz), args, (size_t)shmem, "
        "(cudaStream_t)stream);\n"
        "  if (e != cudaSuccess) return (int)e;\n"
        "  return (int)cudaGetLastError();\n}\n\n"
        "extern \"C\" const char* mxt_error_string(int code) {\n"
        "  return cudaGetErrorString((cudaError_t)code);\n}\n"
        % (entry, name))
    return text, entry


def _dims3(v, who):
    v = (int(v),) if isinstance(v, int) else tuple(int(d) for d in v)
    if not 1 <= len(v) <= 3 or min(v) < 1:
        raise MXNetError("rtc: %s %r must be 1 to 3 positive sizes"
                         % (who, v))
    return v + (1,) * (3 - len(v))


def _require_cuda(tensors, name):
    for t in tensors:
        if not t.is_cuda:
            raise MXNetError(
                "rtc %s: a tensor on %s; a CudaKernel runs on the CUDA "
                "card only (move the data to mx.gpu())" % (name, t.device))
        if t.device != tensors[0].device:
            raise MXNetError("rtc %s: inputs on %s and %s"
                             % (name, tensors[0].device, t.device))


class CudaKernel:
    """A CUDA kernel compiled at run time (the ``mx.rtc.Rtc`` analogue).

    ``body``: the statements of a ``__global__`` function over the named
    pointers (and their ``<arg>_ndim``/``<arg>_dims`` constants).
    ``out_shapes``: ``[(shape, dtype), ...]`` of the outputs.
    ``arg_names``: the names of the inputs, then of the outputs.
    ``grid``/``block``: the launch shape; when neither is given, one
    thread per element of the first output, 256 threads a block.

    Example, MXNet 0.11's::

        k = CudaKernel("int i = threadIdx.x + blockIdx.x * blockDim.x;\\n"
                       "if (i < x_dims[0]) y[i] = x[i] * 2.0f;",
                       [((10,), "float32")], ["x", "y"])
        (y,) = k(x)
    """

    def __init__(self, body, out_shapes, arg_names, grid=None, block=None,
                 name="rtc_kernel"):
        self._body = body
        self._out = [(tuple(int(d) for d in s), _dtype_name(d))
                     for s, d in out_shapes]
        self._arg_names = list(arg_names)
        self._n_in = len(self._arg_names) - len(self._out)
        if self._n_in < 1:
            raise MXNetError("rtc %s: %d arg_names for %d outputs: no inputs"
                             % (name, len(arg_names), len(self._out)))
        self._grid, self._block = grid, block
        self.name = name
        self._launchers = {}  # input signature -> (C entry, error entry)

    def source(self, in_shapes, in_dtypes):
        """The decorated source for inputs of these shapes and dtypes."""
        args = [(a, s, _dtype_name(d), False) for a, s, d in
                zip(self._arg_names, in_shapes, in_dtypes)]
        args += [(a, s, d, True) for a, (s, d) in
                 zip(self._arg_names[self._n_in:], self._out)]
        return decorate(self.name, self._body, args)

    def _launcher(self, ins):
        key = tuple((tuple(t.shape), t.dtype) for t in ins)
        if key not in self._launchers:
            text, entry = self.source([t.shape for t in ins],
                                      [t.dtype for t in ins])
            self._launchers[key] = _cuda.build_source(text, entry,
                                                      _ENTRY_ARGTYPES)
        return self._launchers[key]

    def _launch_shape(self, grid, block):
        grid = grid if grid is not None else self._grid
        block = block if block is not None else self._block
        if grid is None and block is None:
            n = 1
            for d in self._out[0][0] if self._out else ():
                n *= d
            return (max(1, -(-n // THREADS)), 1, 1), (THREADS, 1, 1)
        if grid is None or block is None:
            raise MXNetError("rtc %s: give both grid and block, or neither"
                             % self.name)
        return _dims3(grid, "grid"), _dims3(block, "block")

    def _run(self, inputs, grid=None, block=None):
        """Launch on input tensors; returns the new output tensors."""
        import torch

        from .ndarray.ndarray import torch_dtype

        if len(inputs) != self._n_in:
            raise MXNetError("rtc %s: %d inputs, want %d (%s)"
                             % (self.name, len(inputs), self._n_in,
                                self._arg_names[:self._n_in]))
        ins = [t.contiguous() for t in inputs]
        _require_cuda(ins, self.name)
        ref = ins[0]
        outs = [torch.empty(s, dtype=torch_dtype(d), device=ref.device)
                for s, d in self._out]
        (gx, gy, gz), (bx, by, bz) = self._launch_shape(grid, block)
        fn, err = self._launcher(ins)
        ptrs = (ctypes.c_void_p * len(ins + outs))(
            *[t.data_ptr() for t in ins + outs])
        args = (ctypes.c_void_p * len(ptrs))(
            *[ctypes.addressof(ptrs) + i * ctypes.sizeof(ctypes.c_void_p)
              for i in range(len(ptrs))])
        stream = _cuda.stream_of(ref) if ref.is_cuda else None
        with torch.cuda.device(ref.device) if ref.is_cuda else \
                contextlib.nullcontext():
            rc = fn(args, gx, gy, gz, bx, by, bz, 0, stream)
        if rc:
            raise MXNetError("rtc %s: CUDA error %d (%s)"
                             % (self.name, rc, err(rc).decode()))
        key = "rtc:" + self.name
        _cuda.launches[key] = _cuda.launches.get(key, 0) + 1
        return outs

    def __call__(self, *inputs):
        """Run on NDArrays (or tensors); returns a tuple of NDArrays."""
        from .ndarray.ndarray import NDArray

        ins = [x._data.detach() if isinstance(x, NDArray) else x
               for x in inputs]
        outs = self._run(ins)
        ctx = inputs[0].context if isinstance(inputs[0], NDArray) else None
        return tuple(NDArray(o, ctx) for o in outs)

    def push(self, inputs, outputs=None, grid_dims=None, block_dims=None):
        """Reference ``Rtc.push(inputs, outputs, grid_dims, block_dims)``:
        launch with the given grid and block (which mean on the card what
        they meant in MXNet 0.11) and rebind ``outputs`` to the results
        (new NDArrays when none are given)."""
        from .ndarray.ndarray import NDArray

        outs = self._run([x._data.detach() for x in inputs], grid_dims,
                         block_dims)
        if outputs:
            for dst, o in zip(outputs, outs):
                dst._set_data(o)
            return list(outputs)
        return [NDArray(o, inputs[0].context) for o in outs]

