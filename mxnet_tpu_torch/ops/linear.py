"""The serving projections: ``y = x @ W^T + b`` (kernels K3 and K3q).

Counterpart of ``mxnet_tpu/serve/model.py::_mm``.  In exact mode the
JAX package writes every projection as a broadcast-multiply-reduce, so
that each output element sums over C in an order that does not depend on
how many rows share the call — the property that makes a decoded token
bit-identical to the same position of a full-context forward.  cuBLAS
and ``torch.matmul`` promise no such order, so on CUDA the exact
projection is the hand-written kernel ``csrc/linear.cu`` (one FMA chain
per output over c = 0 .. C-1); on CPU tensors it is the plain form
:func:`mi_linear_plain`.  ``exact=False`` is a plain product, as the JAX
package leaves it to XLA.

A quantized weight is a ``{"q": codes (F, C), "s": scales (F,) or (F,
1)}`` record (``quantize.py``; int8 codes, or e4m3 bytes held as uint8).
On CUDA the exact projection over it is kernel K3q, which dequantizes
each weight element (``code * scale``) before K3's chain, so its output
is K3's on the dequantized weight bit for bit; on CPU tensors, and with
``exact=False``, the weight is dequantized first (the JAX package's
``_resolve_params``) and the fp32 path runs.
"""
from __future__ import annotations

import torch

from .. import _cuda
from .. import quantize as Q
from ..base import MXNetError

__all__ = ["mi_linear", "mi_linear_plain"]

# elements of the (rows, F-chunk, C) product tensor the plain form
# materialises at once (1 GiB of float32)
_PLAIN_CHUNK = 1 << 28


def mi_linear_plain(x, w, b=None):
    """``(x[..., None, :] * w).sum(-1) + b``, the JAX package's exact
    ``_mm`` form.  It materialises an (M, F, C) product, so it runs over F
    in chunks; chunking over F leaves each output's arithmetic as is."""
    rows = max(x[..., 0].numel(), 1)
    step = max(_PLAIN_CHUNK // (rows * max(x.shape[-1], 1)), 1)
    parts = [(x[..., None, :] * w[f0:f0 + step]).sum(-1)
             for f0 in range(0, w.shape[0], step)]
    y = torch.cat(parts, dim=-1) if len(parts) != 1 else parts[0]
    return y + b if b is not None else y


def _mi_linear_cuda(x, w, b):
    c = x.shape[-1]
    f = w.shape[0]
    if w.dim() != 2 or w.shape[1] != c:
        raise MXNetError("mi_linear: weight %r does not take inputs of "
                         "width %d" % (tuple(w.shape), c))
    if b is not None and tuple(b.shape) != (f,):
        raise MXNetError("mi_linear: bias %r does not match %d outputs"
                         % (tuple(b.shape), f))
    for t in (x, w) + ((b,) if b is not None else ()):
        if t.dtype != torch.float32:
            raise MXNetError("mi_linear: the CUDA kernel takes float32, got "
                             "%s" % t.dtype)
        if t.device != x.device:
            raise MXNetError("mi_linear: inputs on different devices")
    x2 = x.reshape(-1, c).contiguous()
    w = w.contiguous()
    b = b.contiguous() if b is not None else None
    y = torch.empty((x2.shape[0], f), dtype=torch.float32, device=x.device)
    if y.numel():
        with torch.cuda.device(x.device):
            _cuda.launch("mi_linear", x2.data_ptr(), w.data_ptr(),
                         b.data_ptr() if b is not None else None,
                         y.data_ptr(), x2.shape[0], f, c, _cuda.stream_of(x))
    return y.reshape(x.shape[:-1] + (f,))


def _mi_linear_q_cuda(x, codes, scales, b):
    c = x.shape[-1]
    f = codes.shape[0]
    mode = Q.code_mode(codes)
    if codes.dtype == torch.float8_e4m3fn:
        raise MXNetError("mi_linear: e4m3 codes go to the kernel as uint8 "
                         "bytes (quantize.storage_dtype)")
    if codes.dim() != 2 or codes.shape[1] != c:
        raise MXNetError("mi_linear: weight %r does not take inputs of "
                         "width %d" % (tuple(codes.shape), c))
    if scales.dtype != torch.float32 or scales.numel() != f \
            or scales.dim() not in (1, 2) or scales.shape[0] != f:
        raise MXNetError("mi_linear: scales %s %r, want float32 (%d,) or "
                         "(%d, 1)" % (scales.dtype, tuple(scales.shape), f,
                                      f))
    if b is not None and (tuple(b.shape) != (f,) or b.dtype != torch.float32):
        raise MXNetError("mi_linear: bias %r does not match %d outputs"
                         % (tuple(b.shape), f))
    if x.dtype != torch.float32:
        raise MXNetError("mi_linear: the CUDA kernel takes float32 inputs, "
                         "got %s" % x.dtype)
    for t in (codes, scales) + ((b,) if b is not None else ()):
        if t.device != x.device:
            raise MXNetError("mi_linear: inputs on different devices")
    x2 = x.reshape(-1, c).contiguous()
    codes, scales = codes.contiguous(), scales.contiguous()
    b = b.contiguous() if b is not None else None
    y = torch.empty((x2.shape[0], f), dtype=torch.float32, device=x.device)
    if y.numel():
        with torch.cuda.device(x.device):
            _cuda.launch("mi_linear_q", x2.data_ptr(), codes.data_ptr(),
                         scales.data_ptr(),
                         b.data_ptr() if b is not None else None,
                         y.data_ptr(), x2.shape[0], f, c,
                         int(mode == "fp8"), _cuda.stream_of(x))
    return y.reshape(x.shape[:-1] + (f,))


def mi_linear(x, w, b=None, exact=True):
    """``x (..., C) @ w (F, C)^T + b (F,)``, ``w`` a float32 tensor or a
    quantized ``{"q", "s"}`` record.  ``exact`` (the serving default)
    selects the M-invariant form: kernel K3 (K3q for a record) on CUDA
    tensors, the plain broadcast-reduce on CPU tensors."""
    if Q.is_quantized(w):
        if exact and x.is_cuda:
            return _mi_linear_q_cuda(x, w["q"], w["s"], b)
        w = Q.dequantize_array(w["q"], w["s"])
    if not exact:
        y = x @ w.t()
        return y + b if b is not None else y
    if x.is_cuda:
        return _mi_linear_cuda(x, w, b)
    return mi_linear_plain(x, w, b)
