"""Weight-only quantization of serving parameters and quantized KV-cache
rows: int8 and fp8 (e4m3).

Counterpart of the serving half of ``mxnet_tpu/quantize.py``.  Weights
are stored as 1-byte codes with per-output-channel float32 scales
(symmetric, scale = amax / 127 for int8 and amax / 448 for e4m3); a KV
row (one token's (H, D) keys or values) as 1-byte codes with one float32
scale.  Dequantization is one elementwise convert and multiply,
``code * scale``, and the serving kernels (K3q, K2q in ``csrc/``) do
exactly that to each element before it enters their unchanged
arithmetic, so a quantized session's logits equal the full-precision
oracle's over the dequantized values bit for bit: the JAX package's
"per precision" contract.

Quantization is the JAX package's arithmetic in float32: IEEE division
``x / scale`` (a tensor divisor: PyTorch multiplies by the reciprocal
when the divisor is a Python number on the card), ``torch.round``
(half to even, like ``np.rint``), a clamp, then the cast.  Codes and
scales are byte-equal to the JAX package's.

Storage: int8 codes are ``torch.int8``; e4m3 codes are ``torch.uint8``
holding the e4m3 bytes (PyTorch's ``float8_e4m3fn`` lacks indexing and
copies on the card), viewed as ``float8_e4m3fn`` only where a plain form
converts them (:func:`codes_to_float`).  So a code tensor's dtype names
its mode (:func:`code_mode`).  A quantized parameter is a ``{"q": codes,
"s": scales}`` record, as in the JAX package.

Eligibility: floating weights with ``ndim >= 2`` and at least
``MIN_QUANT_BYTES`` of storage.  Biases, LayerNorm vectors and scalars
stay float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import _cuda
from .base import MXNetError

__all__ = ["MODES", "INT8_MAX", "FP8_MAX", "MIN_QUANT_BYTES", "quant_mode",
           "quant_dtype", "storage_dtype", "code_mode", "codes_to_float",
           "eligible", "quantize_array", "dequantize_array", "is_quantized",
           "quantize_params", "dequantize_params", "at_rest_bytes",
           "kv_quantize_rows", "kv_dequantize", "kv_append_quantized",
           "kv_append_quantized_plain"]

MODES = ("int8", "fp8")
INT8_MAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn largest finite
MIN_QUANT_BYTES = 1024


def quant_mode(mode):
    """Normalize a quant-mode spec: ``""``/``"off"``/``"none"``/``"0"``
    -> ``""`` (disabled), else one of :data:`MODES`."""
    raw = str(mode or "").strip().lower()
    if raw in ("", "off", "none", "0", "false", "fp32", "float32"):
        return ""
    if raw in ("int8", "i8"):
        return "int8"
    if raw in ("fp8", "f8", "e4m3", "float8", "float8_e4m3fn"):
        return "fp8"
    raise MXNetError("quant mode must be off|int8|fp8 (got %r)" % (mode,))


def quant_dtype(mode):
    """The element type of ``mode``'s codes: ``torch.int8`` or
    ``torch.float8_e4m3fn``."""
    mode = quant_mode(mode)
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise MXNetError("quant_dtype: mode is off")


def storage_dtype(mode):
    """The dtype code tensors are held in: ``torch.int8``, or
    ``torch.uint8`` bytes for e4m3."""
    return torch.int8 if quant_dtype(mode) == torch.int8 else torch.uint8


def code_mode(codes):
    """The mode a code tensor's storage dtype names."""
    if codes.dtype == torch.int8:
        return "int8"
    if codes.dtype in (torch.uint8, torch.float8_e4m3fn):
        return "fp8"
    raise MXNetError("not a code tensor: dtype %s (int8 codes are int8, "
                     "e4m3 codes uint8)" % codes.dtype)


def codes_to_float(codes):
    """Codes as float32 values (exact for both modes)."""
    if code_mode(codes) == "fp8":
        codes = codes.view(torch.float8_e4m3fn)
    return codes.float()


def _qmax(mode):
    return INT8_MAX if mode == "int8" else FP8_MAX


def eligible(shape, dtype, min_bytes=MIN_QUANT_BYTES):
    """Whether a canonical weight of ``shape``/``dtype`` (a torch or
    numpy dtype) is worth quantizing: floating, matrix-or-higher rank,
    and at least ``min_bytes`` of storage."""
    if isinstance(dtype, torch.dtype):
        floating, itemsize = dtype.is_floating_point, dtype.itemsize
    else:
        dtype = np.dtype(dtype)
        floating, itemsize = dtype.kind == "f", dtype.itemsize
    if not floating or len(shape) < 2:
        return False
    return int(math.prod(int(s) for s in shape)) * itemsize >= min_bytes


def _scales(amax, mode):
    """amax -> float32 scales, ``amax / qmax`` by IEEE division; all-zero
    channels and rows get scale 1.0."""
    qmax = torch.full_like(amax, _qmax(mode))
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def _encode(y, mode):
    """Scaled values -> codes in storage dtype: round half to even and
    clamp for int8; clamp, then the e4m3 cast for fp8."""
    if mode == "int8":
        return torch.clamp(torch.round(y), -INT8_MAX, INT8_MAX) \
            .to(torch.int8)
    return torch.clamp(y, -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn) \
        .view(torch.uint8)


def quantize_array(arr, mode):
    """Symmetric quantization of one canonical float32 array.

    Returns ``(q, scale)``: ``q`` the codes in storage dtype and
    ``scale`` a broadcast-ready float32 tensor — per output channel
    (axis 0, shape ``(F, 1, ..., 1)``) for ``ndim >= 2``, per tensor
    (shape ``()``) for vectors.  Runs where ``arr`` lies."""
    mode = quant_mode(mode)
    if not mode:
        raise MXNetError("quantize_array: mode is off")
    x = torch.as_tensor(arr).to(torch.float32)
    if x.dim() >= 2:
        amax = x.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
    else:
        amax = x.abs().amax() if x.numel() else x.new_zeros(())
    scale = _scales(amax, mode)
    return _encode(x / scale, mode), scale


def dequantize_array(q, scale):
    """``code * scale`` in float32, elementwise."""
    return codes_to_float(q) * scale


def is_quantized(value):
    """Whether one params value is a quantized ``{"q", "s"}`` record."""
    return isinstance(value, dict) and "q" in value and "s" in value


def quantize_params(params, mode, min_bytes=MIN_QUANT_BYTES):
    """Quantize a flat name -> tensor params dict for serving: eligible
    weights become ``{"q": codes, "s": scales}`` records, the rest (and
    records already quantized) pass through.  Each weight is quantized on
    the host in float32, as the JAX package does, and its record goes
    back to the weight's device."""
    mode = quant_mode(mode)
    if not mode:
        return dict(params)
    out = {}
    for name, v in params.items():
        if not is_quantized(v) and eligible(tuple(v.shape), v.dtype,
                                            min_bytes):
            q, s = quantize_array(v.detach().cpu(), mode)
            out[name] = {"q": q.to(v.device), "s": s.to(v.device)}
        else:
            out[name] = v
    return out


def dequantize_params(params):
    """A (possibly quantized) params dict as plain float32 tensors: the
    values every quantized kernel computes from its records."""
    return {name: dequantize_array(v["q"], v["s"]) if is_quantized(v)
            else v for name, v in params.items()}


def at_rest_bytes(params):
    """Storage bytes of a params dict as held (codes + scales for
    quantized entries)."""
    total = 0
    for v in params.values():
        for leaf in ((v["q"], v["s"]) if is_quantized(v) else (v,)):
            total += leaf.numel() * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# quantized KV-cache rows
# ---------------------------------------------------------------------------
#
# One float32 scale per (layer, page, offset) row, in scale pools indexed
# like the code pools.  A token's codes and scale are a function of its
# own K/V values alone, so prefill, decode, verify, a prefix hit and a
# re-prefill write the same bytes for the same token.

def kv_quantize_rows(x, mode):
    """Per-row KV quantization: ``x`` (..., H, D) float rows ->
    ``(codes, scales)``, codes in storage dtype and float32 scales of
    ``x``'s leading shape (amax over (H, D); all-zero rows get 1.0).
    The plain form of kernel K9's arithmetic, byte-equal to it on finite
    rows.  A non-finite row follows the JAX package: the max keeps a NaN
    (scale 1.0), an Inf gives scale Inf, and a NaN quotient codes NaN in
    e4m3 (the sign of a NaN byte is the platform's) and 0 in int8."""
    mode = quant_mode(mode)
    if not mode:
        raise MXNetError("kv_quantize_rows: mode is off")
    x32 = x.to(torch.float32)
    scale = _scales(x32.abs().amax(dim=(-2, -1)), mode)
    return _encode(x32 / scale[..., None, None], mode), scale


def kv_dequantize(q, scale):
    """Inverse of :func:`kv_quantize_rows`: ``q`` (..., T, H, D) codes,
    ``scale`` (..., T) float32."""
    return codes_to_float(q) * scale[..., None, None]


def kv_append_quantized_plain(k_codes, v_codes, k_scale, v_scale, pages,
                              offsets, k_rows, v_rows):
    """Plain version of kernel K9: :func:`kv_quantize_rows` of the (N, H,
    D) K and V rows, stored into one layer's code pools (pages + 1, page,
    H, D) and scale pools (pages + 1, page) at ``(pages, offsets)``, in
    place.  Only trash-page rows may collide."""
    mode = code_mode(k_codes)
    for codes, scales, rows in ((k_codes, k_scale, k_rows),
                                (v_codes, v_scale, v_rows)):
        q, s = kv_quantize_rows(rows, mode)
        codes[pages, offsets] = q
        scales[pages, offsets] = s


def _kv_append_cuda(k_codes, v_codes, k_scale, v_scale, pages, offsets,
                    k_rows, v_rows):
    mode = code_mode(k_codes)
    if k_codes.dtype == torch.float8_e4m3fn or v_codes.dtype != k_codes.dtype:
        raise MXNetError("kv_append_quantized: code pools must be int8 or "
                         "uint8 (e4m3 bytes), both alike; got %s and %s"
                         % (k_codes.dtype, v_codes.dtype))
    if k_codes.dim() != 4 or v_codes.shape != k_codes.shape:
        raise MXNetError("kv_append_quantized: code pools %r, %r are not "
                         "one layer's (pages + 1, page, H, D)"
                         % (tuple(k_codes.shape), tuple(v_codes.shape)))
    slots, page, h, d = k_codes.shape
    for s in (k_scale, v_scale):
        if s.dtype != torch.float32 or tuple(s.shape) != (slots, page):
            raise MXNetError("kv_append_quantized: scale pool %s %r, want "
                             "float32 %r" % (s.dtype, tuple(s.shape),
                                             (slots, page)))
    n = pages.numel()
    for rows in (k_rows, v_rows):
        if rows.dtype != torch.float32 or tuple(rows.shape) != (n, h, d):
            raise MXNetError("kv_append_quantized: rows %s %r, want float32 "
                             "%r" % (rows.dtype, tuple(rows.shape),
                                     (n, h, d)))
        if rows[0].numel() and not rows[0].is_contiguous():
            raise MXNetError("kv_append_quantized: a row's (H, D) must be "
                             "contiguous")
    if pages.dtype != torch.int64 or offsets.dtype != torch.int64 \
            or offsets.numel() != n:
        raise MXNetError("kv_append_quantized: pages and offsets must be "
                         "int64 of one length")
    dev = k_codes.device
    for t in (v_codes, k_scale, v_scale, pages, offsets, k_rows, v_rows):
        if t.device != dev:
            raise MXNetError("kv_append_quantized: inputs on different "
                             "devices")
    if not all(t.is_contiguous() for t in (k_codes, v_codes, k_scale,
                                            v_scale)):
        raise MXNetError("kv_append_quantized: pools must be contiguous")
    pages, offsets = pages.contiguous(), offsets.contiguous()
    if n:
        with torch.cuda.device(dev):
            _cuda.launch("kv_append_quantized", k_rows.data_ptr(),
                         v_rows.data_ptr(), k_rows.stride(0),
                         v_rows.stride(0), pages.data_ptr(),
                         offsets.data_ptr(), k_codes.data_ptr(),
                         v_codes.data_ptr(), k_scale.data_ptr(),
                         v_scale.data_ptr(), n, page, h * d,
                         int(mode == "fp8"), _cuda.stream_of(k_rows))


def kv_append_quantized(k_codes, v_codes, k_scale, v_scale, pages, offsets,
                        k_rows, v_rows):
    """Quantize one layer's (N, H, D) K and V rows per row and write codes
    and scales at ``(pages, offsets)`` (int64, (N,)) into the layer's
    code pools (pages + 1, page, H, D; int8, or uint8 e4m3 bytes) and
    scale pools (pages + 1, page), in place.  On CUDA tensors this is
    kernel K9 (``csrc/kv_quant.cu``), whose codes and scales are
    byte-equal to :func:`kv_quantize_rows` on finite rows, and equal to
    it as values on rows holding a NaN or an Inf (NaN codes and scales
    alike); on CPU tensors the plain :func:`kv_append_quantized_plain`."""
    if k_codes.is_cuda:
        return _kv_append_cuda(k_codes, v_codes, k_scale, v_scale, pages,
                               offsets, k_rows, v_rows)
    return kv_append_quantized_plain(k_codes, v_codes, k_scale, v_scale,
                                     pages, offsets, k_rows, v_rows)
