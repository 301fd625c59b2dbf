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

The second half is fp8 training compute (the JAX package's
``quantize.py:380-595``, ``MXNET_FP8``): every FullyConnected,
MultiHeadAttention projection and 2-D ``dot`` traced inside
:func:`fp8_trace` multiplies e4m3 operands at delayed per-tensor scales
and backpropagates an e5m2 cotangent at its current scale, through the
two Hopper kernels of ``ops/fp8_ops.py`` (K12 casts, K11 multiplies);
see :func:`fp8_apply_dot`.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import _cuda
from .base import MXNetError, get_env

__all__ = ["MODES", "INT8_MAX", "FP8_MAX", "MIN_QUANT_BYTES", "quant_mode",
           "quant_dtype", "storage_dtype", "code_mode", "codes_to_float",
           "eligible", "quantize_array", "dequantize_array", "is_quantized",
           "quantize_params", "dequantize_params", "at_rest_bytes",
           "kv_quantize_rows", "kv_dequantize", "kv_append_quantized",
           "kv_append_quantized_plain", "FP8_E5M2_MAX", "FP8_AMAX_HISTORY",
           "fp8_mode", "fp8_enabled", "fp8_layer_allowed", "fp8_trace",
           "fp8_tracing", "fp8_apply_dot", "fp8_hist_init",
           "fp8_realize_scales", "fp8_update_hist"]

MODES = ("int8", "fp8")
INT8_MAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn largest finite
FP8_E5M2_MAX = 57344.0  # float8_e5m2 largest finite (gradient format)
FP8_AMAX_HISTORY = 16  # delayed-scaling window (steps) per fp8 tensor
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


# -- fp8 training compute (delayed scaling) --------------------------------
#
# Forward matmul operands are cast to e4m3 at DELAYED scales: each fp8
# site keeps a per-tensor amax history that rides the TrainStep's carried
# health state (like the dynamic loss scaler) and realizes its scale as
# max(history) / FP8_MAX.  The backward's cotangent is cast to e5m2 at its
# own current amax, inside the same autograd backward.  Sites are claimed
# in execution order from the active trace (:func:`fp8_trace`); the
# executor runs the graph in a fixed topological order, so the i-th claim
# is the same tensor every step and the history is one (n_sites, 2,
# HISTORY) tensor.

_FP8_TRACE = None


class _Fp8Trace(object):
    """Per-forward fp8 site registry: realized scales in, amaxes out."""

    __slots__ = ("scales", "amax", "names")

    def __init__(self, scales=None):
        self.scales = scales  # (n_sites, 2) float32, or None (discovery)
        self.amax = []        # per-site (2,) float32 amax, claim order
        self.names = []       # site labels, claim order


@contextlib.contextmanager
def fp8_trace(scales=None):
    """Arm the fp8 route for the ops run inside the block.

    ``scales``: (n_sites, 2) float32 tensor of realized (x, w) scales, or
    None for discovery and the first step (every site at scale 1.0).
    Yields the trace; read ``.amax`` (list of (2,) tensors, claim order)
    and ``.names`` after the forward."""
    global _FP8_TRACE
    prev, _FP8_TRACE = _FP8_TRACE, _Fp8Trace(scales)
    try:
        yield _FP8_TRACE
    finally:
        _FP8_TRACE = prev


def fp8_tracing():
    """Whether an :func:`fp8_trace` is active — the executor then puts
    node names into op attrs (``__node_name__``); clean runs keep their
    attrs unchanged."""
    return _FP8_TRACE is not None


def current_fp8_trace():
    """The active :func:`fp8_trace`, or None."""
    return _FP8_TRACE


def fp8_mode():
    """Resolve ``MXNET_FP8`` to ``auto`` | ``on`` | ``off``."""
    raw = str(get_env("MXNET_FP8", "off") or "off").strip().lower()
    if raw in ("off", "0", "false", "no", ""):
        return "off"
    if raw in ("on", "1", "true", "yes"):
        return "on"
    if raw == "auto":
        return "auto"
    raise MXNetError("MXNET_FP8 must be auto|on|off (got %r)" % (raw,))


def fp8_enabled(device=None):
    """Whether the fp8 route is armed for a step on ``device``: ``on``
    forces, ``off`` disables, ``auto`` arms on a CUDA device (the H100's
    fp8 tensor cores) and keeps the clean path on the CPU, as the JAX
    package arms it only on backends with fp8 units.  ``device`` None
    means the card, the port's default."""
    mode = fp8_mode()
    if mode != "auto":
        return mode == "on"
    return device is None or torch.device(device).type == "cuda"


def fp8_layer_allowed(name):
    """Per-layer opt-out: ``MXNET_FP8_LAYERS`` empty allows every
    eligible site; a comma-separated list allows only sites whose label
    matches an entry exactly or by prefix."""
    spec = str(get_env("MXNET_FP8_LAYERS", "") or "").strip()
    if not spec:
        return True
    if not name:
        return False
    allowed = [t.strip() for t in spec.split(",") if t.strip()]
    return any(name == a or name.startswith(a) for a in allowed)


def fp8_hist_init(n_sites, device=None):
    """Zero (n_sites, 2, FP8_AMAX_HISTORY) float32 amax history; an empty
    history realizes scale 1.0 (the first step's)."""
    return torch.zeros((int(n_sites), 2, FP8_AMAX_HISTORY),
                       dtype=torch.float32, device=device)


def fp8_realize_scales(hist):
    """``max(history) / FP8_MAX`` per (site, operand), 1.0 where the
    history is still empty (IEEE division by a tensor)."""
    hmax = torch.amax(torch.as_tensor(hist, dtype=torch.float32), dim=-1)
    return torch.where(hmax > 0, hmax / torch.full_like(hmax, FP8_MAX),
                       torch.ones_like(hmax))


def fp8_update_hist(hist, new_amax):
    """Roll the history one step: the fresh (n_sites, 2) amaxes enter at
    slot 0, the oldest falls off."""
    hist = torch.as_tensor(hist, dtype=torch.float32)
    new = torch.as_tensor(new_amax, dtype=torch.float32,
                          device=hist.device)[..., None]
    return torch.cat([new, hist[..., :-1]], dim=-1)


def _fake_cast(x, scale, qmax, dtype):
    """Quantize-dequantize ``x`` through ``dtype`` at ``scale``, in fp32:
    the values the JAX package computes with (the CPU tests' twin)."""
    y = torch.clamp(x.float() / scale, -qmax, qmax)
    return y.to(dtype).float() * scale


class _Fp8Dot(torch.autograd.Function):
    """The fp8 contraction of ``x`` (..., C) with the 2-D ``w`` along
    ``w``'s axis ``w_dim`` (the JAX package's custom VJP ``_fp8_dot_fn``).

    Forward: K12 casts x and w to e4m3 at the delayed scales (and gives
    their amaxes); K11 multiplies the codes.  Backward: K12 takes the
    cotangent's amax, then its e5m2 codes at ``amax / FP8_E5M2_MAX``; K11
    computes dx against the saved e4m3 weight codes and dw against the
    saved e4m3 activation codes (the standard fp8 recipe).  The saved
    operands are the transposed codes K12 wrote in the forward, so no
    torch transpose runs.  A gradient nobody needs is not computed.  The
    scales get no gradient: they are statistics."""

    @staticmethod
    def forward(ctx, x, w, sx, sw, w_dim):
        from .ops import fp8_ops as F8

        need_dx, need_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        C = x.shape[-1]
        x2 = x.reshape(-1, C)
        xc, xct, ax = F8.fp8_cast(x2, sx, F8.E4M3, codes=True,
                                  transposed=need_dw)
        # w (F, C) for w_dim 1: the forward takes its row-major codes and
        # dx its transposed ones; w (C, F) for w_dim 0 the other way round
        fwd_rows = w_dim == 1
        wc, wct, aw = F8.fp8_cast(
            w, sw, F8.E4M3, codes=fwd_rows or need_dx,
            transposed=(not fwd_rows) or need_dx)
        w_fwd, w_bwd = (wc, wct) if fwd_rows else (wct, wc)
        out_dtype = torch.promote_types(x.dtype, w.dtype)
        out = F8.fp8_gemm(xc, w_fwd, F8.E4M3, F8.E4M3, sx, sw, out_dtype)
        F = w.shape[1 - w_dim]
        ctx.save_for_backward(xct if need_dw else None,
                              w_bwd if need_dx else None, sx, sw)
        ctx.meta = (tuple(x.shape), int(w_dim), F, x.dtype, w.dtype)
        amax = torch.stack([ax, aw])
        ctx.mark_non_differentiable(amax)
        return out.reshape(x.shape[:-1] + (F,)), amax

    @staticmethod
    def backward(ctx, g, _g_amax):
        from .ops import fp8_ops as F8

        xct, w_bwd, sx, sw = ctx.saved_tensors
        x_shape, w_dim, F, x_dtype, w_dtype = ctx.meta
        need_dx, need_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        if not (need_dx or need_dw):
            return None, None, None, None, None
        g2 = g.reshape(-1, F)
        _, _, ag = F8.fp8_cast(g2, None, F8.E5M2, codes=False)
        sg = torch.where(ag > 0, ag / torch.full_like(ag, FP8_E5M2_MAX),
                         torch.ones_like(ag))
        gc, gct, _ = F8.fp8_cast(g2, sg, F8.E5M2, codes=need_dx,
                                 transposed=need_dw, amax=False)
        dx = dw = None
        if need_dx:
            dx = F8.fp8_gemm(gc, w_bwd, F8.E5M2, F8.E4M3, sg, sw,
                             x_dtype).reshape(x_shape)
        if need_dw:
            if w_dim == 1:  # dw (F, C) = g^T x
                dw = F8.fp8_gemm(gct, xct, F8.E5M2, F8.E4M3, sg, sx,
                                 w_dtype)
            else:           # dw (C, F) = x^T g
                dw = F8.fp8_gemm(xct, gct, F8.E4M3, F8.E5M2, sx, sg,
                                 w_dtype)
        return dx, dw, None, None, None


def fp8_apply_dot(x, w, label=None, w_dim=1):
    """The fp8 matmul route for one op site, or ``None`` to keep the
    full-precision path (no trace active, the layer opted out, or the
    shapes do not fit the 2-D weight contraction).

    Claims the next site in execution order, records the operands'
    current amaxes into the trace, and contracts ``x`` (..., C) against
    the 2-D ``w`` along ``w_dim`` through :class:`_Fp8Dot`."""
    t = _FP8_TRACE
    if t is None:
        return None
    if not fp8_layer_allowed(label):
        return None
    if w.dim() != 2 or x.dim() < 1:
        return None
    if x.shape[-1] != w.shape[w_dim]:
        return None
    i = len(t.names)
    t.names.append(label or ("site%d" % i))
    if t.scales is None:
        sx = sw = torch.ones((), dtype=torch.float32, device=x.device)
    else:
        sx, sw = t.scales[i, 0], t.scales[i, 1]
    out, amax = _Fp8Dot.apply(x, w, sx, sw, int(w_dim))
    t.amax.append(amax)
    return out
