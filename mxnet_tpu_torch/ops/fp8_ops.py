"""fp8 training's two kernels: the scaled cast (K12) and the fp8 GEMM
(K11), each with its plain PyTorch version.

Counterpart of the arithmetic inside ``mxnet_tpu/quantize.py``'s
``_fp8_dot_fn`` (:512): the JAX package fake-casts each operand (scale,
clip, cast to e4m3 or e5m2, cast back, unscale) and contracts the
results in the compute dtype.  The port keeps the one-byte codes and
multiplies them on the H100's fp8 tensor cores:

* :func:`fp8_cast` — ``x`` (rows, cols), fp32 or bf16, to e4m3 or e5m2
  codes at a scale (a device float): ``clamp(x / s, -qmax, qmax)``
  rounded to nearest even (a NaN becomes the code ml_dtypes gives it),
  optionally the transposed codes, and ``max |x|``.  Codes are uint8
  tensors with rows padded by zero codes to a multiple of 16 bytes:
  (rows, pitch(cols)) and (cols, pitch(rows)).  Kernel K12,
  ``csrc/fp8_cast.cu``.
* :func:`fp8_gemm` — ``(sum_k a[m, k] b[n, k]) * s_a * s_b`` over two
  such code tensors (K-major, the same padded K), accumulated in fp32
  and returned in fp32 or bf16.  Kernel K11, ``csrc/fp8_gemm.cu``.

On CPU tensors each runs its plain version; on a CUDA tensor it
launches its kernel or raises :class:`MXNetError` (no fallback).
``torch._scaled_mm`` computes K11's function too; it is timed beside
K11 as a yardstick (``chip_smoke.py``) and never called here.
"""
from __future__ import annotations

import torch

from .. import _cuda
from ..base import MXNetError

__all__ = ["E4M3", "E5M2", "QMAX", "pitch", "decode", "fp8_cast",
           "fp8_cast_plain", "fp8_gemm", "fp8_gemm_plain"]

E4M3, E5M2 = 0, 1
QMAX = {E4M3: 448.0, E5M2: 57344.0}
_DTYPE = {E4M3: torch.float8_e4m3fn, E5M2: torch.float8_e5m2}
# the code of a NaN, without its sign bit (ml_dtypes' choice)
_NAN_CODE = {E4M3: 0x7F, E5M2: 0x7E}
_OUT = (torch.float32, torch.bfloat16)


def pitch(n):
    """Row pitch in bytes of ``n`` one-byte codes: ``n`` rounded up to
    16, the width of the kernels' copies."""
    return (int(n) + 15) // 16 * 16


def decode(codes, kind):
    """Codes (uint8) of ``kind`` as fp32 values, exactly."""
    return codes.view(_DTYPE[kind]).float()


def _encode_plain(q, kind):
    codes = torch.clamp(q, -QMAX[kind], QMAX[kind]).to(_DTYPE[kind]) \
        .view(torch.uint8)
    sign = torch.signbit(q).to(torch.uint8) << 7
    return torch.where(torch.isnan(q), sign | _NAN_CODE[kind], codes)


def fp8_cast_plain(x, scale, kind, codes=True, transposed=False, amax=True):
    """K12's plain version: ``(codes | None, codes_t | None, amax |
    None)`` for a 2-D ``x``; ``scale`` a 0-d float32 tensor (unused when
    no codes are asked for)."""
    rows, cols = x.shape
    xf = x.float()
    out_c = out_t = out_a = None
    if amax:
        out_a = xf.abs().amax() if xf.numel() else \
            torch.zeros((), dtype=torch.float32, device=x.device)
    if codes or transposed:
        c = _encode_plain(xf / scale, kind)
        if codes:
            out_c = torch.zeros((rows, pitch(cols)), dtype=torch.uint8,
                                device=x.device)
            out_c[:, :cols] = c
        if transposed:
            out_t = torch.zeros((cols, pitch(rows)), dtype=torch.uint8,
                                device=x.device)
            out_t[:, :rows] = c.t()
    return out_c, out_t, out_a


def _check_scale(scale, x, what):
    if scale.dtype != torch.float32 or scale.numel() != 1 \
            or scale.device != x.device:
        raise MXNetError("%s: the scale must be one float32 on %s, got %s "
                         "%r on %s" % (what, x.device, scale.dtype,
                                       tuple(scale.shape), scale.device))


def fp8_cast(x, scale, kind, codes=True, transposed=False, amax=True):
    """Codes of ``x`` (rows, cols) at ``scale``: ``(codes (rows,
    pitch(cols)) | None, codes_t (cols, pitch(rows)) | None, amax (0-d
    float32) | None)``.  Kernel K12 on CUDA tensors (fp32 or bf16; an
    fp16 input is widened first), the plain version on CPU tensors."""
    if kind not in _DTYPE:
        raise MXNetError("fp8_cast: kind must be E4M3 or E5M2, got %r"
                         % (kind,))
    if x.dim() != 2:
        raise MXNetError("fp8_cast: x must be 2-D, got %r"
                         % (tuple(x.shape),))
    if not x.is_cuda:
        return fp8_cast_plain(x, scale, kind, codes, transposed, amax)
    if x.dtype not in _OUT:
        if not x.is_floating_point():
            raise MXNetError("fp8_cast: x must be floating, got %s"
                             % x.dtype)
        x = x.float()
    coded = codes or transposed
    if coded:
        _check_scale(scale, x, "fp8_cast")
    x = x.contiguous()
    rows, cols = x.shape
    dev = x.device
    out_c = torch.empty((rows, pitch(cols)), dtype=torch.uint8,
                        device=dev) if codes else None
    out_t = torch.empty((cols, pitch(rows)), dtype=torch.uint8,
                        device=dev) if transposed else None
    out_a = torch.empty((), dtype=torch.float32, device=dev) \
        if amax else None
    if coded or amax:
        with torch.cuda.device(dev):
            _cuda.launch(
                "fp8_cast", x.data_ptr(), int(x.dtype == torch.bfloat16),
                rows, cols, scale.data_ptr() if coded else None, int(kind),
                out_c.data_ptr() if codes else None, pitch(cols),
                out_t.data_ptr() if transposed else None, pitch(rows),
                out_a.data_ptr() if amax else None, _cuda.stream_of(x))
    return out_c, out_t, out_a


def fp8_gemm_plain(a, b, a_kind, b_kind, sa, sb, out_dtype=torch.float32):
    """K11's plain version: the codes decoded exactly to fp32,
    ``torch.matmul``, then ``* s_a * s_b``."""
    out = (decode(a, a_kind) @ decode(b, b_kind).t()) * sa * sb
    return out.to(out_dtype)


def fp8_gemm(a, b, a_kind, b_kind, sa, sb, out_dtype=torch.float32):
    """``(a · bᵀ) * sa * sb`` over code tensors ``a`` (M, Kp) and ``b``
    (N, Kp) of kinds ``a_kind``/``b_kind`` (Kp a multiple of 16, the pad
    zero codes), ``sa``/``sb`` 0-d float32 tensors; (M, N) in
    ``out_dtype``.  Kernel K11 on CUDA tensors (fp32 or bf16 out; another
    floating dtype is cast from fp32), the plain version on CPU ones."""
    if a.dtype != torch.uint8 or b.dtype != torch.uint8 or a.dim() != 2 \
            or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise MXNetError("fp8_gemm: codes must be uint8 (M, K) and (N, K), "
                         "got %s %r and %s %r"
                         % (a.dtype, tuple(a.shape), b.dtype,
                            tuple(b.shape)))
    if a_kind not in _DTYPE or b_kind not in _DTYPE:
        raise MXNetError("fp8_gemm: kinds must be E4M3 or E5M2")
    if not a.is_cuda:
        return fp8_gemm_plain(a, b, a_kind, b_kind, sa, sb, out_dtype)
    M, K = a.shape
    N = b.shape[0]
    if K % 16 or b.device != a.device or not a.is_contiguous() \
            or not b.is_contiguous():
        raise MXNetError("fp8_gemm: the kernel takes contiguous codes on one "
                         "device with K a multiple of 16, got K = %d" % K)
    _check_scale(sa, a, "fp8_gemm")
    _check_scale(sb, a, "fp8_gemm")
    kernel_dtype = out_dtype if out_dtype in _OUT else torch.float32
    out = torch.empty((M, N), dtype=kernel_dtype, device=a.device)
    if out.numel():
        with torch.cuda.device(a.device):
            _cuda.launch("fp8_gemm", a.data_ptr(), b.data_ptr(), M, N, K, K,
                         K, int(a_kind), int(b_kind), sa.data_ptr(),
                         sb.data_ptr(), out.data_ptr(),
                         int(kernel_dtype == torch.bfloat16),
                         _cuda.stream_of(a))
    return out.to(out_dtype)
