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
           "fp8_cast_plain", "fp8_gemm", "fp8_gemm_plain",
           "fp8_gemm_magnitude", "fp8_gemm_error_bound"]

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


# K11's error bound, derived in csrc/fp8_gemm.cu's header from how
# Hopper's fp8 wgmma adds, measured on an H100 (NVIDIA H100 80GB HBM3,
# 700 W) by testing/fp8_accum.py, whose emulation of it gives K11's bits:
# a k32 step aligns its 32 products and the running sum to the largest
# exponent among them (a product's is the sum of its factors' exponent
# fields, a subnormal factor's its kind's least normal exponent, measured
# for e4m3 and for e5m2) and cuts each toward zero WGMMA_KEPT_BITS below
# it; a sum that carries past that bit is cut again, as many bits below
# its own.  The bound is a worst case; the card's checks also hold a
# sample of K11's outputs equal to that emulation
# (testing/fp8_accum.py::sample_mismatches).
WGMMA_KEPT_BITS = 13
STAGE_DEPTH = 128  # K11 promotes each 128-deep stage (four k32 steps)
# what a stage cuts: its 4 x 32 products, the running sum entering steps
# 2-4, and each step's carry
STAGE_CUTS = 4 * 32 + 3 + 4
# the least exponent of a normal value: a subnormal code's exponent field
MIN_NORMAL_EXP = {E4M3: -6, E5M2: -14}


def fp8_gemm_magnitude(a, b, a_kind, b_kind, sa, sb):
    """``sum_k |a|_f |b|_f s_a s_b`` per output (fp32), the magnitude
    :func:`fp8_gemm_error_bound` scales: ``|x|_f`` is ``|x|`` for a normal
    code and the least normal value for a subnormal one (the exponent the
    tensor cores align it by), so for operands without subnormal codes it
    is ``sum_k |a b| s_a s_b``."""
    def field(codes, kind):
        x = decode(codes, kind).abs()
        return torch.where(x > 0, x.clamp(min=2.0 ** MIN_NORMAL_EXP[kind]),
                           x)
    return (field(a, a_kind) @ field(b, b_kind).t()) * sa * sb


def fp8_gemm_error_bound(mag, k, plain=None):
    """The most K11 may differ from its plain version, per output.

    ``mag`` is :func:`fp8_gemm_magnitude`, ``k`` the contraction's depth.
    Each cut in a stage loses less than 2^-13 of the step's largest
    exponent, which is at most the stage's share of ``mag`` grown by the
    cuts before it: r = STAGE_CUTS 2^-13 of that share, r / (1 - r) with
    the growth.  Then fp32 roundings, each at most 2^-24 of ``mag``: K11's
    promotions of its stages and its two scale multiplies, the plain
    version's own k-term sum (any order), and ``mag``'s.  With ``plain``
    (the plain version's fp32 values), the bound of a bf16 output: one
    more rounding, 2^-8 of its magnitude."""
    stages = -(-int(k) // STAGE_DEPTH)
    r = STAGE_CUTS * 2.0 ** -WGMMA_KEPT_BITS
    rel = r / (1.0 - r) + (2 * int(k) + stages + 2) * 2.0 ** -24
    bound = rel * mag
    if plain is not None:
        bound = bound + 2.0 ** -8 * (plain.abs() + bound)
    return bound


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
