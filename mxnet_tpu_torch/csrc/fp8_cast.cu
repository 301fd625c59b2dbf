// K12: the scaled saturating cast of fp8 training, to e4m3 or e5m2 codes,
// with the transposed codes and the operand's amax from the same read.
//
// Replaces: the quantizing half of mxnet_tpu/quantize.py::_fp8_dot_fn
// (:512) — `_fake_cast` (:504) of the forward operands x and w at their
// delayed scales, of the cotangent g at its current scale in `bwd`
// (:544-547) — and the amaxes fp8_apply_dot (:565) records for the
// history.  The JAX package fake-casts (quantize, then dequantize in the
// compute dtype) and leaves the product to XLA; the port keeps the codes
// and hands them to K11 (fp8_gemm.cu), which multiplies them on the
// tensor cores.
//
// The contract: codes byte-equal to the plain version
// (ops/fp8_ops.py::fp8_cast_plain) and so to the JAX package's casts.
// Every step is exact or IEEE:
//   q    = x / scale                  (__fdiv_rn; x read as fp32, a bf16
//                                      input widened exactly)
//   code = round-to-nearest-even of clamp(q, -qmax, qmax) (qmax 448 for
//          e4m3, 57344 for e5m2), the hardware's satfinite conversion;
//          a NaN q is sign | 0x7F (e4m3) or sign | 0x7E (e5m2), the codes
//          ml_dtypes gives a NaN (the reference's clip keeps a NaN).
//   amax = max |x| over the operand, a max over the bits of |x| as
//          unsigned integers: exact in any order, and a NaN (whose bits
//          exceed Inf's) comes out as NaN, as jnp.max gives it.
// Codes are written with a row pitch rounded up to 16 bytes, the pad
// zero (+0 in both formats), so K11 can read any row in 16-byte copies
// and run its contraction over the pad; the transposed codes
// (cols x rows, pitch rows rounded up to 16) are K11's operands for the
// backward products, whose contraction runs over the other axis:
// fp8 MMA on sm_90 takes both operands K-major and ldmatrix has no 8-bit
// transpose there, so the transpose is made here, from shared memory,
// and never by a separate pass.
//
// One CTA of 256 threads takes a 64 x 64 tile: each value is read once
// (neighbouring threads on neighbouring columns), its code written to
// the row-major codes and kept in a shared tile, from which the
// transposed codes are written (neighbouring threads on neighbouring
// rows).  The amax is one warp reduction and one atomicMax a warp; the
// entry clears it on the stream first.  The cotangent's current scale
// needs its amax before its codes: the wrapper launches this kernel
// twice, once with no code outputs (the amax pass) and once with no amax.
//
// Bound on an H100: bytes.  An element is read once (4 bytes fp32, 2
// bf16) and written twice as codes (1 byte each), over 3.35 TB/s.
#include <cstdint>

#include <cuda_fp8.h>

#include "error.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float read_value(const void* x, size_t i,
                                            int bf16) {
  if (bf16) {
    const uint16_t h = static_cast<const uint16_t*>(x)[i];
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  }
  return static_cast<const float*>(x)[i];
}

// kKind 0: e4m3 (qmax 448), 1: e5m2 (qmax 57344)
template <int kKind>
__device__ __forceinline__ uint8_t encode(float q) {
  if (q != q) {
    return static_cast<uint8_t>((__float_as_uint(q) >> 24) & 0x80u) |
           (kKind == 0 ? 0x7Fu : 0x7Eu);
  }
  const float qmax = kKind == 0 ? 448.0f : 57344.0f;
  q = fminf(fmaxf(q, -qmax), qmax);
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(
      q, __NV_SATFINITE, kKind == 0 ? __NV_E4M3 : __NV_E5M2));
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    fp8_cast_kernel(const void* __restrict__ x, int bf16, int rows, int cols,
                    const float* __restrict__ scale,
                    uint8_t* __restrict__ codes, int ldc,
                    uint8_t* __restrict__ codes_t, int ldt,
                    unsigned* __restrict__ amax) {
  // a row of 68 bytes is 17 words: the transposed read (neighbouring
  // threads on neighbouring rows) touches 32 distinct banks
  __shared__ uint8_t tile[kTile][kTile + 4];
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const bool coded = codes != nullptr || codes_t != nullptr;
  const float s = coded ? *scale : 1.0f;
  unsigned m = 0;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int gr = r0 + r, gc = c0 + c;
    uint8_t code = 0;
    if (gr < rows && gc < cols) {
      const float v = read_value(x, static_cast<size_t>(gr) * cols + gc, bf16);
      m = max(m, __float_as_uint(v) & 0x7FFFFFFFu);
      if (coded) code = encode<kKind>(__fdiv_rn(v, s));
    }
    if (codes != nullptr && gr < rows && gc < ldc)
      codes[static_cast<size_t>(gr) * ldc + gc] = code;
    tile[r][c] = code;
  }
  if (amax != nullptr) {
    m = __reduce_max_sync(0xFFFFFFFFu, m);
    if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(amax, m);
  }
  if (codes_t == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int c = i / kTile, r = i % kTile;
    const int gc = c0 + c, gr = r0 + r;
    if (gc < cols && gr < ldt)
      codes_t[static_cast<size_t>(gc) * ldt + gr] = tile[r][c];
  }
}

}  // namespace

// x: (rows, cols) contiguous, fp32 (bf16 == 0) or bf16 (bf16 == 1);
// scale: one device float (unused, and may be null, when no codes are
// asked for); kind 0 = e4m3, 1 = e5m2; codes: (rows, ldc) bytes or null;
// codes_t: (cols, ldt) bytes or null; amax: one device float (its bits
// as an unsigned max) or null.  ldc >= cols and ldt >= rows, multiples
// of 16; the pads are written as zero codes.
extern "C" int mxt_fp8_cast(const void* x, int bf16, int rows, int cols,
                            const float* scale, int kind, void* codes,
                            int ldc, void* codes_t, int ldt, void* amax,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 0 || cols < 0 || (kind != 0 && kind != 1) ||
      (codes != nullptr && (ldc < cols || ldc % 16 != 0)) ||
      (codes_t != nullptr && (ldt < rows || ldt % 16 != 0)) ||
      ((codes != nullptr || codes_t != nullptr) && scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (amax != nullptr) {
    cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(float), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int wc = codes != nullptr ? ldc : cols;
  const int wr = codes_t != nullptr ? ldt : rows;
  if (wc == 0 || wr == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((wc + kTile - 1) / kTile, (wr + kTile - 1) / kTile);
  uint8_t* c = static_cast<uint8_t*>(codes);
  uint8_t* ct = static_cast<uint8_t*>(codes_t);
  unsigned* a = static_cast<unsigned*>(amax);
  if (kind == 0)
    fp8_cast_kernel<0><<<grid, kThreads, 0, st>>>(x, bf16, rows, cols, scale,
                                                  c, ldc, ct, ldt, a);
  else
    fp8_cast_kernel<1><<<grid, kThreads, 0, st>>>(x, bf16, rows, cols, scale,
                                                  c, ldc, ct, ldt, a);
  return static_cast<int>(cudaGetLastError());
}
