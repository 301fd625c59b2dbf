// K9: quantize KV rows per row and append them to one layer's paged
// code pools, int8 or fp8 e4m3, with one fp32 scale a row.
//
// Replaces: mxnet_tpu/quantize.py::kv_quantize_rows (:337-363) together
// with the scatter that stores its codes and scales into the pools,
// mxnet_tpu/serve/model.py::_kv_append (:216-233) under kv_quant.
//
// The contract: codes and scales byte-equal to the plain
// quantize.kv_quantize_rows on the card, because serving's oracle
// fake-quantizes its keys and values with that plain form, and K2q
// dequantizes what this kernel wrote.  Every step is exact or IEEE:
//   amax  = max |x| over the row's (H, D)      (a max is exact in any order;
//                                                a NaN is kept, as jnp.max
//                                                keeps it)
//   scale = amax > 0 ? amax / qmax : 1          (__fdiv_rn; qmax 127 or 448)
//   int8: x / scale rounded half to even and clamped to +-127 (as
//         torch.round then clamp)
//   e4m3: x / scale clamped to +-448, then the round-to-nearest-even
//         conversion __nv_cvt_float_to_fp8
// Non-finite rows follow the reference too.  A row holding a NaN gets
// scale 1 (amax > 0 is false) and a row holding an Inf scale Inf; a NaN
// quotient (the NaN element, or Inf / Inf) passes the clamps unchanged,
// so e4m3 codes it NaN, and int8 converts it with __float2int_rn, which
// gives 0, as the reference's cast of NaN gives on a CPU.
//
// One CTA quantizes one row of K or of V (grid N x 2: both in one
// launch): a block max over the row, then a second pass that writes the
// codes, reading the row again from L1.  Rows bound for the trash page
// may collide there; nothing reads it.
//
// Bound on an H100: bytes.  A row's H x D fp32 values are read once and
// H x D one-byte codes plus a scale written, ~5 bytes an element over
// 3.35 TB/s (2.4 us for a 256-row prefill at H x D = 2048, 0.08 us for
// a decode step's 8 rows, where the launch is the floor).
#include <cstdint>

#include <cuda_fp8.h>

#include "error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* k_rows;
  const float* v_rows;
  long long k_stride, v_stride;  // elements between rows
  const long long* pages;
  const long long* offsets;
  uint8_t* k_codes;
  uint8_t* v_codes;
  float* k_scale;
  float* v_scale;
  int page, row;  // rows a page; elements a row (H x D)
};

// max that keeps a NaN (fmaxf drops one)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// clamp to [-q, q] that keeps a NaN (fminf/fmaxf would map it to a bound)
__device__ __forceinline__ float nan_clamp(float y, float q) {
  return y != y ? y : fminf(fmaxf(y, -q), q);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool kE4M3>
__global__ void __launch_bounds__(kThreads) kv_quant_kernel(const Params p) {
  __shared__ float red[kWarps];
  const int n = blockIdx.x;
  const bool is_v = blockIdx.y != 0;
  const float* x = is_v ? p.v_rows + n * p.v_stride
                        : p.k_rows + n * p.k_stride;
  const int tid = threadIdx.x;
  float m = 0.f;
  for (int e = tid; e < p.row; e += kThreads) m = nan_max(m, fabsf(x[e]));
  m = warp_max(m);
  if (tid % 32 == 0) red[tid / 32] = m;
  __syncthreads();
  float amax = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = nan_max(amax, red[w]);
  const float qmax = kE4M3 ? 448.f : 127.f;
  const float scale = amax > 0.f ? __fdiv_rn(amax, qmax) : 1.f;
  const long long at = p.pages[n] * p.page + p.offsets[n];
  uint8_t* out = (is_v ? p.v_codes : p.k_codes) + at * p.row;
  for (int e = tid; e < p.row; e += kThreads) {
    const float y = __fdiv_rn(x[e], scale);
    if (kE4M3) {
      out[e] = __nv_cvt_float_to_fp8(nan_clamp(y, 448.f), __NV_SATFINITE,
                                     __NV_E4M3);
    } else {
      // round half to even, then clamp; NaN converts to 0
      const int r = max(-127, min(127, __float2int_rn(y)));
      out[e] = static_cast<uint8_t>(static_cast<int8_t>(r));
    }
  }
  if (tid == 0) (is_v ? p.v_scale : p.k_scale)[at] = scale;
}

}  // namespace

// k_rows, v_rows: N rows of H x D contiguous fp32 each, ``*_stride``
// elements apart; pages, offsets: (N,) int64; k_codes, v_codes: one
// layer's (pages + 1, page, H, D) one-byte pools; k_scale, v_scale: its
// (pages + 1, page) fp32 scale pools; e4m3: 0 for int8 codes, 1 for
// e4m3.  Returns cudaGetLastError() after the launch.
extern "C" int mxt_kv_append_quantized(
    const void* k_rows, const void* v_rows, long long k_stride,
    long long v_stride, const void* pages, const void* offsets,
    void* k_codes, void* v_codes, void* k_scale, void* v_scale, int N,
    int page, int row, int e4m3, void* stream) {
  const Params p{static_cast<const float*>(k_rows),
                 static_cast<const float*>(v_rows), k_stride, v_stride,
                 static_cast<const long long*>(pages),
                 static_cast<const long long*>(offsets),
                 static_cast<uint8_t*>(k_codes),
                 static_cast<uint8_t*>(v_codes),
                 static_cast<float*>(k_scale), static_cast<float*>(v_scale),
                 page, row};
  const dim3 grid(N, 2);
  auto st = static_cast<cudaStream_t>(stream);
  if (e4m3)
    kv_quant_kernel<true><<<grid, kThreads, 0, st>>>(p);
  else
    kv_quant_kernel<false><<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
