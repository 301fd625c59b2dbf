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
// launch).  Where the row is kThreads x kVals values and its pointers
// allow 16-byte loads, each thread reads its kVals neighbouring values
// once, as float4 loads, keeps them in registers for the block max (an
// unsigned max over |x|'s bits in registers, one warp reduction
// instruction, one combine of the warps' maxima) and codes them from
// there, storing its kVals codes as one 4-, 8- or 16-byte store.  Any
// other row (H x D not kThreads x kVals, rows or pools off a 16-byte
// boundary) runs the same arithmetic as a strided loop that reads the
// row twice, the second time from L1.  Rows bound for the trash page
// may collide there; nothing reads it.
//
// Bound on an H100: bytes.  A row's H x D fp32 values are read once and
// H x D one-byte codes plus a scale written, ~5 bytes an element over
// 3.35 TB/s (1.6 us for a 256-row prefill at H x D = 2048, 0.05 us for
// a decode step's 8 rows, where one launch's latency is the floor: the
// index loads, one read of the row, the block max and one store, in
// that order).  The threads a row come from a sweep of 128, 256 and 512
// at 8 to 256 rows (testing/k9_rtc_variants.py, recorded in PERF.md):
// 512 was the fastest up to 128 rows and as fast as 256 at 256.
#include <cstdint>

#include <cuda_fp8.h>

#include "error.cuh"

namespace {

// serving's rows are H x D = 16 x 128 = 2048 values: kRowThreads threads
// a row, kRowValues / kRowThreads values a thread
constexpr int kRowValues = 2048;
constexpr int kRowThreads = 512;

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
  int vec;        // 1: the registers' path (see vec_path)
};

// |x|'s bits.  An unsigned max over them is the bits of max |x| (finite
// values and Inf order as their magnitudes), or a NaN's wherever the row
// holds one (every NaN's bits lie above Inf's): the max that keeps a NaN,
// as jnp.max does, in one integer instruction a value
__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// clamp to [-q, q] that keeps a NaN (fminf/fmaxf would map it to a bound)
__device__ __forceinline__ float nan_clamp(float y, float q) {
  return y != y ? y : fminf(fmaxf(y, -q), q);
}

template <bool kE4M3>
__device__ __forceinline__ uint32_t code_of(float x, float scale) {
  const float y = __fdiv_rn(x, scale);
  if (kE4M3)
    return __nv_cvt_float_to_fp8(nan_clamp(y, 448.f), __NV_SATFINITE,
                                 __NV_E4M3);
  // round half to even, then clamp; NaN converts to 0
  const int r = max(-127, min(127, __float2int_rn(y)));
  return static_cast<uint8_t>(static_cast<int8_t>(r));
}

// kVals codes packed little-endian into kVals / 4 words, one store
template <int kVals>
__device__ __forceinline__ void store_codes(uint8_t* dst,
                                            const uint32_t (&w)[kVals / 4]) {
  if constexpr (kVals == 4)
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  else if constexpr (kVals == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kE4M3, int kThreads, int kVals>
__global__ void __launch_bounds__(kThreads) kv_quant_kernel(const Params p) {
  static_assert(kVals == 4 || kVals == 8 || kVals == 16, "kVals");
  static_assert(kThreads % 128 == 0, "the combine reads the warps' maxima "
                "four at a time");
  constexpr int kWarps = kThreads / 32;
  __shared__ __align__(16) uint32_t red[kWarps];
  const int n = blockIdx.x;
  const bool is_v = blockIdx.y != 0;
  const float* x = is_v ? p.v_rows + n * p.v_stride
                        : p.k_rows + n * p.k_stride;
  const int tid = threadIdx.x;
  // the row's place in the pools, loaded before the row is waited for
  const long long at = p.pages[n] * p.page + p.offsets[n];
  float v[kVals];
  uint32_t m = 0;
  if (p.vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x) + tid * (kVals / 4);
#pragma unroll
    for (int j = 0; j < kVals / 4; ++j) {
      const float4 t = __ldg(x4 + j);
      v[4 * j] = t.x;
      v[4 * j + 1] = t.y;
      v[4 * j + 2] = t.z;
      v[4 * j + 3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < kVals; ++j) m = max(m, abs_bits(v[j]));
  } else {
    for (int e = tid; e < p.row; e += kThreads) m = max(m, abs_bits(x[e]));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if (tid % 32 == 0) red[tid / 32] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps / 4; ++w) {
    const uint4 r = reinterpret_cast<const uint4*>(red)[w];
    m = max(max(m, r.x), max(r.y, max(r.z, r.w)));
  }
  const float amax = __uint_as_float(m);  // NaN where the row holds one
  const float qmax = kE4M3 ? 448.f : 127.f;
  const float scale = amax > 0.f ? __fdiv_rn(amax, qmax) : 1.f;
  uint8_t* out = (is_v ? p.v_codes : p.k_codes) + at * p.row;
  if (p.vec) {
    uint32_t w[kVals / 4] = {};
#pragma unroll
    for (int j = 0; j < kVals; ++j)
      w[j / 4] |= code_of<kE4M3>(v[j], scale) << (8 * (j % 4));
    store_codes<kVals>(out + tid * kVals, w);
  } else {
    for (int e = tid; e < p.row; e += kThreads)
      out[e] = static_cast<uint8_t>(code_of<kE4M3>(x[e], scale));
  }
  if (tid == 0) (is_v ? p.v_scale : p.k_scale)[at] = scale;
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// whether the rows of p take the registers' path at kThreads x kVals: the
// row that long, every row's start on 16 bytes for the float4 loads, and
// the code pools on kVals bytes for the packed stores (a row's codes
// start at a multiple of the row's length)
bool vec_path(const Params& p, int threads, int vals) {
  return p.row == threads * vals && aligned(p.k_rows, 16) &&
         aligned(p.v_rows, 16) && p.k_stride % 4 == 0 &&
         p.v_stride % 4 == 0 && aligned(p.k_codes, vals) &&
         aligned(p.v_codes, vals);
}

template <bool kE4M3>
void launch(Params p, int N, cudaStream_t st) {
  constexpr int kVals = kRowValues / kRowThreads;
  p.vec = vec_path(p, kRowThreads, kVals);
  kv_quant_kernel<kE4M3, kRowThreads, kVals>
      <<<dim3(N, 2), kRowThreads, 0, st>>>(p);
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
                 page, row, 0};
  auto st = static_cast<cudaStream_t>(stream);
  if (e4m3)
    launch<true>(p, N, st);
  else
    launch<false>(p, N, st);
  return static_cast<int>(cudaGetLastError());
}
