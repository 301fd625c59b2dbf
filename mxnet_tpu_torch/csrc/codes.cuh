// Element reads of the serving kernels' weights and KV pages, fp32 or
// one-byte codes: kCode 0 = fp32, 1 = int8, 2 = fp8 e4m3 (held as bytes).
//
// A code is dequantized to code * scale, one rounded multiply after an
// exact conversion to fp32 — quantize.dequantize_array and kv_dequantize,
// the values serving's oracle runs on.  The kernels (K3q in linear.cu,
// K2q in paged_attention.cu) dequantize each element before it enters
// their unchanged arithmetic, so their bits are the fp32 kernels' over
// the dequantized values.
#pragma once

#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace mxt {

// The four codes of a word (byte k is element k) as fp32, exactly:
//   int8: in full-rate integer and fp32 operations (the hardware's I2F
//         runs at a quarter of that rate), one byte permute each: a byte
//         with its sign bit flipped is x + 128; placed under the exponent
//         byte 0x4B it reads 2^23 + x + 128, and subtracting 2^23 + 128
//         leaves x (every step exact);
//   e4m3: by the hardware's paired conversion to fp16, which holds every
//         e4m3 value, then to fp32 (both exact); it timed faster on an
//         H100 than the integer route, whose exponent rebias needs a
//         multiply by 2^120 and more integer work.
// A lone code converts as element 0 of a word.
__device__ __forceinline__ float4 int8x4_to_float4(uint32_t v) {
  const uint32_t u = v ^ 0x80808080u;
  const float bias = 8388736.0f;  // 2^23 + 128
  return make_float4(
      __fsub_rn(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)), bias),
      __fsub_rn(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)), bias),
      __fsub_rn(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)), bias),
      __fsub_rn(__int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)), bias));
}

__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t v) {
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v & 0xFFFFu), __NV_E4M3)));
}

__device__ __forceinline__ float4 e4m3x4_to_float4(uint32_t v) {
  const float2 lo = e4m3x2_to_float2(v), hi = e4m3x2_to_float2(v >> 16);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float4 scaled4(float4 v, float s) {
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s),
                     __fmul_rn(v.w, s));
}

// get(p, i, s): element i at p, dequantized with scale s (ignored for
// fp32); get4(p, c4, s): elements 4 c4 .. 4 c4 + 3 (p aligned to 4
// elements); of(b, s): a code already loaded, its byte in b; word(v, s):
// the four codes of a loaded word.
template <int kCode>
struct Codes;

template <>
struct Codes<0> {
  using T = float;
  __device__ static float get(const T* p, int i, float) { return p[i]; }
  __device__ static float4 get4(const T* p, int c4, float) {
    return reinterpret_cast<const float4*>(p)[c4];
  }
};

template <>
struct Codes<1> {
  using T = int8_t;
  __device__ static float of(unsigned b, float s) {
    return __fmul_rn(int8x4_to_float4(b).x, s);
  }
  __device__ static float get(const T* p, int i, float s) {
    return of(static_cast<uint8_t>(p[i]), s);
  }
  __device__ static float4 word(uint32_t v, float s) {
    return scaled4(int8x4_to_float4(v), s);
  }
  __device__ static float4 get4(const T* p, int c4, float s) {
    return word(reinterpret_cast<const uint32_t*>(p)[c4], s);
  }
};

template <>
struct Codes<2> {
  using T = uint8_t;
  __device__ static float of(unsigned b, float s) {
    return __fmul_rn(e4m3x2_to_float2(b & 0xFFu).x, s);
  }
  __device__ static float get(const T* p, int i, float s) {
    return of(p[i], s);
  }
  __device__ static float4 word(uint32_t v, float s) {
    return scaled4(e4m3x4_to_float4(v), s);
  }
  __device__ static float4 get4(const T* p, int c4, float s) {
    return word(reinterpret_cast<const uint32_t*>(p)[c4], s);
  }
};

}  // namespace mxt
