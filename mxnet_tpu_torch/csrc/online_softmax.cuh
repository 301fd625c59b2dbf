// The online-softmax step shared by flash_attention.cu (K1) and
// paged_attention.cu (K2): "merge one block of keys into one query row".
//
// It is the CUDA form of mxnet_tpu/ops/attention.py::online_block_merge
// (:110-128) and finalize_attention (:163-165).  The serving contract is
// that a paged decode row equals the same row of the full-context
// reference forward bit for bit, so both kernels must run this exact
// arithmetic: the same dot-product order over D, the same expf, and no
// contraction left to the compiler.  Every add and multiply below is an
// explicit __fadd_rn / __fmul_rn (the sources are also built with
// -fmad=false), so inlining into two kernels cannot change the bits.
//
// Element type: K1 reads fp32 rows, K2 fp32 pages (bf16 attention runs
// on the tensor cores in K7/K8, outside this contract).  Loads go
// through to_f32, the identity for fp32.
//
// Layout: one warp owns one query row.  Lane t holds the row's elements
// d = t, t + 32, ... of the scaled query and of the accumulator, so a
// row's head_dim may reach 32 * kMaxDPerLane.  A block of keys is
// visited in two passes: scores (one warp-wide dot per visible key,
// identical on every lane), then probabilities and the weighted sum of
// values, in key order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mxt {

constexpr int kWarp = 32;
constexpr int kMaxDPerLane = 8;                         // head_dim <= 256
constexpr int kMaxBlockChunks = 4;                      // block <= 128 keys
constexpr int kMaxHeadDim = kWarp * kMaxDPerLane;
constexpr int kMaxBlock = kWarp * kMaxBlockChunks;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct RowState {
  float m;                    // running max of the scores seen
  float l;                    // running softmax denominator
  float acc[kMaxDPerLane];    // running weighted sum of values
};

__device__ __forceinline__ void row_init(RowState& st) {
  st.m = -INFINITY;
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) st.acc[i] = 0.f;
}

// qs[i] = q[lane + 32 i] * scale, rounded once (the JAX package's
// ``q32 = q * scale`` before any dot); zero past D.
template <class T>
__device__ __forceinline__ void load_scaled_query(float (&qs)[kMaxDPerLane],
                                                  const T* __restrict__ q,
                                                  int D, float scale,
                                                  int lane) {
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) {
    const int d = lane + kWarp * i;
    qs[i] = d < D ? __fmul_rn(to_f32(q[d]), scale) : 0.f;
  }
}

// Dot of the scaled query with one key row.  Each lane sums its own
// elements in increasing d, then an xor butterfly adds the lanes.  Float
// addition is commutative, so both partners of every butterfly step get
// the same bits and every lane ends with the identical score.
template <class T>
__device__ __forceinline__ float row_dot(const float (&qs)[kMaxDPerLane],
                                         const T* __restrict__ k, int D,
                                         int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) {
    const int d = lane + kWarp * i;
    if (d < D) s = __fadd_rn(s, __fmul_rn(qs[i], to_f32(k[d])));
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// Merge one block of B keys into the row.  ``rows(j, kp, vp)`` says
// whether key j of the block is visible to this row and, if so, points
// kp/vp at its key and value rows; its answer must be uniform across the
// warp.  A block with no visible key is an exact no-op (correction 1,
// nothing added), the guards of online_block_merge.  T is the element
// type of the key and value rows.
template <class T = float, class Rows>
__device__ __forceinline__ void merge_block(RowState& st,
                                            const float (&qs)[kMaxDPerLane],
                                            int D, int B, int lane,
                                            const Rows& rows) {
  const T* kp;
  const T* vp;
  // pass 1: lane t keeps the score of key c*32 + t of chunk c
  float sc[kMaxBlockChunks];
  float bmax = -INFINITY;
#pragma unroll
  for (int c = 0; c < kMaxBlockChunks; ++c) {
    sc[c] = -INFINITY;
    const int n = min(kWarp, B - c * kWarp);
    for (int t = 0; t < n; ++t) {
      if (!rows(c * kWarp + t, kp, vp)) continue;
      const float s = row_dot(qs, kp, D, lane);
      if (lane == t) sc[c] = s;
      bmax = fmaxf(bmax, s);
    }
  }
  const float new_m = fmaxf(st.m, bmax);
  const float safe = isfinite(new_m) ? new_m : 0.f;
  const float corr = isfinite(st.m) ? expf(__fsub_rn(st.m, safe)) : 0.f;
  // pass 2: probabilities (one expf per lane), then the weighted sum of
  // the visible keys' values in key order
  float psum = 0.f;
  float pv[kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) pv[i] = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxBlockChunks; ++c) {
    if (c * kWarp >= B) break;
    const bool vis = isfinite(sc[c]);
    const float p = vis ? expf(__fsub_rn(sc[c], safe)) : 0.f;
    unsigned mask = __ballot_sync(kFull, vis);
    while (mask) {
      const int t = __ffs(mask) - 1;
      mask &= mask - 1;
      const float pt = __shfl_sync(kFull, p, t);
      rows(c * kWarp + t, kp, vp);
      psum = __fadd_rn(psum, pt);
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + kWarp * i;
        if (d < D) pv[i] = __fadd_rn(pv[i], __fmul_rn(pt, to_f32(vp[d])));
      }
    }
  }
  st.l = __fadd_rn(__fmul_rn(st.l, corr), psum);
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i)
    st.acc[i] = __fadd_rn(__fmul_rn(st.acc[i], corr), pv[i]);
  st.m = new_m;
}

// out = acc / max(l, 1e-20): a row that saw no key (an idle decode slot)
// gives 0, not NaN.  The fp32 quotient is rounded to T once.
template <class T>
__device__ __forceinline__ void store_row(const RowState& st,
                                          T* __restrict__ out, int D,
                                          int lane) {
  const float den = fmaxf(st.l, 1e-20f);
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) {
    const int d = lane + kWarp * i;
    if (d < D) out[d] = from_f32<T>(__fdiv_rn(st.acc[i], den));
  }
}

}  // namespace mxt
