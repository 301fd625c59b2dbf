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
//
// The pieces of that arithmetic are separate functions (lane_dot,
// warp_sum, rescale, block_prob, fold), so that K2 can spread one row's
// keys over many warps and still run exactly these operations: a score
// depends on its key alone, the running max after a block is a prefix
// max, a block's probability and value sums depend only on its keys and
// that max, and only the fold of the blocks into (l, acc) is serial.
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

// Lane ``lane``'s share of a dot product: its elements d = lane + 32 i,
// in increasing i, from +0, each product and add rounded on its own.
// ``k(i)`` gives the key's element lane + 32 i (read only where d < D).
template <int N, class Key>
__device__ __forceinline__ float lane_dot(const float (&qs)[N], const Key& k,
                                          int D, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (lane + kWarp * i < D) s = __fadd_rn(s, __fmul_rn(qs[i], k(i)));
  return s;
}

// The xor butterfly 16, 8, 4, 2, 1 over the warp.  Float addition is
// commutative, so both partners of every step get the same bits and
// every lane ends with the identical sum.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// Dot of the scaled query with one key row: lane_dot, then warp_sum.
template <class T>
__device__ __forceinline__ float row_dot(const float (&qs)[kMaxDPerLane],
                                         const T* __restrict__ k, int D,
                                         int lane) {
  return warp_sum(lane_dot(
      qs, [&](int i) { return to_f32(k[lane + kWarp * i]); }, D, lane));
}

// The running max after a block whose visible scores peak at ``bmax``
// (-inf when none is visible), the shift its probabilities take, and the
// factor that rescales the state merged before it (0 while nothing was
// seen: the guards of online_block_merge).
struct Rescale {
  float m, safe, corr;
};

__device__ __forceinline__ Rescale rescale(float m, float bmax) {
  const float new_m = fmaxf(m, bmax);
  const float safe = isfinite(new_m) ? new_m : 0.f;
  const float corr = isfinite(m) ? expf(__fsub_rn(m, safe)) : 0.f;
  return Rescale{new_m, safe, corr};
}

// A key's probability; a masked key (score -inf) gives 0.
__device__ __forceinline__ float block_prob(float s, float safe) {
  return isfinite(s) ? expf(__fsub_rn(s, safe)) : 0.f;
}

// One step of the serial fold over blocks: x * corr + the block's sum.
__device__ __forceinline__ float fold(float x, float corr, float part) {
  return __fadd_rn(__fmul_rn(x, corr), part);
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
  const Rescale rs = rescale(st.m, bmax);
  // pass 2: probabilities (one expf per lane), then the weighted sum of
  // the visible keys' values in key order
  float psum = 0.f;
  float pv[kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) pv[i] = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxBlockChunks; ++c) {
    if (c * kWarp >= B) break;
    const float p = block_prob(sc[c], rs.safe);
    unsigned mask = __ballot_sync(kFull, isfinite(sc[c]));
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
  st.l = fold(st.l, rs.corr, psum);
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i)
    st.acc[i] = fold(st.acc[i], rs.corr, pv[i]);
  st.m = rs.m;
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
