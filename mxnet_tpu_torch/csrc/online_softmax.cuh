// The online-softmax arithmetic shared by flash_attention.cu (K1) and
// paged_attention.cu (K2): "merge one block of keys into one query row".
//
// It is the CUDA form of mxnet_tpu/ops/attention.py::online_block_merge
// (:110-128) and finalize_attention (:163-165).  The serving contract is
// that a paged decode row equals the same row of the full-context
// reference forward (K1) bit for bit, so both kernels must run this exact
// arithmetic: the same dot-product order over D, the same expf, and no
// contraction left to the compiler.  Every add and multiply below is an
// explicit __fadd_rn / __fmul_rn (the sources are also built with
// -fmad=false), so inlining into two kernels cannot change the bits.
//
// The order is the one a warp gives a query row (emulated on the CPU by
// mxnet_tpu_torch/testing/paged_order.py::merge_sequential):
//   - a score: lane t sums q[d] k[d] over d = t, t + 32, ... from +0
//     (lane_dot), then the xor butterfly 16, 8, 4, 2, 1 (warp_sum) —
//     one fixed tree, which K1 forms in one thread (flash_attention.cu);
//   - per block of keys: the block max, rescale, a probability per key
//     (block_prob), the probability and value sums over the block's
//     visible keys in key order, then the fold x * corr + sum.
// Each piece is a function of its own so that K1 and K2 can spread a
// row's keys over threads and warps and still run exactly these
// operations: a score depends on its key alone, the running max after a
// block is a prefix max, a block's sums depend only on its keys and that
// max, and only the fold of the blocks into (l, acc) is serial.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mxt {

constexpr int kWarp = 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxBlock = 128;                          // keys a block
constexpr unsigned kFull = 0xffffffffu;

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

}  // namespace mxt
