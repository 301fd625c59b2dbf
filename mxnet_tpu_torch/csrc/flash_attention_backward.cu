// K4: the flash-attention backward in fp32, recomputed from the
// forward's logsumexp.  bf16 inputs go to K8
// (flash_attention_backward_sm90.cu), the tensor-core kernel; this SIMT
// kernel serves fp32 training.
//
// Replaces: the VJP of mxnet_tpu/ops/attention.py::_pallas_attention
// (:497-506), the TPU flash kernel's backward, whose numerics the JAX
// package defines by _flash_backward (:249-302):
//   p = exp(q.k * scale - lse)      (masked pairs give exactly 0)
//   delta_i = sum_d dO[i, d] * O[i, d]
//   ds = p * (dO.v - delta)
//   dv_j = sum_i p_ij dO_i,  dk_j = sum_i ds_ij (q_i * scale),
//   dq_i = scale * sum_j ds_ij k_j.
//
// Bound on an H100: 10 * D flops per visible (query, key) pair (the
// q.k and dO.v dots, and the three rank-1 accumulations), against the
// fp32 SIMT line (67 TFLOP/s); the bytes (q, k, v, O, dO, lse read
// once, dq, dk, dv written once) are small next to them at T = 1024.
//
// Design: three launches on the caller's stream, no atomics, so the
// result is the same bits on every run.
//   1. delta: one warp per query row, from the saved out.
//   2. dK/dV: one warp per key row j; it walks the query rows that see
//      it in increasing i, recomputes p and ds, and keeps dk_j, dv_j in
//      registers.
//   3. dQ: one warp per query row i; it walks its visible keys in
//      increasing j and multiplies by scale at the end (:301).
// A lane holds the row elements d = lane + 32 e (head_dim <= 256), as in
// online_softmax.cuh; each dot is a per-lane sum and an xor butterfly.
// Only real keys are visited, so a ragged last block needs no padding
// and a masked pair contributes nothing.  Four rows of one (batch, head)
// share a thread block, so the rows they walk hit the same L1 lines.
// Plain fp32 SIMT: TF32 tensor cores would break fp32 parity.
#include "error.cuh"
#include "online_softmax.cuh"

namespace {

using mxt::kFull;
using mxt::kMaxDPerLane;
using mxt::kWarp;
using mxt::to_f32;

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * kWarp;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// r[e] = row[lane + 32 e] * mul in fp32; zero past D
template <class T>
__device__ __forceinline__ void load_row(float (&r)[kMaxDPerLane],
                                         const T* __restrict__ row, int D,
                                         int lane, float mul = 1.f) {
#pragma unroll
  for (int e = 0; e < kMaxDPerLane; ++e) {
    const int d = lane + kWarp * e;
    r[e] = d < D ? to_f32(row[d]) * mul : 0.f;
  }
}

template <class T>
__device__ __forceinline__ void store_row(T* __restrict__ row,
                                          const float (&r)[kMaxDPerLane],
                                          int D, int lane, float mul = 1.f) {
#pragma unroll
  for (int e = 0; e < kMaxDPerLane; ++e) {
    const int d = lane + kWarp * e;
    if (d < D) row[d] = mxt::from_f32<T>(r[e] * mul);
  }
}

__device__ __forceinline__ float dot(const float (&a)[kMaxDPerLane],
                                     const float (&b)[kMaxDPerLane]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxDPerLane; ++e) s += a[e] * b[e];
  return warp_sum(s);
}

// delta[i] = sum_d dO[i, d] * O[i, d]
template <class T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int n_rows, int D) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // uniform over the warp
  float o[kMaxDPerLane], g[kMaxDPerLane];
  load_row(o, out + static_cast<size_t>(row) * D, D, lane);
  load_row(g, dout + static_cast<size_t>(row) * D, D, lane);
  const float s = dot(o, g);
  if (lane == 0) delta[row] = s;
}

// one warp per key row j: dk_j, dv_j over the query rows that see j
template <class T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int n_rows, int T_, int D,
                      float scale, int causal) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;
  const int j = row % T_;
  const size_t bh = static_cast<size_t>(row / T_) * T_;
  float kr[kMaxDPerLane], vr[kMaxDPerLane];
  load_row(kr, k + static_cast<size_t>(row) * D, D, lane);
  load_row(vr, v + static_cast<size_t>(row) * D, D, lane);
  float dk_acc[kMaxDPerLane] = {}, dv_acc[kMaxDPerLane] = {};
  float q32[kMaxDPerLane], g[kMaxDPerLane];
  for (int i = causal ? j : 0; i < T_; ++i) {
    // q32 = q * scale rounded once, the JAX package's q32
    load_row(q32, q + (bh + i) * D, D, lane, scale);
    load_row(g, dout + (bh + i) * D, D, lane);
    const float p = expf(dot(q32, kr) - lse[bh + i]);
    const float ds = p * (dot(g, vr) - delta[bh + i]);
#pragma unroll
    for (int e = 0; e < kMaxDPerLane; ++e) {
      dv_acc[e] += p * g[e];
      dk_acc[e] += ds * q32[e];
    }
  }
  store_row(dk + static_cast<size_t>(row) * D, dk_acc, D, lane);
  store_row(dv + static_cast<size_t>(row) * D, dv_acc, D, lane);
}

// one warp per query row i: dq_i over its visible keys, times scale
template <class T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n_rows, int T_, int D, float scale, int causal) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;
  const int i = row % T_;
  const size_t bh = static_cast<size_t>(row / T_) * T_;
  float q32[kMaxDPerLane], g[kMaxDPerLane];
  load_row(q32, q + static_cast<size_t>(row) * D, D, lane, scale);
  load_row(g, dout + static_cast<size_t>(row) * D, D, lane);
  const float lse_i = lse[row];
  const float delta_i = delta[row];
  float dq_acc[kMaxDPerLane] = {};
  float kr[kMaxDPerLane], vr[kMaxDPerLane];
  const int end = causal ? i + 1 : T_;
  for (int j = 0; j < end; ++j) {
    load_row(kr, k + (bh + j) * D, D, lane);
    load_row(vr, v + (bh + j) * D, D, lane);
    const float p = expf(dot(q32, kr) - lse_i);
    const float ds = p * (dot(g, vr) - delta_i);
#pragma unroll
    for (int e = 0; e < kMaxDPerLane; ++e) dq_acc[e] += ds * kr[e];
  }
  store_row(dq + static_cast<size_t>(row) * D, dq_acc, D, lane, scale);
}

template <class T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, int n_bh, int T_, int D, float scale, int causal,
           cudaStream_t stream) {
  const int n_rows = n_bh * T_;
  const int grid = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  flash_bwd_delta_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(out), g_, delta_, n_rows, D);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  flash_bwd_dkdv_kernel<T><<<grid, kThreads, 0, stream>>>(
      q_, k_, v_, g_, lse_, delta_, static_cast<T*>(dk),
      static_cast<T*>(dv), n_rows, T_, D, scale, causal);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  flash_bwd_dq_kernel<T><<<grid, kThreads, 0, stream>>>(
      q_, k_, v_, g_, lse_, delta_, static_cast<T*>(dq), n_rows, T_, D,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv: (n_bh, T, D) contiguous fp32; lse (the
// forward's, K1) and delta (scratch): (n_bh, T) fp32.  All on the
// current device.  Returns cudaGetLastError() after the launches.
extern "C" int mxt_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int n_bh, int T, int D, float scale, int causal,
    void* stream) {
  return launch<float>(q, k, v, out, lse, dout, dq, dk, dv, delta, n_bh, T,
                       D, scale, causal, static_cast<cudaStream_t>(stream));
}
