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
// Bound on an H100: operations.  10 * D flops a visible (query, key)
// pair (the q.k and dO.v dots and the three rank-1 products), 14 * D
// with the dQ pass's recompute of q.k and dO.v, against 67 TFLOP/s of
// fp32 SIMT; q, k, v, O, dO, lse are read and dq, dk, dv written once, a
// few MB at T = 1024.
//
// Design (FA2's, in SIMT fp32): every operand of a product is staged in
// shared memory once per tile and reused across the tile, so the work is
// register-blocked outer products with few shared-memory reads per FMA.
//   1. delta: one warp per query row, from the saved out.
//   2. dK/dV: a CTA holds BK keys (k, v staged) and a thread's share of
//      dK and dV in registers.  It walks the query tiles that see its
//      keys (from the diagonal when causal), staging scaled q, dO, lse
//      and delta; forms S = q.k and dP = dO.v for the BQ x BK tile (a
//      thread 4 x 4 of each, float4 reads along d), then P = exp(S - lse)
//      (0 where masked) and dS = P (dP - delta), which pass through
//      shared memory transposed for dV += P^T dO and dK += dS^T q.
//   3. dQ: a CTA holds BQ queries and walks the key tiles they see,
//      recomputing S and dP, and accumulates dQ += dS k; times scale at
//      the end.
// No atomics: each output element is summed by one thread in a fixed
// order, so a rerun gives the same bits, and every step is linear in dO,
// so K4(2 dO) is exactly 2 K4(dO).  Each tile's contribution is summed
// on its own and then added to the total: one FMA chain over all T
// queries (as a plain GEMM over T sums) left dV's worst error against
// fp64 at T = 1024 well above SDPA's (PERF.md, section 6); a chain of BQ
// and then one of T / BQ adds shortens the error's random walk.  Built
// without -fmad=false (no bit contract; contraction is fixed at compile
// time).  Heavy causal tiles launch first.  Plain fp32 SIMT: TF32 tensor
// cores would break fp32 parity.
#include "error.cuh"
#include "per_device.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kSmemMax = 227 * 1024;

// DPL: head-dim words a lane of the old per-row layout, DP = 32 DPL the
// padded head dim
template <int DPL>
struct Cfg {
  static constexpr int DP = kWarp * DPL;
  static constexpr int DS = DP + 4;           // row stride of staged rows
  static constexpr int BQ = DPL == 8 ? 32 : 64;
  static constexpr int BK = BQ;
  static constexpr int BP = BQ + 4;           // row stride of P, dS tiles
  static constexpr int MA = BQ / 16;          // queries of S a thread
  static constexpr int MB = BK / 16;          // keys of S a thread
  static constexpr int DT = DP / 16;          // d a thread in the products
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* out;
  const float* lse;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* delta;
  int n_bh, T, D, causal, tiles;
  float scale;
};

// delta[i] = sum_d dO[i, d] * O[i, d]; one warp a row
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const float* __restrict__ out,
                       const float* __restrict__ dout,
                       float* __restrict__ delta, int n_rows, int D) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // uniform over the warp
  const size_t at = static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int d = lane; d < D; d += kWarp)
    s = fmaf(out[at + d], dout[at + d], s);
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if (lane == 0) delta[row] = s;
}

// Stages rows [0, n) of ``src`` (row stride D) into dst[row * C::DS + d],
// d < DP, times ``mul`` (1 leaves them as they are); zero past D and from
// row n on.
template <class C>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int n,
                                      int rows, int D, float mul, int tid) {
  if (D % 4 == 0) {
    constexpr int DP4 = C::DP / 4;
    for (int u = tid; u < rows * DP4; u += kThreads) {
      const int row = u / DP4, d4 = u % DP4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n && 4 * d4 < D)
        x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(row)
                                             * D + 4 * d4);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
      *reinterpret_cast<float4*>(dst + row * C::DS + 4 * d4) = x;
    }
  } else {
    for (int u = tid; u < rows * C::DP; u += kThreads) {
      const int row = u / C::DP, d = u % C::DP;
      dst[row * C::DS + d] =
          (row < n && d < D) ? src[static_cast<size_t>(row) * D + d] * mul
                             : 0.f;
    }
  }
}

// The d of a thread's element e in the (rows x DP) products: float4s 64
// apart at column tx (DT >= 4), or DT consecutive words (DT = 2).
template <class C>
__device__ __forceinline__ int prod_d(int tx, int e) {
  return C::DT >= 4 ? (e / 4) * 64 + tx * 4 + e % 4 : tx * C::DT + e;
}

// A thread's DT words of staged row ``row`` at its columns
template <class C>
__device__ __forceinline__ void load_cols(float (&r)[C::DT],
                                          const float* __restrict__ row,
                                          int tx) {
  if constexpr (C::DT >= 4) {
#pragma unroll
    for (int c = 0; c < C::DT / 4; ++c) {
      const float4 x =
          *reinterpret_cast<const float4*>(row + c * 64 + tx * 4);
      r[4 * c] = x.x;
      r[4 * c + 1] = x.y;
      r[4 * c + 2] = x.z;
      r[4 * c + 3] = x.w;
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(row + tx * 2);
    r[0] = x.x;
    r[1] = x.y;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// S = Q K^T and dP = G V^T for the thread's queries ty + 16 a and keys
// tx + 16 b of the staged tiles (rows of stride DS).
template <class C>
__device__ __forceinline__ void tile_s_dp(float (&s)[C::MA][C::MB],
                                          float (&dp)[C::MA][C::MB],
                                          const float* __restrict__ Qs,
                                          const float* __restrict__ Gs,
                                          const float* __restrict__ Ks,
                                          const float* __restrict__ Vs,
                                          int ty, int tx) {
#pragma unroll
  for (int a = 0; a < C::MA; ++a)
#pragma unroll
    for (int b = 0; b < C::MB; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < C::DP; d += 4) {
    float4 x[C::MA], y[C::MB];
#pragma unroll
    for (int a = 0; a < C::MA; ++a)
      x[a] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * C::DS + d);
#pragma unroll
    for (int b = 0; b < C::MB; ++b)
      y[b] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * b) * C::DS + d);
#pragma unroll
    for (int a = 0; a < C::MA; ++a)
#pragma unroll
      for (int b = 0; b < C::MB; ++b) s[a][b] = dot4(x[a], y[b], s[a][b]);
#pragma unroll
    for (int a = 0; a < C::MA; ++a)
      x[a] = *reinterpret_cast<const float4*>(Gs + (ty + 16 * a) * C::DS + d);
#pragma unroll
    for (int b = 0; b < C::MB; ++b)
      y[b] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * b) * C::DS + d);
#pragma unroll
    for (int a = 0; a < C::MA; ++a)
#pragma unroll
      for (int b = 0; b < C::MB; ++b) dp[a][b] = dot4(x[a], y[b], dp[a][b]);
  }
}

// P and dS of the thread's tile in place of S and dP: p = exp(s - lse)
// and ds = p (dp - delta) where the pair is visible, 0 elsewhere.
template <class C>
__device__ __forceinline__ void tile_p_ds(float (&s)[C::MA][C::MB],
                                          float (&dp)[C::MA][C::MB],
                                          const float* __restrict__ lse_s,
                                          const float* __restrict__ dl_s,
                                          int q0, int k0, int T, int causal,
                                          int ty, int tx) {
#pragma unroll
  for (int a = 0; a < C::MA; ++a) {
    const int i = q0 + ty + 16 * a;
    const float li = lse_s[ty + 16 * a], di = dl_s[ty + 16 * a];
#pragma unroll
    for (int b = 0; b < C::MB; ++b) {
      const int j = k0 + tx + 16 * b;
      const bool vis = i < T && j < T && (!causal || j <= i);
      const float p = vis ? expf(s[a][b] - li) : 0.f;
      s[a][b] = p;
      dp[a][b] = vis ? p * (dp[a][b] - di) : 0.f;
    }
  }
}

// lse and delta of query rows [q0, q0 + BQ), 0 past T
template <class C>
__device__ __forceinline__ void stage_stats(float* __restrict__ lse_s,
                                            float* __restrict__ dl_s,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            int q0, int T, int tid) {
  if (tid < C::BQ) {
    const bool in = q0 + tid < T;
    lse_s[tid] = in ? lse[q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[q0 + tid] : 0.f;
  }
}

// Stores a thread's rows (ty + 16 a, or the keys of the dK/dV layout) of
// a (rows x DP) product, times ``mul``, where row < T and d < D.
template <class C, int M>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[M][C::DT],
                                           int r0, int T, int D, float mul,
                                           int ty, int tx) {
#pragma unroll
  for (int a = 0; a < M; ++a) {
    const int row = r0 + ty + 16 * a;
    if (row >= T) continue;
#pragma unroll
    for (int e = 0; e < C::DT; ++e) {
      const int d = prod_d<C>(tx, e);
      if (d < D) dst[static_cast<size_t>(row) * D + d] = acc[a][e] * mul;
    }
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + C::BK * C::DS;
  float* Qs = Vs + C::BK * C::DS;
  float* Gs = Qs + C::BQ * C::DS;
  float* Pt = Gs + C::BQ * C::DS;  // P^T: key rows, BP stride
  float* Dt = Pt + C::BK * C::BP;  // dS^T
  float* lse_s = Dt + C::BK * C::BP;
  float* dl_s = lse_s + C::BQ;

  const int T = p.T, D = p.D, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x % p.n_bh;
  const int k0 = (blockIdx.x / p.n_bh) * C::BK;  // heavy (early) keys first
  const size_t base = static_cast<size_t>(bh) * T * D;
  const size_t rbase = static_cast<size_t>(bh) * T;
  const int nk = min(C::BK, T - k0);
  stage<C>(Ks, p.k + base + static_cast<size_t>(k0) * D, nk, C::BK, D, 1.f,
           tid);
  stage<C>(Vs, p.v + base + static_cast<size_t>(k0) * D, nk, C::BK, D, 1.f,
           tid);

  float dk[C::MB][C::DT], dv[C::MB][C::DT];
#pragma unroll
  for (int b = 0; b < C::MB; ++b)
#pragma unroll
    for (int e = 0; e < C::DT; ++e) dk[b][e] = dv[b][e] = 0.f;

  for (int q0 = p.causal ? k0 : 0; q0 < T; q0 += C::BQ) {
    const int nq = min(C::BQ, T - q0);
    __syncthreads();  // the previous tile's reads are done
    stage<C>(Qs, p.q + base + static_cast<size_t>(q0) * D, nq, C::BQ, D,
             p.scale, tid);
    stage<C>(Gs, p.dout + base + static_cast<size_t>(q0) * D, nq, C::BQ, D,
             1.f, tid);
    stage_stats<C>(lse_s, dl_s, p.lse + rbase, p.delta + rbase, q0, T, tid);
    __syncthreads();
    float s[C::MA][C::MB], dp[C::MA][C::MB];
    tile_s_dp<C>(s, dp, Qs, Gs, Ks, Vs, ty, tx);
    tile_p_ds<C>(s, dp, lse_s, dl_s, q0, k0, T, p.causal, ty, tx);
#pragma unroll
    for (int a = 0; a < C::MA; ++a)
#pragma unroll
      for (int b = 0; b < C::MB; ++b) {
        Pt[(tx + 16 * b) * C::BP + ty + 16 * a] = s[a][b];
        Dt[(tx + 16 * b) * C::BP + ty + 16 * a] = dp[a][b];
      }
    __syncthreads();
    // dV += P^T dO and dK += dS^T q over the tile's queries, in order,
    // summed a tile at a time; this thread's keys are ty + 16 b
    float dkt[C::MB][C::DT], dvt[C::MB][C::DT];
#pragma unroll
    for (int b = 0; b < C::MB; ++b)
#pragma unroll
      for (int e = 0; e < C::DT; ++e) dkt[b][e] = dvt[b][e] = 0.f;
#pragma unroll 1
    for (int i4 = 0; i4 < C::BQ; i4 += 4) {
      float4 pk[C::MB], sk[C::MB];
#pragma unroll
      for (int b = 0; b < C::MB; ++b) {
        pk[b] = *reinterpret_cast<const float4*>(Pt + (ty + 16 * b) * C::BP
                                                 + i4);
        sk[b] = *reinterpret_cast<const float4*>(Dt + (ty + 16 * b) * C::BP
                                                 + i4);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        float g[C::DT], x[C::DT];
        load_cols<C>(g, Gs + (i4 + ii) * C::DS, tx);
        load_cols<C>(x, Qs + (i4 + ii) * C::DS, tx);
#pragma unroll
        for (int b = 0; b < C::MB; ++b) {
          const float pb = (&pk[b].x)[ii], sb = (&sk[b].x)[ii];
#pragma unroll
          for (int e = 0; e < C::DT; ++e) {
            dvt[b][e] = fmaf(pb, g[e], dvt[b][e]);
            dkt[b][e] = fmaf(sb, x[e], dkt[b][e]);
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < C::MB; ++b)
#pragma unroll
      for (int e = 0; e < C::DT; ++e) {
        dv[b][e] += dvt[b][e];
        dk[b][e] += dkt[b][e];
      }
  }
  store_rows<C, C::MB>(p.dk + base, dk, k0, T, D, 1.f, ty, tx);
  store_rows<C, C::MB>(p.dv + base, dv, k0, T, D, 1.f, ty, tx);
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const Params p) {
  constexpr int BS = C::BK + 4;  // row stride of the dS tile
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + C::BQ * C::DS;
  float* Ks = Gs + C::BQ * C::DS;
  float* Vs = Ks + C::BK * C::DS;
  float* Ss = Vs + C::BK * C::DS;  // dS: query rows, BS stride
  float* lse_s = Ss + C::BQ * BS;
  float* dl_s = lse_s + C::BQ;

  const int T = p.T, D = p.D, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x % p.n_bh;
  const int q0 = (p.tiles - 1 - blockIdx.x / p.n_bh) * C::BQ;  // heavy first
  const size_t base = static_cast<size_t>(bh) * T * D;
  const size_t rbase = static_cast<size_t>(bh) * T;
  const int nq = min(C::BQ, T - q0);
  stage<C>(Qs, p.q + base + static_cast<size_t>(q0) * D, nq, C::BQ, D,
           p.scale, tid);
  stage<C>(Gs, p.dout + base + static_cast<size_t>(q0) * D, nq, C::BQ, D,
           1.f, tid);
  stage_stats<C>(lse_s, dl_s, p.lse + rbase, p.delta + rbase, q0, T, tid);

  float dq[C::MA][C::DT];
#pragma unroll
  for (int a = 0; a < C::MA; ++a)
#pragma unroll
    for (int e = 0; e < C::DT; ++e) dq[a][e] = 0.f;

  const int key_end = p.causal ? min(T, q0 + C::BQ) : T;
  for (int k0 = 0; k0 < key_end; k0 += C::BK) {
    const int nk = min(C::BK, T - k0);
    __syncthreads();
    stage<C>(Ks, p.k + base + static_cast<size_t>(k0) * D, nk, C::BK, D, 1.f,
             tid);
    stage<C>(Vs, p.v + base + static_cast<size_t>(k0) * D, nk, C::BK, D, 1.f,
             tid);
    __syncthreads();
    float s[C::MA][C::MB], dp[C::MA][C::MB];
    tile_s_dp<C>(s, dp, Qs, Gs, Ks, Vs, ty, tx);
    tile_p_ds<C>(s, dp, lse_s, dl_s, q0, k0, T, p.causal, ty, tx);
#pragma unroll
    for (int a = 0; a < C::MA; ++a)
#pragma unroll
      for (int b = 0; b < C::MB; ++b)
        Ss[(ty + 16 * a) * BS + tx + 16 * b] = dp[a][b];
    __syncthreads();
    // dQ += dS k over the tile's keys, in order, summed a tile at a time;
    // this thread's queries are ty + 16 a
    float dqt[C::MA][C::DT];
#pragma unroll
    for (int a = 0; a < C::MA; ++a)
#pragma unroll
      for (int e = 0; e < C::DT; ++e) dqt[a][e] = 0.f;
#pragma unroll 1
    for (int j4 = 0; j4 < C::BK; j4 += 4) {
      float4 sq[C::MA];
#pragma unroll
      for (int a = 0; a < C::MA; ++a)
        sq[a] = *reinterpret_cast<const float4*>(Ss + (ty + 16 * a) * BS
                                                 + j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kr[C::DT];
        load_cols<C>(kr, Ks + (j4 + jj) * C::DS, tx);
#pragma unroll
        for (int a = 0; a < C::MA; ++a) {
          const float sa = (&sq[a].x)[jj];
#pragma unroll
          for (int e = 0; e < C::DT; ++e)
            dqt[a][e] = fmaf(sa, kr[e], dqt[a][e]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < C::MA; ++a)
#pragma unroll
      for (int e = 0; e < C::DT; ++e) dq[a][e] += dqt[a][e];
  }
  store_rows<C, C::MA>(p.dq + base, dq, q0, T, D, p.scale, ty, tx);
}

template <class C>
size_t dkdv_bytes() {
  return 4u * (2 * (C::BK + C::BQ) * C::DS + 2 * C::BK * C::BP + 2 * C::BQ);
}

template <class C>
size_t dq_bytes() {
  return 4u * (2 * (C::BK + C::BQ) * C::DS + C::BQ * (C::BK + 4) +
               2 * C::BQ);
}

template <int DPL>
int launch(Params p, cudaStream_t stream) {
  using C = Cfg<DPL>;
  const int n_rows = p.n_bh * p.T;
  flash_bwd_delta_kernel<<<(n_rows + kThreads / kWarp - 1) /
                               (kThreads / kWarp),
                           kThreads, 0, stream>>>(p.out, p.dout, p.delta,
                                                  n_rows, p.D);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  p.tiles = (p.T + C::BQ - 1) / C::BQ;
  static std::atomic<bool> opted_kv[mxt::kMaxDevices];
  static std::atomic<bool> opted_q[mxt::kMaxDevices];
  cudaError_t e = mxt::opt_in_smem(flash_bwd_dkdv_kernel<C>, kSmemMax,
                                   opted_kv);
  if (e == cudaSuccess)
    e = mxt::opt_in_smem(flash_bwd_dq_kernel<C>, kSmemMax, opted_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_kernel<C><<<p.n_bh * p.tiles, kThreads, dkdv_bytes<C>(),
                             stream>>>(p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  flash_bwd_dq_kernel<C><<<p.n_bh * p.tiles, kThreads, dq_bytes<C>(),
                           stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv: (n_bh, T, D) contiguous fp32, D <= 256;
// lse (the forward's, K1) and delta (scratch): (n_bh, T) fp32.  All on
// the current device.  Returns cudaGetLastError() after the launches.
extern "C" int mxt_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int n_bh, int T, int D, float scale, int causal,
    void* stream) {
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const float*>(out),
           static_cast<const float*>(lse), static_cast<const float*>(dout),
           static_cast<float*>(dq), static_cast<float*>(dk),
           static_cast<float*>(dv), static_cast<float*>(delta), n_bh, T, D,
           causal, 0, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<1>(p, st);
  if (D <= 64) return launch<2>(p, st);
  if (D <= 128) return launch<4>(p, st);
  return launch<8>(p, st);
}
