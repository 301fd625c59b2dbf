// K8: the bf16 flash-attention backward, recomputed from K7's
// logsumexp, on Hopper's tensor cores.
//
// Replaces: the VJP of mxnet_tpu/ops/attention.py::_pallas_attention
// (:497-506), the TPU flash kernel's backward.  Semantics of the port's
// flash_backward_plain:
//   p = exp(q.k * scale - lse)        (masked pairs give exactly 0)
//   delta_i = sum_d dO[i, d] * O[i, d]  (over the saved bf16 out)
//   ds = p * (dO.v - delta)
//   dv = p^T dO,  dk = scale * ds^T q,  dq = scale * ds k.
// The arithmetic is the TPU kernel's: dots of bf16 operands with fp32
// results, the scale after the dot, and p and ds rounded to bf16 for the
// dV, dK and dQ products (flash_attention.py :900, :918, :1258).  The
// fp32 backward stays the SIMT kernel K4 (flash_attention_backward.cu).
//
// Bound on an H100: 10 D flops per visible (query, key) pair (q.k, dO.v
// and the three products) at the bf16 dense rate, 989 TFLOP/s.  This
// design does 14 D: the dK/dV pass and the dQ pass each recompute q.k
// and dO.v, the price of no atomics (the result is the same bits on
// every run, and linear in dO).
//
// Design: three launches on the caller's stream.
//   1. rows: one warp per query row, fp32 delta = sum dO * O, and
//      lse * log2(e), both into (n_bh, Tp) arrays padded to Tp =
//      ceil(T / 128) * 128 (padded rows: delta 0, lse +inf, so p = 0).
//   2. dK/dV: one CTA per (batch*head, 64*NWG-key tile, output column
//      chunk); NWG consumer warpgroups of 64 keys and one producer
//      warpgroup (setmaxnreg moves its registers to the consumers).
//      K and V of the tile load once; Q and dO tiles of 64 queries come
//      by TMA through a two-stage ring, with their 64 lse and delta
//      values by bulk copy, from the first query tile that sees the keys
//      (causal) to the end.  Per step the transposed
//      products put P^T and dS^T in registers as wgmma A operands:
//        S^T = K.Q^T, dP^T = V.dO^T            (both from shared memory)
//        P^T = exp2(S^T * scale*log2e - lse*log2e), dS^T = P^T (dP^T - delta)
//        dV += P^T.dO, dK += dS^T.Q            (A in registers, bf16)
//   3. dQ: one CTA per (batch*head, 64*NWG-query tile, column chunk);
//      Q and dO load once, K/V tiles of 64 keys stream through the ring;
//      S = Q.K^T and dP = dO.V^T again, dQ += dS.K.
// An output column chunk is min(D, 128) wide: at D = 256 two CTAs share
// a tile and each recomputes S and dP, which keeps the accumulators in
// registers.  The tensor maps are 4-D (N, H, T, D) over the caller's
// strides, as in K7.  Head dims 64, 128, 256 (NWG = 2, 2, 1); D = 128 is
// tuned.  Built without -fmad=false.
#include "error.cuh"
#include "sm90.cuh"

namespace {

using namespace mxt90;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;
constexpr int kStep = 64;     // rows of the streamed tiles
constexpr int kRowPad = 128;  // row vectors padded to whole 128-row tiles

template <int D, int NWG>
struct Cfg {
  static constexpr int BT = 64 * NWG;  // rows of the resident tiles
  static constexpr int kThreads = (NWG + 1) * 128;
  static constexpr int DO = D < 128 ? D : 128;  // output columns a CTA
  static constexpr int kChunks = D / DO;
  static constexpr int kTileBytes = BT * D * 2;
  static constexpr int kStepBytes = kStep * D * 2;
  static constexpr int kVecBytes = 2 * kStep * 4;  // lse2, delta of a step
  static constexpr int kSmem = 1024 + 2 * kTileBytes +
                               kStages * (2 * kStepBytes + kVecBytes) + 64;
};

// Element strides (n, h, t) of an (N, H, T, D) operand; D is contiguous.
struct Strides {
  long long n, h, t;
  __device__ size_t at(Head hd, int i) const {
    return static_cast<size_t>(hd.n * n + hd.h * h + i * t);
  }
};

// Row vectors of the backward, (n_bh, Tp) each: lse2 = lse * log2(e) and
// delta = sum_d dO * O; one warp a row (D % 64 == 0).  Rows past T get
// lse2 = +inf and delta = 0, so their probabilities are exactly 0.
__global__ void __launch_bounds__(128)
flash_bwd_sm90_rows(const bf16* __restrict__ out,
                    const bf16* __restrict__ dout, Strides so, Strides sg,
                    const float* __restrict__ lse, float* __restrict__ lse2,
                    float* __restrict__ delta, int n_bh, int H, int T,
                    int Tp, int D) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= n_bh * Tp) return;
  const int bh = row / Tp, i = row % Tp;
  if (i >= T) {
    if (lane == 0) {
      lse2[row] = INFINITY;
      delta[row] = 0.f;
    }
    return;
  }
  const Head hd = head_of(bh, H);
  const bf16* orow = out + so.at(hd, i);
  const bf16* grow = dout + sg.at(hd, i);
  float s = 0.f;
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 o = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(orow + d));
    const float2 g = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(grow + d));
    s += o.x * g.x + o.y * g.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    lse2[row] = lse[static_cast<size_t>(bh) * T + i] * kLog2e;
    delta[row] = s;
  }
}

// Shared layout of both passes: two resident (BT x D) tiles, then the
// ring (a stage: two (64 x D) tiles and 64 lse2 + 64 delta values), then
// the barriers.
struct Smem {
  uint32_t a, b, ring, bar_once, full, empty;
  template <class C>
  __device__ static Smem make(const uint8_t* raw) {
    Smem m;
    m.a = (smem_u32(raw) + 1023) & ~1023u;
    m.b = m.a + C::kTileBytes;
    m.ring = m.b + C::kTileBytes;
    m.bar_once = m.ring + kStages * (2 * C::kStepBytes + C::kVecBytes);
    m.full = m.bar_once + 8;
    m.empty = m.full + 8 * kStages;
    return m;
  }
  template <class C>
  __device__ uint32_t stage(int s) const {
    return ring + s * (2 * C::kStepBytes + C::kVecBytes);
  }
};

template <int NWG>
__device__ __forceinline__ void init_barriers(const Smem& m) {
  if (threadIdx.x == 0) {
    mbar_init(m.bar_once, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(m.full + 8 * s, 1);
      mbar_init(m.empty + 8 * s, NWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer thread: both resident tiles from row r0 once, then the two
// streamed tiles of steps first..first+n-1 and, when ``lse2`` is not null,
// the step's lse2 and delta values (rows of the padded (n_bh, Tp) arrays).
template <int D, class C>
__device__ __forceinline__ void produce(const Smem& m, const CUtensorMap* ta,
                                        const CUtensorMap* tb,
                                        const CUtensorMap* tx,
                                        const CUtensorMap* ty, int r0, Head hd,
                                        int first, int n,
                                        const float* lse2,
                                        const float* delta) {
  mbar_expect_tx(m.bar_once, 2 * C::kTileBytes);
  tma_tile<D>(m.a, ta, m.bar_once, C::BT, r0, hd);
  tma_tile<D>(m.b, tb, m.bar_once, C::BT, r0, hd);
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages;
    const int row = (first + it) * kStep;
    if (it >= kStages) mbar_wait(m.empty + 8 * s, ((it / kStages) & 1) ^ 1);
    const uint32_t x = m.stage<C>(s), full = m.full + 8 * s;
    mbar_expect_tx(full, 2 * C::kStepBytes + (lse2 ? C::kVecBytes : 0));
    tma_tile<D>(x, tx, full, kStep, row, hd);
    tma_tile<D>(x + C::kStepBytes, ty, full, kStep, row, hd);
    if (lse2) {
      bulk_load(x + 2 * C::kStepBytes, lse2 + row, kStep * 4, full);
      bulk_load(x + 2 * C::kStepBytes + kStep * 4, delta + row, kStep * 4,
                full);
    }
  }
}

// The two recomputed score products of one step for warpgroup wg:
// x = A rows of tile a . (ring tile x)^T, y = rows of tile b . (ring y)^T
template <int D, class C>
__device__ __forceinline__ void scores(float (&x)[32], float (&y)[32],
                                       const Smem& m, uint32_t rx,
                                       uint32_t ry, int wg) {
  fence_regs(x);
  fence_regs(y);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<64, 0>(x, desc_k(m.a, C::BT, 64 * wg, kk),
                    desc_k(rx, kStep, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<64, 0>(y, desc_k(m.b, C::BT, 64 * wg, kk),
                    desc_k(ry, kStep, 0, kk), kk > 0);
  wg_commit();
  wg_wait0();
  fence_regs(x);
  fence_regs(y);
}

// Rows of a (BT-row) output tile from registers: row r gets scale * acc
template <class C>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[C::DO / 2],
                                           int row_a, int T, int D, int col0,
                                           float mul, int bh, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= T) continue;
    bf16* p = dst + (static_cast<size_t>(bh) * T + row) * D + col0;
#pragma unroll
    for (int j = 0; j < C::DO / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul,
                                acc[4 * j + 2 * h + 1] * mul);
  }
}

// dK/dV: resident a = K, b = V (BT keys); ring x = Q, y = dO (64 queries)
template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_bwd_sm90_dkdv(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int n_bh, int H, int T, int Tp,
                    float scale, int causal) {
  using C = Cfg<D, NWG>;
  extern __shared__ uint8_t smem_raw[];
  const Smem m = Smem::make<C>(smem_raw);
  // causal: the lowest key tiles walk the most queries; issue them first
  const int tile = static_cast<int>(blockIdx.x) / (n_bh * C::kChunks);
  const int bh = static_cast<int>(blockIdx.x) / C::kChunks % n_bh;
  const int dc = static_cast<int>(blockIdx.x) % C::kChunks;
  const int k0 = tile * C::BT;
  const int first = causal ? k0 / kStep : 0;
  const int n = (T + kStep - 1) / kStep - first;
  init_barriers<NWG>(m);

  // warp-uniform role, so the compiler sees the roles split by warpgroup
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {
    if constexpr (NWG == 2) reg_dealloc<kProducerRegs>();
    if (threadIdx.x % 128 == 0)
      produce<D, C>(m, &tk, &tv, &tq, &tdo, k0, head_of(bh, H), first, n,
                    lse2 + static_cast<size_t>(bh) * Tp,
                    delta + static_cast<size_t>(bh) * Tp);
  } else {
    if constexpr (NWG == 2) reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int key_a = k0 + 64 * wg + 16 * (t / 32) + lane / 4;  // h = 0; +8
    const float c = scale * kLog2e;
    float dka[C::DO / 2], dva[C::DO / 2], st[32], dpt[32];
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < C::DO / 2; ++i) dka[i] = dva[i] = 0.f;

    mbar_wait(m.bar_once, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      const uint32_t rq = m.stage<C>(s);
      const uint32_t rdo = rq + C::kStepBytes;
      // this thread's lse2 and delta pairs: queries 8j + 2(lane % 4) + {0,1}
      const uint32_t vec = rdo + C::kStepBytes + 8 * (lane % 4);
      mbar_wait(m.full + 8 * s, (it / kStages) & 1);
      scores<D, C>(st, dpt, m, rq, rdo, wg);
      const int q0 = (first + it) * kStep;
      const bool masked = causal && key_a + 8 > q0;
      // column pairs j = 2kk, 2kk + 1 make k-slice kk of P^T and dS^T: pack
      // each slice as soon as it is done, so st and dpt die as pa, da grow
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
          const float2 l2 = lds2(vec + 32 * j);
          const float2 dl = lds2(vec + 32 * j + kStep * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const int q = q0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const int key = key_a + 8 * (e >> 1);
            const bool vis = !(masked && key > q);
            const float p =
                vis ? exp2f(fmaf(st[i], c, -(e & 1 ? l2.y : l2.x))) : 0.f;
            dpt[i] = p * (dpt[i] - (e & 1 ? dl.y : dl.x));
            st[i] = p;
          }
        }
        pack_a(pa[kk], st, kk);
        pack_a(da[kk], dpt, kk);
      }
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pa);
      fence_regs(da);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<C::DO, 1>(dva, pa[kk],
                           desc_mn(rdo, kStep, kk, dc * C::DO / 64), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<C::DO, 1>(dka, da[kk],
                           desc_mn(rq, kStep, kk, dc * C::DO / 64), 1);
      wg_commit();
      wg_wait0();
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(m.empty + 8 * s);
    }
    store_rows<C>(dk, dka, key_a, T, D, dc * C::DO, scale, bh, lane);
    store_rows<C>(dv, dva, key_a, T, D, dc * C::DO, 1.f, bh, lane);
  }  // consumer
}

// dQ: resident a = Q, b = dO (BT queries); ring x = K, y = V (64 keys)
template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_bwd_sm90_dq(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const float* __restrict__ lse2,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int n_bh, int H, int T, int Tp, float scale, int causal) {
  using C = Cfg<D, NWG>;
  extern __shared__ uint8_t smem_raw[];
  const Smem m = Smem::make<C>(smem_raw);
  const int n_m = (T + C::BT - 1) / C::BT;
  const int q0 = (n_m - 1 - static_cast<int>(blockIdx.x) /
                                (n_bh * C::kChunks)) * C::BT;
  const int bh = static_cast<int>(blockIdx.x) / C::kChunks % n_bh;
  const int dc = static_cast<int>(blockIdx.x) % C::kChunks;
  const int n_kv = (T + kStep - 1) / kStep;
  const int n = causal ? min(n_kv, (q0 + C::BT - 1) / kStep + 1) : n_kv;
  init_barriers<NWG>(m);

  // warp-uniform role, so the compiler sees the roles split by warpgroup
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {
    if constexpr (NWG == 2) reg_dealloc<kProducerRegs>();
    if (threadIdx.x % 128 == 0)
      produce<D, C>(m, &tq, &tdo, &tk, &tv, q0, head_of(bh, H), 0, n,
                    nullptr, nullptr);
  } else {
    if constexpr (NWG == 2) reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_a = q0 + 64 * wg + 16 * (t / 32) + lane / 4;  // h = 0; +8
    const float c = scale * kLog2e;
    float l2[2], dl[2];  // rows past T: +inf and 0 (their p is 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l2[h] = lse2[static_cast<size_t>(bh) * Tp + row_a + 8 * h];
      dl[h] = delta[static_cast<size_t>(bh) * Tp + row_a + 8 * h];
    }
    float dqa[C::DO / 2], sc[32], dp[32];
    uint32_t da[4][4];
#pragma unroll
    for (int i = 0; i < C::DO / 2; ++i) dqa[i] = 0.f;

    mbar_wait(m.bar_once, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      const uint32_t rk = m.stage<C>(s);
      const uint32_t rv = rk + C::kStepBytes;
      mbar_wait(m.full + 8 * s, (it / kStages) & 1);
      scores<D, C>(sc, dp, m, rk, rv, wg);
      const int key0 = it * kStep;
      const bool masked =
          key0 + kStep > T || (causal && key0 + kStep - 1 > q0 + 64 * wg);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const int key = key0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const bool vis =
            !masked || (key < T && !(causal && key > row_a + 8 * h));
        const float p = vis ? exp2f(fmaf(sc[i], c, -l2[h])) : 0.f;
        dp[i] = p * (dp[i] - dl[h]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pack_a(da[kk], dp, kk);
      fence_regs(dqa);
      fence_regs(da);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<C::DO, 1>(dqa, da[kk],
                           desc_mn(rk, kStep, kk, dc * C::DO / 64), 1);
      wg_commit();
      wg_wait0();
      fence_regs(dqa);
      fence_regs(da);
      mbar_arrive(m.empty + 8 * s);
    }
    store_rows<C>(dq, dqa, row_a, T, D, dc * C::DO, scale, bh, lane);
  }  // consumer
}

template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* rows, int N, int H, int T, const long long* strides,
           float scale, int causal, cudaStream_t stream) {
  using C = Cfg<D, NWG>;
  const int n_bh = N * H;
  const int Tp = (T + kRowPad - 1) / kRowPad * kRowPad;
  float* lse2 = static_cast<float*>(rows);
  float* delta = lse2 + static_cast<size_t>(n_bh) * Tp;
  const long long* so = strides + 9;   // out
  const long long* sg = strides + 12;  // dout
  flash_bwd_sm90_rows<<<(n_bh * Tp + 3) / 4, 128, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      Strides{so[0], so[1], so[2]}, Strides{sg[0], sg[1], sg[2]},
      static_cast<const float*>(lse), lse2, delta, n_bh, H, T, Tp, D);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  // tensor maps: resident tiles of BT rows, streamed tiles of 64
  CUtensorMap q_bt, do_bt, k_bt, v_bt, q_64, do_64, k_64, v_64;
  const void* src[4] = {q, dout, k, v};
  const long long* sst[4] = {strides, sg, strides + 3, strides + 6};
  CUtensorMap* bt[4] = {&q_bt, &do_bt, &k_bt, &v_bt};
  CUtensorMap* st[4] = {&q_64, &do_64, &k_64, &v_64};
  for (int i = 0; i < 4 && !rc; ++i) {
    rc = make_map(bt[i], src[i], N, H, T, D, sst[i], C::BT);
    if (!rc) rc = make_map(st[i], src[i], N, H, T, D, sst[i], kStep);
  }
  if (rc) return rc;
  auto dkdv = flash_bwd_sm90_dkdv<D, NWG>;
  auto dqk = flash_bwd_sm90_dq<D, NWG>;
  rc = static_cast<int>(cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem));
  if (!rc)
    rc = static_cast<int>(cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem));
  if (rc) return rc;
  const int tiles = (T + C::BT - 1) / C::BT * n_bh * C::kChunks;
  dkdv<<<tiles, C::kThreads, C::kSmem, stream>>>(
      k_bt, v_bt, q_64, do_64, lse2, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n_bh, H, T, Tp, scale, causal);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  dqk<<<tiles, C::kThreads, C::kSmem, stream>>>(
      q_bt, do_bt, k_64, v_64, lse2, delta, static_cast<bf16*>(dq), n_bh, H,
      T, Tp, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out, dout: bf16 (N, H, T, D) on the current device, D in {64,
// 128, 256} and contiguous, their n, h, t strides (elements, multiples of
// 8) in strides[0..14] in that order; dq, dk, dv: contiguous bf16 (N H,
// T, D); lse (K7's): (N H, T) fp32; rows (scratch): 2 N H Tp fp32, Tp =
// ceil(T / 128) * 128.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for another D or a refused tensor map).
extern "C" int mxt_flash_attention_backward_sm90(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* rows, int N, int H, int T, int D, const long long* strides,
    float scale, int causal, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, 2>(q, k, v, out, lse, dout, dq, dk, dv, rows, N, H,
                           T, strides, scale, causal, s);
    case 128:
      return launch<128, 2>(q, k, v, out, lse, dout, dq, dk, dv, rows, N, H,
                            T, strides, scale, causal, s);
    case 256:
      return launch<256, 1>(q, k, v, out, lse, dout, dq, dk, dv, rows, N, H,
                            T, strides, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
