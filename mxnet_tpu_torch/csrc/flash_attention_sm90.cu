// K7: the bf16 flash-attention forward with logsumexp, on Hopper's
// tensor cores.
//
// Replaces: mxnet_tpu/ops/attention.py::_pallas_attention (:497-506),
// the forward of the TPU flash kernel.  Its arithmetic is the TPU
// kernel's (jax/experimental/pallas/ops/tpu/flash_attention.py): scores
// are a bf16 x bf16 dot with an fp32 result, scaled after the dot
// (:395-409); the probabilities are rounded to the value type for the
// P.V product (:471) while the running max and denominator stay fp32.
// The semantics are the port's flash_forward_plain: out in bf16, lse =
// where(isfinite(m), m, 0) + log(max(l, 1e-38)), a row that sees no key
// gives 0.  The fp32 forward stays the SIMT kernel K1
// (flash_attention.cu), serving's bit-exact oracle.
//
// Bound on an H100: 4 D flops per visible (query, key) pair at the bf16
// dense tensor-core rate (989 TFLOP/s) against q, k, v read once and out
// and lse written once (3.35 TB/s); at n8 h16 T1024 D128 causal the two
// are close (0.035 and 0.040 ms).
//
// Design (sm90.cuh has the tile layout and the fragments):
//   * one CTA per (batch*head, 64*NWG-query tile), the longest causal
//     tiles issued first; NWG consumer warpgroups of 64 query rows and
//     one producer warpgroup, whose registers go to the consumers
//     (setmaxnreg: 24 and 240 a thread);
//   * the producer loads the Q tile once and K/V tiles of BN keys by TMA
//     into a two-stage ring tracked by mbarriers (full_k, full_v, empty),
//     128-byte swizzle; rows past T arrive as zeros.  The tensor maps are
//     4-D (N, H, T, D) with the caller's strides, so the heads of a fused
//     QKV projection are read where they lie, without a copy;
//   * S = Q.K^T by wgmma (both operands in shared memory), online
//     softmax in fp32 registers with exp2 and scale*log2(e) folded into
//     one multiply after the dot; O += P.V by wgmma with P rounded to
//     bf16 in registers as the A operand and V read MN-major; the two
//     consumer warpgroups overlap one's softmax with the other's products
//     (FlashAttention-3's pipeline inside a warpgroup was tried: it
//     spilled registers and ran slower);
//   * causal key tiles above the diagonal are never loaded; only a tile
//     that crosses the diagonal or the ragged end is masked;
//   * epilogue: O / max(l, 1e-20), rounded to bf16 once, and lse.
// Head dims 64, 128 and 256 are instantiated (the wrapper zero-pads
// others up to one of them); D = 128 is the tuned one.  Built without
// -fmad=false: nothing here is under a bit-exactness contract.
#include "error.cuh"
#include "sm90.cuh"

namespace {

using namespace mxt90;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;

template <int D, int BN, int NWG>
struct Cfg {
  static constexpr int BM = 64 * NWG;
  static constexpr int kThreads = (NWG + 1) * 128;
  static constexpr int kQBytes = BM * D * 2;
  static constexpr int kKVBytes = BN * D * 2;
  // O's N extent per wgmma: 64 or 128 columns, kChunks of them
  static constexpr int kN = D < 128 ? D : 128;
  static constexpr int kChunks = D / kN;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 64;
};

template <int D, int BN, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ out, float* __restrict__ lse,
                      int n_bh, int H, int T, float c, int causal) {
  using C = Cfg<D, BN, NWG>;
  constexpr int BM = C::BM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + C::kQBytes;
  const uint32_t sv = sk + kStages * C::kKVBytes;
  const uint32_t bar_q = sv + kStages * C::kKVBytes;
  const uint32_t full_k = bar_q + 8;            // + 8 s
  const uint32_t full_v = full_k + 8 * kStages;  // + 8 s
  const uint32_t empty = full_v + 8 * kStages;   // + 8 s

  const int n_m = (T + BM - 1) / BM;
  const int q0 = (n_m - 1 - static_cast<int>(blockIdx.x) / n_bh) * BM;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const Head hd = head_of(bh, H);
  const int n_kv = (T + BN - 1) / BN;
  const int n_tiles = causal ? min(n_kv, (q0 + BM - 1) / BN + 1) : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, NWG * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform role, so the compiler sees the roles split by warpgroup
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {  // producer warpgroup: one thread issues every copy
    if constexpr (NWG == 2) reg_dealloc<kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
      tma_tile<D>(sq, &tq, bar_q, BM, q0, hd);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, C::kKVBytes);
        tma_tile<D>(sk + s * C::kKVBytes, &tk, full_k + 8 * s, BN, it * BN,
                    hd);
        mbar_expect_tx(full_v + 8 * s, C::kKVBytes);
        tma_tile<D>(sv + s * C::kKVBytes, &tv, full_v + 8 * s, BN, it * BN,
                    hd);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
    if constexpr (NWG == 2) reg_alloc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_a = q0 + 64 * wg + 16 * (t / 32) + lane / 4;  // h = 0; +8
    float o[C::kChunks][C::kN / 2];
    float s[BN / 2];
    uint32_t pa[BN / 16][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int ch = 0; ch < C::kChunks; ++ch)
#pragma unroll
      for (int i = 0; i < C::kN / 2; ++i) o[ch][i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int ph = (it / kStages) & 1;
      const uint32_t k_tile = sk + st * C::kKVBytes;
      const uint32_t v_tile = sv + st * C::kKVBytes;
      mbar_wait(full_k + 8 * st, ph);
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN, 0>(s, desc_k(sq, BM, 64 * wg, kk),
                        desc_k(k_tile, BN, 0, kk), kk > 0);
      wg_commit();
      wg_wait0();
      fence_regs(s);

      const int key0 = it * BN;
      if (key0 + BN > T || (causal && key0 + BN - 1 > q0 + 64 * wg)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int col = key0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const int row = row_a + 8 * ((i >> 1) & 1);
          if (col >= T || (causal && col > row)) s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float safe[2], corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * c);
        safe[h] = m_new == -INFINITY ? 0.f : m_new;
        corr[h] = exp2f(m[h] - safe[h]);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        s[i] = exp2f(fmaf(s[i], c, -safe[h]));
        l[h] += s[i];
      }
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch)
#pragma unroll
        for (int i = 0; i < C::kN / 2; ++i) o[ch][i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) pack_a(pa[kk], s, kk);

      mbar_wait(full_v + 8 * st, ph);
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch) fence_regs(o[ch]);
      fence_regs(pa);
      wg_fence();
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch)
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<C::kN, 1>(o[ch], pa[kk],
                             desc_mn(v_tile, BN, kk, ch * C::kN / 64), 1);
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch) fence_regs(o[ch]);
      fence_regs(pa);
      mbar_arrive(empty + 8 * st);
    }

    // epilogue: the four lanes of a row hold partial denominators
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + 8 * h;
      if (row >= T) continue;
      const float den = fmaxf(l[h], 1e-20f);
      bf16* orow = out + (static_cast<size_t>(bh) * T + row) * D;
#pragma unroll
      for (int ch = 0; ch < C::kChunks; ++ch)
#pragma unroll
        for (int j = 0; j < C::kN / 8; ++j) {
          const int col = ch * C::kN + 8 * j + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[ch][4 * j + 2 * h] / den,
                                    o[ch][4 * j + 2 * h + 1] / den);
        }
      if (lse != nullptr && lane % 4 == 0)
        lse[static_cast<size_t>(bh) * T + row] =
            (m[h] == -INFINITY ? 0.f : m[h] * kLn2) + logf(fmaxf(l[h], 1e-38f));
    }
  }  // consumer
}

template <int D, int BN, int NWG>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int N, int H, int T, const long long* strides, float scale,
           int causal, cudaStream_t stream) {
  using C = Cfg<D, BN, NWG>;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, N, H, T, D, strides, C::BM);
  if (!rc) rc = make_map(&tk, k, N, H, T, D, strides + 3, BN);
  if (!rc) rc = make_map(&tv, v, N, H, T, D, strides + 6, BN);
  if (rc) return rc;
  auto kern = flash_fwd_sm90_kernel<D, BN, NWG>;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem));
  if (rc) return rc;
  const int grid = (T + C::BM - 1) / C::BM * N * H;
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), N * H, H,
      T, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 (N, H, T, D) on the current device, D in {64, 128, 256}
// and contiguous, with the n, h, t strides (elements, multiples of 8) of
// q, k and v in strides[0..8]; out: contiguous bf16 (N H, T, D); lse:
// (N H, T) fp32, or null when no backward follows.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// D or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int mxt_flash_attention_sm90(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int N, int H, int T, int D,
                                        const long long* strides,
                                        float scale, int causal,
                                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, 128, 2>(q, k, v, out, lse, N, H, T, strides, scale,
                                causal, s);
    case 128:
      return launch<128, 128, 2>(q, k, v, out, lse, N, H, T, strides, scale,
                                 causal, s);
    case 256:
      return launch<256, 64, 2>(q, k, v, out, lse, N, H, T, strides, scale,
                                causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
