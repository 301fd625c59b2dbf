// K3 and K3q: y = x @ W^T + b in fp32 with a summation order fixed by C
// alone; K3 over fp32 weights, K3q over one-byte weights (int8 or fp8
// e4m3 codes with an fp32 scale a feature).
//
// Replaces: mxnet_tpu/serve/model.py::_mm (:123-129) under exact=True,
// the broadcast-multiply-reduce form the JAX package uses so that a
// row's projection does not depend on how many rows share the call
// (model.py:16-33).  Every projection of the serving path and the LM
// head go through it.  K3q also replaces the dequantization the JAX
// package fuses in front of it (mxnet_tpu/quantize.py::dequantize_array,
// :146, through model.py::_resolve_params).
//
// The contract: y[m, f] = b[f] + (((x[m,0] w[f,0] + x[m,1] w[f,1]) + ...)
// as one fused-multiply-add chain over c = 0 .. C-1 from 0, then one
// rounded add of the bias.  No split-K and no tiling of the reduction
// that depends on M, so row r of an M-row call equals the same row
// computed alone, bit for bit.  cuBLAS and torch.matmul promise no such
// thing.  Every kernel below runs exactly this chain; they differ only in
// how the bytes reach it.  K3q dequantizes each weight element before it
// enters the chain, w[f, c] = code[f, c] * scale[f] (one rounded multiply;
// the code's conversion to fp32 is exact for int8 and e4m3), and never
// factors the scale out of the sum: so K3q's output is K3's on
// quantize.dequantize_array(codes, scales), bit for bit, at every M.
//
// Bound on an H100: at decode (M = slots = 8) bytes — the weight matrix
// is read once, F * C * 4 bytes (F * C for K3q) over 3.35 TB/s; at
// prefill (M = 256) operations, 2 * M * F * C flops over the fp32 SIMT
// peak of 67 TFLOP/s (tensor cores would round the inputs to TF32 and
// are not used).  K3q at decode also meets a latency floor: one chain is
// C dependent FMAs, ~4 cycles each at 1.98 GHz (4.1 us at C = 2048,
// 16.5 us at C = 8192), above the byte bound of the narrower
// projections; the chain is not split, and its latency hides across the
// outputs a thread and the CTAs an SM runs.
//
// Decode rows (M <= 16): linear_stream_kernel (K3) and
// linear_q_stream_kernel (K3q).  A CTA owns a slab of 16 features (128
// CTAs at F = 2048, so even the narrowest projection covers the card)
// and streams its weight rows, with the matching columns of x, through a
// ring of shared-memory stages filled by bulk copies (cp.async.bulk, one
// per row and stage, completing on an mbarrier per stage; a K3q weight
// row is C bytes, so it takes this path only when C % 16 == 0).  The
// ring is as deep as shared memory allows while every CTA of the launch
// stays resident.  Each thread runs whole chains: it reads four columns
// of its weight rows (a float4, or a 4-byte word of codes that it
// dequantizes with the row's scale, read once) and x rows as float4s
// (padded rows: no bank conflicts) and feeds them to its chains in column
// order, in a loop without a branch.  One chain per output is C
// dependent FMAs, ~18 us at C = 8192 — about the fp32 weight-read bound
// of that projection, so the chain is not split.  What limits the kernel
// is shared memory's read rate (a warp's float4 read takes four cycles
// even as a broadcast) against the number of warps that hide its
// latency, so the blocking follows the launch: a one-wave launch (F <=
// 16 x SMs) runs one output a thread; a larger one gives each thread two
// features x two rows (K3q: one feature x two rows, twice the warps).
//
// Rows above 16 (the speculative verify's 8 slots x 5 rows, prefill
// buckets of 64 to 256): linear_ring_kernel, the same chains over a
// register-blocked SIMT tile.  A CTA owns a (BM x BN) output tile, each
// thread TM rows x TN features of it, and streams BK-column stages of the
// tile's x rows and weight rows (K3q: codes, dequantized once a stage
// into an fp32 tile every thread reads) through a ring of cp.async
// copies.  A thread reads four columns of each of its rows as float4s
// and runs 4 TM TN FMAs per TM + TN reads, in column order.  The tile
// follows the call: up to 40 rows, the whole call in one CTA's rows
// (none of a 64-row tile's dead rows at the verify's 40) and wide stages
// (128 columns: such tiles are bound by the bytes in flight, not the
// FMA pipe), with 16 to 64 features a CTA so that the grid covers the
// card; at 64 rows and more, 64 x 64 tiles of 8 x 4 micro-tiles, and
// 128 x 128 tiles of 8 x 16 where F gives enough of them.  What binds
// the larger tiles is shared memory's read rate (TM + TN float4 reads a
// thread for 4 TM TN FMAs) and the waves the grid makes.  The rule is
// measured: python -m mxnet_tpu_torch.testing.k3_tiles times every
// candidate at M 17 to 256 and the five serving shapes on an H100.
//
// Inputs the copies cannot take (C not a multiple of 4, or of 16 for
// codes; rows not 16-byte aligned): linear_kernel (K3) and
// linear_q_kernel (K3q), a shared-memory SIMT tile — a (64 x 64) output
// tile per thread block, a (4 x 4) micro-tile per thread, 16-column
// slabs of x and W double-buffered in shared memory (the next slab's
// loads in flight while the block runs the current one; K3q loads 4
// codes and stores the 4 dequantized weights), each output's chain over
// the slabs in increasing c.
#include <cstdint>
#include <type_traits>

#include "codes.cuh"
#include "error.cuh"
#include "per_device.cuh"
#include "sm90.cuh"

namespace {

// The kernels' common signature: x (M, C) fp32, w (F, C) of the weight
// type, scales (F,) fp32 (K3q) or null, bias (F,) or null, y (M, F).
using TiledFn = void (*)(const float*, const void*, const float*,
                         const float*, float*, int, int, int, bool);
using StreamFn = void (*)(const float*, const void*, const float*,
                          const float*, float*, int, int, int, int, int);

// The tiled kernel: each thread reads four elements of each slab of x
// and W (one 16-byte or 4-byte load, or one by one where ``vec`` is
// false: C not a multiple of 4, or rows not aligned) into registers
// while the block runs the current slab, then stores them transposed
// into the other buffer.
constexpr int kTile = 64;
constexpr int kSlabCols = 16;
constexpr int kTilePitch = kTile + 4;  // floats; keeps float4 alignment
constexpr int kSmemMax = 227 * 1024;

// Four consecutive elements of row ``row`` from column ``c`` (0 past the
// matrix), dequantized with ``s``.
template <int kCode>
__device__ __forceinline__ float4 load4(const typename mxt::Codes<kCode>::T* a,
                                        int row, int rows, int c, int C,
                                        bool vec, float s) {
  using W = mxt::Codes<kCode>;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return v;
  const typename W::T* p = a + static_cast<size_t>(row) * C + c;
  if (vec && c + 3 < C) return W::get4(p, 0, s);
  if (c < C) v.x = W::get(p, 0, s);
  if (c + 1 < C) v.y = W::get(p, 1, s);
  if (c + 2 < C) v.z = W::get(p, 2, s);
  if (c + 3 < C) v.w = W::get(p, 3, s);
  return v;
}

template <int kCode>
__device__ __forceinline__ void tiled_body(
    const float* __restrict__ x, const void* __restrict__ wv,
    const float* __restrict__ scales, const float* __restrict__ bias,
    float* __restrict__ y, int M, int F, int C, bool vec) {
  __shared__ __align__(16) float xs[2][kSlabCols][kTilePitch];
  __shared__ __align__(16) float ws[2][kSlabCols][kTilePitch];
  const auto* w = static_cast<const typename mxt::Codes<kCode>::T*>(wv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // features f0 + 4 tx ...
  const int ty = tid / 16;  // rows m0 + 4 ty ...
  const int m0 = blockIdx.y * kTile;
  const int f0 = blockIdx.x * kTile;
  const int lr = tid / 4;        // the slab row this thread loads
  const int lc = tid % 4 * 4;    // and its first column
  const int nt = (C + kSlabCols - 1) / kSlabCols;
  const float s = (kCode && f0 + lr < F) ? scales[f0 + lr] : 0.f;
  float4 rx = load4<0>(x, m0 + lr, M, lc, C, vec, 0.f);
  float4 rw = load4<kCode>(w, f0 + lr, F, lc, C, vec, s);
  auto store = [&](int buf) {
    xs[buf][lc][lr] = rx.x;
    xs[buf][lc + 1][lr] = rx.y;
    xs[buf][lc + 2][lr] = rx.z;
    xs[buf][lc + 3][lr] = rx.w;
    ws[buf][lc][lr] = rw.x;
    ws[buf][lc + 1][lr] = rw.y;
    ws[buf][lc + 2][lr] = rw.z;
    ws[buf][lc + 3][lr] = rw.w;
  };
  store(0);
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int cur = t & 1;
    const int c0 = t * kSlabCols;
    if (t + 1 < nt) {  // the next slab, in flight during this one
      rx = load4<0>(x, m0 + lr, M, c0 + kSlabCols + lc, C, vec, 0.f);
      rw = load4<kCode>(w, f0 + lr, F, c0 + kSlabCols + lc, C, vec, s);
    }
    const int kn = min(kSlabCols, C - c0);
#pragma unroll
    for (int kk = 0; kk < kSlabCols; ++kk) {
      if (kk < kn) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[cur][kk][4 * ty]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[cur][kk][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    }
    if (t + 1 < nt) store(cur ^ 1);  // its readers finished at the last sync
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + 4 * ty + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gf = f0 + 4 * tx + j;
      if (gf >= F) continue;
      y[static_cast<size_t>(gm) * F + gf] =
          bias ? __fadd_rn(acc[i][j], bias[gf]) : acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(256)
linear_kernel(const float* x, const void* w, const float* scales,
              const float* bias, float* y, int M, int F, int C, bool vec) {
  tiled_body<0>(x, w, scales, bias, y, M, F, C, vec);
}

template <int kCode>
__global__ void __launch_bounds__(256)
linear_q_kernel(const float* x, const void* w, const float* scales,
                const float* bias, float* y, int M, int F, int C, bool vec) {
  tiled_body<kCode>(x, w, scales, bias, y, M, F, C, vec);
}

// The ring kernel: a (BM x BN) = (RY TM x FX TN) output tile a CTA of RY
// x FX threads, thread (tx, ty) = (tid % FX, tid / FX) running the
// chains of rows ty + RY i (i < TM) and features tx + FX j (j < TN).
// Stages of BK columns of x's tile rows and W's (fp32, or one-byte codes)
// arrive in a ring of ST stages by 16-byte cp.async copies (zero past M,
// F and C), ST - 1 stages in flight while the CTA runs one.  K3q
// dequantizes a stage's codes once, into one fp32 tile that every thread
// reads.  A thread reads four columns of each of its x rows and weight
// rows as float4s (row pitch BK + 4 floats: the 8 rows a quarter warp
// reads fall in distinct banks, its x rows are one broadcast) and feeds
// them to its TM x TN chains in column order, its weight rows up to
// eight at a time: 4 TM TN FMAs per TM + TN reads.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int kCode, int RY, int TM, int FX, int TN, int BK, int ST>
struct Ring {
  static constexpr int BM = RY * TM, BN = FX * TN, NT = RY * FX;
  static constexpr int kEB = kCode ? 1 : 4;
  static constexpr int kPitch = BK + 4;  // floats between staged rows
  // bytes of one stage: x's rows, then W's (fp32 rows at the x pitch; a
  // code row is BK bytes)
  static constexpr int kXBytes = BM * kPitch * 4;
  static constexpr int kWBytes = kCode ? BN * BK : BN * kPitch * 4;
  static constexpr int kStage = kXBytes + kWBytes;
  // K3q: the dequantized tile and the CTA's scales after the ring
  static constexpr int kBytes =
      ST * kStage + (kCode ? BN * kPitch * 4 + BN * 4 : 0);
  // weight rows read at once: the largest of 8, 6 and 4 that divides TN
  static constexpr int TNB =
      TN % 8 == 0 ? 8 : TN % 6 == 0 ? 6 : TN % 4 == 0 ? 4 : TN;
};

template <int kCode, int RY, int TM, int FX, int TN, int BK, int ST>
__device__ __forceinline__ void ring_body(
    const float* __restrict__ x, const void* __restrict__ wv,
    const float* __restrict__ scales, const float* __restrict__ bias,
    float* __restrict__ y, int M, int F, int C) {
  using R = Ring<kCode, RY, TM, FX, TN, BK, ST>;
  using T = typename mxt::Codes<kCode>::T;
  constexpr int kP = R::kPitch;
  extern __shared__ __align__(128) unsigned char ring[];
  const T* w = static_cast<const T*>(wv);
  const int tid = threadIdx.x;
  const int tx = tid % FX, ty = tid / FX;
  const int m0 = blockIdx.y * R::BM, f0 = blockIdx.x * R::BN;
  const int nk = (C + BK - 1) / BK;
  const uint32_t base = mxt90::smem_u32(ring);
  float* wf = reinterpret_cast<float*>(ring + ST * R::kStage);
  float* sc = wf + R::BN * kP;
  if constexpr (kCode != 0)
    for (int r = tid; r < R::BN; r += R::NT)
      sc[r] = f0 + r < F ? scales[f0 + r] : 0.f;
  // columns [k BK, ...) of the tile's x and W rows into stage k % ST
  auto issue = [&](int k) {
    const int c0 = k * BK;
    const uint32_t st = base + (k % ST) * R::kStage;
    for (int u = tid; u < BK / 4 * R::BM; u += R::NT) {
      const int r = u / (BK / 4), q = u % (BK / 4);
      const int c = c0 + 4 * q;
      const bool in = m0 + r < M && c < C;
      cp_async16(st + (r * kP + 4 * q) * 4,
                 in ? x + static_cast<size_t>(m0 + r) * C + c : x,
                 in ? 16 : 0);
    }
    constexpr int kChunks = BK * R::kEB / 16;  // 16-byte copies a W row
    for (int u = tid; u < kChunks * R::BN; u += R::NT) {
      const int r = u / kChunks, q = u % kChunks;
      const int c = c0 + q * (16 / R::kEB);
      const bool in = f0 + r < F && c < C;
      const uint32_t dst = st + R::kXBytes +
                           (kCode ? r * BK + 16 * q : (r * kP + 4 * q) * 4);
      cp_async16(dst, in ? w + static_cast<size_t>(f0 + r) * C + c : wv,
                 in ? 16 : 0);
    }
  };
  for (int k = 0; k < ST - 1; ++k) {
    if (k < nk) issue(k);
    cp_async_commit();
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<ST - 2>();  // this thread's copies of stage k are in
    __syncthreads();          // everyone's are; stage k - 1 is free
    if (k + ST - 1 < nk) issue(k + ST - 1);
    cp_async_commit();
    const unsigned char* st = ring + (k % ST) * R::kStage;
    const float* xs = reinterpret_cast<const float*>(st);
    const float* ws;
    if constexpr (kCode != 0) {
      const uint32_t* codes =
          reinterpret_cast<const uint32_t*>(st + R::kXBytes);
      for (int u = tid; u < BK / 4 * R::BN; u += R::NT) {
        const int r = u / (BK / 4), q = u % (BK / 4);
        *reinterpret_cast<float4*>(wf + r * kP + 4 * q) =
            mxt::Codes<kCode>::word(codes[u], sc[r]);
      }
      __syncthreads();
      ws = wf;
    } else {
      ws = reinterpret_cast<const float*>(st + R::kXBytes);
    }
    const int n4 = min(BK, C - k * BK) / 4;
#pragma unroll 2
    for (int c4 = 0; c4 < n4; ++c4) {
      float4 xv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (ty + RY * i) * kP +
                                                 4 * c4);
#pragma unroll
      for (int j0 = 0; j0 < TN; j0 += R::TNB) {
        float4 wr[R::TNB];
#pragma unroll
        for (int j = 0; j < R::TNB; ++j)
          wr[j] = *reinterpret_cast<const float4*>(
              ws + (tx + FX * (j0 + j)) * kP + 4 * c4);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < R::TNB; ++j) {
            float& a = acc[i][j0 + j];
            a = __fmaf_rn(xv[i].x, wr[j].x, a);
            a = __fmaf_rn(xv[i].y, wr[j].y, a);
            a = __fmaf_rn(xv[i].z, wr[j].z, a);
            a = __fmaf_rn(xv[i].w, wr[j].w, a);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + RY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx + FX * j;
      if (f < F)
        y[static_cast<size_t>(m) * F + f] =
            bias ? __fadd_rn(acc[i][j], bias[f]) : acc[i][j];
    }
  }
}

template <int kCode, int RY, int TM, int FX, int TN, int BK, int ST>
__global__ void __launch_bounds__(RY * FX)
linear_ring_kernel(const float* x, const void* w, const float* scales,
                   const float* bias, float* y, int M, int F, int C) {
  ring_body<kCode, RY, TM, FX, TN, BK, ST>(x, w, scales, bias, y, M, F, C);
}

template <int kCode, int RY, int TM, int FX, int TN, int BK, int ST>
int launch_ring(const float* x, const void* w, const float* scales,
                const float* bias, float* y, int M, int F, int C,
                cudaStream_t stream) {
  using R = Ring<kCode, RY, TM, FX, TN, BK, ST>;
  const auto kernel = linear_ring_kernel<kCode, RY, TM, FX, TN, BK, ST>;
  static std::atomic<bool> opted[mxt::kMaxDevices];
  if (R::kBytes > 48 * 1024) {
    const cudaError_t e = mxt::opt_in_smem(kernel, kSmemMax, opted);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((F + R::BN - 1) / R::BN, (M + R::BM - 1) / R::BM);
  kernel<<<grid, R::NT, R::kBytes, stream>>>(x, w, scales, bias, y, M, F, C);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kStreamRows = 16;  // M <= 16 takes the streaming kernel
constexpr int kSlab = 16;        // features a CTA (one warp) owns
constexpr int kMaxStages = 12;

// Bytes between rows of a stage: a weight row of ``cols`` elements of
// ``ebytes`` bytes, or an x row of ``cols`` floats, plus 16 bytes, which
// keeps rows 16-byte aligned (bulk copies) and puts the 8 weight rows a
// quarter warp reads in distinct banks.
__host__ __device__ __forceinline__ int row_pitch(int cols, int ebytes) {
  return cols * ebytes + 16;
}

// A stage's weight row as stage_chains reads it: four fp32 columns a
// float4 (K3), four codes a word (K3q).
template <int kCode>
using StageRow = std::conditional_t<kCode == 0, const float4*,
                                    const uint32_t*>;

// Columns [0, n4 * 4) of one stage into L x G chains: the weight rows at
// ws[g] (K3q's dequantized with scales sc[g]) and the x rows at xs,
// xs + step, ... (float4s).
template <int kCode, int L, int G, int R>
__device__ __forceinline__ void stage_chains(float (&acc)[R][G],
                                             StageRow<kCode> (&ws)[G],
                                             const float (&sc)[G],
                                             const float4* xs, int step,
                                             int n4) {
#pragma unroll 4
  for (int c = 0; c < n4; ++c) {
    float4 wv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if constexpr (kCode == 0) wv[g] = ws[g][c];
      else wv[g] = mxt::Codes<kCode>::word(ws[g][c], sc[g]);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const float4 xv = xs[j * step + c];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[j][g] = __fmaf_rn(xv.x, wv[g].x, acc[j][g]);
        acc[j][g] = __fmaf_rn(xv.y, wv[g].y, acc[j][g]);
        acc[j][g] = __fmaf_rn(xv.z, wv[g].z, acc[j][g]);
        acc[j][g] = __fmaf_rn(xv.w, wv[g].w, acc[j][g]);
      }
    }
  }
}

// Lane (p, q) = (lane % 8, lane / 8) of warp v runs the chains of the
// outputs (row 4 R b + q + 4 j, feature 8 G a + p + 8 g) for g < G and
// the j < R whose row is below M, with a = v % (2 / G) and b = v / (2 / G):
// the warps split the slab's 16 features into 2 / G groups and its rows
// into groups of 4 R.  A read of four columns of the stage's weight rows
// touches 8 rows in distinct banks in each quarter warp; a read of an x
// row is one broadcast.  So a warp spends 4 (G + R) shared-memory cycles
// on 4 columns of 32 G R chains: G = R = 1 (4 warps at M = 8) when the
// launch is one wave and needs every warp to hide latency, G = R = 2
// (one warp) for K3 when several CTAs share an SM and shared memory is
// the scarcer resource, and G = 1, R = 2 (two warps) for K3q there, whose
// lanes each dequantize every weight they read.
template <int kCode, int G, int R>
__device__ __forceinline__ void stream_body(
    const float* __restrict__ x, const void* __restrict__ wv,
    const float* __restrict__ scales, const float* __restrict__ bias,
    float* __restrict__ y, int M, int F, int C, int cols, int stages) {
  using T = typename mxt::Codes<kCode>::T;
  constexpr int kEB = sizeof(T);
  // stages x (16 weight rows + M x rows)
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const T* w = static_cast<const T*>(wv);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int v = tid / 32;
  const int fl = 8 * G * (v % (2 / G)) + lane % 8;  // first feature
  const int r0 = 4 * R * (v / (2 / G)) + lane / 8;  // and row
  const int live = min(R, max(0, (M - r0 + 3) / 4));  // rows r0 + 4 j < M
  const int wpitch = row_pitch(cols, kEB);
  const int xpitch = row_pitch(cols, 4);
  const int f0 = blockIdx.x * kSlab;
  const int nf = min(kSlab, F - f0);
  const int stage_bytes = kSlab * wpitch + M * xpitch;
  const int nk = (C + cols - 1) / cols;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      mxt90::mbar_init(mxt90::smem_u32(&full[s]), 1);
    mxt90::mbar_fence_init();
  }
  __syncthreads();
  // warp 0: columns [k cols, ...) of the slab's weight rows and of x into
  // stage k % stages, lane r copying row r (nf + M <= 32)
  auto issue = [&](int k) {
    const int c0 = k * cols;
    const uint32_t n = min(cols, C - c0);
    const uint32_t bar = mxt90::smem_u32(&full[k % stages]);
    unsigned char* st = ring + (k % stages) * stage_bytes;
    if (lane == 0) mxt90::mbar_expect_tx(bar, n * (nf * kEB + M * 4));
    __syncwarp();
    if (lane < nf + M) {
      const bool is_w = lane < nf;
      const void* src =
          is_w ? static_cast<const void*>(w + static_cast<size_t>(f0 + lane) * C + c0)
               : static_cast<const void*>(x + static_cast<size_t>(lane - nf) * C + c0);
      unsigned char* dst =
          st + (is_w ? lane * wpitch : kSlab * wpitch + (lane - nf) * xpitch);
      mxt90::bulk_load(mxt90::smem_u32(dst), src, n * (is_w ? kEB : 4), bar);
    }
  };
  if (v == 0)
    for (int k = 0; k < min(stages - 1, nk); ++k) issue(k);
  float sc[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    sc[g] = (kCode && f0 + fl + 8 * g < F) ? scales[f0 + fl + 8 * g] : 0.f;
  float acc[R][G];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[j][g] = 0.f;
  for (int k = 0; k < nk; ++k) {
    __syncthreads();  // every thread is done with stage (k - 1) % stages
    if (v == 0 && k + stages - 1 < nk) issue(k + stages - 1);
    mxt90::mbar_wait(mxt90::smem_u32(&full[k % stages]), (k / stages) & 1);
    const unsigned char* st = ring + (k % stages) * stage_bytes;
    const float4* xs = reinterpret_cast<const float4*>(
        st + kSlab * wpitch + r0 * xpitch);
    const int n4 = min(cols, C - k * cols) / 4;
    // xpitch / 4 float4s from x row r0 + 4 j to r0 + 4 j + 4; one
    // branch-free loop for each count of live rows
    StageRow<kCode> ws[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      ws[g] = reinterpret_cast<StageRow<kCode>>(st + (fl + 8 * g) * wpitch);
    if (live == R) stage_chains<kCode, R>(acc, ws, sc, xs, xpitch / 4, n4);
    else if (R == 2 && live == 1)
      stage_chains<kCode, 1>(acc, ws, sc, xs, xpitch / 4, n4);
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int m = r0 + 4 * j;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int f = f0 + fl + 8 * g;
      if (m < M && f < F)
        y[static_cast<size_t>(m) * F + f] =
            bias ? __fadd_rn(acc[j][g], bias[f]) : acc[j][g];
    }
  }
}

template <int G, int R>
__global__ void __launch_bounds__(256)
linear_stream_kernel(const float* x, const void* w, const float* scales,
                     const float* bias, float* y, int M, int F, int C,
                     int cols, int stages) {
  stream_body<0, G, R>(x, w, scales, bias, y, M, F, C, cols, stages);
}

template <int G, int R, int kCode>
__global__ void __launch_bounds__(256)
linear_q_stream_kernel(const float* x, const void* w, const float* scales,
                       const float* bias, float* y, int M, int F, int C,
                       int cols, int stages) {
  stream_body<kCode, G, R>(x, w, scales, bias, y, M, F, C, cols, stages);
}

template <int kCode, int G, int R>
StreamFn stream_kernel() {
  if constexpr (kCode == 0) return linear_stream_kernel<G, R>;
  else return linear_q_stream_kernel<G, R, kCode>;
}

template <int kCode>
TiledFn tiled_kernel() {
  if constexpr (kCode == 0) return linear_kernel;
  else return linear_q_kernel<kCode>;
}

template <int kCode, int G, int R>
int launch_stream(const float* x, const void* w, const float* scales,
                  const float* bias, float* y, int M, int F, int C,
                  int cols, int per_sm, cudaStream_t stream) {
  constexpr int kEB = sizeof(typename mxt::Codes<kCode>::T);
  const StreamFn kernel = stream_kernel<kCode, G, R>();
  // the barriers' static bytes count against the opt-in
  static std::atomic<bool> opted[mxt::kMaxDevices];
  const cudaError_t e = mxt::opt_in_smem(kernel, kSmemMax, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the ring is as deep as shared memory allows while every CTA of the
  // launch stays resident, and holds at least two stages
  auto stage_bytes = [&](int n) {
    return kSlab * row_pitch(n, kEB) + M * row_pitch(n, 4);
  };
  const int budget = kSmemMax / per_sm - 1024 - 128;
  while (cols > 128 && 2 * stage_bytes(cols) > budget) cols /= 2;
  const int stages = min(max(budget / stage_bytes(cols), 2), kMaxStages);
  const int warps = 2 / G * ((M + 4 * R - 1) / (4 * R));
  kernel<<<(F + kSlab - 1) / kSlab, 32 * warps, stages * stage_bytes(cols),
           stream>>>(x, w, scales, bias, y, M, F, C, cols, stages);
  return static_cast<int>(cudaGetLastError());
}

// One wave of CTAs (F <= 16 x SMs: one CTA a SM) streams wide stages
// (K3: 512 columns, 1024 from C = 8192; K3q, whose weight rows are a
// quarter of the bytes: 1024 and 2048) with one output a thread.  Larger
// launches (up to 4 CTAs a SM resident) take 256-column stages (K3q 1024;
// the ring shrinks them where shared memory runs short) with two features
// a thread and, above 4 rows, two rows (K3) or one feature and two rows
// (K3q: twice K3's warps, which hide the latency of its dequantizing
// loop).  Measured best of 128 to 2048 columns and of the blockings at
// every serving shape on an H100 (``python -m
// mxnet_tpu_torch.testing.k3q_variants`` times both kernels).
template <int kCode>
int launch_decode(const float* x, const void* w, const float* scales,
                  const float* bias, float* y, int M, int F, int C,
                  cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = mxt::sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ctas = (F + kSlab - 1) / kSlab;
  const int per_sm = min((ctas + sms - 1) / sms, 4);
  if (per_sm == 1)
    return launch_stream<kCode, 1, 1>(
        x, w, scales, bias, y, M, F, C,
        (C >= 8192 ? 2 : 1) * (kCode ? 1024 : 512), 1, stream);
  const int cols = kCode ? 1024 : 256;
  if (M <= 4)
    return launch_stream<kCode, 2, 1>(x, w, scales, bias, y, M, F, C, cols,
                                      per_sm, stream);
  if (kCode)
    return launch_stream<kCode, 1, 2>(x, w, scales, bias, y, M, F, C, cols,
                                      per_sm, stream);
  return launch_stream<kCode, 2, 2>(x, w, scales, bias, y, M, F, C, cols,
                                    per_sm, stream);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Rows above 16 on the ring kernel, <RY, TM, FX, TN, BK, ST>, by the
// fastest tiling of each (M, F, C) class in `python -m
// mxnet_tpu_torch.testing.k3_tiles` on an H100 (the serving shapes: F =
// 2048, 6144, 8192, 32768 at C = 2048, and F = 2048 at C = 8192).  A
// narrow projection (F <= 2048, or C >= 8192: few CTAs, long chains)
// takes 16- or 32-feature tiles with wide stages; a wide one (the LM
// head) the largest tiles.  Any tiling gives the same bits.
template <int kCode>
int launch_rows(const float* x, const void* w, const float* scales,
                const float* bias, float* y, int M, int F, int C,
                cudaStream_t stream) {
  const bool narrow = F <= 2048 || C >= 8192, wide = F >= 16384;
  auto ring = [&](auto kernel) {
    return kernel(x, w, scales, bias, y, M, F, C, stream);
  };
  if (M <= 40) {  // one CTA's rows: the verify's 40, short calls
    if (narrow) return ring(launch_ring<kCode, 8, 5, 16, 1, 128, 3>);
    if (wide) return ring(launch_ring<kCode, 8, 5, 16, 4, 64, 3>);
    if (M <= 32) return ring(launch_ring<kCode, 8, 4, 16, 2, 128, 3>);
    if (F <= 6144) return ring(launch_ring<kCode, 8, 5, 16, 3, 128, 3>);
    return ring(launch_ring<kCode, 8, 5, 16, 4, 128, 3>);
  }
  if (M <= 128 && narrow) {
    if (kCode == 0 && M <= 64)
      return ring(launch_ring<kCode, 8, 4, 16, 2, 256, 2>);
    return ring(launch_ring<kCode, 8, 4, 16, 2, 128, 3>);
  }
  if (kCode != 0 && M <= 64 && !wide) {  // K3q: more CTAs, fewer rows
    if (F <= 6144) return ring(launch_ring<kCode, 8, 5, 16, 3, 128, 3>);
    return ring(launch_ring<kCode, 8, 8, 16, 2, 64, 3>);
  }
  if (M > 64 && wide) return ring(launch_ring<kCode, 16, 8, 8, 16, 32, 3>);
  if (M > 128 && F >= 8192) {
    if (kCode != 0) return ring(launch_ring<kCode, 16, 8, 16, 8, 32, 3>);
    return ring(launch_ring<kCode, 16, 8, 8, 16, 32, 3>);
  }
  // 64 x 64 tiles (K3q up to 128 rows at F <= 6144, and above on narrow
  // projections: 64 x 32, whose more CTAs hide its dequantization)
  if (kCode != 0 && (M <= 128 ? F <= 6144 : narrow))
    return ring(launch_ring<kCode, 8, 8, 16, 2, 64, 3>);
  return ring(launch_ring<kCode, 8, 8, 16, 4, 32, 3>);
}

// Decode rows take the streaming kernel and larger calls the ring kernel
// where the copies can take the rows (16-byte sizes and addresses);
// everything else the tiled one.
template <int kCode>
int launch(const void* x, const void* w, const void* scales,
           const void* bias, void* y, int M, int F, int C, void* stream) {
  constexpr int kEB = sizeof(typename mxt::Codes<kCode>::T);
  const auto* xp = static_cast<const float*>(x);
  const auto* sp = static_cast<const float*>(scales);
  const auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && aligned(x, 16) && aligned(w, 4 * kEB);
  const bool bulk = vec && (C * kEB) % 16 == 0 && aligned(w, 16);
  if (M <= kStreamRows && bulk)
    return launch_decode<kCode>(xp, w, sp, bp, yp, M, F, C, st);
  if (bulk) return launch_rows<kCode>(xp, w, sp, bp, yp, M, F, C, st);
  const dim3 grid((F + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  const TiledFn kernel = tiled_kernel<kCode>();
  kernel<<<grid, 256, 0, st>>>(xp, w, sp, bp, yp, M, F, C, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, C), w: (F, C), bias: (F,) or null, y: (M, F); contiguous fp32 on
// the current device.  Returns cudaGetLastError() after the launch.
extern "C" int mxt_linear(const void* x, const void* w, const void* bias,
                          void* y, int M, int F, int C, void* stream) {
  return launch<0>(x, w, nullptr, bias, y, M, F, C, stream);
}

// K3q: as mxt_linear over codes (F, C), int8 or e4m3 bytes (e4m3 = 1),
// with fp32 scales (F,), each weight dequantized to code * scale.
extern "C" int mxt_linear_q(const void* x, const void* codes,
                            const void* scales, const void* bias, void* y,
                            int M, int F, int C, int e4m3, void* stream) {
  return e4m3 ? launch<2>(x, codes, scales, bias, y, M, F, C, stream)
              : launch<1>(x, codes, scales, bias, y, M, F, C, stream);
}
