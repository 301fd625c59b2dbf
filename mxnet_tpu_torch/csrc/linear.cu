// K3: y = x @ W^T + b in fp32 with a summation order fixed by C alone.
//
// Replaces: mxnet_tpu/serve/model.py::_mm (:123-129) under exact=True,
// the broadcast-multiply-reduce form the JAX package uses so that a
// row's projection does not depend on how many rows share the call
// (model.py:16-33).  Every projection of the serving path and the LM
// head go through it.
//
// The contract: y[m, f] = b[f] + (((x[m,0] w[f,0] + x[m,1] w[f,1]) + ...)
// as one fused-multiply-add chain over c = 0 .. C-1 from 0, then one
// rounded add of the bias.  No split-K and no tiling of the reduction
// that depends on M, so row r of an M-row call equals the same row
// computed alone, bit for bit.  cuBLAS and torch.matmul promise no such
// thing.  Both kernels below run exactly this chain; they differ only in
// how the bytes reach it.
//
// Bound on an H100: at decode (M = slots = 8) bytes — the weight matrix
// is read once, F * C * 4 bytes over 3.35 TB/s; at prefill (M = 256)
// operations, 2 * M * F * C flops over the fp32 SIMT peak of 67 TFLOP/s
// (tensor cores would round the inputs to TF32 and are not used).
//
// Decode rows (M <= 16): linear_stream_kernel.  A CTA owns a slab of 16
// features (128 CTAs at F = 2048, so even the narrowest projection
// covers the card) and streams its weight rows, with the matching
// columns of x, through a ring of shared-memory stages filled by bulk
// copies (cp.async.bulk, one per row and stage, completing on an
// mbarrier per stage).  The ring is as deep as shared memory allows while
// every CTA of the launch stays resident.  Each thread runs whole chains:
// it reads four columns of its weight rows and x rows as float4s (padded
// rows: no bank conflicts) and feeds them to its chains in column order,
// in a loop without a branch.  One chain per output is C dependent FMAs,
// ~18 us at C = 8192 — about the weight-read bound of that projection,
// so the chain is not split.  What limits the kernel is shared memory's
// read rate (a warp's float4 read takes four cycles even as a broadcast)
// against the number of warps that hide its latency, so the blocking
// follows the launch: a one-wave launch (F <= 16 x SMs) runs one output
// a thread; a larger one gives each thread two features x two rows.
//
// Prefill rows (M > 16), and inputs the bulk copies cannot take (C not
// a multiple of 4, unaligned rows): linear_kernel, a shared-memory SIMT
// tile — a (64 x 64) output tile per thread block, a (4 x 4) micro-tile
// per thread, 16-column slabs of x and W double-buffered in shared memory
// (the next slab's float4 loads in flight while the block runs the
// current one), each output's chain over the slabs in increasing c.
#include "error.cuh"
#include "per_device.cuh"
#include "sm90.cuh"

namespace {

// The tiled kernel: each thread reads one float4 of each slab of x and W
// (4 floats one by one where ``vec`` is false: C not a multiple of 4, or
// rows not 16-byte aligned) into registers while the block runs the
// current slab, then stores it transposed into the other buffer.
constexpr int kTile = 64;
constexpr int kSlabCols = 16;
constexpr int kTilePitch = kTile + 4;  // floats; keeps float4 alignment

// Four consecutive elements of row ``row`` from column ``c`` (0 past the
// matrix).
__device__ __forceinline__ float4 load4(const float* __restrict__ a,
                                        int row, int rows, int c, int C,
                                        bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return v;
  const float* p = a + static_cast<size_t>(row) * C + c;
  if (vec && c + 3 < C) return *reinterpret_cast<const float4*>(p);
  if (c < C) v.x = p[0];
  if (c + 1 < C) v.y = p[1];
  if (c + 2 < C) v.z = p[2];
  if (c + 3 < C) v.w = p[3];
  return v;
}

__global__ void __launch_bounds__(256)
linear_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y, int M,
              int F, int C, bool vec) {
  __shared__ __align__(16) float xs[2][kSlabCols][kTilePitch];
  __shared__ __align__(16) float ws[2][kSlabCols][kTilePitch];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // features f0 + 4 tx ...
  const int ty = tid / 16;  // rows m0 + 4 ty ...
  const int m0 = blockIdx.y * kTile;
  const int f0 = blockIdx.x * kTile;
  const int lr = tid / 4;        // the slab row this thread loads
  const int lc = tid % 4 * 4;    // and its first column
  const int nt = (C + kSlabCols - 1) / kSlabCols;
  float4 rx = load4(x, m0 + lr, M, lc, C, vec);
  float4 rw = load4(w, f0 + lr, F, lc, C, vec);
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
      rx = load4(x, m0 + lr, M, c0 + kSlabCols + lc, C, vec);
      rw = load4(w, f0 + lr, F, c0 + kSlabCols + lc, C, vec);
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

constexpr int kStreamRows = 16;  // M <= 16 takes the streaming kernel
constexpr int kSlab = 16;        // features a CTA (one warp) owns
constexpr int kMaxStages = 12;
constexpr int kSmemMax = 227 * 1024;

// Columns [0, n4 * 4) of one stage into L x G chains: the weight rows at
// ws[g] and the x rows at xs, xs + step, ... (float4s).
template <int L, int G, int R>
__device__ __forceinline__ void stage_chains(float (&acc)[R][G],
                                             const float4* (&ws)[G],
                                             const float4* xs, int step,
                                             int n4) {
#pragma unroll 4
  for (int c = 0; c < n4; ++c) {
    float4 wv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) wv[g] = ws[g][c];
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
// into groups of 4 R.  A float4 read of the stage's weight rows touches 8
// rows in distinct banks in each quarter warp; a read of an x row is one
// broadcast.  So a warp spends 4 (G + R) shared-memory cycles on 4
// columns of 32 G R chains: G = R = 1 (4 warps at M = 8) when the launch
// is one wave and needs every warp to hide latency, G = R = 2 (one warp)
// when several CTAs share an SM and shared memory is the scarcer
// resource.
template <int G, int R>
__global__ void __launch_bounds__(256)
linear_stream_kernel(const float* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int M, int F, int C, int cols, int stages) {
  extern __shared__ __align__(128) float ring[];  // stages x (16 + M) rows
  __shared__ __align__(8) uint64_t full[kMaxStages];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int v = tid / 32;
  const int fl = 8 * G * (v % (2 / G)) + lane % 8;  // first feature
  const int r0 = 4 * R * (v / (2 / G)) + lane / 8;  // and row
  const int live = min(R, max(0, (M - r0 + 3) / 4));  // rows r0 + 4 j < M
  const int pitch = cols + 4;  // floats between rows: no bank conflicts
  const int f0 = blockIdx.x * kSlab;
  const int nf = min(kSlab, F - f0);
  const int stage_floats = (kSlab + M) * pitch;
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
    const uint32_t bytes = 4u * min(cols, C - c0);
    const uint32_t bar = mxt90::smem_u32(&full[k % stages]);
    float* st = ring + (k % stages) * stage_floats;
    if (lane == 0) mxt90::mbar_expect_tx(bar, (nf + M) * bytes);
    __syncwarp();
    if (lane < nf + M) {
      const bool is_w = lane < nf;
      const float* src = is_w ? w + static_cast<size_t>(f0 + lane) * C + c0
                              : x + static_cast<size_t>(lane - nf) * C + c0;
      float* dst = st + (is_w ? lane : kSlab + lane - nf) * pitch;
      mxt90::bulk_load(mxt90::smem_u32(dst), src, bytes, bar);
    }
  };
  if (v == 0)
    for (int k = 0; k < min(stages - 1, nk); ++k) issue(k);
  float acc[R][G];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[j][g] = 0.f;
  for (int k = 0; k < nk; ++k) {
    __syncthreads();  // every thread is done with stage (k - 1) % stages
    if (v == 0 && k + stages - 1 < nk) issue(k + stages - 1);
    mxt90::mbar_wait(mxt90::smem_u32(&full[k % stages]), (k / stages) & 1);
    const float* st = ring + (k % stages) * stage_floats;
    const float4* ws[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      ws[g] = reinterpret_cast<const float4*>(st + (fl + 8 * g) * pitch);
    const float4* xs =
        reinterpret_cast<const float4*>(st + (kSlab + r0) * pitch);
    const int n4 = min(cols, C - k * cols) / 4;
    // pitch float4s from x row r0 + 4 j to r0 + 4 j + 4; one branch-free
    // loop for each count of live rows
    if (live == R) stage_chains<R>(acc, ws, xs, pitch, n4);
    else if (R == 2 && live == 1)
      stage_chains<1>(acc, ws, xs, pitch, n4);
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
int launch_stream(const float* x, const float* w, const float* bias,
                  float* y, int M, int F, int C, int cols, int per_sm,
                  cudaStream_t stream) {
  // the barriers' static bytes count against the opt-in
  static std::atomic<bool> opted[mxt::kMaxDevices];
  const cudaError_t e =
      mxt::opt_in_smem(linear_stream_kernel<G, R>, kSmemMax, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the ring is as deep as shared memory allows while every CTA of the
  // launch stays resident, and holds at least two stages
  const int budget = kSmemMax / per_sm - 1024 - 128;
  while (cols > 128 && 2 * (kSlab + M) * (cols + 4) * 4 > budget) cols /= 2;
  const int stage_bytes = (kSlab + M) * (cols + 4) * 4;
  const int stages = min(max(budget / stage_bytes, 2), kMaxStages);
  const int warps = 2 / G * ((M + 4 * R - 1) / (4 * R));
  linear_stream_kernel<G, R><<<(F + kSlab - 1) / kSlab, 32 * warps,
                               stages * stage_bytes, stream>>>(
      x, w, bias, y, M, F, C, cols, stages);
  return static_cast<int>(cudaGetLastError());
}

// One wave of CTAs (F <= 16 x SMs: one CTA a SM) streams 512-column
// stages (1024 from C = 8192) with one output a thread; larger launches
// (up to 4 CTAs a SM resident) 256-column stages with four outputs a
// thread (two at M <= 4).  Measured best of 128 to 1024 columns and of the
// two blockings at every serving shape, on an H100.
int launch_decode(const float* x, const float* w, const float* bias,
                  float* y, int M, int F, int C, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = mxt::sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ctas = (F + kSlab - 1) / kSlab;
  const int per_sm = min((ctas + sms - 1) / sms, 4);
  if (per_sm == 1)
    return launch_stream<1, 1>(x, w, bias, y, M, F, C,
                               C >= 8192 ? 1024 : 512, 1, stream);
  if (M <= 4)
    return launch_stream<2, 1>(x, w, bias, y, M, F, C, 256, per_sm, stream);
  return launch_stream<2, 2>(x, w, bias, y, M, F, C, 256, per_sm, stream);
}

int launch_tiled(const float* x, const float* w, const float* bias,
                 float* y, int M, int F, int C, bool vec,
                 cudaStream_t stream) {
  const dim3 grid((F + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  linear_kernel<<<grid, 256, 0, stream>>>(x, w, bias, y, M, F, C, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x: (M, C), w: (F, C), bias: (F,) or null, y: (M, F); contiguous fp32 on
// the current device.  Returns cudaGetLastError() after the launch.
extern "C" int mxt_linear(const void* x, const void* w, const void* bias,
                          void* y, int M, int F, int C, void* stream) {
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(w);
  if (M <= kStreamRows && vec)
    return launch_decode(xp, wp, bp, yp, M, F, C, st);  // decode rows
  return launch_tiled(xp, wp, bp, yp, M, F, C, vec, st);
}
