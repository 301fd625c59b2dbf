// K3: y = x @ W^T + b in fp32 with a summation order fixed by C alone.
//
// Replaces: mxnet_tpu/serve/model.py::_mm (:123-129) under exact=True,
// the broadcast-multiply-reduce form the JAX package uses so that a
// row's projection does not depend on how many rows share the call
// (model.py:16-33).  Every projection of the serving path and the LM
// head go through it.
//
// The contract: y[m, f] = b[f] + (((x[m,0] w[f,0] + x[m,1] w[f,1]) + ...)
// as one fused-multiply-add chain over c = 0 .. C-1, then one rounded
// add of the bias.  No split-K and no tiling of the reduction that
// depends on M, so row r of an M-row call equals the same row computed
// alone, bit for bit.  cuBLAS and torch.matmul promise no such thing.
//
// Bound on an H100: at decode (M = slots = 8) bytes — the weight matrix
// is read once, F * C * 4 bytes over 3.35 TB/s; at prefill (M = 256)
// operations, 2 * M * F * C flops over the fp32 SIMT peak of 67 TFLOP/s
// (tensor cores would round the inputs to TF32 and are not used).
//
// Design: a classic shared-memory SIMT tile — a (BM x BN) output tile
// per thread block, a (TM x TN) micro-tile per thread, BK-deep slabs of
// x and W staged through shared memory.  Each output's FMA chain runs
// over the slabs in increasing c, which keeps the order independent of
// the tile shape, so the small-M and large-M configurations below give
// the same bits.  Double buffering, vector loads and wgmma are later
// work.
#include "error.cuh"

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
linear_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y, int M,
              int F, int C) {
  constexpr int TX = BN / TN;
  constexpr int NT = (BM / TM) * TX;
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < C; c0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int gm = m0 + r, gc = c0 + kk;
      xs[kk][r] = (gm < M && gc < C) ? x[static_cast<size_t>(gm) * C + gc]
                                     : 0.f;
    }
    for (int e = tid; e < BN * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int gf = f0 + r, gc = c0 + kk;
      ws[kk][r] = (gf < F && gc < C) ? w[static_cast<size_t>(gf) * C + gc]
                                     : 0.f;
    }
    __syncthreads();
    const int kn = min(BK, C - c0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk < kn) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gf = f0 + tx * TN + j;
      if (gf >= F) continue;
      y[static_cast<size_t>(gm) * F + gf] =
          bias ? __fadd_rn(acc[i][j], bias[gf]) : acc[i][j];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
void launch(const float* x, const float* w, const float* bias, float* y,
            int M, int F, int C, cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  linear_kernel<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(x, w, bias, y, M, F, C);
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
  if (M <= 16)
    launch<16, 32, 32, 2, 2>(xp, wp, bp, yp, M, F, C, st);  // decode rows
  else
    launch<64, 64, 16, 4, 4>(xp, wp, bp, yp, M, F, C, st);  // prefill rows
  return static_cast<int>(cudaGetLastError());
}
