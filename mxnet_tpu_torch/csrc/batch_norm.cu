// K5 bn_stats and K6 bn_grad_sums: BatchNorm's per-channel fp32 sums.
//
// Replaces: mxnet_tpu/ops/pallas_bn.py::bn_stats (:79-115), per-channel
// (sum x, sum x^2), and ::bn_grad_sums (:119-172), per-channel (sum dy,
// sum dy * xhat) with xhat = (x - mean) * inv formed in fp32 inside the
// reduction (:146-151).  nn_ops._bn_train turns the first pair into the
// batch mean and variance and the second into dbeta, dgamma and dx.
//
// Bound on an H100: bytes.  K5 reads x once and K6 reads dy and x once
// (bf16 or fp32); each writes 2 * C floats.  A handful of flops per
// element is far below the card's ~20 flops per byte of bandwidth.
//
// Design: the contiguous tensor is (outer, C, inner) around the channel
// axis -- NCHW is (N, C, H*W), NHWC is (N*H*W, C, 1) -- so one kernel
// pair serves both layouts.  No atomics: each channel's outer rows are
// cut into `chunks` runs of `rows` rows (the wrapper picks them from the
// shape alone), one thread block reduces one run of one channel (inner >
// 1) or of 32 neighbouring channels (inner == 1, so a warp reads 32
// consecutive channels) into an fp32 partial, in a fixed order, and a
// second launch adds each channel's partials in chunk order.  Every sum
// has one owner and one order, so reruns give the same bits, and no
// sequential chain is longer than a few hundred terms, which keeps the
// fp32 sums of a 38.5 M-element channel (the bn_data layer) accurate.
// Scalar loads; vector loads, cp.async/TMA and a single-pass finish are
// later work.
#include <cuda_bf16.h>

#include "error.cuh"

namespace {

constexpr int kThreads = 256;  // stage-1 block size, inner > 1
constexpr int kCols = 32;      // channels per block, inner == 1
constexpr int kColRows = 8;    // row lanes per block, inner == 1
constexpr int kFinish = 256;   // finish block size

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// What one element adds to the two running sums.
struct StatsOp {
  const void* x;
  template <class T>
  __device__ __forceinline__ void add(long long idx, int, float& a,
                                      float& b) const {
    const float v = to_f32(static_cast<const T*>(x)[idx]);
    a = __fadd_rn(a, v);
    b = __fadd_rn(b, __fmul_rn(v, v));
  }
};

struct GradOp {
  const void* dy;
  const void* x;
  const float* mean;
  const float* inv;
  template <class T>
  __device__ __forceinline__ void add(long long idx, int c, float& a,
                                      float& b) const {
    const float g = to_f32(static_cast<const T*>(dy)[idx]);
    const float xv = to_f32(static_cast<const T*>(x)[idx]);
    const float xhat = __fmul_rn(__fsub_rn(xv, mean[c]), inv[c]);
    a = __fadd_rn(a, g);
    b = __fadd_rn(b, __fmul_rn(g, xhat));
  }
};

// Fixed-order sum of (a, b) over the block's kThreads threads; thread 0
// returns the totals.
__device__ __forceinline__ void block_sum(float& a, float& b) {
  __shared__ float sa[kThreads / 32], sb[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, off));
    b = __fadd_rn(b, __shfl_down_sync(0xffffffffu, b, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = sa[0];
    b = sb[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      a = __fadd_rn(a, sa[w]);
      b = __fadd_rn(b, sb[w]);
    }
  }
}

// inner > 1: block (s, c) sums rows [s*rows, s*rows + rows) of channel c.
// The run's (row, i) elements are walked as one flat index j; thread t
// takes j = t, t + kThreads, ... so neighbouring threads read
// neighbouring addresses within a row.
template <class T, class Op>
__global__ void __launch_bounds__(kThreads)
sums_rows_kernel(Op op, int outer, int C, int inner, int rows,
                 float* __restrict__ partial) {
  const int s = blockIdx.x, c = blockIdx.y, chunks = gridDim.x;
  const int o0 = s * rows;
  const int o1 = min(o0 + rows, outer);
  const long long n = static_cast<long long>(o1 - o0) * inner;
  const int q = kThreads / inner, r = kThreads % inner;
  int o = o0 + static_cast<int>(threadIdx.x) / inner;
  int i = static_cast<int>(threadIdx.x) % inner;
  float a = 0.f, b = 0.f;
  for (long long j = threadIdx.x; j < n; j += kThreads) {
    op.template add<T>((static_cast<long long>(o) * C + c) * inner + i, c,
                       a, b);
    o += q;
    i += r;
    if (i >= inner) {
      i -= inner;
      ++o;
    }
  }
  block_sum(a, b);
  if (threadIdx.x == 0) {
    partial[static_cast<long long>(s) * C + c] = a;
    partial[(static_cast<long long>(chunks) + s) * C + c] = b;
  }
}

// inner == 1 (channels last): block (s, tile) sums rows [s*rows, ...) of
// channels tile*kCols .. +kCols; lane x is the channel, lane y strides
// over rows, and the kColRows row lanes are added in order at the end.
template <class T, class Op>
__global__ void __launch_bounds__(kCols * kColRows)
sums_cols_kernel(Op op, int outer, int C, int rows,
                 float* __restrict__ partial) {
  __shared__ float sa[kColRows][kCols], sb[kColRows][kCols];
  const int s = blockIdx.x, chunks = gridDim.x;
  const int c = blockIdx.y * kCols + threadIdx.x;
  const int o1 = min(s * rows + rows, outer);
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int o = s * rows + threadIdx.y; o < o1; o += kColRows)
      op.template add<T>(static_cast<long long>(o) * C + c, c, a, b);
  }
  sa[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int y = 1; y < kColRows; ++y) {
      a = __fadd_rn(a, sa[y][threadIdx.x]);
      b = __fadd_rn(b, sb[y][threadIdx.x]);
    }
    partial[static_cast<long long>(s) * C + c] = a;
    partial[(static_cast<long long>(chunks) + s) * C + c] = b;
  }
}

// out[k][c] = sum over s in order of partial[k][s][c], k = 0, 1.  Op only
// names the instance, so a profile tells K5's finish from K6's.
template <class Op>
__global__ void __launch_bounds__(kFinish)
finish_kernel(const float* __restrict__ partial, int chunks, int C,
              float* __restrict__ out) {
  const int e = blockIdx.x * kFinish + threadIdx.x;
  if (e >= 2 * C) return;
  const int k = e / C, c = e % C;
  const float* p = partial + static_cast<long long>(k) * chunks * C + c;
  float acc = 0.f;
  for (int s = 0; s < chunks; ++s)
    acc = __fadd_rn(acc, p[static_cast<long long>(s) * C]);
  out[e] = acc;
}

template <class T, class Op>
int run(const Op& op, int outer, int C, int inner, int rows, int chunks,
        float* partial, float* out, cudaStream_t stream) {
  if (inner > 1) {
    sums_rows_kernel<T, Op><<<dim3(chunks, C), kThreads, 0, stream>>>(
        op, outer, C, inner, rows, partial);
  } else {
    sums_cols_kernel<T, Op>
        <<<dim3(chunks, (C + kCols - 1) / kCols), dim3(kCols, kColRows), 0,
           stream>>>(op, outer, C, rows, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<Op><<<(2 * C + kFinish - 1) / kFinish, kFinish, 0, stream>>>(
      partial, chunks, C, out);
  return static_cast<int>(cudaGetLastError());
}

template <class Op>
int dispatch(int dtype, const Op& op, int outer, int C, int inner, int rows,
             int chunks, void* partial, void* out, void* stream) {
  auto* p = static_cast<float*>(partial);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<__nv_bfloat16>(op, outer, C, inner, rows, chunks, p, o, st);
  return run<float>(op, outer, C, inner, rows, chunks, p, o, st);
}

}  // namespace

// x: contiguous (outer, C, inner), dtype 0 = float32, 1 = bfloat16.
// partial: (2, chunks, C) fp32 scratch; out: (2, C) fp32, out[0] = sum x,
// out[1] = sum x^2.  chunks = ceil(outer / rows).  Two launches on
// `stream`; returns cudaGetLastError().
extern "C" int mxt_bn_stats(const void* x, int dtype, int outer, int C,
                            int inner, int rows, int chunks, void* partial,
                            void* out, void* stream) {
  return dispatch(dtype, StatsOp{x}, outer, C, inner, rows, chunks, partial,
                  out, stream);
}

// dy, x: contiguous (outer, C, inner) of one dtype; mean, inv: (C,) fp32.
// out[0] = sum dy, out[1] = sum dy * (x - mean) * inv.  As mxt_bn_stats
// otherwise.
extern "C" int mxt_bn_grad_sums(const void* dy, const void* x,
                                const void* mean, const void* inv, int dtype,
                                int outer, int C, int inner, int rows,
                                int chunks, void* partial, void* out,
                                void* stream) {
  return dispatch(dtype,
                  GradOp{dy, x, static_cast<const float*>(mean),
                         static_cast<const float*>(inv)},
                  outer, C, inner, rows, chunks, partial, out, stream);
}
