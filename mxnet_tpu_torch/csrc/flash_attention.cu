// K1: blockwise causal softmax-attention forward, fp32.
//
// Replaces: mxnet_tpu/ops/attention.py::_pallas_attention (:497-506), the
// TPU's fused flash kernel, whose numerics the JAX package defines by
// the lax blockwise forward _flash_forward (:211-246).  Forward only;
// the backward comes with the training slice.
//
// Bound on an H100: for the serving oracle's shapes (T <= 1024, D = 128)
// the causal work is 4 * D flops per visible (query, key) pair, so the
// kernel sits near the fp32 SIMT line (67 TFLOP/s), while its bytes
// (q, k, v read once, out written once: 16 * n * H * T * D) are small.
//
// Design: one warp per query row, four rows of one (batch, head) per
// thread block so their key/value reads hit the same L1 lines.  A row
// visits the key blocks of ``block`` rows from position 0 in order and
// keeps (m, l, acc) in registers; the per-block arithmetic is
// online_softmax.cuh's merge_block, shared with the paged decode kernel
// so that a decode row and the matching row here agree bit for bit.
// Plain fp32 SIMT arithmetic with a fixed order; tensor cores, TMA and
// bf16 are later work.
#include "error.cuh"
#include "online_softmax.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * mxt::kWarp)
flash_forward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int n_rows, int T, int D, float scale, int causal,
                     int block) {
  const int lane = threadIdx.x % mxt::kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / mxt::kWarp;
  if (row >= n_rows) return;  // uniform over the warp
  const int i = row % T;      // query position
  const size_t base = static_cast<size_t>(row / T) * T * D;
  float qs[mxt::kMaxDPerLane];
  mxt::load_scaled_query(qs, q + static_cast<size_t>(row) * D, D, scale,
                         lane);
  mxt::RowState st;
  mxt::row_init(st);
  const int nblk = (T + block - 1) / block;
  for (int b = 0; b < nblk; ++b) {
    const int start = b * block;
    auto rows = [&](int j, const float*& kp, const float*& vp) {
      const int pos = start + j;
      if (pos >= T || (causal && pos > i)) return false;
      kp = k + base + static_cast<size_t>(pos) * D;
      vp = v + base + static_cast<size_t>(pos) * D;
      return true;
    };
    mxt::merge_block(st, qs, D, block, lane, rows);
  }
  mxt::store_row(st, out + static_cast<size_t>(row) * D, D, lane);
}

}  // namespace

// q, k, v, out: (n_bh, T, D) contiguous fp32 on the current device.
// Returns cudaGetLastError() after the launch.
extern "C" int mxt_flash_attention_forward(const void* q, const void* k,
                                           const void* v, void* out,
                                           int n_bh, int T, int D,
                                           float scale, int causal,
                                           int block, void* stream) {
  const int n_rows = n_bh * T;
  const int grid = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  flash_forward_kernel<<<grid, kWarpsPerBlock * mxt::kWarp, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n_rows, T, D,
      scale, causal, block);
  return static_cast<int>(cudaGetLastError());
}
