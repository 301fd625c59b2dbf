// K1: blockwise softmax-attention forward in fp32, with an optional
// logsumexp output for the backward (K4).  bf16 inputs go to K7
// (flash_attention_sm90.cu), the tensor-core kernel; this SIMT kernel is
// the fp32 path: serving's bit-exact oracle and fp32 training.
//
// Replaces: mxnet_tpu/ops/attention.py::_pallas_attention (:497-506), the
// TPU's fused flash kernel, whose numerics the JAX package defines by
// the lax blockwise forward _flash_forward (:211-246): out and
// lse = m + log l.
//
// Bound on an H100: the causal work is 4 * D flops per visible (query,
// key) pair, so at T = 1024, D = 128 the kernel is bound by operations
// (fp32 SIMT, 67 TFLOP/s), while its bytes (q, k, v read once, out and
// lse written once) are small.
//
// Design: one warp per query row, four rows of one (batch, head) per
// thread block so their key/value reads hit the same L1 lines.  A row
// visits the key blocks of ``block`` rows from position 0 in order and
// keeps (m, l, acc) in registers; the per-block arithmetic is
// online_softmax.cuh's merge_block, shared with the paged decode kernel
// so that a decode row and the matching row here agree bit for bit.
// Plain SIMT with a fixed order and -fmad=false: TF32 tensor cores would
// break the fp32 parity the serving contract rests on.
#include "error.cuh"
#include "online_softmax.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

template <class T>
__global__ void __launch_bounds__(kWarpsPerBlock * mxt::kWarp)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int n_rows, int T_, int D,
                     float scale, int causal, int block) {
  const int lane = threadIdx.x % mxt::kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / mxt::kWarp;
  if (row >= n_rows) return;  // uniform over the warp
  const int i = row % T_;     // query position
  const size_t base = static_cast<size_t>(row / T_) * T_ * D;
  float qs[mxt::kMaxDPerLane];
  mxt::load_scaled_query(qs, q + static_cast<size_t>(row) * D, D, scale,
                         lane);
  mxt::RowState st;
  mxt::row_init(st);
  const int nblk = (T_ + block - 1) / block;
  for (int b = 0; b < nblk; ++b) {
    const int start = b * block;
    auto rows = [&](int j, const T*& kp, const T*& vp) {
      const int pos = start + j;
      if (pos >= T_ || (causal && pos > i)) return false;
      kp = k + base + static_cast<size_t>(pos) * D;
      vp = v + base + static_cast<size_t>(pos) * D;
      return true;
    };
    mxt::merge_block<T>(st, qs, D, block, lane, rows);
  }
  mxt::store_row(st, out + static_cast<size_t>(row) * D, D, lane);
  // lse = where(isfinite(m), m, 0) + log(max(l, 1e-38)), the guards of
  // _flash_forward (:245)
  if (lse != nullptr && lane == 0)
    lse[row] = __fadd_rn(isfinite(st.m) ? st.m : 0.f,
                         logf(fmaxf(st.l, 1e-38f)));
}

template <class T>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int n_bh, int T_, int D, float scale, int causal,
           int block, cudaStream_t stream) {
  const int n_rows = n_bh * T_;
  const int grid = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  flash_forward_kernel<T><<<grid, kWarpsPerBlock * mxt::kWarp, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), n_rows, T_, D, scale, causal, block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: (n_bh, T, D) contiguous fp32 on the current device;
// lse: (n_bh, T) fp32, or null when the caller needs no backward
// (serving).  Returns cudaGetLastError() after the launch.
extern "C" int mxt_flash_attention_forward(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int n_bh, int T,
                                           int D, float scale, int causal,
                                           int block, void* stream) {
  return launch<float>(q, k, v, out, lse, n_bh, T, D, scale, causal, block,
                       static_cast<cudaStream_t>(stream));
}
