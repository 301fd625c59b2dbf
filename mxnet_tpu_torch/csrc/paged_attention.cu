// K2: attention of S slots' queries over their paged KV cache, fp32.
//
// Replaces: mxnet_tpu/ops/attention.py::decode_attention (:368-490)
// together with the page gathers that feed it in serve/model.py
// (k_pool[i][tables], :586-589 for prefill and :719-722 for decode).
// One kernel serves both: decode (Q = 1 query per slot, one horizon per
// slot) and prefill (S = 1, Q = bucket rows, per-row horizons
// offset + j + 1).
//
// Bound on an H100: bytes.  Each visible key and value row is read once
// per (slot, head) and is used by only Q queries, so at decode the work
// is ~0.5 flop per byte, far below the card's fp32 balance point; the
// least time is the visible K/V bytes over 3.35 TB/s.
//
// Design: the kernel reads layer i's pages through the page table and
// never materialises the gathered (S, H, Tcap, D) context the JAX
// package builds.  One warp per (slot, head, query row); it visits all
// max_pages table entries in order, one page (block = page_size keys)
// at a time, with the validity mask "position < horizon" — keys past the
// horizon are never loaded, so a fully masked page costs no memory
// traffic and is an exact no-op in the merge.  The merge is
// online_softmax.cuh's, shared with flash_attention.cu, so a decode row
// equals the matching row of the full-context forward bit for bit.  A
// slot with horizon 0 sees no key and gives 0.
#include "error.cuh"
#include "online_softmax.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * mxt::kWarp)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       float* __restrict__ out, int n_rows, int H, int Q,
                       int D, int page, int max_pages, int per_row,
                       float scale) {
  const int lane = threadIdx.x % mxt::kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / mxt::kWarp;
  if (row >= n_rows) return;  // uniform over the warp
  const int qi = row % Q;
  const int h = (row / Q) % H;
  const int s = row / (Q * H);
  const int horizon = per_row ? lengths[s * Q + qi] : lengths[s];
  const int* table = tables + static_cast<size_t>(s) * max_pages;
  float qs[mxt::kMaxDPerLane];
  mxt::load_scaled_query(qs, q + static_cast<size_t>(row) * D, D, scale,
                         lane);
  mxt::RowState st;
  mxt::row_init(st);
  for (int b = 0; b < max_pages; ++b) {
    const int start = b * page;
    const size_t pg = start < horizon ? table[b] : 0;
    auto rows = [&](int j, const float*& kp, const float*& vp) {
      if (start + j >= horizon) return false;
      const size_t off = ((pg * page + j) * H + h) * static_cast<size_t>(D);
      kp = k_pool + off;
      vp = v_pool + off;
      return true;
    };
    mxt::merge_block(st, qs, D, page, lane, rows);
  }
  mxt::store_row(st, out + static_cast<size_t>(row) * D, D, lane);
}

}  // namespace

// q, out: (S, H, Q, D); k_pool, v_pool: one layer's (pages + 1, page, H, D)
// pool; tables: (S, max_pages) int32; lengths: (S,) int32, or (S, Q) when
// per_row.  All contiguous on the current device.  Returns
// cudaGetLastError() after the launch.
extern "C" int mxt_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* lengths, void* out, int S,
                                   int H, int Q, int D, int page,
                                   int max_pages, int per_row, float scale,
                                   void* stream) {
  const int n_rows = S * H * Q;
  const int grid = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  paged_attention_kernel<<<grid, kWarpsPerBlock * mxt::kWarp, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out), n_rows, H,
      Q, D, page, max_pages, per_row, scale);
  return static_cast<int>(cudaGetLastError());
}
