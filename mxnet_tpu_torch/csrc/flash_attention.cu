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
// Bound on an H100: operations.  The causal work is 4 * D flops a visible
// (query, key) pair against 67 TFLOP/s of fp32 SIMT; q, k, v are read
// and out written once, a few MB.  The bits forbid FMA (built
// -fmad=false, every add and multiply an explicit __fadd_rn/__fmul_rn),
// so each multiply and each add is an instruction of its own, and a
// score also takes the 31 adds of its fixed summation tree: the floor is
// about twice the bound.
//
// The bits are those of the one-warp-a-row kernel this one replaced
// (testing/paged_order.py::merge_sequential emulates it; K2 keeps them
// too, and serving holds a decode row equal to a K1 row bit for bit).
// A row visits the key blocks of ``block`` keys from position 0 in
// order; per block:
//   - scores: lane l of a warp summed q[d] k[d] over d = l, l + 32, ...
//     in increasing d from +0, then the xor butterfly 16, 8, 4, 2, 1
//     (online_softmax.cuh: lane_dot, warp_sum).  The butterfly is one
//     fixed tree whose leaves are the lanes in 5-bit bit-reversed order
//     (0, 16, 8, 24, 4, ...) added pairwise as a binary counter, and
//     float addition is commutative, so ONE thread forms the same score:
//     the lane partials in that order, five pending sums.  Lanes past D
//     add +0, and a partial that starts at +0 is never -0, so padding d
//     with zeros changes nothing;
//   - the block max (fmaxf, exact in any order), rescale, block_prob;
//   - psum and pv: serial sums over the block's visible keys in key
//     order (a key with a non-finite score is left out, as the ballot
//     did), then the fold  x * corr + sum  (online_softmax.cuh: rescale,
//     block_prob, fold).
// A block with no visible key is an exact no-op (correction 1 and +0
// added; l and acc are never -0, and while nothing is seen correction 0
// keeps them +0), so blocks past a tile's last row are skipped and a
// block masked for some rows of a tile may be run for all.
//
// A sliding window (window > 0: row i sees keys i - window < j, the JAX
// package's _flash_forward with window, :211-246) raises each row's lower
// bound; the groups of keys wholly left of the tile's window are skipped
// (flash_tile.cuh), and at window = 0 the kernel runs exactly the
// operations it ran without one.
//
// Design: a CTA (8 warps) takes a tile of TQ = 16 or 32 query rows of
// one (batch, head), chosen at launch so the grid fills the card (the
// oracle runs n1 h16 at T <= ~288, where 32-row tiles make fewer CTAs
// than SMs); the heaviest causal tiles launch first.  The scaled query
// is staged once, transposed, in shared memory.  Keys come in groups of
// whole blocks (at most 128 keys), staged 64 keys at a time: K
// transposed (so a thread reads four keys' d as one float4), V by rows,
// its loads in flight during the row pass.  Per group:
//   1. scores: each thread forms a (TQ/16 x 4) tile of scores in the
//      tree order above from shared memory, no shuffles; masked pairs
//      are stored as -inf;
//   2. the rows of a warp: one lane a (row, block) for the block max,
//      lane r the rescale chain of row r over the blocks, the lanes
//      across keys for the probabilities (-0 marks a key left out), one
//      lane a (row, block) for the serial psum, lane r the fold of l;
//   3. P.V: a warp owns TQ/8 rows, a lane 1..8 elements of d; for each
//      key in order pv += p * v, folded into acc at each block's end.
//      A left-out key adds p * v = -0 * v, which is exact (pv is never
//      -0) when v is finite; a staged V chunk with a non-finite value
//      runs the select instead, so such a value stays unread.
// Plain SIMT with a fixed order: TF32 tensor cores would break the fp32
// parity the serving contract rests on.  The tile itself is
// flash_tile.cuh's tile_forward, which K2's prefill and verify kernel
// (paged_attention.cu) runs over a slot's pages: this file gives it the
// contiguous rows of one (batch, head) and the causal or full horizons.
#include "error.cuh"
#include "flash_tile.cuh"
#include "per_device.cuh"

namespace {

using mxt::kWarp;
using mxt_tile::kGroup;
using mxt_tile::kThreads;
using mxt_tile::kWarps;
using mxt_tile::Layout;

constexpr int kSmemMax = 227 * 1024;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;
  int n_bh, T, D, causal, block, group, tiles, window;
  float scale;
};

// K1's tile source: query rows row0 .. of one (batch, head), keys and
// values of the same (T, D) block, row i seeing keys j <= i (causal) or
// all T, and with a window only keys j > i - window.
struct DenseTile {
  const float* q;  // the tile's first query row
  const float* k;
  const float* v;
  float* o;
  float* lse_p;  // the tile's first row's lse, or null
  int T, D, row0, n, causal;  // n: rows of the tile below T
  int window, block;
  static constexpr bool kGroupState = false;

  __device__ int rows() const { return n; }
  __device__ int horizon(int r) const {
    return r < n ? (causal ? row0 + r + 1 : T) : 0;
  }
  __device__ int lower(int r) const {
    return window > 0 ? max(row0 + r - window + 1, 0) : 0;
  }
  __device__ int key_begin() const { return lower(0) / block * block; }
  __device__ int key_end() const { return causal ? row0 + n : T; }
  __device__ mxt_tile::DenseRows keys(int j0) const {
    return {k + static_cast<size_t>(j0) * D, D};
  }
  __device__ mxt_tile::DenseRows values(int j0) const {
    return {v + static_cast<size_t>(j0) * D, D};
  }
  __device__ float* out(int r) const { return o + static_cast<size_t>(r) * D; }
  __device__ float* lse(int r) const { return lse_p ? lse_p + r : nullptr; }
};

// DPL elements of d a lane (DP = 32 DPL), RM query rows a warp.  Two
// CTAs of 32 rows share an SM only under a cap of 128 registers (a few
// spills); 16-row tiles fit two CTAs without one.
template <int DPL, int RM>
__global__ void __launch_bounds__(kThreads, DPL <= 4 && RM == 4 ? 2 : 1)
flash_forward_kernel(const Params p) {
  constexpr int TQ = kWarps * RM;
  const int bh = blockIdx.x % p.n_bh;
  const int row0 = (p.tiles - 1 - blockIdx.x / p.n_bh) * TQ;
  const size_t base = static_cast<size_t>(bh) * p.T * p.D;
  const DenseTile src{
      p.q + base + static_cast<size_t>(row0) * p.D, p.k + base, p.v + base,
      p.out + base + static_cast<size_t>(row0) * p.D,
      p.lse ? p.lse + static_cast<size_t>(bh) * p.T + row0 : nullptr, p.T,
      p.D, row0, min(TQ, p.T - row0), p.causal, p.window, p.block};
  mxt_tile::tile_forward<DPL, RM>(src, p.D, p.block, p.group, p.scale);
}

template <int DPL, int RM>
int launch(Params p, cudaStream_t stream) {
  constexpr int TQ = kWarps * RM;
  p.tiles = (p.T + TQ - 1) / TQ;
  const size_t bytes =
      4u * Layout(kWarp * DPL, TQ, p.group, p.block).words;
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> opted[mxt::kMaxDevices];
  if (bytes > 48 * 1024) {
    const cudaError_t e = mxt::opt_in_smem(flash_forward_kernel<DPL, RM>,
                                           kSmemMax, opted);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_forward_kernel<DPL, RM>
      <<<p.n_bh * p.tiles, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Query rows a CTA: 32, or 16 where 32-row tiles would not give two
// CTAs an SM.
template <int DPL>
int launch_rows(const Params& p, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = mxt::sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (static_cast<long long>(p.n_bh) * ((p.T + 31) / 32) >= 2LL * sms)
    return launch<DPL, 4>(p, stream);
  return launch<DPL, 2>(p, stream);
}

int forward(const void* q, const void* k, const void* v, void* out,
            void* lse, int n_bh, int T, int D, float scale, int causal,
            int block, int window, void* stream) {
  if (D < 1 || D > mxt::kMaxHeadDim || block < 1 ||
      block > mxt::kMaxBlock || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // a group is as many whole blocks as fit in kGroup keys
  const int group = block * (kGroup / block);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(out),
           static_cast<float*>(lse), n_bh, T, D, causal, block, group, 0,
           window, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_rows<1>(p, st);
  if (D <= 64) return launch_rows<2>(p, st);
  if (D <= 128) return launch_rows<4>(p, st);
  return launch_rows<8>(p, st);
}

}  // namespace

// q, k, v, out: (n_bh, T, D) contiguous fp32 on the current device, D <=
// 256; lse: (n_bh, T) fp32, or null when the caller needs no backward
// (serving); 1 <= block <= 128.  Returns cudaGetLastError() after the
// launch.
extern "C" int mxt_flash_attention_forward(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int n_bh, int T,
                                           int D, float scale, int causal,
                                           int block, void* stream) {
  return forward(q, k, v, out, lse, n_bh, T, D, scale, causal, block, 0,
                 stream);
}

// K1 with a sliding window of ``window`` >= 1 keys (row i sees keys j with
// i - window < j, and j <= i when causal); otherwise as above.
extern "C" int mxt_flash_attention_window(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse, int n_bh, int T, int D,
                                          float scale, int causal, int block,
                                          int window, void* stream) {
  if (window < 1) return static_cast<int>(cudaErrorInvalidValue);
  return forward(q, k, v, out, lse, n_bh, T, D, scale, causal, block,
                 window, stream);
}
