// K10: the linear-attention (SSM) recurrence of hybrid serving stacks,
// scanned over T rows for S slots and H heads, fp32.
//
// Replaces: mxnet_tpu/ops/ssm_ops.py::ssm_scan (:62-118), the lax.scan
// whose body (:99-110) runs per row
//   new   = g * state + k (outer) v              (state: (D, D) a head)
//   new   = where(valid, new, state)             (bucket padding: identity)
//   y[j]  = sum_i (q[i] * scale) * new[i, j]     (0 on a padded row)
// and, with collect, keeps the state after every row (the speculative
// verify's rollback source).
//
// The contract is the serving one: every row runs the same operations
// whatever T is and however many slots share the call, so a chunked
// prefill over T rows, T single-row decodes, a W-row verify and the
// full-context oracle (a scan from zero through this kernel) give the
// same states and outputs bit for bit.  Every add and multiply is an
// explicit __fadd_rn / __fmul_rn and the source builds with -fmad=false.
// The readout's order is fixed: lane l of a warp sums q[i] new[i, j]
// over i = l, l + 32, ... in increasing i from +0, then the xor
// butterfly 16, 8, 4, 2, 1 adds the lanes (online_softmax.cuh's
// lane_dot and warp_sum).  ops/ssm_ops.py::ssm_scan_plain runs that
// order with tensor ops, so the plain version gives the kernel's bits.
//
// Design.  Columns of the state are independent (new[:, j] needs k and
// v[j] alone, y[j] only new[:, j]), so a CTA of one warp owns a
// (slot, head, block of 8 columns): S x H x D/8 CTAs, which gives a
// 256-row prefill at S = 1 H = 16 D = 128 256 CTAs rather than 16.
// Lane l holds rows i = l + 32 c of its 8 columns in registers (D/32 x 8
// floats) for all T rows: the state is read once from the fp32 state
// pool and written back once (with collect, once more a row).  A lane's
// 8 columns of row i are 32 contiguous bytes, a whole sector, so the
// warp's reads and writes of the state use every byte they move.  The
// inputs of the next kAhead rows are in flight while a row is computed
// (a ring of registers, unrolled; a row's loads are used only when it
// is computed), so a row seldom waits on a load.  The state may be
// updated in place (state == state0): each CTA reads its block before
// it writes it, and no other CTA touches it.
//
// Bound on an H100: bytes at decode, operations at prefill.  Decode
// (S 8, T 1, H 16, D 128) reads and writes 8.4 MB of state each way,
// ~16.8 MB over 3.35 TB/s = 5 us; a 256-row prefill at S 1 does 5 D^2
// flops a row and head (update 3, readout 2), ~335 MFLOP over 67 TFLOP/s
// of fp32 SIMT = 5 us; a verify (S 8, W 5) with collect also writes
// W x 8.4 MB of snapshots, ~50 MB, 15 us.  The bits forbid FMA and fix
// the readout's order, so this simple kernel runs below those bounds.
#include "error.cuh"
#include "online_softmax.cuh"

namespace {

using mxt::kWarp;

constexpr int kCols = 8;   // state columns a warp
constexpr int kAhead = 4;  // rows whose inputs are loaded ahead

struct Params {
  const float* q;          // (S, T, H, D)
  const float* k;
  const float* v;
  const float* state0;     // (S, H, D, D): the state before row 0
  const float* gamma;      // (H,)
  const unsigned char* valid;  // (S, T) bool, or null: every row valid
  float* y;                // (S, T, H, D)
  float* state;            // (S, H, D, D) after row T - 1, or null
  float* states;           // (T, S, H, D, D) after each row, or null
  int S, T, H, D, blocks;  // blocks: column blocks a head
  float scale;
};

// One row's inputs a lane needs: q and k at its rows i (0 past D), v at
// the warp's columns, and the row's validity byte.  Only loads: nothing
// here waits for them.
template <int DC>
struct Row {
  float q[DC], k[DC], v[kCols];
  unsigned char valid;

  __device__ __forceinline__ void load(const Params& p, int s, int t, int h,
                                       int j0, int lane) {
    const size_t base = ((static_cast<size_t>(s) * p.T + t) * p.H + h) *
                        p.D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int i = lane + kWarp * c;
      q[c] = k[c] = 0.f;
      if (i < p.D) {
        q[c] = p.q[base + i];
        k[c] = p.k[base + i];
      }
    }
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      v[jj] = 0.f;
      if (j0 + jj < p.D) v[jj] = p.v[base + j0 + jj];
    }
    valid = 1;
    if (p.valid != nullptr) valid = p.valid[static_cast<size_t>(s) * p.T + t];
  }
};

// The lane's state block: rows i = lane + 32 c, columns j0 .. j0 + 7 of
// the (D, D) matrix at m; 32-byte loads and stores where D % 8 == 0.
template <int DC>
__device__ __forceinline__ void load_state(float (&st)[DC][kCols],
                                           const float* m, int D, int j0,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int i = lane + kWarp * c;
    const float* row = m + static_cast<size_t>(i) * D + j0;
    if (i < D && D % kCols == 0) {
      const float4 a = reinterpret_cast<const float4*>(row)[0];
      const float4 b = reinterpret_cast<const float4*>(row)[1];
      st[c][0] = a.x; st[c][1] = a.y; st[c][2] = a.z; st[c][3] = a.w;
      st[c][4] = b.x; st[c][5] = b.y; st[c][6] = b.z; st[c][7] = b.w;
    } else {
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj)
        st[c][jj] = (i < D && j0 + jj < D) ? row[jj] : 0.f;
    }
  }
}

template <int DC>
__device__ __forceinline__ void store_state(const float (&st)[DC][kCols],
                                            float* m, int D, int j0,
                                            int lane) {
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int i = lane + kWarp * c;
    if (i >= D) continue;
    float* row = m + static_cast<size_t>(i) * D + j0;
    if (D % kCols == 0) {
      reinterpret_cast<float4*>(row)[0] =
          make_float4(st[c][0], st[c][1], st[c][2], st[c][3]);
      reinterpret_cast<float4*>(row)[1] =
          make_float4(st[c][4], st[c][5], st[c][6], st[c][7]);
    } else {
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj)
        if (j0 + jj < D) row[jj] = st[c][jj];
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(kWarp) ssm_scan_kernel(const Params p) {
  const int lane = threadIdx.x;
  const int j0 = (blockIdx.x % p.blocks) * kCols;
  const int sh = blockIdx.x / p.blocks;  // s * H + h
  const int h = sh % p.H, s = sh / p.H;
  const size_t dd = static_cast<size_t>(p.D) * p.D;
  const float g = p.gamma[h];

  float st[DC][kCols];
  load_state<DC>(st, p.state0 + sh * dd, p.D, j0, lane);
  Row<DC> ring[kAhead];  // row t's inputs in ring[t % kAhead]
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (u < p.T) ring[u].load(p, s, u, h, j0, lane);
  for (int t0 = 0; t0 < p.T; t0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + u;  // uniform over the warp
      if (t >= p.T) break;
      const Row<DC>& cur = ring[u];
      float out = 0.f;  // lane jj's output: column j0 + jj
      if (cur.valid) {
#pragma unroll
        for (int c = 0; c < DC; ++c)
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj)
            st[c][jj] = __fadd_rn(__fmul_rn(g, st[c][jj]),
                                  __fmul_rn(cur.k[c], cur.v[jj]));
        float qs[DC];  // q * scale, rounded once: the JAX package's q32
#pragma unroll
        for (int c = 0; c < DC; ++c) qs[c] = __fmul_rn(cur.q[c], p.scale);
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          float part = 0.f;
#pragma unroll
          for (int c = 0; c < DC; ++c)
            if (lane + kWarp * c < p.D)
              part = __fadd_rn(part, __fmul_rn(qs[c], st[c][jj]));
          const float yj = mxt::warp_sum(part);
          if (lane == jj) out = yj;
        }
      }
      if (lane < kCols && j0 + lane < p.D)
        p.y[((static_cast<size_t>(s) * p.T + t) * p.H + h) * p.D + j0 +
            lane] = out;
      if (p.states != nullptr)
        store_state<DC>(st, p.states + (static_cast<size_t>(t) * p.S * p.H +
                                        sh) * dd,
                        p.D, j0, lane);
      if (t + kAhead < p.T) ring[u].load(p, s, t + kAhead, h, j0, lane);
    }
  }
  if (p.state != nullptr) store_state<DC>(st, p.state + sh * dd, p.D, j0,
                                          lane);
}

template <int DC>
int launch(const Params& p, cudaStream_t stream) {
  ssm_scan_kernel<DC><<<p.S * p.H * p.blocks, kWarp, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, y: (S, T, H, D); state0, state: (S, H, D, D); states: (T, S,
// H, D, D) or null; gamma: (H,); valid: (S, T) bytes or null.  fp32,
// contiguous, on the current device; D <= 256.  state may be state0 (in
// place) or null (not written).  Returns cudaGetLastError() after the
// launch.
extern "C" int mxt_ssm_scan(const void* q, const void* k, const void* v,
                            const void* state0, const void* gamma,
                            const void* valid, void* y, void* state,
                            void* states, int S, int T, int H, int D,
                            float scale, void* stream) {
  if (D < 1 || D > mxt::kMaxHeadDim || S < 1 || H < 1 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<const float*>(state0),
           static_cast<const float*>(gamma),
           static_cast<const unsigned char*>(valid), static_cast<float*>(y),
           static_cast<float*>(state), static_cast<float*>(states), S, T, H,
           D, (D + kCols - 1) / kCols, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<1>(p, st);
  if (D <= 64) return launch<2>(p, st);
  if (D <= 128) return launch<4>(p, st);
  return launch<8>(p, st);
}
