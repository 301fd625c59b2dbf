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
// added; l and acc are never -0), so blocks past a tile's last row are
// skipped and a block masked for some rows of a tile may be run for all.
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
// parity the serving contract rests on.
#include "error.cuh"
#include "online_softmax.cuh"
#include "per_device.cuh"

namespace {

using mxt::kWarp;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kChunk = 64;              // keys staged at once
constexpr int kGroup = 128;             // keys scored before the sums
constexpr int kChunkPad = kChunk + 4;   // row stride of K^T
constexpr int kSmemMax = 227 * 1024;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;
  int n_bh, T, D, causal, block, group, tiles;
  float scale;
};

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// Offsets (in 4-byte words) of a CTA's shared arrays: the scaled query
// transposed (DP x TQ + 4), the staged chunk (K^T, DP x kChunkPad, or V,
// kChunk x DP), the group's scores (TQ x G), the probabilities
// transposed (G x TQ + 4), and per row and block of the group the
// correction, the shift, and the block max (later the probability sum).
struct Layout {
  int qt, kv, s, s_ld, pt, corr, safe, part, nbg, words;
  __host__ __device__ Layout(int DP, int TQ, int G, int block) {
    const int tqp = TQ + 4;
    nbg = G / block;
    s_ld = round4(G) + 4;
    qt = 0;
    kv = qt + DP * tqp;
    s = kv + (DP * kChunkPad > kChunk * DP ? DP * kChunkPad : kChunk * DP);
    pt = s + TQ * s_ld;
    corr = pt + G * tqp;
    safe = corr + TQ * nbg;
    part = safe + TQ * nbg;
    words = part + TQ * nbg;
  }
};

// Stages rows [0, n) of ``src`` (row stride D) transposed into
// dst[d * ld + row] for d < DP and row < rows (a multiple of 8), times
// ``mul`` when ``scaled``; zero past D and from row n on.  Eight rows a
// warp-load, four float4 of each, when D % 4 == 0.
template <int DP>
__device__ __forceinline__ void stage_transposed(
    float* __restrict__ dst, int ld, const float* __restrict__ src, int n,
    int rows, int D, bool scaled, float mul, int tid) {
  if (D % 4 == 0) {
    constexpr int DP4 = DP / 4;
    for (int u = tid; u < rows * DP4; u += kThreads) {
      const int row = u % 8 + 8 * (u / (8 * DP4));
      const int d4 = (u / 8) % DP4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n && 4 * d4 < D)
        x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(row)
                                             * D + 4 * d4);
      if (scaled) {
        x.x = __fmul_rn(x.x, mul);
        x.y = __fmul_rn(x.y, mul);
        x.z = __fmul_rn(x.z, mul);
        x.w = __fmul_rn(x.w, mul);
      }
      float* col = dst + 4 * d4 * ld + row;
      col[0] = x.x;
      col[ld] = x.y;
      col[2 * ld] = x.z;
      col[3 * ld] = x.w;
    }
  } else {
    for (int u = tid; u < rows * DP; u += kThreads) {
      const int row = u % rows, d = u / rows;
      float x = (row < n && d < D) ? src[static_cast<size_t>(row) * D + d]
                                   : 0.f;
      dst[d * ld + row] = scaled ? __fmul_rn(x, mul) : x;
    }
  }
}

// A chunk of value rows held in registers on its way to shared memory
// (dst[row * DP + d]): rows [0, n) of ``src`` (row stride D, D % 4 ==
// 0), float4 unit u = tid + kThreads * i; zero past D and from row n on.
template <int DP>
struct ChunkRegs {
  static constexpr int DP4 = DP / 4;
  static constexpr int N = kChunk * DP4 / kThreads;
  float4 x[N];

  // issues the loads; returns whether a loaded value is not finite
  __device__ __forceinline__ bool load(const float* __restrict__ src, int n,
                                       int D, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int row = (tid + kThreads * i) / DP4;
      const int d4 = (tid + kThreads * i) % DP4;
      x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n && 4 * d4 < D)
        x[i] = *reinterpret_cast<const float4*>(
            src + static_cast<size_t>(row) * D + 4 * d4);
    }
    bool bad = false;
#pragma unroll
    for (int i = 0; i < N; ++i)
      bad |= !(isfinite(x[i].x) && isfinite(x[i].y) && isfinite(x[i].z) &&
               isfinite(x[i].w));
    return bad;
  }

  __device__ __forceinline__ void store(float* __restrict__ dst,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      *reinterpret_cast<float4*>(dst + (tid + kThreads * i) * 4) = x[i];
  }
};

// Stages value rows [0, n) of ``src`` into dst[row * DP + d] one word at
// a time (any D); returns whether a staged value is not finite.
template <int DP>
__device__ __forceinline__ bool stage_rows_scalar(
    float* __restrict__ dst, const float* __restrict__ src, int n, int D,
    int tid) {
  bool bad = false;
  for (int u = tid; u < kChunk * DP; u += kThreads) {
    const int row = u / DP, d = u % DP;
    const float x = (row < n && d < D)
                        ? src[static_cast<size_t>(row) * D + d] : 0.f;
    bad |= !isfinite(x);
    dst[u] = x;
  }
  return bad;
}

// N fp32 words from shared memory at p (aligned to N words, N <= 4)
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x; r[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

// A warp's RM probabilities of one key (RM = 2, 4 or 8)
template <int RM>
__device__ __forceinline__ void load_p(float (&pr)[RM], const float* p) {
  if constexpr (RM == 8) {
    float a[4], b[4];
    lds<4>(a, p);
    lds<4>(b, p + 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pr[e] = a[e];
      pr[4 + e] = b[e];
    }
  } else {
    lds<RM>(pr, p);
  }
}

// The d of a lane's element e in the P.V tile: DPL consecutive elements
// (DPL <= 4), or float4s 128 apart (DPL = 8).
template <int DPL>
__device__ __forceinline__ int pv_d(int lane, int e) {
  return DPL <= 4 ? lane * DPL + e : (e / 4) * 128 + lane * 4 + e % 4;
}

template <int DPL>
__device__ __forceinline__ void load_v(float (&v)[DPL],
                                       const float* __restrict__ row,
                                       int lane) {
  if constexpr (DPL <= 4) {
    lds<DPL>(v, row + lane * DPL);
  } else {
#pragma unroll
    for (int c = 0; c < DPL / 4; ++c) {
      float x[4];
      lds<4>(x, row + c * 128 + lane * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * c + e] = x[e];
    }
  }
}

// One leaf of the score tree for a thread's (SR x 4) tile: the partial
// of lane ``l``, sum over d = l + 32 i of q[d] k[d] in increasing i from
// +0, every product and add rounded on its own.
template <int DPL, int SR>
__device__ __forceinline__ void leaf(float (&x)[SR][4],
                                     const float* __restrict__ qcol,
                                     const float* __restrict__ kcol, int tqp,
                                     int l) {
#pragma unroll
  for (int r = 0; r < SR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[r][c] = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = l + kWarp * i;
    float qv[SR], kv4[4];
    lds<SR>(qv, qcol + d * tqp);
    lds<4>(kv4, kcol + d * kChunkPad);
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[r][c] = __fadd_rn(x[r][c], __fmul_rn(qv[r], kv4[c]));
  }
}

template <int SR>
__device__ __forceinline__ void add_into(float (&x)[SR][4],
                                         const float (&y)[SR][4]) {
#pragma unroll
  for (int r = 0; r < SR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[r][c] = __fadd_rn(x[r][c], y[r][c]);
}

// Scores of rows ty*SR + r against the chunk's keys tc*4 + c, summed in
// the butterfly's tree: leaf index 4a + b is lane bitrev5(4a + b) =
// bitrev3(a) + {0, 16, 8, 24}[b]; the four leaves of one ``a`` form a
// subtree, and the eight subtrees add as a binary counter over a.
template <int DPL, int SR>
__device__ __forceinline__ void tile_scores(float (&res)[SR][4],
                                            const float* __restrict__ qcol,
                                            const float* __restrict__ kcol,
                                            int tqp) {
  float st2[SR][4], st3[SR][4], st4[SR][4];
#pragma unroll 1
  for (int a = 0; a < 8; ++a) {
    const int base = ((a & 1) << 2) | (a & 2) | ((a & 4) >> 2);
    float x[SR][4], y[SR][4];
    leaf<DPL, SR>(x, qcol, kcol, tqp, base);
    leaf<DPL, SR>(y, qcol, kcol, tqp, base + 16);
    add_into(x, y);
    float z[SR][4];
    leaf<DPL, SR>(z, qcol, kcol, tqp, base + 8);
    leaf<DPL, SR>(y, qcol, kcol, tqp, base + 24);
    add_into(z, y);
    add_into(x, z);  // the subtree of leaves base + {0, 16, 8, 24}
    if (!(a & 1)) {
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) st2[r][c] = x[r][c];
      continue;
    }
    add_into(x, st2);
    if (!(a & 2)) {
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) st3[r][c] = x[r][c];
      continue;
    }
    add_into(x, st3);
    if (!(a & 4)) {
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) st4[r][c] = x[r][c];
      continue;
    }
    add_into(x, st4);
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) res[r][c] = x[r][c];
  }
}

// DPL elements of d a lane (DP = 32 DPL), RM query rows a warp.  Two
// CTAs of 32 rows share an SM only under a cap of 128 registers (a few
// spills); 16-row tiles fit two CTAs without one.
template <int DPL, int RM>
__global__ void __launch_bounds__(kThreads, DPL <= 4 && RM == 4 ? 2 : 1)
flash_forward_kernel(const Params p) {
  constexpr int DP = kWarp * DPL;
  constexpr int TQ = kWarps * RM;
  constexpr int TQP = TQ + 4;
  constexpr int SR = TQ / 16;   // score rows a thread (a 16 x 16 grid)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(DP, TQ, p.group, p.block);
  float* qt = smem + L.qt;
  float* kv = smem + L.kv;
  float* sc = smem + L.s;
  float* pt = smem + L.pt;
  float* corr = smem + L.corr;
  float* safe = smem + L.safe;
  float* part = smem + L.part;

  const int T = p.T, D = p.D, block = p.block, G = p.group;
  const bool vec = D % 4 == 0;  // float4 loads of whole rows
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int bh = blockIdx.x % p.n_bh;
  const int row0 = (p.tiles - 1 - blockIdx.x / p.n_bh) * TQ;
  const size_t base = static_cast<size_t>(bh) * T * D;
  const float* kb = p.k + base;
  const float* vb = p.v + base;
  const int key_end = p.causal ? min(T, row0 + TQ) : T;

  stage_transposed<DP>(qt, TQP, p.q + base + static_cast<size_t>(row0) * D,
                       min(TQ, T - row0), TQ, D, true, p.scale, tid);

  // lane r < RM keeps the running max and sum of the warp's row r
  float m = -INFINITY, l = 0.f;
  float acc[RM][DPL];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  const int ty = tid / 16, tc = tid % 16;
  const int my_row = warp * RM + lane;  // for lanes < RM

  for (int g0 = 0; g0 < key_end; g0 += G) {
    const int n_g = min(G, key_end - g0);
    const int nb = (n_g + block - 1) / block;
    // 1. scores, chunk by chunk; masked pairs -inf
    for (int c0 = 0; c0 < n_g; c0 += kChunk) {
      __syncthreads();  // the previous reads of kv are done
      stage_transposed<DP>(kv, kChunkPad,
                           kb + static_cast<size_t>(g0 + c0) * D,
                           min(kChunk, n_g - c0), kChunk, D, false, 1.f,
                           tid);
      __syncthreads();
      float s[SR][4];
      tile_scores<DPL, SR>(s, qt + ty * SR, kv + tc * 4, TQP);
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        const int i = row0 + ty * SR + r;
        float w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = g0 + c0 + tc * 4 + c;
          const bool vis = i < T && j < T && (!p.causal || j <= i);
          w[c] = vis ? s[r][c] : -INFINITY;
        }
        if (c0 + tc * 4 < G)
          *reinterpret_cast<float4*>(sc + (ty * SR + r) * L.s_ld + c0 +
                                     tc * 4) = make_float4(w[0], w[1], w[2],
                                                           w[3]);
      }
    }
    __syncthreads();
    // the first V chunk's loads fly during the row pass
    ChunkRegs<DP> vreg;
    bool bad = false;
    if (vec) bad = vreg.load(vb + static_cast<size_t>(g0) * D,
                             min(kChunk, n_g), D, tid);
    // 2. the warp's rows: (a) each (row, block)'s max; (b) lane r's
    // rescale chain over the blocks; (c) the probabilities, -0 where a
    // key is left out; (d) each (row, block)'s probability sum in key
    // order; (e) lane r's fold of l over the blocks
    for (int pi = lane; pi < RM * nb; pi += kWarp) {
      const int row = warp * RM + pi % RM, b = pi / RM;
      const float* sr = sc + row * L.s_ld;
      float bm = -INFINITY;
      for (int j = b * block, j1 = min(j + block, n_g); j < j1; ++j)
        bm = fmaxf(bm, sr[j]);
      part[row * L.nbg + b] = bm;
    }
    __syncwarp();
    if (lane < RM) {
      for (int b = 0; b < nb; ++b) {
        const mxt::Rescale rs = mxt::rescale(m, part[my_row * L.nbg + b]);
        corr[my_row * L.nbg + b] = rs.corr;
        safe[my_row * L.nbg + b] = rs.safe;
        m = rs.m;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = warp * RM + r;
      const float* sr = sc + row * L.s_ld;
      const float* sf = safe + row * L.nbg;
      for (int j = lane; j < n_g; j += kWarp) {
        const float x = sr[j];
        pt[j * TQP + row] = isfinite(x) ? mxt::block_prob(x, sf[j / block])
                                        : -0.f;
      }
    }
    __syncwarp();
    for (int pi = lane; pi < RM * nb; pi += kWarp) {
      const int row = warp * RM + pi % RM, b = pi / RM;
      float psum = 0.f;  // a left-out key adds -0
      for (int j = b * block, j1 = min(j + block, n_g); j < j1; ++j)
        psum = __fadd_rn(psum, pt[j * TQP + row]);
      part[row * L.nbg + b] = psum;
    }
    __syncwarp();
    if (lane < RM)
      for (int b = 0; b < nb; ++b)
        l = mxt::fold(l, corr[my_row * L.nbg + b], part[my_row * L.nbg + b]);
    // 3. P.V in key order, folded at each block's end
    if (vec)
      vreg.store(kv, tid);
    else
      bad = stage_rows_scalar<DP>(kv, vb + static_cast<size_t>(g0) * D,
                                  min(kChunk, n_g), D, tid);
    bool finite = !__syncthreads_or(bad);
    float pv[RM][DPL];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int e = 0; e < DPL; ++e) pv[r][e] = 0.f;
    int b = 0, left = block;
    for (int c0 = 0; c0 < n_g; c0 += kChunk) {
      if (c0) {
        __syncthreads();
        bad = vec ? vreg.load(vb + static_cast<size_t>(g0 + c0) * D,
                              min(kChunk, n_g - c0), D, tid)
                  : stage_rows_scalar<DP>(
                        kv, vb + static_cast<size_t>(g0 + c0) * D,
                        min(kChunk, n_g - c0), D, tid);
        if (vec) vreg.store(kv, tid);
        finite = !__syncthreads_or(bad);
      }
      const int nk = min(kChunk, n_g - c0);
      for (int jj = 0; jj < nk;) {
        const int seg = min(left, nk - jj);
        const float* pj = pt + (c0 + jj) * TQP + warp * RM;
        const float* vj = kv + jj * DP;
        if (finite) {
          for (int t = 0; t < seg; ++t) {
            float pr[RM], vr[DPL];
            load_p<RM>(pr, pj + t * TQP);
            load_v<DPL>(vr, vj + t * DP, lane);
#pragma unroll
            for (int r = 0; r < RM; ++r)
#pragma unroll
              for (int e = 0; e < DPL; ++e)
                pv[r][e] = __fadd_rn(pv[r][e], __fmul_rn(pr[r], vr[e]));
          }
        } else {  // a left-out key's value stays unread
          for (int t = 0; t < seg; ++t) {
            float pr[RM], vr[DPL];
            load_p<RM>(pr, pj + t * TQP);
            load_v<DPL>(vr, vj + t * DP, lane);
#pragma unroll
            for (int r = 0; r < RM; ++r)
              if (!signbit(pr[r]))
#pragma unroll
                for (int e = 0; e < DPL; ++e)
                  pv[r][e] = __fadd_rn(pv[r][e], __fmul_rn(pr[r], vr[e]));
          }
        }
        jj += seg;
        left -= seg;
        if (left == 0 || c0 + jj == n_g) {
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float cr = corr[(warp * RM + r) * L.nbg + b];
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              acc[r][e] = mxt::fold(acc[r][e], cr, pv[r][e]);
              pv[r][e] = 0.f;
            }
          }
          ++b;
          left = block;
        }
      }
    }
  }
  // out = acc / max(l, 1e-20); lse = where(isfinite(m), m, 0) +
  // log(max(l, 1e-38)), the guards of _flash_forward (:245)
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = row0 + warp * RM + r;
    const float lr = __shfl_sync(mxt::kFull, l, r);
    const float mr = __shfl_sync(mxt::kFull, m, r);
    if (i >= T) continue;  // uniform over the warp
    float* orow = p.out + base + static_cast<size_t>(i) * D;
    const float den = fmaxf(lr, 1e-20f);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = pv_d<DPL>(lane, e);
      if (d < D) orow[d] = __fdiv_rn(acc[r][e], den);
    }
    if (p.lse != nullptr && lane == 0)
      p.lse[static_cast<size_t>(bh) * T + i] =
          __fadd_rn(isfinite(mr) ? mr : 0.f, logf(fmaxf(lr, 1e-38f)));
  }
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
  if (D < 1 || D > mxt::kMaxHeadDim || block < 1 || block > mxt::kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  // a group is as many whole blocks as fit in kGroup keys
  const int group = block * (kGroup / block);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(out),
           static_cast<float*>(lse), n_bh, T, D, causal, block, group, 0,
           scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_rows<1>(p, st);
  if (D <= 64) return launch_rows<2>(p, st);
  if (D <= 128) return launch_rows<4>(p, st);
  return launch_rows<8>(p, st);
}
