// The fp32 flash-attention tile shared by K1 (flash_attention.cu, over
// contiguous keys) and K2/K2q's prefill (paged_attention.cu, over the
// pages of a slot, fp32 or one-byte codes): one function, so the two
// kernels run a query row through the same operations in the same order
// and give it the same bits (serving holds a prefill row of K2 equal to
// the row of K1 with block = page).  flash_attention.cu's header comment
// sets out the order and the design; testing/flash_order.py emulates it.
// What differs between the two kernels is only where the rows come from:
// a tile source gives the query rows, each row's visible keys lower(r)
// <= j < horizon(r) (causal or full for K1, serving's per-row lengths
// for K2; a sliding window raises the lower bound, and K2 over a ring
// labels its table rows with absolute positions from k_pos0 on) and row
// sources of keys and values, which K2q dequantizes as it stages them
// (code * scale, codes.cuh).
//
// A sliding window skips the blocks of keys wholly left of every row of
// the tile, the way causal skips those past its last row.  That is exact:
// keys are visited in increasing order, so a block left of a row's window
// comes before any key the row sees, while its running max is still -inf,
// and a fully masked block at m = -inf is the identity (rescale gives
// corr 0, the probabilities are -0 and their sum +0, so l = 0 * 0 + 0 and
// acc = 0 * 0 + (+0) stay +0).  key_begin() is a multiple of the block,
// so the blocks keep their boundaries.  Groups then start at key_begin()
// plus multiples of G.
#pragma once

#include <cstddef>

#include "online_softmax.cuh"

namespace mxt_tile {

using mxt::kWarp;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kChunk = 64;              // keys staged at once
constexpr int kGroup = 128;             // keys scored before the sums
constexpr int kChunkPad = kChunk + 4;   // row stride of K^T

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// Rows of a row-major matrix of row stride D from ``p`` on, as a row
// source: get4(row, d4), elements 4 d4 .. 4 d4 + 3 (D % 4 == 0); get(row,
// d), one element.
struct DenseRows {
  const float* p;
  int D;
  __device__ __forceinline__ float4 get4(int row, int d4) const {
    return *reinterpret_cast<const float4*>(p + static_cast<size_t>(row) * D
                                            + 4 * d4);
  }
  __device__ __forceinline__ float get(int row, int d) const {
    return p[static_cast<size_t>(row) * D + d];
  }
};

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

// Stages rows [0, n) of the row source ``src`` transposed into
// dst[d * ld + row] for d < DP and row < rows (a multiple of 8), times
// ``mul`` when ``scaled``; zero past D and from row n on.  Eight rows a
// warp-load, four float4 of each, when D % 4 == 0.
template <int DP, class Rows>
__device__ __forceinline__ void stage_transposed(
    float* __restrict__ dst, int ld, const Rows& src, int n, int rows,
    int D, bool scaled, float mul, int tid) {
  if (D % 4 == 0) {
    constexpr int DP4 = DP / 4;
    for (int u = tid; u < rows * DP4; u += kThreads) {
      const int row = u % 8 + 8 * (u / (8 * DP4));
      const int d4 = (u / 8) % DP4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n && 4 * d4 < D) x = src.get4(row, d4);
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
      float x = (row < n && d < D) ? src.get(row, d) : 0.f;
      dst[d * ld + row] = scaled ? __fmul_rn(x, mul) : x;
    }
  }
}

// A chunk of value rows held in registers on its way to shared memory
// (dst[row * DP + d]): rows [0, n) of the row source ``src`` (D % 4 ==
// 0), float4 unit u = tid + kThreads * i; zero past D and from row n on.
template <int DP>
struct ChunkRegs {
  static constexpr int DP4 = DP / 4;
  static constexpr int N = kChunk * DP4 / kThreads;
  float4 x[N];

  // issues the loads; returns whether a loaded value is not finite
  template <class Rows>
  __device__ __forceinline__ bool load(const Rows& src, int n, int D,
                                       int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int row = (tid + kThreads * i) / DP4;
      const int d4 = (tid + kThreads * i) % DP4;
      x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n && 4 * d4 < D) x[i] = src.get4(row, d4);
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

// Stages value rows [0, n) of the row source ``src`` into dst[row * DP +
// d] one word at a time (any D); returns whether a staged value is not
// finite.
template <int DP, class Rows>
__device__ __forceinline__ bool stage_rows_scalar(float* __restrict__ dst,
                                                  const Rows& src, int n,
                                                  int D, int tid) {
  bool bad = false;
  for (int u = tid; u < kChunk * DP; u += kThreads) {
    const int row = u / DP, d = u % DP;
    const float x = (row < n && d < D) ? src.get(row, d) : 0.f;
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

// A tile of TQ = 8 RM query rows, DPL elements of d a lane (DP = 32
// DPL), RM rows a warp, over the keys and values of ``src`` in blocks of
// ``block`` keys, G keys (whole blocks) scored before they are summed.
// ``src`` (a tile source: DenseTile in flash_attention.cu, PagedTile in
// paged_attention.cu) gives the tile's query rows (rows(), q: row-major,
// row stride D), each row's visible keys (lower(r) <= j < horizon(r); a
// horizon of 0 past rows()), the keys any row sees (from key_begin(), a
// multiple of ``block``, to key_end()), row sources of keys
// and values from key j0 on (keys(j0), values(j0): get4 / get), and where
// a row's output goes (out(r); lse(r), null where none is kept).  A
// source with kGroupState gets begin_group(g0, n, tid) from every thread
// before a group's keys are staged (between two barriers), to note in
// shared memory where the group's rows lie.
template <int DPL, int RM, class Src>
__device__ __forceinline__ void tile_forward(const Src& src, int D,
                                             int block, int G, float scale) {
  constexpr int DP = kWarp * DPL;
  constexpr int TQ = kWarps * RM;
  constexpr int TQP = TQ + 4;
  constexpr int SR = TQ / 16;   // score rows a thread (a 16 x 16 grid)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(DP, TQ, G, block);
  float* qt = smem + L.qt;
  float* kv = smem + L.kv;
  float* sc = smem + L.s;
  float* pt = smem + L.pt;
  float* corr = smem + L.corr;
  float* safe = smem + L.safe;
  float* part = smem + L.part;

  const bool vec = D % 4 == 0;  // float4 loads of whole rows
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int key_end = src.key_end();

  stage_transposed<DP>(qt, TQP, DenseRows{src.q, D}, src.rows(), TQ, D,
                       true, scale, tid);

  // lane r < RM keeps the running max and sum of the warp's row r
  float m = -INFINITY, l = 0.f;
  float acc[RM][DPL];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  const int ty = tid / 16, tc = tid % 16;
  const int my_row = warp * RM + lane;  // for lanes < RM
  int hz[SR], lo[SR];  // the visible keys of this thread's score rows
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    hz[r] = src.horizon(ty * SR + r);
    lo[r] = src.lower(ty * SR + r);
  }

  for (int g0 = src.key_begin(); g0 < key_end; g0 += G) {
    const int n_g = min(G, key_end - g0);
    const int nb = (n_g + block - 1) / block;
    if constexpr (Src::kGroupState) {  // where the group's rows lie
      __syncthreads();  // the last group's reads of that state are done
      src.begin_group(g0, n_g, tid);  // read after the next barrier
    }
    // 1. scores, chunk by chunk; masked pairs -inf
    for (int c0 = 0; c0 < n_g; c0 += kChunk) {
      __syncthreads();  // the previous reads of kv are done
      stage_transposed<DP>(kv, kChunkPad, src.keys(g0 + c0),
                           min(kChunk, n_g - c0), kChunk, D, false, 1.f,
                           tid);
      __syncthreads();
      float s[SR][4];
      tile_scores<DPL, SR>(s, qt + ty * SR, kv + tc * 4, TQP);
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        float w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = g0 + c0 + tc * 4 + c;
          w[c] = (j < hz[r] && j >= lo[r]) ? s[r][c] : -INFINITY;
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
    if (vec) bad = vreg.load(src.values(g0),
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
      bad = stage_rows_scalar<DP>(kv, src.values(g0),
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
        bad = vec ? vreg.load(src.values(g0 + c0),
                              min(kChunk, n_g - c0), D, tid)
                  : stage_rows_scalar<DP>(
                        kv, src.values(g0 + c0),
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
    const int row = warp * RM + r;
    const float lr = __shfl_sync(mxt::kFull, l, r);
    const float mr = __shfl_sync(mxt::kFull, m, r);
    if (row >= src.rows()) continue;  // uniform over the warp
    float* orow = src.out(row);
    const float den = fmaxf(lr, 1e-20f);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = pv_d<DPL>(lane, e);
      if (d < D) orow[d] = __fdiv_rn(acc[r][e], den);
    }
    float* lse = src.lse(row);
    if (lse != nullptr && lane == 0)
      *lse = __fadd_rn(isfinite(mr) ? mr : 0.f, logf(fmaxf(lr, 1e-38f)));
  }
}

}  // namespace mxt_tile
