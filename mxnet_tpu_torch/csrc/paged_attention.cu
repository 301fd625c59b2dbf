// K2 and K2q: attention of S slots' queries over their paged KV cache;
// K2 over fp32 pages, K2q over one-byte pages (int8 or fp8 e4m3 codes,
// one fp32 scale a (page, row) in scale pools beside the code pools).
//
// Replaces: mxnet_tpu/ops/attention.py::decode_attention (:368-490)
// together with the page gathers that feed it in serve/model.py
// (k_pool[i][tables], :586-589 for prefill and :719-722 for decode), and
// for windowed layers of hybrid stacks its window half with position
// labels together with the ring gather (serve/model.py::_ring_gather,
// :378-412).
// One entry serves decode (Q = 1 query per slot, one horizon per slot),
// prefill (S = 1, Q = bucket rows, per-row horizons offset + j + 1) and
// the speculative verify (S slots of Q = K + 1 rows, per-row horizons),
// with two kernels: at decode one row a CTA (and at the verify a tile of
// up to 8 rows), at prefill K1's tile.
//
// Bound on an H100: bytes at decode, operations at prefill.  Each
// visible key and value row is read once per (slot, head) and is used by
// only Q queries, so at decode the work is ~0.5 flop per byte, far below
// the card's fp32 balance point, and the least time is the visible K/V
// bytes over 3.35 TB/s; a 256-row prefill bucket uses each row ~140
// times, and its 4 D flops a (row, visible key) over 67 TFLOP/s bound it.
//
// The bits are online_softmax.cuh's, the same as K1's (serving's oracle
// is K1 with block = page): per key the dot in lane_dot's and warp_sum's
// order; per page the block max in key order, rescale, block_prob, and
// the probability and value sums in key order; then the fold of the
// pages in order.  Only the fold is serial: a score depends on its key
// alone, the running max after page b is the prefix max of the block
// maxima, and page b's sums depend only on its keys and that max.
//
// Decode (Q = 1) spreads a row's pages over the warps of a CTA without
// changing one operation (the verify runs the same kernel on a tile of
// up to 8 rows, each loaded slice serving every row of the tile):
//
//   1. scores: a warp per page loads the page's key rows into registers
//      (16 keys at once, every load in flight together) and forms each
//      visible key's score by the warp dot and butterfly; the row's lane
//      then takes the page's block max in key order;
//   2. sums: a warp per page scans the block maxima into the prefix max
//      (rescale), loads the page's value rows, and forms the probability
//      sum and the value sum in key order;
//   3. fold: the threads, one per element, fold the pages in page order
//      into (l, acc) from m = -inf, l = 0, acc = 0.
//
// Each key and value row is read by one CTA and used once, so staging
// pages through a shared-memory ring would add a trip through shared
// memory per byte and save no read from memory.  A warp holds a 16-key
// slice in registers instead, its loads issued together (16 warps x 8 KB
// in flight a CTA at D = 128).  Pages are taken in chunks that fit
// shared memory; the running max carries from chunk to chunk.  A CTA
// owns one (slot, head): S x H CTAs of 16 warps.  The kernel reads each
// page through the table and never materialises the gathered context
// the JAX package builds; keys past the horizon are never loaded.  The
// pages past the horizon fold with the correction rescale(m, -inf)
// gives, 1 for a finite m and 0 for -inf, and add 0; x * c + 0 is the
// same after one such fold as after many, so the kernel folds them as
// one.  A slot with horizon 0 gives 0.
//
// Prefill (Q > 8) runs K1's tile (flash_tile.cuh) over the slot's pages:
// a CTA of 8 warps takes 16 or 32 query rows of one (slot, head), as many
// as keep two CTAs an SM busy (K1's rule), stages the keys any row of
// the tile sees 64 at a time in shared memory, read through the table
// (K transposed, V by rows; each group of keys' rows looked up once),
// forms each score in one thread in the butterfly's own tree, and runs
// the row pass and P.V as K1 does.  So a prefill row is the row K1
// computes over the same context with block = page, by construction; the
// emulation in testing/paged_order.py (prefill_tile) shows that its rows
// equal the decode kernel's order at any tile height.  Every staged key
// serves the whole tile from shared memory, and no score takes a
// shuffle.
//
// Windowed layers (the _ring entries) read a slot's per-slot ring of
// pages through a rotated table: table row j is the ring page holding
// absolute page pb_max - RP + 1 + j, and table position j * page + o is
// absolute position k_pos0[s] + j * page + o (k_pos0 a multiple of the
// page, negative before the ring first wraps).  A row with horizon n
// (keys at positions < n) sees positions p with max(n - window, 0) <= p
// < n: in table positions lo <= j < hz.  The gathered context the JAX
// package builds is never materialised.  Pages left of every row's lo
// come first, while the running max is -inf, where a page's fold is the
// identity (corr 0, +0 added to +0), so the kernels start at the first
// page any row sees (decode) or the first group (prefill, K1's tile).
// The table's pages keep absolute page boundaries, so a ring row visits
// the blocks K1 visits with a window over the whole context, with the
// same masks, and gives its bits.  Without a window and with k_pos0 0
// (the plain entries) the kernels run exactly their old operations.
//
// K2q replaces the same function over quantized pages
// (decode_attention's k_scale/v_scale, :368-430, with the scale gathers
// of serve/model.py).  It dequantizes each key and value element with
// its row's scale (code * scale, codes.cuh) and runs K2's operations
// unchanged, so K2q equals K1 over the fake-quantized context
// (quantize.kv_dequantize of the codes) bit for bit, as the
// per-precision oracle needs.  At decode a lane reads the byte of each
// element d = lane + 32 i it sums (a warp's read of a row slice is 32
// consecutive bytes), and a slice's 16 scales are read once, one a lane,
// and shuffled to the lanes that dequantize with them.  At prefill each
// code is dequantized once, as it is staged: a thread reads four codes
// of a row as one word.  The conversion of a code to fp32 is exact
// integer and fp32 arithmetic at full rate (codes.cuh).  Its bound is the
// visible codes and scales over 3.35 TB/s, a quarter of K2's bytes.
#include "codes.cuh"
#include "error.cuh"
#include "flash_tile.cuh"
#include "online_softmax.cuh"
#include "per_device.cuh"

namespace {

using mxt::kFull;
using mxt::kWarp;

constexpr int kKeys = 16;                  // keys a warp holds at once
constexpr int kVerifyRows = 8;             // query rows of a verify CTA
constexpr int kSmemBudget = 96 * 1024;     // bytes, sets the chunk length
constexpr int kSmemMax = 227 * 1024;

struct Params {
  const float* q;
  const void* k_pool;   // fp32, or one-byte codes (K2q)
  const void* v_pool;
  const float* k_scale;  // K2q: (pages + 1, page) fp32, a scale a row
  const float* v_scale;
  const int* tables;
  const int* lengths;
  const int* k_pos0;  // (S,) position of table row 0, or null: 0
  float* out;
  int H, Q, D, page, max_pages, per_row, tiles, chunk, window;
  float scale;
};

// Row length n's visible table positions [lo, hz) for a slot whose table
// starts at position k0: positions max(n - window, 0) <= p < n (window 0:
// 0 <= p < n), at most the table's capacity.
__device__ __forceinline__ int2 visible(int n, int k0, int window, int cap) {
  const int lo = window > 0 ? max(n - window, 0) : 0;
  return make_int2(min(max(lo - k0, 0), cap), min(max(n - k0, 0), cap));
}

// Offsets (in 4-byte words) of a CTA's shared arrays.  Per tile row: the
// scaled query and the accumulator (D each), l, the running max after
// the previous chunk (two, alternating), the horizon and the lower bound;
// per row and page of the chunk: the scores, block max, correction,
// probability sum and value sum (D).
struct Layout {
  int qs, acc, l, mrun, hz, lo, sc, bmax, corr, psum, pv, words;
  __host__ __device__ Layout(int rows, int D, int page, int chunk) {
    qs = 0;
    acc = qs + rows * D;
    l = acc + rows * D;
    mrun = l + rows;
    hz = mrun + 2 * rows;
    lo = hz + rows;
    sc = lo + rows;
    bmax = sc + rows * chunk * page;
    corr = bmax + rows * chunk;
    psum = corr + rows * chunk;
    pv = psum + rows * chunk;
    words = pv + rows * chunk * D;
  }
};

// Loads one 16-key slice of a page's rows: key j (j < n) from
// base + j * stride, lane elements d = lane + 32 i (0 past D or n).  K2q
// loads the codes (a lane reads the byte of each element d it sums, so
// the score and value sums keep K2's order; a warp's read of a row slice
// is 32 consecutive bytes) and one scale a lane, lane j key j's, then
// dequantizes each element with its key's scale (code * scale, shuffled
// from lane j): the registers of K2's slice and one more.
template <int kCode, int DPL>
__device__ __forceinline__ void load_keys(
    float (&kr)[kKeys][DPL], const typename mxt::Codes<kCode>::T* base,
    const float* scales, size_t stride, int n, int D, int lane) {
  if constexpr (kCode == 0) {
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + kWarp * i;
        kr[j][i] = (j < n && d < D) ? base[j * stride + d] : 0.f;
      }
  } else {
    const float mine = lane < n ? scales[lane] : 0.f;
    unsigned codes[kKeys][DPL];
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + kWarp * i;
        codes[j][i] = (j < n && d < D) ? base[j * stride + d] : 0;
      }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float s = __shfl_sync(kFull, mine, j);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        kr[j][i] = (j < n && lane + kWarp * i < D)
                       ? mxt::Codes<kCode>::of(codes[j][i], s) : 0.f;
    }
  }
}

// QT query rows a CTA, DPL elements of a row a lane, NW warps; pages of
// element type kCode (codes.cuh).
template <int QT, int DPL, int NW, int kCode>
__device__ __forceinline__ void paged_body(const Params& p) {
  using T = typename mxt::Codes<kCode>::T;
  constexpr int kThreads = NW * kWarp;
  extern __shared__ float smem[];
  const Layout L(QT, p.D, p.page, p.chunk);
  float* qs = smem + L.qs;
  float* acc = smem + L.acc;
  float* lsum = smem + L.l;
  float* mrun = smem + L.mrun;
  int* hz = reinterpret_cast<int*>(smem + L.hz);
  int* lo = reinterpret_cast<int*>(smem + L.lo);
  float* sc = smem + L.sc;
  float* bmax = smem + L.bmax;
  float* corr = smem + L.corr;
  float* psum = smem + L.psum;
  float* pv = smem + L.pv;

  const int D = p.D, page = p.page, chunk = p.chunk;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int sh = blockIdx.x / p.tiles;  // s * H + h
  const int h = sh % p.H;
  const int s = sh / p.H;
  const int r0 = (blockIdx.x % p.tiles) * QT;
  const int rows = min(QT, p.Q - r0);
  const int cap = p.max_pages * page;

  const int k0 = p.k_pos0 != nullptr ? p.k_pos0[s] : 0;
  for (int r = tid; r < rows; r += kThreads) {
    const int n = p.per_row ? p.lengths[s * p.Q + r0 + r] : p.lengths[s];
    const int2 vis = visible(n, k0, p.window, cap);
    lo[r] = vis.x;
    hz[r] = vis.y;
    lsum[r] = 0.f;
    mrun[r] = -INFINITY;
  }
  const float* qrow = p.q + (static_cast<size_t>(sh) * p.Q + r0) * D;
  for (int e = tid; e < rows * D; e += kThreads) {
    qs[e] = __fmul_rn(qrow[e], p.scale);  // K1's scaled query, rounded once
    acc[e] = 0.f;
  }
  __syncthreads();
  int hmax = 0, lmin = cap;
  for (int r = 0; r < rows; ++r) {
    hmax = max(hmax, hz[r]);
    lmin = min(lmin, lo[r]);
  }
  const int npages = (hmax + page - 1) / page;  // pages some row sees
  const int* table = p.tables + static_cast<size_t>(s) * p.max_pages;
  const size_t key_stride = static_cast<size_t>(p.H) * D;
  const size_t page_words = static_cast<size_t>(page) * key_stride;

  int cur = 0;  // which half of mrun holds the max before this chunk
  for (int c0 = lmin / page; c0 < npages; c0 += chunk) {
    const int nb = min(chunk, npages - c0);
    // 1. scores, then each row's block max in key order
    for (int bl = warp; bl < nb; bl += NW) {
      const int start = (c0 + bl) * page;
      const int pg = table[c0 + bl];
      const T* kp = static_cast<const T*>(p.k_pool) + pg * page_words + h * D;
      const float* ks = kCode ? p.k_scale + static_cast<size_t>(pg) * page
                              : nullptr;
      for (int kc = 0; kc < page; kc += kKeys) {
        float kr[kKeys][DPL];
        load_keys<kCode>(kr, kp + kc * key_stride, kCode ? ks + kc : nullptr,
                         key_stride,
                         min(kKeys, min(page, hmax - start) - kc), D, lane);
        for (int r = 0; r < rows; ++r) {
          // keys of the slice r sees: those below its horizon, none
          // where the slice lies left of its lower bound
          const int vis =
              start + kc + kKeys > lo[r] ? hz[r] - start - kc : 0;
          float mine = -INFINITY;
          if (vis > 0) {
            float qv[DPL];
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
              const int d = lane + kWarp * i;
              qv[i] = d < D ? qs[r * D + d] : 0.f;
            }
#pragma unroll
            for (int j = 0; j < kKeys; ++j) {
              const float sj = mxt::warp_sum(mxt::lane_dot(
                  qv, [&](int i) { return kr[j][i]; }, D, lane));
              if (lane == j && j < vis && start + kc + j >= lo[r])
                mine = sj;
            }
          }
          if (lane < kKeys && kc + lane < page)
            sc[(r * chunk + bl) * page + kc + lane] = mine;
        }
      }
      __syncwarp();
      for (int r = lane; r < rows; r += kWarp) {
        const float* sr = sc + (r * chunk + bl) * page;
        float bm = -INFINITY;  // masked keys are -inf: fmaxf keeps bm
        for (int j = 0; j < page; ++j) bm = fmaxf(bm, sr[j]);
        bmax[r * chunk + bl] = bm;
      }
    }
    __syncthreads();
    // 2. the prefix max, then probability and value sums in key order
    for (int bl = warp; bl < nb; bl += NW) {
      const int start = (c0 + bl) * page;
      float safe = 0.f;  // lane r: row r's shift on this page
      for (int r = lane; r < rows; r += kWarp) {
        float m = mrun[cur * QT + r];
        for (int j = 0; j < bl; ++j) m = fmaxf(m, bmax[r * chunk + j]);
        const mxt::Rescale rs = mxt::rescale(m, bmax[r * chunk + bl]);
        corr[r * chunk + bl] = rs.corr;
        safe = rs.safe;
        if (bl == nb - 1) mrun[(cur ^ 1) * QT + r] = rs.m;
      }
      const int pg = table[c0 + bl];
      const T* vp = static_cast<const T*>(p.v_pool) + pg * page_words + h * D;
      const float* vs = kCode ? p.v_scale + static_cast<size_t>(pg) * page
                              : nullptr;
      for (int kc = 0; kc < page; kc += kKeys) {
        float vr[kKeys][DPL];
        load_keys<kCode>(vr, vp + kc * key_stride, kCode ? vs + kc : nullptr,
                         key_stride,
                         min(kKeys, min(page, hmax - start) - kc), D, lane);
        for (int r = 0; r < rows; ++r) {
          const int at = r * chunk + bl;
          const float shift = __shfl_sync(kFull, safe, r);
          const float sl = (lane < kKeys && kc + lane < page)
                               ? sc[at * page + kc + lane] : -INFINITY;
          const float pr = mxt::block_prob(sl, shift);
          const unsigned vis = __ballot_sync(kFull, isfinite(sl));
          float ps = kc ? psum[at] : 0.f;
          float acc_v[DPL];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + kWarp * i;
            acc_v[i] = (kc && d < D) ? pv[at * D + d] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < kKeys; ++j) {
            if (!(vis >> j & 1u)) continue;  // uniform over the warp
            const float pt = __shfl_sync(kFull, pr, j);
            ps = __fadd_rn(ps, pt);
#pragma unroll
            for (int i = 0; i < DPL; ++i)
              if (lane + kWarp * i < D)
                acc_v[i] = __fadd_rn(acc_v[i], __fmul_rn(pt, vr[j][i]));
          }
          if (lane == 0) psum[at] = ps;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + kWarp * i;
            if (d < D) pv[at * D + d] = acc_v[i];
          }
        }
        __syncwarp();  // lane 0's psum, read by every lane at the next kc
      }
    }
    __syncthreads();
    // 3. the fold, in page order (the next chunk's scores may overlap it:
    // they write only sc and bmax)
    for (int e = tid; e < rows * D; e += kThreads) {
      const int r = e / D, d = e % D;
      float a = acc[e];
      for (int bl = 0; bl < nb; ++bl)
        a = mxt::fold(a, corr[r * chunk + bl], pv[(r * chunk + bl) * D + d]);
      acc[e] = a;
    }
    for (int r = tid; r < rows; r += kThreads) {
      float x = lsum[r];
      for (int bl = 0; bl < nb; ++bl)
        x = mxt::fold(x, corr[r * chunk + bl], psum[r * chunk + bl]);
      lsum[r] = x;
    }
    cur ^= 1;
  }
  __syncthreads();
  // the pages past every horizon (one fold stands for all), then
  // K1's division
  float* orow = p.out + (static_cast<size_t>(sh) * p.Q + r0) * D;
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D;
    float a = acc[e], x = lsum[r];
    if (npages < p.max_pages) {
      const float c = mxt::rescale(mrun[cur * QT + r], -INFINITY).corr;
      a = mxt::fold(a, c, 0.f);
      x = mxt::fold(x, c, 0.f);
    }
    orow[e] = __fdiv_rn(a, fmaxf(x, 1e-20f));
  }
}

template <int QT, int DPL, int NW>
__global__ void __launch_bounds__(NW * kWarp)
paged_attention_kernel(const Params p) {
  paged_body<QT, DPL, NW, 0>(p);
}

template <int QT, int DPL, int NW, int kCode>
__global__ void __launch_bounds__(NW * kWarp)
paged_attention_q_kernel(const Params p) {
  paged_body<QT, DPL, NW, kCode>(p);
}

template <int QT, int DPL, int NW, int kCode>
void (*paged_kernel())(Params) {
  if constexpr (kCode == 0) return paged_attention_kernel<QT, DPL, NW>;
  else return paged_attention_q_kernel<QT, DPL, NW, kCode>;
}

// Decode runs 16 warps, so a slot's pages take fewer rounds of loads;
// a verify tile, and rows past D = 128, 8 warps (the registers of a
// 16-key slice).
template <int kCode, int QT, int DPL,
          int NW = (QT == 1 && DPL <= 4) ? 16 : 8>
int launch(Params p, int S, cudaStream_t stream) {
  const auto kernel = paged_kernel<QT, DPL, NW, kCode>();
  p.tiles = (p.Q + QT - 1) / QT;
  const int fixed = Layout(QT, p.D, p.page, 0).words;
  const int per_page = Layout(QT, p.D, p.page, 1).words - fixed;
  p.chunk = max(1, min(p.max_pages, (kSmemBudget / 4 - fixed) / per_page));
  const size_t bytes = 4u * Layout(QT, p.D, p.page, p.chunk).words;
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> opted[mxt::kMaxDevices];
  if (bytes > 48 * 1024) {
    const cudaError_t e = mxt::opt_in_smem(kernel, kSmemMax, opted);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<S * p.H * p.tiles, NW * kWarp, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kCode, int QT>
int launch_rows(const Params& p, int S, cudaStream_t stream) {
  if (p.D <= 32) return launch<kCode, QT, 1>(p, S, stream);
  if (p.D <= 64) return launch<kCode, QT, 2>(p, S, stream);
  if (p.D <= 128) return launch<kCode, QT, 4>(p, S, stream);
  return launch<kCode, QT, 8>(p, S, stream);
}

// Prefill rows: K1's tile over a slot's pages.  Keys and values of the
// slot's head h, from key j0 of a group on: the group's rows (at = page *
// table entry + offset in the page) and, for K2q, their scales are noted
// in shared memory once a group, so a staged element costs one shared
// read and no division by the page.
template <int kCode>
struct PagedRows {
  const typename mxt::Codes<kCode>::T* pool;  // the head's first element
  const int* at;        // the rows, from key j0 on
  const float* scales;  // K2q: their scales
  size_t stride;        // H D: elements between rows of a page

  __device__ __forceinline__ float4 get4(int row, int d4) const {
    float s = 0.f;
    if constexpr (kCode != 0) s = scales[row];
    return mxt::Codes<kCode>::get4(pool + at[row] * stride, d4, s);
  }
  __device__ __forceinline__ float get(int row, int d) const {
    float s = 0.f;
    if constexpr (kCode != 0) s = scales[row];
    return mxt::Codes<kCode>::get(pool + at[row] * stride, d, s);
  }
};

// The tile source of query rows row0 .. row0 + n - 1 of slot s's head h:
// row r sees the keys below its length (per_row: its own, else the
// slot's) and, with a window, at or above its length - window, in table
// positions from k0 on, at most the table's capacity.
template <int kCode>
struct PagedTile {
  using T = typename mxt::Codes<kCode>::T;
  static constexpr bool kGroupState = true;
  const float* q;
  float* o;
  const T* k_pool;  // the head's first element
  const T* v_pool;
  const float* k_scale;  // K2q: (pages + 1, page)
  const float* v_scale;
  const int* table;
  const int* lens;  // the tile's first row's length, or the slot's
  int* at;          // shared: the group's rows
  float* ks;        // shared: K2q's key and value scales of the group
  float* vs;
  size_t stride;
  int per_row, cap, n, D, page, group, hmax, lmin, k0, window;

  __device__ int2 vis(int r) const {
    return visible(lens[per_row ? r : 0], k0, window, cap);
  }
  __device__ int rows() const { return n; }
  __device__ int horizon(int r) const { return r < n ? vis(r).y : 0; }
  __device__ int lower(int r) const { return r < n ? vis(r).x : 0; }
  __device__ int key_begin() const { return lmin / page * page; }
  __device__ int key_end() const { return hmax; }
  __device__ void begin_group(int g0, int n_g, int tid) const {
    for (int j = tid; j < n_g; j += mxt_tile::kThreads) {
      const int key = g0 + j;
      const int a = table[key / page] * page + key % page;
      at[j] = a;
      if constexpr (kCode != 0) {
        ks[j] = k_scale[a];
        vs[j] = v_scale[a];
      }
    }
  }
  // key j0 of the group that begins at key_begin() + a multiple of group
  __device__ PagedRows<kCode> keys(int j0) const {
    const int j = (j0 - key_begin()) % group;
    return {k_pool, at + j, ks + j, stride};
  }
  __device__ PagedRows<kCode> values(int j0) const {
    const int j = (j0 - key_begin()) % group;
    return {v_pool, at + j, vs + j, stride};
  }
  __device__ float* out(int r) const { return o + static_cast<size_t>(r) * D; }
  __device__ float* lse(int) const { return nullptr; }
};

// Shared words the prefill kernel adds to K1's layout: a group's rows
// and, for K2q, its key and value scales.
__host__ __device__ inline int group_words(int group, int code) {
  return group * (code ? 3 : 1);
}

// A tile of 8 RM rows of one (slot, head) a CTA, the heaviest tiles
// first, as K1 launches them; p.chunk holds the group (whole pages).
template <int kCode, int DPL, int RM>
__global__ void __launch_bounds__(mxt_tile::kThreads,
                                  DPL <= 4 && RM == 4 ? 2 : 1)
paged_prefill_kernel(const Params p) {
  using T = typename mxt::Codes<kCode>::T;
  constexpr int TQ = mxt_tile::kWarps * RM;
  extern __shared__ float4 smem4[];
  const int words =
      mxt_tile::Layout(kWarp * DPL, TQ, p.chunk, p.page).words;
  int* at = reinterpret_cast<int*>(smem4) + words;
  float* ks = reinterpret_cast<float*>(at + p.chunk);
  const int n_sh = gridDim.x / p.tiles;
  const int sh = blockIdx.x % n_sh;  // s * H + h
  const int h = sh % p.H, s = sh / p.H;
  const int row0 = (p.tiles - 1 - blockIdx.x / n_sh) * TQ;
  PagedTile<kCode> src{
      p.q + (static_cast<size_t>(sh) * p.Q + row0) * p.D,
      p.out + (static_cast<size_t>(sh) * p.Q + row0) * p.D,
      static_cast<const T*>(p.k_pool) + h * p.D,
      static_cast<const T*>(p.v_pool) + h * p.D,
      p.k_scale, p.v_scale, p.tables + static_cast<size_t>(s) * p.max_pages,
      p.per_row ? p.lengths + static_cast<size_t>(s) * p.Q + row0
                : p.lengths + s,
      at, ks, ks + p.chunk, static_cast<size_t>(p.H) * p.D, p.per_row,
      p.max_pages * p.page, min(TQ, p.Q - row0), p.D, p.page, p.chunk, 0,
      p.max_pages * p.page, p.k_pos0 != nullptr ? p.k_pos0[s] : 0,
      p.window};
  for (int r = 0; r < src.n; ++r) {
    src.hmax = max(src.hmax, src.horizon(r));
    src.lmin = min(src.lmin, src.lower(r));
  }
  mxt_tile::tile_forward<DPL, RM>(src, p.D, p.page, p.chunk, p.scale);
}

template <int kCode, int DPL, int RM>
int launch_prefill(Params p, int S, cudaStream_t stream) {
  constexpr int TQ = mxt_tile::kWarps * RM;
  const auto kernel = paged_prefill_kernel<kCode, DPL, RM>;
  p.tiles = (p.Q + TQ - 1) / TQ;
  p.chunk = p.page * (mxt_tile::kGroup / p.page);
  const size_t bytes =
      4u * (mxt_tile::Layout(kWarp * DPL, TQ, p.chunk, p.page).words +
            group_words(p.chunk, kCode));
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> opted[mxt::kMaxDevices];
  if (bytes > 48 * 1024) {
    const cudaError_t e = mxt::opt_in_smem(kernel, kSmemMax, opted);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<S * p.H * p.tiles, mxt_tile::kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Rows a CTA: 32, or 16 where 32-row tiles would not give two CTAs an
// SM (K1's rule).
template <int kCode, int DPL>
int prefill_rows(const Params& p, int S, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = mxt::sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (static_cast<long long>(S) * p.H * ((p.Q + 31) / 32) >= 2LL * sms)
    return launch_prefill<kCode, DPL, 4>(p, S, stream);
  return launch_prefill<kCode, DPL, 2>(p, S, stream);
}

// Decode rows take one row a CTA; a few rows a slot (the speculative
// verify's K + 1) the same kernel with a tile of 8 rows, whose warps
// spread the slot's pages (K1's tile, at least 16 rows, leaves most of
// its rows empty there); prefill buckets K1's tile.
template <int kCode>
int launch_code(const Params& p, int S, int Q, cudaStream_t stream) {
  if (Q == 1) return launch_rows<kCode, 1>(p, S, stream);
  if (Q <= kVerifyRows) return launch_rows<kCode, kVerifyRows>(p, S, stream);
  if (p.D <= 32) return prefill_rows<kCode, 1>(p, S, stream);
  if (p.D <= 64) return prefill_rows<kCode, 2>(p, S, stream);
  if (p.D <= 128) return prefill_rows<kCode, 4>(p, S, stream);
  return prefill_rows<kCode, 8>(p, S, stream);
}

}  // namespace

// q, out: (S, H, Q, D); k_pool, v_pool: one layer's (pages + 1, page, H, D)
// pool; tables: (S, max_pages) int32; lengths: (S,) int32, or (S, Q) when
// per_row.  All contiguous on the current device; D <= 256.  Returns
// cudaGetLastError() after the launch.
extern "C" int mxt_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* lengths, void* out, int S,
                                   int H, int Q, int D, int page,
                                   int max_pages, int per_row, float scale,
                                   void* stream) {
  if (D > mxt::kMaxHeadDim || page > mxt::kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), k_pool, v_pool, nullptr, nullptr,
           static_cast<const int*>(tables), static_cast<const int*>(lengths),
           nullptr, static_cast<float*>(out), H, Q, D, page, max_pages,
           per_row, 0, 0, 0, scale};
  return launch_code<0>(p, S, Q, static_cast<cudaStream_t>(stream));
}

// K2 over a windowed layer's rings: as mxt_paged_attention through the
// rotated tables, with k_pos0 (S,) int32 the absolute position of each
// slot's table row 0 (a multiple of the page) and a window of ``window``
// keys (0: every key below the horizon).
extern "C" int mxt_paged_attention_ring(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* tables,
                                        const void* lengths,
                                        const void* k_pos0, void* out, int S,
                                        int H, int Q, int D, int page,
                                        int max_pages, int per_row,
                                        int window, float scale,
                                        void* stream) {
  if (D > mxt::kMaxHeadDim || page > mxt::kMaxBlock || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), k_pool, v_pool, nullptr, nullptr,
           static_cast<const int*>(tables), static_cast<const int*>(lengths),
           static_cast<const int*>(k_pos0), static_cast<float*>(out), H, Q,
           D, page, max_pages, per_row, 0, 0, window, scale};
  return launch_code<0>(p, S, Q, static_cast<cudaStream_t>(stream));
}

// K2q: as mxt_paged_attention over one layer's one-byte code pools
// (int8, or e4m3 bytes where e4m3 = 1) with their (pages + 1, page) fp32
// scale pools k_scale, v_scale.
extern "C" int mxt_paged_attention_q(const void* q, const void* k_pool,
                                     const void* v_pool, const void* k_scale,
                                     const void* v_scale, const void* tables,
                                     const void* lengths, void* out, int S,
                                     int H, int Q, int D, int page,
                                     int max_pages, int per_row, float scale,
                                     int e4m3, void* stream) {
  if (D > mxt::kMaxHeadDim || page > mxt::kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), k_pool, v_pool,
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int*>(tables), static_cast<const int*>(lengths),
           nullptr, static_cast<float*>(out), H, Q, D, page, max_pages,
           per_row, 0, 0, 0, scale};
  auto st = static_cast<cudaStream_t>(stream);
  return e4m3 ? launch_code<2>(p, S, Q, st) : launch_code<1>(p, S, Q, st);
}

// K2q over a windowed layer's one-byte rings and their scale rings, as
// mxt_paged_attention_ring.
extern "C" int mxt_paged_attention_q_ring(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, const void* k_pos0, void* out, int S, int H, int Q,
    int D, int page, int max_pages, int per_row, int window, float scale,
    int e4m3, void* stream) {
  if (D > mxt::kMaxHeadDim || page > mxt::kMaxBlock || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), k_pool, v_pool,
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int*>(tables), static_cast<const int*>(lengths),
           static_cast<const int*>(k_pos0), static_cast<float*>(out), H, Q,
           D, page, max_pages, per_row, 0, 0, window, scale};
  auto st = static_cast<cudaStream_t>(stream);
  return e4m3 ? launch_code<2>(p, S, Q, st) : launch_code<1>(p, S, Q, st);
}
