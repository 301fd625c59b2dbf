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
// The readout's order is fixed (ops/ssm_ops.py::_readout, which the
// plain version runs): partial p[l] for l < 32 sums (q[i] scale) new[i,
// j] over i = l, l + 32, ... in increasing i from +0, then the tree
// p[l] += p[l + o] for l < o, o = 16, 8, 4, 2, 1 (the xor butterfly of
// one warp, which a first form of this kernel ran with shuffles).
//
// Design.  Each state element's recurrence is independent of every other
// (new[i, j] needs k[i], v[j] and itself), and the readout of row t feeds
// nothing, so the recurrence is spread over many threads and the readout
// is taken off its path:
// - A CTA owns a (slot, head, block of JB columns).  Thread (l0, ct), l0 <
//   NL = 32 / LP, holds JT adjacent columns j = j0 + ct JT + u at rows i =
//   l + 32 c for its LP partial indices l = l0 + NL m: LP x D/32 x JT
//   floats in registers for all T rows.  The state is read once and
//   written once (with collect, once more a row); the lanes of a warp
//   take adjacent columns, so every warp instruction moves whole 32-byte
//   sectors (whole 128-byte lines when JB JT reaches 32 a row).
// - A row's update and its LP partial sums run in the thread; the
//   partials' first log2(LP) tree levels (o = 16 .. NL) too, since the
//   thread holds both partners of each.  The remaining NL values a column
//   go to shared memory; after the chunk's rows, one thread a (row,
//   column) loads them and adds the tree's last levels (o = NL/2 .. 1) in
//   its pairing.  Partials are double-buffered by chunk, so the readout of
//   chunk c - 1 runs while other warps already update chunk c, one
//   barrier a chunk.
// - Inputs are read once a CTA: the rows of a chunk of q, k (all D) and
//   v (the block's JB columns) are copied by cp.async two chunks ahead
//   into a ring of three stages, q and k into the order a thread reads
//   them (its LP x D/32 values contiguous, one 16-byte load each four),
//   q scaled once there by the thread that copied it.  A whole chunk of
//   valid rows runs as straight-line blocks of four rows, each row's
//   inputs read two rows ahead.
// - Shapes (launch_shape): decode and verify (T <= 8) are bound by the
//   state's bytes: LP 4, JB 32, JT 4 (64 threads, 16-byte state loads and
//   stores, four CTAs an SM in flight); a prefill is bound by shared
//   memory and instructions: LP 2, JB 16, JT 1, 32-row chunks (256
//   threads, D/16 CTAs a head, so a 256-row prefill at S = 1 H = 16 fills
//   128 of the H100's 132 SMs).  testing/k10_parent.py times the shapes
//   left out and ablations (PERF.md): more columns a thread halve
//   the warps an SM at prefill and ran slower; inputs staged through
//   registers, by TMA bulk copies, or copied so a warp's writes land on
//   adjacent words (uncoalesced reads) all ran slower: any load in flight
//   across the chunk's barrier costs time.
// The state may be updated in place (state == state0): each element is
// read and written by one thread, read before it is written.
//
// Bound on an H100: bytes at decode, instructions at prefill.  Decode
// (S 8, T 1, H 16, D 128) reads and writes 8.4 MB of state each way,
// ~16.8 MB over 3.35 TB/s = 5 us; a verify (S 8, W 5) with collect also
// writes W x 8.4 MB of snapshots, ~50 MB, 15 us.  A row does 5 D^2 flops
// a head (update 3, readout 2); without FMA (the bits forbid it) each is
// one instruction, so a 256-row prefill at S 1 H 16 issues ~335 M fp32
// instructions: 132 SMs x 128 lanes x 1.98 GHz = 33.5 T/s, 10 us (the
// 67 TFLOP/s fp32 peak counts an FMA as two flops: 5 us).  Every column
// thread reads its rows' k and q from shared memory each row, 64 bytes a
// thread at LP 2: 16 KB a row a CTA at 128 bytes a cycle, ~17 us over
// 256 rows, so the prefill's update is bound by shared memory first.
#include <atomic>
#include <cstdint>
#include <type_traits>

#include "error.cuh"
#include "online_softmax.cuh"
#include "per_device.cuh"

namespace {

using mxt::kFull;
using mxt::kWarp;

constexpr int kMaxRows = 32;    // rows a chunk (a bit each in a mask)
constexpr int kStages = 3;      // input chunks: in use, ready, in flight
constexpr int kFewRows = 8;     // T up to this: the decode and verify shape
constexpr int kSmemMax = 232448;

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
  int S, T, H, D;
  int blocks;              // column blocks a head
  int rows;                // rows a chunk: min(T, kMaxRows) or less
  int stages;              // input stages in shared memory: min(chunks, 3)
  float scale;
};

// A CTA's layout for D <= 32 DC, LP partial indices and JT columns a
// thread, JB columns a CTA.  Shared memory (floats): up to three stages of
// [k rows | q rows | v rows] (rows of DP = 32 DC in the threads' order, v
// rows of JB), then up to two partial buffers of rows x JB entries of PP
// floats (NL values, padded so that 16-byte loads of neighbouring entries
// meet no bank twice).
template <int DC, int LP, int JB, int JT>
struct Shape {
  static constexpr int NL = kWarp / LP;  // threads a column
  static constexpr int CT = JB / JT;     // threads across the columns
  static constexpr int NT = NL * CT;     // threads a CTA
  static constexpr int DP = kWarp * DC;
  static constexpr int EI = LP * DC;     // state rows a thread
  static constexpr int PP = NL + 4;
  static_assert(LP >= 1 && LP <= 8 && (kWarp % LP) == 0, "K10 LP");
  static_assert(JT == 1 || JT == 2 || JT == 4, "K10 JT");
  static_assert(JB % JT == 0 && NT % kWarp == 0 && NT <= 1024, "K10 CTA");
  __host__ __device__ static int stage_floats(int rows) {
    return rows * (2 * DP + JB);
  }
  __host__ __device__ static int partial_floats(int rows) {
    return rows * JB * PP;
  }
  static int smem_bytes(int rows, int stages) {
    return 4 * (stages * stage_floats(rows) +
                (stages < 2 ? stages : 2) * partial_floats(rows));
  }
};

// Where q[i] and k[i] sit in a stage row: thread l0's values for m < LP,
// c < DC at (l0 LP + m) DC + c, where i = l0 + NL m + 32 c.
template <int DC, int LP>
__device__ __forceinline__ int stage_pos(int i) {
  constexpr int NL = kWarp / LP;
  const int c = i / kWarp, rem = i % kWarp;
  return ((rem % NL) * LP + rem / NL) * DC + c;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N floats between registers and memory at an address aligned to 4 N
// bytes (up to 16): one vector access each 4, 2 or 1
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int x = 0; x < N; x += 4) {
      const float4 a = reinterpret_cast<const float4*>(src + x)[0];
      dst[x] = a.x; dst[x + 1] = a.y; dst[x + 2] = a.z; dst[x + 3] = a.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int x = 0; x < N; x += 2) {
      const float2 a = reinterpret_cast<const float2*>(src + x)[0];
      dst[x] = a.x; dst[x + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int x = 0; x < N; ++x) dst[x] = src[x];
  }
}
template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (N == 4) {
    reinterpret_cast<float4*>(dst)[0] =
        make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (N == 2) {
    reinterpret_cast<float2*>(dst)[0] = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

// The tree's levels o = O, O / 2, .., 1 over a[0 .. 2 O): a[l] += a[l + o]
// for l < o, so a[0] ends with the sum in the butterfly's pairing.
template <int O, int N>
__device__ __forceinline__ void fold(float (&a)[N]) {
  if constexpr (O > 0) {
#pragma unroll
    for (int l = 0; l < O; ++l) a[l] = __fadd_rn(a[l], a[l + O]);
    fold<O / 2>(a);
  }
}

// One row's inputs as a thread reads them: its EI values of k and of q
// (scaled), and v at its JT columns.
template <int EI, int JT>
struct RowIn {
  float k[EI], q[EI], v[JT];
};

template <bool V>
using Flag = std::integral_constant<bool, V>;

// PIPE: the many-row form, which reads a row's inputs two rows ahead and
// runs whole chunks (every row valid, no snapshots) as straight-line
// blocks of four rows; without it, a row's inputs are read m by m as they
// are used, which keeps the registers a thread needs (and so the state a
// CTA holds in flight) low for decode and verify.  PAD: D < 32 DC, so a
// thread's rows include some i >= D, which the update must leave out (a
// test of i at run time in every row cost a 256-row prefill ~9 %).
template <int DC, int LP, int JB, int JT, int MINB, bool PIPE, bool PAD>
__global__ void __launch_bounds__(Shape<DC, LP, JB, JT>::NT, MINB)
    ssm_scan_kernel(const Params p) {
  using Sh = Shape<DC, LP, JB, JT>;
  constexpr int NL = Sh::NL, CT = Sh::CT, NT = Sh::NT, DP = Sh::DP;
  constexpr int EI = Sh::EI, PP = Sh::PP;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int RC = p.rows;
  const int SF = Sh::stage_floats(RC);
  float* const partials = smem + p.stages * SF;
  const int PF = Sh::partial_floats(RC);

  const int tid = threadIdx.x, lane = tid % kWarp;
  const int ct = tid % CT, l0 = tid / CT;
  const int sh = blockIdx.x / p.blocks;  // s * H + h
  const int h = sh % p.H, s = sh / p.H;
  const int j0 = (blockIdx.x % p.blocks) * JB, j = j0 + ct * JT;
  const bool jvec = p.D % JT == 0;  // the JT columns as one vector access
  const size_t dd = static_cast<size_t>(p.D) * p.D;
  const int HD = p.H * p.D;  // floats from one row of q, k, v to the next
  const float g = p.gamma[h];
  const int nchunks = (p.T + RC - 1) / RC;
  // (s, row 0, h, 0) of q, k, v and y
  const size_t base = static_cast<size_t>(s) * p.T * HD + h * p.D;

  // the state: rows i = l0 + NL m + 32 c of columns j .. j + JT - 1,
  // st[u][m DC + c], read from and written to a (D, D) matrix; the JT
  // columns move as one vector where D allows
  float st[JT][EI];
  auto load_state = [&](const float* mat) {
#pragma unroll
    for (int m = 0; m < LP; ++m)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int i = l0 + NL * m + kWarp * c;
        const size_t at = static_cast<size_t>(i) * p.D + j;
        float in[JT];
        if (i < p.D && jvec && j < p.D) {
          load_vec<JT>(in, mat + at);
        } else {
#pragma unroll
          for (int u = 0; u < JT; ++u)
            in[u] = (i < p.D && j + u < p.D) ? mat[at + u] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < JT; ++u) st[u][m * DC + c] = in[u];
      }
  };
  auto store_state = [&](float* mat) {
#pragma unroll
    for (int m = 0; m < LP; ++m)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int i = l0 + NL * m + kWarp * c;
        const size_t at = static_cast<size_t>(i) * p.D + j;
        float out[JT];
#pragma unroll
        for (int u = 0; u < JT; ++u) out[u] = st[u][m * DC + c];
        if (i < p.D && jvec && j < p.D) {
          store_vec<JT>(mat + at, out);
        } else {
#pragma unroll
          for (int u = 0; u < JT; ++u)
            if (i < p.D && j + u < p.D) mat[at + u] = out[u];
        }
      }
  };
  load_state(p.state0 + sh * dd);

  // values no copy writes (rows i >= D, columns past D) stay 0; the
  // update skips rows i >= D, and columns past D are neither stored nor
  // read out
  if (p.D % kWarp != 0 || p.D % JB != 0) {
    for (int x = tid; x < p.stages * SF; x += NT) smem[x] = 0.f;
    __syncthreads();
  }

  // Each thread copies k and q at the same values i of every RSTEP-th row
  // of a chunk (i = i0, i0 + ISTEP, ...) and scales the q it copied.
  constexpr int RSTEP = NT >= DP ? NT / DP : 1;
  constexpr int ISTEP = NT >= DP ? DP : NT;
  const int i0 = tid % ISTEP, r0 = NT >= DP ? tid / DP : 0;
  // chunk c's inputs into stage c % 3 by cp.async: one commit group a call
  auto issue = [&](int c) {
    if (c < nchunks) {
      float* const stg = smem + (c % kStages) * SF;
      const int t0 = c * RC, rows = min(RC, p.T - t0);
      const size_t b0 = base + static_cast<size_t>(t0) * HD;
      for (int i = i0; i < p.D; i += ISTEP) {
        float* at = stg + r0 * DP + stage_pos<DC, LP>(i);
        const float* kp = p.k + b0 + static_cast<size_t>(r0) * HD + i;
        const float* qp = p.q + b0 + static_cast<size_t>(r0) * HD + i;
        for (int r = r0; r < rows; r += RSTEP) {
          cp_async4(at, kp);
          cp_async4(at + RC * DP, qp);
          at += RSTEP * DP;
          kp += RSTEP * HD;
          qp += RSTEP * HD;
        }
      }
      for (int x = tid; x < rows * JB; x += NT) {
        const int r = x / JB, jj = x % JB;
        if (j0 + jj < p.D)
          cp_async4(stg + 2 * RC * DP + x, p.v + b0 + r * HD + j0 + jj);
      }
    }
    cp_commit();
  };
  // q * scale, rounded once (the JAX package's q32), by the thread that
  // copied it, once its copies have landed
  auto scale_q = [&](int c) {
    if (c >= nchunks) return;
    float* const qs = smem + (c % kStages) * SF + RC * DP;
    const int rows = min(RC, p.T - c * RC);
    for (int i = i0; i < p.D; i += ISTEP) {
      float* at = qs + r0 * DP + stage_pos<DC, LP>(i);
      for (int r = r0; r < rows; r += RSTEP, at += RSTEP * DP)
        *at = __fmul_rn(*at, p.scale);
    }
  };
  // lane r's row of chunk c is valid (a warp's ballot makes the mask)
  auto valid_byte = [&](int c) -> int {
    if (c >= nchunks || p.valid == nullptr) return 1;
    const int t = c * RC + lane;
    if (lane >= RC || t >= p.T) return 1;
    return p.valid[static_cast<size_t>(s) * p.T + t];
  };

  // chunk c's rows: the update, the snapshots, the partials into its
  // buffer
  auto update = [&](int c, unsigned mask) {
    const float* const stg = smem + (c % kStages) * SF;
    const float* const ks = stg + l0 * EI;
    const float* const qs = stg + RC * DP + l0 * EI;
    const float* const vs = stg + 2 * RC * DP + ct * JT;
    float* const pw = partials + (c & 1) * PF + ct * JT * PP + l0;
    const int t0 = c * RC, rows = min(RC, p.T - t0);
    // the row's update of column u at the thread's rows for m, and its
    // partial sum (q: the row's q for m); rows i >= D are left out, as
    // the plain version has none (0 x an infinite v would be a NaN)
    auto column = [&](const float* k, const float* q, float v, int u,
                      int m) {
      float part = 0.f;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        if (!PAD || l0 + NL * m + kWarp * cc < p.D) {
          float& x = st[u][m * DC + cc];
          x = __fadd_rn(__fmul_rn(g, x), __fmul_rn(k[cc], v));
          part = __fadd_rn(part, __fmul_rn(q[cc], x));
        }
      }
      return part;
    };
    auto store_partials = [&](float (&pm)[JT][LP], int r) {
#pragma unroll
      for (int u = 0; u < JT; ++u) {
        fold<LP / 2>(pm[u]);  // levels o = 16 .. NL: partner m + o / NL
        pw[(r * JB + u) * PP] = pm[u][0];
      }
    };
    if constexpr (PIPE) {
      auto load = [&](RowIn<EI, JT>& in, int r) {
        load_vec<EI>(in.k, ks + r * DP);
        load_vec<EI>(in.q, qs + r * DP);
        load_vec<JT>(in.v, vs + r * JB);
      };
      auto step = [&](const RowIn<EI, JT>& in, int r, auto whole) {
        if (decltype(whole)::value || ((mask >> r) & 1u)) {
          float pm[JT][LP];
#pragma unroll
          for (int u = 0; u < JT; ++u)
#pragma unroll
            for (int m = 0; m < LP; ++m)
              pm[u][m] = column(in.k + m * DC, in.q + m * DC, in.v[u], u, m);
          store_partials(pm, r);
        }
        if (!decltype(whole)::value && p.states != nullptr)
          store_state(p.states + (static_cast<size_t>(t0 + r) * p.S * p.H +
                                  sh) * dd);
      };
      const unsigned all = rows < 32 ? (1u << rows) - 1u : ~0u;
      if (rows % 4 == 0 && (mask & all) == all && p.states == nullptr) {
        // a whole chunk: four rows a block of straight-line code, each
        // row's inputs read two rows ahead
        RowIn<EI, JT> a, b, c2, d;
        load(a, 0);
        load(b, 1);
        for (int r = 0; r < rows; r += 4) {
          load(c2, r + 2);
          load(d, r + 3);
          step(a, r, Flag<true>{});
          step(b, r + 1, Flag<true>{});
          load(a, min(r + 4, rows - 1));
          load(b, min(r + 5, rows - 1));
          step(c2, r + 2, Flag<true>{});
          step(d, r + 3, Flag<true>{});
        }
      } else {
        RowIn<EI, JT> a, b;
        load(a, 0);
        for (int r = 0; r < rows; r += 2) {
          if (r + 1 < rows) load(b, r + 1);
          step(a, r, Flag<false>{});
          if (r + 1 >= rows) break;
          if (r + 2 < rows) load(a, r + 2);
          step(b, r + 1, Flag<false>{});
        }
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        if ((mask >> r) & 1u) {  // uniform over the CTA
          float v[JT], pm[JT][LP];
          load_vec<JT>(v, vs + r * JB);
#pragma unroll
          for (int m = 0; m < LP; ++m) {
            float kq[2 * DC];  // k, then q, at the thread's rows for m
            load_vec<DC>(kq, ks + r * DP + m * DC);
            load_vec<DC>(kq + DC, qs + r * DP + m * DC);
#pragma unroll
            for (int u = 0; u < JT; ++u)
              pm[u][m] = column(kq, kq + DC, v[u], u, m);
          }
          store_partials(pm, r);
        }
        if (p.states != nullptr)
          store_state(p.states + (static_cast<size_t>(t0 + r) * p.S * p.H +
                                  sh) * dd);
      }
    }
  };
  // chunk c's outputs: one thread a (row, column) adds the tree's levels
  // o = NL/2 .. 1 over the NL values the column's threads left
  auto readout = [&](int c, unsigned mask) {
    const float* const pb = partials + (c & 1) * PF;
    const int t0 = c * RC, rows = min(RC, p.T - t0);
    for (int x = tid; x < rows * JB; x += NT) {
      const int r = x / JB, jj = x % JB;
      float out = 0.f;
      if ((mask >> r) & 1u) {
        float a[NL];
        load_vec<NL>(a, pb + x * PP);
        fold<NL / 2>(a);
        out = a[0];
      }
      if (j0 + jj < p.D) p.y[base + (t0 + r) * HD + j0 + jj] = out;
    }
  };

  issue(0);
  issue(1);
  cp_wait<1>();
  scale_q(0);
  unsigned mask = __ballot_sync(kFull, valid_byte(0) != 0), last = 0;
  int next_byte = valid_byte(1);
  for (int c = 0; c < nchunks; ++c) {
    cp_wait<0>();
    scale_q(c + 1);
    // chunks c and c + 1 are in place; every thread is past update(c - 1)
    // (stage (c + 2) % 3 is free) and readout(c - 2) (buffer c & 1 is)
    __syncthreads();
    issue(c + 2);
    const unsigned next = __ballot_sync(kFull, next_byte != 0);
    next_byte = valid_byte(c + 2);
    update(c, mask);
    if (c > 0) readout(c - 1, last);
    last = mask;
    mask = next;
  }
  __syncthreads();
  if (nchunks > 0) readout(nchunks - 1, last);

  if (p.state != nullptr) store_state(p.state + sh * dd);
}

template <int DC, int LP, int JB, int JT, int MINB, bool PIPE, bool PAD>
int launch(Params p, cudaStream_t stream) {
  using Sh = Shape<DC, LP, JB, JT>;
  const auto kernel = ssm_scan_kernel<DC, LP, JB, JT, MINB, PIPE, PAD>;
  p.blocks = (p.D + JB - 1) / JB;
  // rows a chunk: all T up to kMaxRows, halved while the stages do not fit
  p.rows = p.T < kMaxRows ? (p.T > 0 ? p.T : 1) : kMaxRows;
  int bytes = 0;
  for (;;) {
    const int chunks = (p.T + p.rows - 1) / p.rows;
    p.stages = chunks < kStages ? (chunks > 0 ? chunks : 1) : kStages;
    bytes = Sh::smem_bytes(p.rows, p.stages);
    if (bytes <= kSmemMax || p.rows == 1) break;
    p.rows = (p.rows + 1) / 2;
  }
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> opted[mxt::kMaxDevices];
  if (bytes > 48 * 1024) {
    const cudaError_t e = mxt::opt_in_smem(kernel, kSmemMax, opted);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<p.S * p.H * p.blocks, Sh::NT, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DC, int LP, int JB, int JT, int MINB, bool PIPE>
int launch_pad(const Params& p, cudaStream_t stream) {
  if (p.D == kWarp * DC)
    return launch<DC, LP, JB, JT, MINB, PIPE, false>(p, stream);
  return launch<DC, LP, JB, JT, MINB, PIPE, true>(p, stream);
}

// MINB: CTAs an SM the registers must allow (__launch_bounds__)
template <int LP, int JB, int JT, int MINB, bool PIPE>
int launch_dc(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch_pad<1, LP, JB, JT, MINB, PIPE>(p, stream);
  if (p.D <= 64) return launch_pad<2, LP, JB, JT, MINB, PIPE>(p, stream);
  if (p.D <= 128) return launch_pad<4, LP, JB, JT, MINB, PIPE>(p, stream);
  return launch_pad<8, LP, JB, JT, MINB, PIPE>(p, stream);
}

// The shape of a call (see the design note above).
int launch_shape(const Params& p, cudaStream_t stream) {
  if (p.T <= kFewRows) return launch_dc<4, 32, 4, 4, false>(p, stream);
  return launch_dc<2, 16, 1, 1, true>(p, stream);
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
           D, 0, 0, 0, scale};
  return launch_shape(p, static_cast<cudaStream_t>(stream));
}
