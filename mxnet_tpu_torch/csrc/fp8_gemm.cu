// K11: the fp8 GEMM of fp8 training on the tensor cores,
//   out[m, n] = (sum_k a[m, k] * b[n, k]) * s_a * s_b,
// a and b one-byte codes (e4m3 or e5m2), both K-major, accumulated in
// fp32 and stored in the compute dtype (fp32 or bf16).
//
// Replaces: the three contractions of mxnet_tpu/quantize.py::_fp8_dot_fn
// (:512) — the forward `_contract(xq, wq)` (e4m3 x e4m3), and in `bwd`
// dx (e5m2 cotangent x e4m3 weight) and dw (e5m2 cotangent x e4m3
// activation) — which the JAX package writes as dots over fake-cast
// operands in the compute dtype.  A product of two fp8 values is exact
// in fp32, so this is the same function up to the summation order and
// the reference's rounding of code * scale to the compute dtype before
// its dot; the scales are applied once, after the sum.  The operands are
// the codes K12 (fp8_cast.cu) writes, rows padded with zero codes to a
// multiple of 16 bytes; the backward's operands are K12's transposed
// codes, since fp8 wgmma on sm_90 takes both operands K-major.
//
// The sum, fixed bit for bit: every output is one thread's sum, in k
// order, of 128-deep partial sums, each the four wgmma m64n128k32 of one
// stage starting from zero (the fp8 tensor cores keep fewer bits in their
// running sum than fp32), added into an fp32 total with __fadd_rn (the
// promotion DeepSeek-V3 describes for Hopper's fp8 GEMMs); then
// x s_a x s_b (__fmul_rn) and one rounding to the output dtype.  No
// split-K, so a rerun gives the same bits, and so does any tile order.
//
// Its error against the exact sum, derived (the formula is
// ops/fp8_ops.py::fp8_gemm_error_bound).  Measured on an H100 by
// testing/fp8_accum.py, whose emulation of it gives this kernel's bits:
// one m64n128k32 step adds its 32 products and the running sum C (none in
// a stage's first step) by aligning them to the largest exponent E among
// them (a product's is the sum of its factors' exponent fields, a
// subnormal factor's its kind's least normal exponent, -6 for e4m3 and
// -14 for e5m2; C's its own) and cutting
// each toward zero to a multiple of u = 2^(E - 13); the cut values add
// exactly, and a sum that carries to 2^(E + 1) or past is cut toward zero
// again, 13 bits below its own leading bit.  So a step loses less than u
// on each of its 32 products and on C, and less than 2^-13 of its sum on
// the carry; 2^E and the sum are at most A (1 + r), A the stage's sum of
// |a|_f |b|_f (|x|_f: |x|, or the least normal value for a subnormal
// code; fp8_gemm_magnitude) and r the stage's relative loss.  A stage
// makes at most 4 x 32 + 3 + 4 = 135 cuts, so its error is below r A, r =
// 135 2^-13 / (1 - 135 2^-13) = 1.68e-2.  The fp32 sum of the stages, the
// two scale multiplies and the plain version's own fp32 sum (any order)
// add (2 K + stages + 2) 2^-24 of the same magnitude, and a bf16 output
// one more rounding, 2^-8 of its magnitude.  The cuts' errors add up only
// where the products share a sign: over random signs they stay near 1e-4
// to 3e-4 of sum |a b|, largest where K is small (a stage's cuts are
// relative to its own sum), so 2^-12, a bound fitted to such errors,
// failed at K = 160 over 2.3 M outputs; the 32-deep tail stage is not the
// cause (the emulation gives the kernel's bits there, as everywhere it was
// compared).  A form that keeps the whole K in the wgmma accumulator cuts
// each product against a running sum that grows with K, and goes over the
// bound at K = 8192 (testing/fp8_accum.py; PERF.md).  The bound is a worst
// case: a kernel that drops a stage may still meet it where the products'
// signs are random, so the card's checks also hold ~300 sampled outputs
// equal to the emulation (fp8_accum.sample_mismatches), which the
// no-promotion form fails at every K above one stage.
//
// Design: the Hopper GEMM shape (sm90.cuh's building blocks, as K7/K8),
// persistent.  One CTA an SM walks 128 x 128 output tiles in groups of
// eight row blocks (neighbouring CTAs share operand rows in L2) with
// three warpgroups.  One producer thread keeps a four-stage ring of
// (128 rows x 128 bytes of K) tiles of a and b filled by TMA (128-byte
// swizzle, zero fill past M, N and K), completing on one mbarrier a
// stage, and runs on into the next output tile's stages while the
// consumers finish this one: the ring fills once a CTA, not once a tile.
// Two consumer warpgroups each take 64 rows of the tile, wait for a
// stage's products, release the stage and promote; the two share the
// tensor cores, so one's products run while the other promotes.  The
// epilogue scales and converts in registers, writes the tile into a
// 128-byte-swizzled shared tile (conflict-free) and stores it with TMA,
// which completes while the next tile's products run; a shape whose
// output rows are not 16-byte aligned stores from registers instead, two
// adjacent columns a store where the row pitch allows.  Measured and
// left out (PERF.md): a second partial buffer, to keep one stage in
// flight during each promotion, needs 3 x 64 accumulator registers and
// spilled under the 168 the launch gives a thread; 64-column halves, one
// in flight while the other is promoted (the same bits), read a's tile
// twice and ran slower; so did consumers started a stage apart, and a
// five-stage ring.
//
// Bound on an H100: operations at the training shapes (2 M N K over
// 1,979 TFLOP/s dense fp8); bytes for small M or N.
#include <cstdint>

#include <cuda_bf16.h>

#include "error.cuh"
#include "sm90.cuh"

namespace {

using namespace mxt90;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 128;                  // bytes of K a stage: one box row
constexpr int kStages = 4;
constexpr int kGroupM = 8;                // row blocks a group of tiles
constexpr int kTileBytes = kBM * kBK;     // a's and b's tiles alike
constexpr int kThreads = 384;             // 2 consumer + 1 producer WG
// the shared output tile: boxes of 64 rows x 128 bytes, 128-byte swizzle,
// kBN * esize / 128 of them a consumer warpgroup
constexpr int kBoxBytes = 64 * 128;
__host__ __device__ constexpr int out_bytes(bool bf16) {
  return 2 * kBN * (bf16 ? 2 : 4) * 64;
}
constexpr int smem_bytes(bool bf16) {
  return 1024 + kStages * 2 * kTileBytes + out_bytes(bf16) + 16 * kStages;
}
static_assert(smem_bytes(false) <= 232448, "K11 shared memory");

// wgmma m64n128k32, fp8 x fp8 -> fp32, both operands K-major from shared
// memory; scale_d = 0 overwrites the accumulator, 1 adds to it.
template <int kA, int kB>
struct Wgmma;

#define MXT_FP8_WGMMA(A, B, TA, TB)                                          \
  template <>                                                                \
  struct Wgmma<A, B> {                                                       \
    __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,   \
                                               uint64_t b, int scale_d) {    \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                       \
          "wgmma.mma_async.sync.aligned.m64n128k32.f32." TA "." TB " {"      \
          "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
          "%24, %25, %26, %27, %28, %29, %30, %31, "                         \
          "%32, %33, %34, %35, %36, %37, %38, %39, "                         \
          "%40, %41, %42, %43, %44, %45, %46, %47, "                         \
          "%48, %49, %50, %51, %52, %53, %54, %55, "                         \
          "%56, %57, %58, %59, %60, %61, %62, %63"                           \
          "}, %64, %65, p, 1, 1;\n}\n"                                       \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),              \
            "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),              \
            "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),              \
            "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),              \
            "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),              \
            "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),              \
            "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),              \
            "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),              \
            "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),              \
            "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),              \
            "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),              \
            "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),              \
            "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),              \
            "+f"(d[62]), "+f"(d[63])                                         \
          : "l"(a), "l"(b), "r"(scale_d));                                   \
    }                                                                        \
  };
MXT_FP8_WGMMA(0, 0, "e4m3", "e4m3")
MXT_FP8_WGMMA(0, 1, "e4m3", "e5m2")
MXT_FP8_WGMMA(1, 0, "e5m2", "e4m3")
MXT_FP8_WGMMA(1, 1, "e5m2", "e5m2")
#undef MXT_FP8_WGMMA

// A 2-D map over (rows, cols) elements of ``type`` with a row pitch of
// ``pitch`` bytes (a multiple of 16): boxes of box_rows rows x 128 bytes,
// 128-byte swizzle; reads past rows or cols give zeros, writes past them
// are dropped.
inline int make_map_2d(CUtensorMap* map, const void* base,
                       CUtensorMapDataType type, int esize, int rows,
                       int cols, long long pitch, int box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esize),
                       static_cast<cuuint32_t>(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = enc(map, type, 2, const_cast<void*>(base), dims, strides, box,
                   elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// One box (128 bytes of K from ``col``, rows from ``row``) into shared
// memory at ``dst``, completing on ``bar``.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// One box of the shared output tile at ``src`` to (col, row) of the map.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the stores committed so far have read their shared tiles
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, seen by the TMA unit next
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of one consumer warpgroup
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_f2(uint32_t addr, float a,
                                             float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

// Output tile t of the grouped order: row blocks in groups of kGroupM,
// column blocks inside a group, a group's row blocks fastest.
__device__ __forceinline__ void tile_origin(int t, int mt, int nt, int& m0,
                                            int& n0) {
  const int per_group = kGroupM * nt;
  const int first = (t / per_group) * kGroupM;
  const int height = min(mt - first, kGroupM);
  const int in = t % per_group;
  m0 = (first + in % height) * kBM;
  n0 = (in / height) * kBN;
}

// epi: 2 = TMA store through the shared tile (16-byte output rows);
// 1 = stores from registers, two columns a store (even N); 0 = one a store
template <int kA, int kB, bool kBf16Out>
__global__ void __launch_bounds__(kThreads, 1)
    fp8_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tout, int M, int N,
                    int K, const float* __restrict__ sa,
                    const float* __restrict__ sb, void* __restrict__ out,
                    int epi) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sA = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sB = sA + kStages * kTileBytes;
  const uint32_t sOut = sB + kStages * kTileBytes;
  const uint32_t full = sOut + out_bytes(kBf16Out);  // 8 bytes a stage
  const uint32_t empty = full + 8 * kStages;
  const int mt = (M + kBM - 1) / kBM, nt = (N + kBN - 1) / kBN;
  const int tiles = mt * nt;
  const int ktiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform role, so the compiler sees the roles split by warpgroup
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer warpgroup: one thread issues every copy
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      int g = 0;  // pipeline stages over all of this CTA's tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, mt, nt, m0, n0);
        for (int it = 0; it < ktiles; ++it, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, 2 * kTileBytes);
          tma_load_2d(sA + s * kTileBytes, &ta, full + 8 * s, it * kBK, m0);
          tma_load_2d(sB + s * kTileBytes, &tb, full + 8 * s, it * kBK, n0);
        }
      }
    }
  } else {
    // consumer warpgroup wg: rows m0 + 64 wg + [0, 64) of each tile
    reg_alloc<kConsumerRegs>();
    const int t128 = threadIdx.x % 128;
    const int lane = t128 % 32, warp = t128 / 32;
    constexpr int kEsize = kBf16Out ? 2 : 4;
    constexpr int kBoxCols = 128 / kEsize;
    const uint32_t stage_out = sOut + wg * (kBN * kEsize / 128) * kBoxBytes;
    const float s_a = *sa, s_b = *sb;
    float acc[64], part[64];
    int g = 0;  // pipeline stages over all of this CTA's tiles
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_origin(t, mt, nt, m0, n0);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      for (int it = 0; it < ktiles; ++it, ++g) {
        const int s = g % kStages;
        mbar_wait(full + 8 * s, (g / kStages) & 1);
        const uint32_t a_tile = sA + s * kTileBytes;
        const uint32_t b_tile = sB + s * kTileBytes;
        fence_regs(part);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          Wgmma<kA, kB>::run(part, desc_k(a_tile, kBM, 64 * wg, kk),
                             desc_k(b_tile, kBN, 0, kk), kk > 0);
        wg_commit();
        wg_wait0();
        fence_regs(part);
        mbar_arrive(empty + 8 * s);  // the stage's products completed
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      }

      // accumulator element 4j + 2h + e is (row 16 warp + lane / 4 + 8 h,
      // column 8 j + 2 (lane % 4) + e) of the warpgroup's 64 x 128 block
      if (epi == 2) {
        if (t128 == 0) bulk_wait_read();  // the last tile's store is out
        wg_sync(wg);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * warp + lane / 4 + 8 * h;
            const float v0 = __fmul_rn(__fmul_rn(acc[4 * j + 2 * h], s_a), s_b);
            const float v1 =
                __fmul_rn(__fmul_rn(acc[4 * j + 2 * h + 1], s_a), s_b);
            // byte of the pair in its box row, then the 16-byte chunk
            // swizzled by the row (the TMA's 128-byte pattern)
            const int col = 8 * j + 2 * (lane % 4);
            const int box = col / kBoxCols;
            const int byte = (col % kBoxCols) * kEsize;
            const uint32_t addr = stage_out + box * kBoxBytes + r * 128 +
                                  ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
            if (kBf16Out)
              st_shared_u32(addr, pack_bf16(v0, v1));
            else
              st_shared_f2(addr, v0, v1);
          }
        fence_async_shared();
        wg_sync(wg);
        if (t128 == 0 && m0 + 64 * wg < M) {
#pragma unroll
          for (int b = 0; b < kBN / kBoxCols; ++b)
            tma_store_2d(&tout, stage_out + b * kBoxBytes, n0 + b * kBoxCols,
                         m0 + 64 * wg);
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
            const int col = n0 + 8 * j + 2 * (lane % 4);
            if (row >= M || col >= N) continue;
            const float v0 = __fmul_rn(__fmul_rn(acc[4 * j + 2 * h], s_a), s_b);
            const float v1 =
                __fmul_rn(__fmul_rn(acc[4 * j + 2 * h + 1], s_a), s_b);
            const size_t o = static_cast<size_t>(row) * N + col;
            if (epi == 1 && col + 1 < N) {
              if (kBf16Out)
                *reinterpret_cast<uint32_t*>(
                    static_cast<__nv_bfloat16*>(out) + o) = pack_bf16(v0, v1);
              else
                *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
                    make_float2(v0, v1);
            } else if (kBf16Out) {
              static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v0);
              if (col + 1 < N)
                static_cast<__nv_bfloat16*>(out)[o + 1] =
                    __float2bfloat16_rn(v1);
            } else {
              static_cast<float*>(out)[o] = v0;
              if (col + 1 < N) static_cast<float*>(out)[o + 1] = v1;
            }
          }
      }
    }
    if (epi == 2 && t128 == 0) bulk_wait_all();
  }
}

template <int kA, int kB>
int launch_kinds(const CUtensorMap& ta, const CUtensorMap& tb,
                 const CUtensorMap& tout, int M, int N, int K,
                 const float* sa, const float* sb, void* out, int bf16_out,
                 int epi, cudaStream_t st) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = tiles < sms ? tiles : sms;
  auto kern = bf16_out ? fp8_gemm_kernel<kA, kB, true>
                       : fp8_gemm_kernel<kA, kB, false>;
  const int smem = smem_bytes(bf16_out != 0);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (rc) return rc;
  kern<<<grid, kThreads, smem, st>>>(ta, tb, tout, M, N, K, sa, sb, out,
                                     epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (M, lda) codes of kind a_kind, b: (N, ldb) codes of kind b_kind
// (0 = e4m3, 1 = e5m2), both 16-byte aligned with lda, ldb multiples of
// 16 and >= K; sa, sb: one device float each; out: (M, N) fp32
// (bf16_out == 0) or bf16, contiguous.
extern "C" int mxt_fp8_gemm(const void* a, const void* b, int M, int N,
                            int K, int lda, int ldb, int a_kind, int b_kind,
                            const float* sa, const float* sb, void* out,
                            int bf16_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 0 || N < 0 || K < 0 || lda < K || ldb < K || lda % 16 != 0 ||
      ldb % 16 != 0 || (a_kind != 0 && a_kind != 1) ||
      (b_kind != 0 && b_kind != 1) ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (K == 0)  // an empty contraction: zeros
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(M) * N * (bf16_out ? 2 : 4), st));
  const int esize = bf16_out ? 2 : 4;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  const int epi = (static_cast<long long>(N) * esize % 16 == 0 && o % 16 == 0)
                      ? 2
                      : (N % 2 == 0 && o % (2 * esize) == 0 ? 1 : 0);
  CUtensorMap ta, tb, tout = {};
  int rc = make_map_2d(&ta, a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, lda,
                       kBM);
  if (!rc)
    rc = make_map_2d(&tb, b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, ldb, kBN);
  if (!rc && epi == 2)
    rc = make_map_2d(&tout, out,
                     bf16_out ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     esize, M, N, static_cast<long long>(N) * esize, 64);
  if (rc) return rc;
  if (a_kind == 0 && b_kind == 0)
    return launch_kinds<0, 0>(ta, tb, tout, M, N, K, sa, sb, out, bf16_out,
                              epi, st);
  if (a_kind == 0)
    return launch_kinds<0, 1>(ta, tb, tout, M, N, K, sa, sb, out, bf16_out,
                              epi, st);
  if (b_kind == 0)
    return launch_kinds<1, 0>(ta, tb, tout, M, N, K, sa, sb, out, bf16_out,
                              epi, st);
  return launch_kinds<1, 1>(ta, tb, tout, M, N, K, sa, sb, out, bf16_out,
                            epi, st);
}
