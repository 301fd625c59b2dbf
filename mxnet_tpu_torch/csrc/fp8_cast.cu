// K12: the scaled saturating cast of fp8 training, to e4m3 or e5m2 codes,
// with the transposed codes and the operand's amax from the same read.
//
// Replaces: the quantizing half of mxnet_tpu/quantize.py::_fp8_dot_fn
// (:512) — `_fake_cast` (:504) of the forward operands x and w at their
// delayed scales, of the cotangent g at its current scale in `bwd`
// (:544-547) — and the amaxes fp8_apply_dot (:565) records for the
// history.  The JAX package fake-casts (quantize, then dequantize in the
// compute dtype) and leaves the product to XLA; the port keeps the codes
// and hands them to K11 (fp8_gemm.cu), which multiplies them on the
// tensor cores.
//
// The contract: codes byte-equal to the plain version
// (ops/fp8_ops.py::fp8_cast_plain) and so to the JAX package's casts.
// Every step is exact or IEEE:
//   q    = x / scale                  (__fdiv_rn; x read as fp32, a bf16
//                                      input widened exactly)
//   code = round-to-nearest-even of clamp(q, -qmax, qmax) (qmax 448 for
//          e4m3, 57344 for e5m2), the hardware's satfinite conversion,
//          two values an instruction; a NaN q is sign | 0x7F (e4m3) or
//          sign | 0x7E (e5m2), the codes ml_dtypes gives a NaN (the
//          reference's clip keeps a NaN).
//   amax = max |x| over the operand, a max over the bits of |x| as
//          unsigned integers: exact in any order, and a NaN (whose bits
//          exceed Inf's) comes out as NaN, as jnp.max gives it.
// Codes are written with a row pitch rounded up to 16 bytes, the pad
// zero (+0 in both formats), so K11 can read any row in 16-byte copies
// and run its contraction over the pad; the transposed codes
// (cols x rows, pitch rows rounded up to 16) are K11's operands for the
// backward products, whose contraction runs over the other axis:
// fp8 MMA on sm_90 takes both operands K-major and ldmatrix has no 8-bit
// transpose there, so the transpose is made here, from shared memory,
// and never by a separate pass.
//
// Bound on an H100: bytes.  An element is read once (4 bytes fp32, 2
// bf16) and written twice as codes (1 byte each), over 3.35 TB/s.
//
// Design, for that bound.  A grid of eight CTAs an SM walks 128 x 128
// tiles (grid-stride), so that loads of some CTAs are always in flight
// while others convert.  A thread reads 8 values of a row at once (one
// 16-byte load of bf16, two of fp32; scalar loads only where the rows are
// not 16-byte aligned), two such runs in flight, converts them (two
// values an instruction) and writes their 8 codes as one 8-byte store; it
// keeps them in a shared 128 x 128-byte tile, XOR-swizzled by 16-byte
// groups, from which each thread reads 16 rows x 4 columns (16
// conflict-free word reads), transposes them in registers (byte
// permutes) and writes 4 transposed rows of 16 bytes, a warp's stores
// whole 128-byte lines.  The amax is a warp reduction, a shared-memory
// reduction and one atomicMax a CTA; the entry clears it on the stream
// first.  An amax alone (the cotangent's first pass) reads the operand
// flat, four 16-byte loads in flight a thread.  The quotient stays
// __fdiv_rn: a multiply by fl(1 / s) with the division kept for values
// within three steps of a code boundary gives the same codes but ran
// slower on the H100 (PERF.md), so the divide does not set the pace.
#include <cstdint>

#include <cuda_fp8.h>

#include "error.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kSegs = kTile * kTile / 8 / kThreads;  // 8-value runs a thread
constexpr int kBatch = 2;                             // runs in flight
constexpr int kCtasPerSm = 8;                       // 32 registers

// kKind 0: e4m3 (qmax 448), 1: e5m2 (qmax 57344)
template <int kKind>
__device__ __forceinline__ uint32_t nan_code(float q) {
  return ((__float_as_uint(q) >> 24) & 0x80u) | (kKind == 0 ? 0x7Fu : 0x7Eu);
}

// codes of x[0] / s, x[1] / s in the low and high byte
template <int kKind>
__device__ __forceinline__ uint32_t encode2(float x0, float x1, float s) {
  const float qmax = kKind == 0 ? 448.0f : 57344.0f;
  const float q0 = __fdiv_rn(x0, s), q1 = __fdiv_rn(x1, s);
  float2 c;
  c.x = fminf(fmaxf(q0, -qmax), qmax);
  c.y = fminf(fmaxf(q1, -qmax), qmax);
  uint32_t v = __nv_cvt_float2_to_fp8x2(c, __NV_SATFINITE,
                                        kKind == 0 ? __NV_E4M3 : __NV_E5M2);
  if (q0 != q0) v = (v & 0xFF00u) | nan_code<kKind>(q0);
  if (q1 != q1) v = (v & 0x00FFu) | (nan_code<kKind>(q1) << 8);
  return v;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// The 8 values at (gr, gc .. gc + 7) as fp32; zero past rows or cols.
// ``vec``: the rows are 16-byte aligned and cols a multiple of the run.
__device__ __forceinline__ void load8(const void* x, int bf16, int rows,
                                      int cols, int gr, int gc, bool vec,
                                      float (&v)[8], int& valid) {
  valid = gr < rows ? min(max(cols - gc, 0), 8) : 0;
  const size_t base = static_cast<size_t>(gr) * cols + gc;
  if (vec && valid == 8) {
    if (bf16) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(x) + base);
      v[0] = bf16_lo(w.x); v[1] = bf16_hi(w.x);
      v[2] = bf16_lo(w.y); v[3] = bf16_hi(w.y);
      v[4] = bf16_lo(w.z); v[5] = bf16_hi(w.z);
      v[6] = bf16_lo(w.w); v[7] = bf16_hi(w.w);
    } else {
      const float4* p = reinterpret_cast<const float4*>(
          static_cast<const float*>(x) + base);
      const float4 a = p[0], b = p[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] = 0.0f;
    if (e < valid)
      v[e] = bf16 ? __uint_as_float(static_cast<uint32_t>(
                        static_cast<const uint16_t*>(x)[base + e]) << 16)
                  : static_cast<const float*>(x)[base + e];
  }
}

__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* red) {
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < blockDim.x / 32 ? red[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xFFFFFFFFu, m);
  }
  return m;  // thread 0's is the block's
}

// Word (row r, 4-byte column w) of the shared tile: 16-byte groups XOR-
// swizzled by the row's 16-row block, so the transposed reads (4 word
// columns x 8 row blocks a warp) hit 32 banks.
__device__ __forceinline__ int swz(int r, int w) {
  return r * (kTile / 4) + (w ^ (((r >> 4) & 7) << 2));
}

template <int kKind>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    fp8_cast_kernel(const void* __restrict__ x, int bf16, int rows, int cols,
                    const float* __restrict__ scale,
                    uint8_t* __restrict__ codes, int ldc,
                    uint8_t* __restrict__ codes_t, int ldt,
                    unsigned* __restrict__ amax, int wr, int wc, bool vec) {
  __shared__ uint32_t tile[kTile * kTile / 4];
  __shared__ unsigned red[kThreads / 32];
  const float s = *scale;
  const int tiles_c = (wc + kTile - 1) / kTile;
  const int tiles = ((wr + kTile - 1) / kTile) * tiles_c;
  unsigned m = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = (t / tiles_c) * kTile, c0 = (t % tiles_c) * kTile;
    // kBatch runs' loads in flight at once, then their conversions
#pragma unroll 1
    for (int k0 = 0; k0 < kSegs; k0 += kBatch) {
      float v[kBatch][8];
      int valid[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int seg = threadIdx.x + (k0 + k) * kThreads;
        load8(x, bf16, rows, cols, r0 + seg / (kTile / 8),
              c0 + 8 * (seg % (kTile / 8)), vec, v[k], valid[k]);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int seg = threadIdx.x + (k0 + k) * kThreads;
        const int r = seg / (kTile / 8), cs = seg % (kTile / 8);
        const int gr = r0 + r, gc = c0 + 8 * cs;
        uint2 out = make_uint2(0u, 0u);
        if (valid[k] > 0) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (e < valid[k])
              m = max(m, __float_as_uint(v[k][e]) & 0x7FFFFFFFu);
          out.x = encode2<kKind>(v[k][0], v[k][1], s) |
                  (encode2<kKind>(v[k][2], v[k][3], s) << 16);
          out.y = encode2<kKind>(v[k][4], v[k][5], s) |
                  (encode2<kKind>(v[k][6], v[k][7], s) << 16);
          if (valid[k] < 8) {  // the pad past cols is zero codes
            const uint64_t keep = (1ull << (8 * valid[k])) - 1;
            out.x &= static_cast<uint32_t>(keep);
            out.y &= static_cast<uint32_t>(keep >> 32);
          }
        }
        if (codes != nullptr && gr < rows && gc < ldc)
          *reinterpret_cast<uint2*>(codes + static_cast<size_t>(gr) * ldc +
                                    gc) = out;
        if (codes_t != nullptr)
          *reinterpret_cast<uint2*>(&tile[swz(r, 2 * cs)]) = out;
      }
    }
    if (codes_t == nullptr) continue;
    __syncthreads();
    // 16 rows x 4 columns a thread: a warp's lanes 4 word columns x all 8
    // row blocks, so each store instruction writes whole 128-byte lines
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int w = warp * 4 + lane % 4;
    const int rb = lane / 4;
    uint32_t col[4][4];  // [column][4-row group]
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = 16 * rb + 4 * p;
      const uint32_t w0 = tile[swz(r, w)], w1 = tile[swz(r + 1, w)];
      const uint32_t w2 = tile[swz(r + 2, w)], w3 = tile[swz(r + 3, w)];
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
      const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
      const uint32_t t2 = __byte_perm(w0, w1, 0x7362);
      const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
      col[0][p] = __byte_perm(t0, t1, 0x5410);
      col[1][p] = __byte_perm(t0, t1, 0x7632);
      col[2][p] = __byte_perm(t2, t3, 0x5410);
      col[3][p] = __byte_perm(t2, t3, 0x7632);
    }
    const int gr = r0 + 16 * rb;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + 4 * w + j;
      if (gc < cols && gr < ldt)
        *reinterpret_cast<uint4*>(codes_t + static_cast<size_t>(gc) * ldt +
                                  gr) =
            make_uint4(col[j][0], col[j][1], col[j][2], col[j][3]);
    }
    __syncthreads();  // the tile is written again by the next one
  }
  if (amax != nullptr) {
    m = block_max(m, red);
    if (threadIdx.x == 0 && m != 0) atomicMax(amax, m);
  }
}

// max |x| alone over n values, read flat
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    fp8_amax_kernel(const void* __restrict__ x, int bf16, size_t n, bool vec,
                    unsigned* __restrict__ amax) {
  __shared__ unsigned red[kThreads / 32];
  unsigned m = 0;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  size_t i0 = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (vec) {
    // 16-byte vectors: 8 bf16 or 4 fp32 values
    const size_t per = bf16 ? 8 : 4, nv = n / per;
    const uint4* p = static_cast<const uint4*>(x);
    const uint32_t mask = bf16 ? 0x7FFF7FFFu : 0x7FFFFFFFu;
    for (size_t i = i0; i < nv; i += 4 * stride) {
      uint4 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = i + u * stride < nv ? p[i + u * stride]
                                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t a[4] = {w[u].x & mask, w[u].y & mask, w[u].z & mask,
                               w[u].w & mask};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          m = bf16 ? max(m, max((a[e] & 0xFFFFu) << 16, a[e] & 0xFFFF0000u))
                   : max(m, a[e]);
      }
    }
    i0 = nv * per + i0;  // the tail, scalar
  }
  for (size_t i = i0; i < n; i += stride) {
    const uint32_t b =
        bf16 ? static_cast<uint32_t>(static_cast<const uint16_t*>(x)[i]) << 16
             : __float_as_uint(static_cast<const float*>(x)[i]);
    m = max(m, b & 0x7FFFFFFFu);
  }
  m = block_max(m, red);
  if (threadIdx.x == 0 && m != 0) atomicMax(amax, m);
}

// CTAs for a grid-stride launch: kCtasPerSm on every SM, at most ``work``
int grid_for(long long work) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(max(1ll, min(work, 1ll * sms * kCtasPerSm)));
}

}  // namespace

// x: (rows, cols) contiguous, fp32 (bf16 == 0) or bf16 (bf16 == 1);
// scale: one device float (unused, and may be null, when no codes are
// asked for); kind 0 = e4m3, 1 = e5m2; codes: (rows, ldc) bytes or null;
// codes_t: (cols, ldt) bytes or null; amax: one device float (its bits
// as an unsigned max) or null.  ldc >= cols and ldt >= rows, multiples
// of 16; the pads are written as zero codes.
extern "C" int mxt_fp8_cast(const void* x, int bf16, int rows, int cols,
                            const float* scale, int kind, void* codes,
                            int ldc, void* codes_t, int ldt, void* amax,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 0 || cols < 0 || (kind != 0 && kind != 1) ||
      (codes != nullptr && (ldc < cols || ldc % 16 != 0)) ||
      (codes_t != nullptr && (ldt < rows || ldt % 16 != 0)) ||
      ((codes != nullptr || codes_t != nullptr) && scale == nullptr) ||
      (reinterpret_cast<uintptr_t>(codes) |
       reinterpret_cast<uintptr_t>(codes_t)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned* a = static_cast<unsigned*>(amax);
  if (a != nullptr) {
    cudaError_t e = cudaMemsetAsync(a, 0, sizeof(float), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t esize = bf16 ? 2 : 4;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (codes == nullptr && codes_t == nullptr) {
    const size_t n = static_cast<size_t>(rows) * cols;
    if (a == nullptr || n == 0) return static_cast<int>(cudaGetLastError());
    const long long blocks = static_cast<long long>(
        (n + 4 * kThreads * (16 / esize) - 1) / (4 * kThreads * (16 / esize)));
    fp8_amax_kernel<<<grid_for(blocks), kThreads, 0, st>>>(x, bf16, n,
                                                           aligned, a);
    return static_cast<int>(cudaGetLastError());
  }
  const int wc = codes != nullptr ? ldc : cols;
  const int wr = codes_t != nullptr ? ldt : rows;
  if (wc == 0 || wr == 0) return static_cast<int>(cudaGetLastError());
  // 16-byte loads need rows of a multiple of 16 bytes and an aligned base
  const bool vec = aligned && cols % (16 / esize) == 0;
  const long long tiles = static_cast<long long>((wr + kTile - 1) / kTile) *
                          ((wc + kTile - 1) / kTile);
  uint8_t* c = static_cast<uint8_t*>(codes);
  uint8_t* ct = static_cast<uint8_t*>(codes_t);
  if (kind == 0)
    fp8_cast_kernel<0><<<grid_for(tiles), kThreads, 0, st>>>(
        x, bf16, rows, cols, scale, c, ldc, ct, ldt, a, wr, wc, vec);
  else
    fp8_cast_kernel<1><<<grid_for(tiles), kThreads, 0, st>>>(
        x, bf16, rows, cols, scale, c, ldc, ct, ldt, a, wr, wc, vec);
  return static_cast<int>(cudaGetLastError());
}
