// Candidate tilings of K3/K3q's ring kernel (csrc/linear.cu) for calls of
// more than 16 rows, and the tiled kernel it replaced there, built for
// one weight type (-DK3T_CODE=0 fp32, 1 int8, 2 e4m3) by
// ``python -m mxnet_tpu_torch.testing.k3_tiles``.
#include "../csrc/linear.cu"

#ifndef K3T_CODE
#define K3T_CODE 0
#endif

// (RY, TM, FX, TN, BK, ST): a (RY TM x FX TN) tile of RY FX threads,
// stages of BK columns, a ring of ST stages.  First the tilings the rule
// in linear.cu takes, then others that lost to them on an H100: wider or
// narrower stages, other micro-tiles, a whole warp on the same x rows.
#define K3T_CANDIDATES(X)                                                \
  X(8, 5, 16, 1, 128, 3) X(8, 5, 16, 4, 64, 3) X(8, 4, 16, 2, 128, 3)    \
  X(8, 5, 16, 3, 128, 3) X(8, 5, 16, 4, 128, 3) X(8, 4, 16, 2, 256, 2)   \
  X(16, 8, 8, 16, 32, 3) X(16, 8, 16, 8, 32, 3) X(8, 8, 16, 2, 64, 3)    \
  X(8, 8, 16, 4, 32, 3) X(8, 5, 16, 2, 128, 3) X(8, 5, 16, 1, 64, 4)     \
  X(16, 4, 8, 8, 32, 3) X(16, 8, 8, 12, 64, 2) X(8, 8, 8, 8, 32, 3)      \
  X(8, 8, 16, 4, 16, 4) X(4, 16, 32, 4, 32, 3)

namespace {

using RingFn = int (*)(const float*, const void*, const float*,
                       const float*, float*, int, int, int, cudaStream_t);

#define K3T_FN(ry, tm, fx, tn, bk, st) \
  launch_ring<K3T_CODE, ry, tm, fx, tn, bk, st>,
#define K3T_NAME(ry, tm, fx, tn, bk, st) \
  "RY" #ry " TM" #tm " FX" #fx " TN" #tn " BK" #bk " ST" #st,

const RingFn kFns[] = {K3T_CANDIDATES(K3T_FN)};
const char* const kNames[] = {K3T_CANDIDATES(K3T_NAME)};

}  // namespace

extern "C" int k3t_count() { return sizeof(kFns) / sizeof(kFns[0]); }

extern "C" const char* k3t_name(int i) { return kNames[i]; }

// Candidate ``i`` (-1: the 64 x 64 tiled kernel) on x (M, C), w (F, C),
// scales (F,) for codes, bias (F,) or null, y (M, F).
extern "C" int k3t_launch(int i, const void* x, const void* w,
                          const void* scales, const void* bias, void* y,
                          int M, int F, int C, void* stream) {
  const auto* xp = static_cast<const float*>(x);
  const auto* sp = static_cast<const float*>(scales);
  const auto* bp = static_cast<const float*>(bias);
  auto* yp = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (i >= 0) return kFns[i](xp, w, sp, bp, yp, M, F, C, st);
  const dim3 grid((F + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  tiled_kernel<K3T_CODE>()<<<grid, 256, 0, st>>>(xp, w, sp, bp, yp, M, F,
                                                 C, true);
  return static_cast<int>(cudaGetLastError());
}
