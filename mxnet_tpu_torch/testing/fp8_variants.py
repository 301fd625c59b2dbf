"""Why fp8 training's kernels ship as they do: K11 (``csrc/fp8_gemm.cu``)
and K12 (``csrc/fp8_cast.cu``) timed against variants of themselves, and
the LM's fp8 step split into host and device time.

Run on a card from the repository's root::

    python -m mxnet_tpu_torch.testing.fp8_variants

It copies ``csrc/`` once a variant under ``build/fp8_variants/``, patches
the variant's source by exact string replacements (which raise if the
shipped source no longer has the patched text), builds every variant with
the exact build's flags (one nvcc each, all at once), and prints one JSON
line a case: each variant's CUDA-event time beside the shipped kernel's
(L2 flushed, each window opened behind a device spin, as chip_smoke times
kernels) and whether its outputs are the shipped kernel's bits.

- K11 at the forward, dx and dw products of the LM's QKV projection (M
  8192, C 2048, F 6144) and the head's dx (F 32768, K 32768):
  ``inflight`` keeps one stage's products in flight while the stage
  before is promoted (two partial buffers, ``wgmma.wait_group 1``);
  ``halves`` runs each stage as two 64-column halves, one in flight
  while the other is promoted (``wgmma`` m64n64k32); ``stagger`` starts
  the second consumer warpgroup a stage after the first; ``stages5``
  deepens the ring to five stages.  Each must give the shipped bits.
- K12 at an activation (8192x2048), the head's weight (32768x2048) and a
  cotangent's e5m2 cast (8192x32768): ``reciprocal`` multiplies by
  fl(1 / s) and takes the quotient only within three fp32 steps of a
  code boundary (the same codes); ``runs8`` keeps 8 runs in flight a
  thread at 2 CTAs an SM; ``runs4`` 4 runs at 4 CTAs an SM.
- The robust phase's LM steps (fp8 + health, bf16 + health) in this
  process: the mean of 5 settled steps, the host's time to enqueue one
  step, one profiled step's device time by kernel group; and the host's
  time a call of the two wrappers takes.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import shutil
import sys
import time

import torch

from .. import _cuda
from .flash_parent import build_other, swapped, time_ms

__all__ = ["main"]

_WAIT1 = """__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
}
"""

_MAINLOOP = """      for (int it = 0; it < ktiles; ++it, ++g) {
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
"""

# one stage's products into P with wgmma template N (64 or 32 floats),
# committed as one group
_STAGE = """#define F8V_STAGE(P, G, N, H)                                              \\
  do {                                                                     \\
    const int s_ = (G) % kStages;                                          \\
    mbar_wait(full + 8 * s_, ((G) / kStages) & 1);                         \\
    fence_regs(P);                                                         \\
    wg_fence();                                                            \\
    _Pragma("unroll") for (int kk = 0; kk < kBK / 32; ++kk)                \\
      N<kA, kB>::run(P, desc_k(sA + s_ * kTileBytes, kBM, 64 * wg, kk),    \\
                     desc_k(sB + s_ * kTileBytes, kBN, 64 * (H), kk),      \\
                     kk > 0);                                              \\
    wg_commit();                                                           \\
  } while (0)
"""

_INFLIGHT = """      F8V_STAGE(part, g, Wgmma, 0);
      for (int it = 0; it < ktiles; ++it, ++g) {
        const bool more = it + 1 < ktiles;
        if (more) {
          if (it % 2 == 0) F8V_STAGE(part2, g + 1, Wgmma, 0);
          else F8V_STAGE(part, g + 1, Wgmma, 0);
          wg_wait1();
        } else {
          wg_wait0();
        }
        if (it % 2 == 0) {
          fence_regs(part);
          mbar_arrive(empty + 8 * (g % kStages));
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        } else {
          fence_regs(part2);
          mbar_arrive(empty + 8 * (g % kStages));
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part2[i]);
        }
      }
"""

_WGMMA64 = r"""template <int kA, int kB>
struct Wgmma64;
#define F8V_WGMMA64(A, B, TA, TB)                                          \
  template <>                                                              \
  struct Wgmma64<A, B> {                                                   \
    __device__ __forceinline__ static void run(float (&d)[32], uint64_t a, \
                                               uint64_t b, int scale_d) {  \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                     \
          "wgmma.mma_async.sync.aligned.m64n64k32.f32." TA "." TB " {"     \
          "%0, %1, %2, %3, %4, %5, %6, %7, "                               \
          "%8, %9, %10, %11, %12, %13, %14, %15, "                         \
          "%16, %17, %18, %19, %20, %21, %22, %23, "                       \
          "%24, %25, %26, %27, %28, %29, %30, %31"                         \
          "}, %32, %33, p, 1, 1;\n}\n"                                     \
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),    \
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),    \
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),            \
            "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),            \
            "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
            "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
            "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),            \
            "+f"(d[30]), "+f"(d[31])                                       \
          : "l"(a), "l"(b), "r"(scale_d));                                 \
    }                                                                      \
  };
F8V_WGMMA64(0, 0, "e4m3", "e4m3")
F8V_WGMMA64(0, 1, "e4m3", "e5m2")
F8V_WGMMA64(1, 0, "e5m2", "e4m3")
F8V_WGMMA64(1, 1, "e5m2", "e5m2")
"""

_HALVES = """      F8V_STAGE(pa, g, Wgmma64, 0);
      F8V_STAGE(pb, g, Wgmma64, 1);
      for (int it = 0; it < ktiles; ++it, ++g) {
        const bool more = it + 1 < ktiles;
        wg_wait1();
        fence_regs(pa);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], pa[i]);
        if (more) {
          F8V_STAGE(pa, g + 1, Wgmma64, 0);
          wg_wait1();
        } else {
          wg_wait0();
        }
        fence_regs(pb);
        mbar_arrive(empty + 8 * (g % kStages));
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[32 + i] = __fadd_rn(acc[32 + i], pb[i]);
        if (more) F8V_STAGE(pb, g + 1, Wgmma64, 1);
      }
"""

_STAGGER = """      for (int it = 0; it < ktiles; ++it, ++g) {
        if (g == 0 && wg == 1)
          asm volatile("bar.sync 3, 256;\\n" ::: "memory");
        const int s = g % kStages;"""

_ARRIVE_FIRST = """        for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        if (g == 0 && wg == 0)
          asm volatile("bar.arrive 3, 256;\\n" ::: "memory");
      }
"""

_RECIPROCAL = """template <int kKind>
__device__ __forceinline__ uint32_t encode_q_(float x0, float x1, float s);

template <int kKind>
__device__ __forceinline__ bool code_around(float p, uint32_t& code) {
  const uint32_t b = __float_as_uint(p);
  if ((b & 0x7FFFFFFFu) - 3u > 0x7F7FFFF9u) return false;
  const uint32_t lh = __nv_cvt_float2_to_fp8x2(
      make_float2(__uint_as_float(b - 3u), __uint_as_float(b + 3u)),
      __NV_SATFINITE, kKind == 0 ? __NV_E4M3 : __NV_E5M2);
  code = lh & 0xFFu;
  return code == (lh >> 8);
}

template <int kKind>
__device__ __forceinline__ uint32_t encode2(float x0, float x1, float s) {
  const float r = __frcp_rn(s);
  uint32_t c0, c1;
  if (((__float_as_uint(r) >> 23) & 0xFFu) - 1u < 254u &&
      code_around<kKind>(__fmul_rn(x0, r), c0) &&
      code_around<kKind>(__fmul_rn(x1, r), c1))
    return c0 | (c1 << 8);
  return encode_q_<kKind>(x0, x1, s);
}

template <int kKind>
__device__ __forceinline__ uint32_t encode_q_(float x0, float x1, float s) {"""


def _k11_variants(src):
    loop_at = src.index(_MAINLOOP)
    start = src.index("// epi: 2 = TMA store")
    staged = src[:start] + _STAGE + src[start:]
    out = {}
    v = staged.replace("    float acc[64], part[64];",
                      "    float acc[64], part[64], part2[64];")
    out["inflight"] = _patch(v, _MAINLOOP, _INFLIGHT).replace(
        "__device__ __forceinline__ void st_shared_u32(",
        _WAIT1 + "__device__ __forceinline__ void st_shared_u32(", 1)
    v = staged.replace("    float acc[64], part[64];",
                      "    float acc[64], pa[32], pb[32];")
    v = v.replace("// A 2-D map over (rows, cols)", _WGMMA64 +
                  "\n// A 2-D map over (rows, cols)", 1)
    out["halves"] = _patch(v, _MAINLOOP, _HALVES).replace(
        "__device__ __forceinline__ void st_shared_u32(",
        _WAIT1 + "__device__ __forceinline__ void st_shared_u32(", 1)
    head = "      for (int it = 0; it < ktiles; ++it, ++g) {\n" \
           "        const int s = g % kStages;"
    tail = ("        for (int i = 0; i < 64; ++i) acc[i] = "
            "__fadd_rn(acc[i], part[i]);\n      }\n")
    v = src[:loop_at] + _patch(_patch(_MAINLOOP, head, _STAGGER), tail,
                               _ARRIVE_FIRST) + src[loop_at + len(_MAINLOOP):]
    out["stagger"] = v
    out["stages5"] = _patch(src, "constexpr int kStages = 4;",
                            "constexpr int kStages = 5;")
    return out


def _k12_variants(src):
    out = {}
    # the shipped encode2 becomes the fallback encode_q
    v = _patch(src, "template <int kKind>\n__device__ __forceinline__ "
               "uint32_t encode2(float x0, float x1, float s) {",
               _RECIPROCAL)
    out["reciprocal"] = v
    out["runs8"] = _patch(_patch(src, "constexpr int kBatch = 2;",
                                 "constexpr int kBatch = 8;"),
                          "constexpr int kCtasPerSm = 8;",
                          "constexpr int kCtasPerSm = 2;")
    out["runs4"] = _patch(_patch(src, "constexpr int kBatch = 2;",
                                 "constexpr int kBatch = 4;"),
                          "constexpr int kCtasPerSm = 8;",
                          "constexpr int kCtasPerSm = 4;")
    return out


def _patch(text, old, new):
    if old not in text:
        raise RuntimeError("fp8_variants: the shipped source lacks %r"
                           % old[:60])
    return text.replace(old, new, 1)


def _build(stem, kernel, variants):
    root = os.path.join(_cuda.BUILD_ROOT, os.pardir, "fp8_variants")

    def one(item):
        name, text = item
        tree = os.path.join(root, name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(_cuda.CSRC, os.path.join(tree, "mxnet_tpu_torch",
                                                 "csrc"))
        with open(os.path.join(tree, "mxnet_tpu_torch", "csrc",
                               stem + ".cu"), "w") as f:
            f.write(text)
        try:
            return name, build_other(tree, (kernel,), "fp8_variants_" + name)
        except RuntimeError as e:  # a variant that fails to build is left out
            _emit(dict(kernel=kernel, variant=name,
                       build_error=str(e)[-3000:]))
            return name, None
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        return {n: e for n, e in pool.map(one, variants.items()) if e}


def _emit(row):
    print(json.dumps(row), flush=True)


def _compare(kernel, case, fn, builds, bits):
    mine = bits(fn())
    row = dict(kernel=kernel, case=case, shipped_ms=time_ms(fn))
    for name, entries in builds.items():
        with swapped(entries):
            got = bits(fn())
            row[name + "_ms"] = time_ms(fn)
        row[name + "_bit_identical"] = all(
            (a is None and b is None) or torch.equal(a, b)
            for a, b in zip(got, mine))
    row["shipped_ms_again"] = time_ms(fn)
    _emit(row)


def _steps(cs):
    from ..ops import fp8_ops as F8

    dev = torch.device("cuda")
    cfg = cs.train_config()
    for fp8 in (True, False):
        step, state, data = cs.robust_step(dev, cfg, 8, fp8, True)
        t = [0]

        def one():
            t[0] += 1
            state[:3] = step(*state, data, None, t=t[0])[:3]
        for _ in range(4):
            one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            one()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 5
        t0 = time.perf_counter()
        one()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        prof = cs.profiled_window(one, cs.FP8_STEP_GROUPS)
        _emit(dict(case="lm-step-%s-health" % ("fp8" if fp8 else "bf16"),
                   step_ms=step_ms, host_enqueue_ms=enqueue_ms,
                   device_busy_ms=prof["device_busy_ms"],
                   device_ms_by_group=prof["device_ms_by_group"]))
        del step, state, data
        torch.cuda.empty_cache()
    x = torch.randn(8192, 2048, device=dev).bfloat16()
    s = torch.full((), 1e-3, device=dev)
    c = F8.fp8_cast(x, s, F8.E4M3, transposed=True)[0]
    for name, fn in (("fp8_cast", lambda: F8.fp8_cast(
            x, s, F8.E4M3, transposed=True)), ("fp8_gemm", lambda: F8.fp8_gemm(
                c, c[:2048], F8.E4M3, F8.E4M3, s, s, torch.bfloat16))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        _emit(dict(case="wrapper-host", kernel=name, host_us_a_call=host_us))


def main():
    # chip_smoke.py (the checkout's root) holds the cases and the step
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import chip_smoke as cs
    from ..ops import fp8_ops as F8

    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build()
    with open(os.path.join(_cuda.CSRC, "fp8_gemm.cu")) as f:
        k11 = _build("fp8_gemm", "fp8_gemm", _k11_variants(f.read()))
    with open(os.path.join(_cuda.CSRC, "fp8_cast.cu")) as f:
        k12 = _build("fp8_cast", "fp8_cast", _k12_variants(f.read()))
    _emit({"card": torch.cuda.get_device_name(0)})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    for case, rows, cols, kind, what in cs.FP8_CAST_CASES:
        if case not in ("x-8192x2048-bf16-e4m3", "w-32768x2048-bf16-e4m3",
                        "g-8192x32768-bf16-e5m2"):
            continue
        x = (torch.randn((rows, cols), generator=gen, device="cuda")
             * 0.05).bfloat16()
        s = torch.full((), 1e-3, device="cuda")
        kw = cs.FP8_CAST_OUTPUTS[what]
        _compare("fp8_cast", case, lambda: F8.fp8_cast(x, s, kind, **kw),
                 k12, lambda outs: [o.view(torch.int32) if o is not None
                                    and o.dtype == torch.float32 else o
                                    for o in outs])
        del x
    for case, a, b, ka, kb, sa, sb in cs.fp8_gemm_cases("cuda", gen):
        if not (case.endswith("F6144") or case == "dx-M8192-C2048-F32768"):
            continue
        _compare("fp8_gemm", case, lambda: F8.fp8_gemm(
            a, b, ka, kb, sa, sb, torch.bfloat16), k11, lambda o: [o])
    torch.cuda.empty_cache()
    with contextlib.suppress(KeyboardInterrupt):
        _steps(cs)


if __name__ == "__main__":
    main()
