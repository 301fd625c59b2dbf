"""Where K2's decode time goes: the one-row-a-CTA kernel of
``csrc/paged_attention.cu`` timed with parts of its work removed.  (Its
prefill and verify rows run K1's tile, ``csrc/flash_tile.cuh``, which
``k1_variants`` takes apart.)

Run on a card from the repository's root::

    python -m mxnet_tpu_torch.testing.k2_variants

It copies ``csrc/`` under ``build/k2_variants/``, builds one library a
variant there with the exact build's flags (one nvcc each, all at once),
and prints, for serving's geometry (pages of 16, 16 heads, D = 128), each
variant's mean CUDA-event time with L2 flushed and the window opened
behind a device spin, as chip_smoke times kernels.

Ablation (the answers are wrong; only the times count): without the
score butterfly; without the score dots (a visible key scores 0, so the
sums still run); without the per-page probability and value sums;
without the fold; and the loads alone.  Where a variant drops the use of
a loaded slice, one sum of the slice a warp keeps its loads.  At decode:
8 slots of 18 pages, the last slot idle.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

from .. import _cuda

__all__ = ["main"]

ABLATIONS = {
    "full": (),
    "no_butterfly": ("-DK2V_NO_BUTTERFLY",),
    "no_score_dots": ("-DK2V_SCORES=0",),
    "no_sums": ("-DK2V_SUMS=0",),
    "no_fold": ("-DK2V_FOLD=0",),
    "loads_only": ("-DK2V_SCORES=0", "-DK2V_SUMS=0", "-DK2V_FOLD=0"),
}
_PATCHES = (
    ("mxt::warp_sum(mxt::lane_dot(", "K2V_SUM(mxt::lane_dot("),
    ("load_keys<kCode>(kr, kp + kc * key_stride, kCode ? ks + kc : nullptr,\n"
     "                         key_stride,\n"
     "                         min(kKeys, min(page, hmax - start) - kc), D, "
     "lane);\n",
     "load_keys<kCode>(kr, kp + kc * key_stride, kCode ? ks + kc : nullptr,\n"
     "                         key_stride,\n"
     "                         min(kKeys, min(page, hmax - start) - kc), D, "
     "lane);\n"
     "        const float k2v_k = K2V_SCORES ? 0.f : k2v_sum(kr);\n"),
    ("          if (vis > 0) {\n            float qv[DPL];",
     "          if (!K2V_SCORES && vis > 0)\n"
     "            mine = lane < vis && lane < kKeys ? 0.f * k2v_k : -INFINITY;\n"
     "          if (K2V_SCORES && vis > 0) {\n            float qv[DPL];"),
    ("load_keys<kCode>(vr, vp + kc * key_stride, kCode ? vs + kc : nullptr,\n"
     "                         key_stride,\n"
     "                         min(kKeys, min(page, hmax - start) - kc), D, "
     "lane);\n"
     "        for (int r = 0; r < rows; ++r) {\n",
     "load_keys<kCode>(vr, vp + kc * key_stride, kCode ? vs + kc : nullptr,\n"
     "                         key_stride,\n"
     "                         min(kKeys, min(page, hmax - start) - kc), D, "
     "lane);\n"
     "        if (!K2V_SUMS && k2v_sum(vr) == 1.25f) pv[lane] = 0.f;\n"
     "        for (int r = 0; r < (K2V_SUMS ? rows : 0); ++r) {\n"),
    ("for (int bl = 0; bl < nb; ++bl)\n        a = mxt::fold",
     "for (int bl = 0; bl < (K2V_FOLD ? nb : 0); ++bl)\n        a = mxt::fold"),
)
_DEFAULTS = """#ifdef K2V_NO_BUTTERFLY
#define K2V_SUM(x) (x)
#else
#define K2V_SUM(x) mxt::warp_sum(x)
#endif
#ifndef K2V_SCORES
#define K2V_SCORES 1
#endif
#ifndef K2V_SUMS
#define K2V_SUMS 1
#endif
#ifndef K2V_FOLD
#define K2V_FOLD 1
#endif
template <int N, int M>
__device__ __forceinline__ float k2v_sum(const float (&r)[N][M]) {
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < M; ++i) t += r[j][i];
  return t;
}
"""


def _patched_source(out_dir):
    """``paged_attention.cu`` with each knob a macro, in a copy of csrc."""
    src_dir = os.path.join(out_dir, "csrc")
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src_dir)
    path = os.path.join(src_dir, "paged_attention.cu")
    with open(path) as f:
        s = f.read()
    for old, new in _PATCHES:
        if s.count(old) != 1:
            raise RuntimeError("k2_variants: the kernel no longer has %r"
                               % old)
        s = s.replace(old, new)
    s = s.replace('#include "per_device.cuh"\n',
                  '#include "per_device.cuh"\n' + _DEFAULTS)
    with open(path, "w") as f:
        f.write(s)
    return path


def _build(path, variants, out_dir):
    nvcc = _cuda._nvcc()
    procs = {}
    for name, defines in variants.items():
        lib = os.path.join(out_dir, "lib_%s.so" % name)
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, *defines, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("k2_variants: %s failed to build:\n%s"
                               % (name, log))
        fn = ctypes.CDLL(lib).mxt_paged_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        entries[name] = fn
    return entries


def main():
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out_dir = os.path.join(here, "build", "k2_variants")
    os.makedirs(out_dir, exist_ok=True)
    path = _patched_source(out_dir)
    entries = _build(path, ABLATIONS, out_dir)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def timed(call, reps=50):
        call()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    page, h, d = 16, 16, 128

    def case(slots, max_pages):
        """Pools, table, lengths and queries of a decode step: random
        lengths, the last slot idle (chip_smoke's tables and lengths at 8
        slots of 18 pages)."""
        rs = np.random.RandomState(5)
        pools = [torch.randn(slots * max_pages + 1, page, h, d,
                             generator=gen, device=dev) for _ in range(2)]
        tab = torch.from_numpy(rs.permutation(slots * max_pages).reshape(
            slots, max_pages).astype(np.int32)).to(dev)
        lens = rs.randint(24, max_pages * page + 1, size=slots)
        lens[-1] = 0
        hor = torch.from_numpy(lens.astype(np.int32)).to(dev)
        q = torch.randn(slots, h, 1, d, generator=gen, device=dev)
        return pools, tab, hor, q

    def run(fn, pools, tab, hor, q, out):
        slots, _, q_rows, _ = q.shape
        rc = fn(q.data_ptr(), pools[0].data_ptr(), pools[1].data_ptr(),
                tab.data_ptr(), hor.data_ptr(), out.data_ptr(), slots, h,
                q_rows, d, page, tab.shape[1], int(hor.dim() == 2),
                d ** -0.5, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("k2_variants: launch returned %d" % rc)

    print("ablation (ms)")
    pools, tab, hor, q = case(8, 18)
    out = torch.empty_like(q)
    for name in ABLATIONS:
        ms = timed(lambda: run(entries[name], pools, tab, hor, q, out))
        print("  decode-S8-Q1  %-14s %.4f" % (name, ms))


if __name__ == "__main__":
    main()
