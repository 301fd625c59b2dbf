"""K3 and K3q at decode (M = 8 rows) under other blockings of their
streaming kernel, and with either form of its bulk-copy issue.

Run on a card from the repository's root::

    python -m mxnet_tpu_torch.testing.k3q_variants

It copies ``csrc/`` under ``build/k3q_variants/``, patches
``linear.cu`` so that an exported setter can force the streaming
kernel's blocking (features G and rows R a thread, the stage width in
columns, and the CTAs a SM its ring is sized for), and builds one
library a form of the copy issue with the exact build's flags (one nvcc
each, all at once):

- ``select`` (the shipped form): every lane of warp 0 picks its source
  (a weight row or an x row), destination and size, then issues one
  copy;
- ``branch``: weight lanes and x lanes issue their copies in two
  branches.

For serving's five projection shapes it prints each variant's mean
CUDA-event time with L2 flushed and the window opened behind a device
spin, as chip_smoke times kernels, and checks that every variant gives
the shipped kernel's bits (a blocking moves no output's chain).
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

SHAPES = ((6144, 2048), (2048, 2048), (8192, 2048), (2048, 8192),
          (32768, 2048))
ROWS = 8
# (G, R) a thread; stage widths in columns; CTAs a SM the ring is sized
# for (0: the shipped rule)
BLOCKINGS = ((1, 1), (1, 2), (2, 1), (2, 2))
COLS = (256, 512, 1024, 2048)
PER_SM = (0, 4)
FORMS = {"select": 1, "branch": 2}

_COPY_FORMS = """#if K3QV_FORM == 1
    if (lane < nf + M) {
      const bool is_w = lane < nf;
      const void* src =
          is_w ? static_cast<const void*>(w + static_cast<size_t>(f0 + lane) * C + c0)
               : static_cast<const void*>(x + static_cast<size_t>(lane - nf) * C + c0);
      unsigned char* dst =
          st + (is_w ? lane * wpitch : kSlab * wpitch + (lane - nf) * xpitch);
      mxt90::bulk_load(mxt90::smem_u32(dst), src, n * (is_w ? kEB : 4), bar);
    }
#else
    if (lane < nf) {
      mxt90::bulk_load(mxt90::smem_u32(st + lane * wpitch),
                       w + static_cast<size_t>(f0 + lane) * C + c0,
                       n * kEB, bar);
    } else if (lane < nf + M) {
      const int m = lane - nf;
      mxt90::bulk_load(mxt90::smem_u32(st + kSlab * wpitch + m * xpitch),
                       x + static_cast<size_t>(m) * C + c0, n * 4, bar);
    }
#endif
  };
"""
_KNOBS = """static int k3qv_g = 0, k3qv_r = 0, k3qv_cols = 0, k3qv_per_sm = 0;
extern "C" void k3qv_set(int g, int r, int cols, int per_sm) {
  k3qv_g = g;
  k3qv_r = r;
  k3qv_cols = cols;
  k3qv_per_sm = per_sm;
}
"""
_FORCED = """  const int per_sm = min((ctas + sms - 1) / sms, 4);
  if (k3qv_g) {
    const int p = k3qv_per_sm ? k3qv_per_sm : per_sm;
    const int c = k3qv_cols;
    if (k3qv_g == 1 && k3qv_r == 1)
      return launch_stream<kCode, 1, 1>(x, w, scales, bias, y, M, F, C, c,
                                        p, stream);
    if (k3qv_g == 1)
      return launch_stream<kCode, 1, 2>(x, w, scales, bias, y, M, F, C, c,
                                        p, stream);
    if (k3qv_r == 1)
      return launch_stream<kCode, 2, 1>(x, w, scales, bias, y, M, F, C, c,
                                        p, stream);
    return launch_stream<kCode, 2, 2>(x, w, scales, bias, y, M, F, C, c, p,
                                      stream);
  }
"""


def _cut(s, start, end):
    """``s`` without the text from ``start`` up to, not including,
    ``end``; each must occur once."""
    i, j = s.find(start), s.find(end)
    if s.count(start) != 1 or s.count(end) != 1 or j < i:
        raise RuntimeError("k3q_variants: linear.cu no longer has %r ... %r"
                           % (start, end))
    return s[:i], s[j:]


def _patched_source(out_dir):
    """``linear.cu`` with the blocking forced by ``k3qv_set`` and the
    copy issue's form a macro, in a copy of csrc."""
    src_dir = os.path.join(out_dir, "csrc")
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src_dir)
    path = os.path.join(src_dir, "linear.cu")
    with open(path) as f:
        s = f.read()
    head, tail = _cut(s, "    __syncwarp();\n", "  if (v == 0)\n")
    s = head + "    __syncwarp();\n" + _COPY_FORMS + tail
    head, tail = _cut(s, "  const int per_sm = min((ctas + sms - 1) / sms, 4);\n",
                      "  if (per_sm == 1)\n")
    s = head + _FORCED + tail
    anchor = '#include "sm90.cuh"\n'
    if s.count(anchor) != 1:
        raise RuntimeError("k3q_variants: linear.cu no longer has %r"
                           % anchor)
    s = s.replace(anchor, anchor + _KNOBS)
    with open(path, "w") as f:
        f.write(s)
    return path


def _build(path, out_dir):
    nvcc = _cuda._nvcc()
    procs = {}
    for name, form in FORMS.items():
        lib = os.path.join(out_dir, "lib_%s.so" % name)
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, "-DK3QV_FORM=%d" % form, "-o", lib,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("k3q_variants: %s failed to build:\n%s"
                               % (name, log))
        dll = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        dll.mxt_linear.argtypes = (p, p, p, p, i, i, i, p)
        dll.mxt_linear_q.argtypes = (p, p, p, p, p, i, i, i, i, p)
        dll.k3qv_set.argtypes = (i, i, i, i)
        libs[name] = dll
    return libs


def main():
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out_dir = os.path.join(here, "build", "k3q_variants")
    os.makedirs(out_dir, exist_ok=True)
    libs = _build(_patched_source(out_dir), out_dir)
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

    rs = np.random.RandomState(3)
    stream = torch.cuda.current_stream().cuda_stream
    for f, c in SHAPES:
        x = torch.from_numpy(rs.randn(ROWS, c).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rs.randn(f).astype(np.float32)).to(dev)
        scales = torch.from_numpy(
            rs.uniform(1e-3, 1e-2, f).astype(np.float32)).to(dev)
        codes = rs.randint(0, 256, size=(f, c)).astype(np.uint8)
        codes[(codes & 0x7F) == 0x7F] = 0  # no e4m3 NaN codes
        codes = torch.from_numpy(codes).to(dev)
        w = torch.from_numpy(rs.randn(f, c).astype(np.float32)).to(dev)
        y = torch.empty(ROWS, f, device=dev)
        for kind in ("fp32", "int8", "e4m3"):
            def run(lib):
                if kind == "fp32":
                    rc = lib.mxt_linear(x.data_ptr(), w.data_ptr(),
                                        bias.data_ptr(), y.data_ptr(), ROWS,
                                        f, c, stream)
                else:
                    rc = lib.mxt_linear_q(
                        x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                        bias.data_ptr(), y.data_ptr(), ROWS, f, c,
                        int(kind == "e4m3"), stream)
                if rc:
                    raise RuntimeError("k3q_variants: launch returned %d"
                                       % rc)

            label = "%s M%d F%d C%d" % (kind, ROWS, f, c)
            ref = None
            for form, lib in libs.items():
                lib.k3qv_set(0, 0, 0, 0)
                ms = timed(lambda: run(lib))
                if ref is None:
                    ref = y.clone()
                elif not torch.equal(y, ref):
                    raise AssertionError("k3q_variants: %s %s changed the "
                                         "bits" % (label, form))
                print("%-24s shipped rule, %-6s issue: %.4f ms"
                      % (label, form, ms), flush=True)
            for form, lib in libs.items():
                for g, r in BLOCKINGS:
                    for cols in COLS:
                        for per_sm in PER_SM:
                            lib.k3qv_set(g, r, cols, per_sm)
                            ms = timed(lambda: run(lib))
                            if not torch.equal(y, ref):
                                raise AssertionError(
                                    "k3q_variants: %s G%d R%d changed the "
                                    "bits" % (label, g, r))
                            print("%-24s G%d R%d cols %4d ring for %s a SM, "
                                  "%-6s issue: %.4f ms"
                                  % (label, g, r, cols,
                                     per_sm or "the launch's CTAs", form,
                                     ms), flush=True)
                lib.k3qv_set(0, 0, 0, 0)


if __name__ == "__main__":
    main()
