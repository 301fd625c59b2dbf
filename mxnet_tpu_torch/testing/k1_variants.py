"""Where K1's time goes: ``csrc/flash_attention.cu`` timed with parts of
its work removed, and at other tilings.

Run on a card from the repository's root::

    python -m mxnet_tpu_torch.testing.k1_variants

It copies ``csrc/`` under ``build/k1_variants/``, turns the kernel's
knobs (in ``flash_attention.cu`` and the tile it shares with K2's
prefill, ``flash_tile.cuh``) into macros by exact string patches
(which raise if the kernel no longer has the patched text), builds one
library a variant with the exact build's flags (one nvcc each, all at
once; D = 128 only), and prints each
variant's mean CUDA-event time with L2 flushed and the window opened
behind a device spin, as chip_smoke times kernels, at the training shape
(n1 h16 T1024 D128 causal, blocks 16 and 128) and the oracle's (T256,
block 16).

- Ablation (the answers are wrong; only the times count): without the
  score tiles (every score 0), without the row pass (block maxima,
  rescale, probabilities, sums), without P.V, and with none of the three
  (the staging of q, K and V, the barriers and the stores).
- Tiling and scheduling: query rows a CTA (16, 32 or 64, or the shipped
  rule), the register cap that
  lets two CTAs of 32 rows share an SM (and the same cap on 16-row
  tiles, which spills), the keys a group scores before it sums (64 or
  128), and the unrolling of the score tree (all of it, or no leaf
  loop).  Every such variant must give the shipped variant's bits: a
  row's operations do not depend on them.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

import torch

from .. import _cuda

__all__ = ["main"]

SHIPPED = ()
ABLATIONS = {
    "no_scores": ("-DK1V_SCORES=0",),
    "no_row_pass": ("-DK1V_ROWS=0",),
    "no_pv": ("-DK1V_PV=0",),
    "staging_only": ("-DK1V_SCORES=0", "-DK1V_ROWS=0", "-DK1V_PV=0"),
}
TILINGS = {
    "rows16": ("-DK1V_RM=2",),
    "rows32": ("-DK1V_RM=4",),
    "rows64": ("-DK1V_RM=8",),
    "rows32_one_cta": ("-DK1V_MINB=1",),
    "rows16_capped": ("-DK1V_MINB2=2",),
    "group64": ("-DK1V_GROUP=64",),
    "unroll_tree": ("-DK1V_UNROLL_A=1",),
    "leaf_loop": ("-DK1V_LEAF_LOOP=1",),
}
_RULE = ("  if (static_cast<long long>(p.n_bh) * ((p.T + 31) / 32) >= "
         "2LL * sms)\n")
_PATCHES = (
    ("DPL <= 4 && RM == 4 ? 2 : 1)",
     "DPL <= 4 ? (RM == 2 ? K1V_MINB2 : K1V_MINB) : 1)"),
    ("#pragma unroll\n  for (int i = 0; i < DPL; ++i) {\n"
     "    const int d = l + kWarp * i;",
     "#if K1V_LEAF_LOOP\n#pragma unroll 1\n#else\n#pragma unroll\n#endif\n"
     "  for (int i = 0; i < DPL; ++i) {\n    const int d = l + kWarp * i;"),
    ("      tile_scores<DPL, SR>(s, qt + ty * SR, kv + tc * 4, TQP);\n",
     "      if (K1V_SCORES) {\n"
     "      tile_scores<DPL, SR>(s, qt + ty * SR, kv + tc * 4, TQP);\n"
     "      } else {\n"
     "#pragma unroll\n"
     "        for (int r = 0; r < SR; ++r)\n"
     "#pragma unroll\n"
     "          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;\n"
     "      }\n"),
    ("    for (int pi = lane; pi < RM * nb; pi += kWarp) {\n"
     "      const int row = warp * RM + pi % RM, b = pi / RM;\n"
     "      const float* sr",
     "    for (int pi = lane; pi < (K1V_ROWS ? RM * nb : 0); pi += kWarp) {\n"
     "      const int row = warp * RM + pi % RM, b = pi / RM;\n"
     "      const float* sr"),
    ("      for (int b = 0; b < nb; ++b) {\n"
     "        const mxt::Rescale rs",
     "      for (int b = 0; b < (K1V_ROWS ? nb : 0); ++b) {\n"
     "        const mxt::Rescale rs"),
    ("      for (int j = lane; j < n_g; j += kWarp) {\n"
     "        const float x = sr[j];",
     "      for (int j = lane; j < (K1V_ROWS ? n_g : 0); j += kWarp) {\n"
     "        const float x = sr[j];"),
    ("    for (int pi = lane; pi < RM * nb; pi += kWarp) {\n"
     "      const int row = warp * RM + pi % RM, b = pi / RM;\n"
     "      float psum",
     "    for (int pi = lane; pi < (K1V_ROWS ? RM * nb : 0); pi += kWarp) {\n"
     "      const int row = warp * RM + pi % RM, b = pi / RM;\n"
     "      float psum"),
    ("        const int seg = min(left, nk - jj);\n",
     "        const int seg = K1V_PV ? min(left, nk - jj) : nk - jj;\n"),
    ("        if (finite) {\n          for (int t = 0; t < seg; ++t) {",
     "        if (!K1V_PV) {\n        } else if (finite) {\n"
     "          for (int t = 0; t < seg; ++t) {"),
    ("#pragma unroll 1\n  for (int a = 0; a < 8; ++a) {",
     "#if K1V_UNROLL_A\n#pragma unroll\n#else\n#pragma unroll 1\n#endif\n"
     "  for (int a = 0; a < 8; ++a) {"),
    ("constexpr int kGroup = 128;", "constexpr int kGroup = K1V_GROUP;"),
    # a block longer than a smaller group makes a group of its own
    ("const int group = block * (kGroup / block);",
     "const int group = block * max(1, kGroup / block);"),
    # every case is D = 128: build only its instantiations
    ("  if (D <= 32) return launch_rows<1>(p, st);\n"
     "  if (D <= 64) return launch_rows<2>(p, st);\n"
     "  if (D <= 128) return launch_rows<4>(p, st);\n"
     "  return launch_rows<8>(p, st);",
     "  return D == 128 ? launch_rows<4>(p, st)\n"
     "                  : static_cast<int>(cudaErrorInvalidValue);"),
    (_RULE,
     "  if (K1V_RM == 2) return launch<DPL, 2>(p, stream);\n"
     "  if (K1V_RM == 4) return launch<DPL, 4>(p, stream);\n"
     "  if (K1V_RM == 8 && DPL <= 4) return launch<DPL, (DPL <= 4 ? 8 : 4)>"
     "(p, stream);\n" + _RULE),
)
_DEFAULTS = """#ifndef K1V_MINB
#define K1V_MINB 2
#endif
#ifndef K1V_MINB2
#define K1V_MINB2 1
#endif
#ifndef K1V_LEAF_LOOP
#define K1V_LEAF_LOOP 0
#endif
#ifndef K1V_SCORES
#define K1V_SCORES 1
#endif
#ifndef K1V_ROWS
#define K1V_ROWS 1
#endif
#ifndef K1V_PV
#define K1V_PV 1
#endif
#ifndef K1V_GROUP
#define K1V_GROUP 128
#endif
#ifndef K1V_RM
#define K1V_RM 0
#endif
#ifndef K1V_UNROLL_A
#define K1V_UNROLL_A 0
#endif
"""
CASES = ((1, 16, 1024, 128, 16), (1, 16, 1024, 128, 128),
         (1, 16, 256, 128, 16))


def _patched_source(out_dir):
    """``flash_attention.cu`` with each knob a macro, in a copy of csrc
    (the kernel's body lives in ``flash_tile.cuh``, patched too)."""
    src_dir = os.path.join(out_dir, "csrc")
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src_dir)
    texts = {}
    for name in ("flash_attention.cu", "flash_tile.cuh"):
        with open(os.path.join(src_dir, name)) as f:
            texts[name] = f.read()
    for old, new in _PATCHES:
        where = [n for n, t in texts.items() if t.count(old) == 1]
        if len(where) != 1 or sum(t.count(old) for t in texts.values()) != 1:
            raise RuntimeError("k1_variants: the kernel no longer has %r"
                               % old)
        texts[where[0]] = texts[where[0]].replace(old, new)
    anchor = '#include "online_softmax.cuh"\n'
    if texts["flash_tile.cuh"].count(anchor) != 1:
        raise RuntimeError("k1_variants: flash_tile.cuh no longer has %r"
                           % anchor)
    texts["flash_tile.cuh"] = texts["flash_tile.cuh"].replace(
        anchor, anchor + _DEFAULTS)
    for name, text in texts.items():
        with open(os.path.join(src_dir, name), "w") as f:
            f.write(text)
    return os.path.join(src_dir, "flash_attention.cu")


def _build(path, variants, out_dir):
    nvcc = _cuda._nvcc()
    procs = {}
    for name, defines in variants.items():
        lib = os.path.join(out_dir, "lib_%s.so" % name)
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, "-Xptxas", "-v", *defines, "-o", lib,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    entries = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("k1_variants: %s failed to build:\n%s"
                               % (name, log))
        spills = {}
        name_ = None
        for ln in log.splitlines():
            m = re.search(r"entry function '\S*flash_forward_kernelILi(\d)ELi"
                          r"(\d)E", ln)
            if m:
                name_ = "<%s,%s>" % m.groups()
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m and name_:
                spills[name_] = int(m.group(1))
        fn = ctypes.CDLL(lib).mxt_flash_attention_forward
        fn.argtypes = list(_cuda.KERNELS["flash_attention"][2])
        fn.restype = ctypes.c_int
        entries[name] = (fn, spills)
    return entries


def main():
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out_dir = os.path.join(here, "build", "k1_variants")
    os.makedirs(out_dir, exist_ok=True)
    path = _patched_source(out_dir)
    variants = {"shipped": SHIPPED, **ABLATIONS, **TILINGS}
    entries = _build(path, variants, out_dir)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def timed(call, reps=30):
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

    print("spill bytes by kernel <DPL,RM>")
    for name, (_, spills) in entries.items():
        print("  %-20s %s" % (name, spills))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for n, h, t, d, block in CASES:
        q, k, v = (torch.randn(n * h, t, d, generator=gen, device=dev)
                   for _ in range(3))
        print("n%d-h%d-T%d-D%d-causal-b%d (ms)" % (n, h, t, d, block))
        ref = None
        for name, (fn, _) in entries.items():
            out = torch.empty_like(q)
            lse = torch.empty(n * h, t, device=dev)

            def call():
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), n * h, t, d,
                        d ** -0.5, 1, block,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError("k1_variants: %s returned %d"
                                       % (name, rc))

            ms = timed(call)
            if ref is None:
                ref, bits = (out.clone(), lse.clone()), "shipped"
            elif name in ABLATIONS:
                bits = "(ablation)"
            else:
                bits = ("bit-equal" if torch.equal(out, ref[0])
                        and torch.equal(lse, ref[1]) else "DIFFERENT")
            print("  %-20s %.4f  %s" % (name, ms, bits))
            if bits == "DIFFERENT":
                raise AssertionError("k1_variants: %s changed the bits"
                                     % name)


if __name__ == "__main__":
    main()
