"""K3 and K3q above 16 rows: every candidate tiling of the ring kernel
(``csrc/linear.cu``), the tiled kernel it replaced there, the shipped
rule and ``F.linear``, at the sizes that set the rule.

Run on a card from the repository's root::

    python -m mxnet_tpu_torch.testing.k3_tiles [--out FILE]

It builds ``testing/k3_tiles.cu`` (which includes ``csrc/linear.cu``)
once a weight type (fp32, int8, e4m3: one nvcc each, all at once, with
the exact build's flags, under ``build/k3_tiles/``).  For M in 17, 24,
40, 48, 64, 128 and 256 rows at serving's five projection shapes it
prints one JSON line a (type, M, shape): each candidate's mean
CUDA-event time (L2 flushed, the window opened behind a device spin, as
chip_smoke times kernels), the tiled kernel's, the shipped rule's and
``F.linear``'s over the (dequantized) fp32 weight.  Every candidate and
the rule must give the tiled kernel's bits: a tiling moves no output's
chain.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from .. import _cuda
from .flash_parent import time_ms

__all__ = ["build", "main"]

ROWS = (17, 24, 40, 48, 64, 128, 256)
SHAPES = ((6144, 2048), (2048, 2048), (8192, 2048), (2048, 8192),
          (32768, 2048))
KINDS = ("fp32", "int8", "e4m3")


def build():
    """{kind: library} of ``k3_tiles.cu`` built for each weight type."""
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(_cuda.BUILD_ROOT, os.pardir, "k3_tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for code, kind in enumerate(KINDS):
        lib = os.path.join(out_dir, "lib_%s.so" % kind)
        procs[kind] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.nvcc_flags("linear"),
             "-DK3T_CODE=%d" % code, "-o", lib,
             os.path.join(here, "k3_tiles.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for kind, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("k3_tiles: %s failed to build:\n%s"
                               % (kind, log))
        dll = ctypes.CDLL(lib)
        dll.k3t_launch.argtypes = (i, p, p, p, p, p, i, i, i, p)
        dll.k3t_name.restype = ctypes.c_char_p
        dll.mxt_linear.argtypes = (p, p, p, p, i, i, i, p)
        dll.mxt_linear_q.argtypes = (p, p, p, p, p, i, i, i, i, p)
        libs[kind] = (dll, log)
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the lines to this file")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)))
    args = ap.parse_args(argv)
    rows = [int(r) for r in args.rows.split(",")]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build()
    out = open(args.out, "w") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit(dict(card=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()))
    for kind, (_, log) in libs.items():
        emit(dict(kind=kind, ptxas=[ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln]))
    rs = np.random.RandomState(3)
    stream = torch.cuda.current_stream().cuda_stream
    for f, c in SHAPES:
        x_all = torch.from_numpy(rs.randn(max(rows), c).astype(
            np.float32)).to(dev)
        bias = torch.from_numpy(0.02 * rs.randn(f).astype(np.float32)).to(dev)
        w = torch.from_numpy(0.02 * rs.randn(f, c).astype(np.float32)).to(dev)
        scales = torch.from_numpy(
            rs.uniform(1e-3, 1e-2, f).astype(np.float32)).to(dev)
        codes = rs.randint(0, 256, size=(f, c)).astype(np.uint8)
        codes[(codes & 0x7F) == 0x7F] = 0  # no e4m3 NaN codes
        codes = torch.from_numpy(codes).to(dev)
        for kind, (lib, _) in libs.items():
            wt = w if kind == "fp32" else codes
            sp = None if kind == "fp32" else scales.data_ptr()
            for m in rows:
                x = x_all[:m].contiguous()
                y = torch.empty(m, f, device=dev)

                def cand(i):
                    rc = lib.k3t_launch(i, x.data_ptr(), wt.data_ptr(), sp,
                                        bias.data_ptr(), y.data_ptr(), m, f,
                                        c, stream)
                    if rc:
                        raise RuntimeError("k3_tiles: launch returned %d"
                                           % rc)

                def shipped():
                    if kind == "fp32":
                        rc = lib.mxt_linear(x.data_ptr(), wt.data_ptr(),
                                            bias.data_ptr(), y.data_ptr(), m,
                                            f, c, stream)
                    else:
                        rc = lib.mxt_linear_q(
                            x.data_ptr(), wt.data_ptr(), sp, bias.data_ptr(),
                            y.data_ptr(), m, f, c, int(kind == "e4m3"),
                            stream)
                    if rc:
                        raise RuntimeError("k3_tiles: launch returned %d"
                                           % rc)

                cand(-1)
                ref = y.clone()
                row = dict(kind=kind, M=m, F=f, C=c,
                           tiled_ms=time_ms(lambda: cand(-1), 100.0))
                shipped()
                if not torch.equal(y, ref):
                    raise AssertionError("k3_tiles: the shipped rule moved "
                                         "bits at %r" % row)
                row["shipped_ms"] = time_ms(shipped, 100.0)
                times = {}
                for i in range(lib.k3t_count()):
                    y.zero_()
                    cand(i)
                    name = lib.k3t_name(i).decode()
                    if not torch.equal(y, ref):
                        raise AssertionError("k3_tiles: %s moved bits at %r"
                                             % (name, row))
                    times[name] = time_ms(lambda: cand(i), 100.0)
                if kind == "fp32":
                    wd = w
                else:
                    from .. import quantize as Q
                    wd = Q.dequantize_array(
                        codes.view(torch.int8) if kind == "int8" else codes,
                        scales[:, None])
                row["library_ms"] = time_ms(
                    lambda: torch.nn.functional.linear(x, wd, bias), 100.0)
                best = min(times, key=times.get)
                row.update(best=best, best_ms=times[best], candidates=times)
                emit(row)
    if out:
        out.close()


if __name__ == "__main__":
    main()
