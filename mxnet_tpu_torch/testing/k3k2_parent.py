"""Serving's projection (K3, K3q) and paged attention (K2, K2q) against
another checkout's build of the same two sources, in one process on one
card.

Run on a card from the repository's root, with the other checkout's
files unpacked under a directory that ``.gitignore`` lists::

    git archive <commit> mxnet_tpu_torch/csrc | tar -x -C build/parent
    python -m mxnet_tpu_torch.testing.k3k2_parent build/parent

It builds ``<dir>/mxnet_tpu_torch/csrc/linear.cu`` and
``paged_attention.cu`` with this checkout's flags for each (one nvcc
each, at once, under ``build/k3k2_parent/``), binds their C entries (the
signatures of ``_cuda.KERNELS``), and prints one JSON line a case:

- K3 (fp32) and K3q (int8, e4m3 codes) at M = 8 (decode), 40 (the
  speculative verify's 8 slots x 5) and 256 (the largest prefill bucket)
  rows at serving's five projection shapes;
- K2 (fp32) and K2q (int8, e4m3 pages) at chip_smoke's cases: decode
  over 8 slots at 18 and 64 pages, prefills of 256 and 64 rows at offset
  32, and the verify's 8 slots x 5 rows.

Both builds must give the same bits at every case (a tiling moves no
output's operations).  Times are CUDA-event means (L2 flushed, each
window opened behind a device spin, as chip_smoke times kernels), taken
in turns other, this, this, other, with the library's one call beside
them: ``F.linear`` over the (dequantized) weight, SDPA over the gathered
(dequantized) context.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

from .flash_parent import build_other, in_turns, swapped, time_ms

__all__ = ["main"]

KERNELS = ("mi_linear", "mi_linear_q", "paged_attention",
           "paged_attention_q")
SHAPES = ((6144, 2048), (2048, 2048), (8192, 2048), (2048, 8192),
          (32768, 2048))


def _emit(row):
    print(json.dumps(row), flush=True)


def _case(other, kernel, case, fn, library):
    """Bits of both builds, then their times in turns and the library's."""
    mine = fn().clone()
    with swapped(other):
        theirs = fn().clone()
    row = dict(kernel=kernel, case=case,
               bit_identical=bool(torch.equal(mine, theirs)),
               ms=in_turns(other, fn), library_ms=time_ms(library))
    _emit(row)
    if not row["bit_identical"]:
        raise AssertionError("%s %s differs from the other build"
                             % (kernel, case))


def _projections(other, randn):
    from .. import quantize as Q
    from ..ops import linear as L

    for f, c in SHAPES:
        w, b = 0.02 * randn(f, c), 0.02 * randn(f)
        weights = [("fp32", w, w)]
        for mode in ("int8", "fp8"):
            q, s = Q.quantize_array(w, mode)
            weights.append((mode, {"q": q, "s": s},
                            Q.dequantize_array(q, s)))
        for m in (8, 40, 256):
            x = randn(m, c)
            for kind, wt, wd in weights:
                _case(other, "mi_linear" if kind == "fp32" else
                      "mi_linear_q", "%s-M%d-F%d-C%d" % (kind, m, f, c),
                      lambda: L.mi_linear(x, wt, b),
                      lambda: torch.nn.functional.linear(x, wd, b))
        del w, b, weights
        torch.cuda.empty_cache()


def _paged(other, randn):
    from .. import quantize as Q
    from ..ops import attention as A

    page, h, d = 16, 16, 128
    rs = np.random.RandomState(5)
    dev = torch.device("cuda")
    cases = []
    for max_pages, lo, idle in ((18, 24, True), (64, 64 * page - 63, False)):
        n_pages = 8 * max_pages
        pools = tuple(randn(n_pages + 1, page, h, d) for _ in range(2))
        tables = torch.from_numpy(rs.permutation(n_pages).reshape(
            8, max_pages).astype(np.int32)).to(dev)
        lens = rs.randint(lo, max_pages * page + 1, size=8)
        if idle:
            lens[7] = 0
        cases.append(("decode-S8-Q1" + ("" if max_pages == 18 else
                                        "-64pages"), pools,
                      randn(8, h, 1, d), tables,
                      torch.from_numpy(lens.astype(np.int32)).to(dev)))
        if max_pages == 18:
            for bucket in (256, 64):
                hz = (32 + np.arange(bucket) + 1).astype(np.int32)
                cases.append(("prefill-S1-Q%d-offset32" % bucket, pools,
                              randn(1, h, bucket, d),
                              tables[:1].contiguous(),
                              torch.from_numpy(hz[None]).to(dev)))
            committed = rs.randint(240, 251, size=(8, 1))
            hz = (committed + np.arange(5) + 1).astype(np.int32)
            cases.append(("verify-S8-Q5", pools, randn(8, h, 5, d), tables,
                          torch.from_numpy(hz).to(dev)))

    def sdpa(q, kp, vp, tab, hor):
        """SDPA over the gathered context, each row masked to its
        horizon (the gather is not timed)."""
        L = int(hor.max())
        keys = torch.arange(L, device=dev)
        hor2 = hor if hor.dim() == 2 else hor[:, None]
        mask = keys < hor2[:, None, :, None]
        kc, vc = (p[tab.long()].reshape(tab.shape[0], -1, h, d)[:, :L]
                  .permute(0, 2, 1, 3).contiguous() for p in (kp, vp))
        mask = mask | (hor2.amax(-1) == 0)[:, None, None, None]
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kc, vc, attn_mask=mask, scale=1.0 / d ** 0.5)

    for case, (kp, vp), q, tab, hor in cases:
        _case(other, "paged_attention", "fp32-" + case,
              lambda: A.paged_attention(q, kp, vp, tab, hor),
              sdpa(q, kp, vp, tab, hor))
        for mode in ("int8", "fp8"):
            (kc, ks), (vc, vs) = (Q.kv_quantize_rows(p, mode)
                                  for p in (kp, vp))
            kd, vd = Q.kv_dequantize(kc, ks), Q.kv_dequantize(vc, vs)
            _case(other, "paged_attention_q", "%s-%s" % (mode, case),
                  lambda: A.paged_attention(q, kc, vc, tab, hor,
                                            k_scale=ks, v_scale=vs),
                  sdpa(q, kd, vd, tab, hor))
            del kc, ks, vc, vs, kd, vd


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    other = build_other(argv[0] if argv else os.path.join("build", "parent"),
                        KERNELS, "k3k2_parent")
    torch.backends.cuda.matmul.allow_tf32 = False
    _emit({"card": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    _projections(other, randn)
    _paged(other, randn)


if __name__ == "__main__":
    main()
