"""fp8 training's kernels, K11 (the fp8 GEMM) and K12 (the scaled cast),
against another checkout's build of the same two sources, in one process
on one card.

Run on a card from the repository's root, with the other checkout's
files unpacked under a directory that ``.gitignore`` lists::

    git archive <commit> mxnet_tpu_torch/csrc | tar -x -C build/parent
    python -m mxnet_tpu_torch.testing.fp8_parent build/parent

It builds ``<dir>/mxnet_tpu_torch/csrc/fp8_gemm.cu`` and ``fp8_cast.cu``
with this checkout's flags for each (one nvcc each, at once, under
``build/fp8_parent/``), binds their C entries (the signatures of
``_cuda.KERNELS``), and prints one JSON line a case:

- K12 at ``chip_smoke.FP8_CAST_CASES`` (the LM's activations, weights
  and cotangents: codes, transposed codes and amax; the amax pass; the
  e5m2 cast): codes and amax bits from both builds equal to each other
  and to the plain version;
- K11 at the 15 products of ``chip_smoke.fp8_gemm_cases`` (forward, dx
  and dw of the LM's five projection shapes) and at
  ``chip_smoke.fp8_gemm_edge_cases``: the outputs of both builds the same
  bits, with ``torch._scaled_mm`` on the same codes timed beside them;
- the LM's fp8 step of chip_smoke's robust phase (``MXNET_FP8=on``,
  Adam, bf16, ``StepHealth(DynamicLossScaler)``), after 10 steps: its
  host-clock time a step over 5 steps in turns, and one profiled step
  under each build (device time by kernel group, idle share).

Times are CUDA-event means (L2 flushed, each window opened behind a
device spin, as chip_smoke times kernels), taken in turns other, this,
this, other.  A case whose bits differ raises after its line.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

import torch

from .flash_parent import build_other, in_turns, swapped, time_ms

__all__ = ["main"]

KERNELS = ("fp8_gemm", "fp8_cast")


def _emit(row):
    print(json.dumps(row), flush=True)


def _bits(outs):
    """The outputs of one fp8_cast call as comparable tensors: codes as
    they are, the amax by its bits (a NaN compares equal to itself)."""
    return [o.view(torch.int32) if o is not None and o.dtype ==
            torch.float32 else o for o in outs]


def _same(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def _casts(cs, other, randn):
    from ..ops import fp8_ops as F8

    for case, rows, cols, kind, what in cs.FP8_CAST_CASES:
        x = (randn(rows, cols) * 0.05).bfloat16()
        s = torch.full((), 1e-3, device="cuda")
        kw = cs.FP8_CAST_OUTPUTS[what]

        def fn():
            return F8.fp8_cast(x, s, kind, **kw)
        mine = _bits(fn())
        with swapped(other):
            theirs = _bits(fn())
        plain = _bits(F8.fp8_cast_plain(x, s, kind, **kw))
        row = dict(kernel="fp8_cast", case=case,
                   bit_identical=_same(mine, theirs),
                   equals_plain=_same(mine, plain), ms=in_turns(other, fn))
        _emit(row)
        if not (row["bit_identical"] and row["equals_plain"]):
            raise AssertionError("K12 %s: builds equal %s, plain equal %s"
                                 % (case, row["bit_identical"],
                                    row["equals_plain"]))
        del x, mine, theirs, plain


def _gemms(cs, other, gen):
    from ..ops import fp8_ops as F8

    for case, a, b, ka, kb, sa, sb in itertools.chain(
            cs.fp8_gemm_cases("cuda", gen), cs.fp8_gemm_edge_cases("cuda",
                                                                  gen)):
        def fn():
            return F8.fp8_gemm(a, b, ka, kb, sa, sb, torch.bfloat16)
        mine = fn()
        with swapped(other):
            theirs = fn()
        library = cs.scaled_mm_call(a, b, ka, kb, sa, sb)
        row = dict(kernel="fp8_gemm", case=case,
                   bit_identical=bool(torch.equal(mine, theirs)),
                   rerun_bit_identical=bool(torch.equal(fn(), mine)),
                   ms=in_turns(other, fn),
                   library_ms=time_ms(library) if library else None)
        _emit(row)
        if not (row["bit_identical"] and row["rerun_bit_identical"]):
            raise AssertionError("K11 %s differs from the other build or "
                                 "from its rerun" % case)
        del mine, theirs


def _steps_ms(fn, reps=5):
    """Mean host time of ``reps`` calls of ``fn`` back to back, one
    synchronize at the end (a training loop's steps overlap the host's
    launches of the next with the device's work on the last)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _step(cs, other):
    """The robust phase's fp8 LM step, settled by 10 steps, timed in
    turns (5 steps a turn), then one profiled step under each build."""
    dev = torch.device("cuda")
    cfg = cs.train_config()
    step, state, data = cs.robust_step(dev, cfg, 8, True, True)
    t = [0]

    def one():
        t[0] += 1
        state[:3] = step(*state, data, None, t=t[0])[:3]
    for _ in range(10):
        one()
    row = dict(case="fp8-lm-step-8L-batch8-adam-health",
               ms=in_turns(other, one, _steps_ms))
    for side in ("other", "this"):
        with swapped(other) if side == "other" else \
                contextlib.nullcontext():
            row["profile_" + side] = cs.profiled_window(
                one, cs.FP8_STEP_GROUPS)
    _emit(row)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    other = build_other(argv[0] if argv else os.path.join("build", "parent"),
                        KERNELS, "fp8_parent")
    # chip_smoke.py (the checkout's root) holds the cases and the step
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import chip_smoke as cs

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

    _casts(cs, other, randn)
    torch.cuda.empty_cache()
    _gemms(cs, other, gen)
    torch.cuda.empty_cache()
    _step(cs, other)


if __name__ == "__main__":
    main()
