"""The fp32 flash kernels K1 and K4 against another checkout's build of
the same two sources, in one process on one card.

Run on a card from the repository's root, with the other checkout's
files unpacked under a directory that ``.gitignore`` lists::

    git archive <commit> mxnet_tpu_torch/csrc | tar -x -C build/parent
    python -m mxnet_tpu_torch.testing.flash_parent build/parent

It builds ``<dir>/mxnet_tpu_torch/csrc/flash_attention.cu`` and
``flash_attention_backward.cu`` with the exact build's flags (one nvcc
each, at once, under ``build/flash_parent/``), binds their C entries
(the signatures of ``_cuda.KERNELS``), and prints one JSON line per
case:

- K1 (forward and lse) at ``chip_smoke.py``'s cases, at the training
  block 128, and at other head dims, blocks, lengths and head counts
  (which choose other tile heights): the outputs and lse must be the
  same bits from both builds;
- K4 at the training shape and at chip_smoke's small case: the largest
  difference between the builds;
- the fp32 train step of chip_smoke's train-parity phase (2 layers of the
  8-layer LM, batch 2, T 1024; host clock, synced) and serving's oracle
  (``reference_last_logits`` of the 8-layer LM over a 250-token prompt),
  the oracle's logits the same bits from both builds.

Times are CUDA-event means (L2 flushed, each window opened behind a
device spin, as chip_smoke times kernels), taken in turns other, this,
this, other.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import _cuda

__all__ = ["build_other", "swapped", "main"]

KERNELS = ("flash_attention", "flash_attention_backward")  # = their stems
SPIN_CYCLES = 1_000_000


def build_other(src_root, kernels=KERNELS, out_name="flash_parent"):
    """Build the sources of ``kernels`` (names in ``_cuda.KERNELS``) of
    the checkout at ``src_root``, one nvcc a source, all at once, with
    this checkout's flags for each, and return {kernel name: (C entry,
    error-text entry)}."""
    out_dir = os.path.join(_cuda.BUILD_ROOT, os.pardir, out_name)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for stem in {_cuda.KERNELS[name][0] for name in kernels}:
        src = os.path.join(src_root, "mxnet_tpu_torch", "csrc", stem + ".cu")
        lib = os.path.join(out_dir, "lib%s.so" % stem)
        procs[stem] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.nvcc_flags(stem), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    handles = {}
    for stem, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on the other %s:\n%s"
                               % (stem, log))
        handles[stem] = ctypes.CDLL(lib)
    entries = {}
    for name in kernels:
        handle = handles[_cuda.KERNELS[name][0]]
        fn = getattr(handle, _cuda.KERNELS[name][1])
        fn.argtypes = list(_cuda.KERNELS[name][2])
        fn.restype = ctypes.c_int
        err = handle.mxt_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        entries[name] = (fn, err)
    return entries


@contextlib.contextmanager
def swapped(entries):
    """Launch ``entries`` in place of this checkout's kernels."""
    _cuda.build()
    saved = {name: _cuda._entries[name] for name in entries}
    _cuda._entries.update(entries)
    try:
        yield
    finally:
        _cuda._entries.update(saved)


_flush = None


def time_ms(fn, target_ms=200.0):
    """Mean CUDA-event time of ``fn``, L2 flushed and the device spun
    before each call."""
    global _flush
    if _flush is None:
        _flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    reps = int(min(max(target_ms / max(once, 1e-3), 3), 50))
    pairs = []
    for _ in range(reps):
        _flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def wall_ms(fn, reps=3):
    """Mean host time of ``fn`` ending in a synchronize, after one warm
    call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def in_turns(other, fn, timer=time_ms):
    """Times of ``fn`` under the other build and this one, in turns
    other, this, this, other."""
    times = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        ctx = swapped(other) if side == "other" else contextlib.nullcontext()
        with ctx:
            times[side].append(timer(fn))
    return times


def main(argv=None):
    from ..ops import attention as A

    argv = sys.argv[1:] if argv is None else argv
    other = build_other(argv[0] if argv else os.path.join("build", "parent"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": subprocess.run(
                          ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # K1: chip_smoke's cases, the training block, other tile heights and
    # head-dim classes; out and lse must be the same bits
    for n, h, t, d, causal, block in (
            (1, 16, 256, 128, True, 16), (1, 16, 1024, 128, True, 16),
            (1, 2, 37, 16, True, 16), (1, 2, 37, 16, False, 16),
            (1, 16, 1024, 128, True, 128), (2, 16, 1024, 128, True, 128),
            (1, 16, 288, 128, True, 16), (4, 16, 200, 40, True, 8),
            (1, 3, 77, 256, False, 128), (1, 64, 150, 64, True, 48),
            (1, 2, 100, 37, True, 1)):
        q, k, v = randn(n, h, t, d), randn(n, h, t, d), randn(n, h, t, d)
        scale = 1.0 / d ** 0.5

        def fwd():
            return A._flash_forward_cuda(q, k, v, causal, scale, block, True)

        mine = fwd()
        with swapped(other):
            theirs = fwd()
        same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
        row = dict(kernel="flash_attention", case="n%d-h%d-T%d-D%d-%s-b%d"
                   % (n, h, t, d, "causal" if causal else "full", block),
                   bit_identical=same, ms=in_turns(other, fwd))
        print(json.dumps(row), flush=True)
        if not same:
            raise AssertionError("K1 differs from the other build: %r" % row)

    # K4: the training shape and chip_smoke's small case
    for n, h, t, d in ((1, 16, 1024, 128), (1, 2, 37, 16)):
        q, k, v, g = (randn(n, h, t, d) for _ in range(4))
        scale = 1.0 / d ** 0.5
        out, lse = A._flash_forward_cuda(q, k, v, True, scale, 16, True)

        def bwd():
            return A._flash_backward_cuda(q, k, v, out, lse, g, True, scale,
                                          16)

        mine = bwd()
        with swapped(other):
            theirs = bwd()
        diff = max((a - b).abs().max().item() for a, b in zip(mine, theirs))
        print(json.dumps(dict(
            kernel="flash_attention_backward",
            case="n%d-h%d-T%d-D%d-causal-fp32" % (n, h, t, d),
            max_abs_diff=diff, ms=in_turns(other, bwd))), flush=True)

    # end to end: the fp32 train-parity step and serving's oracle
    from .. import fused, serve
    from ..models import transformer

    sym = transformer.get_symbol(vocab_size=32768, num_layers=2,
                                 d_model=2048, num_heads=16, seq_len=1024)
    step = fused.TrainStep(sym, optimizer="sgd", optimizer_params=dict(
        learning_rate=1e-3, momentum=0.9, rescale_grad=0.5), device="cuda")
    params, aux, states = step.init_state(
        {"data": (2, 1024), "softmax_label": (2, 1024)}, seed=0)
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(0, 32640, (2, 1024)).astype(
        np.float32)).cuda()
    batch = {"data": toks, "softmax_label": toks}
    print(json.dumps(dict(case="fp32-train-step-2L-batch2", ms=in_turns(
        other, lambda: step(params, aux, states, batch, None),
        wall_ms))), flush=True)
    del step, params, aux, states
    torch.cuda.empty_cache()
    cfg = serve.ModelConfig(vocab_size=32768, num_layers=8, d_model=2048,
                            num_heads=16, max_len=1024)
    sp = serve.init_params(cfg, seed=0, device="cuda")
    prompt = rs.randint(1, 32768, size=250).tolist()

    def oracle():
        return serve.reference_last_logits(sp, prompt, cfg, 16, exact=True)

    mine = oracle()
    with swapped(other):
        theirs = oracle()
    print(json.dumps(dict(case="oracle-8L-250-tokens",
                          bit_identical=bool(torch.equal(mine, theirs)),
                          ms=in_turns(other, oracle, wall_ms))), flush=True)
    if not torch.equal(mine, theirs):
        raise AssertionError("the oracle's logits differ between builds")


if __name__ == "__main__":
    main()
