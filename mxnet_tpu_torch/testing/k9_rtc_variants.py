"""K9 (``csrc/kv_quant.cu``) and the rtc bodies (``testing/rtc_ops.py``):
the sweeps that chose their launch shapes, and their times beside
another checkout's, in one process on one card.

Run on a card from the repository's root::

    python -m mxnet_tpu_torch.testing.k9_rtc_variants sweep
    git archive <commit> mxnet_tpu_torch | tar -x -C build/parent
    python -m mxnet_tpu_torch.testing.k9_rtc_variants parent build/parent

``sweep`` prints one JSON line a case:

- K9 with 128, 256 and 512 threads a row (16, 8 and 4 values a thread),
  each variant built from a copy of ``kv_quant.cu`` under
  ``build/k9_rtc_variants/`` whose every launch takes that instance (one
  nvcc a variant, all at once), at N = 8 (a decode step), 40 (the
  speculative verify's 8 slots x 5), 64, 128 and 256 (the prefill
  buckets) rows of H16 D128, int8 and e4m3: codes and scales byte-equal
  to the plain form in every variant;
- ``rtc_axpy`` at 8192 x 8192 with and without the streaming hints, at
  2 to 512 blocks of 256 threads a streaming multiprocessor (512: one
  float4 a thread, no second pass), beside ``torch.add``, which it is
  also timed against under three windows;
- ``rtc_softmax_forward`` and ``rtc_softmax_backward`` at 256 x 1000
  (logits x1 and x1e4) with 32 to 512 threads a row, and at the shipped
  launch with parts of their work removed (no exp, no division, no sum
  or max reduction, a copy; the backward without its division).

``parent`` builds the other checkout's ``kv_quant.cu`` with this
checkout's flags and compiles its three rtc bodies at its own launch
shapes (one thread an element for axpy and the backward, one 256-thread
block a row for the forward), and prints, at chip_smoke's cases, whether
the two give the same bytes (K9, axpy, the backward) or how far apart
they are (the forward), and their times in turns other, this, this,
other.

Each case gives CUDA-event means (L2 flushed, the window opened behind a
device spin, as chip_smoke times kernels) and device times from the
profiler (the kernels alone, without the wrapper's launch path).
"""
from __future__ import annotations

import ast
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from .. import _cuda
from .flash_parent import build_other, swapped, time_ms

__all__ = ["main"]

K9_THREADS = (128, 256, 512)
K9_ROWS = (8, 40, 64, 128, 256)
AXPY_BLOCKS_PER_SM = (2, 8, 32, 128, 512)
SOFTMAX_ROW_THREADS = (32, 64, 128, 256, 512)
# axpy's plain loads and stores, and the streaming hints in their place
_PLAIN = ("  auto ld = [](const float4* p) { return *p; };\n"
          "  auto st = [](float4* p, float4 v) { *p = v; };\n")
_STREAMING = ("  auto ld = [](const float4* p) { return __ldcs(p); };\n"
              "  auto st = [](float4* p, float4 v) { __stcs(p, v); };\n")
_K9_THREADS_LINE = "constexpr int kRowThreads = "
# the softmax bodies with parts of their work removed (the answers are
# wrong; only the times count): (old, new) text patches, each old found
_FORWARD_ABLATIONS = {
    "no_exp": (("v[i] = expf(v[i] - m);", "v[i] = v[i] - m;"),),
    "no_div": (("v[i] = __fmaf_rn(__fmaf_rn(-q, s, v[i]), rs, q);",
                "v[i] = q;"),),
    "no_sum_reduce": (("s = row_sum(s);", ""),),
    "no_max_reduce": (("m = row_max(m);", ""),),
}
_FORWARD_ABLATIONS["copy"] = sum(_FORWARD_ABLATIONS.values(), ())
_BACKWARD_ABLATIONS = {
    "no_div": (("v[4 * k + j] = (v[4 * k + j] - h) / n;",
                "v[4 * k + j] = (v[4 * k + j] - h) * n;"),),
}


def _emit(row):
    print(json.dumps(row), flush=True)


def device_ms(fn, key, reps=20):
    """Device time a call of ``fn``'s kernel whose name holds ``key`` (one
    a call; the mean over the launches the profiler saw, which may drop
    a launch of a library loaded apart from PyTorch's runtime), or of
    every kernel of a call for "", from the profiler over ``reps``
    calls; None where it saw none in three windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and key in ev.key
               and ev.self_device_time_total > 0]
        seen = sum(ev.count for ev in evs)
        if seen:
            return sum(ev.self_device_time_total for ev in evs) / 1e3 / (
                seen if key else reps)
    return None


def _window_ms(fn, flush=True, spin=True, reps=20):
    """CUDA-event mean of ``fn`` over ``reps`` calls: each in its own
    window behind a device spin, or (``spin=False``) all in one window."""
    from .flash_parent import SPIN_CYCLES

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if not spin:
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    total = 0.0
    for _ in range(reps):
        if flush:
            torch.empty(128 << 20, dtype=torch.uint8, device="cuda").zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def _times(fn, key):
    return dict(ms=time_ms(fn), device_ms=device_ms(fn, key))


def _turns(other, this, key):
    """Times of ``other`` and ``this`` in turns other, this, this, other."""
    out = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        out[side].append(_times(other if side == "other" else this, key))
    return out


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


def _k9_case(gen, mode, n, h=16, d=128, page=16, n_pages=144):
    """chip_smoke's K9 case: N K and V rows (the first all zero) into
    pools of ``n_pages`` pages at seeded slots; returns (run(pools),
    fresh pools, the plain form's pools)."""
    from .. import quantize as Q

    krows, vrows = _randn(gen, n, h, d), _randn(gen, n, h, d)
    krows[0] = 0.0
    slots = torch.from_numpy(np.random.RandomState(n).permutation(
        n_pages * page)[:n]).cuda()
    pages, offs = slots // page, slots % page
    dtype = Q.storage_dtype(mode)

    def pools():
        return [torch.zeros(n_pages + 1, page, h, d, dtype=dtype,
                            device="cuda") for _ in range(2)] + \
            [torch.ones(n_pages + 1, page, device="cuda") for _ in range(2)]

    want = pools()
    Q.kv_append_quantized_plain(*want, pages, offs, krows, vrows)
    return (lambda p: Q.kv_append_quantized(*p, pages, offs, krows, vrows),
            pools, want)


def _k9_variant_source(out_dir, threads):
    """A copy of csrc whose every K9 launch runs ``threads`` a row."""
    src_dir = os.path.join(out_dir, "csrc-%d" % threads)
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src_dir)
    path = os.path.join(src_dir, "kv_quant.cu")
    with open(path) as f:
        s = f.read()
    if s.count(_K9_THREADS_LINE) != 1:
        raise RuntimeError("k9_rtc_variants: kv_quant.cu no longer has one "
                           "%r" % _K9_THREADS_LINE)
    head, rest = s.split(_K9_THREADS_LINE)
    s = head + _K9_THREADS_LINE + "%d;" % threads + rest.split(";", 1)[1]
    with open(path, "w") as f:
        f.write(s)
    return path


def _k9_variants():
    """{threads: (C entry, error entry)}, one nvcc a variant, at once."""
    out_dir = os.path.join(_cuda.BUILD_ROOT, os.pardir, "k9_rtc_variants")
    procs = {}
    for t in K9_THREADS:
        src = _k9_variant_source(out_dir, t)
        lib = os.path.join(out_dir, "libkv_quant_%d.so" % t)
        procs[t] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.nvcc_flags("kv_quant"), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _, _, argtypes = _cuda.KERNELS["kv_append_quantized"]
    entries = {}
    for t, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on the %d-thread K9:\n%s"
                               % (t, log))
        handle = ctypes.CDLL(lib)
        fn = handle.mxt_kv_append_quantized
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        err = handle.mxt_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        entries[t] = {"kv_append_quantized": (fn, err)}
    return entries


def sweep(gen):
    from ..rtc import CudaKernel
    from . import rtc_ops as R

    variants = _k9_variants()
    for mode in ("int8", "fp8"):
        for n in K9_ROWS:
            run, pools, want = _k9_case(gen, mode, n)
            row = dict(kernel="kv_append_quantized",
                       case="%s-N%d" % (mode, n), threads={})
            for t, entry in variants.items():
                with swapped(entry):
                    got = pools()
                    run(got)
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    row["threads"][t] = dict(byte_equal=same,
                                             **_times(lambda: run(got),
                                                      "kv_quant_kernel"))
                if not same:
                    raise AssertionError("K9 at %d threads: other bytes "
                                         "than the plain form" % t)
            _emit(row)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x, y = _randn(gen, 8192, 8192), _randn(gen, 8192, 8192)
    want = R.axpy_plain(x, y)
    row = dict(kernel="rtc_axpy", case="fp32-8192x8192", sms=sms,
               library=_times(lambda: torch.add(y, x, alpha=2.0), ""),
               variants={})
    for hints in (False, True):
        if R.AXPY_BODY.count(_PLAIN) != 1:
            raise RuntimeError("k9_rtc_variants: AXPY_BODY no longer has "
                               "%r" % _PLAIN)
        k = CudaKernel(R.AXPY_BODY.replace(_PLAIN, _STREAMING if hints
                                           else _PLAIN),
                       [(x.shape, "float32")], ["x", "y", "o"],
                       name="rtc_axpy")
        for b in AXPY_BLOCKS_PER_SM:
            def fn():
                return k._run([x, y], sms * b, R.AXPY_THREADS)

            if not torch.equal(fn()[0], want):
                raise AssertionError("rtc_axpy differs at %r" % ((hints, b),))
            row["variants"]["%s-%dblocks" % (
                "streaming" if hints else "plain", b)] = \
                _times(fn, "rtc_axpy")
    # the shipped launch and torch.add under three windows: L2 flushed
    # and a spin before each call (chip_smoke's), a spin alone, and 20
    # calls back to back
    for name, fn in (("rtc_axpy", lambda: R.axpy(x, y)),
                     ("torch.add", lambda: torch.add(y, x, alpha=2.0))):
        row[name] = dict(flushed_ms=time_ms(fn),
                         spin_only_ms=_window_ms(fn, flush=False),
                         back_to_back_ms=_window_ms(fn, flush=False,
                                                    spin=False))
    _emit(row)
    del x, y, want
    for scale in (1.0, 1e4):
        x = scale * _randn(gen, 256, 1000)
        label = torch.randint(0, 1000, (256,), device="cuda",
                              generator=gen).float()
        p = R.softmax_forward_plain(x)
        for name, ins, want, args in (
                ("rtc_softmax_forward", [x], p, ["x", "y"]),
                ("rtc_softmax_backward", [p, label],
                 R.softmax_backward_plain(p, label), ["y", "label", "dx"])):
            row = dict(kernel=name, case="fp32-256x1000" + (
                "" if scale == 1.0 else "-x1e4"), row_threads={})
            for t in SOFTMAX_ROW_THREADS:
                body, grid, block = R.launch_shape(name, x.shape, t)
                k = CudaKernel(body, [(x.shape, "float32")], args,
                               grid=grid, block=block, name=name)
                err = (k._run(ins)[0] - want).abs().max().item()
                row["row_threads"][t] = dict(
                    max_abs_err=err, **_times(lambda: k._run(ins), name))
            body, grid, block = R.launch_shape(name, x.shape)
            row["ablations"] = {}
            for what, patches in (
                    _FORWARD_ABLATIONS if name == "rtc_softmax_forward"
                    else _BACKWARD_ABLATIONS).items():
                text = body
                for old, new in patches:
                    if old not in text:
                        raise RuntimeError("k9_rtc_variants: %s no longer "
                                           "has %r" % (name, old))
                    text = text.replace(old, new)
                k = CudaKernel(text, [(x.shape, "float32")], args,
                               grid=grid, block=block, name=name)
                row["ablations"][what] = _times(lambda: k._run(ins), name)
            _emit(row)


def _other_bodies(root):
    """The three rtc bodies of the checkout at ``root`` (its
    ``testing/rtc_ops.py``, read, not imported) and its forward's
    threads a block."""
    path = os.path.join(root, "mxnet_tpu_torch", "testing", "rtc_ops.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            try:
                found[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return found


def parent(gen, root):
    from ..rtc import CudaKernel
    from . import rtc_ops as R

    other = build_other(root, ("kv_append_quantized",), "k9_rtc_parent")
    for mode in ("int8", "fp8"):
        for n in (8, 256):
            run, pools, want = _k9_case(gen, mode, n)
            mine, theirs = pools(), pools()
            run(mine)
            with swapped(other):
                run(theirs)
            same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
            plain = all(torch.equal(a, b) for a, b in zip(mine, want))

            times = {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                with swapped(other) if side == "other" else \
                        contextlib.nullcontext():
                    times[side].append(_times(
                        lambda: run(theirs if side == "other" else mine),
                        "kv_quant_kernel"))
            _emit(dict(kernel="kv_append_quantized",
                       case="%s-%s-N%d" % (mode, "decode" if n == 8 else
                                          "prefill", n),
                       byte_identical=same, byte_equal_plain=plain,
                       times=times))
            if not (same and plain):
                raise AssertionError("K9 %s N%d: other bytes" % (mode, n))
    bodies = _other_bodies(root)
    threads = bodies.get("SOFTMAX_THREADS", 256)
    for shape in ((16, 128), (8192, 8192)):
        x, y = _randn(gen, *shape), _randn(gen, *shape)
        k_other = CudaKernel(bodies["AXPY_BODY"], [(shape, "float32")],
                             ["x", "y", "o"], name="rtc_axpy")
        a, b = R.axpy(x, y), k_other._run([x, y])[0]
        _emit(dict(kernel="rtc_axpy", case="fp32-%dx%d" % shape,
                   bit_identical=bool(torch.equal(a, b)),
                   bit_equal_plain=bool(torch.equal(a, R.axpy_plain(x, y))),
                   times=_turns(lambda: k_other._run([x, y]),
                                lambda: R.axpy(x, y), "rtc_axpy"),
                   library=_times(lambda: torch.add(y, x, alpha=2.0),
                                  "")))
        del x, y, a, b
    for scale in (1.0, 1e4):
        case = "fp32-256x1000" + ("" if scale == 1.0 else "-x1e4")
        x = scale * _randn(gen, 256, 1000)
        label = torch.randint(0, 1000, (256,), device="cuda",
                              generator=gen).float()
        fwd = CudaKernel(bodies["SOFTMAX_FORWARD_BODY"],
                         [((256, 1000), "float32")], ["x", "y"], grid=256,
                         block=threads, name="rtc_softmax_forward")
        p, p_other = R.softmax_forward(x), fwd._run([x])[0]
        p_plain = R.softmax_forward_plain(x)
        _emit(dict(kernel="rtc_softmax_forward", case=case,
                   max_abs_diff=(p - p_other).abs().max().item(),
                   max_abs_err=(p - p_plain).abs().max().item(),
                   other_max_abs_err=(p_other - p_plain).abs().max().item(),
                   times=_turns(lambda: fwd._run([x]),
                                lambda: R.softmax_forward(x),
                                "rtc_softmax_forward"),
                   library=_times(lambda: torch.softmax(x, 1), "")))
        bwd = CudaKernel(bodies["SOFTMAX_BACKWARD_BODY"],
                         [((256, 1000), "float32")], ["y", "label", "dx"],
                         name="rtc_softmax_backward")
        g, g_other = R.softmax_backward(p, label), bwd._run([p, label])[0]
        _emit(dict(kernel="rtc_softmax_backward", case=case,
                   bit_identical=bool(torch.equal(g, g_other)),
                   bit_equal_plain=bool(torch.equal(
                       g, R.softmax_backward_plain(p, label))),
                   times=_turns(lambda: bwd._run([p, label]),
                                lambda: R.softmax_backward(p, label),
                                "rtc_softmax_backward")))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("sweep", "parent"):
        sys.exit("usage: python -m mxnet_tpu_torch.testing.k9_rtc_variants "
                 "sweep | parent [checkout]")
    _emit({"card": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    if argv[0] == "sweep":
        sweep(gen)
    else:
        parent(gen, argv[1] if len(argv) > 1 else
               os.path.join("build", "parent"))


if __name__ == "__main__":
    main()
