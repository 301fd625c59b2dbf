"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds, not minutes.
All sources compile in parallel at first use, into
``build/mxnet_tpu_torch/<hash>/`` at the repo root, keyed by a hash of
every file in ``csrc/`` and of each source's compiler flags; a later
process with the same sources reuses the libraries.  nvcc's output
(``-Xptxas -v``: registers, shared memory, spills) is kept beside each
library as ``lib<source>.log``.

Flags are per source (:func:`nvcc_flags`).  The exact sources — K1, K2
and K2q (``online_softmax.cuh``'s users, windowed and over rings too), K3
and K3q (the projection), K9 (``kv_quant.cu``, the KV rows'
quantize-and-append), K10 (``ssm_scan.cu``, the SSM recurrence), K11
and K12 (``fp8_gemm.cu``, ``fp8_cast.cu``: fp8 training's GEMM and
scaled cast), the BatchNorm sums and run-time ``rtc`` kernels — build
with ``-fmad=false``,
so that
no add and multiply are contracted behind serving's bit-exactness
contract.  The backward kernels K4 and K8 and the Hopper forward K7 build
without it (:data:`SOURCE_FLAGS`): none has a bit contract, and
contraction into FMA is fixed at compile time, so their reruns still
give the same bits.

Every C entry launches on the stream it is handed (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``;
:func:`launch` raises :class:`MXNetError` on a non-zero code.  The
Python wrappers in ``ops/`` check device, dtype, shape and contiguity,
allocate the outputs, and add one to :data:`launches` per kernel launch
— the count that shows a run really went through the kernels.  A
launch inside a CUDA-graph capture only records it: the serving session
takes those counts back after each capture and adds them again at every
replay of the graph (``serve/session.py``), so the count follows the
launches that ran.

:func:`build_source` is the same build for a source text handed over at
run time (``rtc.CudaKernel``): one library per text, in
``build/mxnet_tpu_torch/rtc/<sha256 of text and flags>/``, reused by
later calls and later processes; its launches count under
``"rtc:<kernel name>"``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .base import MXNetError

__all__ = ["KERNELS", "launches", "reset_launches", "build", "launch",
           "build_seconds", "build_source", "stream_of", "nvcc_flags"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "build", "mxnet_tpu_torch")

# the exact build: every source but those in SOURCE_FLAGS, and rtc texts
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
FAST_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")
SOURCE_FLAGS = {"flash_attention_backward": FAST_FLAGS,
                "flash_attention_sm90": FAST_FLAGS,
                "flash_attention_backward_sm90": FAST_FLAGS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# kernel name -> (source stem, C entry, argtypes)
KERNELS = {
    "flash_attention": (
        "flash_attention", "mxt_flash_attention_forward",
        (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P)),
    "flash_attention_backward": (
        "flash_attention_backward", "mxt_flash_attention_backward",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P)),
    "flash_attention_sm90": (
        "flash_attention_sm90", "mxt_flash_attention_sm90",
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _F, _I, _P)),
    "flash_attention_backward_sm90": (
        "flash_attention_backward_sm90", "mxt_flash_attention_backward_sm90",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _F, _I,
         _P)),
    "paged_attention": (
        "paged_attention", "mxt_paged_attention",
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P)),
    "mi_linear": (
        "linear", "mxt_linear",
        (_P, _P, _P, _P, _I, _I, _I, _P)),
    "mi_linear_q": (
        "linear", "mxt_linear_q",
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "paged_attention_q": (
        "paged_attention", "mxt_paged_attention_q",
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
         _P)),
    "kv_append_quantized": (
        "kv_quant", "mxt_kv_append_quantized",
        (_P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    # hybrid stacks: K1 with a sliding window, K2/K2q over windowed
    # layers' rings (rotated tables, position labels), K10 the SSM scan
    "flash_attention_window": (
        "flash_attention", "mxt_flash_attention_window",
        (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P)),
    "paged_attention_ring": (
        "paged_attention", "mxt_paged_attention_ring",
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
         _P)),
    "paged_attention_q_ring": (
        "paged_attention", "mxt_paged_attention_q_ring",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _F, _I, _P)),
    "ssm_scan": (
        "ssm_scan", "mxt_ssm_scan",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P)),
    "bn_stats": (
        "batch_norm", "mxt_bn_stats",
        (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P)),
    "bn_grad_sums": (
        "batch_norm", "mxt_bn_grad_sums",
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P)),
    # fp8 training: K11 the fp8 GEMM, K12 the scaled cast (+ amax)
    "fp8_gemm": (
        "fp8_gemm", "mxt_fp8_gemm",
        (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P)),
    "fp8_cast": (
        "fp8_cast", "mxt_fp8_cast",
        (_P, _I, _I, _I, _P, _I, _P, _I, _P, _I, _P, _P)),
}

# launches per kernel since the last reset_launches()
launches = dict.fromkeys(KERNELS, 0)

_lock = threading.Lock()
_entries = {}
build_seconds = None  # wall time of the build in this process (0: cached)
_rtc_entries = {}     # digest -> (C entry, error-text entry)


def reset_launches():
    for name in launches:
        launches[name] = 0


def _nvcc():
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                     "built from mxnet_tpu_torch/csrc at first use")


def nvcc_flags(stem):
    """nvcc's flags for ``csrc/<stem>.cu``: :data:`NVCC_FLAGS` (with
    ``-fmad=false``) unless :data:`SOURCE_FLAGS` names the source, and
    ``-Xptxas -v`` for the build log."""
    return SOURCE_FLAGS.get(stem, NVCC_FLAGS) + ("-Xptxas", "-v")


def _source_key():
    h = hashlib.sha256()
    for stem in sorted({stem for stem, _, _ in KERNELS.values()}):
        h.update(("%s: %s\n" % (stem, " ".join(nvcc_flags(stem)))).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile (or reuse) every kernel library and bind its C entries.
    Idempotent; returns the build directory."""
    global build_seconds
    with _lock:
        out_dir = os.path.join(BUILD_ROOT, _source_key())
        if _entries:
            return out_dir
        t0 = time.perf_counter()
        os.makedirs(out_dir, exist_ok=True)
        stems = sorted({stem for stem, _, _ in KERNELS.values()})
        libs = {s: os.path.join(out_dir, "lib%s.so" % s) for s in stems}
        todo = [s for s in stems if not os.path.exists(libs[s])]
        if todo:
            nvcc = _nvcc()
            procs = {}
            for s in todo:  # one nvcc per source, all at once
                tmp = "%s.%d.tmp" % (libs[s], os.getpid())
                cmd = [nvcc, *nvcc_flags(s), "-o", tmp,
                       os.path.join(CSRC, s + ".cu")]
                procs[s] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            errors = []
            for s, (tmp, proc) in procs.items():
                log, _ = proc.communicate()
                with open(os.path.join(out_dir, "lib%s.log" % s), "w") as f:
                    f.write(log)
                if proc.returncode:
                    errors.append("%s.cu (nvcc rc %d):\n%s"
                                  % (s, proc.returncode, log))
                else:
                    os.replace(tmp, libs[s])
            if errors:
                raise MXNetError("CUDA kernel build failed:\n"
                                 + "\n".join(errors))
        for name, (stem, entry, argtypes) in KERNELS.items():
            lib = ctypes.CDLL(libs[stem])
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            err = lib.mxt_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _entries[name] = (fn, err)
        build_seconds = time.perf_counter() - t0 if todo else 0.0
        return out_dir


def build_source(text, entry, argtypes):
    """Compile the CUDA source ``text`` (or reuse its library from an
    earlier call or process) and return its C function ``entry`` with
    ``argtypes`` bound, returning int.  A compile error raises
    :class:`MXNetError` carrying nvcc's output."""
    digest = hashlib.sha256(
        (" ".join(NVCC_FLAGS) + "\0" + text).encode()).hexdigest()
    with _lock:
        if digest not in _rtc_entries:
            out_dir = os.path.join(BUILD_ROOT, "rtc", digest[:32])
            lib_path = os.path.join(out_dir, "librtc.so")
            if not os.path.exists(lib_path):
                os.makedirs(out_dir, exist_ok=True)
                src = os.path.join(out_dir, "kernel.%d.cu" % os.getpid())
                with open(src, "w") as f:
                    f.write(text)
                tmp = "%s.%d.tmp" % (lib_path, os.getpid())
                proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                if proc.returncode:
                    raise MXNetError("rtc: nvcc rc %d compiling %s:\n%s"
                                     % (proc.returncode, entry, proc.stdout))
                os.replace(tmp, lib_path)
                os.replace(src, os.path.join(out_dir, "kernel.cu"))
            lib = ctypes.CDLL(lib_path)
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            err = lib.mxt_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _rtc_entries[digest] = (fn, err)
        return _rtc_entries[digest]


def stream_of(tensor):
    """PyTorch's current stream on ``tensor``'s device, as a pointer."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def launch(name, *args):
    """Call kernel ``name``'s C entry (building at first use), raise on a
    CUDA error, and count the launch."""
    if name not in _entries:
        build()
    fn, err = _entries[name]
    rc = fn(*args)
    if rc:
        raise MXNetError("%s: CUDA error %d (%s)"
                         % (name, rc, err(rc).decode()))
    launches[name] += 1
