"""The port's rtc facility (``rtc.CudaKernel``) on the CPU, without nvcc.

What can be checked without a card: the decorated source (MXNet 0.11's
example, ``x`` → ``y`` over one dimension of 10), the dtype map, the
cache key, a CPU tensor raising, and ``push`` writing its outputs through
a launcher stand-in that computes on the host from the pointer table the
facility hands it (so the argument order, the grid and the block, and the
launch count are what the CUDA launch would get).  A library built by a
C compiler stands in for nvcc's output to show that a cached build is
found and loaded without compiling.  Building and running the kernels
is in ``tests/test_torch_cuda.py``.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _cuda, rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.testing import rtc_ops

EXAMPLE = ("int i = threadIdx.x + blockIdx.x * blockDim.x;\n"
           "if (i < x_dims[0]) y[i] = x[i] * 2.0f;")


def test_decorated_source_of_the_mxnet_example():
    k = rtc.CudaKernel(EXAMPLE, [((10,), "float32")], ["x", "y"],
                       name="double")
    text, entry = k.source([(10,)], ["float32"])
    assert 'extern "C" __global__ void double(const float* x, float* y) {' \
        in text
    assert "const int x_ndim = 1; const int x_dims[] = {10};" in text
    assert "const int y_ndim = 1; const int y_dims[] = {10};" in text
    assert EXAMPLE in text
    assert entry.startswith("mxt_rtc_") and len(entry) == 8 + 16
    assert 'extern "C" int %s(void** args' % entry in text
    assert "cudaLaunchKernel((const void*)double" in text
    assert "return (int)cudaGetLastError();" in text
    assert "mxt_error_string" in text


@pytest.mark.parametrize("dtype,ctype", [
    ("float32", "float"), ("bfloat16", "__nv_bfloat16"),
    ("float16", "__half"), ("int32", "int"), (torch.bfloat16,
                                              "__nv_bfloat16")])
def test_dtype_map(dtype, ctype):
    k = rtc.CudaKernel("", [((2, 3), dtype)], ["a", "b"])
    text, _ = k.source([(2, 3)], [dtype])
    assert "(const %s* a, %s* b)" % (ctype, ctype) in text
    assert "#include <cuda_bf16.h>" in text and \
        "#include <cuda_fp16.h>" in text


def test_unsupported_dtype_raises():
    k = rtc.CudaKernel("", [((2,), "float64")], ["a", "b"])
    with pytest.raises(MXNetError, match="float64"):
        k.source([(2,)], ["float32"])


def test_cache_key_follows_the_text():
    k = rtc.CudaKernel(EXAMPLE, [((10,), "float32")], ["x", "y"])
    a, ea = k.source([(10,)], ["float32"])
    b, eb = k.source([(10,)], ["float32"])
    c, ec = k.source([(12,)], ["float32"])
    assert (a, ea) == (b, eb)
    assert a != c and ea != ec


def test_cpu_tensor_raises_and_names_the_card():
    x = torch.ones(10)
    k = rtc.CudaKernel(EXAMPLE, [((10,), "float32")], ["x", "y"],
                       name="double")
    with pytest.raises(MXNetError, match="CUDA card"):
        k(x)
    with tmx.cpu(), pytest.raises(MXNetError, match="CUDA card"):
        k.push([tmx.nd.ones((10,))], [tmx.nd.zeros((10,))])


def test_launch_shape_defaults_and_checks():
    k = rtc.CudaKernel("", [((1000, 3), "float32")], ["x", "y"])
    assert k._launch_shape(None, None) == ((12, 1, 1), (256, 1, 1))
    assert k._launch_shape((4, 2), 64) == ((4, 2, 1), (64, 1, 1))
    with pytest.raises(MXNetError, match="both"):
        k._launch_shape(4, None)
    with pytest.raises(MXNetError, match="positive"):
        k._launch_shape((0,), (1,))


def _host_axpy_launcher(calls):
    """A stand-in for the compiled entry: reads the kernel's arguments from
    the pointer table and computes o = 2x + y on the host."""
    def fn(args, gx, gy, gz, bx, by, bz, shmem, stream):
        n = 16 * 128
        ptrs = [ctypes.cast(args[i], ctypes.POINTER(ctypes.c_void_p))[0]
                for i in range(3)]
        x, y, o = (np.ctypeslib.as_array((ctypes.c_float * n)
                                         .from_address(p)) for p in ptrs)
        o[:] = 2.0 * x + y
        calls.append(((gx, gy, gz), (bx, by, bz), shmem, stream))
        return 0
    return fn


def test_push_writes_the_given_outputs(monkeypatch):
    calls = []
    monkeypatch.setattr(rtc, "_require_cuda", lambda tensors, name: None)
    monkeypatch.setattr(_cuda, "build_source", lambda text, entry, types: (
        _host_axpy_launcher(calls), None))
    rs = np.random.RandomState(0)
    x = rs.randn(16, 128).astype("float32")
    y = rs.randn(16, 128).astype("float32")
    before = _cuda.launches.get("rtc:rtc_axpy", 0)
    with tmx.cpu():
        k = rtc.CudaKernel(rtc_ops.AXPY_BODY, [((16, 128), "float32")],
                           ["x", "y", "o"], name="rtc_axpy")
        dst = tmx.nd.zeros((16, 128))
        out = k.push([tmx.nd.array(x), tmx.nd.array(y)], [dst],
                     grid_dims=(8,), block_dims=(256,))
        assert out == [dst]
        np.testing.assert_allclose(dst.asnumpy(), 2 * x + y, rtol=1e-6)
        (got,) = k(tmx.nd.array(x), tmx.nd.array(y))
        np.testing.assert_allclose(got.asnumpy(), 2 * x + y, rtol=1e-6)
    assert calls[0][:2] == ((8, 1, 1), (256, 1, 1))
    assert calls[1][:2] == ((8, 1, 1), (256, 1, 1))  # one thread an element
    assert _cuda.launches["rtc:rtc_axpy"] == before + 2


def test_cached_library_is_loaded_without_nvcc(tmp_path, monkeypatch):
    """A library already in the build directory under the text's hash is
    loaded as it is: nvcc is never looked for."""
    if shutil.which("cc") is None:
        pytest.skip("needs a C compiler to stand in for nvcc")
    text = "// an rtc source\n"
    entry = "mxt_rtc_fake"
    digest = hashlib.sha256((" ".join(_cuda.NVCC_FLAGS) + "\0" + text)
                            .encode()).hexdigest()
    monkeypatch.setattr(_cuda, "BUILD_ROOT", str(tmp_path))
    lib_dir = tmp_path / "rtc" / digest[:32]
    lib_dir.mkdir(parents=True)
    src = tmp_path / "fake.c"
    src.write_text("int mxt_rtc_fake(void) { return 7; }\n"
                   "const char* mxt_error_string(int c) { return \"e\"; }\n")
    subprocess.run(["cc", "-shared", "-fPIC", "-o",
                    str(lib_dir / "librtc.so"), str(src)], check=True)

    def no_nvcc():
        raise AssertionError("nvcc must not run for a cached build")

    monkeypatch.setattr(_cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(_cuda, "_rtc_entries", {})
    fn, err = _cuda.build_source(text, entry, ())
    assert fn() == 7 and err(0) == b"e"
    assert os.listdir(lib_dir) == ["librtc.so"]


def _softmax_columns(c, vec, k_vec, threads):
    """The columns the softmax bodies give the threads of a row: thread
    t's chunk k of a group at g holds columns g + 4 T k + 4 t + j (float4)
    or g + 4 T k + T j + t (scalars), j < 4, T threads a row, masked to
    c."""
    cols = []
    for g in range(0, c, 4 * threads * k_vec):
        for t in range(threads):
            for k in range(k_vec):
                for j in range(4):
                    e = g + 4 * threads * k + (4 * t + j if vec else
                                               threads * j + t)
                    if e < c:
                        cols.append(e)
    return cols


@pytest.mark.parametrize("name", ["rtc_axpy", "rtc_softmax_forward",
                                  "rtc_softmax_backward"])
def test_kernel_launch_shapes_cover_their_bodies(name):
    """``_kernel`` hands each body the grid and block its text assumes, at
    the card tests' shapes: axpy a 1-D grid-stride launch over float4,
    one a thread up to 512 blocks of 256 an SM; the softmax bodies whole warps a
    row, a float4 a thread up to 128 threads, rows of 256 threads a block
    (block (threads a row, rows a block)), every row and column visited
    once, the row in registers up to 2048 columns; an input without rows
    raises."""
    shapes = {"rtc_axpy": [(1, 1), (3, 5), (33, 129), (8192, 8192)],
              "rtc_softmax_forward": [(n, c) for n in (1, 37, 256)
                                      for c in (1, 3, 1000, 4097)]}
    shapes["rtc_softmax_backward"] = shapes["rtc_softmax_forward"]
    for n, c in shapes[name]:
        k = rtc_ops._kernel(name, (n, c))
        (gx, gy, gz), (bx, by, bz) = k._launch_shape(None, None)
        assert (gy, gz, bz) == (1, 1, 1) and k.name == name
        if name == "rtc_axpy":
            assert by == 1 and bx == rtc_ops.AXPY_THREADS
            assert gx == max(1, min(132 * 512, -(-n * c // 1024)))
            assert "i += step" in k._body and "ld(x4 + i)" in k._body
            continue
        threads = min(128, 32 * -(-c // 128))
        assert (bx, by) == (threads, 256 // threads)
        rows = [b * by + ty for b in range(gx) for ty in range(by)]
        assert [r for r in rows if r < n] == list(range(n))
        k_vec = max(1, min(4, -(-c // (4 * threads))))
        assert k._body.startswith("\n  constexpr int kVec = %d;" % k_vec)
        assert (c <= 4 * threads * k_vec) == (c <= 2048)
        for vec in (True, False):
            assert sorted(_softmax_columns(c, vec, k_vec, threads)) == \
                list(range(c))
    with pytest.raises(MXNetError, match="no rows"):
        rtc_ops._kernel(name, (0, 1000))
