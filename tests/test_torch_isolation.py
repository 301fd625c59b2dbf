"""The PyTorch port stands alone: importing it pulls in neither JAX, nor
``ml_dtypes``, nor the JAX package, and no file of it names them."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")


def test_import_leaves_jax_out():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serve, "
            "mxnet_tpu_torch.ops.attention, mxnet_tpu_torch.ops.linear, "
            "mxnet_tpu_torch.ops.nn_ops, mxnet_tpu_torch.symbol, "
            "mxnet_tpu_torch.fused, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.executor, mxnet_tpu_torch.models, "
            "mxnet_tpu_torch.context, mxnet_tpu_torch.random, "
            "mxnet_tpu_torch.ndarray, mxnet_tpu_torch.io, "
            "mxnet_tpu_torch.metric, mxnet_tpu_torch.initializer, "
            "mxnet_tpu_torch.module, mxnet_tpu_torch.model, "
            "mxnet_tpu_torch.callback, mxnet_tpu_torch.ops.pallas_bn, "
            "mxnet_tpu_torch.models.resnet, mxnet_tpu_torch.autograd, "
            "mxnet_tpu_torch.gluon, mxnet_tpu_torch.gluon.model_zoo.vision, "
            "mxnet_tpu_torch.gluon.data, mxnet_tpu_torch.operator, "
            "mxnet_tpu_torch.rtc, mxnet_tpu_torch.testing.rtc_ops, "
            "mxnet_tpu_torch.ops.optimizer_ops, mxnet_tpu_torch.quantize, "
            "mxnet_tpu_torch.lr_scheduler, mxnet_tpu_torch.ops.random_ops, "
            "mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.autotune, "
            "mxnet_tpu_torch.health, mxnet_tpu_torch.serve.supervisor, "
            "mxnet_tpu_torch.serve.gateway; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'mxnet_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _package_files():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, name)


@pytest.mark.parametrize("needle", ["import jax", "mxnet_tpu."])
def test_no_file_names_jax_or_the_jax_package(needle):
    hits = []
    for path in _package_files():
        with open(path, encoding="utf-8") as f:
            for n, line in enumerate(f, 1):
                if needle in line:
                    hits.append("%s:%d" % (os.path.relpath(path, ROOT), n))
    assert not hits, hits
