"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A package of its own beside the JAX one, with the same module layout.
The kernels the JAX package runs on a TPU are CUDA C++ written for the
H100 (``csrc/``, built at first use by :mod:`._cuda`); the rest is plain
PyTorch.  Entry points run on the card unless the caller passes
``device="cpu"`` or the context ``mx.cpu()``.  These slices are ported:

* serving — :mod:`.serve` runs the built-in transformer LM end to end;
* transformer training — :mod:`.symbol` builds the LM (:mod:`.models`),
  and :class:`.fused.TrainStep` trains it (forward, backward, SGD);
* the MXNet training surface — ``Context``, ``NDArray``, ``Executor``
  (``Symbol.bind``/``simple_bind``), ``io``, ``metric``, ``initializer``
  and :class:`.module.Module`, whose ``fit`` trains ResNet
  (``models.resnet``) through the fused step;
* imperative training — :mod:`.autograd` over torch autograd, and
  :mod:`.gluon` (blocks, layers, losses, ``Trainer``, ``data``, the
  model zoo's ResNets); :mod:`.operator` (``CustomOp``) and :mod:`.rtc`
  (CUDA kernel bodies compiled at run time);
* ops and optimizers — the JAX package's op registry but for the contrib
  ops, ``RNN`` and ``MoE``, every optimizer in its split and fused forms,
  :mod:`.lr_scheduler` and ``clip_global_norm``;
* the rest of the training surface — multi-step dispatch
  (``steps_per_call=K``: K updates as one CUDA-graph replay) with its
  recompile guard (:mod:`.compile_cache`), the model zoo's image
  symbols, and the remaining metrics, initializers, callbacks,
  iterators and ``FeedForward``;
* the serving front — :mod:`.checkpoint` (``CheckpointManager``), the
  replica supervisor and the HTTP gateway (:mod:`.serve`);
* robust training — fp8 matmuls (``MXNET_FP8``, :mod:`.quantize`), the
  loss scaler, step health and the policy monitor (:mod:`.health`),
  remat, and ``Module.fit``'s checkpoint, resume and health options.
"""
from . import (autograd, callback, checkpoint, compile_cache, context,
               executor, fused, gluon, health, initializer, io,
               lr_scheduler, metric, model, models, module, ndarray,
               operator, optimizer, quantize, random, rtc, serve, symbol)
from .base import (MXNetError, StepHung, TrainingDiverged,
                   TrainingPreempted)
from .checkpoint import CheckpointManager, CheckpointState
from .context import Context, cpu, current_context, gpu, tpu
from .model import load_checkpoint, save_checkpoint
from .module import Module
from .ndarray import NDArray

init = initializer
mod = module
nd = ndarray
sym = symbol

__all__ = ["CheckpointManager", "CheckpointState", "Context", "MXNetError",
           "Module", "NDArray", "StepHung", "TrainingDiverged",
           "TrainingPreempted", "autograd", "callback", "checkpoint",
           "compile_cache", "context", "cpu", "current_context", "executor",
           "fused", "gluon", "gpu", "health", "init", "initializer", "io",
           "load_checkpoint", "lr_scheduler", "metric", "mod", "model",
           "models", "module", "nd", "ndarray", "operator", "optimizer",
           "quantize", "random", "rtc", "save_checkpoint", "serve", "sym",
           "symbol", "tpu"]
