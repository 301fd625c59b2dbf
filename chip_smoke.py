#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths, its
optimizers and its ops once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line of output each; any failure raises and the script
exits non-zero (it also refuses to run without a CUDA device, or outside
a checkout that holds ``mxnet_tpu_torch/``):

1. card — the card's name and power limit from ``nvidia-smi``, then the
   build of every kernel from ``mxnet_tpu_torch/csrc`` (build seconds).
2. kernels — each hand-written kernel against its plain PyTorch version
   at the serving and training paths' shapes (the fp32 flash forward K1
   at the oracle's block 16 and fp32 training's block 128; its backward
   K4 at fp32 training's n1 h16 T1024 D128 causal, rerun bit-equal,
   linear in g, and no less accurate than half SDPA's fp32 backward
   against fp64 truth; BatchNorm's K5/K6 at ResNet-50's at batch 256;
   the bf16 tensor-core attention K7/K8 at the
   training path's n8 h16 T1024 D128 causal and at 30 ragged and
   head-dim cases, each rerun bit-equal and linear in g, and at the main
   shape no less accurate than SDPA against fp64 truth), with a stated
   tolerance:
   max error, ``kernel_ms``, ``plain_ms``, ``library_ms`` (one PyTorch
   call that computes the same function, timed as a yardstick and used
   nowhere in the port) and ``bound_ms`` (the larger of bytes over 3.35
   TB/s and operations over the peak for the inputs' type: 67 TFLOP/s
   fp32 outside the tensor cores, 989 TFLOP/s bf16 dense, from the H100
   SXM data sheet).  Timings are CUDA-event means over launches on a
   cold L2, each started behind a spin of the device so that the window
   holds the call's device work and not the host's launch path.
   Serving's decode kernels K2 (paged attention: decode over 8 slots at
   18 and at 64 pages, prefills of 256 and 64 rows, and the speculative
   verify's 8 slots x 5 rows at per-row horizons over ~250 tokens; the
   yardstick is
   SDPA over the gathered context, masked to each row's horizon, checked
   against the plain version) and K3 (every projection shape at M = 1,
   8, 40 — the verify's rows — and 256) must give the same bits when run
   again; so must their quantized forms, each also bit-equal to its fp32
   kernel on the dequantized inputs: K2q (the K2 cases over int8 and e4m3
   pages quantized per row; yardstick SDPA over the dequantized context)
   and K3q (int8 and e4m3 weights at M = 8, 40 and 256 for every
   projection; yardstick ``F.linear`` over the dequantized weight; each
   line adds ``chain_floor_ms``, one output's chain of C
   dependent FMAs at ~4 cycles each), and K9 (a decode step's 8 and a
   prefill's 256 K and V rows quantized and appended, byte-equal to the
   plain form; no PyTorch call computes it).  Hybrid stacks' kernels: K1
   with a window of 128 at n1 h16 T1024 D128 block 16 (yardstick SDPA
   with the window as a mask); K2 and K2q (int8, e4m3) over rings of 25
   pages a slot through rotated tables at decode (8 slots, rings
   wrapped), the verify (8 x 5 rows) and a 256-row prefill, every K2 row
   K1's windowed row bit for bit (yardstick SDPA over the ring gathered
   in position order, masked by position); and K10, the SSM scan, at a
   decode step (S8 T1), a 256-row prefill (S1) and the verify (S8 W5,
   every row's state kept), bit-equal to its plain version (no PyTorch
   call computes it; ``instruction_floor_ms`` beside the flop bound: its
   5 D^2 flops a row and head are one fp32 instruction each, since the
   bits forbid FMA).  fp8 training's kernels: K12, the scaled cast,
   at ``FP8_CAST_CASES`` — activations (8192x2048, the FFN down
   projection's 8192x8192), weights (the head's 32768x2048, the QKV
   projection's 6144x2048) and cotangents (8192x32768, 8192x6144: each
   its amax pass and its e5m2 cast) — bit-equal to its plain version (no
   PyTorch call computes it); K11, the fp8 GEMM, at the forward, dx and
   dw products of the LM's five projection shapes at M = 8192 and at two
   edge cases (33 x 33 tiles, more than the card's SMs; N = 2050, whose
   bf16 rows are not 16-byte aligned) (bound over the 1,979 TFLOP/s fp8
   dense peak), within ``FP8_GEMM_NOTE`` of its plain version and rerun
   bit-equal, with ``torch._scaled_mm`` over the same codes as the
   yardstick (none at N = 2050, which it refuses).  The K2/K3
   lines add the
   effective bandwidth (the bound's bytes over the kernel's time) beside
   the card's 3.35 TB/s, the kernel's and the library's times in the
   window without the spin (``*_ms_with_launch``), and their host launch
   paths alone (``*_host_ms``: calls enqueued back to back).  Before
   them, one ``sass`` line (tensor-core instructions in each kernel
   library, from ``cuobjdump --dump-sass``: K7, K8 and K11 must show
   HGMMA) and four ``ptxas`` lines (registers and spills of K7/K8 and
   K11, of K12, of K3 and K2, and of K1 and K4).
3. invariance — rows of the exact projection at M = 256 are
   bit-identical to the same rows computed alone (M = 1), forty at a time
   (M = 40, the verify's rows) and 64 at a time (the smallest prefill
   bucket) at every projection shape, over fp32 weights (K3) and int8 and
   e4m3 codes (K3q), and LayerNorm's rows to the same rows alone.
4. serve — the transformer LM at the width of ``bench_transformer.py``'s
   default model (8 layers, d_model 2048, 16 heads, vocab 32768, max_len
   1024; random weights from seed 0) serves 16 requests through the
   continuous-batching scheduler, every entry point of the session a CUDA
   graph captured once in ``__init__`` (``capture_s``, ``graph_pool_mb``).
   Every request's first-token logits, and every token's logits of two
   whole streams, must equal the port's ``reference_last_logits`` bit for
   bit (``oracle_s``: the wall time of those checks, K1 in each).  Launch
   counts are reset just before this phase and read just after; every
   kernel must have run, and the launches over the scheduler's run must
   equal each graph's replays times the launches it recorded at capture.
   The profile line then gives a full batch's decode steps three ways
   (``sess.step()``, the graph's replays alone, and the eager decode
   function on the same buffers) and one 256-row prefill.
4b. spec — the same 16 requests on speculative sessions (``spec_k`` 4)
   with the drafts ``layers:8`` (the identity draft), ``layers:2`` and
   ``ngram``: every request's stream must equal the serve phase's, the
   identity draft must accept every proposal, and the launches must be
   the graphs' replays.  Each line gives the acceptance rate, tokens per
   verify step, the spec step's host ms, a profiled window of two spec
   steps of a full batch, and the verify and draft graphs' device ms.
4c. quant — the same model and traffic on quantized sessions, weights and
   KV pages both: ``quant="int8", kv_quant="int8"`` and ``quant="fp8",
   kv_quant="e4m3"``.  Every first token's logits and two whole streams
   must equal ``reference_last_logits`` over the session's dequantized
   params at its ``kv_quant``, bit for bit; the run's launches must be the
   graphs' replays and go through K3q, K2q and K9 alone; the logits'
   teacher-forced drift from the fp32 session's stays within
   ``bench_serve.py``'s bounds (int8 0.25, fp8 1.0); at-rest params and a
   KV page must shrink at least 3.9x.  Each line adds the serve line's
   numbers and a ``quant_profile`` line the profile line's.  Then the
   int8 session speculative (``spec_k`` 4, draft ``layers:2``): its streams
   must equal the int8 session's (``quant_spec``).
4d. hybrid — the same model as hybrid stacks, 16 seeded requests of
   300-960 prompt tokens (32 new tokens each, 50 ms apart; prompts above
   the largest bucket admitted as a resume's are, chunked prefill over
   256-row buckets): ``layers="full,window,ssm"`` with window 128 (rings
   of 25 pages wrap, the SSM state crosses up to four chunks), then
   ``layers="window,ssm"`` with int8 rings (admission by slots), each
   bit-exact against the oracle (every first token, two whole streams),
   its run's launches of K2 over pages and rings, K3, K9 and K10 the
   graphs' replays times the launches recorded, the oracle's K1, K1
   windowed and K10 launches one a layer of their kind a check; ring and
   state MB and a profile of the first.  Then the first under ``spec_k``
   4 with the ``ngram`` draft: every stream equal to its plain run's.
4e. gateway — the serve phase's model saved by the port's
   ``CheckpointManager`` (v2, SHA-256 verify on) into a temporary
   directory, restored twice through ``InferenceSession.from_checkpoint``
   (``num_heads`` from the saved transformer symbol) into a two-replica
   ``ReplicaSet`` behind a ``Gateway`` on ``127.0.0.1:0``; the serve
   phase's 16 requests sent 50 ms apart by client threads over HTTP/SSE,
   every stream equal to the serve phase's token for token (tokens/s,
   TTFT p50/p99 at the client's first SSE event); then the same traffic
   with one replica killed mid-run (``serve_replica_kill``: zero requests
   lost, every stream equal, the replica rejoins cold), one client that
   disconnects after its first event (afterwards each replica's
   ``state_report()`` equals its pre-traffic snapshot), and a drain that
   flips ``/readyz`` to 503 while the streams in flight finish whole.
   The phase's K3 and K2 launches must equal both replicas' replays
   times the launches recorded; checkpoint save/load seconds and bytes,
   capture seconds, failovers, sheds and rejoins in the ``gateway`` line.
5. train — the same LM trains through ``models.transformer.get_symbol``
   -> ``fused.TrainStep(optimizer="sgd", compute_dtype="bfloat16")`` ->
   ``init_state(seed=0)`` at ``bench_transformer.py``'s default (T 1024,
   batch 8; SGD lr 1e-3, momentum 0.9, rescale_grad 1/8): one warm-up
   and five timed steps.  The cross-entropy at the labels and every
   parameter must be finite, and attention must have run through K7 and
   K8 (bf16) exactly once per layer per step.  Then one profiled step.
5b. optim — the same LM in bf16 through ``fused.TrainStep(optimizer=
   "adam", optimizer_params={"learning_rate": 3e-4, "wd": 0.01,
   "clip_global_norm": 1.0, "rescale_grad": 1/8})`` (JAX's default betas
   and epsilon), the learning rate ``CosineScheduler(max_update=16,
   base_lr=3e-4, warmup_steps=2)(t)`` each call: 8 steps on one repeated
   batch, the first a warm-up, 5 timed (step ms, tokens/s, TFLOP/s as
   ``bench_transformer.py:120-123`` counts them, peak memory), one
   profiled (K7, K8, GEMMs, the rest).  K7 and K8 must run once per layer
   a step, the loss and every parameter stay finite, and the
   cross-entropy must fall over the 8 steps.  Then an ``optim_update``
   line: each optimizer's ``fused_update`` over every parameter of the
   LM (CUDA-event mean behind the spin) beside its byte bound.
5c. robust — the same LM through ``fused.TrainStep(optimizer="adam",
   compute_dtype="bfloat16", health=StepHealth(DynamicLossScaler(
   init_scale=2**15, growth_interval=1000)))`` built under
   ``MXNET_FP8=on``: every FullyConnected and MultiHeadAttention
   projection runs K12 and K11.  13 steps on one batch: the
   cross-entropy must fall, the amax history fill one column a step, and
   K11 and K12 launch 3 and 4 times a site a step (steps 2-13; the count
   of sites comes from one forward probe).  Step ms, tokens/s and TFLOP/s
   over steps 2-6 and again over steps 7-11 (``*_steady``), beside the
   bf16 step's without and with step health timed the same way in the
   same call, and one step of each profiled (``profile_fp8_health``,
   ``profile_bf16_health``: device time by ``FP8_STEP_GROUPS``, idle
   share).  Then
   one poisoned batch (a token id at V looks up a NaN row) must be
   skipped with params and Adam states bit-equal and the scale halved
   (and the skip's select timed alone); and two steps with
   ``remat=True`` must give the update of two without, bit for bit, with
   the second step's peak memory over its forward, backward and update,
   under Adam and under SGD without momentum.  Then ``bench_fit.py``'s
   MLP through ``Module.fit(
   checkpoint=, health="skip", loss_scale="dynamic", step_timeout_s=,
   steps_per_call=4)`` under ``MXNET_FP8=auto`` (K11/K12 inside the
   captured calls): once through, and once preempted by its own SIGTERM
   after 5 calls and resumed from the final checkpoint (which carries the
   loss scale and the amax history), params bit-equal to the
   uninterrupted fit.
6. train-parity — one step of the kernel path against one step under
   ``MXNET_ATTN_IMPL=reference`` from one state, by the per-tensor
   relative L2 error of the parameter update: fp32 at full width with 2
   layers and batch 2 (bound 1e-3), under SGD and once more under Adam
   with ``clip_global_norm`` (epsilon 1e-6, see ``ADAM_PARITY``), and
   bf16 with all 8 layers and batch
   8, where both bf16 steps are also held against the fp32 reference
   step and the kernel path must be no less accurate than the
   reference.  The fp32 step runs K1/K4, the bf16 one K7/K8; launches
   are counted over each.  The fp32 SGD kernel step is then timed (host
   clock, synced) and profiled for K1's and K4's device time.
7. resnet — ResNet-50 (``models.resnet.get_symbol(num_classes=1000,
   num_layers=50, image_shape=(3, 224, 224))``, NCHW, ``bench.py``'s
   model at full width) trains through ``mx.mod.Module(sym,
   context=mx.gpu(0)).fit(NDArrayIter(...), optimizer="sgd",
   compute_dtype="bfloat16")`` for 2 epochs of 1024 numpy-seeded images
   at batch 256 (8 steps; ``bench.py`` runs batch 512, cut here because
   the eager step keeps every saved activation).  Parameters and moving
   statistics must be finite and changed, the accuracy finite, and every
   training-mode BatchNorm node must launch K5 and K6 exactly once a
   step.  Then one profiled step.
7b. nag — the same ResNet-50 through ``Module.fit`` at batch 256 in bf16
   for 4 steps with ``optimizer="nag"`` (momentum 0.9, wd 1e-4, lr 0.1)
   under ``MultiFactorScheduler(step=[2], factor=0.1)``,
   ``examples/image-classification/common/fit.py``'s configuration:
   every step's learning rate must be the schedule's, every parameter
   finite and changed; img/s over steps 2-4.
8. resnet-parity — one bf16 ResNet-50 ``Module`` step at 224×224, batch
   16, through K5/K6 and once more with the plain sums patched in for
   the kernel wrappers (and once with fp64-accumulated sums, the logged
   noise yardstick), all held against the fp32 step from the same state
   (TF32 off) by each parameter's and moving statistic's update: the
   kernel path's mean and median error at most 1.1x the plain path's,
   and at most 1.5x per tensor wherever the bf16 update tracks the fp32
   one (plain error < 0.5).
9. gluon — the same ResNet-50 as Gluon's model zoo builds it
   (``vision.resnet50_v1(classes=1000)``, 224x224, NCHW, full width,
   Xavier(gaussian, in, 2), ``cast("bfloat16")``) trains imperatively:
   ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` -> ``backward()``
   -> ``Trainer("sgd", lr 0.1, momentum 0.9, multi_precision).step(256)``
   over ``DataLoader(ArrayDataset(X, Y), batch_size=256, shuffle=True)``,
   2 epochs of 1024 numpy-seeded images (8 steps; batch 256 where
   ``bench.py`` trains 512, as in the resnet phase).  The loss must be
   finite every step, every parameter and running statistic finite and
   changed, K5 and K6 launched exactly once per BatchNorm block a step
   (counted from the net), and ``hybridize()`` must give the imperative
   forward's logits bit for bit (both run the same eager ops).  Then one
   profiled step.
10. custom-op — the rtc facility's own path, then the loss head as an
   rtc-backed ``CustomOp``: ``CudaKernel`` runs ``o = 2x + y`` through
   ``__call__`` and ``push`` at (16, 128) and (8192, 8192); the Gluon
   ResNet-50 trains 4 more steps with its loss head
   ``nd.Custom(net(x).astype("float32"), y, op_type="rtc_softmax")``
   (both rtc softmax kernels once a step, loss finite, parameters
   changed); ``Module.fit`` trains PR 3's ResNet-50 symbol with its
   ``SoftmaxOutput`` replaced by ``sym.Custom(fc1, label,
   op_type="rtc_softmax")`` at batch 64 for 2 steps; and on one batch the
   logits' gradient through the rtc head must equal
   ``SoftmaxCrossEntropyLoss``'s divided by N.
11. ops — every case of the op sweep's table that the port registers
   (``mxnet_tpu_torch/testing/op_specs.py``, the port's copy of
   ``tests/test_op_sweep.py``'s, 295 cases) on the card and on the
   port's CPU from the same inputs, TF32 off, compared as
   ``tests/test_torch_op_sweep.py`` compares (rtol 1e-5, atol 1e-6);
   samplers by shape, dtype and device, and 12 of them by the mean and
   variance of 10^5 draws.  Any failure fails the run; the ops that
   synchronise the host under ``torch.cuda.set_sync_debug_mode("warn")``
   are listed, not failed.
12. multistep — ``bench_fit.py``'s own recipe on the card: the MLP
   ``FC 1024 -> relu -> FC 1024 -> relu -> FC 10 -> SoftmaxOutput`` over
   512 features, batch 64, 32 batches an epoch from ``RandomState(0)``,
   ``Xavier``, SGD lr 0.01, through ``Module.fit(prefetch_to_device=True,
   steps_per_call=16, metric_sync_period=50)`` for 8 epochs, and again at
   ``steps_per_call=1``: img/s over the epochs after the first at both,
   the pure-step rate (``TrainStep`` over one resident batch, as
   ``bench_fit.py`` measures it, and the captured 16-step call over one
   resident super-batch), ``pipeline_efficiency`` (fit over pure step),
   capture seconds, graph pool MB, and the replays, which must equal the
   batches / 16.  The K = 16 fit's parameters must equal the K = 1
   fit's within rtol 1e-5, atol 1e-6 (TF32 off).  Then, under SGD with
   momentum and under Adam with ``clip_global_norm``, one captured
   16-step call must equal the same 16 steps run eagerly
   (``TrainStep.run_eager``) bit for bit, and a second replay at a new lr
   and first step number must equal the eager loop at those values.
13. zoo — the model zoo's seven other symbols at their published widths
   through ``Module.fit`` in bf16, SGD momentum 0.9, lr 0.01,
   ``steps_per_call=4``, 2 calls (8 steps) over numpy-seeded images,
   batch 128: lenet and mlp at 1x28x28 and 10 classes; alexnet, vgg16,
   inception_bn and mobilenet at 3x224x224, inception_v3 at 3x299x299,
   1000 classes.  Each graph is captured before the fit
   (``TrainStep.compile``).  Per model: img/s over the second call,
   capture seconds, pool MB; the cross-entropy finite; every parameter
   and moving statistic finite and changed; for the BatchNorm models K5
   and K6 launched exactly once per training-mode BatchNorm a step (8 x
   the count from the symbol, i.e. 2 replays x the launches recorded);
   for alexnet and vgg16 one more replay over four copies of one batch at
   lr 0 with the momentum zeroed, whose inner steps' outputs must differ
   (each inner step draws its own dropout masks).
14. a ``wall`` line (the script's seconds and the new phases'), a
   ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, data sheet
SM_CLOCK_HZ = 1.98e9        # H100 SXM boost clock, data sheet
CHAIN_CYCLES = 4            # latency of one dependent fp32 FMA
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
# fp32 instructions a second (132 SMs x 128 lanes at the boost clock): the
# floor of a kernel that may not contract a multiply and an add into FMA
FP32_INSTR_PER_S = 132 * 128 * SM_CLOCK_HZ
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 dense tensor cores
FP8_FLOP_PER_S = 1979e12    # H100 SXM fp8 dense tensor cores
# the device spin before each timed call: 0.5 ms at the H100's 1.98 GHz
# boost clock, longer than the host takes to launch one wrapper
SPIN_CYCLES = 1_000_000
ATTN_ATOL = 1e-5
ATTN_NOTE = ("atol 1e-5: fp32 on both sides; the D = 128 score dots and "
             "the per-block sums run in other orders, ~100 units of "
             "roundoff at these magnitudes")
LSE_ATOL = 5e-5
# K7/K8 against fp64 truth: max and mean |error| of out, dq, dk, dv each
# at most 1.25x SDPA's, which rounds P to bf16 the same way
SM90_FP64 = 1.25
SM90_FP64_NOTE = ("max and mean |error| against an fp64 materialised "
                  "attention and its gradients, each <= 1.25 x SDPA's")
# K4 against fp64 truth at the training shape: max and mean |error| of
# dq, dk, dv each at most 2x SDPA's fp32 backward's
K4_FP64 = 2.0
K4_FP64_NOTE = ("max and mean |error| of dq, dk, dv against an fp64 "
                "materialised attention's gradients, each <= 2 x SDPA's "
                "fp32 backward's")
# K4 against the plain version at n1 h16 T1024 D128, from the fp64
# comparison at this shape (the k4_accuracy line; NVIDIA H100 80GB HBM3,
# 700 W): K4's dq, dk, dv lay within 2.9e-6 of fp64 truth and the plain
# version's within 7.6e-6 (its dV a single FMA chain over 1024 queries),
# so the two lie within 1.1e-5 of each other; 2e-5 leaves room for
# other inputs
K4_T1024_ATOL = 2e-5
K4_T1024_NOTE = ("atol 2e-5: K4 within 2.9e-6 and the plain version "
                 "within 7.6e-6 of fp64 truth at this shape (k4_accuracy "
                 "line), within 1.1e-5 of each other")
BWD_ATOL = 2e-5
BWD_NOTE = ("atol 2e-5: fp32 on both sides, sums over up to 37 terms of "
            "order 1 in other orders")
# train-parity bounds on the per-tensor relative L2 error of the update
PARITY_FP32 = 1e-3
PARITY_FP32_NOTE = ("fp32 everywhere; only the attention's summation order "
                    "differs between K1/K4 and the materialized reference")
# bf16: the kernel path (K7/K8) keeps scores, the softmax statistics and
# the normalisation in fp32 and rounds only P and dS for its products,
# where the materialized reference rounds the scores and the normalised
# probabilities to bf16, so against the fp32 step
# (the truth) it must be no less accurate: its mean error over tensors at
# most the reference's, and no tensor's error above 1.5 times the
# reference's (one step's noise on single tensors: the plain versions on
# the CPU at d_model 64 with 2 and 4 layers give at most 1.25)
PARITY_BF16_RATIO = 1.5
PARITY_BF16_NOTE = ("against the fp32 reference step on the same token "
                    "ids: mean kernel error <= mean reference error, and "
                    "every tensor's kernel error <= 1.5 x its reference "
                    "error")
# rtc kernels against their plain versions: 2x + y and the softmax
# backward are one or two fp32 operations a value on both sides (2x is
# exact; -fmad=false keeps the add separate), so they must agree bit for
# bit; the softmax forward takes expf against torch's exp and sums its
# row in another order
RTC_EXACT_NOTE = "bit-equal: the same fp32 operations in the same order"
RTC_SOFTMAX_ATOL = 1e-6
RTC_SOFTMAX_NOTE = ("atol 1e-6 on probabilities <= 1: fp32 on both sides, "
                    "one row max and one row sum of 1000 terms each, expf "
                    "against torch's exp")
# custom-op: the rtc head's logit gradient (p - onehot)/N against
# SoftmaxCrossEntropyLoss's gradient / N: both p within 1e-6 of each other
HEAD_GRAD_ATOL = 2e-6
HEAD_GRAD_NOTE = ("|diff| <= 2e-6 / N: the rtc softmax within 1e-6 of "
                  "torch's, and log_softmax's gradient forms exp(log p) - "
                  "onehot, one more rounding")
LINEAR_SLACK = 2.0
LINEAR_NOTE = ("|diff| <= 2 C 2^-24 (|x| |w|^T + |b|): the worst-case "
               "fp32 error of two summation orders over C terms")


RTC_KERNELS = ("rtc_axpy", "rtc_softmax_forward", "rtc_softmax_backward")


def log(phase, **fields):
    print("%s %s" % (phase, json.dumps(fields, sort_keys=True)), flush=True)


SM90_STEMS = ("flash_attention_sm90", "flash_attention_backward_sm90",
              "fp8_gemm")


def kernel_sass(build_dir):
    """Tensor-core instructions in each kernel library's SASS
    (``cuobjdump --dump-sass``): HGMMA (16-bit wgmma), QGMMA (fp8 wgmma)
    and HMMA (mma.sync) counts per source.  K7 and K8 must show HGMMA,
    K11 QGMMA."""
    from mxnet_tpu_torch import _cuda

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    counts = {}
    for stem in sorted({stem for stem, _, _ in _cuda.KERNELS.values()}):
        text = subprocess.run(
            [tool, "--dump-sass", os.path.join(build_dir, "lib%s.so" % stem)],
            capture_output=True, text=True, check=True).stdout
        counts[stem] = {op: len(re.findall(r"\b%s\." % op, text))
                        for op in ("HGMMA", "QGMMA", "HMMA")}
    missing = [stem for stem in SM90_STEMS
               if not counts[stem]["HGMMA"] + counts[stem]["QGMMA"]]
    if missing:
        raise AssertionError("no wgmma (HGMMA/QGMMA) in the SASS of %r"
                             % missing)
    return counts


def kernel_name(symbol):
    """A kernel's name and integer template arguments from its mangled
    symbol (``_ZN12_GLOBAL__N_113linear_kernelILi64E...`` ->
    ``linear_kernel<64,...>``), also those inside a class argument
    (``...dq_kernelINS_3CfgILi4EEEEEv...`` -> ``dq_kernel<4>``)."""
    if not symbol.startswith("_Z"):
        return symbol
    i = 3 if symbol.startswith("_ZN") else 2
    name = symbol
    while True:
        n = re.match(r"\d+", symbol[i:])
        if not n:
            break
        i += n.end()
        name = symbol[i:i + int(n.group())]
        i += int(n.group())
    args = (re.findall(r"L[a-z]+(-?\d+)E", symbol[i:])
            if symbol[i:i + 1] == "I" else [])
    if args:
        name += "<%s>" % ",".join(args)
    return name


def ptxas_report(build_dir, stems):
    """Registers and spill bytes of every kernel of ``stems``, from the
    ``-Xptxas -v`` log the build keeps beside each library."""
    out = {}
    for stem in stems:
        name = None
        with open(os.path.join(build_dir, "lib%s.log" % stem)) as f:
            for line in f:
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    name = kernel_name(m.group(1))
                    out[name] = {}
                    continue
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m and name:
                    out[name].update(spill_stores=int(m.group(1)),
                                     spill_loads=int(m.group(2)))
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    out[name]["registers"] = int(m.group(1))
    return out


def sm90_invariants(A, q, k, v, out, lse, g, causal, scale, got):
    """K8 (``got`` = its (dq, dk, dv) at ``g``) gives the same bits when run
    again, and exactly twice its result at 2 g (no atomics; every step is
    linear in dO and doubling is exact in fp32 and bf16)."""
    import torch

    again = A._flash_backward_cuda(q, k, v, out, lse, g, causal, scale, 128)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("K8: a rerun gave other bits")
    twice = A._flash_backward_cuda(q, k, v, out, lse, 2 * g, causal, scale,
                                   128)
    if not all(torch.equal(2 * a, b) for a, b in zip(got, twice)):
        raise AssertionError("K8: the result at 2 g is not twice that at g")


def fp64_accuracy(q, k, v, g, scale, kernel, library, plain=None):
    """Max and mean |error| of ``kernel`` and ``library`` (each (out, dq,
    dk, dv) of causal attention over (n, h, T, D) inputs) against an fp64
    materialised attention and its gradients, one batch row at a time;
    with the kernel's error over the library's, and the ``plain``
    version's errors where it is given."""
    import torch

    names = ("out", "dq", "dk", "dv")
    sums = {name: [0.0] * 6 for name in names}
    t = q.shape[-2]
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    for i in range(q.shape[0]):
        q64, k64, v64, g64 = (x[i].double() for x in (q, k, v, g))
        p = torch.softmax((q64 @ k64.transpose(-1, -2) * scale)
                          .masked_fill(~mask, -torch.inf), -1)
        o = p @ v64
        ds = p * (g64 @ v64.transpose(-1, -2)
                  - (g64 * o).sum(-1, keepdim=True))
        truth = (o, scale * (ds @ k64), scale * (ds.transpose(-1, -2) @ q64),
                 p.transpose(-1, -2) @ g64)
        for j, name in enumerate(names):
            for side, res in ((0, kernel), (2, library), (4, plain)):
                if res is None:
                    continue
                e = (res[j][i].double() - truth[j]).abs()
                sums[name][side] = max(sums[name][side], e.max().item())
                sums[name][side + 1] += e.sum().item()
        del p, o, ds, truth
    count = q.numel()
    out = {}
    for name, (kmax, ksum, lmax, lsum, pmax, psum) in sums.items():
        out[name] = dict(kernel_max=kmax, kernel_mean=ksum / count,
                         sdpa_max=lmax, sdpa_mean=lsum / count,
                         max_ratio=kmax / max(lmax, 1e-30),
                         mean_ratio=ksum / max(lsum, 1e-30))
        if plain is not None:
            out[name].update(plain_max=pmax, plain_mean=psum / count)
    return out


def seeded_requests(cfg, n_requests, prompt_lens, max_new, arrival_gap_s):
    """The serve and spec phases' traffic: ``n_requests`` greedy requests
    of numpy-seeded prompts, ``arrival_gap_s`` apart."""
    from mxnet_tpu_torch import serve

    rs = np.random.RandomState(0)
    return [serve.Request(rid=i, prompt=rs.randint(
                1, cfg.vocab_size,
                size=int(rs.randint(prompt_lens[0], prompt_lens[1] + 1))
            ).tolist(), max_new=max_new, arrival_s=arrival_gap_s * i)
            for i in range(n_requests)]


def admit_long_prompts(sess):
    """Let the scheduler admit prompts longer than the session's largest
    bucket the way it admits a preempted request's transcript
    (``try_alloc(resume=True)``): chunked prefill covers them at
    page-aligned offsets, and the slot's page reservation still bounds
    them.  The JAX package's ``try_alloc`` refuses such a prompt unless
    ``resume``; the hybrid phase's long-context traffic needs it."""
    alloc = sess.try_alloc

    def try_alloc(prompt_len, max_new=None, tokens=None, resume=False):
        return alloc(prompt_len, max_new, tokens=tokens, resume=True)

    sess.try_alloc = try_alloc


def replayed_launches(sess, launched):
    """Hold the kernel launches counted over a run (``launched``) against
    the session's graph replays in that run times the launches each graph
    recorded at capture; they must be equal (on the CPU both are empty).
    Returns the replays by entry point.  Resets the session's replay
    counts."""
    rep = sess.graph_report()
    want = {}
    for name, per in rep["launches_per_replay"].items():
        for kernel, n in per.items():
            want[kernel] = want.get(kernel, 0) + rep["replays"][name] * n
    got = {k: n for k, n in launched.items() if n}
    if got != want:
        raise AssertionError("kernel launches %r are not the graphs' "
                             "replays x their launches %r" % (got, want))
    for exe in sess.executables.values():
        exe.replays = 0
    return rep["replays"]


def serve_phase(dev, cfg, sconf, n_requests, prompt_lens, whole_streams=2,
                arrival_gap_s=0.05, params=None, max_new=None,
                long_prompts=False):
    """Serve ``n_requests`` greedy requests of numpy-seeded prompts through
    the continuous-batching scheduler on a session over ``params``
    (default ``init_params(cfg, seed=0)``; on the card its entry points
    are captured as CUDA graphs), then hold every request's first-token
    logits, and every token's logits of ``whole_streams`` streams,
    against ``reference_last_logits`` bit for bit — at the session's
    precision: over its dequantized params and at its ``kv_quant``.
    Each request asks ``max_new`` tokens (default ``sconf.max_new``);
    ``long_prompts`` admits prompts above the largest bucket
    (:func:`admit_long_prompts`).  Returns the session, the phase's
    numbers (``run_launches``: the kernel launches of the scheduler's
    run; ``oracle_launches``: those of the oracle's checks) and each
    request's token stream."""
    import torch

    from mxnet_tpu_torch import _cuda, serve

    if params is None:
        params = serve.init_params(cfg, seed=0, device=dev)
    t0 = time.perf_counter()
    sess = serve.InferenceSession(params, num_heads=cfg.num_heads,
                                  config=sconf, device=dev)
    session_s = time.perf_counter() - t0
    if long_prompts:
        admit_long_prompts(sess)
    max_new = sconf.max_new if max_new is None else max_new
    reqs = seeded_requests(cfg, n_requests, prompt_lens, max_new,
                           arrival_gap_s)

    # record what a client sees: per stream, each transcript beside the
    # logits that chose its next token
    streams, slot_stream, step_ms = [], {}, []
    prefill_fn, step_fn = sess.prefill, sess.step

    def prefill(slot, prompt):
        first, logits = prefill_fn(slot, prompt)
        slot_stream[slot] = {"seq": list(prompt) + [first],
                             "checks": [(list(prompt), logits)]}
        streams.append(slot_stream[slot])
        return first, logits

    def step():
        t0 = time.perf_counter()
        toks, logits = step_fn()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for slot, tok in toks.items():
            st = slot_stream[slot]
            st["checks"].append((list(st["seq"]), logits[slot].copy()))
            st["seq"].append(tok)
        return toks, logits

    sess.prefill, sess.step = prefill, step
    before = dict(_cuda.launches)
    done, makespan = serve.Scheduler(sess, policy="continuous").run(reqs)
    run_launches = {k: n - before[k] for k, n in _cuda.launches.items()}
    replays = replayed_launches(sess, run_launches)
    summary = serve.summarize(done, makespan)
    failed = [r.rid for r in done if r.failed]
    if failed or summary["completed"] != n_requests:
        raise AssertionError("requests failed: %r" % failed)
    if any(len(r.tokens) != max_new for r in done):
        raise AssertionError("a request stopped short of max_new")
    checked = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_oracle = time.perf_counter()
    before = dict(_cuda.launches)
    oracle_params = sess.dequantized_params()
    for sid, st in enumerate(streams):
        for seq, logits in st["checks"][:None if sid < whole_streams else 1]:
            if not np.isfinite(logits).all():
                raise AssertionError("non-finite logits in stream %d" % sid)
            ref = serve.reference_last_logits(
                oracle_params, seq, sess.model, sconf.page_size,
                exact=sconf.exact, kv_quant=sconf.kv_quant).cpu().numpy()
            if not np.array_equal(logits, ref):
                raise AssertionError(
                    "stream %d at length %d: logits differ from the "
                    "reference by %.3g" % (sid, len(seq),
                                           np.abs(logits - ref).max()))
            checked += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t_oracle
    oracle_launches = {k: n - before[k] for k, n in _cuda.launches.items()
                       if n > before[k]}
    del oracle_params
    sess.prefill, sess.step = prefill_fn, step_fn
    graphs = sess.graph_report()
    return sess, dict(requests=n_requests, completed=summary["completed"],
                tokens=summary["total_tokens"],
                tokens_per_s=summary["tokens_per_sec"],
                ttft_p50_ms=summary["ttft_p50_s"] * 1e3,
                ttft_p99_ms=summary["ttft_p99_s"] * 1e3,
                decode_step_ms_mean=float(np.mean(step_ms)),
                decode_steps=len(step_ms), makespan_s=makespan,
                bitexact_logits_checked=checked, oracle_s=oracle_s,
                oracle_ms_per_check=oracle_s * 1e3 / max(checked, 1),
                session_s=session_s, capture_s=graphs["capture_s"],
                graph_pool_mb=(graphs["graph_pool_bytes"] or 0) / 2.0 ** 20,
                kv_pool_mb=sess.cache.pool_bytes() / 2.0 ** 20,
                replays=replays, run_launches=run_launches,
                oracle_launches=oracle_launches,
                launches_per_replay=graphs["launches_per_replay"]), \
        {r.rid: list(r.tokens) for r in done}


def profiled_window(fn, groups):
    """Run ``fn`` under ``torch.profiler``; the device time of its kernels
    by group (``groups``: (name, substrings of the kernel's name)), the
    rest as ``other``, and the device's idle share of the wall time.
    Only device-side events count: a CPU op's device time repeats the
    time of the kernels it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
    count = dict.fromkeys(by, 0)
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        name = next((g for g, keys in groups
                     if any(k in ev.key for k in keys)), "other")
        by[name] += ev.self_device_time_total / 1e3
        count[name] += ev.count
        key = ev.key[:60]
        kernels[key] = kernels.get(key, 0.0) + ev.self_device_time_total / 1e3
    busy = sum(by.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=max(0.0, 1.0 - busy / wall_ms),
                device_ms_by_group=by, kernels_by_group=count,
                top_kernels_ms=dict(top))


# the ring and prefill kernels' first template argument is the weight or
# page type: 0 fp32 (K3, K2), 1 int8 and 2 e4m3 (K3q, K2q)
SERVE_GROUPS = (("mi_linear", ("linear_kernel", "linear_stream_kernel",
                               "linear_ring_kernel<0,")),
                ("paged_attention", ("paged_attention_kernel",
                                     "paged_prefill_kernel<0,")),
                ("flash_attention", ("flash_forward_kernel",)),
                ("mi_linear_q", ("linear_q_kernel", "linear_q_stream_kernel",
                                 "linear_ring_kernel<1,",
                                 "linear_ring_kernel<2,")),
                ("paged_attention_q", ("paged_attention_q_kernel",
                                       "paged_prefill_kernel<1,",
                                       "paged_prefill_kernel<2,")),
                ("kv_append_quantized", ("kv_quant_kernel",)),
                ("ssm_scan", ("ssm_scan_kernel",)))


def replay_ms(exe, reps=20):
    """CUDA-event mean of ``reps`` back-to-back replays of ``exe``'s graph
    over the inputs its last call left in its buffers: the graph's device
    time without the host's part of a step (the weights, ~2 GB a decode
    step, dwarf the 50 MB L2, so no flush)."""
    import torch

    exe.graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        exe.graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def fill_slots(sess, prompt_len=250, seed=1):
    """Admit and prefill a request of ``prompt_len`` seeded tokens into
    every slot; returns the prompts, one more than the slots."""
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(1, sess.model.vocab_size, size=prompt_len).tolist()
               for _ in range(sess.config.slots + 1)]
    for prompt in prompts[:-1]:
        sess.prefill(sess.try_alloc(prompt_len, sess.config.max_new), prompt)
    return prompts


def profile_phase(sess, steps=4):
    """Device time by kernel over ``steps`` decode steps of a full batch
    (every slot at a 250-token prompt) — the replayed graph through
    ``sess.step()``, the graph's replays alone, and the eager decode
    function on the same buffers (the yardstick the graph replaces) —
    and over one 256-row prefill, with the device's idle share of each
    window."""
    prompts = fill_slots(sess)
    sess.step()  # warm
    exe = sess.executables["decode"]

    def decode():
        for _ in range(steps):
            sess.step()

    def eager():  # the last step again: the same rows, the same bits
        for _ in range(steps):
            exe.fn(**exe.inputs)

    out = {"decode_steps": steps,
           "decode": profiled_window(decode, SERVE_GROUPS),
           "decode_eager": profiled_window(eager, SERVE_GROUPS),
           "decode_replay_ms": replay_ms(exe)}
    eager()  # warm again after the profiler
    slot = sess.active_slots()[-1]
    sess.release(slot)
    slot = sess.try_alloc(250, sess.config.max_new)
    out["prefill_256"] = profiled_window(
        lambda: sess.prefill(slot, prompts[-1]), SERVE_GROUPS)
    for slot in sess.active_slots():
        sess.release(slot)
    return out


def spec_phase(dev, cfg, params, sconf, reqs, want, steps=2,
               long_prompts=False):
    """Serve ``reqs`` again on a speculative session (``sconf``'s
    ``spec_k`` and ``draft``) over the serve phase's ``params``: every
    request's stream must equal ``want`` (the serve phase's), the launches
    must be the graphs' replays, and the identity draft (all the target's
    layers) must accept every proposal.  Then ``steps`` spec steps of a
    full batch at 250-token prompts are profiled and the verify and draft
    graphs timed alone.  ``long_prompts`` as in :func:`serve_phase`.
    Returns the phase's numbers."""
    from mxnet_tpu_torch import _cuda, serve

    sess = serve.InferenceSession(params, num_heads=cfg.num_heads,
                                  config=sconf, device=dev)
    if long_prompts:
        admit_long_prompts(sess)
    step_ms = []
    spec_fn = sess.spec_step

    def spec_step(limits=None):
        t0 = time.perf_counter()
        out = spec_fn(limits)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    sess.spec_step = spec_step
    before = dict(_cuda.launches)
    done, makespan = serve.Scheduler(sess, policy="continuous").run(reqs)
    replays = replayed_launches(sess, {k: n - before[k] for k, n
                                       in _cuda.launches.items()})
    got = {r.rid: list(r.tokens) for r in done}
    if any(r.failed for r in done) or got != want:
        bad = [r.rid for r in done if r.failed or got[r.rid] != want[r.rid]]
        raise AssertionError("spec draft %s: streams of requests %r differ "
                             "from the serve phase's" % (sconf.draft, bad))
    rep = sess.spec_report()
    if sconf.draft == "layers:%d" % cfg.num_layers \
            and rep["acceptance_rate"] != 1.0:
        raise AssertionError("the identity draft accepted %r, not all"
                             % rep["acceptance_rate"])
    summary = serve.summarize(done, makespan)
    sess.spec_step = spec_fn
    graphs = sess.graph_report()
    out = dict(draft=sconf.draft, spec_k=sconf.spec_k, requests=len(reqs),
               streams_equal_serve=True, tokens=summary["total_tokens"],
               tokens_per_s=summary["tokens_per_sec"],
               ttft_p50_ms=summary["ttft_p50_s"] * 1e3,
               ttft_p99_ms=summary["ttft_p99_s"] * 1e3,
               makespan_s=makespan, spec_steps=len(step_ms),
               spec_step_ms_mean=float(np.mean(step_ms)),
               capture_s=graphs["capture_s"],
               graph_pool_mb=(graphs["graph_pool_bytes"] or 0) / 2.0 ** 20,
               replays=replays,
               launches_per_replay=graphs["launches_per_replay"], **rep)
    if dev.type == "cuda":
        fill_slots(sess)
        sess.spec_step()  # warm
        out["profile_steps"] = steps
        out["profile"] = profiled_window(
            lambda: [sess.spec_step() for _ in range(steps)], SERVE_GROUPS)
        for name in ("verify", "draft"):
            if name in sess.executables:
                out["%s_replay_ms" % name] = replay_ms(
                    sess.executables[name])
        for slot in sess.active_slots():
            sess.release(slot)
    return out


# bench_serve.py's bounds on a quantized session's teacher-forced logit
# drift from the fp32 session's
DRIFT_BOUND = {"int8": 0.25, "fp8": 1.0}
BYTES_SHRINK = 3.9  # at-rest params and KV page bytes, fp32 over 1-byte


def logit_drift(sess, qsess, prompt, steps=6):
    """Largest |logit difference| of ``qsess`` from the fp32 ``sess`` over
    one prompt's prefill and ``steps`` decode steps, the quantized session
    fed the fp32 session's tokens (teacher forcing, as ``bench_serve.py``
    measures it), so both score the same sequence."""
    steps = min(steps, sess.config.max_new - 1)
    bslot = sess.try_alloc(len(prompt), steps + 1)
    qslot = qsess.try_alloc(len(prompt), steps + 1)
    _, blog = sess.prefill(bslot, prompt)
    _, qlog = qsess.prefill(qslot, prompt)
    drift = float(np.abs(qlog - blog).max())
    for _ in range(steps):
        qsess._slot_tokens[qslot] = sess._slot_tokens[bslot]
        _, blogs = sess.step()
        _, qlogs = qsess.step()
        drift = max(drift, float(np.abs(qlogs[qslot] - blogs[bslot]).max()))
    sess.release(bslot)
    qsess.release(qslot)
    return drift


# the hybrid phase: the serving LM's layers as full,window,ssm cycled over
# its 8 layers (f,w,s,f,w,s,f,w), windows of 128 keys, serving's slots,
# pages and buckets; requests of 300-960 prompt tokens ask 32 tokens each.
# The session's max_new is its reservation cap: a full layer holds a
# 960-token prompt and its 32 new tokens in 62 pages (256 + 736 = 992)
HYBRID_WINDOW = 128
HYBRID_PROMPTS = (300, 960)
HYBRID_NEW = 32


def hybrid_phases(dev, cfg, smi):
    """Serve the serve phase's model as hybrid stacks on the card, 16
    seeded requests of 300-960 prompt tokens 50 ms apart (rings of 25
    pages wrap; a prompt's SSM state crosses up to four 256-row chunks):
    ``layers="full,window,ssm"``; ``layers="window,ssm"`` with int8 KV
    rings, which admits by slots; and ``spec_k=4`` with the ngram draft on
    the first stack, whose streams must equal its plain decode's.  Every
    first token's logits and two whole streams must equal the oracle's
    bit for bit; the run's launches of K2 (over pages and rings), K3, K9
    and K10 are the graphs' replays times the launches they recorded, and
    the oracle's checks launch K1, K1 with the window and K10 once a
    layer of their kind each.  Returns the launches of all three."""
    import torch

    from mxnet_tpu_torch import _cuda, serve

    card = dev.type == "cuda"
    params = serve.init_params(cfg, seed=0, device=dev)
    base = serve.ServeConfig(slots=8, page_size=16, buckets=(64, 128, 256),
                             max_new=HYBRID_NEW, exact=True,
                             window=HYBRID_WINDOW)
    total = {}
    fws = dataclasses.replace(base, layers="full,window,ssm",
                              max_new=1024 - 256 - 32)
    streams = None
    for conf, tag in ((fws, "hybrid"),
                      (dataclasses.replace(base, layers="window,ssm",
                                           kv_quant="int8"),
                       "hybrid_window_ssm_int8")):
        if card:
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        sess, stats, got = serve_phase(
            dev, cfg, conf, n_requests=16, prompt_lens=HYBRID_PROMPTS,
            params=params, max_new=HYBRID_NEW, long_prompts=True)
        kinds = sess.model.kinds
        run, oracle = stats["run_launches"], stats["oracle_launches"]
        suffix = "_q" if conf.kv_quant else ""
        need = ["mi_linear", "ssm_scan", "paged_attention%s_ring" % suffix]
        if "full" in kinds:
            need.append("paged_attention" + suffix)
        if conf.kv_quant:
            need.append("kv_append_quantized")
        checks = stats["bitexact_logits_checked"]
        want = {"flash_attention": checks * kinds.count("full"),
                "flash_attention_window": checks * kinds.count("window"),
                "ssm_scan": checks * kinds.count("ssm")}
        if card and min(run.get(k, 0) for k in need) < 1:
            raise AssertionError("%s: a kernel of the path never ran: %r"
                                 % (tag, run))
        for kernel, n in want.items():
            if card and oracle.get(kernel, 0) != n:
                raise AssertionError("%s: the oracle launched %s %d times, "
                                     "not %d" % (tag, kernel,
                                                 oracle.get(kernel, 0), n))
        if not kinds.count("full") and sess.cache.pages_needed(
                HYBRID_PROMPTS[1], HYBRID_NEW):
            raise AssertionError("%s: a stack without full layers reserved "
                                 "pages" % tag)
        graphs = sess.graph_report()
        log(tag, model="8L-d2048-h16-V32768", layers=conf.layers,
            kinds="".join(k[0] for k in kinds), window=conf.window,
            kv_quant=conf.kv_quant, ring_pages=sess.cache.ring_pages,
            ring_mb=sess.cache.ring_bytes() / 2.0 ** 20,
            ssm_state_mb=sess.cache.state_bytes() / 2.0 ** 20,
            pages_needed_960=sess.cache.pages_needed(HYBRID_PROMPTS[1],
                                                     HYBRID_NEW),
            failed_requests=0, nvidia_smi=smi,
            peak_mem_gib=(torch.cuda.max_memory_allocated() / 2.0 ** 30
                          if card else None),
            executables=sorted(sess.executables),
            launches=dict(_cuda.launches), **stats)
        for name, n in _cuda.launches.items():
            total[name] = total.get(name, 0) + n
        if tag == "hybrid":
            streams = got
            if card:
                log("hybrid_profile", nvidia_smi=smi, **profile_phase(sess))
        del graphs
        del sess
    # speculative decoding on the full,window,ssm stack: the verify selects
    # each slot's committed SSM state in the graph
    if card:
        torch.cuda.empty_cache()
    _cuda.reset_launches()
    spec = spec_phase(
        dev, cfg, params, dataclasses.replace(fws, spec_k=4, draft="ngram"),
        seeded_requests(cfg, 16, HYBRID_PROMPTS, HYBRID_NEW, 0.05), streams,
        long_prompts=True)
    if card and min(_cuda.launches[k] for k in (
            "ssm_scan", "paged_attention_ring", "paged_attention")) < 1:
        raise AssertionError("a kernel never ran on the hybrid speculative "
                             "path: %r" % _cuda.launches)
    log("hybrid_spec", layers=fws.layers, window=fws.window, nvidia_smi=smi,
        launches=dict(_cuda.launches), **spec)
    for name, n in _cuda.launches.items():
        total[name] = total.get(name, 0) + n
    del params
    return total


# the gateway phase's clients: each request's SSE stream read as it
# arrives; every socket read carries this timeout
GW_CLIENT_TIMEOUT_S = 120.0


def sse_client(port, payload, out, t_send=None):
    """POST ``payload`` to the gateway on 127.0.0.1 and read its SSE
    stream, recording into ``out``: ``status``, ``tokens``, the final
    ``done`` event, and ``ttft_s`` (send to the first token event) and
    ``total_s``.  ``t_send`` (a ``perf_counter`` time) delays the send
    until then."""
    import http.client

    if t_send is not None:
        time.sleep(max(0.0, t_send - time.perf_counter()))
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=GW_CLIENT_TIMEOUT_S)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(payload))
        resp = conn.getresponse()
        out["status"] = resp.status
        out["tokens"] = []
        while True:
            line = resp.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            event = json.loads(line[len(b"data: "):])
            if "token" in event:
                if not out["tokens"]:
                    out["ttft_s"] = time.perf_counter() - t0
                out["tokens"].append(event["token"])
            if event.get("done"):
                out["done"] = event
        out["total_s"] = time.perf_counter() - t0
    finally:
        conn.close()


def gateway_traffic(port, reqs, gap_s):
    """Send ``reqs`` (``serve.Request``s) to the gateway, one client
    thread each, ``gap_s`` apart; returns rid -> the client's record and
    the seconds from the first send to the last stream's end."""
    import threading

    t0 = time.perf_counter() + 0.01
    results = {r.rid: {} for r in reqs}
    threads = [threading.Thread(
        target=sse_client, args=(port, {"rid": r.rid, "prompt": r.prompt,
                                         "max_new": r.max_new},
                                 results[r.rid], t0 + gap_s * i))
        for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=GW_CLIENT_TIMEOUT_S + 30)
        if t.is_alive():
            raise AssertionError("a gateway client never finished")
    return results, time.perf_counter() - t0


def check_streams(results, want, tag):
    """Every client got a 200, a whole stream equal to ``want[rid]``, and
    a final event carrying the same transcript."""
    for rid, res in results.items():
        if res.get("status") != 200 or res.get("tokens") != want[rid] or \
                res.get("done", {}).get("tokens") != want[rid]:
            raise AssertionError(
                "%s: request %d got status %r, tokens %r, done %r; the "
                "serve phase streamed %r" % (tag, rid, res.get("status"),
                                             res.get("tokens"),
                                             res.get("done"), want[rid]))


def gateway_phase(dev, cfg, sconf, params, want, serve_stats, n_requests=16,
                  prompt_lens=(24, 250), gap_s=0.05, kill_after=40):
    """Serve the serve phase's model over HTTP: save ``params`` with the
    port's ``CheckpointManager`` (v2, verify on) and the transformer
    symbol, restore it twice through ``InferenceSession.from_checkpoint``
    into a two-replica ``ReplicaSet`` behind a ``Gateway`` on
    127.0.0.1:0, and send the serve phase's ``n_requests`` requests
    ``gap_s`` apart over HTTP/SSE: every stream must equal ``want`` (the
    serve phase's streams).  Then the same traffic with replica 0 killed
    at the ``kill_after``-th hit of ``serve_replica_kill`` (nothing lost,
    streams equal), one client that resets its connection after the first
    event (afterwards each replica's ``state_report()`` equals its
    pre-traffic snapshot), and a drain that flips ``/readyz`` to 503 while
    the streams in flight finish whole.  The phase's kernel launches must
    equal both replicas' replays times the launches recorded.  Returns
    the phase's numbers and its launches."""
    import shutil
    import socket
    import struct
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import torch

    from mxnet_tpu_torch import _cuda, serve
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.testing import faults

    card = dev.type == "cuda"
    out = {}
    ckpt_dir = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        sym = transformer.get_symbol(
            vocab_size=cfg.vocab_size, num_layers=cfg.num_layers,
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            seq_len=cfg.max_len)
        mgr = CheckpointManager(ckpt_dir, prefix="lm", verify=True,
                                save_optimizer_states=False)
        t0 = time.perf_counter()
        mgr.save(epoch=1, symbol=sym, arg_params=params)
        out["ckpt_save_s"] = time.perf_counter() - t0
        out["ckpt_bytes"] = sum(
            os.path.getsize(os.path.join(ckpt_dir, n))
            for n in os.listdir(ckpt_dir))
        sessions, load_s, build_s = [], [], []
        for _ in range(2):
            t0 = time.perf_counter()
            state = mgr.load(epoch=1, device=dev)
            load_s.append(time.perf_counter() - t0)
            del state
            t0 = time.perf_counter()
            sessions.append(serve.InferenceSession.from_checkpoint(
                ckpt_dir, prefix="lm", epoch=1, config=sconf, device=dev))
            build_s.append(time.perf_counter() - t0)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for sess in sessions:
        if sess.model.num_heads != cfg.num_heads:
            raise AssertionError("from_checkpoint read num_heads %d"
                                 % sess.model.num_heads)
        for k, v in sess.params.items():
            if v.device != params[k].device or not torch.equal(v,
                                                               params[k]):
                raise AssertionError("restored parameter %s differs from "
                                     "the saved one" % k)
    out.update(ckpt_load_s=load_s, from_checkpoint_s=build_s,
               capture_s=[s.capture_s for s in sessions],
               graph_pool_mb=[(s.graph_pool_bytes or 0) / 2.0 ** 20
                              for s in sessions])
    baseline = [s.state_report() for s in sessions]
    rs = serve.ReplicaSet(sessions=sessions, step_timeout_s=60.0,
                          rejoin_backoff_s=0.05)
    reqs = lambda: seeded_requests(cfg, n_requests, prompt_lens,
                                   sconf.max_new, gap_s)
    for sess in sessions:
        for exe in sess.executables.values():
            exe.replays = 0
    gw = serve.Gateway(rs, host="127.0.0.1", port=0).start()
    try:
        if card:
            torch.cuda.synchronize()
        _cuda.reset_launches()
        # a. the serve phase's traffic over HTTP/SSE
        results, wall = gateway_traffic(gw.port, reqs(), gap_s)
        check_streams(results, want, "gateway")
        ttft = sorted(r["ttft_s"] * 1e3 for r in results.values())
        tokens = sum(len(r["tokens"]) for r in results.values())
        out.update(requests=n_requests, tokens=tokens,
                   tokens_per_s=tokens / wall, makespan_s=wall,
                   ttft_p50_ms=float(np.percentile(ttft, 50)),
                   ttft_p99_ms=float(np.percentile(ttft, 99)),
                   ttft_max_ms=ttft[-1],
                   serve_tokens_per_s=serve_stats["tokens_per_s"],
                   serve_ttft_p50_ms=serve_stats["ttft_p50_ms"],
                   serve_ttft_p99_ms=serve_stats["ttft_p99_ms"],
                   streams_equal=n_requests)
        # b. replica 0 killed mid-run: nothing lost, streams equal
        deaths0 = rs.counters["deaths"]
        os.environ["MXNET_FAULT_INJECT"] = \
            "serve_replica_kill:kill:after=%d" % kill_after
        faults.reset()
        try:
            results, wall = gateway_traffic(gw.port, reqs(), gap_s)
        finally:
            os.environ.pop("MXNET_FAULT_INJECT", None)
            faults.reset()
        check_streams(results, want, "gateway with a replica killed")
        if rs.counters["deaths"] != deaths0 + 1:
            raise AssertionError("the kill did not land: %r"
                                 % rs.counters)
        out.update(kill_tokens_per_s=sum(len(r["tokens"]) for r in
                                         results.values()) / wall,
                   kill_lost=0, kill_streams_equal=n_requests)
        # c. a client that resets its connection after the first event
        one = reqs()[0]
        sock = socket.create_connection(("127.0.0.1", gw.port),
                                        timeout=GW_CLIENT_TIMEOUT_S)
        body = json.dumps({"rid": 9000, "prompt": one.prompt,
                           "max_new": one.max_new}).encode()
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body) + body)
        seen = b""
        while b"data: " not in seen:
            chunk = sock.recv(4096)
            if not chunk:
                raise AssertionError("the gateway closed before the first "
                                     "event: %r" % seen)
            seen += chunk
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        sock.close()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
                rs.outstanding or gw.open_streams()):
            time.sleep(0.01)
        after = [s.state_report() for s in sessions]
        if after != baseline:
            raise AssertionError("state_report after the disconnect %r != "
                                 "before the traffic %r" % (after, baseline))
        out.update(disconnect_cancelled=gw.counters["cancelled"],
                   state_report_round_trip=True)
        # d. drain: /readyz flips to 503 while the streams in flight end
        drain_reqs = reqs()[:4]
        results = {r.rid: {} for r in drain_reqs}
        threads = [threading.Thread(target=sse_client, args=(
            gw.port, {"rid": r.rid, "prompt": r.prompt,
                      "max_new": r.max_new}, results[r.rid]))
            for r in drain_reqs]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and \
                len(gw.open_streams()) < len(drain_reqs):
            time.sleep(0.001)
        gw.drain(wait=False)
        try:
            urllib.request.urlopen("http://127.0.0.1:%d/readyz" % gw.port,
                                   timeout=30)
            readyz = 200
        except urllib.error.HTTPError as exc:
            readyz = exc.code
        if readyz != 503:
            raise AssertionError("/readyz answered %d while draining"
                                 % readyz)
        for t in threads:
            t.join(timeout=GW_CLIENT_TIMEOUT_S + 30)
        clean = gw._drain_fut.result(timeout=gw.drain_s + 30)
        check_streams(results, want, "gateway drain")
        if not clean:
            raise AssertionError("the drain force-cancelled streams")
        out.update(drain_readyz=readyz, drain_clean=clean,
                   drain_streams_equal=len(drain_reqs))
        if card:
            torch.cuda.synchronize()
        launched = dict(_cuda.launches)
    finally:
        gw.stop()
    want_launches = {}
    replays = []
    for sess in sessions:
        rep = sess.graph_report()
        replays.append(rep["replays"])
        for name, per in rep["launches_per_replay"].items():
            for kernel, n in per.items():
                want_launches[kernel] = want_launches.get(kernel, 0) + \
                    rep["replays"][name] * n
    got = {k: n for k, n in launched.items() if n}
    if got != want_launches:
        raise AssertionError("gateway phase launches %r are not both "
                             "replicas' replays x recorded %r"
                             % (got, want_launches))
    out.update(replays=replays, failovers=rs.counters["failover_requests"],
               deaths=rs.counters["deaths"], rejoins=rs.counters["rejoins"],
               shed=rs.counters["shed"],
               replica_states=[r.state for r in rs.replicas],
               gateway_counters=dict(gw.counters),
               incident=gw.incident_path or rs.incident_path)
    return out, got


def train_config(num_layers=8):
    """bench_transformer.py's default model (:57-58)."""
    return dict(vocab_size=32768, num_layers=num_layers, d_model=2048,
                num_heads=16, seq_len=1024)


def train_tokens(cfg, batch, seed=0, bf16_exact=False):
    """Numpy-seeded token ids, used as data and labels.  Drawn from
    [0, 32640): the bf16 step casts the float ids to bf16 (as the JAX
    package's does), and every id below 32640 rounds to at most 32640,
    inside the vocabulary; ids from 32704 would round to 32768 and look
    up a NaN row.  ``bf16_exact`` rounds the ids through bf16 here, so an
    fp32 step trains on the same tokens as a bf16 one."""
    import torch

    rs = np.random.RandomState(seed)
    toks = torch.from_numpy(
        rs.randint(0, 32640, (batch, cfg["seq_len"])).astype(np.float32))
    return toks.bfloat16().float() if bf16_exact else toks


def train_step(dev, cfg, batch, compute_dtype, lr=1e-3, bf16_exact=False,
               optimizer="sgd", optimizer_params=None, **step_kwargs):
    """A TrainStep at ``cfg`` (more ``TrainStep`` arguments in
    ``step_kwargs``), its state from ``init_state(seed=0)`` and one batch
    of :func:`train_tokens` on ``dev``.  The optimizer is SGD (``lr``,
    momentum 0.9) unless ``optimizer``/``optimizer_params`` say
    otherwise; ``rescale_grad`` is 1 / ``batch`` either way."""
    from mxnet_tpu_torch import fused
    from mxnet_tpu_torch.models import transformer

    if optimizer_params is None:
        optimizer_params = {"learning_rate": lr, "momentum": 0.9}
    step = fused.TrainStep(
        transformer.get_symbol(**cfg), optimizer=optimizer,
        optimizer_params=dict(optimizer_params, rescale_grad=1.0 / batch),
        compute_dtype=compute_dtype, device=dev, **step_kwargs)
    shapes = {"data": (batch, cfg["seq_len"]),
              "softmax_label": (batch, cfg["seq_len"])}
    state = step.init_state(shapes, seed=0)
    toks = train_tokens(cfg, batch, bf16_exact=bf16_exact).to(dev)
    return step, state, {"data": toks, "softmax_label": toks}


def cross_entropy(probs, labels, dtype):
    """Mean -log p[label] over the rows of the LM head's output, at the
    labels the step trained on (cast to ``dtype`` like the batch)."""
    return float(ce_tensor(probs, labels, dtype))


def ce_tensor(probs, labels, dtype):
    """:func:`cross_entropy` as a device scalar (no host sync)."""
    import torch

    lab = labels.to(dtype).long().reshape(-1, 1)
    return -torch.log(probs.float().gather(1, lab)).mean()


def train_phase(dev, cfg, batch, steps=5):
    """One warm-up and ``steps`` timed bf16 TrainSteps; returns the
    phase's numbers and the kernel launches counted over all steps."""
    import torch

    from mxnet_tpu_torch import _cuda
    from mxnet_tpu_torch.models import transformer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step, (params, aux, states), data = train_step(dev, cfg, batch,
                                                   "bfloat16")
    _cuda.reset_launches()
    params, aux, states, outs = step(params, aux, states, data, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, aux, states, outs = step(params, aux, states, data, None)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = dict(_cuda.launches)
    per_step = {k: launches[k] / (steps + 1)
                for k in ("flash_attention_sm90",
                          "flash_attention_backward_sm90")}
    if any(n != cfg["num_layers"] for n in per_step.values()):
        raise AssertionError("attention kernels per step %r, want %d each"
                             % (per_step, cfg["num_layers"]))
    ce = cross_entropy(outs[0], data["softmax_label"], torch.bfloat16)
    if not np.isfinite(ce):
        raise AssertionError("cross-entropy %r is not finite" % ce)
    bad = [n for n, p in params.items() if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError("non-finite parameters after training: %r"
                             % bad[:5])
    tokens = batch * cfg["seq_len"]
    # bench_transformer.py:120-123: 6 P tokens + 12 L B T^2 d_model
    flops = (6.0 * transformer.count_params(**cfg) * tokens
             + 12.0 * cfg["num_layers"] * batch * cfg["seq_len"] ** 2
             * cfg["d_model"])
    stats = dict(model="%dL-d%d-h%d-V%d-T%d" % (
                     cfg["num_layers"], cfg["d_model"], cfg["num_heads"],
                     cfg["vocab_size"], cfg["seq_len"]),
                 batch=batch, steps_timed=steps, step_ms=step_s * 1e3,
                 tokens_per_s=tokens / step_s,
                 achieved_tflops=flops / step_s / 1e12,
                 share_of_bf16_dense_peak_989=flops / step_s
                 / BF16_FLOP_PER_S,
                 cross_entropy=ce,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2.0 ** 30,
                 launches_per_step=per_step)
    # one profiled step: K7, K8, cuBLAS GEMMs and the rest
    stats["profile"] = profiled_window(
        lambda: step(params, aux, states, data, None),
        (("flash_attention_sm90", ("flash_fwd_sm90",)),
         ("flash_attention_backward_sm90", ("flash_bwd_sm90",)),
         ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_"))))
    return stats, launches


def step_update(dev, cfg, batch, compute_dtype, impl, bf16_exact=False,
                timing=None, **optimizer):
    """The parameter update (new - old, in fp32) of one step from
    ``init_state(seed=0)`` under ``MXNET_ATTN_IMPL=impl``.  With a dict
    ``timing`` (on the card), three more steps from the same state are
    timed on the host clock (synced) and one is profiled, the flash
    kernels' device time by kernel put into it."""
    import torch

    saved = os.environ.get("MXNET_ATTN_IMPL")
    os.environ["MXNET_ATTN_IMPL"] = impl
    try:
        step, (params, aux, states), data = train_step(
            dev, cfg, batch, compute_dtype, bf16_exact=bf16_exact,
            **optimizer)
        new, _, _, outs = step(params, aux, states, data, None)
        if not bool(torch.isfinite(outs[0]).all()):
            raise AssertionError("%s: non-finite outputs" % impl)
        update = {n: (new[n] - params[n]).float() for n in new}
        if timing is not None:
            del new, outs
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(params, aux, states, data, None)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            prof = profiled_window(
                lambda: step(params, aux, states, data, None),
                (("flash_attention", ("flash_forward_kernel",)),
                 ("flash_attention_backward", ("flash_bwd_",))))
            timing.update(step_ms=ms, step_ms_mean=float(np.mean(ms)),
                          profiled_step=prof)
        return update
    finally:
        if saved is None:
            os.environ.pop("MXNET_ATTN_IMPL", None)
        else:
            os.environ["MXNET_ATTN_IMPL"] = saved
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def rel_l2(got, want):
    """Per-tensor relative L2 error of ``got`` against ``want``."""
    return {n: float((got[n] - w).norm() / w.norm().clamp_min(1e-30))
            for n, w in want.items()}


def spread(rel):
    worst = max(rel, key=rel.get)
    return dict(max=rel[worst], worst_tensor=worst,
                mean=float(np.mean(list(rel.values()))),
                median=float(np.median(list(rel.values()))))


def parity_phase(dev, cfg, batch, compute_dtype, timed=True, **optimizer):
    """One step through the attention kernels (K1/K4 in fp32, K7/K8 in
    bf16) against one under MXNET_ATTN_IMPL=reference
    from the same ``init_state(seed=0)``: the per-tensor relative L2
    error of the parameter update.  In bf16 both are also held against
    the fp32 reference step on the same (bf16-exact) token ids, the
    truth that says how much of the difference is bf16's own.
    ``optimizer``: :func:`train_step`'s optimizer arguments; ``timed``:
    time and profile the fp32 kernel step on the card."""
    bf16 = compute_dtype is not None
    timing = {} if dev.type == "cuda" and not bf16 and timed else None
    kern = step_update(dev, cfg, batch, compute_dtype, "auto", bf16, timing,
                       **optimizer)
    ref = step_update(dev, cfg, batch, compute_dtype, "reference", bf16,
                      **optimizer)
    out = dict(kernel_vs_reference=spread(rel_l2(kern, ref)))
    if timing:
        out["kernel_step"] = timing
    if bf16:
        truth = step_update(dev, cfg, batch, None, "reference", True)
        kern_err, ref_err = rel_l2(kern, truth), rel_l2(ref, truth)
        ratio = {n: kern_err[n] / max(ref_err[n], 1e-30) for n in truth}
        out.update(kernel_vs_fp32=spread(kern_err),
                   reference_vs_fp32=spread(ref_err),
                   kernel_over_reference_error=spread(ratio))
    return out


# K5/K6 against their plain versions: per channel, |diff| <= 3e-5 times
# the sum of the magnitudes of the terms summed.  Both sides sum in fp32
# in other orders; the kernels' longest sequential chain is a few hundred
# terms (chunk_rows), so their rounding walks to a few 2^-24 sqrt(n) of
# that magnitude, far inside
BN_RTOL = 3e-5
BN_NOTE = ("per channel |diff| <= 3e-5 * sum|terms| (sum|x|, sum x^2, "
           "sum|dy|, sum|dy xhat|): fp32 sums in two orders")
# resnet-parity: the kernel and plain bf16 steps do the same arithmetic
# but for the order of the channel sums, so their errors against the fp32
# step must agree within noise.  At ResNet-50's depth from a fresh state
# the bf16 update of the deep layers is mostly noise (measured on the
# H100: median error 110 % on both paths, kernel against plain 58 %), so
# a per-tensor ratio there is a draw from that noise; the per-tensor bound
# holds where the bf16 update tracks the fp32 one (plain error < 0.5),
# and the spread of a third summation order (fp64-accumulated sums)
# against the plain one is logged as the measured noise
PARITY_BN_MEAN = 1.1
PARITY_BN_RATIO = 1.5
PARITY_BN_TRACKS = 0.5
PARITY_BN_NOTE = ("against the fp32 step from the same state, by the "
                  "relative L2 error of each parameter's and moving "
                  "statistic's update: kernel mean and median <= 1.1 x "
                  "plain's; kernel error <= 1.5 x plain error for every "
                  "tensor whose plain error is < 0.5")


def bn_nodes(sym):
    """The training-mode BatchNorm nodes of ``sym``."""
    return [n for n in sym._topo() if not n.is_variable
            and n.op.name in ("BatchNorm", "BatchNorm_v1")
            and not n.attrs.get("use_global_stats", False)]


def resnet_images(n, seed=0, image=224):
    """``n`` numpy-seeded images, pixels uniform in [0, 1), and labels from
    [0, 256): the bf16 step casts the labels to bf16 too, and larger ids
    round (ROADMAP queue 3)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3, image, image), dtype=np.float32)
    return x, rng.integers(0, 256, n).astype(np.float32)


XAVIER = dict(rnd_type="gaussian", factor_type="in", magnitude=2)
SGD = {"learning_rate": 0.1, "momentum": 0.9}


def resnet_phase(dev, sym, batch=256, n_images=1024, epochs=2):
    """``Module.fit`` of ``sym`` in bf16 on ``dev`` (the phase's numbers,
    and the kernel launches counted over the fit alone)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _cuda

    cuda = dev.type == "cuda"
    x, y = resnet_images(n_images)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mod = mx.mod.Module(sym, context=mx.context.context_of(dev))
    mod.bind(it.provide_data, it.provide_label)
    init = mx.init.Xavier(**XAVIER)
    mod.init_params(init)
    arg0, aux0 = ({k: v.asnumpy() for k, v in d.items()}
                  for d in mod.get_params())
    marks = []

    def tick(param):
        if cuda:
            torch.cuda.synchronize()
        marks.append((param.epoch, time.perf_counter()))

    acc = mx.metric.Accuracy()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    mod.fit(it, num_epoch=epochs, optimizer="sgd", optimizer_params=SGD,
            initializer=init, compute_dtype="bfloat16", eval_metric=acc,
            batch_end_callback=tick)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    steps = epochs * (n_images // batch)
    nodes = bn_nodes(sym)
    want = {"bn_stats": len(nodes) * steps, "bn_grad_sums": len(nodes) * steps}
    if cuda and any(launches[k] != n for k, n in want.items()):
        raise AssertionError("BatchNorm kernel launches %r, want %r (%d "
                             "training-mode BatchNorm nodes x %d steps)"
                             % ({k: launches[k] for k in want}, want,
                                len(nodes), steps))
    fixed = {n.name + "_gamma" for n in nodes if n.attrs.get("fix_gamma",
                                                                True)}
    arg, aux = ({k: v.asnumpy() for k, v in d.items()}
                for d in mod.get_params())
    for kind, new, old in (("parameter", arg, arg0), ("moving stat", aux,
                                                      aux0)):
        bad = [k for k, v in new.items() if not np.isfinite(v).all()]
        same = [k for k, v in new.items()
                if k not in fixed and np.array_equal(v, old[k])]
        if bad or same:
            raise AssertionError("%s not finite %r / unchanged %r"
                                 % (kind, bad[:5], same[:5]))
    name, value = acc.get()
    if not np.isfinite(value):
        raise AssertionError("train %s %r is not finite" % (name, value))
    last = [t for e, t in marks if e == epochs - 1]
    first_end = [t for e, t in marks if e == epochs - 2][-1]
    epoch_s = last[-1] - first_end
    stats = dict(image="x".join(str(d) for d in x.shape[1:]), batch=batch,
                 steps=steps, bn_nodes=len(nodes),
                 img_per_s_epoch2=(n_images // batch) * batch / epoch_s,
                 step_ms_epoch2=1e3 * (last[-1] - last[0]) / (len(last) - 1),
                 train_accuracy=value,
                 launches_per_step={k: launches[k] / steps for k in want})
    if cuda:
        stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2.0 ** 30
        # the batch on the card already, as the prefetcher hands it over
        ctx = mx.context.context_of(dev)
        batch0 = mx.io.DataBatch([mx.nd.array(x[:batch], ctx)],
                                 [mx.nd.array(y[:batch], ctx)])

        def one_step():
            mod.forward_backward(batch0)
            mod.update()

        one_step()
        stats["profile"] = profiled_window(one_step, (
            ("bn_stats", ("StatsOp",)), ("bn_grad_sums", ("GradOp",)),
            ("cudnn_conv", ("cudnn", "conv", "xmma", "implicit", "gemm",
                            "sm90_", "cutlass", "dgrad", "wgrad",
                            "nchwToNhwc", "nhwcToNchw"))))
    return stats, launches


def emulated_kernel_sums():
    """``(bn_stats, bn_grad_sums)`` that sum in the kernels' chunk order in
    plain PyTorch — fp32 partials over ``chunk_rows``' runs of rows, added
    in chunk order — to rehearse the parity criterion without the card."""
    import torch

    from mxnet_tpu_torch.ops import pallas_bn as P

    def chunked(terms, outer, c, inner):
        # per run of rows: 256 lanes each summing every 256th element,
        # then the lanes added together (the kernel's block), then the
        # runs' partials in order (its finish)
        rows, chunks = P.chunk_rows(outer, c, inner)
        out = []
        for t in terms:
            acc = torch.zeros(c, dtype=torch.float32, device=t.device)
            for s in range(chunks):
                run = t[s * rows:(s + 1) * rows].transpose(0, 1).reshape(c, -1)
                run = torch.nn.functional.pad(run, (0, -run.shape[1] % 256))
                acc = acc + run.reshape(c, -1, 256).sum(dim=1).sum(dim=1)
            out.append(acc)
        return tuple(out)

    def stats(x, axis=1):
        outer, c, inner = P._dims(x, axis)
        xf = x.float().reshape(outer, c, inner)
        return chunked([xf, xf * xf], outer, c, inner)

    def grad_sums(dy, x, mean, inv, axis=1):
        outer, c, inner = P._dims(x, axis)
        xf = x.float().reshape(outer, c, inner)
        dyf = dy.float().reshape(outer, c, inner)
        xhat = (xf - mean.float().view(1, c, 1)) * inv.float().view(1, c, 1)
        return chunked([dyf, dyf * xhat], outer, c, inner)

    return stats, grad_sums


def resnet_parity_phase(dev, sym, batch=16, image=224, kernel_sums=None):
    """One bf16 ``Module`` step of ``sym`` through the kernel wrappers (or
    ``kernel_sums`` patched in for them) and one with the plain sums
    patched in, both held against the fp32 step from the same state by
    the relative L2 error of each parameter's and moving statistic's
    update."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import pallas_bn

    ctx = mx.context.context_of(dev)
    x, y = resnet_images(batch, seed=1, image=image)
    shapes = ([("data", x.shape)], [("softmax_label", y.shape)])
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(*shapes)
    mod.init_params(mx.init.Xavier(**XAVIER))
    arg0, aux0 = ({k: v.asnumpy() for k, v in d.items()}
                  for d in mod.get_params())

    def update(compute_dtype, sums):
        saved = pallas_bn.bn_stats, pallas_bn.bn_grad_sums
        if sums is not None:
            pallas_bn.bn_stats, pallas_bn.bn_grad_sums = sums
        try:
            m = mx.mod.Module(sym, context=ctx)
            m.bind(*shapes)
            m.init_params(arg_params=arg0, aux_params=aux0)
            m.init_optimizer(optimizer="sgd", optimizer_params=SGD,
                             compute_dtype=compute_dtype)
            m.forward_backward(mx.io.DataBatch(
                [mx.nd.array(x, ctx)], [mx.nd.array(y, ctx)]))
            m.update()
            arg, aux = m.get_params()
        finally:
            pallas_bn.bn_stats, pallas_bn.bn_grad_sums = saved
        out = {k: arg[k].asnumpy().astype(np.float64) - arg0[k]
               for k in arg0}
        out.update({k: aux[k].asnumpy().astype(np.float64) - aux0[k]
                    for k in aux0})
        return out

    def f64_sums():
        # a third summation order: the plain sums accumulated in fp64
        def stats(x, axis=1):
            return tuple(v.float() for v in pallas_bn.bn_stats_plain(
                x.double(), axis))

        def grad_sums(dy, x, mean, inv, axis=1):
            return tuple(v.float() for v in pallas_bn.bn_grad_sums_plain(
                dy.double(), x.double(), mean.double(), inv.double(), axis))
        return stats, grad_sums

    kern = update("bfloat16", kernel_sums)
    plain = update("bfloat16", (pallas_bn.bn_stats_plain,
                                pallas_bn.bn_grad_sums_plain))
    alt = update("bfloat16", f64_sums())
    truth = update(None, None)
    live = [k for k, v in truth.items() if np.any(v)]  # fix_gamma: no update

    def err(got, want):
        return {k: float(np.linalg.norm(got[k] - want[k])
                         / max(np.linalg.norm(want[k]), 1e-30)) for k in live}

    kern_err, plain_err, alt_err = err(kern, truth), err(plain, truth), \
        err(alt, truth)
    ratio = {k: kern_err[k] / max(plain_err[k], 1e-30) for k in live}
    tracking = [k for k in live if plain_err[k] < PARITY_BN_TRACKS]
    per_tensor = {k: dict(kernel=kern_err[k], plain=plain_err[k],
                          fp64_sums=alt_err[k]) for k in live}
    return dict(tensors=len(live), kernel_vs_fp32=spread(kern_err),
                plain_vs_fp32=spread(plain_err),
                fp64_sums_vs_fp32=spread(alt_err),
                kernel_over_plain_error=spread(ratio),
                fp64_sums_over_plain_error=spread(
                    {k: alt_err[k] / max(plain_err[k], 1e-30)
                     for k in live}),
                tracking_tensors=len(tracking),
                tracking_kernel_over_plain=spread(
                    {k: ratio[k] for k in tracking}) if tracking else None,
                kernel_vs_plain=spread(err(kern, plain))), per_tensor


def count_batchnorms(block):
    """The BatchNorm blocks of a Gluon block, counted from the net."""
    from mxnet_tpu_torch.gluon import nn

    n = 1 if isinstance(block, nn.BatchNorm) else 0
    return n + sum(count_batchnorms(c) for c in block._children.values())


def param_values(params, trainer=None):
    """Each parameter's value as fp32 numpy: a bf16 parameter's fp32
    master copy where ``trainer`` keeps one (``multi_precision``), since a
    small update may not move the bf16 copy at all."""
    master = {}
    if trainer is not None:
        for i, p in enumerate(trainer._params):
            state = trainer._updater.states.get(i)
            if isinstance(state, tuple):
                master[p.name] = state[1]
    return [(master[p.name] if p.name in master else p.data()).asnumpy()
            for p in params]


def gluon_net(ctx, image=224):
    """``vision.resnet50_v1(classes=1000)``, Xavier(gaussian, in, 2) on
    ``ctx``, its deferred shapes resolved by one predict-mode forward, then
    ``cast("bfloat16")``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(**XAVIER), ctx=ctx)
    net(mx.nd.zeros((1, 3, image, image), ctx))
    net.cast("bfloat16")
    return net


def gluon_phase(dev, net, batch=256, n_images=1024, epochs=2, image=224):
    """The tentpole loop over ``net``: returns the phase's numbers and the
    kernel launches counted over the loop alone."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _cuda, autograd, gluon

    cuda = dev.type == "cuda"
    ctx = mx.context.context_of(dev)
    x, y = resnet_images(n_images, image=image)
    y = np.random.default_rng(1).integers(0, 1000, n_images).astype(
        np.float32)
    params = list(net.collect_params().values())
    before = param_values(params)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            dict(SGD, multi_precision=True))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(x, y),
                                   batch_size=batch, shuffle=True)
    losses, marks = [], []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    with ctx:
        for epoch in range(epochs):
            for xb, yb in loader:
                with autograd.record():
                    loss = loss_fn(net(xb.astype("bfloat16")), yb)
                loss.backward()
                trainer.step(batch)
                losses.append(float(loss.mean().asscalar()))  # syncs
                marks.append((epoch, time.perf_counter()))
    launches = dict(_cuda.launches)
    steps = epochs * (n_images // batch)
    n_bn = count_batchnorms(net)
    want = {"bn_stats": n_bn * steps, "bn_grad_sums": n_bn * steps}
    if cuda and any(launches[k] != n for k, n in want.items()):
        raise AssertionError("BatchNorm kernel launches %r, want %r (%d "
                             "BatchNorm blocks x %d steps)"
                             % ({k: launches[k] for k in want}, want, n_bn,
                                steps))
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss: %r" % losses)
    after = param_values(params, trainer)
    bad = [p.name for p, a in zip(params, after) if not np.isfinite(a).all()
           or not np.isfinite(p.data().asnumpy()).all()]
    same = [p.name for p, a, b in zip(params, after, before)
            if np.array_equal(a, b)]
    if bad or same:
        raise AssertionError("parameters not finite %r / unchanged %r"
                             % (bad[:5], same[:5]))
    last = [t for e, t in marks if e == epochs - 1]
    first_end = [t for e, t in marks if e == epochs - 2][-1]
    stats = dict(model="resnet50_v1", image="3x%dx%d" % (image, image),
                 batch=batch, steps=steps, batchnorm_blocks=n_bn,
                 params=sum(int(np.prod(p.shape)) for p in params),
                 loss_first=losses[0], loss_last=losses[-1],
                 img_per_s_epoch2=(n_images // batch) * batch
                 / (last[-1] - first_end),
                 step_ms_epoch2=1e3 * (last[-1] - last[0]) / (len(last) - 1),
                 launches_per_step={k: launches[k] / steps for k in want})
    # hybridize() against the imperative forward, in inference mode
    xb = mx.nd.array(x[:max(1, batch // 8)], ctx).astype("bfloat16")
    ref = net(xb).asnumpy()
    net.hybridize()
    hyb = net(xb).asnumpy()
    net.hybridize(False)
    if not np.array_equal(ref, hyb):
        raise AssertionError("hybridize changed the logits by %.3g"
                             % np.abs(ref - hyb).max())
    stats["hybridize_bit_equal"] = True
    if cuda:
        stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2.0 ** 30
        xb = mx.nd.array(x[:batch], ctx).astype("bfloat16")
        yb = mx.nd.array(y[:batch], ctx)

        def one_step():
            with autograd.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            trainer.step(batch)

        one_step()
        stats["profile"] = profiled_window(one_step, (
            ("bn_stats", ("StatsOp",)), ("bn_grad_sums", ("GradOp",)),
            ("cudnn_conv", ("cudnn", "conv", "xmma", "implicit", "gemm",
                            "sm90_", "cutlass", "dgrad", "wgrad",
                            "nchwToNhwc", "nhwcToNchw"))))
    return stats, launches


def custom_op_phase(dev, net, batch=256, steps=4, image=224, fit_batch=64):
    """The rtc facility's own path and the rtc-backed loss head (see the
    module note, phase 10).  Returns the phase's numbers and its kernel
    launches."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _cuda, autograd, gluon
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.testing import rtc_ops

    cuda = dev.type == "cuda"
    ctx = mx.context.context_of(dev)
    _cuda.reset_launches()
    # 1. the facility through its user entry points: __call__ and push
    for shape in ((16, 128), (8192, 8192)):
        a = mx.nd.array(np.random.default_rng(2).random(shape, np.float32),
                        ctx)
        b = mx.nd.array(np.random.default_rng(3).random(shape, np.float32),
                        ctx)
        if cuda:
            k = rtc_ops._kernel("rtc_axpy", shape)
            (o,) = k(a, b)
            dst = mx.nd.zeros(shape, ctx)
            k.push([a, b], [dst])
            outs = [o, dst]
        else:
            outs = [mx.nd.array(rtc_ops.axpy(a.handle, b.handle), ctx)]
        want = 2.0 * a.handle + b.handle
        for out in outs:
            if not torch.equal(out.handle, want):
                raise AssertionError("rtc_axpy %r differs from 2x + y"
                                     % (shape,))
        del a, b, outs, want
    # 2. the Gluon ResNet-50 with the rtc loss head
    x, y = resnet_images(steps * batch, seed=3, image=image)
    y = np.random.default_rng(4).integers(0, 1000, steps * batch).astype(
        np.float32)
    params = list(net.collect_params().values())
    before = param_values(params)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            dict(SGD, multi_precision=True))
    losses = []
    for i in range(steps):
        xb = mx.nd.array(x[i * batch:(i + 1) * batch], ctx)
        yb = mx.nd.array(y[i * batch:(i + 1) * batch], ctx)
        with autograd.record():
            p = mx.nd.Custom(net(xb.astype("bfloat16")).astype("float32"),
                             yb, op_type="rtc_softmax")
        p.backward()
        trainer.step(batch)
        pick = p.handle.detach().gather(1, yb.handle.long()[:, None])
        losses.append(float(-torch.log(pick.clamp_min(1e-30)).mean()))
    head = {k: _cuda.launches.get("rtc:" + k, 0)
            for k in ("rtc_softmax_forward", "rtc_softmax_backward")}
    if cuda and any(n != steps for n in head.values()):
        raise AssertionError("rtc head launches %r, want %d each"
                             % (head, steps))
    after = param_values(params, trainer)
    if not np.isfinite(losses).all() or not all(
            np.isfinite(a).all() for a in after):
        raise AssertionError("non-finite loss or parameters: %r" % losses)
    same = [q.name for q, a, b in zip(params, after, before)
            if np.array_equal(a, b)]
    if same:
        raise AssertionError("parameters unchanged: %r" % same[:5])
    # 3. the same op inside a bound Symbol, under Module.fit (fp32: a graph
    # with a Custom node runs on the split executor)
    sym = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=(3, image, image))
    fc1 = sym.get_internals()["fc1_output"]
    head_sym = mx.sym.Custom(fc1, mx.sym.Variable("softmax_label"),
                             op_type="rtc_softmax", name="softmax")
    xf, yf = resnet_images(2 * fit_batch, seed=5, image=image)
    mod = mx.mod.Module(head_sym, context=ctx)
    mod.fit(mx.io.NDArrayIter(xf, yf, batch_size=fit_batch), num_epoch=1,
            optimizer="sgd", optimizer_params=SGD,
            initializer=mx.init.Xavier(**XAVIER))
    if mod._fused is not None:
        raise AssertionError("Module fused a graph with a Custom node")
    if not all(np.isfinite(v.asnumpy()).all()
               for v in mod.get_params()[0].values()):
        raise AssertionError("Module.fit with the rtc head: non-finite "
                             "parameters")
    del mod
    launches = dict(_cuda.launches)
    # 4. the logits' gradient through the rtc head against
    # SoftmaxCrossEntropyLoss's / N, on one batch (outside the counts): at
    # the net's logits, whose softmax may be saturated (p exactly 0 or 1,
    # where any two implementations agree), and at the same logits
    # standardized per row, where it is not
    xb = mx.nd.array(x[:batch], ctx).astype("bfloat16")
    yb = mx.nd.array(y[:batch], ctx)
    raw = net(xb).astype("float32").asnumpy()
    r64 = raw.astype(np.float64)
    std = ((r64 - r64.mean(1, keepdims=True))
           / r64.std(1, keepdims=True).clip(1e-6)).astype(np.float32)
    head = dict(head_launches=head)
    for case, logits in (("net_logits", raw), ("standardized", std)):
        grads = []
        for use_rtc in (True, False):
            z = mx.nd.array(logits, ctx)
            z.attach_grad()
            with autograd.record():
                if use_rtc:
                    out = mx.nd.Custom(z, yb, op_type="rtc_softmax")
                else:
                    out = gluon.loss.SoftmaxCrossEntropyLoss()(z, yb)
            out.backward()
            grads.append(z.grad.asnumpy())
        err = float(np.abs(grads[0] - grads[1] / batch).max())
        if err > HEAD_GRAD_ATOL / batch:
            raise AssertionError("rtc head gradient off SoftmaxCrossEntropy"
                                 "Loss's / N by %.3g at the %s (%s)"
                                 % (err, case, HEAD_GRAD_NOTE))
        g = np.abs(grads[0] * batch)  # |p - onehot|
        head[case] = dict(
            max_abs_err=err, entries_differing=int(
                (grads[0] != grads[1] / batch).sum()),
            # where two softmax implementations can round apart
            entries_unsaturated=int(((g > 1e-6) & (g < 0.5)).sum()))
    stats = dict(steps=steps, batch=batch, loss_first=losses[0],
                 loss_last=losses[-1],
                 module_fit=dict(batch=fit_batch, steps=2, precision="fp32"),
                 head_grad_tolerance=HEAD_GRAD_NOTE, **head)
    return stats, launches


# the optim phase's optimizer: Adam at JAX's default betas and epsilon,
# weight decay added to the gradient (the reference's adam_update) and
# global-norm clipping; the learning rate comes from a cosine schedule
# each step
ADAM = {"learning_rate": 3e-4, "wd": 0.01, "clip_global_norm": 1.0}
# train-parity under Adam: the same optimizer with epsilon 1e-6.  The
# key projection's bias has a zero gradient in exact arithmetic (softmax
# ignores a shift of every score), so each attention path's rounding
# noise there is all Adam sees, and at epsilon 1e-8 Adam scales that
# noise up to a step of order lr that differs between the two paths
# (the plain versions on the CPU at d_model 128, 2 layers, T 128: worst
# tensor blk0_attn_in_bias at 2.0e-3 with epsilon 1e-8, 2.1e-5 with 1e-6)
ADAM_PARITY = dict(ADAM, epsilon=1e-6)
COSINE = dict(max_update=16, base_lr=3e-4, warmup_steps=2)


def optim_phase(dev, cfg, batch, timed=5, total=8, profile=True):
    """The transformer LM in bf16 through ``fused.TrainStep(optimizer=
    "adam")`` with ``clip_global_norm`` and a cosine schedule: ``total``
    steps on one repeated batch, the first a warm-up, the next ``timed``
    timed (host clock, synced), then one profiled (on the card) and the
    rest plain.  Returns the phase's numbers and the kernel launches over
    all steps."""
    import torch

    from mxnet_tpu_torch import _cuda, lr_scheduler
    from mxnet_tpu_torch.models import transformer

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    step, (params, aux, states), data = train_step(
        dev, cfg, batch, "bfloat16", optimizer="adam", optimizer_params=ADAM)
    sched = lr_scheduler.CosineScheduler(**COSINE)
    ces, lrs = [], []
    state = [params, aux, states]

    def one(t):
        lrs.append(sched(t))
        state[0], state[1], state[2], outs = step(
            *state, data, None, lr=lrs[-1], t=t)
        ces.append(ce_tensor(outs[0], data["softmax_label"], torch.bfloat16))

    _cuda.reset_launches()
    one(1)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(2, 2 + timed):
        one(t)
    if cuda:
        torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    prof = None
    for t in range(2 + timed, total + 1):
        if profile and cuda and prof is None:
            prof = profiled_window(lambda: one(t), (
                ("flash_attention_sm90", ("flash_fwd_sm90",)),
                ("flash_attention_backward_sm90", ("flash_bwd_sm90",)),
                ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "sm90_"))))
        else:
            one(t)
    launches = dict(_cuda.launches)
    if cuda:
        per_step = {k: launches[k] / total
                    for k in ("flash_attention_sm90",
                              "flash_attention_backward_sm90")}
        if any(n != cfg["num_layers"] for n in per_step.values()):
            raise AssertionError("attention kernels per step %r, want %d "
                                 "each" % (per_step, cfg["num_layers"]))
    ces = [float(c) for c in ces]
    if not all(np.isfinite(ces)) or not ces[-1] < ces[0]:
        raise AssertionError("cross-entropy over %d steps on one batch %r: "
                             "not finite or not falling" % (total, ces))
    bad = [n for n, p in state[0].items()
           if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError("non-finite parameters after training: %r"
                             % bad[:5])
    tokens = batch * cfg["seq_len"]
    # bench_transformer.py:120-123: 6 P tokens + 12 L B T^2 d_model
    flops = (6.0 * transformer.count_params(**cfg) * tokens
             + 12.0 * cfg["num_layers"] * batch * cfg["seq_len"] ** 2
             * cfg["d_model"])
    stats = dict(model="%dL-d%d-h%d-V%d-T%d" % (
                     cfg["num_layers"], cfg["d_model"], cfg["num_heads"],
                     cfg["vocab_size"], cfg["seq_len"]),
                 optimizer="adam", optimizer_params=ADAM, schedule=COSINE,
                 batch=batch, steps=total, steps_timed=timed,
                 step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                 achieved_tflops=flops / step_s / 1e12,
                 share_of_bf16_dense_peak_989=flops / step_s
                 / BF16_FLOP_PER_S,
                 cross_entropy_by_step=ces, lr_by_step=lrs,
                 launches_per_step={k: v / total for k, v in launches.items()
                                    if v})
    if cuda:
        stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2.0 ** 30
        stats["profile"] = prof
    return stats, launches


def optim_update_rows(dev, cfg, time_ms, seed=0):
    """Each registered optimizer's ``fused_update`` over every parameter
    of the LM at ``cfg`` (fp32, as ``TrainStep`` keeps them), random
    gradients: the mean time of the whole sweep (``time_ms``) beside its
    byte bound, every weight, gradient and state tensor read once and
    every weight and state tensor written once, over 3.35 TB/s."""
    import torch

    from mxnet_tpu_torch import optimizer as opt
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.symbol.symbol import _infer_param_shapes

    sym = transformer.get_symbol(**cfg)
    shapes = _infer_param_shapes(sym, {"data": (1, cfg["seq_len"]),
                                       "softmax_label": (1, cfg["seq_len"])})
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    gen = torch.Generator(device=dev).manual_seed(seed)
    weights = {n: 0.02 * torch.randn(tuple(shapes[n]), generator=gen,
                                     device=dev) for n in names}
    grads = {n: torch.randn(tuple(shapes[n]), generator=gen, device=dev)
             for n in names}
    n_elem = sum(w.numel() for w in weights.values())
    rows = []
    for name, kw in (("sgd", dict(momentum=0.9)), ("nag", dict(momentum=0.9)),
                     ("sgld", {}), ("dcasgd", dict(momentum=0.9)),
                     ("adam", {}), ("adagrad", {}), ("rmsprop", {}),
                     ("rmsprop", dict(centered=True)), ("adadelta", {}),
                     ("ftrl", {}), ("adamax", {}), ("nadam", {}),
                     ("test", {})):
        o = opt.create(name, learning_rate=1e-3, wd=1e-4,
                       rescale_grad=1.0 / 8, **kw)
        states = {n: o.init_fused_state(w) for n, w in weights.items()}
        n_states = sum(
            1 for e in (states[names[0]] if isinstance(states[names[0]],
                                                       tuple)
                        else (states[names[0]],))
            if e is not None and e.dim() > 0)

        def sweep():
            for n in names:
                o.fused_update(weights[n], grads[n], states[n], 1e-3, 1e-4,
                               1, gen)

        nbytes = 4 * n_elem * (3 + 2 * n_states)
        ms = time_ms(sweep, target_ms=200.0)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(optimizer=name + ("-centered" if kw.get("centered")
                                           else ""),
                         state_tensors=n_states, ms=ms, bound_ms=bound,
                         bound_by="bytes", over_bound=ms / bound))
        del states
    return dict(params=len(names), elements=n_elem, rows=rows)


NAG = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def nag_fit_phase(dev, sym, batch=256, steps=4, image=224):
    """``Module.fit`` of ``sym`` in bf16 with NAG (momentum 0.9, wd 1e-4)
    under ``MultiFactorScheduler(step=[2], factor=0.1)`` for ``steps``
    steps (``examples/image-classification/common/fit.py``'s
    configuration): the learning rate of every fused step must be the
    schedule's at the pre-increment update count, and every parameter
    finite and changed.  Returns the phase's numbers and launches."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _cuda, lr_scheduler

    cuda = dev.type == "cuda"
    x, y = resnet_images(batch * steps, seed=5, image=image)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mod = mx.mod.Module(sym, context=mx.context.context_of(dev))
    mod.bind(it.provide_data, it.provide_label)
    init = mx.init.Xavier(**XAVIER)
    mod.init_params(init)
    arg0 = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    sched_args = dict(step=[2], factor=0.1)
    mod.init_optimizer(
        optimizer="nag", compute_dtype="bfloat16", optimizer_params=dict(
            NAG, lr_scheduler=lr_scheduler.MultiFactorScheduler(
                **sched_args)))
    lrs, marks = [], []
    fused = mod._fused

    def recorded(*args):
        lrs.append(float(args[5]))
        return fused(*args)

    mod._fused = recorded

    def tick(param):
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    _cuda.reset_launches()
    if cuda:
        torch.cuda.synchronize()
    mod.fit(it, num_epoch=1, optimizer="nag", initializer=init,
            compute_dtype="bfloat16", batch_end_callback=tick)
    launches = dict(_cuda.launches)
    want_sched = lr_scheduler.MultiFactorScheduler(base_lr=NAG[
        "learning_rate"], **sched_args)
    want = [want_sched(n) for n in range(steps)]
    if lrs != want:
        raise AssertionError("nag fit: learning rates %r, the schedule's "
                             "%r" % (lrs, want))
    arg = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    fixed = {n.name + "_gamma" for n in bn_nodes(sym)
             if n.attrs.get("fix_gamma", True)}
    bad = [k for k, v in arg.items() if not np.isfinite(v).all()]
    same = [k for k, v in arg.items()
            if k not in fixed and np.array_equal(v, arg0[k])]
    if bad or same:
        raise AssertionError("nag fit: parameters not finite %r / unchanged "
                             "%r" % (bad[:5], same[:5]))
    # steps 2.. on the host clock, each synced (the first builds cuDNN
    # plans)
    secs = marks[-1] - marks[0]
    return dict(optimizer="nag", optimizer_params=NAG,
                schedule=dict(kind="MultiFactorScheduler", **sched_args),
                batch=batch, steps=steps, lr_by_step=lrs,
                img_per_s_steps_2_on=(len(marks) - 1) * batch / secs,
                step_ms_steps_2_on=1e3 * secs / (len(marks) - 1)), launches


# ops phase: card against CPU by test_torch_op_sweep's comparison
OPS_RTOL, OPS_ATOL = 1e-5, 1e-6
OPS_NOTE = ("the port's op on the card against the same op on the CPU, "
            "same inputs, TF32 off: rtol 1e-5, atol 1e-6, NaN where the "
            "CPU gives NaN, dtypes and shapes equal; samplers by shape, "
            "dtype and device, and by mean and variance within 4 standard "
            "errors at 1e5 draws")


def ops_phase(dev):
    """Every case of the op sweep's table that the port registers
    (``mxnet_tpu_torch/testing/op_specs.py``) on ``dev`` and on the CPU.
    Returns (numbers, failures by name, ops that synchronised the host
    under ``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import imperative_invoke
    from mxnet_tpu_torch.testing import op_specs

    ctx = mx.context.context_of(dev)
    cuda = dev.type == "cuda"
    failures, syncs = {}, {}
    matched = 0

    def run(name, arrays, attrs, on):
        with on:
            ins = [mx.nd.array(a, dtype=a.dtype) for a in arrays]
            if cuda:
                torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                if cuda and on is ctx:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    outs = imperative_invoke(name, ins, dict(attrs))
                finally:
                    if cuda:
                        torch.cuda.set_sync_debug_mode("default")
            said = [str(w.message) for w in seen
                    if "called a synchronizing" in str(w.message)]
            if said:
                syncs[name] = said[0][:160]
            return outs

    for name, (inputs, attrs) in sorted(op_specs.SPECS.items()):
        arrays = [np.asarray(x) for x in inputs]
        try:
            got = run(name, arrays, attrs, ctx)
            want = run(name, arrays, attrs, mx.cpu())
            if len(got) != len(want):
                raise AssertionError("%d outputs, CPU %d" % (len(got),
                                                             len(want)))
            for g, w in zip(got, want):
                if g._data.device.type != dev.type:
                    raise AssertionError("output on %s" % g._data.device)
                gn, wn = g.asnumpy(), w.asnumpy()
                if gn.shape != wn.shape or gn.dtype != wn.dtype:
                    raise AssertionError("%s %s, CPU %s %s" % (
                        gn.shape, gn.dtype, wn.shape, wn.dtype))
                if not op_specs.is_random(name):
                    np.testing.assert_allclose(
                        gn.astype(np.float64), wn.astype(np.float64),
                        rtol=OPS_RTOL, atol=OPS_ATOL, equal_nan=True)
            matched += 1
        except Exception as e:  # noqa: BLE001 — every failure is reported
            failures[name] = "%s: %s" % (type(e).__name__, str(e)[:200])
    moments = {}
    for name, inputs, attrs, (mean, var) in op_specs.RANDOM_MOMENTS:
        with ctx:
            out = imperative_invoke(
                name, [mx.nd.array(x) for x in inputs],
                dict(attrs, shape=(op_specs.N_DRAWS,)))[0]
        ok, m, v = op_specs.moments_ok(out.asnumpy(), mean, var)
        moments[name] = dict(mean=m, var=v, want=(mean, var))
        if not ok:
            failures[name + "(moments)"] = "mean %r var %r, want %r %r" % (
                m, v, mean, var)
    return dict(cases=len(op_specs.SPECS), matched=matched,
                moment_checks=len(op_specs.RANDOM_MOMENTS),
                moments=moments), failures, syncs


def fit_mlp_sym(mx, feat=512, hidden=1024, classes=10):
    """``bench_fit.py``'s ``build_sym(512, 1024, 10)`` over the port."""
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=hidden, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=hidden, name="fc2")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=classes, name="fc3")
    return mx.sym.SoftmaxOutput(net, name="softmax", normalization="batch")


def clone_state(state):
    def one(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(one(e) for e in x)
        return x.clone()
    return [{k: one(v) for k, v in d.items()} for d in state]


def state_diff(got, want):
    """(bit-equal, largest |difference|) over params, aux, states and
    the stacked outputs of two multi-step results."""
    import torch

    pairs = []
    for g, w in zip(got[:3], want[:3]):
        for k in w:
            gs = g[k] if isinstance(g[k], tuple) else (g[k],)
            ws = w[k] if isinstance(w[k], tuple) else (w[k],)
            pairs += [(a, b) for a, b in zip(gs, ws) if b is not None]
    pairs += list(zip(got[3], want[3]))
    equal = all(bool(torch.equal(a, b)) for a, b in pairs)
    worst = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    return equal, worst


ADAM_CLIP = {"learning_rate": 0.01, "wd": 0.01, "clip_global_norm": 0.5}
GEMM_GROUPS = (("gemm", ("gemm", "Gemm", "sm90_", "cutlass", "xmma")),)
ZOO_GROUPS = (("bn_stats", ("StatsOp",)), ("bn_grad_sums", ("GradOp",)),
              ("cudnn_conv_gemm", ("cudnn", "conv", "xmma", "implicit",
                                   "gemm", "Gemm", "sm90_", "cutlass",
                                   "dgrad", "wgrad", "nchwToNhwc",
                                   "nhwcToNchw")))
MULTISTEP_TOL = dict(rtol=1e-5, atol=1e-6)


def multistep_phase(dev, batch=64, n_batches=32, epochs=8, K=16,
                    pure_iters=60):
    """``bench_fit.py``'s recipe: Module.fit at ``steps_per_call=K`` and
    at 1, the pure-step rates, and the captured call against its eager
    loop bit for bit.  Returns the phase's numbers."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fused

    cuda = dev.type == "cuda"
    ctx = mx.context.context_of(dev)
    feat, classes = 512, 10
    rs = np.random.RandomState(0)
    X = rs.randn(n_batches * batch, feat).astype("float32")
    y = rs.randint(0, classes, size=n_batches * batch).astype("float32")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fit(steps_per_call):
        mod = mx.mod.Module(fit_mlp_sym(mx), context=ctx)
        marks = []

        def epoch_cb(epoch, sym_, arg, aux):
            sync()
            marks.append(time.perf_counter())

        mod.fit(mx.io.NDArrayIter(X, y, batch_size=batch), num_epoch=epochs,
                optimizer="sgd", initializer=mx.init.Xavier(),
                optimizer_params={"learning_rate": 0.01},
                epoch_end_callback=epoch_cb, prefetch_to_device=True,
                steps_per_call=steps_per_call, metric_sync_period=50)
        steps = (n_batches // steps_per_call) * steps_per_call
        rate = steps * batch * (len(marks) - 1) / (marks[-1] - marks[0])
        return mod, rate

    mod_k, fit_k = fit(K)
    # no graph on the CPU (a rehearsal): the K steps run eagerly there
    report = mod_k._fused.graph_report() or [dict(
        capture_s=0.0, pool_bytes=0, replays=None, launches={})]
    if cuda and report[0]["replays"] != epochs * n_batches // K:
        raise AssertionError("multistep fit: graphs %r, want one replayed "
                             "%d times (batches / %d)"
                             % (report, epochs * n_batches // K, K))
    mod_1, fit_1 = fit(1)
    a = {k: v.asnumpy() for k, v in mod_k.get_params()[0].items()}
    b = {k: v.asnumpy() for k, v in mod_1.get_params()[0].items()}
    worst = 0.0
    for k in b:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **MULTISTEP_TOL)
        worst = max(worst, float(np.abs(a[k] - b[k]).max()))
    if mod_k._optimizer.num_update != mod_1._optimizer.num_update:
        raise AssertionError("num_update %d at K=%d, %d at K=1" % (
            mod_k._optimizer.num_update, K, mod_1._optimizer.num_update))

    # pure step: bench_fit.py's TrainStep over one resident batch, and
    # the captured K-step call over one resident super-batch
    shapes = {"data": (batch, feat), "softmax_label": (batch,)}
    sgd = {"learning_rate": 0.01, "rescale_grad": 1.0 / batch}
    rsb = np.random.RandomState(1)
    xb = torch.from_numpy(rsb.randn(K, batch, feat).astype("float32")).to(dev)
    yb = torch.from_numpy(rsb.randint(0, classes, (K, batch)).astype(
        "float32")).to(dev)
    rates, profiles = {}, {}
    for steps_per_call in (1, K):
        step = fused.TrainStep(fit_mlp_sym(mx), optimizer="sgd",
                               optimizer_params=sgd, device=dev,
                               steps_per_call=steps_per_call)
        state = step.init_state(shapes)
        bd = ({"data": xb[0], "softmax_label": yb[0]} if steps_per_call == 1
              else {"data": xb, "softmax_label": yb})
        state = step(*state, bd, None)[:3]
        calls = max(2, pure_iters // steps_per_call)
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            state = step(*state, bd, None)[:3]
        sync()
        rates[steps_per_call] = calls * steps_per_call * batch / (
            time.perf_counter() - t0)
        if cuda:
            # K eager steps, or one replay of K: the same K updates
            def window(step=step, bd=bd, n=K // steps_per_call):
                nonlocal state
                for _ in range(n):
                    state = step(*state, bd, None)[:3]
            profiles[steps_per_call] = profiled_window(window, GEMM_GROUPS)

    # the captured call against its eager loop, then a replay at a new
    # lr and first step number
    bitwise = {}
    for name, params in (("sgd", dict(momentum=0.9, **sgd)),
                         ("adam", dict(ADAM_CLIP,
                                       rescale_grad=1.0 / batch))):
        step = fused.TrainStep(fit_mlp_sym(mx), optimizer=name,
                               optimizer_params=params, device=dev,
                               steps_per_call=K)
        state = step.init_state(shapes, seed=2)
        sb = {"data": xb, "softmax_label": yb}
        want = step.run_eager(*clone_state(state), sb, None, 0.01, 1)
        got = step(*state, sb, None, lr=0.01, t=1)
        eq1, d1 = state_diff(got, want)
        sb2 = {"data": xb.flip(0), "softmax_label": yb.flip(0)}
        want2 = step.run_eager(*clone_state(got[:3]), sb2, None, 0.003, 57)
        got2 = step(*got[:3], sb2, None, lr=0.003, t=57)
        eq2, d2 = state_diff(got2, want2)
        moved = not bool(torch.equal(got2[0]["fc1_weight"],
                                     want[0]["fc1_weight"]))
        bitwise[name] = dict(first_call_equal=eq1, first_call_max_diff=d1,
                             new_lr_t0_equal=eq2, new_lr_t0_max_diff=d2)
        if not (eq1 and eq2 and moved):
            raise AssertionError("multistep %s: the captured call is not "
                                 "its eager loop bit for bit: %r"
                                 % (name, bitwise[name]))
    g = report[0]
    return dict(model="bench_fit build_sym(512, 1024, 10)", batch=batch,
                batches_per_epoch=n_batches, epochs=epochs,
                steps_per_call=K, metric_sync_period=50,
                fit_img_per_s_k=fit_k, fit_img_per_s_k1=fit_1,
                fit_speedup_k_over_k1=fit_k / fit_1,
                pure_step_img_per_s=rates[1],
                pure_step_img_per_s_captured_k=rates[K],
                pipeline_efficiency=fit_k / rates[1],
                pipeline_efficiency_k1=fit_1 / rates[1],
                capture_s=g["capture_s"], pool_mb=g["pool_bytes"] / 2.0 ** 20,
                replays=g["replays"], batches=epochs * n_batches,
                launches_per_replay=g["launches"],
                k_vs_k1_max_abs_diff=worst, k_vs_k1_tolerance=MULTISTEP_TOL,
                captured_vs_eager=bitwise,
                profile_k1_steps=profiles.get(1),
                profile_one_replay=profiles.get(K))


ZOO = (("lenet", {}, (1, 28, 28), 10),
       ("mlp", {}, (1, 28, 28), 10),
       ("alexnet", {}, (3, 224, 224), 1000),
       ("vgg", dict(num_layers=16), (3, 224, 224), 1000),
       ("inception_bn", {}, (3, 224, 224), 1000),
       ("mobilenet", {}, (3, 224, 224), 1000),
       ("inception_v3", {}, (3, 299, 299), 1000))
ZOO_SGD = {"learning_rate": 0.01, "momentum": 0.9}


def zoo_phase(dev, name, kwargs, image, classes, batch=128, K=4, calls=2,
              seed=0):
    """One zoo symbol through ``Module.fit`` in bf16 at ``steps_per_call=
    K`` for ``calls`` calls, its graph captured ahead.  Returns the
    phase's numbers and the kernel launches counted over the fit."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _cuda, models

    cuda = dev.type == "cuda"
    sym = models.get_model(name, num_classes=classes, **kwargs)
    n = batch * K * calls
    rng = np.random.default_rng(seed)
    x = rng.random((n,) + image, dtype=np.float32)
    # labels below 256: the bf16 step casts them to bf16 too
    y = rng.integers(0, min(classes, 256), n).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mod = mx.mod.Module(sym, context=mx.context.context_of(dev))
    mod.bind(it.provide_data, it.provide_label)
    init = mx.init.Xavier(**XAVIER)
    mod.init_params(init)
    arg0, aux0 = ({k: v.asnumpy() for k, v in d.items()}
                  for d in mod.get_params())
    mod.init_optimizer(optimizer="sgd", optimizer_params=ZOO_SGD,
                       compute_dtype="bfloat16", steps_per_call=K)
    shapes = {"data": (batch,) + image, "softmax_label": (batch,)}
    mod._fused.compile(shapes)
    marks = []

    def tick(param):
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    ce = mx.metric.CrossEntropy()
    _cuda.reset_launches()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=ZOO_SGD,
            compute_dtype="bfloat16", eval_metric=ce, steps_per_call=K,
            batch_end_callback=tick)
    launches = dict(_cuda.launches)
    report = mod._fused.graph_report() or [dict(
        capture_s=0.0, pool_bytes=0, replays=None, launches={})]
    if cuda and (len(report) != 1 or report[0]["replays"] != calls):
        raise AssertionError("%s: graphs %r, want one replayed %d times"
                             % (name, report, calls))
    nodes = bn_nodes(sym)
    want = {"bn_stats": len(nodes) * K * calls,
            "bn_grad_sums": len(nodes) * K * calls}
    if cuda and any(launches[k] != v for k, v in want.items()):
        raise AssertionError("%s: BatchNorm kernel launches %r, want %r (%d "
                             "BatchNorm nodes x %d steps)" % (
                                 name, {k: launches[k] for k in want}, want,
                                 len(nodes), K * calls))
    loss = ce.get()[1]
    if not np.isfinite(loss):
        raise AssertionError("%s: cross-entropy %r" % (name, loss))
    fixed = {nd.name + "_gamma" for nd in nodes
             if nd.attrs.get("fix_gamma", True)}
    arg, aux = ({k: v.asnumpy() for k, v in d.items()}
                for d in mod.get_params())
    for kind, new, old in (("parameter", arg, arg0),
                           ("moving stat", aux, aux0)):
        bad = [k for k, v in new.items() if not np.isfinite(v).all()]
        same = [k for k, v in new.items()
                if k not in fixed and np.array_equal(v, old[k])]
        if bad or same:
            raise AssertionError("%s: %s not finite %r / unchanged %r"
                                 % (name, kind, bad[:5], same[:5]))
    stats = dict(model=name, kwargs=kwargs,
                 image="x".join(str(d) for d in image), classes=classes,
                 batch=batch, steps_per_call=K, steps=K * calls,
                 img_per_s_call2=K * batch / (marks[-1] - marks[-2]),
                 capture_s=report[0]["capture_s"],
                 pool_mb=report[0]["pool_bytes"] / 2.0 ** 20,
                 cross_entropy=float(loss), bn_nodes=len(nodes),
                 launches_per_replay=report[0]["launches"],
                 params=int(sum(v.size for v in arg.values())))
    step = mod._fused
    params = {k: v._data for k, v in mod._exec.arg_dict.items()
              if k in step.param_names}
    aux_t = {k: v._data for k, v in mod._exec.aux_dict.items()}
    one = {"data": torch.from_numpy(x[:batch]).to(dev),
           "softmax_label": torch.from_numpy(y[:batch]).to(dev)}
    sb = {k: v.unsqueeze(0).expand((K,) + v.shape).contiguous()
          for k, v in one.items()}
    if cuda:
        stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2.0 ** 30
        # one more replay (K steps), profiled
        stats["profile_one_replay"] = profiled_window(
            lambda: step(params, aux_t, mod._fused_states, sb, None),
            ZOO_GROUPS)
    if any(nd.op.name == "Dropout" for nd in sym._topo()
           if not nd.is_variable):
        # four copies of one batch at lr 0 with the momentum zeroed: the
        # weights and batch statistics stay put, so the inner steps'
        # outputs differ only by their dropout masks
        states = {k: None if v is None else torch.zeros_like(v)
                  for k, v in mod._fused_states.items()}
        outs = step(params, aux_t, states, sb, None, lr=0.0)[3][0]
        diff = float((outs[0].float() - outs[1].float()).abs().max())
        stats["dropout_inner_steps_max_diff"] = diff
        if not diff > 0:
            raise AssertionError("%s: two inner steps drew the same dropout "
                                 "masks" % name)
    return stats, launches


# -- fp8 training: K11 and K12 at the LM's shapes ---------------------------

# K11 against its plain version (codes decoded to fp32, an fp32 matmul,
# then the scales): the products are exact, but fp8 wgmma cuts each addend
# of a k32 step 13 bits below the step's largest exponent, and K11 adds
# each 128-deep stage into fp32; each output within the bound derived
# from those cuts, mxnet_tpu_torch/ops/fp8_ops.py::fp8_gemm_error_bound,
# and a sample of outputs equal to the emulation of that sum
# (testing/fp8_accum.py::emulate_k11), which holds K11 far more tightly
FP8_GEMM_NOTE = ("|K11 - plain| <= fp8_ops.fp8_gemm_error_bound("
                 "fp8_gemm_magnitude, K, plain) per output: (135 cuts of a "
                 "128-deep stage x 2^-13, grown) + fp32 roundings, then one "
                 "bf16 rounding; and ~320 sampled outputs equal to "
                 "fp8_accum.emulate_k11's (the measured wgmma sum)")
FP8_CAST_NOTE = "bit-equal: codes, transposed codes and amax"
# the LM's five projection shapes (C in, F out) at M = batch 8 x T 1024
FP8_SHAPES = ((2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048),
              (2048, 32768))


# K12's cases: (case, rows, cols, kind, outputs) at the LM's operands — an
# activation (x, and the FFN down projection's input), a weight (the
# head's, the QKV projection's), a cotangent (the head's, the QKV
# projection's: its amax pass and its e5m2 cast)
FP8_CAST_CASES = (
    ("x-8192x2048-bf16-e4m3", 8192, 2048, 0, "codes"),
    ("w-32768x2048-bf16-e4m3", 32768, 2048, 0, "codes"),
    ("g-8192x32768-bf16-e5m2-amax", 8192, 32768, 1, "amax"),
    ("g-8192x32768-bf16-e5m2", 8192, 32768, 1, "cast"),
    ("x-8192x8192-bf16-e4m3", 8192, 8192, 0, "codes"),
    ("w-6144x2048-bf16-e4m3", 6144, 2048, 0, "codes"),
    ("g-8192x6144-bf16-e5m2-amax", 8192, 6144, 1, "amax"),
    ("g-8192x6144-bf16-e5m2", 8192, 6144, 1, "cast"))
FP8_CAST_OUTPUTS = {"codes": dict(codes=True, transposed=True, amax=True),
                    "amax": dict(codes=False, transposed=False, amax=True),
                    "cast": dict(codes=True, transposed=True, amax=False)}


def fp8_codes(dev, gen, rows, cols, kind, scale_by=1.0):
    """Seeded bf16 operand (rows, cols) cast by K12 at its amax scale:
    (codes, transposed codes, scale)."""
    import torch

    from mxnet_tpu_torch.ops import fp8_ops as F8

    x = (torch.randn((rows, cols), generator=gen, device=dev)
         * scale_by).bfloat16()
    _, _, amax = F8.fp8_cast(x, None, kind, codes=False)
    s = amax / torch.full_like(amax, F8.QMAX[kind])
    c, ct, _ = F8.fp8_cast(x, s, kind, codes=True, transposed=True,
                           amax=False)
    return c, ct, s


def fp8_gemm_edge_cases(dev, gen):
    """K11 off the LM's shapes: 33 x 33 tiles (more than the card's SMs,
    not a multiple of them: the persistent loop's uneven last round), and
    a bf16 output whose rows are not 16-byte aligned (N = 2050: the
    epilogue that stores from registers)."""
    from mxnet_tpu_torch.ops import fp8_ops as F8

    xc, _, sx = fp8_codes(dev, gen, 4224, 2048, F8.E4M3)
    wc, _, sw = fp8_codes(dev, gen, 4160, 2048, F8.E4M3, 0.02)
    yield ("tiles-M4224-C2048-F4160", xc, wc, F8.E4M3, F8.E4M3, sx, sw)
    del xc, wc
    gc, _, sg = fp8_codes(dev, gen, 8192, 2048, F8.E5M2, 1e-3)
    wc, _, sw = fp8_codes(dev, gen, 2050, 2048, F8.E4M3, 0.02)
    yield ("masked-M8192-C2048-F2050", gc, wc, F8.E5M2, F8.E4M3, sg, sw)


def fp8_gemm_cases(dev, gen, M=8192):
    """K11's three products at each projection shape, as the training
    step builds them: (case, a codes, b codes, a kind, b kind, s_a, s_b)
    from seeded bf16 operands cast by K12 at their amax scales."""
    from mxnet_tpu_torch.ops import fp8_ops as F8

    for C, F in FP8_SHAPES:
        xc, xct, sx = fp8_codes(dev, gen, M, C, F8.E4M3)
        wc, wct, sw = fp8_codes(dev, gen, F, C, F8.E4M3, 0.02)
        gc, gct, sg = fp8_codes(dev, gen, M, F, F8.E5M2, 1e-3)
        yield ("fwd-M%d-C%d-F%d" % (M, C, F), xc, wc, F8.E4M3, F8.E4M3,
               sx, sw)
        yield ("dx-M%d-C%d-F%d" % (M, C, F), gc, wct, F8.E5M2, F8.E4M3,
               sg, sw)
        yield ("dw-M%d-C%d-F%d" % (M, C, F), gct, xct, F8.E5M2, F8.E4M3,
               sg, sx)
        del xc, xct, wc, wct, gc, gct


def scaled_mm_call(a, b, a_kind, b_kind, sa, sb):
    """``torch._scaled_mm`` over the same codes (K-major a, b viewed
    column-major), the yardstick of K11's row; None where this torch has
    no such call for the pair of formats."""
    import torch

    dt = (torch.float8_e4m3fn, torch.float8_e5m2)
    fa, fb = a.view(dt[a_kind]), b.view(dt[b_kind]).t()

    def call():
        return torch._scaled_mm(fa, fb, scale_a=sa, scale_b=sb,
                                out_dtype=torch.bfloat16)
    try:
        call()
    except Exception as e:  # the yardstick only: the port never calls it
        log("scaled_mm_unavailable", kinds=[a_kind, b_kind], error=str(e))
        return None
    return call


ROBUST_SCALER = dict(init_scale=2.0 ** 15, growth_interval=1000)
# an LM step's kernels by group: K11, K12 (the amax pass too), the amax
# clears K12's entry puts on the stream, the bf16 attention kernels, the
# library's GEMMs, step health's select; the rest is "other"
FP8_STEP_GROUPS = (("fp8_gemm", ("fp8_gemm_kernel",)),
                   ("fp8_cast", ("fp8_cast_kernel", "fp8_amax_kernel")),
                   ("memset", ("Memset",)),
                   ("flash_sm90", ("flash_fwd_sm90", "flash_bwd_sm90")),
                   ("bf16_gemm", ("gemm", "nvjet", "xmma", "cutlass",
                                  "sm90_")),
                   ("select", ("where_kernel",)))


class phase_peaks:
    """Peak device memory (GiB) of one training step, split where the
    step calls ``torch.autograd.grad``: the forward (up to the call),
    the backward (the call), the update (after it) and the step (the
    largest); a measuring wrapper of that function while the block runs.
    Empty off the card."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.peaks = {}

    def __enter__(self):
        import torch

        if not self.cuda:
            return self.peaks
        self._grad = torch.autograd.grad
        peaks, inner = self.peaks, self._grad

        def grad(*args, **kwargs):
            torch.cuda.synchronize()
            peaks["forward"] = torch.cuda.max_memory_allocated() / 2.0 ** 30
            torch.cuda.reset_peak_memory_stats()
            out = inner(*args, **kwargs)
            torch.cuda.synchronize()
            peaks["backward"] = torch.cuda.max_memory_allocated() / 2.0 ** 30
            torch.cuda.reset_peak_memory_stats()
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.grad = grad
        return peaks

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.autograd.grad = self._grad
            torch.cuda.synchronize()
            self.peaks["update"] = torch.cuda.max_memory_allocated() \
                / 2.0 ** 30
            self.peaks["step"] = max(self.peaks.values())
        return False


def robust_step(dev, cfg, batch, fp8, health, remat=None, optimizer="adam",
                optimizer_params=None):
    """The optim phase's LM step (Adam with ``ADAM`` unless
    ``optimizer``/``optimizer_params`` say otherwise, bf16, batch
    ``batch``, init_state(seed=0)) built under ``MXNET_FP8`` on or off,
    with ``StepHealth(DynamicLossScaler(**ROBUST_SCALER))`` when
    ``health`` and ``remat``; returns (step, [params, aux, states],
    batch)."""
    from mxnet_tpu_torch.health import DynamicLossScaler, StepHealth

    prev = os.environ.get("MXNET_FP8")
    os.environ["MXNET_FP8"] = "on" if fp8 else "off"
    try:
        step, state, data = train_step(
            dev, cfg, batch, "bfloat16", optimizer=optimizer,
            optimizer_params=optimizer_params or ADAM, remat=remat,
            health=StepHealth(scaler=DynamicLossScaler(**ROBUST_SCALER))
            if health else None)
    finally:
        if prev is None:
            os.environ.pop("MXNET_FP8")
        else:
            os.environ["MXNET_FP8"] = prev
    return step, list(state), data


def robust_train_phase(dev, cfg, batch=8, total=13, timed=5):
    """The LM under fp8 (K11/K12 at every projection), the dynamic loss
    scaler and step health.  Each of the bf16, bf16 + health and fp8 +
    health steps is timed over steps 2 to ``timed`` + 1 (the window
    earlier runs reported) and again over the next ``timed`` steps
    (``*_steady``: the allocator and the caches settled).  Returns the
    phase's numbers and the kernel launches of the fp8 run's steps after
    the first."""
    import threading

    import torch

    from mxnet_tpu_torch import _cuda
    from mxnet_tpu_torch import quantize as Q
    from mxnet_tpu_torch.models import transformer

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def free():
        if cuda:
            torch.cuda.empty_cache()

    tokens = batch * cfg["seq_len"]
    flops = (6.0 * transformer.count_params(**cfg) * tokens
             + 12.0 * cfg["num_layers"] * batch * cfg["seq_len"] ** 2
             * cfg["d_model"])
    stats = dict(threads_alive=sorted(th.name
                                      for th in threading.enumerate()),
                 model="%dL-d%d-h%d-V%d-T%d" % (
                     cfg["num_layers"], cfg["d_model"], cfg["num_heads"],
                     cfg["vocab_size"], cfg["seq_len"]),
                 optimizer="adam", optimizer_params=ADAM, batch=batch,
                 scaler=ROBUST_SCALER, steps_timed=timed)

    def rates(step_s):
        return dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                    achieved_tflops=flops / step_s / 1e12)

    # the bf16 step, without and with step health, timed beside the fp8
    # one; the latter's next step profiled (on the card)
    for tag, health in (("bf16", False), ("bf16_health", True)):
        step, state, data = robust_step(dev, cfg, batch, False, health)
        state[:3] = step(*state, data, None, t=1)[:3]
        t = 1
        for window in (tag, tag + "_steady"):
            sync()
            t0 = time.perf_counter()
            for _ in range(timed):
                t += 1
                state[:3] = step(*state, data, None, t=t)[:3]
            sync()
            stats[window] = rates((time.perf_counter() - t0) / timed)
        if health and cuda:
            t0 = time.perf_counter()
            state[:3] = step(*state, data, None, t=t + 1)[:3]
            stats["bf16_health_host_enqueue_ms"] = \
                (time.perf_counter() - t0) * 1e3

            def more():
                state[:3] = step(*state, data, None, t=t + 2)[:3]
            stats["profile_bf16_health"] = profiled_window(more,
                                                           FP8_STEP_GROUPS)
        del step, state, data
        free()

    # fp8 with step health: the loss falls, K11/K12 run their counts
    step, state, data = robust_step(dev, cfg, batch, True, True)
    ces = []

    def one(t, batch_=None):
        state[0], state[1], state[2], outs = step(*state, batch_ or data,
                                                  None, t=t)
        ces.append(ce_tensor(outs[0], data["softmax_label"], torch.bfloat16))

    one(1)  # counts the sites (one forward probe) and warms up
    sites = step._fp8_sites
    hist1 = step.export_hstate()["fp8_hist"]
    if not ((hist1[..., :1] > 0).all() and (hist1[..., 1:] == 0).all()):
        raise AssertionError("fp8 amax history after one step: %r"
                             % hist1[0])
    _cuda.reset_launches()
    for window, first in (("fp8_health", 2), ("fp8_health_steady",
                                              2 + timed)):
        sync()
        t0 = time.perf_counter()
        for t in range(first, first + timed):
            one(t)
        sync()
        stats[window] = rates((time.perf_counter() - t0) / timed)
    for t in range(2 + 2 * timed, total + 1):
        if cuda and t == total:  # the last step profiled
            stats["profile_fp8_health"] = profiled_window(
                lambda: one(t), FP8_STEP_GROUPS)
        else:  # the host's time to enqueue a step, beside its device time
            sync()
            t0 = time.perf_counter()
            one(t)
            stats["fp8_health_host_enqueue_ms"] = \
                (time.perf_counter() - t0) * 1e3
    sync()
    launches = dict(_cuda.launches)
    per_step = {k: v / (total - 1) for k, v in launches.items() if v}
    want = {"fp8_gemm": 3 * sites, "fp8_cast": 4 * sites}
    if cuda and any(per_step.get(k) != n for k, n in want.items()):
        raise AssertionError("fp8 launches a step %r, want %r (%d sites)"
                             % (per_step, want, sites))
    ces = [float(c) for c in ces]
    if not all(np.isfinite(ces)) or not ces[-1] < ces[0]:
        raise AssertionError("fp8 cross-entropy over %d steps on one "
                             "batch %r: not finite or not falling"
                             % (total, ces))
    hist = step.export_hstate()["fp8_hist"]
    if not ((hist[..., :total] > 0).all() and (hist[..., total:] == 0).all()):
        raise AssertionError("the amax history did not fill one column a "
                             "step over %d steps" % total)
    stats.update(fp8_sites=sites, launches_per_step=per_step,
                 cross_entropy_by_step=list(ces),
                 fp8_scales_after=dict(
                     x_min=float(Q.fp8_realize_scales(
                         torch.from_numpy(hist))[:, 0].min()),
                     w_max=float(Q.fp8_realize_scales(
                         torch.from_numpy(hist))[:, 1].max())))

    # one poisoned batch (a token id at V looks up a NaN row): skipped
    # with params and Adam states bit-equal, the scale backed off
    before = clone_state(state)
    scale = step.loss_scale
    poisoned = dict(data)
    poisoned["data"] = data["data"].clone()
    poisoned["data"][0, 0] = float(cfg["vocab_size"])
    one(total + 1, poisoned)
    sync()
    equal, _ = state_diff(state + [()], before + [()])
    h = step.last_health
    if not (bool(h["nonfinite"]) and equal
            and step.loss_scale == scale * 0.5):
        raise AssertionError("poisoned step: nonfinite %s, bit-equal %s, "
                             "scale %r -> %r" % (bool(h["nonfinite"]), equal,
                                                 scale, step.loss_scale))
    del before
    free()
    # what the skip's select costs: old and new params and both Adam
    # states, read and written once more
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    tensors = [t for tree in (state[0], state[2]) for v in tree.values()
               for t in (v if isinstance(v, tuple) else (v,))
               if t is not None]

    def select():
        for t in tensors:
            torch.where(flag, t, t)
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        select()
    sync()
    stats.update(poisoned_step=dict(skipped=True, params_states_bit_equal=
                                    equal, loss_scale=[scale,
                                                       step.loss_scale]),
                 skip_select_ms=(time.perf_counter() - t0) / 3 * 1e3,
                 skip_select_gb=3 * sum(t.numel() * t.element_size()
                                        for t in tensors) / 1e9)
    del step, state, data, tensors
    free()

    # remat: fp8 steps recomputing the forward give the updates of steps
    # that keep it, bit for bit; the second step's peak memory over its
    # forward, its backward and the whole step, under Adam and under SGD
    # without momentum (whose update holds no states)
    stats["remat"] = {}
    for opt, params in (("adam", ADAM), ("sgd", {"learning_rate": 1e-3})):
        got = {}
        for remat in (None, True):
            step, state, data = robust_step(dev, cfg, batch, True, True,
                                            remat=remat, optimizer=opt,
                                            optimizer_params=params)
            state[:3] = step(*state, data, None, t=1)[:3]
            sync()
            with phase_peaks(cuda) as peaks:
                new = step(*state, data, None, t=2)[0]
            got[remat] = dict(new=new, peaks=peaks,
                              segments=len(step._segments or ()))
            del step, state, data
            free()
        equal = all(torch.equal(got[True]["new"][k], v)
                    for k, v in got[None]["new"].items())
        if not equal:
            raise AssertionError("%s: remat=True's update differs from no "
                                 "remat's" % opt)
        stats["remat"][opt] = dict(
            bit_equal=equal, checkpointed_segments=got[True]["segments"],
            peak_gib_no_remat=got[None]["peaks"],
            peak_gib_remat=got[True]["peaks"])
        del got
        free()
    return stats, launches


def robust_fit_phase(dev, batch=64, n_batches=32, epochs=2, K=4,
                     kill_at_call=5):
    """``bench_fit.py``'s MLP through ``Module.fit(checkpoint=,
    health="skip", loss_scale="dynamic", step_timeout_s=,
    steps_per_call=K)`` under ``MXNET_FP8=auto`` (armed on the card: its
    three FullyConnected layers run K11/K12 inside the captured calls):
    once through, and once preempted by its own SIGTERM after call
    ``kill_at_call`` and resumed from the final checkpoint, whose params
    must equal the uninterrupted fit's bit for bit.  Returns the phase's
    numbers and the launches of the preempted and resumed fits."""
    import shutil
    import signal
    import tempfile

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _cuda
    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch.base import TrainingPreempted

    ctx = mx.context.context_of(dev)
    feat, classes = 512, 10
    rs = np.random.RandomState(0)
    X = rs.randn(n_batches * batch, feat).astype("float32")
    y = rs.randint(0, classes, size=n_batches * batch).astype("float32")
    opts = dict(num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": 0.01},
                initializer=mx.init.Xavier(), health="skip",
                loss_scale="dynamic", step_timeout_s=300.0,
                steps_per_call=K, prefetch_to_device=True)

    def fit(**kw):
        mx.random.seed(0)
        np.random.seed(0)
        it = mx.io.NDArrayIter(X, y, batch_size=batch, shuffle=True, seed=0)
        mod = mx.mod.Module(fit_mlp_sym(mx), context=ctx)
        mod.fit(it, **dict(opts, **kw))
        return mod

    def params(mod):
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    prev = os.environ.get("MXNET_FP8")
    os.environ["MXNET_FP8"] = "auto"
    tmp = tempfile.mkdtemp(prefix="robust_fit_")
    try:
        t0 = time.perf_counter()
        ref = fit()
        fit_s = time.perf_counter() - t0
        sites = ref._fused._fp8_sites
        ref = params(ref)
        mgr = ckpt.CheckpointManager(tmp, prefix="mlp")
        calls = [0]

        def kill(param):
            calls[0] += 1
            if calls[0] == kill_at_call:
                os.kill(os.getpid(), signal.SIGTERM)

        _cuda.reset_launches()
        try:
            fit(checkpoint=mgr, batch_end_callback=kill)
        except TrainingPreempted as e:
            where = (e.epoch, e.nbatch)
        else:
            raise AssertionError("the fit was not preempted")
        state = mgr.load(device=dev)
        res = params(fit(resume_from=mgr))
        launches = dict(_cuda.launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if prev is None:
            os.environ.pop("MXNET_FP8", None)
        else:
            os.environ["MXNET_FP8"] = prev
    equal = all(np.array_equal(res[k], v) for k, v in ref.items())
    if not equal or where != (0, kill_at_call * K):
        raise AssertionError("preempted at %r; resumed params bit-equal "
                             "to the uninterrupted fit: %s" % (where, equal))
    if dev.type == "cuda" and min(launches.get(k, 0)
                                  for k in ("fp8_gemm", "fp8_cast")) < 1:
        raise AssertionError("the fit did not run K11/K12: %r" % launches)
    return dict(model="mlp-512-1024-1024-10", batch=batch, K=K,
                fp8_sites=sites, preempted_at=list(where),
                checkpoint=dict(epoch=state.epoch, nbatch=state.nbatch,
                                num_update=state.num_update,
                                hstate_keys=sorted(state.hstate or {})),
                resumed_bit_equal=equal, uninterrupted_fit_s=fit_s,
                launches={k: v for k, v in launches.items() if v}), launches


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device — this script runs only on the "
                 "card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch", "csrc")):
        sys.exit("chip_smoke: mxnet_tpu_torch/ is not beside this script")
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mxnet_tpu_torch import _cuda

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_s = {}
    # -- 1. card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build_dir = _cuda.build()
    log("card", kind=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=_cuda.build_seconds, build_dir=os.path.relpath(build_dir,
                                                                here))

    log("sass", tensor_core_instructions=kernel_sass(build_dir))
    log("ptxas", note="registers a thread at launch (in K7/K8 and K11 "
        "setmaxnreg then gives the consumer warpgroups 240) and spill "
        "bytes", kernels=ptxas_report(build_dir, SM90_STEMS))
    log("ptxas", note="registers a thread and spill bytes of fp8 "
        "training's scaled cast K12 (fp8_cast)",
        kernels=ptxas_report(build_dir, ("fp8_cast",)))
    log("ptxas", note="registers a thread and spill bytes of serving's "
        "decode kernels, K3 and K3q (linear), K2 and K2q (paged_attention) "
        "and K9 (kv_quant)",
        kernels=ptxas_report(build_dir, ("linear", "paged_attention",
                                         "kv_quant")))
    log("ptxas", note="registers a thread and spill bytes of the fp32 flash "
        "kernels, K1 (flash_attention) and K4 (flash_attention_backward)",
        kernels=ptxas_report(build_dir, ("flash_attention",
                                         "flash_attention_backward")))

    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    errs = dict.fromkeys(list(_cuda.KERNELS) + list(RTC_KERNELS), 0.0)

    def time_ms(fn, target_ms=300.0, spin=True):
        """Mean CUDA-event time of ``fn`` per call, L2 flushed before
        every call (outside the timed window).  A spin of the device
        (``torch.cuda._sleep``, ~0.5 ms) after the flush holds the start
        event back until the host has enqueued the call, so the window
        holds the call's device work, not the host's launch path (a
        call that launches many kernels still waits on the host between
        them).  ``spin=False`` leaves the spin out, so the window also
        holds whatever of the host's launch path the flush does not
        cover."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t0) * 1e3
        reps = int(min(max(target_ms / max(once, 1e-3), 3), 50))
        pairs = []
        for _ in range(reps):
            flush_buf.zero_()
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    def host_ms(fn, reps=50):
        """Host time per call of ``fn``'s launch path: ``reps`` calls
        enqueued back to back, the clock stopped before the device is
        waited for."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return ms

    def device_ms(fn, key, reps=20):
        """Device time per call of ``fn``'s kernels whose name holds
        ``key`` (one a call), or of every kernel of a call for "", from
        the profiler over ``reps`` calls: the kernel alone, without the
        host's launch path, which the CUDA-event time of a launch-bound
        kernel includes.  For a key, the mean over the launches the
        profiler saw (it may drop a launch of a library loaded apart from
        PyTorch's runtime); None where it saw none in three windows."""
        fn()
        for _ in range(3):
            prof = profiled_window(lambda: [fn() for _ in range(reps)],
                                   ((key, (key,)),))
            seen = prof["kernels_by_group"][key]
            if seen:
                return prof["device_ms_by_group"][key] / (seen if key
                                                          else reps)
        return None

    def record(name, case, err, ok, tolerance, kernel, plain, library,
               nbytes, flops, peak=FP32_FLOP_PER_S, device_key=None,
               bandwidth=False, extra=None):
        if not ok:
            raise AssertionError("%s %s: max error %.3g outside the "
                                 "tolerance (%s)" % (name, case, err,
                                                     tolerance))
        errs[name] = max(errs[name], float(err))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        row = dict(kernel=name, case=case, max_abs_err=float(err),
                   tolerance=tolerance, kernel_ms=time_ms(kernel),
                   plain_ms=time_ms(plain),
                   library_ms=time_ms(library) if library else None,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        row.update(extra or {})
        if device_key:
            row["kernel_device_ms"] = device_ms(kernel, device_key)
            if library:  # every kernel the one PyTorch call launches
                row["library_device_ms"] = device_ms(library, "")
        if bandwidth:  # bytes the bound counts over the kernel's time
            row["effective_gb_s"] = nbytes / row["kernel_ms"] / 1e6
            row["bound_gb_s"] = HBM_BYTES_PER_S / 1e9
            # the same calls in the window without the spin, which holds
            # the host's launch path where it is the longer, and that
            # launch path alone
            row["kernel_ms_with_launch"] = time_ms(kernel, spin=False)
            row["kernel_host_ms"] = host_ms(kernel)
            if library:
                row["library_ms_with_launch"] = time_ms(library, spin=False)
                row["library_host_ms"] = host_ms(library)
        log("kernel", **row)
        rows[(name, case)] = row

    # -- 2. kernels against their plain versions ----------------------------
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.ops import linear as L

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # K1: causal flash forward; the serving oracle's block is the page,
    # fp32 training's 128
    for n, h, t, d, causal, block in ((1, 16, 256, 128, True, 16),
                                      (1, 16, 1024, 128, True, 16),
                                      (1, 16, 1024, 128, True, 128),
                                      (1, 2, 37, 16, True, 16),
                                      (1, 2, 37, 16, False, 16)):
        q, k, v = randn(n, h, t, d), randn(n, h, t, d), randn(n, h, t, d)
        scale = 1.0 / d ** 0.5
        got = A.flash_attention(q, k, v, causal=causal, scale=scale,
                                block=block)
        want = A.flash_attention_plain(q, k, v, causal, scale, block,
                                       mi=True)
        pairs = n * h * (t * (t + 1) // 2 if causal else t * t)
        err = (got - want).abs().max().item()
        record("flash_attention", "n%d-h%d-T%d-D%d-%s-b%d"
               % (n, h, t, d, "causal" if causal else "full", block),
               err, err <= ATTN_ATOL, ATTN_NOTE,
               lambda: A.flash_attention(q, k, v, causal=causal, scale=scale,
                                         block=block),
               lambda: A.flash_attention_plain(q, k, v, causal, scale,
                                               block, mi=True),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, scale=scale),
               nbytes=4 * 4 * n * h * t * d, flops=4 * d * pairs)

    # K7 + K8: the bf16 tensor-core kernels of the training path, at the
    # bench's shape, against the plain versions inside the derived bound
    # (the plain versions keep P and dS in fp32, the kernels round them to
    # bf16 as the TPU kernel does: testing/attention_sm90.py)
    from mxnet_tpu_torch.testing import attention_sm90 as SM90

    sdpa = torch.nn.functional.scaled_dot_product_attention
    n, h, t, d = 8, 16, 1024, 128
    scale = 1.0 / d ** 0.5
    q, k, v, g = (randn(n, h, t, d).bfloat16() for _ in range(4))
    pairs = n * h * t * (t + 1) // 2
    out, lse = A._flash_forward_cuda(q, k, v, True, scale, 128, True)
    want_out, want_lse = A.flash_forward_plain(q, k, v, True, scale, 128)
    err, ratio = SM90.violation(out, want_out, SM90.forward_bound(
        q, k, v, want_out, True, scale))
    lse_err = (lse - want_lse).abs().max().item()
    record("flash_attention_sm90", "n8-h16-T1024-D128-causal-lse",
           max(err, lse_err), ratio <= 1.0 and lse_err <= LSE_ATOL,
           SM90.TOLERANCE_NOTE + "; lse atol %g" % LSE_ATOL,
           lambda: A._flash_forward_cuda(q, k, v, True, scale, 128, True),
           lambda: A.flash_forward_plain(q, k, v, True, scale, 128),
           lambda: sdpa(q, k, v, is_causal=True, scale=scale),
           nbytes=2 * 4 * n * h * t * d + 4 * n * h * t,
           flops=4 * d * pairs, peak=BF16_FLOP_PER_S)
    got = A._flash_backward_cuda(q, k, v, out, lse, g, True, scale, 128)
    want = A.flash_backward_plain(q, k, v, out, lse, g, True, scale, 128)
    checks = [SM90.violation(a, b, c) for a, b, c in zip(
        got, want, SM90.backward_bounds(q, k, v, out, lse, g, want, True,
                                        scale))]
    sm90_invariants(A, q, k, v, out, lse, g, True, scale, got)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_out = sdpa(qs, ks, vs, is_causal=True, scale=scale)
    record("flash_attention_backward_sm90", "n8-h16-T1024-D128-causal",
           max(e for e, _ in checks), all(r <= 1.0 for _, r in checks),
           SM90.TOLERANCE_NOTE + "; rerun bit-equal; K8(2g) == 2 K8(g)",
           lambda: A._flash_backward_cuda(q, k, v, out, lse, g, True, scale,
                                          128),
           lambda: A.flash_backward_plain(q, k, v, out, lse, g, True, scale,
                                          128),
           lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), g,
                                       retain_graph=True),
           nbytes=2 * 8 * n * h * t * d + 4 * n * h * t,
           flops=10 * d * pairs, peak=BF16_FLOP_PER_S)
    # against fp64 truth, beside SDPA (which also rounds P to bf16)
    sdpa_grads = torch.autograd.grad(sdpa_out, (qs, ks, vs), g)
    acc = fp64_accuracy(q, k, v, g, scale, (out,) + tuple(got),
                        (sdpa_out.detach(),) + tuple(sdpa_grads))
    log("sm90_accuracy", case="n8-h16-T1024-D128-causal", bound=SM90_FP64,
        tolerance=SM90_FP64_NOTE, **acc)
    bad = [name for name, r in acc.items()
           if r["max_ratio"] > SM90_FP64 or r["mean_ratio"] > SM90_FP64]
    if bad:
        raise AssertionError("K7/K8 less accurate than SDPA against fp64 "
                             "in %r: %r" % (bad, acc))
    del q, k, v, g, out, lse, want_out, want_lse, got, want, sdpa_out
    del qs, ks, vs, sdpa_grads
    torch.cuda.empty_cache()

    # K7 + K8 at ragged and small shapes, every head dim class: the bound,
    # reruns bit-equal, linearity in g
    worst = dict.fromkeys(("out", "dq", "dk", "dv"), 0.0)
    n_cases = 0
    for t in (5, 37, 200):
        for d in (16, 64, 80, 128, 256):
            for causal in (True, False):
                scale = 1.0 / d ** 0.5
                q, k, v, g = (randn(1, 2, t, d).bfloat16() for _ in range(4))
                out, lse = A._flash_forward_cuda(q, k, v, causal, scale, 128,
                                                 True)
                wo, wl = A.flash_forward_plain(q, k, v, causal, scale, 128)
                e, r = SM90.violation(out, wo, SM90.forward_bound(
                    q, k, v, wo, causal, scale))
                results = [("out", "flash_attention_sm90", e, r)]
                got = A._flash_backward_cuda(q, k, v, wo, wl, g, causal,
                                             scale, 128)
                want = A.flash_backward_plain(q, k, v, wo, wl, g, causal,
                                              scale, 128)
                for name, a, b, c in zip(("dq", "dk", "dv"), got, want,
                                         SM90.backward_bounds(
                                             q, k, v, wo, wl, g, want,
                                             causal, scale)):
                    e, r = SM90.violation(a, b, c)
                    results.append((name, "flash_attention_backward_sm90",
                                    e, r))
                sm90_invariants(A, q, k, v, wo, wl, g, causal, scale, got)
                lse_err = (lse - wl).abs().max().item()
                for name, kernel, e, r in results:
                    if r > 1.0 or lse_err > LSE_ATOL:
                        raise AssertionError(
                            "%s T%d D%d causal=%s: %s error %.3g is %.3g x "
                            "the bound (%s); lse error %.3g"
                            % (kernel, t, d, causal, name, e, r,
                               SM90.TOLERANCE_NOTE, lse_err))
                    worst[name] = max(worst[name], r)
                    errs[kernel] = max(errs[kernel], e)
                n_cases += 1
    log("sm90_cases", cases=n_cases, shapes="n1-h2, T in (5, 37, 200), D in "
        "(16, 64, 80, 128, 256), causal and full",
        tolerance=SM90.TOLERANCE_NOTE, worst_error_over_bound=worst,
        rerun_bitequal=True, linear_in_g=True)

    # K4 in fp32 at fp32 training's shape, against the plain version and,
    # beside SDPA's fp32 backward, against fp64 truth; reruns bit-equal,
    # K4(2g) == 2 K4(g)
    n, h, t, d, block = 1, 16, 1024, 128, 128
    scale = 1.0 / d ** 0.5
    q, k, v, g = (randn(n, h, t, d) for _ in range(4))
    out, lse = A._flash_forward_cuda(q, k, v, True, scale, block, True)
    got = A._flash_backward_cuda(q, k, v, out, lse, g, True, scale, block)
    want = A.flash_backward_plain(q, k, v, out, lse, g, True, scale, block)
    again = A._flash_backward_cuda(q, k, v, out, lse, g, True, scale, block)
    twice = A._flash_backward_cuda(q, k, v, out, lse, 2 * g, True, scale,
                                   block)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("K4: a rerun gave other bits")
    if not all(torch.equal(2 * a, b) for a, b in zip(got, twice)):
        raise AssertionError("K4: the result at 2 g is not twice that at g")
    pairs = n * h * t * (t + 1) // 2
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, scale=scale)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    record("flash_attention_backward", "n1-h16-T1024-D128-causal-fp32", err,
           err <= K4_T1024_ATOL,
           K4_T1024_NOTE + "; rerun bit-equal; K4(2g) == 2 K4(g)",
           lambda: A._flash_backward_cuda(q, k, v, out, lse, g, True, scale,
                                          block),
           lambda: A.flash_backward_plain(q, k, v, out, lse, g, True, scale,
                                          block),
           lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), g,
                                       retain_graph=True),
           nbytes=4 * 8 * n * h * t * d + 4 * n * h * t,
           flops=10 * d * pairs)
    sdpa_grads = torch.autograd.grad(sdpa_out, (qs, ks, vs), g)
    acc = fp64_accuracy(q, k, v, g, scale, (out,) + tuple(got),
                        (sdpa_out.detach(),) + tuple(sdpa_grads),
                        plain=(out,) + tuple(want))
    log("k4_accuracy", case="n1-h16-T1024-D128-causal-fp32", bound=K4_FP64,
        tolerance=K4_FP64_NOTE,
        # the kernel row's bound counts 10 D flops a visible pair; dQ's
        # recompute of q.k and dO.v makes K4's own work 14 D
        bound_ms_with_recompute=14 * d * pairs / FP32_FLOP_PER_S * 1e3,
        **acc)
    bad = [name for name, r in acc.items() if name != "out" and (
        r["max_ratio"] > K4_FP64 or r["mean_ratio"] > K4_FP64)]
    if bad:
        raise AssertionError("K4 less accurate than SDPA's fp32 backward "
                             "against fp64 in %r: %r" % (bad, acc))
    del q, k, v, g, out, lse, got, want, again, twice, sdpa_out, qs, ks, vs
    del sdpa_grads
    torch.cuda.empty_cache()

    # K4 in fp32 at a small ragged shape (37 = 2 blocks of 16 + 5), a
    # correctness case
    for causal in (True, False):
        n, h, t, d, block = 1, 2, 37, 16, 16
        scale = 1.0 / d ** 0.5
        q, k, v, g = (randn(n, h, t, d) for _ in range(4))
        out, lse = A.flash_forward_plain(q, k, v, causal, scale, block)
        got = A._flash_backward_cuda(q, k, v, out, lse, g, causal, scale,
                                     block)
        want = A.flash_backward_plain(q, k, v, out, lse, g, causal, scale,
                                      block)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        pairs = n * h * (t * (t + 1) // 2 if causal else t * t)
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, scale=scale)
        record("flash_attention_backward", "n1-h2-T37-D16-%s-fp32"
               % ("causal" if causal else "full"), err, err <= BWD_ATOL,
               BWD_NOTE,
               lambda: A._flash_backward_cuda(q, k, v, out, lse, g, causal,
                                              scale, block),
               lambda: A.flash_backward_plain(q, k, v, out, lse, g, causal,
                                              scale, block),
               lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), g,
                                           retain_graph=True),
               nbytes=4 * 8 * n * h * t * d + 4 * n * h * t,
               flops=10 * d * pairs)

    # K2: decode (8 slots, one query each; slot 7 idle), decode at a long
    # context (8 slots near 1024 tokens, 64 pages each) and prefill (one
    # slot, a 256-row bucket at offset 32 with per-row horizons)
    page, h, d = 16, 16, 128
    rs = np.random.RandomState(5)
    cases = []
    for max_pages, lo, idle in ((18, 24, True), (64, 64 * page - 63, False)):
        n_pages = 8 * max_pages
        pools = tuple(randn(n_pages + 1, page, h, d) for _ in range(2))
        tables = torch.from_numpy(rs.permutation(n_pages).reshape(
            8, max_pages).astype(np.int32)).to(dev)
        lens = rs.randint(lo, max_pages * page + 1, size=8)
        if idle:
            lens[7] = 0
        case = "decode-S8-Q1" + ("" if max_pages == 18 else "-64pages")
        cases.append((case, pools, randn(8, h, 1, d), tables,
                      torch.from_numpy(lens.astype(np.int32)).to(dev)))
        if max_pages == 18:
            for bucket in (256, 64):  # serving's largest and smallest
                horizons = (32 + np.arange(bucket) + 1).astype(np.int32)
                cases.append(("prefill-S1-Q%d-offset32" % bucket, pools,
                              randn(1, h, bucket, d),
                              tables[:1].contiguous(),
                              torch.from_numpy(horizons.reshape(
                                  1, bucket)).to(dev)))
            # speculative verify: 8 slots, W = 5 rows each at horizons
            # committed + j + 1 over a ~250-token context
            committed = rs.randint(240, 251, size=(8, 1))
            horizons = (committed + np.arange(5) + 1).astype(np.int32)
            cases.append(("verify-S8-Q5", pools, randn(8, h, 5, d), tables,
                          torch.from_numpy(horizons).to(dev)))

    def gathered_sdpa(q, pools, tab, hor):
        """SDPA over a case's context already gathered into (S, H, L, D),
        L = the longest horizon, each query row masked to its own
        horizon: the active slots at decode (hor (S,)), every slot's rows
        at prefill and verify (hor (S, Q)).  The gather itself is not
        timed."""
        L = int(hor.max())
        keys = torch.arange(L, device=dev)
        if hor.dim() == 2:  # a horizon a query row
            live = (hor.amax(-1) > 0).nonzero().flatten()
            mask = keys < hor[live][:, None, :, None]  # (S, 1, Q, L)
        else:
            live = (hor > 0).nonzero().flatten()
            mask = keys < hor[live].reshape(-1, 1, 1, 1)  # (S, 1, 1, L)
        kc, vc = (pool[tab[live].long()].reshape(len(live), -1, h, d)
                  [:, :L].permute(0, 2, 1, 3).contiguous() for pool in pools)
        ql = q[live].contiguous()
        return live, lambda: torch.nn.functional.scaled_dot_product_attention(
            ql, kc, vc, attn_mask=mask, scale=1.0 / d ** 0.5)

    for case, (k_pool, v_pool), q, tab, hor in cases:
        got = A.paged_attention(q, k_pool, v_pool, tab, hor)
        if not torch.equal(got, A.paged_attention(q, k_pool, v_pool, tab,
                                                  hor)):
            raise AssertionError("paged_attention %s: a rerun gave other "
                                 "bits" % case)
        want = A.paged_attention_plain(q, k_pool, v_pool, tab, hor)
        if case == "decode-S8-Q1" and got[7].abs().max().item() != 0.0:
            raise AssertionError("paged_attention: idle slot is not 0")
        hn = hor.cpu().numpy()
        per_slot = hn.max(axis=-1) if hn.ndim == 2 else hn
        nbytes = 4 * (2 * q.numel() + tab.numel() + hor.numel()
                      + 2 * int(per_slot.sum()) * h * d)
        err = (got - want).abs().max().item()
        # the yardstick must compute the same function: a wrong gather or
        # mask would be off by far more than fp32 roundoff
        live, library = gathered_sdpa(q, (k_pool, v_pool), tab, hor)
        lib_err = (library() - want[live]).abs().max().item()
        log("library_check", kernel="paged_attention", case=case,
            library="gathered SDPA", max_abs_err=lib_err)
        if lib_err > 1e-3:
            raise AssertionError("paged_attention %s: the gathered SDPA is "
                                 "%.3g off the plain version" % (case,
                                                                 lib_err))
        record("paged_attention", case, err, err <= ATTN_ATOL,
               ATTN_NOTE + "; rerun bit-equal",
               lambda: A.paged_attention(q, k_pool, v_pool, tab, hor),
               lambda: A.paged_attention_plain(q, k_pool, v_pool, tab, hor),
               library, nbytes=nbytes,
               flops=4 * d * h * int(hn.sum()), bandwidth=True)

    # K2q: the same cases over one-byte pages, the pools quantized per row
    # (int8 and e4m3); bit-equal to K2 on the dequantized pools, reruns
    # bit-equal, within ATTN_ATOL of the plain version
    from mxnet_tpu_torch import quantize as Q

    for mode in ("int8", "fp8"):
        for case, pools, q, tab, hor in cases:
            (kc, ks), (vc, vs) = (Q.kv_quantize_rows(p, mode) for p in pools)
            deq = (Q.kv_dequantize(kc, ks), Q.kv_dequantize(vc, vs))
            kw = dict(k_scale=ks, v_scale=vs)
            got = A.paged_attention(q, kc, vc, tab, hor, **kw)
            if not torch.equal(got, A.paged_attention(q, kc, vc, tab, hor,
                                                      **kw)):
                raise AssertionError("paged_attention_q %s %s: a rerun gave "
                                     "other bits" % (mode, case))
            if not torch.equal(got, A.paged_attention(q, *deq, tab, hor)):
                raise AssertionError("paged_attention_q %s %s: not K2's bits "
                                     "on the dequantized pools"
                                     % (mode, case))
            want = A.paged_attention_plain(q, kc, vc, tab, hor, **kw)
            hn = hor.cpu().numpy()
            per_slot = hn.max(axis=-1) if hn.ndim == 2 else hn
            nbytes = (4 * (2 * q.numel() + tab.numel() + hor.numel())
                      + 2 * int(per_slot.sum()) * (h * d + 4))
            err = (got - want).abs().max().item()
            live, library = gathered_sdpa(q, deq, tab, hor)
            lib_err = (library() - want[live]).abs().max().item()
            if lib_err > 1e-3:
                raise AssertionError("paged_attention_q %s %s: the gathered "
                                     "SDPA is %.3g off the plain version"
                                     % (mode, case, lib_err))
            record("paged_attention_q", "%s-%s" % (mode, case), err,
                   err <= ATTN_ATOL,
                   ATTN_NOTE + "; bit-equal to K2 on the dequantized pools; "
                   "rerun bit-equal",
                   lambda: A.paged_attention(q, kc, vc, tab, hor, **kw),
                   lambda: A.paged_attention_plain(q, kc, vc, tab, hor,
                                                   **kw),
                   library, nbytes=nbytes,
                   flops=4 * d * h * int(hn.sum()), bandwidth=True)
            del kc, ks, vc, vs, deq
    del cases, got, want
    torch.cuda.empty_cache()

    # K1 with a sliding window: the oracle of a hybrid stack's windowed
    # layers at the serving LM's shape (block = page 16, window 128); the
    # yardstick is SDPA with the window as an explicit mask
    n, h, t, d, block, window = 1, 16, 1024, 128, 16, 128
    q, k, v = randn(n, h, t, d), randn(n, h, t, d), randn(n, h, t, d)
    scale = 1.0 / d ** 0.5
    got = A.flash_attention(q, k, v, scale=scale, block=block, window=window)
    if not torch.equal(got, A.flash_attention(q, k, v, scale=scale,
                                              block=block, window=window)):
        raise AssertionError("flash_attention_window: a rerun gave other "
                             "bits")
    want = A.flash_attention_plain(q, k, v, True, scale, block, mi=True,
                                   window=window)
    pos = torch.arange(t, device=dev)
    win_mask = (pos[None, :] <= pos[:, None]) & \
        (pos[:, None] - pos[None, :] < window)
    err = (got - want).abs().max().item()
    record("flash_attention_window", "n1-h16-T1024-D128-causal-b16-w128",
           err, err <= ATTN_ATOL, ATTN_NOTE + "; rerun bit-equal",
           lambda: A.flash_attention(q, k, v, scale=scale, block=block,
                                     window=window),
           lambda: A.flash_attention_plain(q, k, v, True, scale, block,
                                           mi=True, window=window),
           lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, attn_mask=win_mask, scale=scale),
           nbytes=4 * 4 * n * h * t * d,
           flops=4 * d * n * h * int(win_mask.sum()))
    win_full = got  # K2 over rings must give these rows

    # K2 and K2q over windowed layers' rings: 25 pages of 16 rows a slot
    # (window 128 + the 256-row bucket - 1, plus a page), read through
    # rotated tables, at decode (8 slots, every ring wrapped), the verify
    # (8 slots x 5 rows) and a 256-row prefill at offset 512.  K2's rows
    # must be K1's windowed rows bit for bit; the yardstick is SDPA over
    # the ring gathered in position order, masked by position
    from mxnet_tpu_torch.serve.model import ring_table

    rp, page = 25, 16
    ring_rows = [k[0].transpose(0, 1), v[0].transpose(0, 1)]  # (T, h, d)

    def ring_of(rows_, lasts):
        """Each slot's ring after positions 0 .. last were written in
        order; rows nothing wrote hold NaN (fp32, scales) or 0 (codes)."""
        pools = []
        for x in rows_:
            shape = (len(lasts) * rp, page) + tuple(x.shape[1:])
            pools.append(torch.full(shape, float("nan"), device=dev)
                         if x.dtype.is_floating_point else
                         torch.zeros(shape, dtype=x.dtype, device=dev))
        for slot, last in enumerate(lasts):
            p = torch.arange(max(last + 1 - rp * page, 0), last + 1,
                             device=dev)
            for pool, x in zip(pools, rows_):
                pool[slot * rp + (p // page) % rp, p % page] = x[p]
        return pools

    ring_cases = []
    hz = np.array([420, 512, 600, 777, 850, 901, 1000, 1024])
    ring_cases.append(("decode-S8-Q1-ring", hz - 1, (hz - 1) // page,
                       torch.stack([q[0, :, n - 1] for n in hz])[:, :, None],
                       torch.from_numpy(hz.astype(np.int32)).to(dev)))
    committed = np.array([400, 455, 512, 600, 701, 800, 900, 1019])
    hor = committed[:, None] + np.arange(5) + 1
    ring_cases.append(("verify-S8-Q5-ring", committed + 4,
                       (committed + 4) // page,
                       torch.stack([torch.stack([q[0, :, n - 1] for n in row],
                                                1) for row in hor]),
                       torch.from_numpy(hor.astype(np.int32)).to(dev)))
    hor = (512 + np.arange(256) + 1)[None]
    ring_cases.append(("prefill-S1-Q256-offset512-ring", np.array([767]),
                       np.array([767 // page]), q[:, :, 512:768],
                       torch.from_numpy(hor.astype(np.int32)).to(dev)))

    def ring_sdpa(qr, pools, table, k_pos0, hor_):
        """SDPA over each slot's ring gathered in position order, each row
        masked to 0 <= p <= pos and p > pos - window (the gather is not
        timed)."""
        kpos = A.table_positions(k_pos0, table, page)        # (S, L)
        hr = hor_ if hor_.dim() == 2 else hor_[:, None]      # (S, Q|1)
        posq = (hr - 1)[:, None, :, None]
        kp = kpos[:, None, None, :]
        mask = (kp >= 0) & (kp <= posq) & (kp > posq - window)
        kc, vc = (A.gather_pages(pool, table) for pool in pools[:2])
        if len(pools) == 4:  # codes: dequantize the gathered rows
            kc = Q.codes_to_float(kc) * A.gather_scales(
                pools[2], table)[:, None, :, None]
            vc = Q.codes_to_float(vc) * A.gather_scales(
                pools[3], table)[:, None, :, None]
        kc, vc = kc.contiguous(), vc.contiguous()
        qc = qr.contiguous()
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=mask, scale=scale)

    for mode in (None, "int8", "fp8"):
        rows_ = ring_rows
        if mode:
            (kc_, ks_), (vc_, vs_) = (Q.kv_quantize_rows(x, mode)
                                      for x in ring_rows)
            rows_ = [kc_, vc_, ks_, vs_]
        name = "paged_attention_q_ring" if mode else "paged_attention_ring"
        for case, lasts, pb_max, qr, hor_ in ring_cases:
            pools = ring_of(rows_, lasts)
            table, k_pos0 = ring_table(
                torch.arange(len(lasts), device=dev),
                torch.from_numpy(pb_max).to(dev), rp, page)
            kw = dict(window=window, k_pos0=k_pos0)
            if mode:
                kw.update(k_scale=pools[2], v_scale=pools[3])
            qr = qr.contiguous()
            got = A.paged_attention(qr, pools[0], pools[1], table, hor_, **kw)
            if not torch.equal(got, A.paged_attention(qr, pools[0], pools[1],
                                                      table, hor_, **kw)):
                raise AssertionError("%s %s: a rerun gave other bits"
                                     % (name, case))
            hr = hor_ if hor_.dim() == 2 else hor_[:, None]
            if not mode:  # every row is K1's windowed row, bit for bit
                for i in range(hr.shape[0]):
                    for j in range(hr.shape[1]):
                        if not torch.equal(got[i, :, j],
                                           win_full[0, :, int(hr[i, j]) - 1]):
                            raise AssertionError(
                                "%s %s: row (%d, %d) is not K1's windowed "
                                "row" % (name, case, i, j))
            want = A.paged_attention_plain(qr, pools[0], pools[1], table,
                                           hor_, **kw)
            err = (got - want).abs().max().item()
            library = ring_sdpa(qr, pools, table, k_pos0, hor_)
            lib_err = (library() - want).abs().max().item()
            if not lib_err <= 1e-3:
                raise AssertionError("%s %s: the ring SDPA is %.3g off the "
                                     "plain version" % (name, case, lib_err))
            hn = hr.cpu().numpy()
            # keys a slot reads: the union of its rows' windows
            keys = np.minimum(hn.max(-1), window + hn.shape[1] - 1)
            vis = np.minimum(hn, window)
            row_bytes = h * d * (1 if mode else 4) + (4 if mode else 0)
            nbytes = (4 * (2 * qr.numel() + table.numel() + hor_.numel())
                      + 2 * int(keys.sum()) * row_bytes)
            record(name, "%s%s" % (mode + "-" if mode else "", case), err,
                   err <= ATTN_ATOL,
                   ATTN_NOTE + "; rerun bit-equal" + (
                       "" if mode else "; every row K1's windowed row"),
                   lambda: A.paged_attention(qr, pools[0], pools[1], table,
                                             hor_, **kw),
                   lambda: A.paged_attention_plain(qr, pools[0], pools[1],
                                                   table, hor_, **kw),
                   library, nbytes=nbytes,
                   flops=4 * d * h * int(vis.sum()), bandwidth=True)
            del pools
    del ring_cases, win_full
    torch.cuda.empty_cache()

    # K10: the SSM scan at serving's shapes — a decode step (8 slots, one
    # row each), a 256-row prefill chunk (one slot) and the verify (8
    # slots x 5 rows, the state after every row kept) — bit-equal to the
    # plain version, which runs K10's operations in its order; no single
    # PyTorch call computes the scan
    from mxnet_tpu_torch.ops import ssm_ops as SSM

    h, d = 16, 128
    gamma = SSM.ssm_decay(h, dev)
    for s_, t_, collect, case in ((8, 1, False, "decode-S8-T1-H16-D128"),
                                  (1, 256, False, "prefill-S1-T256-H16-D128"),
                                  (8, 5, True,
                                   "verify-S8-W5-H16-D128-collect")):
        q, k, v = (randn(s_, t_, h, d) for _ in range(3))
        state0 = 0.1 * randn(s_, h, d, d)
        got = SSM.ssm_scan(q, k, v, state0, gamma, collect=collect)
        again = SSM.ssm_scan(q, k, v, state0, gamma, collect=collect)
        want = SSM.ssm_scan_plain(q, k, v, state0, gamma, collect=collect)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("ssm_scan %s: a rerun gave other bits"
                                 % case)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        # q, k, v read, y written, the state read once and written once a
        # row kept (the last snapshot is the state)
        nbytes = 4 * (4 * s_ * t_ * h * d + h
                      + (1 + (t_ if collect else 1)) * s_ * h * d * d)
        record("ssm_scan", case, err, same,
               "bit-equal: the plain version runs K10's operations in its "
               "order; rerun bit-equal",
               lambda: SSM.ssm_scan(q, k, v, state0, gamma, collect=collect),
               lambda: SSM.ssm_scan_plain(q, k, v, state0, gamma,
                                          collect=collect),
               None, nbytes=nbytes, flops=5 * s_ * t_ * h * d * d,
               device_key="ssm_scan_kernel",
               extra=dict(instruction_floor_ms=5 * s_ * t_ * h * d * d
                          / FP32_INSTR_PER_S * 1e3))
        del q, k, v, state0, got, again, want
    torch.cuda.empty_cache()

    # K3: every projection shape of the path at decode rows, the
    # speculative verify's 8 x 5 rows and prefill rows.  Tolerance: both
    # sides sum C products in fp32 in different orders, so each output
    # may differ by at most 2 * C * 2^-24 * sum|x||w|.
    for m in (1, 8, 40, 256):
        for f, c in ((6144, 2048), (2048, 2048), (8192, 2048),
                     (2048, 8192), (32768, 2048)):
            x, w, b = randn(m, c), 0.02 * randn(f, c), 0.02 * randn(f)
            got = L.mi_linear(x, w, b)
            if not torch.equal(got, L.mi_linear(x, w, b)):
                raise AssertionError("mi_linear M%d-F%d-C%d: a rerun gave "
                                     "other bits" % (m, f, c))
            want = L.mi_linear_plain(x, w, b)
            bound = (LINEAR_SLACK * c * 2.0 ** -24
                     * (x.abs() @ w.abs().t() + b.abs()))
            diff = (got - want).abs()
            record("mi_linear", "M%d-F%d-C%d" % (m, f, c),
                   diff.max().item(), bool((diff <= bound).all()),
                   LINEAR_NOTE + "; rerun bit-equal",
                   lambda: L.mi_linear(x, w, b),
                   lambda: L.mi_linear_plain(x, w, b),
                   lambda: torch.nn.functional.linear(x, w, b),
                   nbytes=4 * (m * c + f * c + f + m * f),
                   flops=2 * m * f * c, bandwidth=True)

    # K3q: the projections over one-byte weights, int8 and e4m3 codes with
    # a scale a feature: bit-equal to K3 on the dequantized weight, reruns
    # bit-equal; the yardstick F.linear over the dequantized weight (TF32
    # off).  Beside the bound, the latency floor of one output's chain of
    # C dependent FMAs (~4 cycles each at 1.98 GHz)
    for mode in ("int8", "fp8"):
        for m, (f, c) in itertools.product(
                (8, 40, 256), ((6144, 2048), (2048, 2048), (8192, 2048),
                               (2048, 8192), (32768, 2048))):
            x, b = randn(m, c), 0.02 * randn(f)
            qw, sw = Q.quantize_array(0.02 * randn(f, c), mode)
            rec = {"q": qw, "s": sw}
            w = Q.dequantize_array(qw, sw)
            got = L.mi_linear(x, rec, b)
            case = "%s-M%d-F%d-C%d" % (mode, m, f, c)
            if not torch.equal(got, L.mi_linear(x, rec, b)):
                raise AssertionError("mi_linear_q %s: a rerun gave other "
                                     "bits" % case)
            if not torch.equal(got, L.mi_linear(x, w, b)):
                raise AssertionError("mi_linear_q %s: not K3's bits on the "
                                     "dequantized weight" % case)
            want = L.mi_linear_plain(x, w, b)
            bound = (LINEAR_SLACK * c * 2.0 ** -24
                     * (x.abs() @ w.abs().t() + b.abs()))
            diff = (got - want).abs()
            record("mi_linear_q", case, diff.max().item(),
                   bool((diff <= bound).all()),
                   LINEAR_NOTE + "; bit-equal to K3 on the dequantized "
                   "weight; rerun bit-equal",
                   lambda: L.mi_linear(x, rec, b),
                   lambda: L.mi_linear_plain(
                       x, Q.dequantize_array(qw, sw), b),
                   lambda: torch.nn.functional.linear(x, w, b),
                   nbytes=4 * m * c + f * c + 8 * f + 4 * m * f,
                   flops=2 * m * f * c, bandwidth=True,
                   extra=dict(chain_floor_ms=c * CHAIN_CYCLES / SM_CLOCK_HZ
                              * 1e3))
            del x, b, qw, sw, rec, w, got, want, bound, diff
    torch.cuda.empty_cache()

    # K9: quantize-and-append of a decode step's 8 K and V rows and a
    # 256-row prefill's, into one layer's pools (pages of 16, H 16, D 128);
    # codes and scales byte-equal to the plain form, reruns too.  No
    # PyTorch call computes it, so no library time
    for mode in ("int8", "fp8"):
        for n in (8, 256):
            page, h, d, n_pages = 16, 16, 128, 144
            krows, vrows = randn(n, h, d), randn(n, h, d)
            krows[0] = 0.0
            slots = torch.from_numpy(np.random.RandomState(n).permutation(
                n_pages * page)[:n]).to(dev)
            pages, offs = slots // page, slots % page
            dtype = Q.storage_dtype(mode)

            def pools():
                return [torch.zeros(n_pages + 1, page, h, d, dtype=dtype,
                                    device=dev) for _ in range(2)] + \
                    [torch.ones(n_pages + 1, page, device=dev)
                     for _ in range(2)]

            got, again, want = pools(), pools(), pools()
            Q.kv_append_quantized(*got, pages, offs, krows, vrows)
            Q.kv_append_quantized(*again, pages, offs, krows, vrows)
            Q.kv_append_quantized_plain(*want, pages, offs, krows, vrows)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("kv_append_quantized %s N%d: a rerun "
                                     "gave other bytes" % (mode, n))
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            record("kv_append_quantized", "%s-%s-N%d" % (
                       mode, "decode" if n == 8 else "prefill", n), err, same,
                   "byte-equal codes and scales; rerun byte-equal",
                   lambda: Q.kv_append_quantized(*got, pages, offs, krows,
                                                 vrows),
                   lambda: Q.kv_append_quantized_plain(*want, pages, offs,
                                                       krows, vrows),
                   None, nbytes=2 * n * (4 * h * d + h * d + 4) + 16 * n,
                   flops=2 * 2 * n * h * d, device_key="kv_quant_kernel")
            del krows, vrows, got, again, want

    # K5/K6: BatchNorm's channel sums at ResNet-50's shapes at batch 256
    # (the stem's bn0, bn_data, a stage-1 and a stage-4 map), one
    # channels-last case and one fp32 case; each kernel must also give the
    # same bits when run again
    from mxnet_tpu_torch.ops import pallas_bn as BN

    def bn_library_backward(dy, x, mean, inv, axis):
        # the (dgamma, dbeta) half of PyTorch's BatchNorm backward, which
        # computes exactly (sum dy xhat, sum dy); channels-last goes in as
        # an NCHW view with channels-last strides
        if axis != 1:
            dy, x = dy.movedim(axis, 1), x.movedim(axis, 1)
        w = torch.ones(x.shape[1], dtype=torch.float32, device=x.device)
        return torch.ops.aten.native_batch_norm_backward(
            dy, x, w, None, None, mean, inv, True, 2e-5,
            [False, True, True])

    def bn_case(shape, axis, dtype):
        case = "%s-%s-axis%d" % (str(dtype).replace("torch.", ""),
                                 "x".join(map(str, shape)), axis)
        x = (1.5 * randn(*shape) + 0.3).to(dtype)
        dy = randn(*shape).to(dtype)
        dims = tuple(i for i in range(x.dim()) if i != axis)
        bshape = [1] * x.dim()
        bshape[axis] = c = shape[axis]
        n = x.numel() // c
        xf = x.float()
        mags = (xf.abs().sum(dims), (xf * xf).sum(dims))
        got, want = BN.bn_stats(x, axis), BN.bn_stats_plain(x, axis)
        if not all(torch.equal(a, b) for a, b in zip(got, BN.bn_stats(x,
                                                                      axis))):
            raise AssertionError("bn_stats %s: a rerun gave other bits"
                                 % case)
        diff = [(g - w).abs() for g, w in zip(got, want)]
        record("bn_stats", case, max(d.max().item() for d in diff),
               all(bool((d <= BN_RTOL * m).all())
                   for d, m in zip(diff, mags)), BN_NOTE,
               lambda: BN.bn_stats(x, axis),
               lambda: BN.bn_stats_plain(x, axis),
               lambda: torch.var_mean(x, dim=dims, correction=0),
               nbytes=x.numel() * x.element_size() + 8 * c,
               flops=3 * x.numel())
        mean = want[0] / n
        inv = torch.rsqrt((want[1] / n - mean * mean).clamp_min(0) + 2e-5)
        xhat = (xf - mean.view(bshape)) * inv.view(bshape)
        del xf
        dyf = dy.float()
        mags = (dyf.abs().sum(dims), (dyf * xhat).abs().sum(dims))
        del dyf, xhat
        got = BN.bn_grad_sums(dy, x, mean, inv, axis)
        want = BN.bn_grad_sums_plain(dy, x, mean, inv, axis)
        if not all(torch.equal(a, b) for a, b in zip(
                got, BN.bn_grad_sums(dy, x, mean, inv, axis))):
            raise AssertionError("bn_grad_sums %s: a rerun gave other bits"
                                 % case)
        diff = [(g - w).abs() for g, w in zip(got, want)]
        record("bn_grad_sums", case, max(d.max().item() for d in diff),
               all(bool((d <= BN_RTOL * m).all())
                   for d, m in zip(diff, mags)), BN_NOTE,
               lambda: BN.bn_grad_sums(dy, x, mean, inv, axis),
               lambda: BN.bn_grad_sums_plain(dy, x, mean, inv, axis),
               lambda: bn_library_backward(dy, x, mean, inv, axis),
               nbytes=2 * x.numel() * x.element_size() + 16 * c,
               flops=6 * x.numel())
        del x, dy, got, want, diff, mags
        torch.cuda.empty_cache()

    for shape, axis, dtype in (((256, 64, 112, 112), 1, torch.bfloat16),
                               ((256, 3, 224, 224), 1, torch.bfloat16),
                               ((256, 256, 56, 56), 1, torch.bfloat16),
                               ((256, 2048, 7, 7), 1, torch.bfloat16),
                               ((256, 56, 56, 256), 3, torch.bfloat16),
                               ((256, 512, 28, 28), 1, torch.float32)):
        bn_case(shape, axis, dtype)

    # rtc: CUDA bodies compiled at run time (testing/rtc_ops.py).  The first
    # CudaKernel build, then the same text again from the disk cache
    from mxnet_tpu_torch.testing import rtc_ops as R

    t0 = time.perf_counter()
    R._kernel("rtc_axpy", (16, 128))._launcher(
        [torch.empty(16, 128, device=dev)] * 2)
    rtc_build_s = time.perf_counter() - t0
    saved_entries, _cuda._rtc_entries = _cuda._rtc_entries, {}
    t0 = time.perf_counter()
    R.CudaKernel(R.AXPY_BODY, [((16, 128), "float32")], ["x", "y", "o"],
                 name="rtc_axpy")._launcher(
        [torch.empty(16, 128, device=dev)] * 2)
    rtc_cached_s = time.perf_counter() - t0
    _cuda._rtc_entries.update(saved_entries)
    log("rtc_build", first_build_s=rtc_build_s, cached_rebuild_s=rtc_cached_s)
    for shape in ((16, 128), (8192, 8192)):
        x, y = randn(*shape), randn(*shape)
        n = x.numel()
        got, want = R.axpy(x, y), R.axpy_plain(x, y)
        err = (got - want).abs().max().item()
        record("rtc_axpy", "fp32-%dx%d" % shape, err, torch.equal(got, want),
               RTC_EXACT_NOTE, lambda: R.axpy(x, y),
               lambda: R.axpy_plain(x, y),
               lambda: torch.add(y, x, alpha=2.0), nbytes=12 * n,
               flops=2 * n, device_key="rtc_axpy")
        del x, y, got, want
    for scale in (1.0, 1e4):
        case = "fp32-256x1000" + ("" if scale == 1.0 else "-x1e4")
        x = scale * randn(256, 1000)
        label = torch.randint(0, 1000, (256,), device=dev,
                              generator=gen).float()
        p, p_want = R.softmax_forward(x), R.softmax_forward_plain(x)
        err = (p - p_want).abs().max().item()
        record("rtc_softmax_forward", case, err, err <= RTC_SOFTMAX_ATOL,
               RTC_SOFTMAX_NOTE, lambda: R.softmax_forward(x),
               lambda: R.softmax_forward_plain(x),
               lambda: torch.softmax(x, 1), nbytes=8 * x.numel(),
               flops=5 * x.numel(), device_key="rtc_softmax_forward")
        got = R.softmax_backward(p, label)
        want = R.softmax_backward_plain(p, label)
        xs = x.detach().requires_grad_()
        ce = torch.nn.functional.cross_entropy(xs, label.long())
        record("rtc_softmax_backward", case, (got - want).abs().max().item(),
               torch.equal(got, want), RTC_EXACT_NOTE,
               lambda: R.softmax_backward(p, label),
               lambda: R.softmax_backward_plain(p, label),
               lambda: torch.autograd.grad(ce, xs, retain_graph=True),
               nbytes=8 * x.numel() + 4 * label.numel(),
               flops=2 * x.numel(), device_key="rtc_softmax_backward")
        del x, xs, ce, p, p_want, got, want

    # K12: the scaled cast at the LM's operands (an activation, the head's
    # weight, a cotangent's amax pass and its e5m2 cast), bit-equal to the
    # plain version; K11: the three products of each projection shape,
    # within FP8_GEMM_NOTE of the plain version, rerun bit-equal, with
    # torch._scaled_mm on the same codes as the yardstick
    from mxnet_tpu_torch.ops import fp8_ops as F8
    from mxnet_tpu_torch.testing import fp8_accum

    for case, rows_, cols, kind, what in FP8_CAST_CASES:
        x = (randn(rows_, cols) * 0.05).bfloat16()
        s8 = torch.full((), 1e-3, device=dev)
        kw = FP8_CAST_OUTPUTS[what]
        got = F8.fp8_cast(x, s8, kind, **kw)
        want = F8.fp8_cast_plain(x, s8, kind, **kw)
        same = all((g is None and w is None) or torch.equal(g, w)
                   for g, w in zip(got, want))
        n = rows_ * cols
        out_bytes = (2 * n if kw["codes"] else 0)
        record("fp8_cast", case, 0.0 if same else float("inf"), same,
               FP8_CAST_NOTE, lambda: F8.fp8_cast(x, s8, kind, **kw),
               lambda: F8.fp8_cast_plain(x, s8, kind, **kw), None,
               nbytes=2 * n + out_bytes, flops=2 * n)
        del x, got, want
    for case, a, b, ka, kb, sa, sb in itertools.chain(
            fp8_gemm_cases(dev, gen), fp8_gemm_edge_cases(dev, gen)):
        M, N, Kd = a.shape[0], b.shape[0], a.shape[1]
        got = F8.fp8_gemm(a, b, ka, kb, sa, sb, torch.bfloat16)
        want = F8.fp8_gemm_plain(a, b, ka, kb, sa, sb, torch.float32)
        top = want.abs().max().item()
        diff = (got.float() - want).abs()
        err = diff.max().item()
        mag = F8.fp8_gemm_magnitude(a, b, ka, kb, sa, sb)
        within = bool((diff <= F8.fp8_gemm_error_bound(mag, Kd, want))
                      .all())
        del diff, mag
        bad, sampled = fp8_accum.sample_mismatches(a, b, ka, kb, sa, sb, got)
        again = F8.fp8_gemm(a, b, ka, kb, sa, sb, torch.bfloat16)
        record("fp8_gemm", case, err,
               within and bad == 0 and torch.equal(again, got),
               FP8_GEMM_NOTE,
               lambda: F8.fp8_gemm(a, b, ka, kb, sa, sb, torch.bfloat16),
               lambda: F8.fp8_gemm_plain(a, b, ka, kb, sa, sb,
                                         torch.bfloat16),
               scaled_mm_call(a, b, ka, kb, sa, sb),
               nbytes=M * Kd + N * Kd + 2 * M * N, flops=2 * M * N * Kd,
               peak=FP8_FLOP_PER_S,
               extra=dict(max_abs_out=top, rel_err=err / top,
                          emulation_sample=sampled,
                          emulation_mismatches=bad))
        del got, want, again
    torch.cuda.empty_cache()

    # -- 3. row-count invariance ------------------------------------------
    # rows at M = 1 (decode's streaming kernel), at M = 40 (the
    # speculative verify's 8 slots x 5 rows) and at M = 64 (the smallest
    # prefill bucket; both the ring kernel's shorter tiles) equal the same
    # rows at M = 256, for every projection shape of a verify step, over
    # fp32 weights (K3) and int8 and e4m3 codes (K3q)
    rows40 = rows64 = rows1 = 0
    for f, c in ((6144, 2048), (2048, 2048), (8192, 2048), (2048, 8192),
                 (32768, 2048)):
        xc = randn(256, c)
        w, b = 0.02 * randn(f, c), 0.02 * randn(f)
        weights = [("fp32", w)] + [
            (mode, dict(zip(("q", "s"), Q.quantize_array(w, mode))))
            for mode in ("int8", "fp8")]
        for kind, wt in weights:
            full = L.mi_linear(xc, wt, b)
            for r in range(0, 256, 5):
                if not torch.equal(L.mi_linear(xc[r:r + 1], wt, b),
                                   full[r:r + 1]):
                    raise AssertionError(
                        "mi_linear %s row %d differs at M=1 vs M=256 (F=%d, "
                        "C=%d)" % (kind, r, f, c))
                rows1 += 1
            for m, starts in ((40, (0, 40, 107, 216)), (64, (0, 77, 192))):
                for r in starts:
                    if not torch.equal(L.mi_linear(xc[r:r + m], wt, b),
                                       full[r:r + m]):
                        raise AssertionError(
                            "mi_linear %s rows %d..%d differ at M=%d vs "
                            "M=256 (F=%d, C=%d)" % (kind, r, r + m - 1, m, f,
                                                    c))
                    if m == 40:
                        rows40 += m
                    else:
                        rows64 += m
        del weights, full
    x = randn(256, 2048)
    gamma, beta = 1 + 0.1 * randn(2048), 0.1 * randn(2048)
    from mxnet_tpu_torch.serve.model import _layer_norm

    full = _layer_norm(x, gamma, beta)
    for r in range(256):
        if not torch.equal(_layer_norm(x[r:r + 1], gamma, beta),
                           full[r:r + 1]):
            raise AssertionError("LayerNorm row %d differs at M=1 vs M=256"
                                 % r)
    log("invariance", mi_linear_rows_checked=rows1,
        mi_linear_m40_rows_checked=rows40, mi_linear_m64_rows_checked=rows64,
        weights=["fp32", "int8", "fp8"], layer_norm_rows_checked=256,
        bit_identical=True)

    # -- 4. serve at full width -------------------------------------------
    from mxnet_tpu_torch import serve

    cfg = serve.ModelConfig(vocab_size=32768, num_layers=8, d_model=2048,
                            num_heads=16, max_len=1024)
    sconf = serve.ServeConfig(slots=8, page_size=16, buckets=(64, 128, 256),
                              max_new=32, exact=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    sess, stats, streams = serve_phase(dev, cfg, sconf, n_requests=16,
                                       prompt_lens=(24, 250))
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    serve_kernels = ("flash_attention", "paged_attention", "mi_linear")
    if min(launches[k] for k in serve_kernels) < 1:
        raise AssertionError("a kernel never ran on the serving path: %r"
                             % launches)
    log("serve", model="8L-d2048-h16-V32768",
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2.0 ** 30,
        launches=launches, **stats)
    log("profile", nvidia_smi=smi, **profile_phase(sess))

    # -- 4b. speculative decoding: the same traffic, three drafts ----------
    for draft in ("layers:8", "layers:2", "ngram"):
        torch.cuda.empty_cache()
        _cuda.reset_launches()
        spec = spec_phase(
            dev, cfg, sess.params,
            dataclasses.replace(sconf, spec_k=4, draft=draft),
            seeded_requests(cfg, 16, (24, 250), sconf.max_new, 0.05),
            streams)
        spec_launches = dict(_cuda.launches)
        if min(spec_launches[k] for k in ("paged_attention",
                                          "mi_linear")) < 1:
            raise AssertionError("a kernel never ran on the speculative "
                                 "path: %r" % spec_launches)
        for name, n in spec_launches.items():
            launches[name] += n
        log("spec", nvidia_smi=smi, launches=spec_launches, **spec)

    # -- 4c. quantized serving: the same model and traffic -----------------
    from mxnet_tpu_torch.serve.kv_cache import PagedKVCache

    quant_kernels = ("mi_linear_q", "paged_attention_q",
                     "kv_append_quantized")
    head_dim = cfg.d_model // cfg.num_heads
    fp32_page = PagedKVCache.page_bytes(cfg.num_layers, cfg.num_heads,
                                        head_dim, sconf.page_size)
    probe = np.random.RandomState(2).randint(
        1, cfg.vocab_size, size=250).tolist()
    int8_streams = None
    for quant, kv_quant in (("int8", "int8"), ("fp8", "e4m3")):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        qconf = dataclasses.replace(sconf, quant=quant, kv_quant=kv_quant)
        qsess, qstats, qstreams = serve_phase(dev, cfg, qconf, n_requests=16,
                                              prompt_lens=(24, 250),
                                              params=sess.params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
        q_launches = dict(_cuda.launches)
        run = qstats["run_launches"]
        if min(run[k] for k in quant_kernels) < 1 or \
                run["mi_linear"] or run["paged_attention"]:
            raise AssertionError("the quantized session's run did not go "
                                 "through K3q, K2q and K9 alone: %r" % run)
        drift = logit_drift(sess, qsess, probe)
        if drift > DRIFT_BOUND[qconf.quant]:
            raise AssertionError("%s/%s: teacher-forced logit drift %.4g "
                                 "over %g" % (quant, kv_quant, drift,
                                              DRIFT_BOUND[qconf.quant]))
        params_shrink = sess.params_bytes_at_rest() / \
            qsess.params_bytes_at_rest()
        q_page = PagedKVCache.page_bytes(cfg.num_layers, cfg.num_heads,
                                         head_dim, sconf.page_size,
                                         kv_quant=kv_quant)
        if min(params_shrink, fp32_page / q_page) < BYTES_SHRINK:
            raise AssertionError("%s/%s: bytes shrink %.3f (params), %.3f "
                                 "(KV page), under %g" % (
                                     quant, kv_quant, params_shrink,
                                     fp32_page / q_page, BYTES_SHRINK))
        for name, n in q_launches.items():
            launches[name] += n
        log("quant", model="8L-d2048-h16-V32768", quant=qconf.quant,
            kv_quant=qconf.kv_quant, nvidia_smi=smi, peak_mem_gib=peak,
            launches=q_launches, logit_drift=drift,
            logit_drift_bound=DRIFT_BOUND[qconf.quant],
            params_bytes_fp32=sess.params_bytes_at_rest(),
            params_bytes_quant=qsess.params_bytes_at_rest(),
            params_shrink=params_shrink, page_bytes_fp32=fp32_page,
            page_bytes_quant=q_page, page_shrink=fp32_page / q_page,
            **qstats)
        log("quant_profile", quant=qconf.quant, kv_quant=qconf.kv_quant,
            nvidia_smi=smi, **profile_phase(qsess))
        if quant == "int8":
            int8_streams = qstreams
        del qsess

    # the int8 session again, speculative: its streams must not move
    torch.cuda.empty_cache()
    _cuda.reset_launches()
    spec = spec_phase(
        dev, cfg, sess.params,
        dataclasses.replace(sconf, quant="int8", kv_quant="int8", spec_k=4,
                            draft="layers:2"),
        seeded_requests(cfg, 16, (24, 250), sconf.max_new, 0.05),
        int8_streams)
    spec_launches = dict(_cuda.launches)
    if min(spec_launches[k] for k in quant_kernels) < 1:
        raise AssertionError("a quantized kernel never ran on the "
                             "speculative path: %r" % spec_launches)
    for name, n in spec_launches.items():
        launches[name] += n
    log("quant_spec", quant="int8", kv_quant="int8", nvidia_smi=smi,
        launches=spec_launches, **spec)
    serve_params, serve_stats = sess.params, stats
    del sess
    torch.cuda.empty_cache()

    # -- 4d. hybrid stacks: window rings and SSM states at full width ------
    t0 = time.perf_counter()
    hybrid_launches = hybrid_phases(dev, cfg, smi)
    for name, n in hybrid_launches.items():
        launches[name] += n
    phase_s["hybrid"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # -- 4e. the serving front: checkpoint, replicas, HTTP gateway ---------
    t0 = time.perf_counter()
    gw_stats, gw_launches = gateway_phase(dev, cfg, sconf, serve_params,
                                          streams, serve_stats)
    if min(gw_launches.get(k, 0) for k in ("paged_attention",
                                            "mi_linear")) < 1:
        raise AssertionError("a kernel never ran on the gateway path: %r"
                             % gw_launches)
    for name, n in gw_launches.items():
        launches[name] += n
    phase_s["gateway"] = time.perf_counter() - t0
    log("gateway", model="8L-d2048-h16-V32768", replicas=2,
        nvidia_smi=smi, launches=gw_launches, **gw_stats)
    del serve_params
    torch.cuda.empty_cache()

    # -- 5. train at full width -------------------------------------------
    stats, train_launches = train_phase(dev, train_config(), batch=8)
    log("train", nvidia_smi=smi, launches=train_launches, **stats)
    torch.cuda.empty_cache()
    for name, n in train_launches.items():
        launches[name] += n

    # -- 5b. optim: the same LM under Adam, clipping and a schedule -------
    t0 = time.perf_counter()
    stats, optim_launches = optim_phase(dev, train_config(), batch=8)
    log("optim", nvidia_smi=smi, launches=optim_launches, **stats)
    torch.cuda.empty_cache()
    for name, n in optim_launches.items():
        launches[name] += n
    log("optim_update", nvidia_smi=smi, note="each optimizer's fused_update "
        "over every parameter of the 8-layer LM (fp32), CUDA-event mean "
        "behind the device spin; bound: weight, gradient and states read "
        "once, weight and states written once, over 3.35 TB/s",
        **optim_update_rows(dev, train_config(), time_ms))
    torch.cuda.empty_cache()
    phase_s["optim"] = time.perf_counter() - t0

    # -- 5c. robust training: fp8, the loss scaler, step health, remat,
    # and fit's checkpoint, preemption and resume --------------------------
    t0 = time.perf_counter()
    stats, robust_launches = robust_train_phase(dev, train_config(), batch=8)
    log("robust_train", nvidia_smi=smi, launches=robust_launches, **stats)
    for name, n in robust_launches.items():
        launches[name] += n
    torch.cuda.empty_cache()
    stats, fit_launches = robust_fit_phase(dev)
    log("robust_fit", nvidia_smi=smi, **stats)
    for name, n in fit_launches.items():
        launches[name] += n
    torch.cuda.empty_cache()
    phase_s["robust"] = time.perf_counter() - t0

    # -- 6. train parity: kernel path vs MXNET_ATTN_IMPL=reference ---------
    _cuda.reset_launches()
    fp32 = parity_phase(dev, train_config(num_layers=2), 2, None)
    for name, n in _cuda.launches.items():
        launches[name] = launches.get(name, 0) + n
    if fp32["kernel_vs_reference"]["max"] > PARITY_FP32:
        raise AssertionError("fp32 parity %r over %g" % (fp32, PARITY_FP32))
    log("train_parity", case="fp32-2L-batch2", bound=PARITY_FP32,
        tolerance=PARITY_FP32_NOTE, **fp32)
    t0 = time.perf_counter()
    _cuda.reset_launches()
    adam = parity_phase(dev, train_config(num_layers=2), 2, None,
                        timed=False, optimizer="adam",
                        optimizer_params=ADAM_PARITY)
    for name, n in _cuda.launches.items():
        launches[name] = launches.get(name, 0) + n
    if adam["kernel_vs_reference"]["max"] > PARITY_FP32:
        raise AssertionError("fp32 Adam parity %r over %g"
                             % (adam, PARITY_FP32))
    log("train_parity", case="fp32-2L-batch2-adam-clip", bound=PARITY_FP32,
        optimizer_params=ADAM_PARITY, tolerance=PARITY_FP32_NOTE, **adam)
    phase_s["adam_parity"] = time.perf_counter() - t0
    _cuda.reset_launches()
    bf16 = parity_phase(dev, train_config(), 8, "bfloat16")
    for name, n in _cuda.launches.items():
        launches[name] = launches.get(name, 0) + n
    if (bf16["kernel_vs_fp32"]["mean"] > bf16["reference_vs_fp32"]["mean"]
            or bf16["kernel_over_reference_error"]["max"]
            > PARITY_BF16_RATIO):
        raise AssertionError("bf16 parity %r outside (%s)"
                             % (bf16, PARITY_BF16_NOTE))
    log("train_parity", case="bf16-8L-batch8", tolerance=PARITY_BF16_NOTE,
        **bf16)

    # -- 7. ResNet-50 through Module.fit ------------------------------------
    from mxnet_tpu_torch.models import resnet

    r50 = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=(3, 224, 224))
    stats, resnet_launches = resnet_phase(dev, r50)
    log("resnet", nvidia_smi=smi, model="resnet50", launches=resnet_launches,
        **stats)
    torch.cuda.empty_cache()
    for name, n in resnet_launches.items():
        launches[name] += n

    # -- 7b. ResNet-50 Module.fit under NAG and a step schedule ------------
    t0 = time.perf_counter()
    stats, nag_launches = nag_fit_phase(dev, r50)
    log("nag", nvidia_smi=smi, model="resnet50", launches=nag_launches,
        **stats)
    torch.cuda.empty_cache()
    for name, n in nag_launches.items():
        launches[name] += n
    phase_s["nag"] = time.perf_counter() - t0

    # -- 8. ResNet-50 parity: K5/K6 vs the plain sums, against fp32 --------
    par, per_tensor = resnet_parity_phase(dev, r50)
    log("resnet_parity_tensors", **per_tensor)
    if any(par[k][q] > PARITY_BN_MEAN * par["plain_vs_fp32"][q]
           for k in ("kernel_vs_fp32",) for q in ("mean", "median")) or (
               par["tracking_kernel_over_plain"] is not None and
               par["tracking_kernel_over_plain"]["max"] > PARITY_BN_RATIO):
        raise AssertionError("resnet parity %r outside (%s)"
                             % (par, PARITY_BN_NOTE))
    log("resnet_parity", case="resnet50-224-batch16",
        tolerance=PARITY_BN_NOTE, **par)
    torch.cuda.empty_cache()

    # -- 9. Gluon ResNet-50, imperative ------------------------------------
    from mxnet_tpu_torch.context import context_of

    net = gluon_net(context_of(dev))
    stats, gluon_launches = gluon_phase(dev, net)
    log("gluon", nvidia_smi=smi, launches=gluon_launches, **stats)
    torch.cuda.empty_cache()
    for name, n in gluon_launches.items():
        launches[name] = launches.get(name, 0) + n

    # -- 10. the rtc facility and the rtc-backed CustomOp head --------------
    stats, custom_launches = custom_op_phase(dev, net)
    log("custom_op", nvidia_smi=smi, launches=custom_launches, **stats)
    del net
    torch.cuda.empty_cache()
    for name, n in custom_launches.items():
        launches[name] = launches.get(name, 0) + n

    # -- 11. every op of the sweep table, card against CPU ----------------
    t0 = time.perf_counter()
    stats, failures, syncs = ops_phase(dev)
    phase_s["ops"] = time.perf_counter() - t0
    log("ops", tolerance=OPS_NOTE, failures=failures,
        host_syncs=dict(count=len(syncs), ops=syncs), **stats)
    if failures:
        raise AssertionError("ops on the card: %d failures %r"
                             % (len(failures), sorted(failures)))

    # -- 12. multistep: bench_fit.py's recipe, K = 16 against K = 1 --------
    t0 = time.perf_counter()
    log("multistep", nvidia_smi=smi, **multistep_phase(dev))
    torch.cuda.empty_cache()
    phase_s["multistep"] = time.perf_counter() - t0

    # -- 13. zoo: the seven other symbols at full width, K = 4 --------------
    t0 = time.perf_counter()
    zoo_launches = dict.fromkeys(("bn_stats", "bn_grad_sums"), 0)
    for name, kwargs, image, classes in ZOO:
        stats, zl = zoo_phase(dev, name, kwargs, image, classes)
        log("zoo", nvidia_smi=smi, launches={k: v for k, v in zl.items()
                                             if v}, **stats)
        torch.cuda.empty_cache()
        for k, v in zl.items():
            launches[k] = launches.get(k, 0) + v
            if k in zoo_launches:
                zoo_launches[k] += v
    log("zoo_launches", **zoo_launches)
    phase_s["zoo"] = time.perf_counter() - t0

    # -- 14. summary ------------------------------------------------------
    if min(launches.values()) < 1:
        raise AssertionError("a kernel never ran on a main path: %r"
                             % launches)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
    if bad:
        raise AssertionError("JAX or the JAX package was imported: %r"
                             % bad[:5])
    main_case = {"flash_attention": "n1-h16-T1024-D128-causal-b16",
                 "flash_attention_backward": "n1-h16-T1024-D128-causal-fp32",
                 "flash_attention_sm90": "n8-h16-T1024-D128-causal-lse",
                 "flash_attention_backward_sm90": "n8-h16-T1024-D128-causal",
                 "paged_attention": "decode-S8-Q1",
                 "mi_linear": "M8-F6144-C2048",
                 "bn_stats": "bfloat16-256x64x112x112-axis1",
                 "bn_grad_sums": "bfloat16-256x64x112x112-axis1",
                 "rtc_axpy": "fp32-8192x8192",
                 "rtc_softmax_forward": "fp32-256x1000",
                 "rtc_softmax_backward": "fp32-256x1000",
                 "mi_linear_q": "int8-M8-F6144-C2048",
                 "paged_attention_q": "int8-decode-S8-Q1",
                 "kv_append_quantized": "int8-decode-N8",
                 "flash_attention_window": "n1-h16-T1024-D128-causal-b16-"
                                           "w128",
                 "paged_attention_ring": "decode-S8-Q1-ring",
                 "paged_attention_q_ring": "int8-decode-S8-Q1-ring",
                 "ssm_scan": "decode-S8-T1-H16-D128",
                 "fp8_gemm": "fwd-M8192-C2048-F6144",
                 "fp8_cast": "x-8192x2048-bf16-e4m3"}
    replaces = {
        "flash_attention": "mxnet_tpu/ops/attention.py:497",
        "flash_attention_backward": "mxnet_tpu/ops/attention.py:497",
        "flash_attention_sm90": "mxnet_tpu/ops/attention.py:497",
        "flash_attention_backward_sm90": "mxnet_tpu/ops/attention.py:497",
        "paged_attention": "mxnet_tpu/ops/attention.py:368",
        "mi_linear": "mxnet_tpu/serve/model.py:123",
        "bn_stats": "mxnet_tpu/ops/pallas_bn.py:79",
        "bn_grad_sums": "mxnet_tpu/ops/pallas_bn.py:119",
        "mi_linear_q": "mxnet_tpu/serve/model.py:123 + "
                       "mxnet_tpu/quantize.py:146",
        "paged_attention_q": "mxnet_tpu/ops/attention.py:368",
        "kv_append_quantized": "mxnet_tpu/quantize.py:337",
        # the windowed forward is the lax _flash_forward (the Pallas kernel
        # takes no window); rings: decode_attention's window half with
        # serve/model.py's _ring_gather
        "flash_attention_window": "mxnet_tpu/ops/attention.py:211",
        "paged_attention_ring": "mxnet_tpu/ops/attention.py:368 + "
                                "mxnet_tpu/serve/model.py:378",
        "paged_attention_q_ring": "mxnet_tpu/ops/attention.py:368 + "
                                  "mxnet_tpu/serve/model.py:378",
        "ssm_scan": "mxnet_tpu/ops/ssm_ops.py:62",
        # fp8 training's lax code: the custom VJP's contractions (K11) and
        # its fake casts with the amaxes fp8_apply_dot records (K12)
        "fp8_gemm": "mxnet_tpu/quantize.py:512",
        "fp8_cast": "mxnet_tpu/quantize.py:512 + "
                    "mxnet_tpu/quantize.py:565",
    }
    sources = {name: ("cuda", "mxnet_tpu_torch/csrc/%s.cu" % stem)
               for name, (stem, _, _) in _cuda.KERNELS.items()}
    for name in RTC_KERNELS:
        sources[name] = ("cuda-rtc", "mxnet_tpu_torch/testing/rtc_ops.py")
        replaces[name] = "mxnet_tpu/rtc.py:54"
    kernels = []
    for name, (route, source) in sources.items():
        row = rows[(name, main_case[name])]
        count = launches[name] if route == "cuda" else \
            launches["rtc:" + name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces[name], "launches": count,
            "max_abs_err": errs[name], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "kernel_device_ms": row.get("kernel_device_ms"),
            "library_device_ms": row.get("library_device_ms"),
            "shape": main_case[name]})
    log("wall", total_s=time.perf_counter() - t_start,
        added_phases_s=phase_s)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
