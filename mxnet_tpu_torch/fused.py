"""The train step: forward, backward and optimizer update in one call.

Counterpart of ``mxnet_tpu/fused.py``.  This slice ports the single-device
:class:`TrainStep` (:143) with the same constructor and the same
``__call__(params, aux, states, batch, rng, lr=None, t=None) -> (params,
aux, states, outs)``:

* the loss is the JAX package's: with ``compute_dtype`` every floating
  argument — parameters, aux states *and the batch* — is cast to that
  dtype (``cast_compute``, :341-343 and :357-359), then the outputs are
  summed (``_loss_from_outputs``, :70-78), whose loss heads carry their
  own backward;
* the backward is torch autograd over the eagerly run graph; gradients
  of fp32 parameters come back fp32 through the cast;
* with the optimizer's ``clip_global_norm``, every live gradient is
  scaled by ``min(1, clip / ||g||)``, the norm taken over all of them in
  fp32 after ``rescale_grad`` and the factor cast to each gradient's
  dtype (:467-474);
* the update runs in ``sorted(grads)`` order through the optimizer's
  fused form (:475-501) — any registered optimizer, each with its own
  state — returning new tensors, so the caller's old state stays valid.

``steps_per_call=K`` (K >= 2) is the JAX package's multi-step dispatch
(:562-606): ``__call__`` takes a ``(K, batch, ...)`` super-batch and runs
K updates, ``lr`` held for the K inner steps, ``t`` advancing once an
inner step, each inner step on its own random stream, the outputs
stacked ``(K, batch, ...)``.  Where the JAX package scans the K steps in
one XLA program with donated buffers, the port captures them once per
input signature as one CUDA graph whose parameter, aux and optimizer
state buffers are the caller's tensors, updated in place (the
donation); ``lr`` and the first step number are device scalars written
before each replay, so a call is one replay (:class:`_Graph`).  On the
CPU the same K steps run one after another through the same code
(:meth:`TrainStep.run_eager`, the captured call's plain version).  With
K = 1 the step runs eagerly and returns new tensors, as before.

Robust training (:347-548 and :1125-1229 of the JAX package's file):

* ``health=StepHealth(...)`` computes the global gradient norm and a
  non-finite flag on the device (``last_health``) and skips a
  non-finite step there: a device-side select keeps the old params, aux
  and optimizer states bit for bit (the JAX package's ``lax.cond``; a
  CUDA graph has no branch, and reading the flag on the host would break
  a capture).  With a :class:`~mxnet_tpu_torch.health.DynamicLossScaler`
  the loss is scaled before the backward, the gradients unscaled after,
  and the scale and its clean streak (``loss_scale``, ``good_steps``)
  are device scalars carried from step to step.
* ``MXNET_FP8=on|auto`` routes every FullyConnected, MultiHeadAttention
  projection and 2-D ``dot`` through the fp8 kernels K11/K12
  (``quantize.fp8_apply_dot``) at delayed scales realized from a carried
  (sites, 2, 16) amax history ``fp8_hist``, which rolls every step,
  skipped ones too, with non-finite amaxes taken as 0.  ``auto`` arms on
  CUDA tensors only.  The site count comes from one forward probe
  (:meth:`_fp8_site_count`), run in the order the step claims sites.
* The carried state (``export_hstate``/``load_hstate``) rides a
  captured K-step graph as static buffers, updated in place;
  ``load_hstate`` copies into them.
* ``remat=True``/``"full"`` recomputes the forward in the backward
  (``torch.utils.checkpoint``); the ``dots_*`` policy names of
  ``jax.checkpoint_policies`` save the matmul outputs (selective
  checkpointing) and recompute the rest.  The recomputed forward draws
  the same dropout masks from a copy of the step's generator taken before
  the forward, and re-enters the fp8 trace at the same scales.

``mesh``, ``zero``, ``plan`` and ``param_sharding`` belong to the
multi-device slice and raise.

Note on ``compute_dtype="bfloat16"``: the cast reaches the token ids too,
as in the JAX package, so ids above 256 round to bf16 and an id that
rounds to V or beyond looks up a NaN row (``ops/matrix_ops.py``).  The
port reproduces this on purpose; the JAX package is the reference.
"""
from __future__ import annotations

import functools
import hashlib
import json
import time

import numpy as np
import torch

from . import _cuda
from . import optimizer as opt_mod
from . import quantize as Q
from .base import MXNetError, get_env, later_slice, resolve_device
from .compile_cache import registry, signature_of
from .health import StepHealth

__all__ = ["TrainStep", "compile_train_step", "state_from_numpy"]


def _loss_from_outputs(outs):
    """Seed the backward like ``Executor.backward`` with ones head grads:
    the sum of the outputs (loss heads carry a backward that ignores the
    cotangent's value)."""
    total = None
    for o in outs:
        s = o.float().sum()
        total = s if total is None else total + s
    return total


def _graph_digest(symbol):
    """8 hex digits over the graph's ops, attributes, arguments and
    auxiliary states, but not its auto-generated node names: a model
    built again in the same process gets the same digest."""
    nodes = json.loads(symbol.tojson())["nodes"]
    text = json.dumps([[(n["op"], n.get("attrs")) for n in nodes],
                       symbol.list_arguments(),
                       symbol.list_auxiliary_states()], sort_keys=True)
    return hashlib.sha1(text.encode()).hexdigest()[:8]


def _check_slice(mesh, zero, plan, param_sharding):
    """Raise ``later_slice`` for every option that needs several devices,
    including the env spellings the JAX package reads."""
    zero = zero if zero is not None else get_env("MXNET_ZERO", "auto", str)
    plan = plan if plan is not None else \
        (get_env("MXNET_PLAN", "", str).strip() or None)
    for field, value, fine in (
            ("mesh", mesh, mesh is None),
            ("zero", zero, str(zero).strip().lower() in
             ("auto", "off", "0", "false", "no", "")),
            ("plan", plan, plan is None),
            ("param_sharding", param_sharding,
             param_sharding in (None, "replicated"))):
        if not fine:
            raise later_slice(field, value)


# the matmuls jax.checkpoint_policies' dots_* policies save, as the aten
# ops a torch forward runs them through
_DOTS = ("mm", "addmm", "bmm", "baddbmm")
_DOTS_NO_BATCH = ("mm", "addmm")
_REMAT_POLICIES = {
    "nothing_saveable": "full",
    "everything_saveable": None,
    "dots_saveable": _DOTS, "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
}


def _resolve_remat(remat):
    """``remat`` -> None (no recompute), ``"full"``, or a tuple of the aten
    op names whose outputs are saved (selective checkpointing).  Any other
    name raises, as ``jax.checkpoint_policies`` lookups do in the JAX
    package; the named-value policies (``save_only_these_names`` and the
    like) take arguments the port's ops do not carry."""
    if remat is None or remat is False:
        return None
    if remat is True or remat == "full":
        return "full"
    if isinstance(remat, str) and remat in _REMAT_POLICIES:
        return _REMAT_POLICIES[remat]
    raise MXNetError("unknown remat policy %r (the port takes True, "
                     "'full' or one of %s)"
                     % (remat, ", ".join(sorted(_REMAT_POLICIES))))


def _sac_context(saved):
    """Selective checkpointing that saves the outputs of the aten ops
    named in ``saved`` and recomputes everything else."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    ops = {getattr(torch.ops.aten, name).default for name in saved}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _select_tree(bad, old, new, written):
    """``old`` where the 0-d flag ``bad`` holds, else ``new``, over a
    tensor, a tuple of them or None: the old bits are kept exactly.  The
    result is written over ``new`` (the update's fresh tensors), so the
    select holds no third copy of the parameters and states, unless an
    earlier select already wrote that storage (``written``, data
    pointers: an optimizer may return one tensor as weight and state)."""
    if old is None:
        return None
    if isinstance(old, tuple):
        return tuple(_select_tree(bad, o, n, written)
                     for o, n in zip(old, new))
    if new is old:
        return old
    if new.data_ptr() in written:
        return torch.where(bad, old, new)
    written.add(new.data_ptr())
    return torch.where(bad, old, new, out=new)


class TrainStep:
    """(params, aux, opt_states, batch) -> updated state, one call per
    ``steps_per_call`` steps.  ``device`` is where :meth:`init_state` places the state (None:
    the card); ``__call__`` runs where the tensors it is given live."""

    def __init__(self, symbol, optimizer="sgd", optimizer_params=None,
                 mesh=None, data_names=("data",),
                 label_names=("softmax_label",), dtype="float32",
                 batch_sharding_axis="data", compute_dtype=None,
                 remat=None, fixed_param_names=(), param_sharding=None,
                 steps_per_call=1, health=None, zero=None, plan=None,
                 device=None):
        from .executor import _trace_fn

        _check_slice(mesh, zero, plan, param_sharding)
        if health is not None and not isinstance(health, StepHealth):
            raise MXNetError("health must be a StepHealth (got %r)"
                             % (health,))
        self._health = health
        self._scaler = health.scaler if health is not None else None
        # the scaler's overflow must never reach the weights, whatever
        # skip_nonfinite says
        self._skip_on_bad = health is not None and (
            health.skip_nonfinite or self._scaler is not None)
        self._remat = _resolve_remat(remat)
        self._segments = None  # remat's checkpointed segments, at first use
        self._fp8_mode = Q.fp8_mode()
        self._fp8 = self._fp8_for(device)
        self._fp8_sites = None
        self._hstate = None
        self.last_health = None
        K = int(steps_per_call)
        if K < 1:
            raise MXNetError("steps_per_call must be >= 1, got %d" % K)
        self._steps_per_call = K
        self.symbol = symbol
        self._device = device
        self._fwd_fn, self._arg_names, self._aux_names = _trace_fn(
            symbol, is_train=True)
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.param_names = [n for n in self._arg_names
                            if n not in self.data_names
                            and n not in self.label_names]
        opt_params = dict(optimizer_params or {})
        self._frozen = frozenset(fixed_param_names) | frozenset(
            opt_params.pop("fixed_param_names", ()))
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **opt_params)
        elif isinstance(optimizer, opt_mod.Optimizer):
            if opt_params:
                raise MXNetError(
                    "optimizer_params must not be set when passing an "
                    "Optimizer instance (got %r); configure the instance "
                    "instead" % sorted(opt_params))
        else:
            raise MXNetError("optimizer must be a name or Optimizer")
        if not optimizer.supports_fused:
            raise MXNetError("optimizer %s has no fused form"
                             % type(optimizer).__name__)
        self.optimizer = optimizer
        self.lr = optimizer.lr
        self._lr_mults = {n: optimizer.lr_mult.get(n, 1.0)
                          for n in self.param_names}
        self._wd_mults = {n: optimizer.wd_mult.get(n, 1.0)
                          for n in self.param_names}
        if compute_dtype is not None:
            compute_dtype = getattr(torch, str(compute_dtype))
        self._compute_dtype = compute_dtype
        self._t = 0
        # one guard per graph, shared by rebuilt instances; with K >= 2
        # it counts the captures (one per input signature)
        self._recompile_guard = registry.guard("TrainStep(%s:%s)" % (
            getattr(symbol, "name", None) or "graph",
            _graph_digest(symbol)))
        self._graphs = {}  # signature -> _Graph (on a CUDA device)
        self._pool = None
        self.compile_stats = None

    def _fp8_for(self, device):
        """Whether fp8 is armed for a step on ``device`` (None: the card):
        ``MXNET_FP8`` as read at construction."""
        if self._fp8_mode != "auto":
            return self._fp8_mode == "on"
        return device is None or torch.device(device).type == "cuda"

    @property
    def _use_hstate(self):
        return self._health is not None or self._fp8

    def _cast(self, x):
        if self._compute_dtype is not None and x.is_floating_point():
            return x.to(self._compute_dtype)
        return x

    @property
    def steps_per_call(self):
        return self._steps_per_call

    def __call__(self, params, aux, states, batch, rng, lr=None, t=None):
        """One call: K = 1 runs one step eagerly and returns new tensors;
        K >= 2 runs K steps over the super-batch (one graph replay on a
        CUDA device, where the returned params/aux/states are the
        caller's own tensors, updated in place).  ``t`` is the step
        number of the (first) step; None continues ``self._t``."""
        K = self._steps_per_call
        if t is None:
            self._t += K
            t = self._t - K + 1
        else:
            self._t = int(t) + K - 1
        lr = self.lr if lr is None else lr
        device = next(iter(batch.values())).device
        if K == 1:
            p, a, s, outs, h, stats = self._step(
                params, aux, states, batch, rng, lr, t,
                self._prepare_hstate(params, aux, batch, device))
            self._keep_health(h, stats)
            return p, a, s, outs
        self._check_super_batch(batch)
        sig = signature_of(params, aux, states, batch)
        if device.type != "cuda":
            self._recompile_guard.observe(sig)
            return self.run_eager(params, aux, states, batch, rng, lr, t)
        hstate = self._prepare_hstate(params, aux, batch, device)
        graph = self._graphs.get(sig)
        if graph is None:
            self._recompile_guard.observe(sig, force=True)
            graph = self._capture(params, aux, states, batch, rng)
            self._graphs[sig] = graph
        else:
            self._recompile_guard.observe(sig)
        p, a, s, outs, h, stats = graph(params, aux, states, batch, lr, t,
                                        hstate)
        self._keep_health(h, stats)
        return p, a, s, outs

    # -- carried health state ------------------------------------------
    def _prepare_hstate(self, params, aux, batch, device):
        """Arm fp8 for ``device``, count the fp8 sites once, and create the
        carried state on first use.  Returns the state a step carries, or
        None for the plain step."""
        self._fp8 = self._fp8_for(device)
        if not self._use_hstate:
            return None
        if self._fp8 and self._fp8_sites is None:
            self._fp8_site_count(params, aux, batch)
        if self._hstate is None:
            self._hstate = self._init_hstate(device)
        elif self._fp8 and self._fp8_sites and \
                "fp8_hist" not in self._hstate:
            self._hstate = dict(self._hstate, fp8_hist=Q.fp8_hist_init(
                self._fp8_sites, device))
        return self._hstate

    def _keep_health(self, hstate, stats):
        """Keep a step's new carried state and its health stats."""
        if self._use_hstate:
            self._hstate, self.last_health = hstate, stats

    def _init_hstate(self, device):
        h = {}
        if self._scaler is not None:
            h["loss_scale"] = torch.full((), self._scaler.init_scale,
                                         dtype=torch.float32, device=device)
            h["good_steps"] = torch.zeros((), dtype=torch.int32,
                                          device=device)
        if self._fp8 and self._fp8_sites:
            h["fp8_hist"] = Q.fp8_hist_init(self._fp8_sites, device)
        return h

    def _fp8_site_count(self, params, aux, batch):
        """The number of fp8 sites one forward claims — the leading dim of
        the amax history — from one forward under ``torch.no_grad`` in an
        fp8 trace (counted once; a K-step super-batch's first batch).  The
        probe draws from a generator of its own, so no random stream of
        the run moves."""
        if not self._fp8 or self._fp8_sites is not None:
            return self._fp8_sites
        K = self._steps_per_call
        b = {n: (v[0] if K > 1 else v) for n, v in batch.items()}
        device = next(iter(b.values())).device
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        args = dict(params)
        args.update(b)
        with torch.no_grad(), Q.fp8_trace() as tr:
            self._fwd_fn({k: self._cast(v) for k, v in args.items()},
                         {k: self._cast(v) for k, v in aux.items()}, gen)
        self._fp8_sites = len(tr.names)
        return self._fp8_sites

    def export_hstate(self):
        """Host snapshot (numpy) of the carried state — the loss scale,
        its clean streak and the fp8 amax history — or None when the step
        carries none."""
        if self._hstate is None:
            return None
        return {k: v.detach().cpu().numpy() for k, v in self._hstate.items()}

    def load_hstate(self, hstate):
        """Install an :meth:`export_hstate` snapshot.  Dtypes are pinned
        (fp32 scale and history, int32 streak); an fp8 history also pins
        the site count.  Where the step already holds buffers of the same
        keys and shapes (a captured graph's), the values are copied into
        them, never rebound, so the next replay reads them."""
        if hstate is None:
            return
        if not self._use_hstate:
            raise MXNetError(
                "cannot install a health state: this TrainStep carries "
                "none (no StepHealth and fp8 off) — build it armed like "
                "the step that exported it")
        cur = self._hstate
        if cur:
            device = next(iter(cur.values())).device
        else:
            device = resolve_device(self._device, "TrainStep.load_hstate")
        new = {}
        if "loss_scale" in hstate:
            new["loss_scale"] = torch.tensor(
                float(np.asarray(hstate["loss_scale"])), dtype=torch.float32)
            new["good_steps"] = torch.tensor(
                int(np.asarray(hstate.get("good_steps", 0))),
                dtype=torch.int32)
        if "fp8_hist" in hstate:
            new["fp8_hist"] = torch.as_tensor(
                np.asarray(hstate["fp8_hist"], np.float32))
            self._fp8_sites = int(new["fp8_hist"].shape[0])
        if cur and set(cur) == set(new) and all(
                cur[k].shape == new[k].shape for k in new):
            with torch.no_grad():
                for k, v in new.items():
                    cur[k].copy_(v)
            return
        self._hstate = {k: v.to(device) for k, v in new.items()} or None

    @property
    def loss_scale(self):
        """The current loss scale as a float (a host read), or None
        without a scaler."""
        if self._hstate is None or "loss_scale" not in self._hstate:
            return None
        return float(self._hstate["loss_scale"])

    def _check_super_batch(self, batch):
        K = self._steps_per_call
        for name, v in batch.items():
            if v.dim() < 1 or v.shape[0] != K:
                raise MXNetError(
                    "TrainStep(steps_per_call=%d): input %r has shape %r; "
                    "a multi-step call takes a (%d, batch, ...) super-batch "
                    "(io.DevicePrefetchIter(steps_per_call=%d) packs one)"
                    % (K, name, tuple(v.shape), K, K))

    def _inner_generators(self, rng, device):
        """The K inner steps' random streams: generator k seeded from the
        call's key and k (the JAX package folds k into its key)."""
        base = rng.initial_seed() if rng is not None else 0
        gens = []
        for k in range(self._steps_per_call):
            gen = torch.Generator(device=device)
            gen.manual_seed((base * 1000003 + k + 1) % (2 ** 63))
            gens.append(gen)
        return gens

    def _k_steps(self, params, aux, states, batch, gens, lr, t0,
                 hstate=None, replays=None):
        """K steps one after another over the super-batch: ``lr`` a 0-d
        fp32 tensor, ``t0`` the first step number as a 0-d int32 tensor
        (step k's is ``t0 + k``, computed on the device), the carried
        state threaded through.  The body a graph captures and
        :meth:`run_eager` runs.  Outputs and health stats come back
        stacked (K, ...)."""
        per_step, per_stats = [], []
        for k in range(self._steps_per_call):
            params, aux, states, outs, hstate, stats = self._step(
                params, aux, states, {n: v[k] for n, v in batch.items()},
                gens[k], lr, t0 + k, hstate,
                replays[k] if replays is not None else None)
            per_step.append(outs)
            per_stats.append(stats)
        stacked = None
        if per_stats[0] is not None:
            stacked = {key: torch.stack([st[key] for st in per_stats])
                       for key in per_stats[0]}
        return params, aux, states, tuple(
            torch.stack([o[i] for o in per_step])
            for i in range(len(per_step[0]))), hstate, stacked

    def run_eager(self, params, aux, states, batch, rng, lr, t):
        """The multi-step call without a graph, on any device: the K steps
        of :meth:`_k_steps` one after another, returning new tensors.  It
        is what ``__call__`` runs on the CPU and the captured call's plain
        version on the card (``t`` the first step's number).  It carries
        the step's health state and sets ``last_health`` as a call does."""
        device = next(iter(batch.values())).device
        hstate = self._prepare_hstate(params, aux, batch, device)
        p, a, s, outs, h, stats = self._k_steps(
            params, aux, states, batch, self._inner_generators(rng, device),
            torch.full((), float(lr), dtype=torch.float32, device=device),
            torch.full((), int(t), dtype=torch.int32, device=device), hstate)
        self._keep_health(h, stats)
        return p, a, s, outs

    def _capture(self, params, aux, states, batch, rng):
        """Capture the K-step call for this signature as one CUDA graph.

        The static buffers are the caller's params, aux and states (the
        graph writes the new values into them with ``copy_``), a copy of
        the super-batch, and the device scalars ``lr`` and ``t0``.  The K
        inner generators, seeded from this call's ``rng``, are registered
        with the graph and advance at every replay, so every replay draws
        new random numbers (a later call's ``rng`` is not read).  One inner step runs first on a side
        stream, PyTorch's rule before a capture: cuDNN, cuBLAS and the
        kernels build and choose there, and its results are dropped.  A
        capture records launches and runs none, so the counts it added
        are taken back and kept as the launches a replay makes.  A
        failure raises ``MXNetError``; nothing falls back to the eager
        loop.  The capture is thread-local, so a staging thread may go on
        copying batches meanwhile."""
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise MXNetError("TrainStep(steps_per_call=%d): this torch (%s) "
                             "cannot register a generator with a CUDA graph"
                             % (self._steps_per_call, torch.__version__))
        device = next(iter(batch.values())).device
        t_start = time.perf_counter()
        sp = {k: v.detach() for k, v in params.items()}
        sa = {k: v.detach() for k, v in aux.items()}
        ss = {k: _detach_tree(v) for k, v in states.items()}
        sb = {k: v.detach().clone() for k, v in batch.items()}
        # the carried health state: the step's own buffers, updated in
        # place by every replay (load_hstate copies into them)
        sh = self._hstate if self._use_hstate else None
        lr = torch.zeros((), dtype=torch.float32, device=device)
        t0 = torch.ones((), dtype=torch.int32, device=device)
        gens = self._inner_generators(rng, device)
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._step(sp, sa, ss, {n: v[0] for n, v in sb.items()},
                           gens[0], lr, t0, sh)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            for gen in gens:
                graph.register_generator_state(gen)
            # remat: the recomputed forward of inner step k draws from a
            # copy of generator k taken before the capture, registered
            # with the graph too, so both replay the same offsets (a
            # generator's state cannot be rewound inside a capture)
            replays = None
            if self._remat is not None and any(
                    n.op.needs_rng for n in self.symbol._topo()
                    if not n.is_variable):
                replays = [gen.clone_state() for gen in gens]
                for gen in replays:
                    graph.register_generator_state(gen)
            before = dict(_cuda.launches)
            try:
                # thread_local: a staging thread (io.DevicePrefetchIter)
                # may pin and copy batches while this thread captures
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    new_p, new_a, new_s, outs, new_h, hstats = \
                        self._k_steps(sp, sa, ss, sb, gens, lr, t0, sh,
                                      replays)
                    with torch.no_grad():
                        _copy_tree(sp, new_p)
                        _copy_tree(sa, new_a)
                        _copy_tree(ss, new_s)
                        if sh is not None:
                            _copy_tree(sh, new_h)
            except Exception as exc:
                raise MXNetError(
                    "TrainStep(steps_per_call=%d): capturing the call as a "
                    "CUDA graph failed: %s" % (self._steps_per_call, exc)) \
                    from exc
            finally:
                counted = dict(_cuda.launches)
                _cuda.launches.update(before)
            torch.cuda.synchronize()
            pool_bytes = torch.cuda.memory_reserved() - reserved
        launches = {k: n - before.get(k, 0) for k, n in counted.items()
                    if n > before.get(k, 0)}
        stats = {"capture_s": time.perf_counter() - t_start,
                 "pool_bytes": pool_bytes, "launches": launches,
                 "steps_per_call": self._steps_per_call}
        self.compile_stats = stats
        return _Graph(graph, sp, sa, ss, sb, lr, t0, outs, gens, stats,
                      sh, hstats, replays)

    def graph_report(self):
        """Per captured signature (in capture order): capture seconds,
        pool bytes, replays and the kernel launches a replay makes."""
        return [dict(g.stats, replays=g.replays)
                for g in self._graphs.values()]

    def compile(self, shapes, dtype="float32"):
        """Capture ahead of time for per-step input ``shapes`` (the dict
        :meth:`init_state` takes; the leading K axis is added here), over
        fresh buffers from :meth:`init_state` that the first call's
        tensors are copied into.  Records and returns ``compile_stats``
        (capture seconds, pool bytes, launches recorded); the guard
        counts the capture.  On the CPU there is nothing to capture: the
        signature is recorded and the stats are zero."""
        K = self._steps_per_call
        if K == 1:
            raise MXNetError("TrainStep.compile: steps_per_call=1 runs "
                             "eagerly; there is no graph to capture")
        shapes = {k: tuple(v) for k, v in dict(shapes).items()}
        params, aux, states = self.init_state(shapes, dtype=dtype)
        device = next(iter(params.values())).device
        batch = {}
        for n in self.data_names + self.label_names:
            if n not in shapes:
                raise MXNetError("compile(shapes) is missing a shape for "
                                 "input %r" % n)
            batch[n] = torch.zeros((K,) + shapes[n], dtype=torch.float32,
                                   device=device)
        sig = signature_of(params, aux, states, batch)
        self._prepare_hstate(params, aux, batch, device)
        if device.type != "cuda":
            self._recompile_guard.observe(sig)
            self.compile_stats = {"capture_s": 0.0, "pool_bytes": 0,
                                  "launches": {}, "steps_per_call": K}
            return self.compile_stats
        if sig not in self._graphs:
            self._recompile_guard.observe(sig, force=True)
            self._graphs[sig] = self._capture(params, aux, states, batch,
                                              None)
        return self.compile_stats

    def _forward(self, args, aux, rng, replay=None):
        """The graph's forward; under ``remat`` recomputed in the backward,
        one checkpointed segment at a time (:func:`executor.segment_plan`,
        about sqrt(ops) segments), so only the tensors crossing a segment
        boundary stay alive between the forward and the backward.  A
        segment's recompute draws from a copy of the generator taken where
        the segment began, so dropout masks repeat bit for bit, and
        re-enters the fp8 trace at the scales of the sites it claimed (its
        amaxes are dropped).  Inside a CUDA-graph capture a generator
        cannot be copied, so a graph that draws random numbers is one
        segment whose recompute draws from ``replay``, a copy registered
        with the graph before the capture."""
        if self._remat is None:
            return self._fwd_fn(args, aux, rng)
        from torch.utils import checkpoint

        from .executor import run_segment, segment_plan

        if self._segments is None:
            ops = sum(1 for n in self.symbol._topo() if not n.is_variable)
            self._segments = segment_plan(self.symbol,
                                          max(1, int(round(ops ** 0.5))))
            self._draws = any(seg.draws for seg in self._segments)
        capturing = rng is not None and rng.device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing()
        whole = capturing and self._draws
        if whole:
            return self._remat_whole(args, aux, rng, replay)
        topo_vars = [n for n in self.symbol._topo() if n.is_variable]
        aux_set = set(self._aux_names)
        env = {(id(n), 0): (aux if n.name in aux_set else args)[n.name]
               for n in topo_vars}
        new_aux = dict(aux)
        device = next(iter(args.values())).device if args else None
        tr = Q.current_fp8_trace()
        kwargs = self._checkpoint_kwargs()
        for seg in self._segments:
            copy = rng.clone_state() if seg.draws and rng is not None \
                else None
            # the scales of the sites this segment claims, sliced here:
            # a selective recompute must run the forward's ops and no more
            scales = None if tr is None or tr.scales is None \
                else tr.scales[len(tr.names):]
            calls = [0]

            def run(*values, seg=seg, copy=copy, scales=scales,
                    calls=calls):
                first = calls[0] == 0
                calls[0] += 1
                if first or tr is None:
                    return run_segment(seg, values, rng if first else copy,
                                       True, device, aux_set)
                with Q.fp8_trace(scales):
                    return run_segment(seg, values, copy, True, device,
                                       aux_set)

            res = checkpoint.checkpoint(
                run, *[env[k] for k in seg.inputs], use_reentrant=False,
                preserve_rng_state=rng is None, **kwargs)
            env.update(zip(seg.outputs, res[:len(seg.outputs)]))
            new_aux.update(zip((a for a, _ in seg.aux),
                               res[len(seg.outputs):]))
        return (tuple(env[(id(n), i)] for (n, i) in self.symbol._outputs),
                new_aux)

    def _remat_whole(self, args, aux, rng, replay):
        """The whole forward as one checkpointed function, its recompute
        drawing from ``replay`` (see :meth:`_forward`)."""
        from torch.utils import checkpoint

        arg_keys, aux_keys = list(args), list(aux)
        n_args = len(arg_keys)
        tr = Q.current_fp8_trace()
        calls, layout = [0], {}

        def run(*flat):
            first = calls[0] == 0
            calls[0] += 1
            a = dict(zip(arg_keys, flat[:n_args]))
            x = dict(zip(aux_keys, flat[n_args:]))
            gen = rng if first else replay
            if first or tr is None:
                outs, new_aux = self._fwd_fn(a, x, gen)
            else:
                with Q.fp8_trace(tr.scales):
                    outs, new_aux = self._fwd_fn(a, x, gen)
            layout["n"], layout["aux"] = len(outs), list(new_aux)
            return tuple(outs) + tuple(new_aux[k] for k in layout["aux"])

        res = checkpoint.checkpoint(
            run, *[args[k] for k in arg_keys], *[aux[k] for k in aux_keys],
            use_reentrant=False, preserve_rng_state=False,
            **self._checkpoint_kwargs())
        n = layout["n"]
        return tuple(res[:n]), dict(zip(layout["aux"], res[n:]))

    def _checkpoint_kwargs(self):
        """Selective checkpointing's context for a ``dots_*`` policy."""
        if self._remat == "full":
            return {}
        return {"context_fn": functools.partial(_sac_context, self._remat)}

    def _step(self, params, aux, states, batch, rng, lr, t, hstate=None,
              replay=None):
        """One update.  ``hstate`` None: the plain step.  Otherwise (a dict,
        maybe empty) the health step: stats, the non-finite skip, the loss
        scale and the fp8 history, returned as the new carried state.
        Returns ``(params, aux, states, outs, hstate, stats)``."""
        frozen = self._frozen
        use_h = hstate is not None
        scaler = self._scaler if use_h else None
        fp8_on = use_h and self._fp8 and "fp8_hist" in hstate
        leaves = {k: v.detach().requires_grad_(k not in frozen)
                  for k, v in params.items()}
        amax = None
        with torch.enable_grad():
            args = dict(leaves)
            args.update(batch)
            args = {k: self._cast(v) for k, v in args.items()}
            caux = {k: self._cast(v) for k, v in aux.items()}
            if fp8_on:
                with Q.fp8_trace(Q.fp8_realize_scales(
                        hstate["fp8_hist"])) as tr:
                    outs, new_aux = self._forward(args, caux, rng, replay)
                if len(tr.amax) != hstate["fp8_hist"].shape[0]:
                    raise MXNetError(
                        "fp8: the forward claimed %d sites, the amax "
                        "history holds %d" % (len(tr.amax),
                                              hstate["fp8_hist"].shape[0]))
                amax = torch.stack(tr.amax) if tr.amax else None
            else:
                outs, new_aux = self._forward(args, caux, rng, replay)
            new_aux = {k: v.detach().to(aux[k].dtype)
                       for k, v in new_aux.items()}
            loss = _loss_from_outputs(outs)
            # scale the loss before the backward: the gradients come back
            # scaled out of the underflow-prone range
            seed = loss * hstate["loss_scale"] if scaler is not None \
                else loss
            live = [k for k in sorted(leaves) if k not in frozen]
            got = torch.autograd.grad(seed, [leaves[k] for k in live],
                                      allow_unused=True)
        loss = loss.detach()
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(live, got)}
        if scaler is not None:
            scale = hstate["loss_scale"]
            inv = torch.ones_like(scale) / scale
            loss = seed.detach() * inv
            grads = {k: g * inv.to(g.dtype) for k, g in grads.items()}
        clip = self.optimizer.clip_global_norm
        gnorm = None
        if use_h or clip is not None:
            # one NaN/Inf anywhere poisons the sum of squares: the norm's
            # finiteness is the all-gradients flag
            gnorm = opt_mod.global_grad_norm([grads[k] for k in live],
                                             self.optimizer.rescale_grad)
        if clip is not None:
            factor = opt_mod.global_norm_scale(gnorm, clip)
            grads = {k: g * factor.to(g.dtype) for k, g in grads.items()}
        new_params, new_states = {}, {}
        with torch.no_grad():
            for k in sorted(params):
                if k in frozen:
                    new_params[k], new_states[k] = params[k], states[k]
                    continue
                new_params[k], new_states[k] = self.optimizer.fused_update(
                    params[k], grads[k], states[k],
                    lr * self._lr_mults[k],
                    self.optimizer.wd * self._wd_mults[k], t, rng)
            outs = tuple(o.detach() for o in outs)
            if not use_h:
                return new_params, new_aux, new_states, outs, None, None
            bad = ~(torch.isfinite(loss) & torch.isfinite(gnorm))
            if self._skip_on_bad:
                # the skip on the device: the old bits, selected
                written = set()
                for k in new_params:
                    if k not in frozen:
                        new_params[k] = _select_tree(
                            bad, params[k], new_params[k], written)
                        new_states[k] = _select_tree(
                            bad, states[k], new_states[k], written)
                new_aux = {k: torch.where(bad, aux[k], v)
                           for k, v in new_aux.items()}
            new_h = dict(hstate)
            if scaler is not None:
                scale = hstate["loss_scale"]
                good = torch.where(bad, torch.zeros_like(
                    hstate["good_steps"]), hstate["good_steps"] + 1)
                grow = good >= scaler.growth_interval
                new_h["loss_scale"] = torch.where(
                    bad, torch.clamp(scale * scaler.backoff,
                                     min=scaler.min_scale),
                    torch.where(grow, torch.clamp(scale * scaler.growth,
                                                  max=scaler.max_scale),
                                scale))
                new_h["good_steps"] = torch.where(
                    grow, torch.zeros_like(good), good)
            if amax is not None:
                # the history rolls on skipped steps too, but a
                # non-finite forward amax must not poison it
                safe = torch.where(torch.isfinite(amax), amax,
                                   torch.zeros_like(amax))
                new_h["fp8_hist"] = Q.fp8_update_hist(hstate["fp8_hist"],
                                                      safe)
            stats = {"loss": loss.float(), "grad_norm": gnorm,
                     "nonfinite": bad}
            if scaler is not None:
                stats["loss_scale"] = hstate["loss_scale"]
        return new_params, new_aux, new_states, outs, new_h, stats

    def init_state(self, shapes, dtype="float32", seed=0):
        """Allocate params/aux/optimizer states from the shape inference
        pass, with the JAX package's rules: ``*_gamma`` ones, ``*_bias`` and
        ``*_beta`` zeros, every other parameter ``sqrt(2 / fan_in) *
        normal`` with fan_in the product of the trailing dims (the first
        dim for 1-D).  Draws come from a ``torch.Generator`` seeded with
        ``seed``, one parameter after another in argument order, so the
        values differ from the JAX package's; carry one state across with
        :func:`state_from_numpy` to compare the two."""
        from .symbol.symbol import _infer_param_shapes

        device = resolve_device(self._device, "TrainStep.init_state")
        dtype = getattr(torch, str(dtype))
        all_shapes = _infer_param_shapes(self.symbol, dict(shapes))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        params, aux, states = {}, {}, {}
        for n in self.param_names:
            shp = tuple(all_shapes[n])
            if n.endswith("_gamma"):
                params[n] = torch.ones(shp, dtype=dtype, device=device)
            elif n.endswith(("_bias", "_beta")):
                params[n] = torch.zeros(shp, dtype=dtype, device=device)
            else:
                fan_in = int(np.prod(shp[1:])) if len(shp) > 1 else shp[0]
                scale = (2.0 / max(1, fan_in)) ** 0.5
                params[n] = scale * torch.randn(shp, generator=gen,
                                                dtype=dtype, device=device)
        for n in self.param_names:
            states[n] = self.optimizer.init_fused_state(params[n])
        for n in self._aux_names:
            fill = torch.ones if n.endswith("_var") else torch.zeros
            aux[n] = fill(tuple(all_shapes[n]), dtype=torch.float32,
                          device=device)
        return params, aux, states


def _detach_tree(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_detach_tree(e) for e in x)
    return x.detach()


def _copy_tree(dst, src):
    """Write ``src`` into ``dst`` ({name: tensor, a tuple of tensors or
    None}); a tensor that already shares ``dst``'s storage is skipped."""
    for k, d in dst.items():
        _copy_leaf(d, src[k])


def _copy_leaf(d, s):
    if d is None:
        return
    if isinstance(d, tuple):
        for de, se in zip(d, s):
            _copy_leaf(de, se)
        return
    if s.data_ptr() != d.data_ptr() or s.stride() != d.stride():
        d.copy_(s)


class _Graph:
    """One captured multi-step call: the graph, its static buffers and
    outputs.  A call writes what differs into the buffers (a tensor the
    caller rebound, the batch, ``lr``, ``t0``, the carried health
    state), replays, counts the replay and its kernel launches, and
    returns the buffers (updated in place) and copies of the stacked
    outputs and health stats, which the next replay would overwrite."""

    def __init__(self, graph, params, aux, states, batch, lr, t0, outs,
                 gens, stats, hstate=None, hstats=None, replays=None):
        self.graph = graph
        self.params, self.aux, self.states = params, aux, states
        self.batch, self.lr, self.t0 = batch, lr, t0
        self.outs = outs
        self.gens = gens
        self.stats = stats
        self.hstate, self.hstats = hstate, hstats
        self.replays_gens = replays
        self.replays = 0

    def __call__(self, params, aux, states, batch, lr, t, hstate=None):
        with torch.no_grad():
            _copy_tree(self.params, params)
            _copy_tree(self.aux, aux)
            _copy_tree(self.states, states)
            _copy_tree(self.batch, batch)
            if self.hstate is not None and hstate is not None:
                _copy_tree(self.hstate, hstate)
            if isinstance(lr, torch.Tensor):
                self.lr.copy_(lr)
            else:
                self.lr.fill_(float(lr))
            self.t0.fill_(int(t))
        if self.replays_gens is not None:
            # the remat copies start every replay where their generators
            # do (an update that draws would move only the original)
            for gen, copy in zip(self.gens, self.replays_gens):
                copy.set_state(gen.get_state())
        self.graph.replay()
        self.replays += 1
        for kernel, n in self.stats["launches"].items():
            _cuda.launches[kernel] += n
        hstats = None if self.hstats is None else \
            {k: v.clone() for k, v in self.hstats.items()}
        return (dict(self.params), dict(self.aux), dict(self.states),
                tuple(o.clone() for o in self.outs),
                None if self.hstate is None else dict(self.hstate), hstats)


def compile_train_step(symbol, **kwargs):
    return TrainStep(symbol, **kwargs)


def state_from_numpy(params, aux, states, device=None):
    """The port's (params, aux, states) from numpy ones — for example the
    JAX package's ``init_state`` output converted with ``np.asarray``:
    {name: array}, with each optimizer state None, an array or a tuple of
    those.  Tensors land on ``device`` (None: the card)."""
    device = resolve_device(device, "state_from_numpy")

    def conv(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(conv(e) for e in x)
        return torch.from_numpy(np.array(x)).to(device)

    return ({k: conv(v) for k, v in params.items()},
            {k: conv(v) for k, v in aux.items()},
            {k: conv(v) for k, v in states.items()})
