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

``mesh``, ``zero``, ``plan``, ``health``, ``remat``, ``param_sharding``
and ``MXNET_FP8`` belong to later slices and raise.

Note on ``compute_dtype="bfloat16"``: the cast reaches the token ids too,
as in the JAX package, so ids above 256 round to bf16 and an id that
rounds to V or beyond looks up a NaN row (``ops/matrix_ops.py``).  The
port reproduces this on purpose; the JAX package is the reference.
"""
from __future__ import annotations

import hashlib
import json
import time

import numpy as np
import torch

from . import _cuda
from . import optimizer as opt_mod
from .base import MXNetError, get_env, later_slice, resolve_device
from .compile_cache import registry, signature_of

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


def _check_slice(mesh, zero, plan, health, remat, param_sharding):
    """Raise ``later_slice`` for every option outside the single-device
    eager step, including the env spellings the JAX package reads."""
    zero = zero if zero is not None else get_env("MXNET_ZERO", "auto", str)
    plan = plan if plan is not None else \
        (get_env("MXNET_PLAN", "", str).strip() or None)
    fp8 = str(get_env("MXNET_FP8", "off") or "off").strip().lower()
    for field, value, fine in (
            ("mesh", mesh, mesh is None),
            ("zero", zero, str(zero).strip().lower() in
             ("auto", "off", "0", "false", "no", "")),
            ("plan", plan, plan is None),
            ("health", health, health is None),
            ("remat", remat, remat in (None, False)),
            ("param_sharding", param_sharding,
             param_sharding in (None, "replicated")),
            ("MXNET_FP8", fp8, fp8 in ("off", "0", "false", "no", ""))):
        if not fine:
            raise later_slice(field, value)


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

        _check_slice(mesh, zero, plan, health, remat, param_sharding)
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
        if K == 1:
            return self._step(params, aux, states, batch, rng, lr, t)
        self._check_super_batch(batch)
        device = next(iter(batch.values())).device
        sig = signature_of(params, aux, states, batch)
        if device.type != "cuda":
            self._recompile_guard.observe(sig)
            return self.run_eager(params, aux, states, batch, rng, lr, t)
        graph = self._graphs.get(sig)
        if graph is None:
            self._recompile_guard.observe(sig, force=True)
            graph = self._capture(params, aux, states, batch, rng)
            self._graphs[sig] = graph
        else:
            self._recompile_guard.observe(sig)
        return graph(params, aux, states, batch, lr, t)

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

    def _k_steps(self, params, aux, states, batch, gens, lr, t0):
        """K steps one after another over the super-batch: ``lr`` a 0-d
        fp32 tensor, ``t0`` the first step number as a 0-d int32 tensor
        (step k's is ``t0 + k``, computed on the device).  The body a
        graph captures and :meth:`run_eager` runs."""
        per_step = []
        for k in range(self._steps_per_call):
            params, aux, states, outs = self._step(
                params, aux, states, {n: v[k] for n, v in batch.items()},
                gens[k], lr, t0 + k)
            per_step.append(outs)
        return params, aux, states, tuple(
            torch.stack([o[i] for o in per_step])
            for i in range(len(per_step[0])))

    def run_eager(self, params, aux, states, batch, rng, lr, t):
        """The multi-step call without a graph, on any device: the K steps
        of :meth:`_k_steps` one after another, returning new tensors.  It
        is what ``__call__`` runs on the CPU and the captured call's plain
        version on the card (``t`` the first step's number)."""
        device = next(iter(batch.values())).device
        return self._k_steps(
            params, aux, states, batch, self._inner_generators(rng, device),
            torch.full((), float(lr), dtype=torch.float32, device=device),
            torch.full((), int(t), dtype=torch.int32, device=device))

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
        lr = torch.zeros((), dtype=torch.float32, device=device)
        t0 = torch.ones((), dtype=torch.int32, device=device)
        gens = self._inner_generators(rng, device)
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._step(sp, sa, ss, {n: v[0] for n, v in sb.items()},
                           gens[0], lr, t0)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            for gen in gens:
                graph.register_generator_state(gen)
            before = dict(_cuda.launches)
            try:
                # thread_local: a staging thread (io.DevicePrefetchIter)
                # may pin and copy batches while this thread captures
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    new_p, new_a, new_s, outs = self._k_steps(
                        sp, sa, ss, sb, gens, lr, t0)
                    with torch.no_grad():
                        _copy_tree(sp, new_p)
                        _copy_tree(sa, new_a)
                        _copy_tree(ss, new_s)
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
        return _Graph(graph, sp, sa, ss, sb, lr, t0, outs, gens, stats)

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

    def _step(self, params, aux, states, batch, rng, lr, t):
        frozen = self._frozen
        leaves = {k: v.detach().requires_grad_(k not in frozen)
                  for k, v in params.items()}
        with torch.enable_grad():
            args = dict(leaves)
            args.update(batch)
            args = {k: self._cast(v) for k, v in args.items()}
            outs, new_aux = self._fwd_fn(
                args, {k: self._cast(v) for k, v in aux.items()}, rng)
            new_aux = {k: v.detach().to(aux[k].dtype)
                       for k, v in new_aux.items()}
            loss = _loss_from_outputs(outs)
            live = [k for k in sorted(leaves) if k not in frozen]
            got = torch.autograd.grad(loss, [leaves[k] for k in live],
                                      allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(live, got)}
        clip = self.optimizer.clip_global_norm
        if clip is not None:
            factor = opt_mod.global_norm_scale(opt_mod.global_grad_norm(
                [grads[k] for k in live], self.optimizer.rescale_grad), clip)
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
        return new_params, new_aux, new_states, tuple(o.detach()
                                                      for o in outs)

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
    caller rebound, the batch, ``lr``, ``t0``), replays, counts the
    replay and its kernel launches, and returns the buffers (updated in
    place) and a copy of the stacked outputs, which the next replay
    would overwrite."""

    def __init__(self, graph, params, aux, states, batch, lr, t0, outs,
                 gens, stats):
        self.graph = graph
        self.params, self.aux, self.states = params, aux, states
        self.batch, self.lr, self.t0 = batch, lr, t0
        self.outs = outs
        self.gens = gens
        self.stats = stats
        self.replays = 0

    def __call__(self, params, aux, states, batch, lr, t):
        with torch.no_grad():
            _copy_tree(self.params, params)
            _copy_tree(self.aux, aux)
            _copy_tree(self.states, states)
            _copy_tree(self.batch, batch)
            if isinstance(lr, torch.Tensor):
                self.lr.copy_(lr)
            else:
                self.lr.fill_(float(lr))
            self.t0.fill_(int(t))
        self.graph.replay()
        self.replays += 1
        for kernel, n in self.stats["launches"].items():
            _cuda.launches[kernel] += n
        return (dict(self.params), dict(self.aux), dict(self.states),
                tuple(o.clone() for o in self.outs))


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
