"""InferenceSession: bucketed prefill, one decode step and speculative
decoding over the paged KV cache, every entry point captured once as a
CUDA graph.

Counterpart of ``mxnet_tpu/serve/session.py``.  The JAX session compiles
every executable it will ever run in ``__init__`` (``_Executable``,
``_aot``, ``_compile_all``): one prefill per sequence-length bucket, one
fixed-shape decode step and, with speculative decoding on (``spec_k >
0``), one ``K + 1``-row verify and — for a draft model — one draft scan,
dispatched over donated pool buffers.  Here each is a CUDA graph
(:class:`_Executable`): on a CUDA device ``__init__`` runs every entry
point once on a side stream (the kernels build and load there), then
captures each over fixed input buffers, all graphs in one memory pool; a
call copies its inputs into those buffers and replays, and the replay
writes the KV pools in place.  ``sess.executables`` names exactly these
for the session's life: ``decode``, ``prefill_<bucket>`` per bucket,
``verify``, and ``draft`` for a draft model.  A capture that fails
raises; nothing runs the eager functions on the card in its place.  On
the CPU the same names run the eager functions over the same buffers.
Every projection runs K3 and attention K2 (``csrc/``); a quantized
session runs K3q, K2q and K9 in their place, in the same graphs.

A replay's outputs are the graph's own tensors: the graphs share one
pool and replay in series on one stream, so an output is valid until
the next replay of any entry point, and every caller here reads what it
needs (tokens, logits) before that.

Speculative decoding (``spec_k``, ``draft``): a draft proposes ``spec_k``
tokens a slot, one verify runs all ``W = K + 1`` rows through the
target, and greedy acceptance commits the longest agreeing prefix.
Verify row ``j`` equals the ``j``-th serial decode step bit for bit, so
acceptance is an integer comparison and the output equals
non-speculative decode token for token; the rejected suffix rolls back
through :meth:`PagedKVCache.truncate`, in the draft's cache too.  Drafts:
``ngram`` (prompt lookup on the host, the default), ``layers:N`` (the
target's first N blocks) or explicit ``draft_params``.

Prefix caching (``prefix_pages``), chunked prefill at page-aligned
offsets, and oversubscription with on-demand page growth carry over
from the JAX session unchanged; they are host bookkeeping around the
same entry points.  Model load goes through the port's checkpoint
restore (:meth:`InferenceSession.from_checkpoint`, and a
checkpoint-directory draft), which reads the JAX package's files too;
an env-derived config takes a cached autotune record's knobs
(``MXNET_AUTOTUNE``, :func:`~mxnet_tpu_torch.autotune.apply_serve`).
The replica supervisor rejoins a replica through :meth:`reset_cold`,
and the gateway's cancellation tests hold :meth:`state_report` to its
baseline.

Hybrid stacks (``layers``, ``MXNET_SERVE_LAYERS``, with ``window``,
``MXNET_SERVE_WINDOW``): a pattern of ``full``, ``window`` and ``ssm``
cycled over the model's depth makes per-slot memory O(window) or O(1) in
context length (:class:`PagedKVCache`'s rings and state pool).  The
rings, the states and the verify's commit caps are inputs of the same
captured graphs: the executable set stays frozen, and the recompile
guards' names carry the window and the kinds (``-w<window><f|w|s...>``).
Speculative decoding composes (the verify selects each slot's committed
SSM state in the graph; rings roll back by length), a ``layers:N`` draft
inherits the kinds and the window (one holding an SSM layer is refused
up front), preempt/resume rebuilds rings and states exactly by
re-prefilling, and the prefix cache opts out.

Weight-only quantization (``quant``, ``int8`` or ``fp8``): the session
quantizes its params (and a draft's) at construction into ``{"q",
"s"}`` records (``quantize.py``), ~4x fewer bytes at rest, which every
projection reads through kernel K3q and the embeddings dequantize as
they gather.  Quantized KV pages (``kv_quant``, ``int8`` or
``e4m3``/``fp8``): one-byte code pools with a float32 scale a row
(:class:`PagedKVCache`), written through kernel K9 and read through
K2q, ~4x the tokens a pool byte holds.  Both keep the JAX package's
per-precision contract: a quantized session's logits equal
``reference_last_logits(sess.dequantized_params(), seq, model, page,
exact=True, kv_quant=mode)`` bit for bit, so verify rows, prefix hits,
preempt/re-prefill and graph replays keep those bits, and speculation
composes as before.

Env knobs: ``MXNET_SERVE_SLOTS``, ``MXNET_SERVE_PAGE``,
``MXNET_SERVE_BUCKETS``, ``MXNET_SERVE_MAX_NEW``, ``MXNET_SERVE_PAGES``,
``MXNET_SERVE_EXACT``, ``MXNET_SERVE_SPEC_K``, ``MXNET_SERVE_DRAFT``,
``MXNET_SERVE_QUANT``, ``MXNET_SERVE_KV_QUANT``,
``MXNET_SERVE_PREFIX_PAGES``, ``MXNET_SERVE_OVERSUB``,
``MXNET_SERVE_WATERMARK``, ``MXNET_SERVE_TTFT_SLO_MS``,
``MXNET_SERVE_WINDOW``, ``MXNET_SERVE_LAYERS`` — the JAX package's
names.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import time

import numpy as np
import torch

from .. import _cuda
from .. import quantize as Q
from ..base import MXNetError, get_env, resolve_device
from ..compile_cache import registry, signature_of
from ..testing import faults
from .kv_cache import PagedKVCache
from .model import config_from_params, decode_step, draft_propose, \
    exact_mode, params_from_numpy, prefill_forward, verify_step

__all__ = ["ServeConfig", "InferenceSession"]


def _parse_buckets(raw):
    if isinstance(raw, str):
        parts = [p for p in raw.replace(";", ",").split(",") if p.strip()]
        raw = [int(p) for p in parts]
    buckets = tuple(sorted(set(int(b) for b in raw)))
    if not buckets:
        raise MXNetError("ServeConfig: empty bucket set")
    return buckets


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Capacity knobs for one :class:`InferenceSession`.

    ``buckets`` are padded prefill lengths (each a multiple of
    ``page_size``); ``max_new`` caps tokens generated per request;
    ``num_pages`` sizes the shared KV pool (default: full reservation
    capacity for ``slots`` worst-case requests); ``spec_k`` > 0 turns
    on speculative decoding with K draft proposals per step and
    ``draft`` picks the proposer (``""``/``"ngram"`` host prompt-lookup,
    ``"layers:N"`` the target's first N blocks, else a checkpoint
    directory, prefix ``model``).  ``quant`` (``""``, ``"int8"`` or
    ``"fp8"``) quantizes the weights and ``kv_quant`` (the same, ``e4m3``
    naming fp8) the KV pages, normalized as ``quantize.quant_mode``
    does.  ``layers`` is a pattern of layer kinds (``"full,window,ssm"``)
    cycled over the model's depth, and ``window`` the span of its
    ``window`` layers; an empty pattern is the classic all-full stack,
    and ``window`` is then unused.
    """

    slots: int = 4
    page_size: int = 16
    buckets: tuple = (16, 32, 64)
    max_new: int = 32
    num_pages: int = 0  # 0 = slots * max_pages_per_slot
    exact: bool = True
    spec_k: int = 0  # 0 = speculative decoding off
    draft: str = ""  # "", "ngram", "layers:N", or a checkpoint dir
    quant: str = ""  # "", "int8" or "fp8": weight-only quantization
    kv_quant: str = ""  # "", "int8" or "fp8" (e4m3): quantized KV pages
    prefix_pages: int = 0  # 0 = prefix cache off; -1 = unbounded retention
    oversub: bool = False  # admit by current need, grow on demand
    watermark: int = 0  # free-pool floor that triggers preemption
    ttft_slo_ms: float = 0.0  # 0 = no TTFT budget (SLO admission off)
    window: int = 0  # sliding-window length of "window" layers
    layers: str = ""  # layer-kind pattern, e.g. "full,window,ssm"

    @classmethod
    def from_env(cls, **overrides):
        vals = dict(
            slots=get_env("MXNET_SERVE_SLOTS", cls.slots, int),
            page_size=get_env("MXNET_SERVE_PAGE", cls.page_size, int),
            buckets=_parse_buckets(
                get_env("MXNET_SERVE_BUCKETS", "16,32,64", str)),
            max_new=get_env("MXNET_SERVE_MAX_NEW", cls.max_new, int),
            num_pages=get_env("MXNET_SERVE_PAGES", 0, int),
            exact=exact_mode(),
            spec_k=get_env("MXNET_SERVE_SPEC_K", 0, int),
            draft=get_env("MXNET_SERVE_DRAFT", "", str),
            quant=get_env("MXNET_SERVE_QUANT", "", str),
            kv_quant=get_env("MXNET_SERVE_KV_QUANT", "", str),
            prefix_pages=get_env("MXNET_SERVE_PREFIX_PAGES", 0, int),
            oversub=get_env("MXNET_SERVE_OVERSUB", False, bool),
            watermark=get_env("MXNET_SERVE_WATERMARK", 0, int),
            ttft_slo_ms=get_env("MXNET_SERVE_TTFT_SLO_MS", 0.0, float),
            window=get_env("MXNET_SERVE_WINDOW", 0, int),
            layers=get_env("MXNET_SERVE_LAYERS", "", str),
        )
        vals.update(overrides)
        return cls(**vals)

    def __post_init__(self):
        object.__setattr__(self, "buckets", _parse_buckets(self.buckets))
        object.__setattr__(self, "quant", Q.quant_mode(self.quant))
        object.__setattr__(self, "kv_quant", Q.quant_mode(self.kv_quant))
        if self.slots < 1 or self.page_size < 1 or self.max_new < 1:
            raise MXNetError("ServeConfig: slots/page_size/max_new must "
                             "be >= 1")
        if self.spec_k < 0:
            raise MXNetError("ServeConfig: spec_k must be >= 0")
        if self.prefix_pages < -1:
            raise MXNetError("ServeConfig: prefix_pages must be >= -1")
        if self.watermark < 0:
            raise MXNetError("ServeConfig: watermark must be >= 0")
        if self.ttft_slo_ms < 0:
            raise MXNetError("ServeConfig: ttft_slo_ms must be >= 0")
        for b in self.buckets:
            if b % self.page_size:
                raise MXNetError(
                    "ServeConfig: bucket %d is not a multiple of page_size "
                    "%d (prefill writes whole pages)" % (b, self.page_size))
        if self.window < 0:
            raise MXNetError("ServeConfig: window must be >= 0")
        pat = self.layer_pattern
        bad = set(pat) - {"full", "window", "ssm"}
        if bad:
            raise MXNetError("ServeConfig: unknown layer kinds %r in "
                             "layers=%r" % (sorted(bad), self.layers))
        if "window" in pat and self.window < 1:
            raise MXNetError(
                "ServeConfig: layers=%r has windowed layers but window is "
                "unset (MXNET_SERVE_WINDOW)" % (self.layers,))

    @property
    def layer_pattern(self):
        """``layers`` parsed into a tuple of kinds (:meth:`kinds_for`
        cycles it over the model's depth)."""
        return tuple(t.strip() for t in self.layers.replace(";", ",")
                     .split(",") if t.strip())

    def kinds_for(self, num_layers):
        """Per-layer kinds of a ``num_layers``-deep model: the pattern
        repeated over the stack; an all-full pattern is ``()``, the
        classic stack."""
        pat = self.layer_pattern
        if not pat:
            return ()
        kinds = tuple(pat[i % len(pat)] for i in range(int(num_layers)))
        return () if set(kinds) == {"full"} else kinds

    @property
    def ring_pages(self):
        """Pages of each windowed layer's ring a slot: a call writes up
        to ``span`` rows (the largest bucket, or the speculative window)
        before its queries read, so the ring holds ``window + span - 1``
        rows, plus one page because the rotated table is page-granular
        (the newest page may hold one row)."""
        span = max(max(self.buckets), self.spec_window if self.spec_k else 1)
        return -(-(self.window + span - 1) // self.page_size) + 1

    @property
    def max_pages_per_slot(self):
        worst = max(self.buckets) + self.max_new
        return -(-worst // self.page_size)

    @property
    def pool_pages(self):
        return self.num_pages or self.slots * self.max_pages_per_slot

    @property
    def spec_window(self):
        """Verify rows per speculative step: the last committed token
        plus the K proposals."""
        return self.spec_k + 1

    @property
    def spec_pad_pages(self):
        """All-trash page-table columns appended past the reservable
        range.  A verify/draft step writes up to ``spec_k`` rows beyond
        a slot's committed horizon; near the end of a request those can
        cross the reservation boundary, and the draft's page-index clip
        must then land on trash instead of aliasing the slot's last real
        page."""
        return -(-self.spec_k // self.page_size) if self.spec_k else 0


class _Executable(object):
    """One entry point of the session: ``fn`` over fixed-shape input
    buffers (``inputs``, name -> tensor).

    On a CUDA device :func:`_capture` records ``fn`` once as ``graph``
    with its ``outputs`` and the kernel ``launches`` one replay makes; a
    call copies its arguments into the buffers and replays, counting the
    replay and the launches it makes.  On the CPU a call runs ``fn``
    eagerly over the same buffers."""

    def __init__(self, name, fn, inputs, guard=None):
        self.name = name
        self.fn = fn
        self.inputs = inputs
        self.guard = guard  # observes the one input signature it takes
        if guard is not None:
            guard.observe(signature_of(inputs))
        self.graph = None
        self.outputs = None
        self.pool_bytes = 0  # growth of the graph pool at its capture
        self.launches = {}  # kernel -> launches a replay makes
        self.replays = 0

    def __call__(self, **values):
        for key, val in values.items():
            buf = self.inputs[key]
            val = torch.as_tensor(val)
            if tuple(val.shape) != tuple(buf.shape):
                raise MXNetError("%s: %s of shape %r, the executable takes "
                                 "%r" % (self.name, key, tuple(val.shape),
                                         tuple(buf.shape)))
            buf.copy_(val)
        if self.graph is None:
            self.outputs = self.fn(**self.inputs)
            return self.outputs
        self.graph.replay()
        self.replays += 1
        for kernel, n in self.launches.items():
            _cuda.launches[kernel] += n
        return self.outputs


def _capture(exes, device):
    """Capture every executable of ``exes`` as a CUDA graph, all into one
    memory pool.  Each runs once first on a side stream, PyTorch's rule
    before a capture: the kernels build and load there, and nothing a
    capture cannot hold (an nvcc run, a library load, a first
    ``cudaFuncSetAttribute``) is left for it.  The warm-up writes only the
    trash page (the buffers hold all-trash tables).  A capture records
    launches and runs none, so the counts it added are taken back and
    kept as the executable's launches a replay.  Returns ``(seconds,
    pool bytes)``: the seconds include the warm-up, and the pool's size
    is the growth of the memory PyTorch reserves on ``device`` across the
    captures (the warm-up's cached blocks released first)."""
    t0 = time.perf_counter()
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for exe in exes:
                exe.fn(**exe.inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        pool = torch.cuda.graph_pool_handle()
        for exe in exes:
            before = dict(_cuda.launches)
            held = torch.cuda.memory_reserved()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=pool):
                    outputs = exe.fn(**exe.inputs)
            except RuntimeError as exc:
                raise MXNetError("InferenceSession: capturing %r as a CUDA "
                                 "graph failed: %s" % (exe.name, exc)) \
                    from exc
            finally:
                counted = dict(_cuda.launches)
                _cuda.launches.update(before)
            exe.launches = {k: n - before.get(k, 0)
                            for k, n in counted.items()
                            if n > before.get(k, 0)}
            exe.graph, exe.outputs = graph, outputs
            exe.pool_bytes = torch.cuda.memory_reserved() - held
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return (time.perf_counter() - t0,
                torch.cuda.memory_reserved() - reserved)




class InferenceSession(object):
    """Serving session for the built-in transformer LM.

    ``params`` is a flat name -> array dict (numpy arrays or tensors)
    under the training parameter names; it is held as float32 on
    ``device`` (default: the card — without one, pass ``device="cpu"``),
    or quantized under ``config.quant``.
    On a CUDA device every entry point is captured as a CUDA graph here,
    once; steady-state serving only replays.

    With ``config.spec_k > 0`` the session also hosts a draft proposer:
    pass ``draft_params`` (+ ``draft_num_heads``) explicitly, or let
    ``config.draft`` resolve one (``"ngram"``, ``"layers:N"`` or a
    checkpoint directory).  A draft model gets its own
    :class:`PagedKVCache` (same slot and page geometry, the draft's
    dims) that the session keeps in lockstep with the target's.
    """

    def __init__(self, params, num_heads, config=None, device=None,
                 draft_params=None, draft_num_heads=None):
        self.device = resolve_device(device, "InferenceSession")
        self.config = config or ServeConfig.from_env()
        if config is None:
            # env-driven config: a cached autotune record for this
            # (model fingerprint, card) may override knobs (opt-in via
            # MXNET_AUTOTUNE; autotune.provenance() lists it)
            from .. import autotune as _autotune

            self.config = _autotune.apply_serve(self.config, params)
        cfg = self.config
        self.params = params_from_numpy(params, self.device)
        if cfg.quant:
            # on the host in fp32, as the JAX package quantizes; a
            # layers:N draft then shares these records
            self.params = Q.quantize_params(self.params, cfg.quant)
        self.model = config_from_params(self.params, num_heads=num_heads)
        kinds = cfg.kinds_for(self.model.num_layers)
        if kinds:
            # every kind reuses the block's attention weights, so any
            # checkpoint hosts any stack
            self.model = dataclasses.replace(
                self.model, window=cfg.window, layer_kinds=kinds).validate()
        if max(cfg.buckets) + cfg.max_new > self.model.max_len:
            raise MXNetError(
                "ServeConfig worst case %d (bucket %d + max_new %d) exceeds "
                "the model's max_len %d"
                % (max(cfg.buckets) + cfg.max_new, max(cfg.buckets),
                   cfg.max_new, self.model.max_len))
        self.cache = self._new_cache(self.model)
        # the recompile guards' names: the model and capacity, and the
        # options that change the graphs' inputs
        self._guard_prefix = (
            "InferenceSession(%dL-d%d-h%d-V%d-s%d-p%d-m%d-n%d)"
            % (self.model.num_layers, self.model.d_model,
               self.model.num_heads, self.model.vocab_size, cfg.slots,
               cfg.page_size, cfg.max_pages_per_slot, cfg.pool_pages))
        if cfg.spec_k:
            self._guard_prefix += "-k%d" % cfg.spec_k
        if cfg.quant:
            self._guard_prefix += "-q%s" % cfg.quant
        if cfg.kv_quant:
            self._guard_prefix += "-kv%s" % cfg.kv_quant
        if self.model.hybrid:
            self._guard_prefix += "-w%d%s" % (
                self.model.window, "".join(k[0] for k in self.model.kinds))
        self._slot_tokens = {}  # slot -> next token to feed the decoder
        self._slot_history = {}  # slot -> prompt + committed tokens
        self._spec_stats = {"verify_steps": 0, "slot_steps": 0,
                            "proposed": 0, "accepted": 0, "committed": 0}
        self._resolve_draft(draft_params, draft_num_heads)
        self._exes = self._build_executables()
        self.capture_s = self.graph_pool_bytes = None
        if self.device.type == "cuda":
            self.capture_s, self.graph_pool_bytes = _capture(
                list(self._exes.values()), self.device)

    @classmethod
    def from_checkpoint(cls, directory, prefix="model", epoch=None,
                        num_heads=None, config=None, device=None):
        """Restore params through the checkpoint manager and build a
        session on ``device`` (default: the card).  Any shard layout
        assembles here, the JAX package's files included; ``num_heads``
        is read from the saved symbol's ``MultiHeadAttention`` node when
        not given."""
        from ..checkpoint import CheckpointManager

        device = resolve_device(device, "InferenceSession.from_checkpoint")
        state = CheckpointManager(directory, prefix=prefix).load(
            epoch=epoch, device=device)
        if num_heads is None and state.symbol is not None:
            num_heads = _num_heads_from_symbol(state.symbol)
        if num_heads is None:
            raise MXNetError(
                "from_checkpoint: pass num_heads= (the checkpoint symbol "
                "does not record a MultiHeadAttention op)")
        return cls(_checkpoint_params(state), num_heads=num_heads,
                   config=config, device=device)

    def _new_cache(self, model):
        cfg = self.config
        return PagedKVCache(
            num_layers=model.num_layers,
            num_heads=model.num_heads,
            head_dim=model.head_dim,
            page_size=cfg.page_size,
            num_pages=cfg.pool_pages,
            slots=cfg.slots,
            max_pages_per_slot=cfg.max_pages_per_slot,
            table_pad=cfg.spec_pad_pages,
            prefix_pages=cfg.prefix_pages,
            kv_quant=cfg.kv_quant,
            device=self.device,
            layer_kinds=model.layer_kinds,
            window=model.window,
            ring_pages=cfg.ring_pages if "window" in model.kinds else 0)

    def _resolve_draft(self, draft_params, draft_num_heads):
        """Pick the speculative proposer — explicit params, the host-side
        n-gram lookup or a layer-truncated copy of the target — and build
        its mirrored cache."""
        cfg = self.config
        self.draft_params = None
        self.draft_model = None
        self.draft_cache = None
        self._draft_mode = "off"
        if not cfg.spec_k:
            if draft_params is not None:
                raise MXNetError(
                    "draft_params given but spec_k == 0 — set "
                    "ServeConfig.spec_k (MXNET_SERVE_SPEC_K) to enable "
                    "speculative decoding")
            return
        if draft_params is None:
            spec = cfg.draft or "ngram"
            if spec == "ngram":
                self._draft_mode = "ngram"
                return
            inherit = None
            if spec.startswith("layers:"):
                try:
                    n = int(spec.split(":", 1)[1])
                except ValueError:
                    raise MXNetError("ServeConfig.draft=%r: N of layers:N "
                                     "must be an integer" % (spec,)) \
                        from None
                draft_params = _layer_truncated(self.params, n)
                draft_num_heads = draft_num_heads or self.model.num_heads
                inherit = n
            else:
                # a checkpoint directory (prefix "model")
                from ..checkpoint import CheckpointManager

                state = CheckpointManager(spec).load(device=self.device)
                if draft_num_heads is None and state.symbol is not None:
                    draft_num_heads = _num_heads_from_symbol(state.symbol)
                draft_params = _checkpoint_params(state)
        else:
            inherit = None
        self._draft_mode = "model"
        # a layers:N draft shares the target's tensors (and quantized
        # records): same device, same dtype, so params_from_numpy hands
        # them back as they are, and quantize_params passes records through
        self.draft_params = params_from_numpy(draft_params, self.device)
        if cfg.quant:
            self.draft_params = Q.quantize_params(self.draft_params,
                                                  cfg.quant)
        self.draft_model = config_from_params(
            self.draft_params,
            num_heads=draft_num_heads or self.model.num_heads)
        if inherit is not None and self.model.hybrid:
            # a layers:N draft is the target's first N blocks: their kinds
            # and the window come with them
            dkinds = self.model.kinds[:inherit]
            if set(dkinds) != {"full"}:
                self.draft_model = dataclasses.replace(
                    self.draft_model, window=self.model.window,
                    layer_kinds=dkinds).validate()
        if "ssm" in self.draft_model.kinds:
            raise MXNetError(
                "draft model has SSM layers — a draft's speculative rows "
                "must roll back in O(1), and an SSM draft would need its own "
                "verify-synchronized state pool; put SSM layers above the "
                "draft depth or use the ngram draft")
        if self.draft_model.vocab_size != self.model.vocab_size:
            raise MXNetError(
                "draft vocab %d != target vocab %d — a draft must share "
                "the target's token space"
                % (self.draft_model.vocab_size, self.model.vocab_size))
        if max(cfg.buckets) + cfg.max_new > self.draft_model.max_len:
            raise MXNetError(
                "draft max_len %d cannot cover the serve worst case %d"
                % (self.draft_model.max_len,
                   max(cfg.buckets) + cfg.max_new))
        self.draft_cache = self._new_cache(self.draft_model)

    def _build_executables(self):
        """Every entry point the session runs, each over its own
        fixed-shape input buffers: tables start all-trash and lengths 0,
        so a warm-up call writes nothing but the trash page."""
        cfg, dev = self.config, self.device
        s, w = cfg.slots, cfg.spec_window
        i32, i64 = torch.int32, torch.int64

        def buf(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        def entry(fn, model, cache, params):
            pools = cache.pools()
            if cache.n_window:
                pools["ring_pages"] = cache.ring_pages
            return functools.partial(
                fn, params=params, cfg=model, page_size=cfg.page_size,
                exact=bool(cfg.exact), **pools)

        def step_inputs(cache, tokens_shape):
            return dict(tokens=buf(tokens_shape, i64),
                        lengths=buf((s,), i32),
                        tables=buf((s, cache.table_width), i32,
                                   cache.trash_page))

        def exe(name, fn, inputs):
            return _Executable(name, fn, inputs, registry.guard(
                "%s.%s" % (self._guard_prefix, name)))

        tgt = (self.model, self.cache, self.params)
        exes = {"decode": exe("decode", entry(decode_step, *tgt),
                              step_inputs(self.cache, (s,)))}
        for bucket in cfg.buckets:
            name = "prefill_%d" % bucket
            inputs = dict(
                tokens=buf((1, bucket), i64), length=buf((), i64, 1),
                offset=buf((), i64),
                table_row=buf((self.cache.table_width,), i32,
                              self.cache.trash_page))
            if self.cache.hybrid:  # rings and states are slot-indexed
                inputs["slot"] = buf((), i64)
            exes[name] = exe(name, entry(prefill_forward, *tgt), inputs)
        if cfg.spec_k:
            inputs = step_inputs(self.cache, (s, w))
            if self.cache.n_ssm:  # the commit caps the graph selects with
                inputs["limits"] = buf((s,), i32, 1)
            exes["verify"] = exe("verify", entry(verify_step, *tgt), inputs)
        if self._draft_mode == "model":
            inputs = step_inputs(self.draft_cache, (s, w))
            inputs["n_feed"] = buf((s,), i32)
            exes["draft"] = exe("draft", entry(
                draft_propose, self.draft_model, self.draft_cache,
                self.draft_params), inputs)
        return exes

    @property
    def executables(self):
        """name -> :class:`_Executable`: ``decode``, one ``prefill_<bucket>``
        per bucket, plus ``verify`` (and ``draft``, for a draft model)
        when ``spec_k > 0`` — fixed for the session's lifetime."""
        return dict(self._exes)

    def params_bytes_at_rest(self):
        """Bytes the serving params occupy as held: codes and scales
        under ``config.quant``, float32 otherwise."""
        return Q.at_rest_bytes(self.params)

    def dequantized_params(self):
        """The params as float32 tensors: for a quantized session exactly
        the weight values its kernels compute from the records (the
        oracle's params); a full-precision session's params as they
        are."""
        return Q.dequantize_params(self.params)

    def graph_report(self):
        """Capture seconds, the graphs' pool bytes, and per executable its
        replays and the kernel launches one replay makes (all ``None``
        and empty on the CPU, where nothing is captured)."""
        return dict(capture_s=self.capture_s,
                    graph_pool_bytes=self.graph_pool_bytes,
                    replays={n: e.replays for n, e in self._exes.items()},
                    launches_per_replay={n: dict(e.launches)
                                         for n, e in self._exes.items()})

    def guard_report(self):
        """name -> the executable's recompile-guard snapshot (calls,
        traces, signatures): one signature and one trace each, since every
        entry point takes fixed-shape buffers."""
        return {n: e.guard.snapshot() for n, e in self._exes.items()}

    # -- request lifecycle ------------------------------------------------
    def bucket_for(self, prompt_len):
        for b in self.config.buckets:
            if prompt_len <= b:
                return b
        raise MXNetError(
            "prompt of %d tokens exceeds the largest prefill bucket %d"
            % (prompt_len, max(self.config.buckets)))

    def try_alloc(self, prompt_len, max_new=None, tokens=None,
                  resume=False):
        """Reserve a slot for a request, or return ``None`` when the
        cache can't admit it right now.  ``tokens`` (the prompt's ids)
        enables the prefix-cache lookup; ``resume=True`` lifts the
        bucket-length check for a preempted request's re-prefill (chunked
        prefill covers it)."""
        if prompt_len < 1:
            raise MXNetError("empty prompt")
        if not resume:
            self.bucket_for(prompt_len)  # validates length
        max_new = self.config.max_new if max_new is None else int(max_new)
        if max_new > self.config.max_new:
            raise MXNetError("max_new %d exceeds the session cap %d"
                             % (max_new, self.config.max_new))
        toks = None
        if tokens is not None:
            toks = [int(t) for t in tokens]
            if len(toks) != int(prompt_len):
                raise MXNetError(
                    "try_alloc: tokens length %d != prompt_len %d"
                    % (len(toks), prompt_len))
        oversub = self.config.oversub
        slot = self.cache.alloc(prompt_len, max_new, tokens=toks,
                                oversub=oversub)
        if slot is not None and self.draft_cache is not None:
            # identical geometry and identical alloc/release/publish
            # sequences keep the two caches' free lists and prefix
            # indexes in lockstep
            dslot = self.draft_cache.alloc(prompt_len, max_new,
                                           tokens=toks, oversub=oversub)
            if dslot != slot or (self.draft_cache.cached_len(dslot)
                                 != self.cache.cached_len(slot)):
                raise MXNetError(
                    "draft cache desync: target slot %r (cached %d) vs "
                    "draft slot %r (cached %d)"
                    % (slot, self.cache.cached_len(slot), dslot,
                       self.draft_cache.cached_len(dslot)
                       if dslot is not None else -1))
        return slot

    def _chunk_bucket(self, remaining):
        """Bucket for one prefill chunk: the smallest that fits, else the
        largest (a further chunk follows at a page-aligned offset)."""
        for b in self.config.buckets:
            if remaining <= b:
                return b
        return max(self.config.buckets)

    def prefill(self, slot, prompt_tokens):
        """Run the bucketed prefill for ``slot``; returns
        ``(first_token, last_logits)`` with the logits as a numpy array.

        Only the uncached suffix is computed (positions covered by prefix
        hits are skipped), in page-aligned chunks; afterwards the slot's
        full prompt pages are published into the prefix index, and a
        draft model ingests the prompt into its own cache."""
        prompt = np.asarray(prompt_tokens, np.int64).reshape(-1)
        p = int(prompt.shape[0])
        cached = self.cache.cached_len(slot)
        if not 0 <= cached < p:
            raise MXNetError("prefill: cached prefix %d outside prompt "
                             "of %d tokens" % (cached, p))
        if self.config.kv_quant:
            # chaos site: a fault here fails this request before any of
            # its quantized pages or scale rows is written
            faults.inject("kv_quant")
        if self.cache.n_window:
            # chaos site: before any ring row is written, so survivors'
            # rings (and this slot's next request) stay consistent
            faults.inject("kv_window")
        extra = {"slot": slot} if self.cache.hybrid else {}
        off = cached
        while off < p:
            bucket = self._chunk_bucket(p - off)
            n = min(p - off, bucket)
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :n] = prompt[off:off + n]
            self.cache.ensure_writable(slot, off, n)
            first, last_logits = self._exes["prefill_%d" % bucket](
                tokens=toks, length=n, offset=off,
                table_row=self.cache.table_row(slot), **extra)
            off += n
            self.cache.lengths[slot] = off
        first = int(first)
        last_logits = last_logits.cpu().numpy()
        prompt_list = [int(t) for t in prompt]
        self._slot_tokens[slot] = first
        self._slot_history[slot] = prompt_list + [first]
        self.cache.register_prefix(slot, prompt_list)
        if self._draft_mode == "model":
            self._draft_ingest(slot, prompt)
            self.draft_cache.register_prefix(slot, prompt_list)
        return first, last_logits

    def _draft_ingest(self, slot, prompt):
        """Teacher-force the prompt through the draft executable in
        W-token chunks, so that the draft cache holds the positions the
        target prefill just wrote.  Rows a chunk writes past its feed,
        and the rows written for the other slots (``n_feed`` 0), lie
        beyond each slot's committed length: the next draft call
        overwrites them before any horizon admits them.  Prefix hits skip
        ingestion: the draft's hit pages already hold draft KV for the
        same chain, and alloc left the length at the cached prefix."""
        cfg = self.config
        w = cfg.spec_window
        p = int(prompt.shape[0])
        cached = self.draft_cache.cached_len(slot)
        self.draft_cache.ensure_writable(slot, cached, p - cached)
        for off in range(cached, p, w):
            chunk = prompt[off:off + w]
            toks = np.zeros((cfg.slots, w), np.int64)
            toks[slot, :len(chunk)] = chunk
            n_feed = np.zeros((cfg.slots,), np.int32)
            n_feed[slot] = len(chunk)
            self._exes["draft"](tokens=toks, n_feed=n_feed,
                                lengths=self.draft_cache.device_lengths(),
                                tables=self.draft_cache.device_tables())
            self.draft_cache.lengths[slot] = off + len(chunk)

    def step(self):
        """Advance every active slot one token with the decode step;
        returns ``(tokens, logits)`` where ``tokens`` maps slot -> emitted
        token id and ``logits`` is the (slots, vocab) numpy array
        (inactive rows are garbage by design)."""
        cfg = self.config
        self._pre_dispatch(1)
        tokens = np.zeros((cfg.slots,), np.int64)
        for slot, tok in self._slot_tokens.items():
            tokens[slot] = tok
        next_toks, logits = self._exes["decode"](
            tokens=tokens, lengths=self.cache.device_lengths(),
            tables=self.cache.device_tables())
        next_np = next_toks.cpu().numpy()
        logits = logits.cpu().numpy()
        out = {}
        for slot in list(self._slot_tokens):
            self.cache.lengths[slot] += 1
            tok = int(next_np[slot])
            self._slot_tokens[slot] = tok
            if slot in self._slot_history:
                self._slot_history[slot].append(tok)
            out[slot] = tok
        return out, logits

    def spec_step(self, limits=None):
        """One speculative step for every active slot: the draft proposes
        K tokens, one verify runs all ``W = K + 1`` rows through the
        target, and greedy acceptance commits the longest agreeing prefix
        (1..W tokens — at least the target's own next token).

        ``limits`` (slot -> int) caps the tokens a slot may commit this
        step (the scheduler passes ``max_new - emitted``).  Returns slot
        -> ``[committed tokens]``, the tokens the same number of
        :meth:`step` calls would emit.  Both caches advance ``W`` rows
        and roll the rejected suffix back with
        :meth:`PagedKVCache.truncate`, so their lengths stay equal and
        every kept row belongs to a committed token."""
        cfg = self.config
        if not cfg.spec_k:
            raise MXNetError("spec_step on a session with spec_k == 0 — "
                             "set MXNET_SERVE_SPEC_K / ServeConfig.spec_k")
        out = {}
        if not self._slot_tokens:
            return out
        w, k = cfg.spec_window, cfg.spec_k
        active = sorted(self._slot_tokens)
        self._pre_dispatch(w)
        tokens = np.zeros((cfg.slots, w), np.int64)
        for slot, tok in self._slot_tokens.items():
            tokens[slot, 0] = tok
        if self._draft_mode == "model":
            proposals = self._exes["draft"](
                tokens=tokens, n_feed=np.ones((cfg.slots,), np.int32),
                lengths=self.draft_cache.device_lengths(),
                tables=self.draft_cache.device_tables())
            tokens[:, 1:] = proposals[:, :k].cpu().numpy()
        else:
            for slot in active:
                tokens[slot, 1:] = self._ngram_propose(slot, k)
        caps = {}
        for slot in active:
            caps[slot] = w
            if limits is not None:
                caps[slot] = max(1, min(w, int(limits.get(slot, w))))
        extra = {}
        if self.cache.n_ssm:
            # the caps ride into the graph, whose acceptance count must be
            # the loop's below to commit the right SSM state (an idle
            # slot's state is garbage until alloc zeroes it)
            lim = np.ones((cfg.slots,), np.int32)
            for slot, cap in caps.items():
                lim[slot] = cap
            extra["limits"] = lim
        greedy, _ = self._exes["verify"](
            tokens=tokens, lengths=self.cache.device_lengths(),
            tables=self.cache.device_tables(), **extra)
        greedy = greedy.cpu().numpy()
        self._spec_stats["verify_steps"] += 1
        for slot in active:
            limit = caps[slot]
            # commit greedy[:c]: row 0 unconditionally, then one more
            # per proposal the target's previous row agreed with
            c = 1
            while c < limit and tokens[slot, c] == greedy[slot, c - 1]:
                c += 1
            committed = [int(t) for t in greedy[slot, :c]]
            for cache in (self.cache, self.draft_cache):
                if cache is not None:
                    cache.lengths[slot] += w
                    cache.truncate(slot, w - c)
            self._slot_tokens[slot] = committed[-1]
            self._slot_history[slot].extend(committed)
            # proposals past the commit limit never had a chance, so
            # they don't count against the draft's acceptance rate
            self._spec_stats["slot_steps"] += 1
            self._spec_stats["proposed"] += limit - 1
            self._spec_stats["accepted"] += c - 1
            self._spec_stats["committed"] += c
            out[slot] = committed
        return out

    def _ngram_propose(self, slot, k, max_n=3):
        """Prompt-lookup draft: match the longest suffix n-gram of the
        slot's history (prompt + committed tokens, ending at the pending
        feed token) against an earlier occurrence and propose its
        continuation; a short continuation pads with its last token, and
        no match proposes the last token K times."""
        hist = self._slot_history.get(slot) or [0]
        for n in range(min(max_n, len(hist) - 1), 0, -1):
            pat = hist[-n:]
            for start in range(len(hist) - n - 1, -1, -1):
                if hist[start:start + n] == pat:
                    cont = hist[start + n:start + n + k]
                    if cont:
                        out = list(cont)
                        while len(out) < k:
                            out.append(out[-1])
                        return out
        return [hist[-1]] * k

    def spec_report(self):
        """Speculation counters: ``acceptance_rate`` = accepted /
        proposed (proposals with a chance to commit), and
        ``tokens_per_verify_step`` = committed tokens per slot per
        verify (1..K+1)."""
        rep = dict(self._spec_stats)
        rep["acceptance_rate"] = (
            rep["accepted"] / float(rep["proposed"])
            if rep["proposed"] else 0.0)
        rep["tokens_per_verify_step"] = (
            rep["committed"] / float(rep["slot_steps"])
            if rep["slot_steps"] else 0.0)
        return rep

    def _pre_dispatch(self, rows):
        """Page upkeep before a step writes ``rows`` KV rows per active
        slot, in both caches: grow oversubscribed slots to cover them (a
        no-op under reservation) and cross the copy-on-write guard."""
        for slot in sorted(self._slot_tokens):
            for cache in (self.cache, self.draft_cache):
                if cache is None:
                    continue
                n = int(cache.lengths[slot])
                if self.config.oversub:
                    cache.append_pages(slot, n + rows)
                cache.ensure_writable(slot, n, rows)

    def pages_short(self, rows=None):
        """Fresh pages the next decode boundary must obtain across all
        active slots — the scheduler's preemption probe.  ``rows``
        defaults to the step's width (1, or the speculative window)."""
        if rows is None:
            rows = self.config.spec_window if self.config.spec_k else 1
        return sum(self.cache.pages_short(slot,
                                          int(self.cache.lengths[slot])
                                          + rows)
                   for slot in self._slot_tokens)

    def release(self, slot):
        self._slot_tokens.pop(slot, None)
        self._slot_history.pop(slot, None)
        self.cache.release(slot)
        if self.draft_cache is not None:
            self.draft_cache.release(slot)

    def active_slots(self):
        return sorted(self._slot_tokens)

    def reset_cold(self):
        """Return the session to a just-built state (a replica's rejoin
        after a supervisor eject): every slot released and the prefix
        index dropped, so the replica re-enters rotation cold and warms
        its cache from live traffic.  The captured graphs hold no
        request state and stay valid: the next replay reads the tables
        and lengths a new request writes."""
        for slot in list(self._slot_tokens):
            try:
                self.release(slot)
            except MXNetError:
                pass
        self.cache.drop_prefix_index()
        if self.draft_cache is not None:
            self.draft_cache.drop_prefix_index()

    def state_report(self):
        """Occupancy snapshot for leak assertions: active and free
        slots, free pages, retained published-prefix pages (they survive
        a release by design), the draft cache in lockstep, and
        ``pool_bytes`` (fixed buffers: it never moves)."""
        out = {
            "active_slots": self.active_slots(),
            "free_slots": self.cache.free_slots,
            "free_pages": self.cache.free_pages,
            "retained_pages": self.cache.retained_pages,
            "pool_bytes": self.cache.pool_bytes(),
        }
        if self.draft_cache is not None:
            out["draft_free_slots"] = self.draft_cache.free_slots
            out["draft_free_pages"] = self.draft_cache.free_pages
        return out

    def memory_analysis(self, name="decode"):
        """The JAX session's ``memory_analysis`` keys that have a
        counterpart for one entry point: ``argument_size_in_bytes``, the
        graph's fixed input buffers; ``output_size_in_bytes``, its
        output buffers; ``temp_size_in_bytes``, the growth of the
        session's graph pool when this entry was captured.  XLA's
        ``generated_code_size_in_bytes`` has none (a graph replays
        kernels loaded once per process).  On the CPU nothing is
        captured: the outputs are the last call's, and temp is 0."""
        exe = self._exes[name]

        def nbytes(tree):
            if torch.is_tensor(tree):
                return tree.numel() * tree.element_size()
            if isinstance(tree, dict):
                return sum(nbytes(v) for v in tree.values())
            if isinstance(tree, (list, tuple)):
                return sum(nbytes(v) for v in tree)
            return 0

        return {"argument_size_in_bytes": nbytes(exe.inputs),
                "output_size_in_bytes": nbytes(exe.outputs),
                "temp_size_in_bytes": int(exe.pool_bytes)}

    def fallback_count(self):
        """Calls that left the frozen executables: 0 by construction.
        The JAX session falls back to a lazy jit on an aval drift; an
        entry point here takes only its own buffers' shapes and raises
        on any other (``_Executable.__call__``), because a replay over
        wrong-shaped buffers has no eager stand-in on the card."""
        return 0


def _checkpoint_params(state):
    """The serving params of a loaded checkpoint: its arg and aux
    arrays, as the tensors the NDArrays hold."""
    params = {k: getattr(v, "_data", v)
              for k, v in state.arg_params.items()}
    params.update({k: getattr(v, "_data", v)
                   for k, v in (state.aux_params or {}).items()})
    return params


def _num_heads_from_symbol(symbol):
    """``num_heads`` of a saved symbol's MultiHeadAttention node, if the
    checkpoint recorded one."""
    try:
        graph = json.loads(symbol.tojson())
    except Exception:  # an unserialisable symbol records nothing
        return None
    for node in graph.get("nodes", []):
        op = (node.get("op") or "").lower()
        if "multiheadattention" in op.replace("_", ""):
            attrs = node.get("attrs") or node.get("param") or {}
            if "num_heads" in attrs:
                try:
                    return int(attrs["num_heads"])
                except (TypeError, ValueError):
                    pass
    return None


def _layer_truncated(params, n):
    """A draft from the target's own weights: its first ``n`` decoder
    blocks plus the shared embedding, final LayerNorm and head (the
    self-speculative "layer skip" draft).  ``n`` equal to the full depth
    gives the identity draft, which accepts every proposal."""
    total = 0
    while "blk%d_attn_in_weight" % total in params:
        total += 1
    n = int(n)
    if not 1 <= n <= total:
        raise MXNetError(
            "draft layers:%d out of range (target has %d blocks)"
            % (n, total))
    keep = {"tok_embed_weight", "pos_embed", "final_ln_gamma",
            "final_ln_beta", "lm_head_weight", "lm_head_bias"}
    out = {}
    for key, val in params.items():
        if key in keep or (key.startswith("blk")
                           and int(key[3:].split("_", 1)[0]) < n):
            out[key] = val
    return out
