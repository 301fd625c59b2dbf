"""InferenceSession: bucketed prefill and one decode step over the paged
KV cache.

Counterpart of ``mxnet_tpu/serve/session.py``.  The JAX session compiles
one prefill executable per sequence-length bucket plus one fixed-shape
decode executable up front; PyTorch runs eagerly, so here the same set
is a table of entry points under the same names (``sess.executables``:
``decode``, ``prefill_<bucket>``), each running the hand-written kernels
of ``csrc/`` on the card: K3 for every projection, K2 for attention over
the pages.  A failing call raises — there is no silent retry.

Prefix caching (``prefix_pages``), chunked prefill at page-aligned
offsets, and oversubscription with on-demand page growth carry over
from the JAX session unchanged; they are host bookkeeping around the
same two functions.  Speculative decoding, hybrid window/SSM stacks,
weight and KV quantization, autotune and checkpoint loading are ported
in later slices: their ``ServeConfig`` fields raise.

Env knobs: ``MXNET_SERVE_SLOTS``, ``MXNET_SERVE_PAGE``,
``MXNET_SERVE_BUCKETS``, ``MXNET_SERVE_MAX_NEW``, ``MXNET_SERVE_PAGES``,
``MXNET_SERVE_EXACT``, ``MXNET_SERVE_PREFIX_PAGES``,
``MXNET_SERVE_OVERSUB``, ``MXNET_SERVE_WATERMARK``,
``MXNET_SERVE_TTFT_SLO_MS`` — the JAX package's names.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..base import MXNetError, get_env, later_slice, resolve_device
from .kv_cache import PagedKVCache
from .model import config_from_params, decode_step, exact_mode, \
    params_from_numpy, prefill_forward

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
    capacity for ``slots`` worst-case requests).  ``spec_k``, ``draft``,
    ``quant``, ``kv_quant``, ``window`` and ``layers`` keep the JAX
    package's fields; any value but the default is a later slice of the
    port and raises, naming the field.
    """

    slots: int = 4
    page_size: int = 16
    buckets: tuple = (16, 32, 64)
    max_new: int = 32
    num_pages: int = 0  # 0 = slots * max_pages_per_slot
    exact: bool = True
    spec_k: int = 0
    draft: str = ""
    quant: str = ""
    kv_quant: str = ""
    prefix_pages: int = 0  # 0 = prefix cache off; -1 = unbounded retention
    oversub: bool = False  # admit by current need, grow on demand
    watermark: int = 0  # free-pool floor that triggers preemption
    ttft_slo_ms: float = 0.0  # 0 = no TTFT budget (SLO admission off)
    window: int = 0
    layers: str = ""

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
        for name in ("spec_k", "draft", "quant", "kv_quant", "window"):
            val = getattr(self, name)
            if val:
                raise later_slice("ServeConfig.%s" % name, val)
        kinds = {t.strip() for t in self.layers.replace(";", ",").split(",")
                 if t.strip()}
        if kinds - {"full"}:
            raise later_slice("ServeConfig.layers", self.layers)
        if self.slots < 1 or self.page_size < 1 or self.max_new < 1:
            raise MXNetError("ServeConfig: slots/page_size/max_new must "
                             "be >= 1")
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

    @property
    def max_pages_per_slot(self):
        worst = max(self.buckets) + self.max_new
        return -(-worst // self.page_size)

    @property
    def pool_pages(self):
        return self.num_pages or self.slots * self.max_pages_per_slot


class InferenceSession(object):
    """Serving session for the built-in transformer LM.

    ``params`` is a flat name -> array dict (numpy arrays or tensors)
    under the training parameter names; it is held as float32 on
    ``device`` (default: the card — without one, pass ``device="cpu"``).
    """

    def __init__(self, params, num_heads, config=None, device=None):
        self.device = resolve_device(device, "InferenceSession")
        self.config = config or ServeConfig.from_env()
        cfg = self.config
        self.params = params_from_numpy(params, self.device)
        self.model = config_from_params(self.params, num_heads=num_heads)
        if max(cfg.buckets) + cfg.max_new > self.model.max_len:
            raise MXNetError(
                "ServeConfig worst case %d (bucket %d + max_new %d) exceeds "
                "the model's max_len %d"
                % (max(cfg.buckets) + cfg.max_new, max(cfg.buckets),
                   cfg.max_new, self.model.max_len))
        self.cache = PagedKVCache(
            num_layers=self.model.num_layers,
            num_heads=self.model.num_heads,
            head_dim=self.model.head_dim,
            page_size=cfg.page_size,
            num_pages=cfg.pool_pages,
            slots=cfg.slots,
            max_pages_per_slot=cfg.max_pages_per_slot,
            prefix_pages=cfg.prefix_pages,
            device=self.device)
        self._slot_tokens = {}  # slot -> next token to feed the decoder
        static = dict(cfg=self.model, page_size=cfg.page_size,
                      exact=bool(cfg.exact))
        self._exes = {"decode": functools.partial(decode_step, **static)}
        for bucket in cfg.buckets:
            self._exes["prefill_%d" % bucket] = functools.partial(
                prefill_forward, **static)

    @property
    def executables(self):
        """name -> entry point: ``decode`` plus one ``prefill_<bucket>``
        per bucket, fixed for the session's lifetime."""
        return dict(self._exes)

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
        return self.cache.alloc(prompt_len, max_new, tokens=toks,
                                oversub=self.config.oversub)

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
        full prompt pages are published into the prefix index."""
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        p = int(prompt.shape[0])
        cached = self.cache.cached_len(slot)
        if not 0 <= cached < p:
            raise MXNetError("prefill: cached prefix %d outside prompt "
                             "of %d tokens" % (cached, p))
        first = last_logits = None
        off = cached
        while off < p:
            bucket = self._chunk_bucket(p - off)
            n = min(p - off, bucket)
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :n] = prompt[off:off + n]
            self.cache.ensure_writable(slot, off, n)
            first, last_logits = self._exes["prefill_%d" % bucket](
                self.params, torch.from_numpy(toks).to(self.device), n, off,
                self.cache.table_row(slot), self.cache.k_pool,
                self.cache.v_pool)
            off += n
            self.cache.lengths[slot] = off
        first = int(first)
        self._slot_tokens[slot] = first
        self.cache.register_prefix(slot, [int(t) for t in prompt])
        return first, last_logits.cpu().numpy()

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
            self.params, torch.from_numpy(tokens).to(self.device),
            self.cache.device_lengths(), self.cache.device_tables(),
            self.cache.k_pool, self.cache.v_pool)
        next_np = next_toks.cpu().numpy()
        out = {}
        for slot in list(self._slot_tokens):
            self.cache.lengths[slot] += 1
            tok = int(next_np[slot])
            self._slot_tokens[slot] = tok
            out[slot] = tok
        return out, logits.cpu().numpy()

    def _pre_dispatch(self, rows):
        """Page upkeep before a step writes ``rows`` KV rows per active
        slot: grow oversubscribed slots to cover them (a no-op under
        reservation) and cross the copy-on-write guard."""
        for slot in sorted(self._slot_tokens):
            n = int(self.cache.lengths[slot])
            if self.config.oversub:
                self.cache.append_pages(slot, n + rows)
            self.cache.ensure_writable(slot, n, rows)

    def pages_short(self, rows=1):
        """Fresh pages the next decode boundary must obtain across all
        active slots — the scheduler's preemption probe."""
        return sum(self.cache.pages_short(slot,
                                          int(self.cache.lengths[slot])
                                          + rows)
                   for slot in self._slot_tokens)

    def release(self, slot):
        self._slot_tokens.pop(slot, None)
        self.cache.release(slot)

    def active_slots(self):
        return sorted(self._slot_tokens)
