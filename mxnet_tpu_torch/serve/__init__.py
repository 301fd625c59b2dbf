"""mxnet_tpu_torch.serve — the serving runtime on PyTorch and CUDA.

Continuous batching over bucketed prefill, one decode step and
speculative decoding (a draft's proposals checked by one verify step), on
a paged KV cache whose pages the hand-written attention kernel reads
directly; on the card every entry point runs as a CUDA graph captured
once.  N replicas run behind :class:`ReplicaSet` (failover, load
shedding, a circuit breaker, cold rejoin) and reach the network through
:class:`Gateway` (HTTP/SSE).  Counterpart of ``mxnet_tpu/serve``.
"""
from .gateway import Gateway
from .kv_cache import PagedKVCache
from .model import ModelConfig, config_from_params, decode_step, \
    draft_propose, full_forward, init_params, params_from_numpy, \
    prefill_forward, reference_last_logits, verify_step
from .scheduler import Request, Scheduler, ServeCancelled, summarize
from .session import InferenceSession, ServeConfig
from .supervisor import ReplicaSet, ServeOverloaded, ServeUnavailable

__all__ = [
    "Gateway",
    "InferenceSession",
    "ModelConfig",
    "PagedKVCache",
    "ReplicaSet",
    "Request",
    "Scheduler",
    "ServeCancelled",
    "ServeConfig",
    "ServeOverloaded",
    "ServeUnavailable",
    "config_from_params",
    "decode_step",
    "draft_propose",
    "full_forward",
    "init_params",
    "params_from_numpy",
    "prefill_forward",
    "reference_last_logits",
    "summarize",
    "verify_step",
]
