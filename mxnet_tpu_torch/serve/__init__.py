"""mxnet_tpu_torch.serve — the serving runtime on PyTorch and CUDA.

Continuous batching over bucketed prefill and one decode step, on a paged
KV cache whose pages the hand-written attention kernel reads directly.
Counterpart of ``mxnet_tpu/serve``; the supervisor and the HTTP gateway
are later slices of the port.
"""
from .kv_cache import PagedKVCache
from .model import ModelConfig, config_from_params, decode_step, \
    full_forward, init_params, params_from_numpy, prefill_forward, \
    reference_last_logits
from .scheduler import Request, Scheduler, ServeCancelled, summarize
from .session import InferenceSession, ServeConfig

__all__ = [
    "InferenceSession",
    "ModelConfig",
    "PagedKVCache",
    "Request",
    "Scheduler",
    "ServeCancelled",
    "ServeConfig",
    "config_from_params",
    "decode_step",
    "full_forward",
    "init_params",
    "params_from_numpy",
    "prefill_forward",
    "reference_last_logits",
    "summarize",
]
