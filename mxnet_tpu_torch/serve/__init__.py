"""mxnet_tpu_torch.serve — the serving runtime on PyTorch and CUDA.

Continuous batching over bucketed prefill, one decode step and
speculative decoding (a draft's proposals checked by one verify step), on
a paged KV cache whose pages the hand-written attention kernel reads
directly; on the card every entry point runs as a CUDA graph captured
once.  Counterpart of ``mxnet_tpu/serve``; the supervisor and the HTTP
gateway are later slices of the port.
"""
from .kv_cache import PagedKVCache
from .model import ModelConfig, config_from_params, decode_step, \
    draft_propose, full_forward, init_params, params_from_numpy, \
    prefill_forward, reference_last_logits, verify_step
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
    "draft_propose",
    "full_forward",
    "init_params",
    "params_from_numpy",
    "prefill_forward",
    "reference_last_logits",
    "summarize",
    "verify_step",
]
