"""Global random state.

Counterpart of ``mxnet_tpu/random.py`` (reference ``mx.random.seed``).
The JAX package splits ``jax.random`` keys off one chain; here
:func:`next_key` hands out a fresh ``torch.Generator`` seeded from one
counter-advanced chain, on the device of the context asked for.  The two
packages' random streams differ by construction: tests feed both the
same numpy-made inputs.
"""
from __future__ import annotations

import threading

__all__ = ["seed", "next_key", "current_seed"]

_state = threading.local()
_DEFAULT_SEED = 0


def _get():
    if not hasattr(_state, "seed_value"):
        _state.seed_value = _DEFAULT_SEED
        _state.counter = 0
    return _state


def seed(seed_state):
    """Seed all random generators (reference ``mx.random.seed``)."""
    st = _get()
    st.seed_value = int(seed_state)
    st.counter = 0


def current_seed():
    return _get().seed_value


def next_key(ctx=None):
    """A fresh ``torch.Generator`` on ``ctx``'s device (default: the
    current context), seeded as a pure function of (seed, draw count)."""
    import torch

    from .context import current_context

    st = _get()
    st.counter += 1
    device = (ctx or current_context()).torch_device
    gen = torch.Generator(device=device)
    gen.manual_seed((st.seed_value * 1000003 + st.counter) % (2 ** 63))
    return gen
