"""Random samplers.

Counterpart of ``mxnet_tpu/ops/random_ops.py`` (reference
``src/operator/random/sample_op.cc``, ``multisample_op.cc`` and
``sample_multinomial_op.cc``): the ``random_*`` samplers with global
parameters (and their ``_sample_*`` and short aliases), the ``sample_*``
samplers with one distribution a row of their parameter tensors,
``sample_multinomial`` (with ``get_prob``) and ``shuffle``.

Every op declares ``needs_rng`` and draws from the ``torch.Generator``
the invoke layer hands it (``random.next_key(ctx)``), on the device of
its output, so a seed replays the same draws there.  The two packages
draw from different generators: the distributions, shapes and dtypes are
the JAX package's, the values are not.  Shape inference runs the ops
with no generator on ``meta`` tensors.
"""
from __future__ import annotations

import torch

from .matrix_ops import _device, _dtype
from .registry import register


def _draw(rng, attrs):
    """(device, generator keyword) of a draw."""
    if rng is None:
        return _device(attrs), {}
    return rng.device, {"generator": rng}


def _shape(attrs):
    return tuple(int(s) for s in attrs.get("shape", ()))


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws, one per element of the tensor ``alpha``."""
    return torch._standard_gamma(alpha, **gen)


def _poisson(lam, gen):
    return torch.poisson(lam, **gen)


@register("random_uniform", aliases=("_sample_uniform", "uniform"),
          needs_rng=True)
def _uniform(attrs, rng):
    dev, gen = _draw(rng, attrs)
    low, high = float(attrs.get("low", 0.0)), float(attrs.get("high", 1.0))
    u = torch.rand(_shape(attrs), dtype=_dtype(attrs), device=dev, **gen)
    return u * (high - low) + low


@register("random_normal", aliases=("_sample_normal", "normal"),
          needs_rng=True)
def _normal(attrs, rng):
    dev, gen = _draw(rng, attrs)
    return (float(attrs.get("loc", 0.0)) + float(attrs.get("scale", 1.0))
            * torch.randn(_shape(attrs), dtype=_dtype(attrs), device=dev,
                          **gen))


@register("random_gamma", aliases=("_sample_gamma",), needs_rng=True)
def _random_gamma(attrs, rng):
    dev, gen = _draw(rng, attrs)
    alpha = torch.full(_shape(attrs), float(attrs.get("alpha", 1.0)),
                       dtype=_dtype(attrs), device=dev)
    return _gamma(alpha, gen) * float(attrs.get("beta", 1.0))


@register("random_exponential", aliases=("_sample_exponential",),
          needs_rng=True)
def _random_exponential(attrs, rng):
    dev, gen = _draw(rng, attrs)
    e = torch.empty(_shape(attrs), dtype=_dtype(attrs), device=dev)
    return e.exponential_(1.0, **gen) / float(attrs.get("lam", 1.0))


@register("random_poisson", aliases=("_sample_poisson",), needs_rng=True)
def _random_poisson(attrs, rng):
    dev, gen = _draw(rng, attrs)
    lam = torch.full(_shape(attrs), float(attrs.get("lam", 1.0)),
                     dtype=torch.float32, device=dev)
    return _poisson(lam, gen).to(_dtype(attrs))


@register("random_negative_binomial", aliases=("_sample_negbinomial",),
          needs_rng=True)
def _neg_binomial(attrs, rng):
    """Failures before ``k`` successes of probability ``p``: a Poisson of
    a Gamma(k) rate scaled by (1 - p) / p."""
    dev, gen = _draw(rng, attrs)
    k, p = float(attrs.get("k", 1)), float(attrs.get("p", 1.0))
    alpha = torch.full(_shape(attrs), k, dtype=torch.float32, device=dev)
    lam = _gamma(alpha, gen) * (1 - p) / p
    return _poisson(lam, gen).to(_dtype(attrs))


@register("random_generalized_negative_binomial",
          aliases=("_sample_gennegbinomial",), needs_rng=True)
def _gen_neg_binomial(attrs, rng):
    """Mean ``mu``, dispersion ``alpha``: a Poisson of a Gamma(1 / alpha)
    rate scaled by mu alpha."""
    dev, gen = _draw(rng, attrs)
    mu, alpha = float(attrs.get("mu", 1.0)), float(attrs.get("alpha", 1.0))
    shape = torch.full(_shape(attrs), 1.0 / alpha, dtype=torch.float32,
                       device=dev)
    lam = _gamma(shape, gen) * (mu * alpha)
    return _poisson(lam, gen).to(_dtype(attrs))


# --- per-row-parameter samplers (reference multisample_op.cc) --------------

def _msample(fn):
    """A sampler with one distribution an element of its parameter
    tensors: the output is ``params[0].shape + shape``, float32."""
    def compute(attrs, rng, *params):
        out_shape = tuple(params[0].shape) + _shape(attrs)
        gen = {} if rng is None else {"generator": rng}
        tail = (1,) * len(_shape(attrs))
        return fn(gen, out_shape, params[0].device,
                  *(p.float().reshape(tuple(p.shape) + tail)
                    for p in params))
    return compute


def _rand(shape, dev, gen):
    return torch.rand(shape, device=dev, **gen)


register("sample_uniform", _msample(
    lambda gen, s, dev, low, high: _rand(s, dev, gen) * (high - low) + low),
    needs_rng=True)
register("sample_normal", _msample(
    lambda gen, s, dev, mu, sigma: mu + sigma * torch.randn(
        s, device=dev, **gen)), needs_rng=True)
register("sample_gamma", _msample(
    lambda gen, s, dev, alpha, beta: _gamma(alpha.expand(s).contiguous(),
                                            gen) * beta), needs_rng=True)
register("sample_exponential", _msample(
    lambda gen, s, dev, lam: torch.empty(s, device=dev).exponential_(
        1.0, **gen) / lam), needs_rng=True)
register("sample_poisson", _msample(
    lambda gen, s, dev, lam: _poisson(lam.expand(s).contiguous(), gen)),
    needs_rng=True)


@register("sample_multinomial", aliases=("_sample_multinomial",),
          needs_rng=True)
def _multinomial(attrs, rng, data):
    """``n`` (the product of ``shape``) draws from each row of
    probabilities ``data``, as ``dtype`` (int32) codes, shaped
    ``data.shape[:-1] + (n,)`` (``(n,)`` dropped when n is 1); with
    ``get_prob`` also each draw's log-probability."""
    n = 1
    for s in _shape(attrs):
        n *= s if s else 1
    probs = torch.clamp_min(data.float(), 1e-37)
    rows = probs.reshape(-1, probs.shape[-1])
    gen = {} if rng is None else {"generator": rng}
    if data.is_meta:
        idx = torch.empty((rows.shape[0], n), dtype=torch.int64,
                          device="meta")
    else:
        idx = torch.multinomial(rows, n, replacement=True, **gen)
    idx = idx.reshape(tuple(data.shape[:-1]) + (n,))
    if n == 1:
        idx = idx[..., 0]
    out = idx.to(_dtype(attrs, "int32"))
    if bool(attrs.get("get_prob", False)):
        logp = torch.log_softmax(torch.log(probs), dim=-1)
        got = torch.gather(logp, -1, idx[..., None] if n == 1 else idx)
        return out, got.reshape(out.shape)
    return out


@register("shuffle", aliases=("_shuffle",), needs_rng=True)
def _shuffle(attrs, rng, data):
    """The rows of ``data`` (axis 0) in a random order."""
    gen = {} if rng is None else {"generator": rng}
    perm = torch.randperm(data.shape[0], device=data.device, **gen)
    return data[perm]
