"""Weight initializers (reference ``python/mxnet/initializer.py``).

Counterpart of ``mxnet_tpu/initializer.py``: the reference's dispatch by
name pattern through :class:`InitDesc` (``*_weight`` -> the
initializer's rule, ``*_gamma`` -> 1, ``*_beta``/``*_bias``/
``*moving_mean`` -> 0, ``*moving_var`` -> 1) and by a variable's
``__init__`` attribute.  Draws come from an explicit CPU
``torch.Generator`` per parameter, seeded as a pure function of
(``mx.random`` seed, parameter name), so a value does not depend on the
order of initialization or on the device; they differ from the JAX
package's numpy draws, so tests carry one state across instead.
``Bilinear`` and ``LSTMBias`` draw nothing and equal the JAX package's;
``Load`` and ``Mixed`` route parameters to saved arrays and to
initializers by name pattern.
"""
from __future__ import annotations

import json
import math
import re
import zlib

import numpy as np

from .base import MXNetError, _Registry
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Constant",
           "Zero", "One", "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear",
           "LSTMBias", "Load", "Mixed", "register", "create"]

_registry = _Registry("initializer")


def _param_gen(desc):
    """The CPU generator of one parameter."""
    import torch

    h = zlib.crc32(str(desc).encode("utf-8"))
    gen = torch.Generator()
    gen.manual_seed((_random.current_seed() * 1000003 + h) % (2 ** 31))
    return gen


def register(klass):
    _registry.register(klass.__name__.lower(), klass)
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    if isinstance(name, (list, tuple)):
        # the decoded dumps() form, as a Symbol's JSON round trip gives it
        return _registry.get(str(name[0]).lower())(**(name[1] or {}))
    name = str(name)
    if name.startswith("["):
        decoded = json.loads(name)
        return _registry.get(decoded[0].lower())(**decoded[1])
    return _registry.get(name.lower())(**kwargs)


class InitDesc(str):
    """Name + attrs descriptor (reference ``InitDesc``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Dispatch on the parameter name's suffix, like the reference
    ``Initializer.__call__``; ``arr`` is an NDArray, written by rebinding
    (``arr[:] = values``)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """'["name", {kwargs}]' (reference ``Initializer.dumps``)."""
        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        init = desc.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("upsampling"):
            self._init_bilinear(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith(("moving_mean", "running_mean")):
            self._init_zero(desc, arr)
        elif name.endswith(("moving_var", "running_var")):
            self._init_one(desc, arr)
        elif name.endswith(("moving_inv_var", "moving_avg")):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_bilinear(self, _, arr):
        """The bilinear upsampling kernel (reference ``_init_bilinear``,
        with its float ``i / shape[3]`` kept as the JAX package keeps
        it)."""
        weight = np.zeros(int(np.prod(arr.shape)), dtype="float32")
        shape = arr.shape
        f = np.ceil(shape[3] / 2.)
        c = (2 * f - 1 - f % 2) / (2. * f)
        for i in range(weight.size):
            x = i % shape[3]
            y = (i / shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.reshape(shape)

    def _init_weight(self, desc, arr):
        raise NotImplementedError("virtual")

    def _init_default(self, desc, arr):
        raise MXNetError("Unknown initialization pattern for %s" % desc)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        import torch

        u = torch.rand(arr.shape, generator=_param_gen(desc))
        arr[:] = (2.0 * u - 1.0) * self.scale


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        import torch

        arr[:] = self.sigma * torch.randn(arr.shape,
                                          generator=_param_gen(desc))


@register
class Constant(Initializer):
    def __init__(self, value=0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Zero(Constant):
    def __init__(self):
        super().__init__(0)


@register
class One(Constant):
    def __init__(self):
        super().__init__(1)


_registry.register("zeros", Zero)
_registry.register("ones", One)


@register
class Xavier(Initializer):
    """Glorot init (reference Xavier: rnd_type, factor_type, magnitude)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        import torch

        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError(
                "Xavier initializer cannot be applied to vector %s" % desc)
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        gen = _param_gen(desc)
        if self.rnd_type == "uniform":
            arr[:] = (2.0 * torch.rand(shape, generator=gen) - 1.0) * scale
        elif self.rnd_type == "gaussian":
            arr[:] = scale * torch.randn(shape, generator=gen)
        else:
            raise MXNetError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """Kaiming init (reference MSRAPrelu)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """An orthogonal matrix times ``scale`` (reference Orthogonal): the
    left or right singular vectors of a uniform or normal draw, whichever
    has the weight's (rows, fan-in) shape."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        import torch

        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        gen = _param_gen(desc)
        if self.rand_type == "uniform":
            tmp = 2.0 * torch.rand((nout, nin), generator=gen,
                                   dtype=torch.float64) - 1.0
        else:
            tmp = torch.randn((nout, nin), generator=gen,
                              dtype=torch.float64)
        u, _, v = np.linalg.svd(tmp.numpy(), full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * q.reshape(arr.shape)).astype("float32")


@register
class Bilinear(Initializer):
    """Every weight the bilinear upsampling kernel."""

    def _init_weight(self, desc, arr):
        self._init_bilinear(desc, arr)


@register
class LSTMBias(Initializer):
    """Zero bias but ``forget_bias`` on the forget gate's quarter
    (reference LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        b = np.zeros(arr.shape, dtype="float32")
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = b

    _init_bias = _init_weight


class Load:
    """Initialize from a dict of arrays, e.g. ``nd.load`` of a ``.params``
    file (``arg:``/``aux:`` prefixes dropped), falling back to
    ``default_init`` for names it lacks (reference Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {
            (k[4:] if k.startswith(("arg:", "aux:")) else k): v
            for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if tuple(self.param[name].shape) != tuple(arr.shape):
                raise MXNetError(
                    "Parameter %s has wrong shape %s vs %s"
                    % (name, arr.shape, self.param[name].shape))
            arr[:] = self.param[name]
        else:
            if self.default_init is None:
                raise MXNetError("Cannot init %s: not in loaded param and no "
                                 "default init" % name)
            self.default_init(name, arr)


class Mixed:
    """Route each parameter to the first initializer whose pattern
    matches its name (reference Mixed)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("Mixed: %d patterns for %d initializers"
                             % (len(patterns), len(initializers)))
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError("Parameter name %s did not match any pattern"
                         % name)
