"""The port's NDArray ops against the JAX package's, on the forward cases
of the JAX package's own sweep table (``tests/test_op_sweep.py`` SPECS,
imported, not copied).

Every op of the table that the port registers runs on the same numpy
inputs through both packages' ``imperative_invoke`` (fp32 rtol 1e-5,
atol 1e-6; NaN where the JAX package gives NaN).  The ops the table has
and the port does not yet register are listed in ROADMAP queue 1 step 3;
``test_ops_of_this_slice_are_covered`` pins that the ops the Gluon layers,
the losses and the trainer reach are all in the table and all run.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import imperative_invoke as jinvoke
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray import imperative_invoke as tinvoke
from mxnet_tpu_torch.ops import registry as treg

from test_op_sweep import SPECS

# ops the Gluon layers, the losses, the Trainer and the imperative drive
# reach (issue scope of this slice), each must have a case here
SLICE_OPS = ["exp", "log", "abs", "square", "sqrt", "sigmoid", "relu",
             "_maximum", "_minimum", "_maximum_scalar", "_minimum_scalar",
             "sum", "mean", "max", "min", "pick", "softmax", "log_softmax",
             "Dropout", "sgd_update", "sgd_mom_update", "where", "BlockGrad",
             "Cast", "LeakyReLU", "InstanceNorm", "Deconvolution", "Concat"]

# random ops: the two packages draw from different generators
RANDOM = {"Dropout"}

PORTED = sorted(n for n in SPECS if treg.exists(n))


def _inputs(spec_inputs):
    return [x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)
            for x in spec_inputs]


def test_ops_of_this_slice_are_covered():
    missing = [n for n in SLICE_OPS if n not in PORTED]
    assert not missing, missing


@pytest.mark.parametrize("name", PORTED)
def test_op_forward_matches_jax(name):
    inputs, attrs = SPECS[name]
    arrays = _inputs(inputs)
    want = [o.asnumpy() for o in jinvoke(
        name, [jmx.nd.array(x) for x in arrays], dict(attrs))]
    with tmx.cpu():
        got = [o.asnumpy() for o in tinvoke(
            name, [tmx.nd.array(x, dtype=x.dtype) for x in arrays],
            dict(attrs))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name in RANDOM and not np.array_equal(w, arrays[0]):
            continue
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=1e-5,
                                   atol=1e-6, equal_nan=True)
