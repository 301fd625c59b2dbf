"""The port's NDArray ops against the JAX package's, on the forward cases
of the JAX package's own sweep table (``tests/test_op_sweep.py`` SPECS,
imported, not copied).

Every op of the table that the port registers runs on the same numpy
inputs through both packages' ``imperative_invoke`` (fp32 rtol 1e-5,
atol 1e-6; NaN where the JAX package gives NaN; dtypes equal).  The
samplers draw from different generators in the two packages, so they
are held by shape and dtype here (against the JAX op's abstract
evaluation) and by their moments in ``test_torch_op_grads.py``.  The
port keeps a copy of the table for the card
(``mxnet_tpu_torch/testing/op_specs.py``), held equal to it here.  The names the table has and the port does
not register are exactly the ones ROADMAP places in later steps (the
contrib ops, ``RNN``, ``MoE``).
"""
import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import imperative_invoke as jinvoke
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray import imperative_invoke as tinvoke
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.testing import op_specs

from test_op_sweep import SPECS

# ops the Gluon layers, the losses, the Trainer, the optimizers and the
# imperative drive reach, each must have a case here
SLICE_OPS = ["exp", "log", "abs", "square", "sqrt", "sigmoid", "relu",
             "_maximum", "_minimum", "_maximum_scalar", "_minimum_scalar",
             "sum", "mean", "max", "min", "pick", "softmax", "log_softmax",
             "Dropout", "sgd_update", "sgd_mom_update", "where", "BlockGrad",
             "Cast", "LeakyReLU", "InstanceNorm", "Deconvolution", "Concat",
             "mp_sgd_update", "mp_sgd_mom_update", "adam_update",
             "rmsprop_update", "rmspropalex_update", "ftrl_update", "clip",
             "elemwise_maximum", "random_normal", "LRN", "SliceChannel",
             "transpose", "slice", "take", "one_hot", "topk", "dot",
             "batch_dot", "MakeLoss", "LinearRegressionOutput",
             "SVMOutput", "ROIPooling", "SequenceMask", "UpSampling"]

# the names left to later steps of the port (ROADMAP queue 1 steps 6
# and 7): the contrib ops, RNN, MoE
LATER = {"CTCLoss", "Correlation", "DeformableConvolution",
         "DeformablePSROIPooling", "MultiBoxDetection", "MultiBoxPrior",
         "MultiBoxTarget", "MultiProposal", "PSROIPooling", "Proposal",
         "count_sketch", "ctc_loss", "dequantize", "fft", "ifft",
         "khatri_rao", "krprod", "quantize", "_contrib_CTCLoss",
         "_contrib_DeformableConvolution", "_contrib_DeformablePSROIPooling",
         "_contrib_MultiBoxDetection", "_contrib_MultiBoxPrior",
         "_contrib_MultiBoxTarget", "_contrib_MultiProposal",
         "_contrib_PSROIPooling", "_contrib_Proposal",
         "_contrib_count_sketch", "_contrib_dequantize", "_contrib_fft",
         "_contrib_ifft", "_contrib_khatri_rao", "_contrib_quantize",
         "RNN", "_state_zeros", "MoE", "_contrib_MoE"}

PORTED = sorted(n for n in SPECS if treg.exists(n))

# the samplers: the two packages draw from different generators
RANDOM = {n for n in PORTED if op_specs.is_random(n)}


def _inputs(spec_inputs):
    return [x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)
            for x in spec_inputs]


def test_ops_of_this_slice_are_covered():
    missing = [n for n in SLICE_OPS if n not in PORTED]
    assert not missing, missing


def test_registry_holds_every_name_but_the_later_steps():
    theirs, ours = set(jreg.list_ops()), set(treg.list_ops())
    assert not ours - theirs
    assert theirs - ours == LATER
    assert len(ours) == 296


def _jax_shapes(name, arrays, attrs):
    """The JAX op's outputs as zero arrays of their shapes and dtypes,
    from its abstract evaluation (a random op's values differ anyway,
    and compiling JAX's samplers costs seconds each)."""
    op = jreg.get(name)
    outs = jax.eval_shape(
        lambda key, *xs: jreg.invoke(op, (key,) + xs, dict(attrs)),
        jax.random.PRNGKey(0), *arrays)
    n = op.count_outputs(jreg.FrozenAttrs(attrs))
    return [np.zeros(o.shape, o.dtype) for o in outs[:n]]


def test_port_copy_of_the_table_equals_it():
    """``mxnet_tpu_torch/testing/op_specs.py`` (what ``chip_smoke.py``
    runs on the card) holds exactly the table's cases of the ported
    ops."""
    assert sorted(op_specs.SPECS) == PORTED
    for name in PORTED:
        (want_in, want_attrs), (got_in, got_attrs) = SPECS[name], \
            op_specs.SPECS[name]
        assert got_attrs == want_attrs, name
        assert len(got_in) == len(want_in), name
        for g, w in zip(got_in, _inputs(want_in)):
            assert g.dtype == w.dtype and np.array_equal(g, w,
                                                         equal_nan=True), name


@pytest.mark.parametrize("name", PORTED)
def test_op_forward_matches_jax(name):
    inputs, attrs = SPECS[name]
    arrays = _inputs(inputs)
    if name in RANDOM:
        want = _jax_shapes(name, arrays, attrs)
    else:
        want = [o.asnumpy() for o in jinvoke(
            name, [jmx.nd.array(x) for x in arrays], dict(attrs))]
    with tmx.cpu():
        got = [o.asnumpy() for o in tinvoke(
            name, [tmx.nd.array(x, dtype=x.dtype) for x in arrays],
            dict(attrs))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if name in RANDOM:
            continue
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=1e-5,
                                   atol=1e-6, equal_nan=True)


def test_creation_and_random_ops_inside_a_graph():
    """Ops without tensor inputs inside a Symbol graph: shape inference
    runs them on ``meta`` tensors, and the executor makes their outputs
    on its own device (the CPU here, whatever the current context)."""
    outs = []
    for pkg in (jmx, tmx):
        x = pkg.sym.Variable("x")
        y = pkg.sym.broadcast_add(x, pkg.sym._arange(start=0, stop=3))
        z = pkg.sym.broadcast_mul(y, pkg.sym.random_uniform(shape=(2, 3)))
        g = pkg.sym.Group([y, pkg.sym.zeros_like(z) + 1.0])
        assert g.infer_shape(x=(2, 3))[1] == [(2, 3), (2, 3)]
        ex = g.simple_bind(pkg.cpu(), x=(2, 3), grad_req="null")
        ex.forward(is_train=False, x=pkg.nd.array(
            np.ones((2, 3), np.float32), pkg.cpu()))
        outs.append([o.asnumpy() for o in ex.outputs])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)
