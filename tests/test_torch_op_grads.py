"""Gradients, ties and kinks of the port's ops against the JAX package's,
and the moments of the port's random ops, on the CPU.

* The port twins of ``tests/test_op_sweep.py``'s ``test_grad_*`` for the
  ops of this slice (the spatial samplers, ``ROIPooling``, the
  ``Sequence*`` ops, the ``linalg_*``, ``L2Normalization``,
  ``_slice_assign``), and the gradients of the other new ops that have
  one: the same inputs and the same cotangent through the op's
  ``compute`` in both packages, ``jax.vjp`` there and torch autograd
  here, every input gradient within rtol 1e-5, atol 1e-6 (NaN where
  JAX's is NaN).
* The custom VJPs: ``MakeLoss``, the regression outputs and
  ``SVMOutput`` give ``grad_scale``-scaled gradients times the cotangent
  and a zero label gradient.
* Ties and kinks follow JAX, not torch: ``clip`` at its bounds, ``norm``
  at 0, ``smooth_l1`` at |x| = 1/sigma^2, ``abs`` inside ``norm(ord=1)``
  at 0, ``sort``/``argsort``/``topk`` on ties (stable), ``argmax``/
  ``argmin`` (the first extremum), ``take``'s ``clip``/``wrap`` modes and
  ``batch_take``'s ids out of range (read clamped, their gradient
  dropped, as JAX's gather and its scatter do).
* Random ops: mean and variance within 4 standard errors of the
  distribution's at 10^5 draws; the same seed gives the same draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.testing import op_specs

RTOL, ATOL = 1e-5, 1e-6
N = op_specs.N_DRAWS


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _spd(n=4):
    a = _f(n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _tril(n=4):
    return np.tril(_spd(n)).astype(np.float32)


LENS = np.array([2, 4], np.float32)
ROIS = np.array([[0, 0, 0, 5, 5], [0, 1, 2, 4, 5]], np.float32)
THETA = np.array([[1.0, 0.1, 0.0, 0.1, 1.0, 0.0]], np.float32)
TIES = np.array([[1.0, 3.0, 2.0, 3.0, 1.0, 2.0],
                 [0.5, 0.5, -1.0, 0.5, -1.0, 7.0]], np.float32)

# name, inputs, attrs, indices of the inputs whose gradient is compared
GRAD_CASES = [
    ("ROIPooling", [_f(1, 2, 6, 6), ROIS],
     {"pooled_size": (3, 3), "spatial_scale": 1.0}, (0,)),
    ("SpatialTransformer", [_f(1, 2, 6, 6), THETA],
     {"transform_type": "affine", "sampler_type": "bilinear",
      "target_shape": (4, 4)}, (0, 1)),
    ("BilinearSampler",
     [_f(1, 2, 5, 5), 0.5 * np.random.RandomState(1).uniform(
         -0.9, 0.9, (1, 2, 3, 3)).astype(np.float32)], {}, (0, 1)),
    ("GridGenerator", [THETA],
     {"transform_type": "affine", "target_shape": (4, 4)}, (0,)),
    ("SequenceMask", [_f(4, 2, 3), LENS],
     {"use_sequence_length": True, "value": -1.0}, (0,)),
    ("SequenceReverse", [_f(4, 2, 3), LENS], {"use_sequence_length": True},
     (0,)),
    ("SequenceLast", [_f(4, 2, 3), LENS], {"use_sequence_length": True},
     (0,)),
    ("linalg_gemm", [_f(3, 4), _f(4, 5, seed=1), _f(3, 5, seed=2)],
     {"alpha": 0.5, "beta": 2.0, "transpose_b": False}, (0, 1, 2)),
    ("linalg_gemm2", [_f(4, 3), _f(4, 5, seed=1)],
     {"transpose_a": True}, (0, 1)),
    ("linalg_potrf", [_spd()], {}, (0,)),
    ("linalg_potri", [_tril()], {}, (0,)),
    ("linalg_sumlogdiag", [_spd()], {}, (0,)),
    ("linalg_trmm", [_tril(), _f(4, 4, seed=1)], {"rightside": True},
     (0, 1)),
    ("linalg_trsm", [_tril(), _f(4, 4, seed=1)], {"transpose": True},
     (0, 1)),
    ("linalg_syrk", [_f(3, 4)], {"transpose": True}, (0,)),
    ("L2Normalization", [_f(2, 3, 4)], {"mode": "channel"}, (0,)),
    ("LRN", [_f(2, 4, 3, 3)], {"nsize": 3, "alpha": 0.1}, (0,)),
    ("UpSampling", [_f(1, 2, 3, 3)], {"scale": 2, "sample_type": "nearest"},
     (0,)),
    ("UpSampling", [_f(1, 2, 3, 3)],
     {"scale": 2, "sample_type": "bilinear"}, (0,)),
    ("SoftmaxActivation", [_f(2, 3, 2)], {"mode": "channel"}, (0,)),
    ("softmax_cross_entropy", [_f(4, 5), np.array([0, 4, 2, 2], np.float32)],
     {}, (0,)),
    ("Crop", [_f(1, 2, 6, 6)], {"h_w": (3, 4), "offset": (1, 2)}, (0,)),
    ("_slice_assign", [_f(4, 4), _f(2, 2, seed=1)],
     {"begin": (1, 1), "end": (3, 3)}, (0, 1)),
    ("_slice_assign", [_f(4, 5), _f(2, 3, seed=1)],
     {"begin": (3, None), "end": (1, None), "step": (-1, -2)}, (0, 1)),
    ("_slice_assign_scalar", [_f(4, 4)],
     {"begin": (0, 1), "end": (2, 4), "scalar": 3.0}, (0,)),
    ("slice", [_f(5, 6)], {"begin": (4, 1), "end": (0, 6), "step": (-2, 2)},
     (0,)),
    ("slice_axis", [_f(3, 6)], {"axis": -1, "begin": 1, "end": 5}, (0,)),
    ("slice_like", [_f(4, 5), _f(2, 3)], {"axes": (1,)}, (0,)),
    ("Pad", [_f(1, 2, 3, 4)], {"mode": "edge",
                               "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)}, (0,)),
    ("Pad", [_f(1, 2, 3, 4)], {"mode": "reflect",
                               "pad_width": (0, 0, 0, 0, 2, 2, 1, 3)}, (0,)),
    ("Pad", [_f(1, 2, 3, 4)], {"mode": "constant", "constant_value": 1.5,
                               "pad_width": (0, 0, 1, 0, 2, 2, 1, 3)}, (0,)),
    ("take", [_f(5, 3), np.array([[-2, 0], [4, 9]], np.float32)],
     {"mode": "clip"}, (0,)),
    ("take", [_f(5, 3), np.array([-7, 1, 12], np.float32)],
     {"mode": "wrap", "axis": 0}, (0,)),
    ("take", [_f(3, 5), np.array([-1, 4, 2], np.float32)], {"axis": 1},
     (0,)),
    ("batch_take", [_f(4, 3), np.array([-1, 3, 5, -4], np.float32)], {},
     (0,)),
    ("tile", [_f(2, 3)], {"reps": (2, 1, 2)}, (0,)),
    ("repeat", [_f(2, 3)], {"repeats": 3}, (0,)),
    ("stack", [_f(3, 4), _f(3, 4, seed=1)], {"axis": 1}, (0, 1)),
    ("SliceChannel", [_f(2, 6)], {"num_outputs": 3, "axis": 1,
                                  "squeeze_axis": False}, (0,)),
    ("transpose", [_f(2, 3, 4)], {"axes": (1, 2, 0)}, (0,)),
    ("broadcast_to", [_f(1, 4)], {"shape": (3, 0)}, (0,)),
    ("broadcast_axis", [_f(3, 1, 1)], {"axis": (1, 2), "size": (2, 4)},
     (0,)),
    ("prod", [np.array([[2.0, 0.0, 3.0], [1.5, -2.0, 0.5]], np.float32)],
     {"axis": 1}, (0,)),
    ("nanprod", [np.array([[2.0, np.nan, 3.0], [1.5, -2.0, 0.5]],
                          np.float32)], {"axis": (0, 1)}, (0,)),
    ("nansum", [np.array([[2.0, np.nan, 3.0]], np.float32)], {}, (0,)),
    ("norm", [_f(3, 4)], {"axis": 1, "keepdims": True}, (0,)),
    ("norm", [np.zeros((2, 3), np.float32)], {}, (0,)),
    ("norm", [np.array([[0.0, -1.0, 2.0]], np.float32)], {"ord": 1}, (0,)),
    ("clip", [np.array([-1.0, -0.5, 0.0, 0.5, 1.0], np.float32)],
     {"a_min": -0.5, "a_max": 0.5}, (0,)),
    ("smooth_l1", [np.array([-2.0, -0.25, 0.0, 0.25, 0.5, 3.0], np.float32)],
     {"scalar": 2.0}, (0,)),
    ("sort", [TIES], {"axis": 1, "is_ascend": False}, (0,)),
    ("topk", [TIES], {"axis": 1, "k": 3, "ret_typ": "value"}, (0,)),
    ("topk", [TIES], {"axis": 0, "k": 1, "ret_typ": "value",
                      "is_ascend": True}, (0,)),
    ("dot", [_f(4, 3), _f(5, 4, seed=1)], {"transpose_a": True,
                                           "transpose_b": True}, (0, 1)),
    ("dot", [_f(2, 3, 4), _f(4, 5, seed=1)], {}, (0, 1)),
    ("batch_dot", [_f(2, 4, 3), _f(2, 4, 5, seed=1)], {"transpose_a": True},
     (0, 1)),
    ("add_n", [_f(2, 3), _f(2, 3, seed=1), _f(2, 3, seed=2)], {},
     (0, 1, 2)),
    ("MakeLoss", [_f(3, 4)], {"grad_scale": 0.25}, (0,)),
    ("LinearRegressionOutput", [_f(4, 3), _f(4, 3, seed=1)],
     {"grad_scale": 2.0}, (0, 1)),
    ("MAERegressionOutput", [_f(4, 3), _f(4, 3, seed=1)], {}, (0, 1)),
    ("LogisticRegressionOutput", [_f(4, 3), _f(12, seed=1)], {}, (0, 1)),
    ("SVMOutput", [_f(4, 5), np.array([1, 0, 4, 2], np.float32)],
     {"margin": 0.5, "regularization_coefficient": 0.7}, (0, 1)),
    ("SVMOutput", [_f(4, 5), np.array([1, 0, 4, 2], np.float32)],
     {"use_linear": True}, (0, 1)),
]


def _case_id(case):
    name, _, attrs, _ = case
    return name + ("-" + "-".join("%s=%s" % kv for kv in sorted(
        attrs.items())) if attrs else "")


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _cotangents(outs):
    rs = np.random.RandomState(7)
    return [np.asarray(rs.randn(*o.shape), np.float32) for o in outs]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[_case_id(c) for c in GRAD_CASES])
def test_gradient_matches_jax(case):
    name, inputs, attrs, wrt = case
    jop, top = jreg.get(name), treg.get(name)
    jattrs, tattrs = jreg.FrozenAttrs(attrs), treg.FrozenAttrs(attrs)

    def jfn(*xs):
        return _outputs(jop.compute(jattrs, *xs))

    xs = [jnp.asarray(x) for x in inputs]
    cts = _cotangents(jax.eval_shape(jfn, *xs))

    @jax.jit  # one executable: eager vmapped samplers take seconds
    def forward_and_vjp(xs, cts):
        outs, vjp = jax.vjp(jfn, *xs)
        return outs, vjp(cts)

    jouts, jgrads = forward_and_vjp(xs, tuple(jnp.asarray(c) for c in cts))
    tin = [torch.tensor(x, requires_grad=i in wrt)
           for i, x in enumerate(inputs)]
    touts = _outputs(top.compute(tattrs, *tin))
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=RTOL, atol=ATOL, equal_nan=True)
    got = torch.autograd.grad(touts, [tin[i] for i in wrt],
                              [torch.from_numpy(c) for c in cts],
                              allow_unused=True)
    for i, g in zip(wrt, got):
        want = np.asarray(jgrads[i])
        g = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg="input %d" % i)


def _forward(name, x, attrs):
    jx = np.asarray(jreg.get(name).compute(jreg.FrozenAttrs(attrs),
                                           jnp.asarray(x)))
    tx = treg.get(name).compute(treg.FrozenAttrs(attrs),
                                torch.from_numpy(x)).numpy()
    return tx, jx


@pytest.mark.parametrize("name,attrs", [
    ("argmax", {"axis": 1}), ("argmin", {"axis": 1}), ("argmax", {}),
    ("argmax", {"axis": 0, "keepdims": True}), ("argmax_channel", {}),
    ("argsort", {"axis": 1}), ("argsort", {"axis": 1, "is_ascend": False}),
    ("topk", {"axis": 1, "k": 4}), ("topk", {"axis": 1, "k": 4,
                                             "is_ascend": True}),
    ("sort", {"axis": 0})])
def test_ties_follow_jax(name, attrs):
    """On tied entries (and a NaN for the arg-reductions) the port picks
    the same index as the JAX package: the first extremum, stable
    order."""
    x = TIES.copy()
    if name.startswith("argm"):
        x[1, 4] = np.nan
    got, want = _forward(name, x, attrs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# random ops: moments and seeding
# ---------------------------------------------------------------------------

def _draw(name, inputs, attrs, seed):
    tmx.random.seed(seed)
    with tmx.cpu():
        out = tmx.nd.imperative_invoke(
            name, [tmx.nd.array(x) for x in inputs], attrs)[0]
    return out.asnumpy().astype(np.float64).reshape(-1)


@pytest.mark.parametrize("name,inputs,attrs,moments",
                         op_specs.RANDOM_MOMENTS,
                         ids=[c[0] for c in op_specs.RANDOM_MOMENTS])
def test_random_moments_and_seeding(name, inputs, attrs, moments):
    attrs = dict(attrs, shape=(N,))
    x = _draw(name, inputs, attrs, seed=11)
    assert x.size == N
    ok, mean, var = op_specs.moments_ok(x, *moments)
    assert ok, (mean, var, moments)
    np.testing.assert_array_equal(_draw(name, inputs, attrs, seed=11), x)
    assert not np.array_equal(_draw(name, inputs, attrs, seed=12), x)


def test_multinomial_frequencies_and_log_probs():
    p = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1]], np.float32)
    tmx.random.seed(3)
    with tmx.cpu():
        op = treg.get("sample_multinomial")
        gen = tmx.random.next_key(tmx.cpu())
        idx, logp = op.compute(treg.FrozenAttrs(shape=(N,), get_prob=True),
                               gen, torch.from_numpy(p))
    assert idx.shape == (2, N) and idx.dtype == torch.int32
    for row in range(2):
        freq = np.bincount(idx[row].numpy(), minlength=4) / N
        se = np.sqrt(p[row] * (1 - p[row]) / N)
        assert (np.abs(freq - p[row]) < 4 * se).all(), (freq, p[row])
        np.testing.assert_allclose(
            logp[row].numpy(), np.log(p[row])[idx[row].numpy()], rtol=1e-5)


def test_shuffle_permutes_rows_and_replays_under_a_seed():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    a = _draw("shuffle", [x], {}, seed=4).reshape(20, 2)
    assert sorted(map(tuple, a)) == sorted(map(tuple, x))
    assert not np.array_equal(a, x)
    np.testing.assert_array_equal(
        _draw("shuffle", [x], {}, seed=4).reshape(20, 2), a)
