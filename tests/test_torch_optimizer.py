"""The port's optimizers, schedulers and global-norm clipping against the
JAX package's, on the CPU, from numpy-seeded weights and gradients.

* Every registered optimizer in both forms — the split ``update`` over
  NDArrays through an ``Updater`` (SGD's with an ``lr_scheduler``) and the
  fused ``fused_update`` over tensors — for 3 steps on two parameters
  with ``lr_mult``, ``wd_mult``, ``rescale_grad`` and ``clip_gradient``:
  weights and states within rtol 1e-5, atol 1e-6 after each step.  SGLD
  adds Gaussian noise from each package's own generator, so it is held
  by the noise's moments instead (mean and variance within 4 standard
  errors at 10^5 draws).
* SGD ``multi_precision`` on bf16 weights through ``mp_sgd_update`` /
  ``mp_sgd_mom_update``, and NAG on bf16 weights (the JAX package's NAG
  has no multi-precision form; its arithmetic promotes to fp32).
* Each scheduler's rate at ``num_update`` 0 to 40, exactly; the
  ``Updater``'s ``get_states``/``set_states`` round trip.

The optimizers inside ``Module``, ``TrainStep`` and ``gluon.Trainer`` are
in ``test_torch_optimizer_fit.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt
from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6

NAMES = ("w_weight", "b_bias")
SHAPES = ((4, 3), (4, 3))
COMMON = dict(learning_rate=0.1, wd=0.01, rescale_grad=0.5,
              clip_gradient=1.0)

# name -> constructor arguments beyond COMMON
CASES = {
    "sgd": dict(momentum=0.9),
    "sgd-plain": dict(),
    "ccsgd": dict(momentum=0.5),
    "nag": dict(momentum=0.9),
    "dcasgd": dict(momentum=0.9, lamda=0.1),
    "adam": dict(beta1=0.8, beta2=0.99),
    "adagrad": dict(eps=1e-6),
    "rmsprop": dict(gamma1=0.8),
    "rmsprop-centered": dict(centered=True, gamma2=0.8, clip_weights=0.9),
    "adadelta": dict(rho=0.8),
    "ftrl": dict(lamda1=0.05, beta=0.5),
    "adamax": dict(beta1=0.8),
    "nadam": dict(schedule_decay=0.01),
    "test": dict(),
}


def _kind(case):
    return case.split("-")[0]


def _make(pkg, case, scheduler=False):
    kw = dict(COMMON, **CASES[case],
              param_idx2name=dict(enumerate(NAMES)))
    if scheduler:
        sched = jsched if pkg is jopt else tsched
        kw["lr_scheduler"] = sched.FactorScheduler(step=1, factor=0.7)
    o = pkg.create(_kind(case), **kw)
    o.set_lr_mult({"w_weight": 0.5})
    o.set_wd_mult({"b_bias": 2.0})
    return o


def _weights(dtype=np.float32):
    rs = np.random.RandomState(0)
    return [rs.randn(*s).astype(dtype) for s in SHAPES]


def _grads(step):
    # entries beyond clip_gradient / rescale_grad = 2 exercise the clip
    rs = np.random.RandomState(100 + step)
    return [(3 * rs.randn(*s)).astype(np.float32) for s in SHAPES]


def _np(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_np(e) for e in x)
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    if hasattr(x, "asnumpy"):
        return np.asarray(x.asnumpy(), np.float32)
    return np.asarray(x, np.float32)


def _close(got, want, what):
    if want is None or got is None:
        assert got is None and want is None, what
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, "%s[%d]" % (what, i))
        return
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.fixture
def jax_eager():
    """Run the JAX package's ops op by op: its per-op ``jit`` caches an
    executable per attribute value, and the split path's rates and
    coefficients change every step (seconds of compiling a case)."""
    with jax.disable_jit():
        yield


@pytest.mark.parametrize("case", list(CASES))
def test_split_update_matches_jax(case, jax_eager):
    # one case reads its rate from a scheduler (a rate that moves every
    # step makes each JAX op compile anew, which costs seconds)
    sched = case == "sgd"
    jo, to = _make(jopt, case, sched), _make(topt, case, sched)
    jup, tup = jopt.get_updater(jo), topt.get_updater(to)
    w0 = _weights()
    jw = [jmx.nd.array(w) for w in w0]
    with tmx.cpu():
        tw = [tmx.nd.array(w) for w in w0]
        for step in range(3):
            for i, g in enumerate(_grads(step)):
                jup(i, jmx.nd.array(g), jw[i])
                tup(i, tmx.nd.array(g), tw[i])
            for i in range(len(NAMES)):
                _close(_np(tw[i]), _np(jw[i]), "%s w%d" % (case, i))
                _close(_np(tup.states[i]), _np(jup.states[i]),
                       "%s state%d" % (case, i))
    assert to.num_update == jo.num_update == (0 if case == "test" else 3)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_update_matches_jax(case, jax_eager):
    jo, to = _make(jopt, case), _make(topt, case)
    jw = [jnp.asarray(w) for w in _weights()]
    tw = [torch.from_numpy(w) for w in _weights()]
    js = [jo.init_fused_state(w) for w in jw]
    ts = [to.init_fused_state(w) for w in tw]
    assert to.supports_fused
    for step in range(3):
        for i, g in enumerate(_grads(step)):
            lr = jo.lr * jo.lr_mult.get(NAMES[i], 1.0)
            wd = jo.wd * jo.wd_mult.get(NAMES[i], 1.0)
            jw[i], js[i] = jo.fused_update(jw[i], jnp.asarray(g), js[i], lr,
                                           wd, jnp.asarray(step + 1),
                                           jax.random.PRNGKey(step))
            tw[i], ts[i] = to.fused_update(tw[i], torch.from_numpy(g), ts[i],
                                           lr, wd, step + 1, None)
            _close(_np(tw[i]), _np(jw[i]), "%s w%d" % (case, i))
            _close(_np(ts[i]), _np(js[i]), "%s state%d" % (case, i))


def test_sgld_noise_has_the_reference_moments():
    """With a zero gradient and no decay, an SGLD step adds N(0, lr): the
    mean and the variance of 10^5 draws within 4 standard errors, in both
    forms; the same seed gives the same draws."""
    n, lr = 100_000, 0.04
    o = topt.create("sgld", learning_rate=lr)
    w = torch.zeros(n)
    gen = torch.Generator().manual_seed(3)
    noise, _ = o.fused_update(w, torch.zeros(n), None, lr, 0.0, 1, gen)
    with tmx.cpu():
        tmx.random.seed(5)
        nw = tmx.nd.zeros((n,))
        o.update(0, nw, tmx.nd.zeros((n,)), None)
        split = nw.asnumpy()
        tmx.random.seed(5)
        again = tmx.nd.zeros((n,))
        o.update(0, again, tmx.nd.zeros((n,)), None)
        np.testing.assert_array_equal(again.asnumpy(), split)
    for x in (noise.numpy().astype(np.float64), split.astype(np.float64)):
        assert abs(x.mean()) < 4 * np.sqrt(lr / n)
        # the sample variance's standard error is var * sqrt(2 / n)
        assert abs(x.var() - lr) < 4 * lr * np.sqrt(2.0 / n)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_multi_precision_bf16_matches_jax(momentum, jax_eager):
    kw = dict(learning_rate=0.1, momentum=momentum, multi_precision=True,
              rescale_grad=0.5, wd=0.01)
    jo, to = jopt.create("sgd", **kw), topt.create("sgd", **kw)
    jup, tup = jopt.get_updater(jo), topt.get_updater(to)
    w0 = _weights()
    jw = [jmx.nd.array(w).astype("bfloat16") for w in w0]
    with tmx.cpu():
        tw = [tmx.nd.array(w).astype("bfloat16") for w in w0]
        for step in range(3):
            for i, g in enumerate(_grads(step)):
                jup(i, jmx.nd.array(g).astype("bfloat16"), jw[i])
                tup(i, tmx.nd.array(g).astype("bfloat16"), tw[i])
        for i in range(len(NAMES)):
            assert tw[i]._data.dtype == torch.bfloat16
            _close(_np(tw[i]), _np(jw[i]), "w%d" % i)
            _close(_np(tup.states[i]), _np(jup.states[i]), "state%d" % i)
    # the fused form keeps the fp32 master copy in its state too
    ts = to.init_fused_state(torch.from_numpy(w0[0]).bfloat16())
    assert isinstance(ts, tuple) and ts[1].dtype == torch.float32


def test_nag_bf16_matches_jax(jax_eager):
    jo = jopt.create("nag", learning_rate=0.1, momentum=0.9, wd=0.01)
    to = topt.create("nag", learning_rate=0.1, momentum=0.9, wd=0.01)
    jup, tup = jopt.get_updater(jo), topt.get_updater(to)
    w0 = _weights()
    jw = [jmx.nd.array(w).astype("bfloat16") for w in w0]
    with tmx.cpu():
        tw = [tmx.nd.array(w).astype("bfloat16") for w in w0]
        for step in range(2):
            for i, g in enumerate(_grads(step)):
                jup(i, jmx.nd.array(g).astype("bfloat16"), jw[i])
                tup(i, tmx.nd.array(g).astype("bfloat16"), tw[i])
        for i in range(len(NAMES)):
            assert str(tw[i].dtype) == str(np.dtype(jw[i].dtype))
            _close(_np(tw[i]), _np(jw[i]), "w%d" % i)


SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.8, stop_factor_lr=0.04,
                             base_lr=0.3)),
    ("MultiFactorScheduler", dict(step=[2, 7, 30], factor=0.5, base_lr=1.0)),
    ("PolyScheduler", dict(max_update=25, base_lr=0.2, pwr=3)),
    ("CosineScheduler", dict(max_update=30, base_lr=0.5, final_lr=0.01,
                             warmup_steps=4)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS)
def test_schedulers_match_jax_exactly(name, kw):
    js, ts = getattr(jsched, name)(**kw), getattr(tsched, name)(**kw)
    assert [ts(n) for n in range(41)] == [js(n) for n in range(41)]


def test_optimizer_takes_a_scheduler_and_global_norm_clip():
    sched = tsched.FactorScheduler(step=2, factor=0.5)
    o = topt.create("adam", learning_rate=0.4, lr_scheduler=sched,
                    clip_global_norm=2.0)
    assert sched.base_lr == 0.4 and o.clip_global_norm == 2.0
    with pytest.raises(MXNetError, match="must be > 0"):
        topt.create("sgd", clip_global_norm=-1.0)
    with pytest.raises(MXNetError, match="not registered"):
        topt.create("lamb")
    assert set(topt._registry) == set(jopt._registry._entries)
    grads = [torch.from_numpy(g) for g in _grads(0)]
    norm = topt.global_grad_norm(grads, rescale_grad=0.5)
    want = jopt.global_grad_norm([jnp.asarray(g.numpy()) for g in grads],
                                 0.5)
    np.testing.assert_allclose(norm.item(), float(want), rtol=RTOL)
    for max_norm in (0.1, 1e3):
        np.testing.assert_allclose(
            topt.global_norm_scale(norm, max_norm).item(),
            float(jopt.global_norm_scale(want, max_norm)), rtol=RTOL)


def test_updater_states_round_trip():
    o = topt.create("adam")
    up = topt.get_updater(o)
    with tmx.cpu():
        w = tmx.nd.array(_weights()[0])
        up(0, tmx.nd.array(_grads(0)[0]), w)
        saved = up.get_states()
        again = topt.get_updater(topt.create("adam"))
        again.set_states(saved)
    assert sorted(again.states) == [0]
    for a, b in zip(again.states[0], up.states[0]):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
