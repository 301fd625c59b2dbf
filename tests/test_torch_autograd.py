"""The port's imperative autograd against the JAX package's, on the CPU.

Every case of ``tests/test_autograd.py`` runs through both packages on
the same numpy inputs: each package must give the reference's expected
values, and the two must agree (fp32, rtol 1e-5).  Then the cases that
break a naive design over torch autograd: ``grad_req`` write/add/null,
``pause()`` inside ``record()``, gradients at the ties and kinks where a
torch built-in differs from JAX (``maximum``/``minimum`` at a tie, their
scalar forms, ``abs`` at 0, ``max`` over a tied row, ``pick``), and a
recorded op's inputs staying ``requires_grad`` leaves through rebinds.
"""
import contextlib

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL = 1e-5

PACKAGES = {"jax": jmx, "torch": tmx}


def _scope(mx):
    """The port's arrays default to the card: run its side on the CPU."""
    return mx.cpu() if mx is tmx else contextlib.nullcontext()


def both(case):
    """Run ``case(mx)`` in both packages; returns {name: numpy results}."""
    out = {}
    for name, mx in PACKAGES.items():
        with _scope(mx):
            res = case(mx)
        out[name] = [np.asarray(r.asnumpy() if hasattr(r, "asnumpy") else r)
                     for r in (res if isinstance(res, (list, tuple))
                               else [res])]
    for a, b in zip(out["jax"], out["torch"]):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-7)
    return out["torch"]


def test_simple_grad():
    def case(mx):
        x = mx.nd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.sum(x * x)
        y.backward()
        return x.grad
    np.testing.assert_allclose(both(case)[0], [2, 4, 6])


def test_chain_rule():
    def case(mx):
        x = mx.nd.array([0.5])
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.exp(mx.nd.sin(x))
        y.backward()
        return x.grad
    np.testing.assert_allclose(both(case)[0],
                               [np.exp(np.sin(0.5)) * np.cos(0.5)],
                               rtol=RTOL)


def test_multiple_variables():
    def case(mx):
        a, b = mx.nd.array([2.0]), mx.nd.array([3.0])
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            c = a * b + a
        c.backward()
        return a.grad, b.grad
    ga, gb = both(case)
    np.testing.assert_allclose(ga, [4.0])
    np.testing.assert_allclose(gb, [2.0])


def test_head_grads():
    def case(mx):
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * 2
        y.backward(mx.nd.array([10.0, 20.0]))
        return x.grad
    np.testing.assert_allclose(both(case)[0], [20, 40])


def test_grad_req_add():
    def case(mx):
        x = mx.nd.array([1.0])
        g = mx.nd.zeros((1,))
        mx.autograd.mark_variables([x], [g], "add")
        for _ in range(2):
            with mx.autograd.record():
                y = x * 3
            y.backward()
        return g
    np.testing.assert_allclose(both(case)[0], [6.0])


def test_grad_req_write_overwrites():
    def case(mx):
        x = mx.nd.array([1.0, 2.0])
        x.attach_grad()
        for k in (3.0, 5.0):
            with mx.autograd.record():
                y = x * k
            y.backward()
        return x.grad
    np.testing.assert_allclose(both(case)[0], [5.0, 5.0])


def test_grad_req_null_skips():
    def case(mx):
        x, w = mx.nd.array([1.0, 2.0]), mx.nd.array([3.0, 4.0])
        gx, gw = mx.nd.zeros((2,)), mx.nd.array([7.0, 7.0])
        mx.autograd.mark_variables([x, w], [gx, gw], ["write", "null"])
        with mx.autograd.record():
            y = mx.nd.sum(x * w)
        y.backward()
        return gx, gw
    gx, gw = both(case)
    np.testing.assert_allclose(gx, [3.0, 4.0])
    np.testing.assert_allclose(gw, [7.0, 7.0])


def test_stop_gradient():
    def case(mx):
        x = mx.nd.array([2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.BlockGrad(x * x) + x
        y.backward()
        return x.grad
    np.testing.assert_allclose(both(case)[0], [1.0])


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_is_training_flags(name):
    ag = PACKAGES[name].autograd
    assert not ag.is_recording()
    assert not ag.is_training()
    with ag.record():
        assert ag.is_recording()
        assert ag.is_training()
        with ag.pause():
            assert not ag.is_recording()
    assert not ag.is_recording()


def test_grad_function():
    def case(mx):
        x = mx.nd.array([3.0])
        with mx.autograd.record():
            y = x * x
        return mx.autograd.grad([y], [x])[0]
    np.testing.assert_allclose(both(case)[0], [6.0])


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_training_mode_without_recording(name):
    mx = PACKAGES[name]
    with _scope(mx):
        x = mx.nd.ones((40, 40))
        with mx.autograd.train_mode():
            y = mx.nd.Dropout(x, p=0.5)
        v = y.asnumpy()
    assert (v == 0).any()
    assert set(np.unique(v)) <= {0.0, 2.0}


def test_detach():
    def case(mx):
        x = mx.nd.array([1.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * 2
            y.detach() * 3
        y.backward()
        return x.grad
    np.testing.assert_allclose(both(case)[0], [2.0])


def test_retain_graph():
    def case(mx):
        x = mx.nd.array([2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
        y.backward(retain_graph=True)
        first = x.grad.asnumpy()
        y.backward()
        return first, x.grad
    first, second = both(case)
    np.testing.assert_allclose(first, [4.0])
    np.testing.assert_allclose(second, [4.0])


def test_detach_blocks_gradient():
    def case(mx):
        x = mx.nd.array([2.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * 2
            z = y.detach() * 3
        z.backward()
        return x.grad
    np.testing.assert_allclose(both(case)[0], [0.0])


def test_getitem_on_tape():
    def case(mx):
        x = mx.nd.array([[1.0, 2.0], [3.0, 4.0]])
        x.attach_grad()
        with mx.autograd.record():
            z = mx.nd.sum(x[0] * 3)
        z.backward()
        return x.grad
    np.testing.assert_allclose(both(case)[0], [[3, 3], [0, 0]])


def test_grad_then_backward():
    def case(mx):
        x = mx.nd.array([3.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
        g = mx.autograd.grad([y], [x], retain_graph=True)[0].asnumpy()
        y.backward()
        return g, x.grad
    g, xg = both(case)
    np.testing.assert_allclose(g, [6.0])
    np.testing.assert_allclose(xg, [6.0])


def test_many_steps_no_id_aliasing():
    rs = np.random.RandomState(0)
    w0 = rs.randn(8, 4).astype("float32")
    x0 = rs.randn(16, 4).astype("float32")

    def case(mx):
        w = mx.nd.array(w0)
        b = mx.nd.array(np.zeros(8, "float32"))
        w.attach_grad()
        b.attach_grad()
        x = mx.nd.array(x0)
        for _ in range(5):
            with mx.autograd.record():
                out = mx.nd.sum(mx.nd.FullyConnected(x, w, b, num_hidden=8))
            out.backward()
            assert w.grad.shape == (8, 4) and b.grad.shape == (8,)
            mx.nd.sgd_update(w, w.grad, lr=0.01, out=w)
            mx.nd.sgd_update(b, b.grad, lr=0.01, out=b)
        return w, b, w.grad
    both(case)


def test_backward_without_recording_raises():
    with tmx.cpu():
        x = tmx.nd.array([1.0])
        x.attach_grad()
        y = x * 2
        with pytest.raises(MXNetError, match="without recorded graph"):
            y.backward()
        with tmx.autograd.record():
            y = x * 2
        y.backward()
        with pytest.raises(MXNetError, match="without recorded graph"):
            y.backward()  # the graph was spent


def test_pause_inside_record():
    def case(mx):
        x = mx.nd.array([2.0, 3.0])
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
            with mx.autograd.pause():
                z = x * 10  # not recorded: a constant below
            out = mx.nd.sum(y + z)
        out.backward()
        return x.grad, z
    g, z = both(case)
    np.testing.assert_allclose(g, [4.0, 6.0])
    np.testing.assert_allclose(z, [20.0, 30.0])


def test_leaves_stay_leaves_across_rebinds():
    """A marked variable rebound by an update (``out=``, ``[:]``) is a
    ``requires_grad`` leaf again; an ``out=`` target and a mutable input
    (BatchNorm's moving mean) never carry a graph."""
    with tmx.cpu():
        w = tmx.nd.array([1.0, 2.0])
        w.attach_grad()
        m = tmx.nd.zeros((2,))
        tmx.nd.sgd_update(w, tmx.nd.ones((2,)), lr=0.5, out=w)
        assert w._data.requires_grad and w._data.is_leaf
        w[:] = np.array([3.0, 4.0], "float32")
        assert w._data.requires_grad and w._data.is_leaf
        x = tmx.nd.array(np.random.RandomState(0).randn(4, 2, 3, 3)
                         .astype("float32"))
        gamma, beta = tmx.nd.ones((2,)), tmx.nd.zeros((2,))
        mean, var = tmx.nd.zeros((2,)), tmx.nd.ones((2,))
        with tmx.autograd.record():
            out = tmx.nd.BatchNorm(x, gamma, beta, mean, var, fix_gamma=False)
            tmx.nd.elemwise_mul(w, w, out=m)
        assert out._data.grad_fn is not None
        assert mean._data.grad_fn is None and not mean._data.requires_grad
        assert m._data.grad_fn is None and not m._data.requires_grad
        assert np.abs(mean.asnumpy()).sum() > 0


@pytest.mark.parametrize("op", ["maximum", "minimum"])
def test_tie_gradient_is_split_as_in_jax(op):
    """At a tie, jnp.maximum/minimum give each side half the gradient;
    the scalar forms give the array half."""
    def case(mx):
        a, b = mx.nd.array([1.0, 2.0, 3.0]), mx.nd.array([1.0, 0.0, 5.0])
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            y = mx.nd.sum(getattr(mx.nd, "elemwise_" + op)(a, b)
                          + getattr(mx.nd, "_%s_scalar" % op)(a, scalar=2.0))
        y.backward()
        return a.grad, b.grad
    ga, gb = both(case)
    assert 0.5 in ga and 0.5 in gb


def test_kink_gradients_follow_jax():
    """abs at 0 (1 in JAX, 0 for torch.abs), relu at 0 (0.5), and max
    over a row with a tied maximum (shared evenly)."""
    def case(mx):
        x = mx.nd.array([[-1.0, 0.0, 2.0, 2.0]])
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.sum(mx.nd.abs(x)) + mx.nd.sum(mx.nd.relu(x)) \
                + mx.nd.sum(mx.nd.max(x, axis=1))
        y.backward()
        return x.grad
    np.testing.assert_allclose(both(case)[0], [[-1.0, 1.5, 2.5, 2.5]])


def test_pick_gradient():
    rs = np.random.RandomState(1)
    x0 = rs.randn(5, 4).astype("float32")
    idx = np.array([0, 3, 1, 7, -2], "float32")  # clipped into range

    def case(mx):
        x = mx.nd.array(x0)
        x.attach_grad()
        with mx.autograd.record():
            p = mx.nd.pick(x, mx.nd.array(idx), axis=1)
            y = mx.nd.sum(p * p)
        y.backward()
        return p, x.grad
    both(case)
