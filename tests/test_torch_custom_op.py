"""The port's CustomOp against the JAX package's, on the CPU.

The cases of ``tests/test_custom_op.py`` run through both packages with
the same ops and the same numpy inputs: the imperative forward, the
autograd backward, the symbolic bind (a softmax loss op whose backward is
``(softmax − onehot) / N``), an MLP whose loss layer is that op trained by
``Module.fit``, a forward-only op, an unknown ``op_type``.  Tolerance:
fp32 rtol 1e-5 (atol 1e-6 for gradients near 0); the two fits' accuracy
must both clear the reference's 0.9.

Then ``rtc_softmax`` — the port's rtc-backed loss op, whose CPU path runs
the plain bodies — against a JAX twin whose ``forward``/``backward`` are
``PallasKernel`` bodies run in interpret mode, as the JAX package's own
rtc test runs them (``tests/test_deploy_tools.py:128-147``).
"""
import contextlib

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.operator as jop
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.operator as top
from mxnet_tpu_torch.testing import rtc_ops  # noqa: F401  (rtc_softmax)

PACKAGES = {"jax": (jmx, jop), "torch": (tmx, top)}


def _scope(mx):
    return mx.cpu() if mx is tmx else contextlib.nullcontext()


def _define(mxop, suffix=""):
    """The reference test's two ops, registered in one package."""
    class Softmax(mxop.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lbl = in_data[1].asnumpy().astype("int32")
            y = out_data[0].asnumpy().copy()
            y[np.arange(lbl.shape[0]), lbl] -= 1.0
            self.assign(in_grad[0], req[0], y / lbl.shape[0])
            self.assign(in_grad[1], req[1],
                        np.zeros_like(in_data[1].asnumpy()))

    @mxop.register("test_softmax" + suffix)
    class SoftmaxProp(mxop.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Scale2(mxop.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0].asnumpy() * 2.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * 2.0)

    @mxop.register("test_scale2" + suffix)
    class Scale2Prop(mxop.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Scale2()

    class FwdOnly(mxop.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2.0)

    @mxop.register("test_fwd_only" + suffix)
    class FwdOnlyProp(mxop.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def infer_shape(self, in_shape):
            return [in_shape[0]], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return FwdOnly()


# the JAX package's own test module registers these names too; the twins
# here take a suffix of their own
SUFFIX = "_port_parity"
_define(jop, SUFFIX)
_define(top, SUFFIX)


def both(case):
    out = {}
    for name, (mx, mxop) in PACKAGES.items():
        with _scope(mx):
            res = case(mx)
        out[name] = [r.asnumpy() if hasattr(r, "asnumpy") else np.asarray(r)
                     for r in (res if isinstance(res, (list, tuple))
                               else [res])]
    for a, b in zip(out["jax"], out["torch"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    return out["torch"]


def test_custom_imperative_forward():
    def case(mx):
        x = mx.nd.array(np.arange(6, dtype="float32").reshape(2, 3))
        return mx.nd.Custom(x, op_type="test_scale2" + SUFFIX)
    np.testing.assert_allclose(both(case)[0],
                               np.arange(6).reshape(2, 3) * 2.0)


def test_custom_autograd_backward():
    def case(mx):
        x = mx.nd.array(np.ones((2, 3), "float32"))
        mx.autograd.mark_variables([x], [mx.nd.zeros((2, 3))])
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type="test_scale2" + SUFFIX)
            loss = (y * y).sum()
        loss.backward()
        return y, x.grad
    y, g = both(case)
    np.testing.assert_allclose(g, 8.0 * np.ones((2, 3)))


def _softmax_ref(x, lbl):
    p = np.exp(x - x.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    g = p.copy()
    g[np.arange(len(lbl)), lbl.astype(int)] -= 1.0
    return p, g / len(lbl)


@pytest.mark.parametrize("op_type", ["test_softmax" + SUFFIX,
                                     "rtc_softmax"])
def test_custom_symbolic_forward_backward(op_type):
    rs = np.random.RandomState(0)
    x = rs.randn(4, 5).astype("float32")
    lbl = np.array([0, 2, 1, 4], "float32")
    p, g = _softmax_ref(x, lbl)

    def case(mx):
        if mx is jmx and op_type == "rtc_softmax":
            op = "rtc_softmax_pallas_twin"
        else:
            op = op_type
        net = mx.sym.Custom(mx.sym.Variable("data"), mx.sym.Variable("label"),
                            op_type=op, name="sm")
        ex = net.bind(mx.cpu(), {"data": mx.nd.array(x),
                                 "label": mx.nd.array(lbl)},
                      args_grad={"data": mx.nd.zeros((4, 5)),
                                 "label": mx.nd.zeros((4,))})
        ex.forward(is_train=True)
        out = ex.outputs[0].asnumpy()
        ex.backward()
        return out, ex.grad_dict["data"]
    out, grad = both(case)
    np.testing.assert_allclose(out, p, rtol=1e-5)
    np.testing.assert_allclose(grad, g, rtol=1e-5, atol=1e-6)


def test_custom_softmax_trains_mlp():
    """The reference's 'done' criterion in both packages: an MLP whose
    loss layer is a CustomOp learns through Module.fit (the port runs a
    graph with a Custom node on the split executor)."""
    rs = np.random.RandomState(3)
    X = rs.randn(120, 10).astype("float32")
    w = rs.randn(10, 3).astype("float32")
    y = (X @ w).argmax(axis=1).astype("float32")
    for name, (mx, _) in PACKAGES.items():
        it = mx.io.NDArrayIter(X, y, batch_size=20, shuffle=True,
                               label_name="label")
        fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                   name="fc")
        net = mx.sym.Custom(fc, mx.sym.Variable("label"),
                            op_type="test_softmax" + SUFFIX, name="loss")
        mod = mx.mod.Module(net, context=mx.cpu(), label_names=("label",))
        mod.fit(it, num_epoch=30, optimizer="sgd",
                initializer=mx.init.Xavier(),
                optimizer_params={"learning_rate": 1.0})
        if mx is tmx:
            assert mod._fused is None
        score = dict(mod.score(it, mx.metric.Accuracy(
            label_names=("label",))))
        assert score["accuracy"] > 0.9, (name, score)


def test_custom_op_forward_only():
    def case(mx):
        x = mx.nd.array(np.ones((2, 3), "float32"))
        return mx.nd.Custom(x, op_type="test_fwd_only" + SUFFIX)
    np.testing.assert_allclose(both(case)[0], 2 * np.ones((2, 3)))


def test_custom_unknown_op_type_raises():
    with tmx.cpu(), pytest.raises(tmx.MXNetError, match="nope"):
        tmx.nd.Custom(tmx.nd.zeros((2, 2)), op_type="nope")


def test_create_operator_gets_the_inputs_context():
    seen = []

    class Ident(top.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0])

    @top.register("ctx_probe")
    class IdentProp(top.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            seen.append((ctx, shapes, dtypes))
            return Ident()

    with tmx.cpu():
        tmx.nd.Custom(tmx.nd.ones((2, 2)), op_type="ctx_probe")
    assert seen == [(tmx.cpu(), [[2, 2]], ["float32"])]


# -- rtc_softmax against a JAX twin of Pallas bodies (interpret mode) -------

def _pallas_twin():
    import jax.numpy as jnp

    from mxnet_tpu.rtc import PallasKernel

    def fwd_body(x_ref, y_ref):
        x = x_ref[...]
        e = jnp.exp(x - jnp.max(x, axis=1, keepdims=True))
        y_ref[...] = e / jnp.sum(e, axis=1, keepdims=True)

    def bwd_body(y_ref, label_ref, dx_ref):
        y = y_ref[...]
        n, c = y.shape
        hot = (label_ref[...].astype(jnp.int32)[:, None]
               == jnp.arange(c)[None, :]).astype(y.dtype)
        dx_ref[...] = (y - hot) / n

    class Twin(jop.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            k = PallasKernel(fwd_body, [(in_data[0].shape, "float32")],
                             interpret=True)
            self.assign(out_data[0], req[0], k(in_data[0])[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            k = PallasKernel(bwd_body, [(out_data[0].shape, "float32")],
                             interpret=True)
            self.assign(in_grad[0], req[0], k(out_data[0], in_data[1])[0])
            self.assign(in_grad[1], req[1], in_data[1] * 0)

    @jop.register("rtc_softmax_pallas_twin")
    class TwinProp(jop.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Twin()


_pallas_twin()


@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_rtc_softmax_matches_the_pallas_twin(scale):
    """Forward and the logits' gradient under ``autograd.record()``, at
    ordinary and at ±1e4 logits (fp32, rtol 1e-5, atol 1e-6)."""
    rs = np.random.RandomState(8)
    x = (scale * rs.randn(6, 11)).astype("float32")
    lbl = rs.randint(0, 11, 6).astype("float32")

    def case(mx):
        op = "rtc_softmax" if mx is tmx else "rtc_softmax_pallas_twin"
        xa = mx.nd.array(x)
        xa.attach_grad()
        with mx.autograd.record():
            out = mx.nd.Custom(xa, mx.nd.array(lbl), op_type=op)
        out.backward()
        return out, xa.grad
    out, grad = both(case)
    p, g = _softmax_ref(x.astype(np.float64), lbl)
    np.testing.assert_allclose(out, p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad, g, rtol=1e-5, atol=1e-6)


def test_rtc_plain_bodies():
    """The CPU path of the three rtc kernels' wrappers is their plain
    version."""
    import torch

    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(4, 7).astype("float32"))
    y = torch.from_numpy(rs.randn(4, 7).astype("float32"))
    lbl = torch.tensor([0.0, 6.0, 3.9, 7.0])  # 3.9 truncates, 7 is out
    torch.testing.assert_close(rtc_ops.axpy(x, y), 2 * x + y)
    p = rtc_ops.softmax_forward(x)
    torch.testing.assert_close(p, torch.softmax(x, 1))
    d = rtc_ops.softmax_backward(p, lbl)
    want = p.clone()
    want[0, 0] -= 1
    want[1, 6] -= 1
    want[2, 3] -= 1
    torch.testing.assert_close(d, want / 4)
