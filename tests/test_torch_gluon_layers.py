"""The port's Gluon layers against the JAX package's, on the CPU.

Each layer is built in both packages, initialized by the JAX package and
carried into the port (``Parameter.set_data`` from numpy); the same
numpy input and cotangent then give the forward, the input's gradient
and every parameter's gradient under ``autograd.record()`` in both (fp32,
rtol 1e-5).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.gluon  # noqa: F401
import mxnet_tpu_torch as tmx

RTOL = 1e-5


def close(got, want, rtol=RTOL, scale_atol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=scale_atol * max(float(np.abs(want).max(initial=0.0)), 1e-30))


def carry(jnet, tnet):
    """Copy the JAX block's parameters into the port's, by position (the
    auto-generated names count per package)."""
    jps = list(jnet.collect_params().values())
    tps = list(tnet.collect_params().values())
    assert len(jps) == len(tps)
    for jp, tp in zip(jps, tps):
        assert tuple(jp.shape) == tuple(tp.shape), (jp.name, tp.name)
        tp.set_data(jp.data().asnumpy())


def build(make, x, init=None):
    """The same block in both packages, initialized by the JAX package
    (``init``: an initializer name), shapes resolved by one predict-mode
    forward, and carried over."""
    jnet, tnet = make(jmx), make(tmx)
    jinit = getattr(jmx.init, init)() if init else None
    jnet.initialize(jinit)
    tnet.initialize(ctx=tmx.cpu())
    jnet(jmx.nd.array(x))
    with tmx.cpu():
        tnet(tmx.nd.array(x))
    carry(jnet, tnet)
    return jnet, tnet


def run_grads(mx, net, x, cot):
    """Forward under record, backward of sum(out * cot): the output, the
    input's gradient and every parameter's gradient (None without one)."""
    xa = mx.nd.array(x)
    xa.attach_grad()
    with mx.autograd.record():
        out = net(xa)
        loss = mx.nd.sum(out * mx.nd.array(cot))
    loss.backward()
    grads = [p.grad().asnumpy() if p.grad_req != "null" else
             p.data().asnumpy() for p in net.collect_params().values()]
    return out.asnumpy(), xa.grad.asnumpy(), grads


LAYERS = {
    "dense": (lambda mx: mx.gluon.nn.Dense(5, activation="tanh"), (3, 7)),
    "dense_noflatten": (lambda mx: mx.gluon.nn.Dense(4, flatten=False),
                        (2, 3, 6)),
    "conv2d": (lambda mx: mx.gluon.nn.Conv2D(4, 3, strides=2, padding=1,
                                             activation="relu"),
               (2, 3, 9, 9)),
    "conv1d": (lambda mx: mx.gluon.nn.Conv1D(3, 3, groups=1), (2, 2, 8)),
    "conv3d": (lambda mx: mx.gluon.nn.Conv3D(2, 2), (1, 2, 4, 4, 4)),
    "conv2d_transpose": (lambda mx: mx.gluon.nn.Conv2DTranspose(
        3, 3, strides=2, padding=1), (2, 4, 5, 5)),
    "batchnorm": (lambda mx: mx.gluon.nn.BatchNorm(), (4, 3, 5, 5)),
    "instancenorm": (lambda mx: mx.gluon.nn.InstanceNorm(), (2, 3, 4, 4)),
    "layernorm": (lambda mx: mx.gluon.nn.LayerNorm(), (3, 4, 6)),
    "activation_sigmoid": (lambda mx: mx.gluon.nn.Activation("sigmoid"),
                           (3, 5)),
    "leakyrelu": (lambda mx: mx.gluon.nn.LeakyReLU(0.1), (3, 5)),
    "maxpool": (lambda mx: mx.gluon.nn.MaxPool2D(3, 2, 1), (2, 3, 7, 7)),
    "avgpool": (lambda mx: mx.gluon.nn.AvgPool2D(2), (2, 3, 6, 6)),
    "globalavgpool": (lambda mx: mx.gluon.nn.GlobalAvgPool2D(),
                      (2, 3, 4, 4)),
    "globalmaxpool": (lambda mx: mx.gluon.nn.GlobalMaxPool2D(),
                      (2, 3, 4, 4)),
    "flatten_dense": (lambda mx: _seq(mx, mx.gluon.nn.Flatten(),
                                      mx.gluon.nn.Dense(3)), (2, 3, 2, 2)),
    "dropout_p0": (lambda mx: mx.gluon.nn.Dropout(0.0), (3, 4)),
    "mha": (lambda mx: mx.gluon.nn.MultiHeadAttention(num_heads=2),
            (2, 5, 8)),
}


def _seq(mx, *blocks):
    net = mx.gluon.nn.HybridSequential()
    net.add(*blocks)
    return net


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients(name):
    make, shape = LAYERS[name]
    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype("float32")
    jnet, tnet = build(make, x, "Xavier")
    cot = rs.randn(*jnet(jmx.nd.array(x)).shape).astype("float32")
    jres = run_grads(jmx, jnet, x, cot)
    with tmx.cpu():
        tres = run_grads(tmx, tnet, x, cot)
    close(tres[0], jres[0])
    close(tres[1], jres[1])
    for g, w in zip(tres[2], jres[2]):
        close(g, w)
