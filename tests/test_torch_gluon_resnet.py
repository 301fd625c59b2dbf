"""A tiny Gluon ResNet trained by the port against the JAX package.

``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 16, 32, 32], classes=10,
thumbnail=True)`` and its ``ResNetV2`` twin at 16x16, batch 4, for 3
fp32 ``Trainer`` steps (SGD, momentum 0.9) through the tentpole loop
(``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` -> ``backward()``
-> ``Trainer.step``), from one Xavier state made by the JAX package and
carried into the port: every parameter and running statistic is compared
after each step (rtol 1e-4, atol 1e-5 x the tensor's largest magnitude:
three steps through 16 convolutions and 13 BatchNorms summed in other
orders).  Most of this file's time is the JAX package's first eager
backward, which compiles each primitive once.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

TRAIN_RTOL = 1e-4


def close(got, want, rtol=TRAIN_RTOL, scale_atol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=scale_atol * max(float(np.abs(want).max(initial=0.0)), 1e-30))


def _tiny_resnet(mx, version):
    v = jvision if mx is jmx else tvision
    if version == 1:
        return v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1], [8, 16, 16, 32, 32],
                          classes=10, thumbnail=True)
    return v.ResNetV2(v.BottleneckV2, [1, 1, 1, 1], [8, 16, 16, 32, 32],
                      classes=10, thumbnail=True)


XAVIER = dict(rnd_type="gaussian", factor_type="in", magnitude=2)
SGD = {"learning_rate": 0.1, "momentum": 0.9}


def _resnet_data(steps=3, batch=4, seed=11):
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, 3, 16, 16).astype("float32"),
             rs.randint(0, 10, batch).astype("float32"))
            for _ in range(steps)]


def _train(mx, net, data):
    """Steps of the tentpole loop; every parameter after each step."""
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", SGD)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    after = []
    for x, y in data:
        xa = mx.nd.array(x)
        with mx.autograd.record():
            loss = loss_fn(net(xa).astype("float32"), mx.nd.array(y))
        loss.backward()
        trainer.step(x.shape[0])
        after.append([p.data().asnumpy().astype(np.float64)
                      for p in net.collect_params().values()])
    return after


@pytest.fixture(scope="module")
def jax_resnet_runs():
    out = {}
    for version in (1, 2):
        data = _resnet_data()
        jnet = _tiny_resnet(jmx, version)
        jnet.initialize(jmx.init.Xavier(**XAVIER))
        jnet(jmx.nd.array(data[0][0]))
        init = [p.data().asnumpy() for p in jnet.collect_params().values()]
        out[version] = (init, _train(jmx, jnet, data))
    return out


def _port_net(version, init):
    net = _tiny_resnet(tmx, version)
    net.initialize(ctx=tmx.cpu())
    with tmx.cpu():
        net(tmx.nd.zeros((1, 3, 16, 16)))
    for p, v in zip(net.collect_params().values(), init):
        p.set_data(v)
    return net


@pytest.mark.parametrize("version", [1, 2])
def test_tiny_resnet_trainer_steps_match_jax(jax_resnet_runs, version):
    init, want = jax_resnet_runs[version]
    net = _port_net(version, init)
    with tmx.cpu():
        got = _train(tmx, net, _resnet_data())
    names = list(net.collect_params().keys())
    for step, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(names, g, w):
            assert np.isfinite(a).all(), (step, name)
            close(a, b, rtol=TRAIN_RTOL, scale_atol=1e-5)
    changed = [not np.array_equal(a, b) for a, b in zip(got[-1], init)]
    assert sum(changed) >= len(init) - 2  # fix-gamma-free net: all move


