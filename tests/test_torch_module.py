"""The port's Module surface against the JAX package's, on the CPU.

A tiny ResNet — ``resnet(units=[1, 1], num_stages=2, filter_list=[8, 32,
64], num_classes=10, image_shape=(3, 64, 64), bottle_neck=True)``: the
ImageNet stem (7×7 conv, ``bn0``, max ``Pooling``), two bottleneck units
with their projection shortcuts, the global average pool, ``Flatten``,
``FullyConnected`` and ``SoftmaxOutput`` — built by both packages'
``models.resnet`` from one numpy state:

* ``Module.fit`` for 2 steps of batch 4 (SGD, momentum 0.9), fp32 and
  ``compute_dtype="bfloat16"``;
* ``score`` and ``predict`` after the fp32 fit;
* ``simple_bind`` -> ``forward(is_train=True)`` -> ``backward()``;
* ``nd.save`` files and checkpoints written by one package, read by the
  other;
* ``NDArrayIter`` batches and the ``Accuracy``/``CrossEntropy`` values.

Each JAX fit runs once per module (a module-scoped fixture).

Tolerances: fp32 rtol 1e-4 with atol 1e-5 × the tensor's largest
magnitude (two SGD-momentum steps through 21 convolutions and 9
BatchNorms summed in other orders).  bf16: see
:func:`test_fit_bf16_matches_jax`.
"""
import os

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import name as jname
from mxnet_tpu.models import resnet as jresnet
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import resnet as tresnet

NET = dict(units=[1, 1], num_stages=2, filter_list=[8, 32, 64],
           num_classes=10, image_shape=(3, 64, 64), bottle_neck=True)
BATCH = 4
OPT = {"learning_rate": 0.1, "momentum": 0.9}
# seeds whose BatchNorm outputs stay >= 1e-5 from relu's kink in both
# fp32 steps (test_fit_fp32_matches_jax checks it): an input within
# rounding (~1e-6) of 0 passes its gradient or not by the last bit, which
# moves a channel's dbeta by percent between the packages
STATE_SEED, DATA_SEED = 28, 0


def _data(n=8, seed=DATA_SEED):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.float32)
    return x, y


def _state(sym, seed=STATE_SEED):
    """A numpy state for every parameter and aux state: He-normal
    weights, gammas near 1, small betas and biases, moving statistics
    near (0, 1)."""
    shapes = dict(zip(sym.list_arguments() + sym.list_auxiliary_states(),
                      sum(sym.infer_shape(data=(BATCH, 3, 64, 64),
                                          softmax_label=(BATCH,))[::2], [])))
    rs = np.random.RandomState(seed)
    arg, aux = {}, {}
    for n in sym.list_arguments():
        shp = shapes[n]
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            arg[n] = 1.0 + 0.1 * rs.randn(*shp)
        elif n.endswith(("_beta", "_bias")):
            arg[n] = 0.1 * rs.randn(*shp)
        else:
            arg[n] = rs.randn(*shp) * np.sqrt(2.0 / np.prod(shp[1:]))
    for n in sym.list_auxiliary_states():
        aux[n] = (0.1 * rs.randn(*shapes[n]) if n.endswith("_mean")
                  else 1.0 + 0.1 * rs.rand(*shapes[n]))
    cast = lambda d: {k: v.astype(np.float32) for k, v in d.items()}
    return cast(arg), cast(aux)


def _np(params):
    return {k: v.asnumpy().astype(np.float32) for k, v in params.items()}


def _jax_module(state):
    mod = jmx.mod.Module(jresnet.resnet(**NET), context=jmx.cpu())
    arg = {k: jmx.nd.array(v) for k, v in state[0].items()}
    aux = {k: jmx.nd.array(v) for k, v in state[1].items()}
    return mod, arg, aux


@pytest.fixture(scope="module")
def net():
    """The shared state and the JAX package's fp32 and bf16 fits."""
    sym = tresnet.resnet(**NET)
    state = _state(sym)
    x, y = _data()
    out = {"sym": sym, "state": state, "x": x, "y": y}
    for cd in (None, "bfloat16"):
        mod, arg, aux = _jax_module(state)
        mod.fit(jmx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                optimizer="sgd", optimizer_params=OPT, arg_params=arg,
                aux_params=aux, force_init=True, compute_dtype=cd)
        out[cd] = tuple(_np(p) for p in mod.get_params())
        if cd is None:
            out["jax_fp32_module"] = mod
    return out


def _port_fit(net, compute_dtype):
    mod = tmx.mod.Module(net["sym"], context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(net["x"], net["y"], batch_size=BATCH),
            num_epoch=1, optimizer="sgd", optimizer_params=OPT,
            arg_params=net["state"][0], aux_params=net["state"][1],
            force_init=True, compute_dtype=compute_dtype)
    return mod


def test_fit_fp32_matches_jax(net, monkeypatch):
    from mxnet_tpu_torch.ops import nn_ops

    bn_train, margins = nn_ops._bn_train, []

    def recording(*args):
        bn = bn_train(*args)

        def run(*xs):
            out = bn(*xs)
            margins.append(float(out[0].detach().abs().min()))
            return out
        return run

    monkeypatch.setattr(nn_ops, "_bn_train", recording)
    mod = _port_fit(net, None)
    # the seeds' premise: no BatchNorm output at relu's kink
    assert len(margins) == 2 * 9 and min(margins) >= 1e-5, min(margins)
    got = tuple(_np(p) for p in mod.get_params())
    for g, w, init in zip(got, net[None], net["state"]):
        assert sorted(g) == sorted(w)
        for k in w:
            if k != "bn_data_gamma":  # fix_gamma pins it
                assert not np.array_equal(w[k], init[k]), k  # it trained
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       atol=1e-5 * np.abs(w[k]).max(),
                                       err_msg=k)
    assert mod._optimizer.num_update == 2


def _update_err(got, want, init):
    """Relative L2 error of the update (new - old) per tensor."""
    return {k: np.linalg.norm((got[k] - init[k]) - (want[k] - init[k]))
            / max(np.linalg.norm(want[k] - init[k]), 1e-30) for k in want}


def test_fit_bf16_matches_jax(net):
    """Both bf16 fits are held against the JAX package's fp32 fit from the
    same state (the truth), by the relative L2 error of each tensor's
    update: the port's mean error over tensors may not exceed the JAX
    package's, nor any tensor's error twice the JAX package's (or 2^-8).
    XLA sums the BatchNorm parameter gradients in bf16 (bn_data's dβ is
    a sum of 16 k cancelling terms), the port in fp32, so the port's bf16
    fit is the nearer one in the mean; single tensors whose update is
    mostly bf16 noise on both sides scatter either way.  Measured here:
    mean error 0.73 against the JAX package's 6.1, worst ratio 1.51."""
    mod = _port_fit(net, "bfloat16")
    got = tuple(_np(p) for p in mod.get_params())
    ratios, port_mean, jax_mean = [], [], []
    for g, w, truth, init in zip(got, net["bfloat16"], net[None],
                                 net["state"]):
        for k in w:
            assert g[k].dtype == np.float32 and np.isfinite(g[k]).all()
        port, ref = _update_err(g, truth, init), _update_err(w, truth, init)
        for k in ref:
            if k == "bn_data_gamma":
                continue
            ratios.append(port[k] / max(ref[k], 2.0 ** -8))
            port_mean.append(port[k])
            jax_mean.append(ref[k])
    assert max(ratios) <= 2.0, max(ratios)
    assert np.mean(port_mean) <= np.mean(jax_mean), (np.mean(port_mean),
                                                     np.mean(jax_mean))


def test_score_and_predict_match_jax(net):
    mod = _port_fit(net, None)
    x, y = _data(n=6, seed=3)  # 6 = a full batch and a padded one
    jmod = net["jax_fp32_module"]
    want = jmod.predict(jmx.io.NDArrayIter(x, y, batch_size=BATCH))
    got = mod.predict(tmx.io.NDArrayIter(x, y, batch_size=BATCH))
    assert got.shape == (6, 10)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-4,
                               atol=1e-6)
    for metric in ("acc", "ce"):
        w = jmod.score(jmx.io.NDArrayIter(x, y, batch_size=BATCH), metric)
        g = mod.score(tmx.io.NDArrayIter(x, y, batch_size=BATCH), metric)
        assert [n for n, _ in g] == [n for n, _ in w]
        np.testing.assert_allclose([v for _, v in g], [v for _, v in w],
                                   rtol=1e-4)


def test_simple_bind_gradients_match_jax(net):
    x, y = net["x"][:BATCH], net["y"][:BATCH]
    shapes = {"data": x.shape, "softmax_label": y.shape}
    jex = jresnet.resnet(**NET).simple_bind(jmx.cpu(), **shapes)
    tex = net["sym"].simple_bind(tmx.cpu(), **shapes)
    for ex, nd in ((jex, jmx.nd), (tex, tmx.nd)):
        for k, v in net["state"][0].items():
            ex.arg_dict[k][:] = v
        for k, v in net["state"][1].items():
            ex.aux_dict[k][:] = v
    jex.forward(is_train=True, data=jmx.nd.array(x),
                softmax_label=jmx.nd.array(y))
    jex.backward()
    with tmx.cpu():
        tex.forward(is_train=True, data=tmx.nd.array(x),
                    softmax_label=tmx.nd.array(y))
    tex.backward()
    np.testing.assert_allclose(tex.outputs[0].asnumpy(),
                               jex.outputs[0].asnumpy(), rtol=1e-4,
                               atol=1e-6)
    assert sorted(tex.grad_dict) == sorted(jex.grad_dict)
    # atol 1e-3 x max: the stem's dγ sums 32 k terms that cancel to ~1e-3
    # of their size, so their fp32 rounding shows at 1e-4 of the result
    # (the JAX package's own eager and jitted gradients differ by 2e-4)
    for k, w in jex.grad_dict.items():
        w = w.asnumpy()
        np.testing.assert_allclose(tex.grad_dict[k].asnumpy(), w, rtol=1e-4,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)
    for k, w in jex.aux_dict.items():  # the moving-stat update
        np.testing.assert_allclose(tex.aux_dict[k].asnumpy(), w.asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # grad_req='add' accumulates a second backward
    tex2 = net["sym"].simple_bind(tmx.cpu(), grad_req="add", **shapes)
    tex2.copy_params_from({k: tmx.nd.array(v, tmx.cpu())
                           for k, v in net["state"][0].items()})
    for _ in range(2):
        tex2.forward(is_train=True, data=x, softmax_label=y)
        tex2.backward()
    k = "fc1_weight"
    assert tex2.grad_dict[k].shape == tex.grad_dict[k].shape
    with pytest.raises(MXNetError, match="before forward"):
        tex2.backward()


def test_split_update_matches_fused_step(net):
    """``forward``/``backward``/``update`` by hand (the executor and the
    updater) give the fused step's parameters."""
    x, y = net["x"][:BATCH], net["y"][:BATCH]
    batch = tmx.io.DataBatch([tmx.nd.array(x, tmx.cpu())],
                             [tmx.nd.array(y, tmx.cpu())])
    got = []
    for fused in (True, False):
        mod = tmx.mod.Module(net["sym"], context=tmx.cpu())
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        mod.init_params(arg_params=net["state"][0],
                        aux_params=net["state"][1])
        mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
        assert (mod._fused is not None) is True
        if fused:
            mod.forward_backward(batch)
        else:
            mod.forward(batch, is_train=True)
            mod.backward()
        mod.update()
        got.append(_np(mod.get_params()[0]))
    for k, w in got[0].items():
        np.testing.assert_allclose(got[1][k], w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_files_load_across_packages(tmp_path, net):
    rs = np.random.RandomState(4)
    arrays = {"a": rs.randn(3, 4).astype(np.float32),
              "b": rs.randint(0, 9, (5,)).astype(np.int32)}
    tpath, jpath = str(tmp_path / "port.nd"), str(tmp_path / "jax.nd")
    with tmx.cpu():
        tmx.nd.save(tpath, {k: tmx.nd.array(v) for k, v in arrays.items()})
        tmx.nd.save(tpath + "l", [tmx.nd.array(arrays["a"])])
    jmx.nd.save(jpath, {k: jmx.nd.array(v) for k, v in arrays.items()})
    for loaded in (jmx.nd.load(tpath + ".npz"),):
        for k, v in arrays.items():
            np.testing.assert_array_equal(loaded[k].asnumpy(), v)
    np.testing.assert_array_equal(jmx.nd.load(tpath + "l.npz")[0].asnumpy(),
                                  arrays["a"])
    with tmx.cpu():
        loaded = tmx.nd.load(jpath)
    for k, v in arrays.items():
        np.testing.assert_array_equal(loaded[k].asnumpy(), v)
        assert loaded[k].context == tmx.cpu()
    # a checkpoint written by the port loads in the JAX package, and back
    prefix = str(tmp_path / "net")
    arg = {k: tmx.nd.array(v, tmx.cpu()) for k, v in net["state"][0].items()}
    aux = {k: tmx.nd.array(v, tmx.cpu()) for k, v in net["state"][1].items()}
    tmx.save_checkpoint(prefix, 3, net["sym"], arg, aux)
    jsym, jarg, jaux = jmx.load_checkpoint(prefix, 3)
    assert jsym.tojson() == net["sym"].tojson()
    for k, v in net["state"][0].items():
        np.testing.assert_array_equal(jarg[k].asnumpy(), v)
    with tmx.cpu():
        tsym, targ, taux = tmx.load_checkpoint(prefix, 3)
    assert tsym.list_auxiliary_states() == net["sym"].list_auxiliary_states()
    np.testing.assert_array_equal(taux["bn0_moving_var"].asnumpy(),
                                  net["state"][1]["bn0_moving_var"])
    assert os.path.exists(prefix + "-0003.params")


@pytest.mark.parametrize("kwargs", [
    dict(shuffle=False), dict(shuffle=True, seed=5),
    dict(last_batch_handle="discard"), dict(last_batch_handle="roll_over")])
def test_ndarray_iter_and_metrics_match_jax(kwargs):
    rs = np.random.RandomState(6)
    x = rs.randn(10, 3).astype(np.float32)
    y = rs.randint(0, 3, 10).astype(np.float32)
    probs = rs.dirichlet(np.ones(3), 4).astype(np.float32)
    jit = jmx.io.NDArrayIter(x, y, batch_size=4, **kwargs)
    tit = tmx.io.NDArrayIter(x, y, batch_size=4, **kwargs)
    assert tit.provide_data == [tmx.io.DataDesc("data", (4, 3))]
    assert [d.shape for d in tit.provide_label] == [(4,)]
    jm = [jmx.metric.create(m) for m in ("acc", "ce", "loss")]
    tm = [tmx.metric.create(m) for m in ("acc", "ce", "loss")]
    for _ in range(2):  # two epochs: the reset reshuffles / rolls over
        jb, tb = list(jit), list(tit)
        assert len(jb) == len(tb)
        for j, t in zip(jb, tb):
            assert t.pad == j.pad
            np.testing.assert_array_equal(t.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())
            assert t.data[0].context == tmx.cpu()
            for a, b in zip(jm, tm):
                a.update(j.label, [jmx.nd.array(probs)])
                b.update(t.label, [tmx.nd.array(probs, tmx.cpu())])
        jit.reset()
        tit.reset()
    for a, b in zip(jm, tm):
        assert b.get()[0] == a.get()[0]
        np.testing.assert_allclose(b.get()[1], a.get()[1], rtol=1e-6)


def test_context_and_options_outside_the_slice():
    assert str(tmx.gpu(1)) == "gpu(1)" and tmx.tpu(0) == tmx.gpu(0)
    assert tmx.current_context() == tmx.gpu(0)
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        assert tmx.nd.zeros((2,)).context == tmx.cpu()
    if not torch.cuda.is_available():  # the default is the card
        with pytest.raises(MXNetError, match=r"mx\.cpu\(\)"):
            tmx.mod.Module(tresnet.resnet(**NET))
    mod = tmx.mod.Module(tresnet.resnet(**NET), context=tmx.cpu())
    it = tmx.io.NDArrayIter(*_data(n=4), batch_size=BATCH)
    for kwargs in (dict(kvstore="dist_sync"), dict(monitor=object()),
                   dict(zero="on"), dict(elastic=True)):
        with pytest.raises(MXNetError, match="later slice"):
            mod.fit(it, num_epoch=1, **kwargs)


def test_prefetch_worker_error_surfaces(monkeypatch):
    from mxnet_tpu_torch.testing import faults

    monkeypatch.setenv("MXNET_FAULT_INJECT", "device_prefetch:raise:after=2")
    faults.reset()
    try:
        it = tmx.io.DevicePrefetchIter(
            tmx.io.NDArrayIter(*_data(n=12), batch_size=BATCH))
        assert next(it).staged
        with pytest.raises(faults.FaultInjected):
            next(it)
        it.close()
    finally:
        monkeypatch.delenv("MXNET_FAULT_INJECT")
        faults.reset()


# ---------------------------------------------------------------------------
# the layer ops ResNet adds, and the NHWC graph
# ---------------------------------------------------------------------------

def _op_parity(name, attrs, arrays, seed=0):
    """Forward and input gradients of op ``name`` in both packages for one
    numpy-seeded cotangent (fp32; rtol 1e-5, atol 1e-5 x max)."""
    import jax.numpy as jnp

    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg

    def jfn(*xs):
        return jreg.get(name).compute(jreg.FrozenAttrs(attrs), *xs)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in arrays))
    g = np.random.RandomState(seed).randn(*want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    got = treg.get(name).compute(treg.FrozenAttrs(attrs), *xs)
    got.backward(torch.from_numpy(g))
    for t, w in [(got, want)] + list(zip([x.grad for x in xs], want_grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", ["valid", "full", "global"])
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
def test_pooling_matches_jax(pool_type, mode, layout):
    rs = np.random.RandomState(11)
    x = rs.randn(2, 3, 9, 8).astype(np.float32)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    attrs = {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
             "pool_type": pool_type, "layout": layout,
             "global_pool": mode == "global",
             "pooling_convention": "full" if mode == "full" else "valid"}
    _op_parity("Pooling", attrs, [x])


@pytest.mark.parametrize("layout,attrs", [
    ("NCHW", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}),
    ("NCHW", {"kernel": (3, 3), "dilate": (2, 2), "num_group": 2}),
    ("NHWC", {"kernel": (1, 1), "stride": (2, 2), "no_bias": True})])
def test_convolution_matches_jax(layout, attrs):
    rs = np.random.RandomState(12)
    groups = attrs.get("num_group", 1)
    x = rs.randn(2, 4, 7, 6).astype(np.float32)
    w = (0.3 * rs.randn(6, 4 // groups, *attrs["kernel"])).astype(
        np.float32)
    if layout == "NHWC":
        x, w = x.transpose(0, 2, 3, 1).copy(), w.transpose(0, 2, 3, 1).copy()
    arrays = [x, w] + ([] if attrs.get("no_bias") else
                       [rs.randn(6).astype(np.float32)])
    _op_parity("Convolution", dict(attrs, num_filter=6, layout=layout),
               arrays)


def test_nhwc_resnet_forward_matches_jax():
    """The CIFAR-stem ResNet-8 in NHWC: both packages' symbols agree in
    JSON, shapes and the forward in both modes from one state."""
    kw = dict(num_classes=4, num_layers=8, image_shape=(3, 32, 32),
              layout="NHWC")
    # fresh name scopes: the auto-generated names count per package and
    # per process, so symbols other tests built first would shift them
    with tname.NameManager():
        tsym = tresnet.get_symbol(**kw)
    with jname.NameManager():
        jsym = jresnet.get_symbol(**kw)
    assert tsym.tojson() == jsym.tojson()
    shapes = {"data": (2, 32, 32, 3), "softmax_label": (2,)}
    assert tsym.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    rs = np.random.RandomState(13)
    arg_shapes, _, aux_shapes = tsym.infer_shape(**shapes)
    x = rs.rand(2, 32, 32, 3).astype(np.float32)
    y = np.array([1, 3], np.float32)
    jex = jsym.simple_bind(jmx.cpu(), grad_req="null", **shapes)
    tex = tsym.simple_bind(tmx.cpu(), grad_req="null", **shapes)
    for name, shp in zip(tsym.list_arguments(), arg_shapes):
        if name not in shapes:
            v = (rs.randn(*shp) * (0.1 if len(shp) == 1 else
                                   np.sqrt(2.0 / np.prod(shp[1:])))
                 + (1.0 if name.endswith("_gamma") else 0.0))
            jex.arg_dict[name][:] = tex.arg_dict[name][:] = \
                v.astype(np.float32)
    for name, shp in zip(tsym.list_auxiliary_states(), aux_shapes):
        v = 0.1 * rs.randn(*shp) + (1.0 if name.endswith("_var") else 0.0)
        jex.aux_dict[name][:] = tex.aux_dict[name][:] = v.astype(np.float32)
    for is_train in (False, True):
        want = jex.forward(is_train=is_train, data=jmx.nd.array(x),
                           softmax_label=jmx.nd.array(y))[0].asnumpy()
        got = tex.forward(is_train=is_train, data=x,
                          softmax_label=y)[0].asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
