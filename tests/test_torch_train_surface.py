"""The rest of the port's training surface against the JAX package's, on
the CPU: the metrics F1, Perplexity, MAE, MSE and RMSE; the initializers
Bilinear, LSTMBias, Orthogonal, Load and Mixed; the callbacks
``module_checkpoint`` and ``ProgressBar``; the iterators ``CSVIter``,
``LibSVMIter``, ``MNISTIter``, ``ResizeIter`` and ``PrefetchingIter``
over small files written here; ``FeedForward``; and the default context
under nested ``with`` blocks.

Tolerances: the metrics and the deterministic initializers are computed
by the same numpy code in both packages and must be equal (rtol 1e-12);
the iterators copy values and must be equal; FeedForward's fit is two
epochs of SGD on a small MLP from one state, within rtol 1e-5, atol 1e-6
(fp32 matmuls summed in other orders).
"""
import gzip
import logging
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

PKGS = (jmx, tmx)


# -- metrics ---------------------------------------------------------------

def _metric_inputs(seed=0):
    rs = np.random.RandomState(seed)
    cls_label = rs.randint(0, 2, 12).astype(np.float32)
    cls_pred = rs.rand(12, 2).astype(np.float32)
    lm_label = rs.randint(0, 5, (3, 4)).astype(np.float32)
    lm_pred = rs.dirichlet(np.ones(5), 12).astype(np.float32)
    reg_label = rs.randn(12).astype(np.float32)
    reg_pred = rs.randn(12, 1).astype(np.float32)
    return dict(f1=(cls_label, cls_pred), perplexity=(lm_label, lm_pred),
                mae=(reg_label, reg_pred), mse=(reg_label, reg_pred),
                rmse=(reg_label, reg_pred))


@pytest.mark.parametrize("name,kwargs", [
    ("f1", {}), ("perplexity", dict(ignore_label=None)),
    ("perplexity", dict(ignore_label=2)), ("mae", {}), ("mse", {}),
    ("rmse", {})])
def test_metric_matches_jax(name, kwargs):
    values = []
    for pkg in PKGS:
        m = pkg.metric.create(name, **kwargs)
        for seed in (0, 1):
            label, pred = _metric_inputs(seed)[name]
            m.update([pkg.nd.array(label, pkg.cpu())],
                     [pkg.nd.array(pred, pkg.cpu())])
        values.append(m.get())
    assert values[1][0] == values[0][0]
    np.testing.assert_allclose(values[1][1], values[0][1], rtol=1e-12)
    assert np.isfinite(values[1][1])


def test_f1_refuses_non_binary_labels():
    with pytest.raises(ValueError, match="binary"):
        tmx.metric.F1().update([np.array([0., 2.])],
                               [np.array([[0.1, 0.9], [0.8, 0.2]])])


# -- initializers ----------------------------------------------------------

def _init(pkg, init, name, shape):
    arr = pkg.nd.zeros(shape, pkg.cpu())
    init(pkg.init.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("make,name,shape", [
    (lambda p: p.init.Bilinear(), "up_weight", (2, 1, 4, 4)),
    (lambda p: p.init.Bilinear(), "up_weight", (1, 1, 3, 5)),
    (lambda p: p.init.Xavier(), "deconv_upsampling", (1, 2, 4, 4)),
    (lambda p: p.init.LSTMBias(forget_bias=2.0), "lstm_i2h_bias", (16,)),
])
def test_deterministic_initializers_match_jax(make, name, shape):
    want, got = (_init(p, make(p), name, shape) for p in PKGS)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got.any()


@pytest.mark.parametrize("shape,rand_type", [
    ((8, 12), "uniform"), ((12, 8), "normal"), ((6, 2, 3, 3), "uniform")])
def test_orthogonal_is_orthogonal_at_its_scale(shape, rand_type):
    scale = 1.414
    w = _init(tmx, tmx.init.Orthogonal(scale=scale, rand_type=rand_type),
              "fc_weight", shape).reshape(shape[0], -1).astype(np.float64)
    gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(gram, scale ** 2 * np.eye(len(gram)),
                               atol=1e-5)
    other = _init(tmx, tmx.init.Orthogonal(scale=scale, rand_type=rand_type),
                  "fc2_weight", shape)
    assert not np.allclose(other.reshape(w.shape), w)


def test_load_and_mixed_read_a_saved_params_file(tmp_path):
    rs = np.random.RandomState(3)
    saved = {"arg:fc1_weight": rs.randn(4, 3).astype(np.float32),
             "aux:bn_moving_var": rs.rand(4).astype(np.float32)}
    path = str(tmp_path / "net-0001.params")
    tmx.nd.save(path, {k: tmx.nd.array(v, tmx.cpu())
                       for k, v in saved.items()})
    with tmx.cpu():
        loaded = tmx.nd.load(path)
    load = tmx.init.Load(loaded, default_init=tmx.init.Constant(0.25))
    np.testing.assert_array_equal(_init(tmx, load, "fc1_weight", (4, 3)),
                                  saved["arg:fc1_weight"])
    np.testing.assert_array_equal(_init(tmx, load, "bn_moving_var", (4,)),
                                  saved["aux:bn_moving_var"])
    np.testing.assert_array_equal(_init(tmx, load, "fc2_weight", (2, 2)),
                                  np.full((2, 2), 0.25, np.float32))
    with pytest.raises(MXNetError, match="wrong shape"):
        _init(tmx, load, "fc1_weight", (3, 4))
    with pytest.raises(MXNetError, match="no default init"):
        _init(tmx, tmx.init.Load(loaded), "fc9_weight", (2,))
    mixed = tmx.init.Mixed(["fc1_.*", ".*_bias", ".*"],
                           [load, tmx.init.Zero(), tmx.init.One()])
    np.testing.assert_array_equal(_init(tmx, mixed, "fc1_weight", (4, 3)),
                                  saved["arg:fc1_weight"])
    assert not _init(tmx, mixed, "fc2_bias", (3,)).any()
    assert (_init(tmx, mixed, "fc2_weight", (3, 2)) == 1).all()
    with pytest.raises(MXNetError, match="did not match"):
        _init(tmx, tmx.init.Mixed(["fc.*"], [load]), "conv_weight", (1,))


# -- the small MLP of tests/test_prefetch.py -------------------------------

def _data(n=80, d=6, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, d).astype("float32")
    w = rs.randn(d, 3).astype("float32")
    return X, (X @ w).argmax(axis=1).astype("float32")


def _mlp(pkg):
    net = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(net, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax",
                                 normalization="batch")


def _mlp_state(seed=5):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": 0.5 * rs.randn(8, 6), "fc1_bias": 0.1 * rs.randn(8),
            "fc2_weight": 0.5 * rs.randn(3, 8), "fc2_bias": 0.1 * rs.randn(3)}


def test_module_checkpoint_writes_what_module_load_reads(tmp_path):
    X, y = _data()
    prefix = str(tmp_path / "mlp")
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=20), num_epoch=2,
            initializer=tmx.init.Xavier(),
            epoch_end_callback=tmx.callback.module_checkpoint(mod, prefix,
                                                              period=2))
    assert (tmp_path / "mlp-symbol.json").exists()
    assert (tmp_path / "mlp-0002.params").exists()
    assert not (tmp_path / "mlp-0001.params").exists()
    with tmx.cpu():  # a checkpoint's arrays land on the current context
        back = tmx.mod.Module.load(prefix, 2, context=tmx.cpu())
    back.bind([("data", (20, 6))], [("softmax_label", (20,))])
    back.init_params()
    want, got = mod.get_params()[0], back.get_params()[0]
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    # with the optimizer states: prefix-0001.states, read back by
    # Module.load(load_optimizer_states=True) at init_optimizer
    tmx.callback.module_checkpoint(mod, prefix,
                                   save_optimizer_states=True)(0)
    assert (tmp_path / "mlp-0001.states").exists()
    with tmx.cpu():
        again = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                    context=tmx.cpu())
    again.bind([("data", (20, 6))], [("softmax_label", (20,))])
    again.init_params()
    again.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1,
                                           "momentum": 0.9})
    assert set(again._fused_states) == set(mod._fused_states)


def test_progress_bar_logs_the_share_done(caplog):
    bar = tmx.callback.ProgressBar(total=8, length=16)
    with caplog.at_level(logging.INFO):
        bar(tmx.module.BatchEndParam(epoch=0, nbatch=2, eval_metric=None))
    assert "[====------------] 25%" in caplog.text


def test_feedforward_fit_matches_jax():
    X, y = _data()
    state = _mlp_state()
    results = []
    for pkg in PKGS:
        args = {k: pkg.nd.array(v.astype(np.float32), pkg.cpu())
                for k, v in state.items()}
        np.random.seed(11)  # both NDArrayIters shuffle from np.random
        model = pkg.model.FeedForward(
            _mlp(pkg), ctx=pkg.cpu(), num_epoch=2, numpy_batch_size=20,
            arg_params=args, learning_rate=0.5)
        model.fit(X, y)
        params = {k: v.asnumpy() for k, v in model.arg_params.items()}
        acc = model.score(pkg.io.NDArrayIter(X, y, batch_size=20))
        results.append((params, model.predict(X[:30]), acc))
    (want, want_pred, want_acc), (got, got_pred, got_acc) = results
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got_pred, want_pred, rtol=1e-5, atol=1e-6)
    assert got_pred.shape == (30, 3)
    assert got_acc == pytest.approx(want_acc)


# -- iterators -------------------------------------------------------------

def _batches(it):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [l.asnumpy() for l in (b.label or [])], b.pad))
    return out


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(g, w)


def test_csv_iter_matches_jax(tmp_path):
    rs = np.random.RandomState(0)
    np.savetxt(tmp_path / "d.csv", rs.randn(10, 6), delimiter=",")
    np.savetxt(tmp_path / "l.csv", rs.randint(0, 3, 10), delimiter=",")
    got, want = (_batches(p.io.CSVIter(
        data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
        label_csv=str(tmp_path / "l.csv"), batch_size=4)) for p in
        (tmx, jmx))
    _same_batches(got, want)
    assert got[0][0][0].shape == (4, 2, 3) and got[-1][2] == 2


def test_libsvm_iter_matches_jax_dense(tmp_path):
    lines = ["1 0:0.5 3:1.5", "0 2:2.0", "1 1:-1.0 4:3.0 5:0.25", "0",
             "1 5:7.0"]
    (tmp_path / "d.libsvm").write_text("\n".join(lines) + "\n")
    for kwargs in (dict(), dict(num_parts=2, part_index=1)):
        its = [p.io.LibSVMIter(data_libsvm=str(tmp_path / "d.libsvm"),
                               data_shape=(6,), batch_size=2, **kwargs)
               for p in (tmx, jmx)]
        assert its[0].provide_data == its[1].provide_data
        got, want = _batches(its[0]), []
        for b in its[1]:
            want.append(([b.data[0].asnumpy()], [b.label[0].asnumpy()],
                         b.pad))
        _same_batches(got, want)


def _write_idx(path, arr, gz=False):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    payload = header + arr.astype(np.uint8).tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(payload)


@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter_matches_jax(tmp_path, flat):
    rs = np.random.RandomState(1)
    _write_idx(str(tmp_path / "img"), rs.randint(0, 256, (7, 28, 28)))
    _write_idx(str(tmp_path / "lab.gz"), rs.randint(0, 10, (7,)), gz=True)
    got, want = (_batches(p.io.MNISTIter(
        image=str(tmp_path / "img"), label=str(tmp_path / "lab"),
        batch_size=3, shuffle=False, flat=flat)) for p in (tmx, jmx))
    _same_batches(got, want)
    assert got[0][0][0].shape == ((3, 784) if flat else (3, 1, 28, 28))


def test_resize_iter_matches_jax():
    X, y = _data(n=10)
    got, want = (_batches(p.io.ResizeIter(
        p.io.NDArrayIter(X, y, batch_size=4), size=5)) for p in (tmx, jmx))
    _same_batches(got, want)
    assert len(got) == 5


def test_prefetching_iter_matches_jax():
    X, y = _data(n=12)
    results = []
    for p in (tmx, jmx):
        it = p.io.PrefetchingIter(
            [p.io.NDArrayIter(X, y, batch_size=4),
             p.io.NDArrayIter({"extra": 2 * X}, batch_size=4)],
            rename_data=[{"data": "x"}, None])
        assert [d.name for d in it.provide_data] == ["x", "extra"]
        first = _batches(it)
        it.reset()
        results.append((first, _batches(it)))
        it.close()
    _same_batches(results[0][0], results[1][0])
    _same_batches(results[0][1], results[0][0])


# -- the default context ---------------------------------------------------

def test_reentered_context_restores_the_outer_default():
    c, g = tmx.cpu(), tmx.gpu(0)
    before = tmx.current_context()
    with c:
        with c:
            assert tmx.current_context() == c
        assert tmx.current_context() == c
        with g:
            with c:
                assert tmx.current_context() == c
            assert tmx.current_context() == g
        assert tmx.current_context() == c
    assert tmx.current_context() == before
