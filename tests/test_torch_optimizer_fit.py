"""The port's optimizers where users meet them — ``Module``,
``fused.TrainStep`` and ``gluon.Trainer`` — against the JAX package's,
on the CPU, from one numpy state.

* ``Module`` with each optimizer name of ``tests/test_module.py``'s list
  on a small MLP, 2 batches through the fused step, parameters within
  rtol 1e-5, atol 1e-6 (SGLD, whose noise is each package's own: moved
  and finite); the fused step's learning rate and ``t`` under a
  ``FactorScheduler``, step by step; the split path (forward, backward,
  ``update``) with ``clip_global_norm`` and a scheduler.
* A tiny transformer ``TrainStep`` (2 layers, d_model 64, T 16) under
  Adam + ``clip_global_norm`` 0.1, 3 steps (rtol 1e-4).
* ``gluon.Trainer("adam")`` over a tiny net, 2 steps (rtol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.gluon  # noqa: F401  (jmx.gluon)
import mxnet_tpu_torch as tmx
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu_torch import lr_scheduler as tsched

RTOL, ATOL = 1e-5, 1e-6

MODULE_NAMES = ["sgd", "adam", "adagrad", "rmsprop", "adadelta", "ftrl",
                "adamax", "nadam", "nag", "sgld", "dcasgd"]


def _mlp(sym):
    net = sym.Variable("data")
    net = sym.FullyConnected(net, num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=3, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _mlp_data():
    rs = np.random.RandomState(0)
    x = rs.randn(40, 6).astype(np.float32)
    y = rs.randint(0, 3, 40).astype(np.float32)
    params = {"fc1_weight": 0.5 * rs.randn(8, 6), "fc1_bias": rs.randn(8),
              "fc2_weight": 0.5 * rs.randn(3, 8), "fc2_bias": rs.randn(3)}
    return x, y, {k: v.astype(np.float32) for k, v in params.items()}


def _fit_two_batches(pkg, name, optimizer_params=None, hook=None):
    x, y, params = _mlp_data()
    it = pkg.io.NDArrayIter(x, y, batch_size=20)
    mod = pkg.mod.Module(_mlp(pkg.sym), context=pkg.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: pkg.nd.array(v)
                                for k, v in params.items()},
                    force_init=True)
    mod.init_optimizer(optimizer=name, kvstore=None,
                       optimizer_params=optimizer_params or {})
    if hook is not None:
        hook(mod)
    for batch in it:
        mod.forward_backward(batch)
        mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, params


@pytest.mark.parametrize("name", MODULE_NAMES)
def test_module_with_every_optimizer_name_matches_jax(name):
    with tmx.cpu():
        got, start = _fit_two_batches(tmx, name)
    want, _ = _fit_two_batches(jmx, name)
    for k in want:
        assert np.isfinite(got[k]).all()
        if name == "sgld":  # the noise is each package's own
            assert not np.array_equal(got[k], start[k]), k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg="%s %s" % (name, k))


def test_module_split_path_clips_by_the_global_norm(monkeypatch):
    """``Module.update`` on the split path (``MXNET_FUSED_STEP=0``:
    executor forward/backward, then the updater) under Adam with
    ``clip_global_norm`` (which binds) and a ``FactorScheduler``, against
    the JAX package's split path."""
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")

    def params(pkg):
        sched = tsched if pkg is tmx else jsched
        return dict(learning_rate=0.05, clip_global_norm=0.05,
                    lr_scheduler=sched.FactorScheduler(step=1, factor=0.5))

    with tmx.cpu():
        got, _ = _fit_two_batches(tmx, "adam", params(tmx))
    want, _ = _fit_two_batches(jmx, "adam", params(jmx))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_module_fused_path_reads_the_scheduler_per_step():
    """The fused step's learning rate is the scheduler's at the
    pre-increment update count, and ``t`` the post-increment one, as in
    the JAX package (2 epochs of 2 batches)."""
    def recorder(seen):
        def hook(mod):
            step = mod._fused

            def call(*args):
                seen.append((float(args[5]), int(args[6])))
                return step(*args)
            mod._fused = call
        return hook

    got, want = [], []
    for pkg, seen in ((tmx, got), (jmx, want)):
        opt_params = dict(learning_rate=0.2, lr_scheduler=(
            tsched if pkg is tmx else jsched).FactorScheduler(
                step=1, factor=0.5))
        if pkg is tmx:
            with tmx.cpu():
                _fit_two_batches(pkg, "sgd", opt_params, recorder(seen))
        else:
            _fit_two_batches(pkg, "sgd", opt_params, recorder(seen))
    assert got == want == [(0.2, 1), (0.2, 2)]


def test_train_step_adam_global_norm_clip_matches_jax(monkeypatch):
    """A tiny transformer TrainStep (2 layers, d_model 64, T 16) under
    Adam with ``clip_global_norm`` 0.1 (which binds: the gradients' norm
    is larger), 3 steps from one state, against the JAX package's."""
    from mxnet_tpu.fused import TrainStep as JaxStep
    from mxnet_tpu.models import transformer as jtransformer
    from mxnet_tpu_torch import fused
    from mxnet_tpu_torch.models import transformer as ttransformer

    monkeypatch.setenv("MXNET_ATTN_BLOCK", "16")
    monkeypatch.delenv("MXNET_ATTN_IMPL", raising=False)
    cfg = dict(vocab_size=48, num_layers=2, d_model=64, num_heads=4,
               seq_len=16)
    # epsilon 1e-6: the key projection's bias has a zero gradient in
    # exact arithmetic (softmax ignores a shift of every score), so each
    # package's rounding noise there, ~1e-11 after the clip, is all Adam
    # sees; at the default 1e-8 Adam would scale that noise up to a
    # step of order lr, different in each package
    opt_params = dict(learning_rate=1e-3, wd=0.01, clip_global_norm=0.1,
                      rescale_grad=0.5, epsilon=1e-6)
    shapes = {"data": (2, 16), "softmax_label": (2, 16)}
    jstep = JaxStep(jtransformer.get_symbol(**cfg), optimizer="adam",
                    optimizer_params=opt_params)
    tstep = fused.TrainStep(ttransformer.get_symbol(**cfg),
                            optimizer="adam", optimizer_params=opt_params,
                            device="cpu")
    jstate = jstep.init_state(shapes)
    host = [{k: None if v is None else
             (tuple(np.asarray(e) for e in v) if isinstance(v, tuple)
              else np.asarray(v)) for k, v in d.items()} for d in jstate]
    tstate = fused.state_from_numpy(*host, device="cpu")
    grads_norm = None
    for step in range(3):
        rs = np.random.RandomState(step)
        data = rs.randint(0, 48, (2, 16)).astype(np.float32)
        label = rs.randint(0, 48, (2, 16)).astype(np.float32)
        jp, ja, js, jo = jstep(*jstate, {"data": jnp.asarray(data),
                                         "softmax_label": jnp.asarray(label)},
                               jax.random.PRNGKey(0))
        tp, ta, ts, to = tstep(*tstate, {"data": torch.from_numpy(data),
                                         "softmax_label":
                                         torch.from_numpy(label)}, None)
        if grads_norm is None:  # the clip binds from the first step
            upd = {k: tp[k] - tstate[0][k] for k in tp}
            grads_norm = sum(float((u * u).sum()) for u in upd.values())
            assert grads_norm > 0
        np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]),
                                   rtol=1e-4, atol=1e-6)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
            for a, b in zip(ts[k], js[k]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-4, atol=1e-6, err_msg=k)
        jstate, tstate = (jp, ja, js), (tp, ta, ts)


def test_trainer_adam_two_steps_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(5, 3).astype(np.float32)
    y = rs.randint(0, 2, 5).astype(np.float32)
    w = [0.5 * rs.randn(4, 3), rs.randn(4), 0.5 * rs.randn(2, 4),
         rs.randn(2)]
    results = []
    for pkg in (jmx, tmx):
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Dense(4, in_units=3, activation="relu"),
                pkg.gluon.nn.Dense(2, in_units=4))
        ctx = pkg.cpu()
        net.initialize(ctx=ctx)
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.05, "wd": 0.01})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with ctx:
            for p, v in zip(net.collect_params().values(), w):
                p.set_data(pkg.nd.array(v.astype(np.float32)))
            for _ in range(2):
                with pkg.autograd.record():
                    loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
                loss.backward()
                trainer.step(5)
        results.append([p.data().asnumpy()
                        for p in net.collect_params().values()])
    for want, got in zip(*results):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
