"""The port's model zoo against the JAX package's, on the CPU.

* Each of the seven image-classification symbols (lenet, mlp, alexnet,
  vgg at every depth with and without BatchNorm, inception_bn,
  mobilenet at two multipliers, inception_v3) builds the same graph in
  both packages: node ops and attributes, argument, auxiliary and output
  names, and ``infer_shape`` at the published input sizes.  No compute.
* The forward of lenet, mlp, mobilenet and vgg11, at batch 2 and the
  smallest input each accepts, from one numpy state: within 1e-5
  relative.  alexnet, inception_bn and inception_v3 are left out of the
  forward check: their smallest inputs (67, 32 and 75 pixels a side with
  their pooling chains) take the JAX package seconds each on this CPU,
  and their ops are the same ones the four checked nets run.
"""
import json

import numpy as np
import pytest

from mxnet_tpu import models as jmodels
from mxnet_tpu import name as jname
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.base import MXNetError

IMAGENET = (3, 224, 224)
CASES = [
    ("lenet", {}, (1, 28, 28)),
    ("lenet", dict(add_stn=True, num_classes=7), (1, 28, 28)),
    ("mlp", {}, (1, 28, 28)),
    ("alexnet", {}, IMAGENET),
    ("vgg", dict(num_layers=11), IMAGENET),
    ("vgg", dict(num_layers=13, batch_norm=True), IMAGENET),
    ("vgg", dict(num_layers=16), IMAGENET),
    ("vgg", dict(num_layers=19, batch_norm=True), IMAGENET),
    ("inception_bn", {}, IMAGENET),
    ("mobilenet", {}, IMAGENET),
    ("mobilenet", dict(multiplier=0.5, num_classes=100), IMAGENET),
    ("inception_v3", {}, (3, 299, 299)),
]


def _build(name, kwargs):
    with jname.NameManager():
        j = jmodels.get_model(name, **kwargs)
    with tname.NameManager():
        t = tmodels.get_model(name, **kwargs)
    return j, t


@pytest.mark.parametrize("name,kwargs,image", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_symbol_matches_jax(name, kwargs, image):
    j, t = _build(name, kwargs)
    jn, tn = json.loads(j.tojson())["nodes"], json.loads(t.tojson())["nodes"]
    assert [n["op"] for n in tn] == [n["op"] for n in jn]
    assert [n["name"] for n in tn] == [n["name"] for n in jn]
    assert [n.get("attrs") for n in tn] == [n.get("attrs") for n in jn]
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    shapes = {"data": (32,) + image}
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)


def test_get_model_serves_all_nine_names():
    names = ["alexnet", "inception_bn", "inception_v3", "lenet", "mlp",
             "mobilenet", "resnet", "transformer", "vgg"]
    assert sorted(tmodels._MODELS) == sorted(jmodels._MODELS) == names
    with pytest.raises(MXNetError, match="vgg depth"):
        tmodels.get_model("vgg", num_layers=12)
    with pytest.raises(MXNetError, match="unknown model"):
        tmodels.get_model("googlenet")


def _state(arg_shapes, aux_shapes, seed=0):
    rs = np.random.RandomState(seed)
    args, aux = {}, {}
    for n, shp in arg_shapes.items():
        if n.endswith("_gamma"):
            args[n] = 1.0 + 0.1 * rs.randn(*shp)
        elif n.endswith(("_beta", "_bias")):
            args[n] = 0.1 * rs.randn(*shp)
        else:
            fan_in = int(np.prod(shp[1:])) if len(shp) > 1 else shp[0]
            args[n] = rs.randn(*shp) * np.sqrt(2.0 / fan_in)
    for n, shp in aux_shapes.items():
        aux[n] = (1.0 + 0.2 * rs.rand(*shp) if n.endswith("_var")
                  else 0.1 * rs.randn(*shp))
    cast = {k: v.astype(np.float32) for k, v in args.items()}
    return cast, {k: v.astype(np.float32) for k, v in aux.items()}


def _forward(pkg, sym, ctx, x, args, aux):
    exe = sym.simple_bind(ctx, grad_req="null", data=x.shape)
    for n, v in args.items():
        exe.arg_dict[n][:] = v
    for n, v in aux.items():
        exe.aux_dict[n][:] = v
    exe.arg_dict["data"][:] = x
    exe.forward(is_train=False)
    return exe.outputs[0].asnumpy()


@pytest.mark.parametrize("name,kwargs,image", [
    ("lenet", {}, (1, 28, 28)),
    ("mlp", {}, (1, 28, 28)),
    ("mobilenet", dict(multiplier=0.25, num_classes=10), (3, 32, 32)),
    ("vgg", dict(num_layers=11, num_classes=10), (3, 32, 32)),
])
def test_forward_matches_jax(name, kwargs, image):
    import mxnet_tpu as jmx

    j, t = _build(name, kwargs)
    x_shape = (2,) + image
    arg_shapes, _, aux_shapes = t.infer_shape(data=x_shape)
    args = {n: s for n, s in zip(t.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = dict(zip(t.list_auxiliary_states(), aux_shapes))
    args, aux = _state(args, auxs)
    x = np.random.RandomState(1).rand(*x_shape).astype(np.float32)
    want = _forward(jmx, j, jmx.cpu(), x, args, aux)
    got = _forward(tmx, t, tmx.cpu(), x, args, aux)
    assert got.shape == want.shape == (2, kwargs.get("num_classes", 10))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
