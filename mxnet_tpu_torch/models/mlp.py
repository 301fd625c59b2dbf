"""MLP (reference ``example/image-classification/symbols/mlp.py``).

Counterpart of ``mxnet_tpu/models/mlp.py`` over the port's ``symbol``."""
from .. import symbol as sym


def get_symbol(num_classes=10, **kwargs):
    data = sym.Variable("data")
    data = sym.Flatten(data)
    fc1 = sym.FullyConnected(data, num_hidden=128, name="fc1")
    act1 = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act1, num_hidden=64, name="fc2")
    act2 = sym.Activation(fc2, act_type="relu", name="relu2")
    fc3 = sym.FullyConnected(act2, num_hidden=num_classes, name="fc3")
    return sym.SoftmaxOutput(fc3, name="softmax")
