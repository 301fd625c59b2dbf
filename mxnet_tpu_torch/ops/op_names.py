"""Per-op input/aux naming metadata for the Symbol frontend.

In the reference, each operator property declares its argument names
(``ListArguments``/``ListAuxiliaryStates``, ``include/mxnet/operator.h``),
which is how ``Symbol.list_arguments()`` produces ``conv0_weight``,
``bn0_moving_mean`` … and how ``simple_bind`` knows what to allocate.
This table provides the same metadata for the port's registry; it is the
port's own copy of ``mxnet_tpu/ops/op_names.py``.

``aux`` marks trailing inputs that are *auxiliary states* (not arguments,
not differentiated — reference ``MXSymbolListAuxiliaryStates``); these must
line up with the op's ``mutable_inputs``.
"""
from __future__ import annotations

# op name -> (input names, aux input names)
INPUT_NAMES = {
    "FullyConnected": (("data", "weight", "bias"), ()),
    "Convolution": (("data", "weight", "bias"), ()),
    "Convolution_v1": (("data", "weight", "bias"), ()),
    "Deconvolution": (("data", "weight", "bias"), ()),
    "BatchNorm": (("data", "gamma", "beta"), ("moving_mean", "moving_var")),
    "BatchNorm_v1": (("data", "gamma", "beta"), ("moving_mean", "moving_var")),
    "Embedding": (("data", "weight"), ()),
    "LeakyReLU": (("data", "gamma"), ()),
    "InstanceNorm": (("data", "gamma", "beta"), ()),
    "LayerNorm": (("data", "gamma", "beta"), ()),
    "SoftmaxOutput": (("data", "label"), ()),
    "Softmax": (("data", "label"), ()),
    "LinearRegressionOutput": (("data", "label"), ()),
    "MAERegressionOutput": (("data", "label"), ()),
    "LogisticRegressionOutput": (("data", "label"), ()),
    "SVMOutput": (("data", "label"), ()),
    "softmax_cross_entropy": (("data", "label"), ()),
    "SequenceMask": (("data", "sequence_length"), ()),
    "SequenceLast": (("data", "sequence_length"), ()),
    "SequenceReverse": (("data", "sequence_length"), ()),
    "BilinearSampler": (("data", "grid"), ()),
    "SpatialTransformer": (("data", "loc"), ()),
    "GridGenerator": (("data",), ()),
    "ROIPooling": (("data", "rois"), ()),
    "dot": (("lhs", "rhs"), ()),
    "batch_dot": (("lhs", "rhs"), ()),
    "where": (("condition", "x", "y"), ()),
    "take": (("a", "indices"), ()),
    "RNN": (("data", "parameters", "state", "state_cell"), ()),
    "MultiBoxTarget": (("anchor", "label", "cls_pred"), ()),
    "MultiBoxDetection": (("cls_prob", "loc_pred", "anchor"), ()),
    "Proposal": (("cls_prob", "bbox_pred", "im_info"), ()),
    "MultiProposal": (("cls_prob", "bbox_pred", "im_info"), ()),
    "PSROIPooling": (("data", "rois"), ()),
    "DeformableConvolution": (("data", "offset", "weight", "bias"), ()),
    "CTCLoss": (("data", "label"), ()),
    "Correlation": (("data1", "data2"), ()),
    "DeformablePSROIPooling": (("data", "rois", "trans"), ()),
    "MultiHeadAttention": (("data", "in_weight", "in_bias", "out_weight",
                            "out_bias"), ()),
    "MoE": (("data", "gate_weight", "w1_weight", "w2_weight"), ()),
    "quantize": (("data", "min_range", "max_range"), ()),
    "dequantize": (("data", "min_range", "max_range"), ()),
    "count_sketch": (("data", "h", "s"), ()),
}
# contrib ops answer under both their legacy and _contrib_ names
_CONTRIB = ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
            "Proposal", "MultiProposal", "PSROIPooling",
            "DeformableConvolution", "DeformablePSROIPooling", "CTCLoss",
            "quantize", "dequantize", "count_sketch",
            "MultiHeadAttention", "MoE")
for _name in _CONTRIB:
    if _name in INPUT_NAMES:
        INPUT_NAMES["_contrib_" + _name] = INPUT_NAMES[_name]
INPUT_NAMES["ctc_loss"] = INPUT_NAMES["CTCLoss"]

_BINARY_DEFAULT = ("lhs", "rhs")


def input_names_for(op_name, num_inputs):
    """Names for an op's tensor inputs (after any rng key)."""
    if op_name in INPUT_NAMES:
        names, aux = INPUT_NAMES[op_name]
        return (names + aux)[:num_inputs] if num_inputs else names + aux
    if num_inputs == 2:
        return _BINARY_DEFAULT
    if num_inputs and num_inputs > 2:
        return tuple("arg%d" % i for i in range(num_inputs))
    return ("data",)


def aux_names_for(op_name):
    return INPUT_NAMES.get(op_name, ((), ()))[1]


def expected_inputs(op_name, attrs):
    """Full (arg_names, aux_names) an op instance wants, given its attrs
    (handles optional inputs like bias under ``no_bias``)."""
    names, aux = INPUT_NAMES.get(op_name, (("data",), ()))
    names = list(names)
    if attrs.get("no_bias") and "bias" in names:
        names.remove("bias")
    if op_name == "LeakyReLU" and attrs.get("act_type", "leaky") != "prelu":
        names = ["data"]
    if op_name in ("SequenceMask", "SequenceLast", "SequenceReverse") and \
            not attrs.get("use_sequence_length"):
        names = ["data"]
    if op_name == "RNN" and attrs.get("mode", "lstm") != "lstm":
        names = [n for n in names if n != "state_cell"]
    if op_name == "Custom" and "op_type" in attrs:
        from ..operator import _make_prop

        names = list(_make_prop(attrs).list_arguments())
    return tuple(names), tuple(aux)
