"""Per-operator parameter declarations — the ``dmlc::Parameter`` analogue.

In the reference every operator declares a parameter struct
(``DMLC_DECLARE_PARAMETER``, 75 files) giving each attribute a type, a
default, and a description; the registry renders those into the
docstrings of every generated frontend function and validates kwargs at
call time.  This module, the port's own copy of
``mxnet_tpu/ops/op_params.py``, is the same single source of truth for
the port's registry: ``ops/__init__`` attaches each spec to its ``OpDef``, the
``nd``/``sym`` frontends render the table into ``__doc__``, and — with
``MXNET_STRICT_OP_PARAMS=1`` — unknown attribute names raise instead of
being silently ignored.

Each spec is ``(name, type, default, description)``; ``default=REQUIRED``
marks a mandatory attribute.
"""
from __future__ import annotations

REQUIRED = "__required__"

# op name -> [(param, type, default, description), ...]
PARAM_SPECS = {
    "FullyConnected": [
        ("num_hidden", "int", REQUIRED, "Number of output units."),
        ("no_bias", "bool", False, "Disable the bias term."),
        ("flatten", "bool", True,
         "Flatten trailing input dims into one feature axis."),
    ],
    "Convolution": [
        ("kernel", "tuple of int", REQUIRED, "Spatial kernel size."),
        ("num_filter", "int", REQUIRED, "Number of output channels."),
        ("stride", "tuple of int", None, "Spatial stride (default 1s)."),
        ("pad", "tuple of int", None, "Zero padding (default 0s)."),
        ("dilate", "tuple of int", None, "Dilation (default 1s)."),
        ("num_group", "int", 1, "Grouped-convolution group count."),
        ("no_bias", "bool", False, "Disable the bias term."),
        ("layout", "str", "NCHW",
         "Input layout: NCHW/NHWC (NCW/NWC, NCDHW/NDHWC by rank)."),
        ("cudnn_tune", "str", None,
         "Accepted for reference parity; XLA owns algorithm choice."),
        ("workspace", "int", None,
         "Accepted for reference parity; XLA owns scratch memory."),
    ],
    "Deconvolution": [
        ("kernel", "tuple of int", REQUIRED, "Spatial kernel size."),
        ("num_filter", "int", REQUIRED, "Number of output channels."),
        ("stride", "tuple of int", None, "Upsampling stride."),
        ("pad", "tuple of int", None, "Padding removed from the output."),
        ("adj", "tuple of int", None, "Output-size adjustment."),
        ("target_shape", "tuple of int", None,
         "Explicit output spatial shape (overrides adj)."),
        ("num_group", "int", 1, "Group count."),
        ("no_bias", "bool", True, "Disable the bias term."),
    ],
    "Pooling": [
        ("kernel", "tuple of int", REQUIRED, "Pooling window."),
        ("pool_type", "str", "max", "max | avg | sum."),
        ("stride", "tuple of int", None, "Stride (default 1s)."),
        ("pad", "tuple of int", None, "Padding (default 0s)."),
        ("global_pool", "bool", False, "Pool over the whole spatial extent."),
        ("pooling_convention", "str", "valid",
         "Output-shape rounding: valid | full."),
        ("layout", "str", "NCHW", "Input layout."),
    ],
    "BatchNorm": [
        ("eps", "float", 1e-3, "Variance epsilon."),
        ("momentum", "float", 0.9, "Moving-average momentum."),
        ("fix_gamma", "bool", True, "Freeze gamma at 1."),
        ("use_global_stats", "bool", False,
         "Normalize with moving stats even in training."),
        ("output_mean_var", "bool", False, "Also output batch mean/var."),
        ("axis", "int", 1, "Channel axis."),
    ],
    "Activation": [
        ("act_type", "str", REQUIRED,
         "relu | sigmoid | tanh | softrelu | softsign | gelu."),
    ],
    "LeakyReLU": [
        ("act_type", "str", "leaky", "leaky | prelu | elu | rrelu."),
        ("slope", "float", 0.25, "Negative-region slope (leaky/elu)."),
        ("lower_bound", "float", 0.125, "rrelu slope lower bound."),
        ("upper_bound", "float", 0.334, "rrelu slope upper bound."),
    ],
    "Dropout": [
        ("p", "float", 0.5, "Drop probability."),
        ("mode", "str", "training",
         "training: scale at train time only; always: also at inference."),
    ],
    "SoftmaxOutput": [
        ("grad_scale", "float", 1.0, "Scale applied to the gradient."),
        ("ignore_label", "float", -1.0,
         "Label value excluded from gradient when use_ignore is set."),
        ("use_ignore", "bool", False, "Enable ignore_label."),
        ("multi_output", "bool", False,
         "Softmax over axis 1 with trailing spatial axes."),
        ("preserve_shape", "bool", False, "Softmax over the last axis."),
        ("normalization", "str", "null",
         "Gradient normalization: null | batch | valid."),
        ("out_grad", "bool", False, "Accept an incoming head gradient."),
        ("smooth_alpha", "float", 0.0, "Label smoothing."),
    ],
    "Embedding": [
        ("input_dim", "int", REQUIRED, "Vocabulary size."),
        ("output_dim", "int", REQUIRED, "Embedding width."),
        ("dtype", "str", "float32", "Weight dtype."),
    ],
    "RNN": [
        ("state_size", "int", REQUIRED, "Hidden state width."),
        ("num_layers", "int", REQUIRED, "Stacked layer count."),
        ("mode", "str", REQUIRED, "rnn_relu | rnn_tanh | lstm | gru."),
        ("bidirectional", "bool", False, "Bidirectional stacking."),
        ("state_outputs", "bool", False, "Also output final states."),
        ("p", "float", 0.0, "Inter-layer dropout."),
    ],
}
PARAM_SPECS.update({
    "Reshape": [
        ("shape", "tuple of int", REQUIRED,
         "Target shape; 0 copies, -1 infers, -2/-3/-4 reference "
         "split/merge codes."),
        ("reverse", "bool", False, "Match shape right-to-left."),
    ],
    "slice": [
        ("begin", "tuple of int", REQUIRED, "Start per axis."),
        ("end", "tuple of int", REQUIRED, "End per axis (None = to end)."),
        ("step", "tuple of int", None, "Step per axis."),
    ],
    "Cast": [("dtype", "str", REQUIRED, "Target dtype.")],
    "clip": [
        ("a_min", "float", REQUIRED, "Lower bound."),
        ("a_max", "float", REQUIRED, "Upper bound."),
    ],
    "Concat": [
        ("dim", "int", 1, "Concatenation axis."),
        ("num_args", "int", None, "Accepted for reference parity."),
    ],
    "SliceChannel": [
        ("num_outputs", "int", REQUIRED, "Number of splits."),
        ("axis", "int", 1, "Split axis."),
        ("squeeze_axis", "bool", False, "Drop the split axis when size 1."),
    ],
    "dot": [
        ("transpose_a", "bool", False, "Transpose the first input."),
        ("transpose_b", "bool", False, "Transpose the second input."),
    ],
    "MultiHeadAttention": [
        ("num_heads", "int", REQUIRED, "Attention head count."),
        ("causal", "bool", True, "Apply the causal (autoregressive) mask."),
        ("seq_parallel", "bool", False,
         "Ring attention over the active mesh's 'seq' axis "
         "(long-context: shard T over chips, rotate K/V on ICI)."),
    ],
    "MoE": [
        ("num_experts", "int", REQUIRED, "Expert count E."),
        ("top_k", "int", 2, "Experts routed per token."),
        ("hidden_size", "int", None,
         "Expert FFN hidden width H (default 4*D; used for parameter "
         "shape inference)."),
        ("capacity_factor", "float", 1.25,
         "Per-expert buffer = ceil(cf * top_k * tokens / E); overflow "
         "tokens are dropped from that expert."),
        ("expert_parallel", "bool", False,
         "Shard tokens + experts over the active mesh's 'expert' axis; "
         "dispatch/return ride all_to_all on ICI."),
    ],
    "LayerNorm": [
        ("eps", "float", 1e-5, "Variance epsilon."),
        ("axis", "int", -1, "Normalized axis."),
    ],
    "topk": [
        ("k", "int", 1, "Number of elements."),
        ("axis", "int", -1, "Axis to rank along."),
        ("ret_typ", "str", "indices", "value | indices | mask | both."),
        ("is_ascend", "bool", False, "Rank ascending."),
        ("dtype", "str", "float32", "Index output dtype."),
    ],
})


def attach_specs(registry_exists, registry_get):
    """Attach each spec list to its OpDef (aliases share the OpDef, so
    they share the spec).  Specs of ops the port has not reached yet stay
    in the table, unattached."""
    for name, spec in PARAM_SPECS.items():
        if registry_exists(name):
            registry_get(name).param_specs = spec
