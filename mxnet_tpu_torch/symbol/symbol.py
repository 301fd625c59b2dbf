"""Symbol — the declarative graph frontend.

Counterpart of ``mxnet_tpu/symbol/symbol.py`` (the reference's nnvm
``Symbol``, ``python/mxnet/symbol/symbol.py``).  A Symbol is a light DAG
of op applications over named variables.  Shape inference runs each op's
``compute`` on ``meta`` tensors (no data, no kernel: every wrapper takes
its plain version there), and :mod:`..executor`'s ``_trace_fn`` turns the
graph into one function that ``fused.TrainStep`` differentiates with
torch autograd; ``bind``/``simple_bind`` return that module's
``Executor``.

JSON save/load writes the reference's checkpoint graph format
(``nodes``/``arg_nodes``/``heads`` — ``nnvm::pass::SaveJSON``) exactly as
the JAX package does, so a ``prefix-symbol.json`` saved by either package
loads in the other.
"""
from __future__ import annotations

import json

from ..base import MXNetError
from ..ops import registry as _registry
from ..ops.op_names import expected_inputs

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]


class _Node:
    """One graph node: an op application, or a variable (op is None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs", "aux_slots")

    def __init__(self, op, name, attrs, inputs, aux_slots=()):
        self.op = op                      # OpDef or None for variables
        self.name = name
        self.attrs = dict(attrs)
        self.inputs = inputs              # list[(Node, out_idx)]
        self.aux_slots = tuple(aux_slots)  # input positions that are aux vars
        if op is None:
            self.num_outputs = 1
        else:
            self.num_outputs = op.count_outputs(
                _registry.FrozenAttrs(self.attrs))

    @property
    def is_variable(self):
        return self.op is None


class Symbol:
    """A (multi-)output slice of a graph. Composable like the reference."""

    def __init__(self, outputs):
        # outputs: list[(Node, out_idx)]
        self._outputs = list(outputs)

    # -- composition --------------------------------------------------------
    def __getitem__(self, index):
        if isinstance(index, str):
            index = self.list_outputs().index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def list_outputs(self):
        out = []
        for node, idx in self._outputs:
            if node.num_outputs == 1:
                out.append(node.name if node.is_variable
                           else node.name + "_output")
            else:
                out.append("%s_output%d" % (node.name, idx))
        return out

    def _topo(self):
        """Topological order of all nodes reachable from the outputs."""
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for (inp, _) in node.inputs:
                visit(inp)
            order.append(node)

        for node, _ in self._outputs:
            visit(node)
        return order

    def _aux_node_ids(self):
        """ids of variable nodes consumed through an aux slot."""
        aux = set()
        for n in self._topo():
            for pos, (src, _) in enumerate(n.inputs):
                if pos in n.aux_slots and src.is_variable:
                    aux.add(id(src))
        return aux

    def list_arguments(self):
        aux = self._aux_node_ids()
        return [n.name for n in self._topo()
                if n.is_variable and id(n) not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_node_ids()
        return [n.name for n in self._topo()
                if n.is_variable and id(n) in aux]

    def get_internals(self):
        """All node outputs as one group."""
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.num_outputs)])

    def attr_dict(self):
        return {n.name: {k: str(v) for k, v in n.attrs.items()}
                for n in self._topo() if n.attrs}

    # -- shape inference ------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input
        shapes, by op-specific parameter inference plus abstract
        evaluation on ``meta`` tensors."""
        shapes = _infer_param_shapes(self, dict(kwargs))
        arg_shapes = [shapes.get(n) for n in self.list_arguments()]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        return arg_shapes, self._infer_outputs(shapes), aux_shapes

    def _infer_outputs(self, shapes):
        import torch

        from ..executor import _trace_fn

        fn, arg_names, aux_names = _trace_fn(self, is_train=False)

        def meta(name):
            return torch.empty(shapes[name], dtype=torch.float32,
                               device="meta")

        outs, _ = fn({n: meta(n) for n in arg_names},
                     {n: meta(n) for n in aux_names}, None)
        return [tuple(int(d) for d in o.shape) for o in outs]

    # -- binding --------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", **kwargs):
        """Allocate every argument, gradient and aux array from the input
        shapes in ``kwargs`` and bind them (reference ``simple_bind``)."""
        from ..executor import Executor

        return Executor._simple_bind(self, ctx, grad_req, kwargs)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        from ..executor import Executor

        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states)

    def eval(self, ctx=None, **kwargs):
        shapes = {k: v.shape for k, v in kwargs.items()}
        ex = self.simple_bind(ctx, grad_req="null", **shapes)
        return ex.forward(is_train=False, **kwargs)

    # -- serialization ------------------------------------------------------
    def tojson(self):
        """Reference-compatible graph JSON (nodes/arg_nodes/heads), byte
        for byte what the JAX package writes for the same graph."""
        nodes_list = self._topo()
        node_idx = {id(n): i for i, n in enumerate(nodes_list)}
        nodes_json = []
        for n in nodes_list:
            nodes_json.append({
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "attrs": {k: json.dumps(v) if not isinstance(v, str) else v
                          for k, v in n.attrs.items()},
                "inputs": [[node_idx[id(src)], i, 0]
                           for (src, i) in n.inputs],
            })
        arg_nodes = [i for i, n in enumerate(nodes_list) if n.is_variable]
        heads = [[node_idx[id(n)], i, 0] for (n, i) in self._outputs]
        return json.dumps({"nodes": nodes_json, "arg_nodes": arg_nodes,
                           "heads": heads,
                           "attrs": {"mxnet_tpu_version": "0.1.0"}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- operators ----------------------------------------------------------
    def _binary(self, other, op, scalar_op, rop=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if rop else (self, other)
            return _apply(op, [a, b], {})
        return _apply(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o):
        return self._binary(o, "elemwise_add", "_plus_scalar")

    def __radd__(self, o):
        return self._binary(o, "elemwise_add", "_plus_scalar")

    def __sub__(self, o):
        return self._binary(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "elemwise_sub", "_rminus_scalar", rop=True)

    def __mul__(self, o):
        return self._binary(o, "elemwise_mul", "_mul_scalar")

    def __rmul__(self, o):
        return self._binary(o, "elemwise_mul", "_mul_scalar")

    def __truediv__(self, o):
        return self._binary(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "elemwise_div", "_rdiv_scalar", rop=True)

    def __pow__(self, o):
        return self._binary(o, "elemwise_power", "_power_scalar")

    def __neg__(self):
        return _apply("negative", [self], {})

    def __getattr__(self, name):
        if name.startswith("_") or not _registry.exists(name):
            raise AttributeError(name)

        def method(*args, **kw):
            return _apply(name, [self] + [a for a in args
                                          if isinstance(a, Symbol)], kw)
        return method

    def __repr__(self):
        return "<Symbol %s>" % (self.name or self.list_outputs())


def _infer_param_shapes(sym, known):
    """Forward shape propagation with op-specific parameter inference —
    the reference's InferShape pass: given data shapes, derive the
    weight/bias/aux shapes of layer ops.  Returns {var name: shape}."""
    env = {}     # (node id, out idx) -> shape
    shapes = {}  # var name -> shape
    for node in sym._topo():
        if node.is_variable:
            if known.get(node.name) is not None:
                shapes[node.name] = tuple(known[node.name])
            elif node.attrs.get("__shape__"):
                # Variable(shape=...) declared its own shape
                shapes[node.name] = tuple(
                    int(d) for d in node.attrs["__shape__"])
            continue
        _fill_param_shapes(node, env, shapes)
        in_shapes = []
        for (src, i) in node.inputs:
            s = shapes.get(src.name) if src.is_variable \
                else env.get((id(src), i))
            if s is None:
                raise MXNetError(
                    "infer_shape: cannot infer inputs of node %s" % node.name)
            in_shapes.append(s)
        for i, s in enumerate(_abstract_eval(node, in_shapes)):
            env[(id(node), i)] = s
    return shapes


def _abstract_eval(node, in_shapes):
    """Output shapes of one node: its compute on ``meta`` tensors."""
    import torch

    attrs = dict(node.attrs)
    if node.op.uses_train_mode:
        attrs["__is_train__"] = False
    ins = [torch.empty(tuple(s), dtype=torch.float32, device="meta")
           for s in in_shapes]
    if not ins:
        attrs["__device__"] = "meta"
    if node.op.needs_rng:
        ins = [None] + ins
    res = node.op.compute(_registry.FrozenAttrs(attrs), *ins)
    res = res if isinstance(res, tuple) else (res,)
    return [tuple(int(d) for d in o.shape) for o in res]


def _fill_param_shapes(node, env, shapes):
    """Derive weight/bias/gamma/... shapes from the data shape for the
    slice's layer ops (the part of the reference's per-op InferShape that
    runs 'backward' from data to params)."""
    def set_var(pos, shape):
        src, _ = node.inputs[pos]
        if src.is_variable and src.name not in shapes:
            shapes[src.name] = tuple(int(d) for d in shape)

    op = node.op.name
    a = node.attrs
    if not node.inputs:
        return
    src, i = node.inputs[0]
    data = shapes.get(src.name) if src.is_variable else env.get((id(src), i))
    if data is None:
        return
    if op == "FullyConnected":
        nh = int(a["num_hidden"])
        flat = 1
        for d in (data[1:] if a.get("flatten", True) else data[-1:]):
            flat *= d
        set_var(1, (nh, flat))
        if len(node.inputs) > 2:
            set_var(2, (nh,))
    elif op in ("Convolution", "Convolution_v1"):
        nf = int(a["num_filter"])
        ng = int(a.get("num_group", 1))
        kernel = tuple(int(k) for k in a["kernel"])
        if a.get("layout") in ("NWC", "NHWC", "NDHWC"):
            # channels-last: weight (O, *kernel, I/g), cuDNN-NHWC form
            set_var(1, (nf,) + kernel + (data[-1] // ng,))
        else:
            set_var(1, (nf, data[1] // ng) + kernel)
        if len(node.inputs) > 2:
            set_var(2, (nf,))
    elif op in ("BatchNorm", "BatchNorm_v1"):
        c = data[int(a.get("axis", 1))]
        for pos in (1, 2, 3, 4):
            if pos < len(node.inputs):
                set_var(pos, (c,))
    elif op == "LayerNorm":
        c = data[int(a.get("axis", -1))]
        set_var(1, (c,))
        set_var(2, (c,))
    elif op == "Embedding":
        set_var(1, (int(a["input_dim"]), int(a["output_dim"])))
    elif op == "SoftmaxOutput":
        set_var(1, data[:-1] if not a.get("multi_output") else
                (data[0],) + tuple(data[2:]))
    elif op == "_contrib_MultiHeadAttention":
        c = data[2]
        set_var(1, (3 * c, c))
        set_var(2, (3 * c,))
        set_var(3, (c, c))
        set_var(4, (c,))
    elif op == "Custom":
        # the prop's infer_shape derives the other inputs' shapes from the
        # data's (reference python/mxnet/operator.py infer_shape_entry);
        # an empty shape is an input the prop echoed back unknown
        from ..operator import _make_prop

        prop = _make_prop(a)
        known = [list(data)] + [[] for _ in prop.list_arguments()[1:]]
        for pos, s in enumerate(prop.infer_shape(known)[0]):
            if s and pos < len(node.inputs):
                set_var(pos, s)


def _apply(op_name, input_syms, attrs, name=None):
    """Compose an op over symbols (the reference's CreateAtomicSymbol +
    Compose).  Active ``AttrScope`` attributes apply under explicit
    ones."""
    from .. import name as _name_mod
    from ..attribute import current as _scope_attrs

    op = _registry.get(op_name)
    scoped = _scope_attrs()
    merged = dict(scoped)
    merged.update(attrs)
    attrs = merged
    # explicit names also go through the NameManager so Prefix prepends
    name = _name_mod.current().get(name or attrs.pop("name", None),
                                   op_name.lower().lstrip("_"))
    attrs.pop("name", None)
    op.validate_attrs(attrs)

    arg_names, aux_names = expected_inputs(op_name, attrs)
    inputs = []
    for s in input_syms:
        if len(s._outputs) != 1:
            raise MXNetError("cannot compose multi-output symbol directly")
        inputs.append(s._outputs[0])
    # auto-create missing parameter/aux variables (conv = Convolution(data)
    # creates convolution0_weight, ...); they inherit the active AttrScope
    total_wanted = len(arg_names) + len(aux_names)
    if len(inputs) < total_wanted and op_name in _PARAMETRIC_OPS:
        for extra in list(arg_names)[len(inputs):] + list(aux_names):
            vnode = _Node(None, "%s_%s" % (name, extra), dict(scoped), [])
            inputs.append((vnode, 0))
    aux_slots = tuple(range(len(arg_names),
                            len(arg_names) + len(aux_names)))
    node = _Node(op, name, attrs, inputs, aux_slots)
    return Symbol([(node, i) for i in range(node.num_outputs)])


# the slice's ops that auto-create their parameter variables
_PARAMETRIC_OPS = {
    "FullyConnected", "Convolution", "Convolution_v1", "BatchNorm",
    "BatchNorm_v1", "Embedding", "LayerNorm", "SoftmaxOutput", "Softmax",
    "MultiHeadAttention", "_contrib_MultiHeadAttention", "Custom",
}


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """Create a symbolic variable (reference ``mx.sym.Variable``); active
    AttrScope attributes apply under explicit ones."""
    from ..attribute import current as _scope_attrs

    attrs = dict(_scope_attrs())
    attrs.update(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else \
            (init.dumps() if hasattr(init, "dumps")
             else init.__class__.__name__)
    return Symbol([(_Node(None, name, attrs, []), 0)])


var = Variable


def Group(symbols):
    """Group symbols into one multi-output symbol (reference
    ``mx.sym.Group``)."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    for nj in data["nodes"]:
        attrs = {}
        for k, v in nj.get("attrs", {}).items():
            if k == "__init__":
                # keep the serialized initializer string as written
                attrs[k] = v
                continue
            try:
                attrs[k] = json.loads(v)
            except (ValueError, TypeError):
                attrs[k] = v
        if nj["op"] == "null":
            node = _Node(None, nj["name"], attrs, [])
        else:
            op = _registry.get(nj["op"])
            inputs = [(nodes[i], oi) for (i, oi, _) in nj["inputs"]]
            arg_names, aux_names = expected_inputs(nj["op"], attrs)
            aux_slots = tuple(range(len(arg_names),
                                    len(arg_names) + len(aux_names)))
            node = _Node(op, nj["name"], attrs, inputs, aux_slots)
        nodes.append(node)
    return Symbol([(nodes[i], oi) for (i, oi, _) in data["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())
