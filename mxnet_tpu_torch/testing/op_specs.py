"""The forward cases of the op sweep, for the ops the port registers.

The port's own copy of the spec table of ``tests/test_op_sweep.py``
(``_build_specs``), without the cases of the ops the port does not
register (the contrib ops, ``RNN``, ``MoE``): ``chip_smoke.py`` runs
every case on the card and on the CPU, where JAX is not installed, and
``tests/test_torch_op_sweep.py`` holds this copy equal to the original.
:data:`RANDOM_MOMENTS` gives, for the samplers, a draw of 10^5 values
and the mean and variance of its distribution; :func:`is_random` names
the ops whose values come from a generator.
"""
import numpy as np


def _f(*shape):
    return np.random.RandomState(0).randn(*shape).astype("float32")


def _pos(*shape):
    return (np.random.RandomState(0).rand(*shape) + 0.5).astype("float32")


def _unit(*shape):
    return (np.random.RandomState(0).uniform(-0.9, 0.9, shape)
            ).astype("float32")


def _idx(n, hi, *shape):
    return (np.random.RandomState(0).randint(0, hi, shape or (n,))
            ).astype("float32")


def _spd(n=4):
    a = np.random.RandomState(0).randn(n, n).astype("float32")
    return a @ a.T + n * np.eye(n, dtype="float32")


def _tril(n=4):
    return np.tril(_spd(n)).astype("float32")


# name -> (input builder list, attrs).  Values may be callables (lazy).
UNARY = "abs ceil cbrt cos cosh degrees erf exp expm1 fix floor negative \
radians relu rint round sigmoid sign sin sinh softsign square tan tanh \
trunc logical_not arcsin arctan arcsinh arctanh".split()
UNARY_POS = "log log10 log1p log2 sqrt rsqrt gamma gammaln rcbrt \
reciprocal arccosh".split()

BINARY = "_add _sub _minus _mul _div _mod _power _maximum _minimum _hypot \
_arctan2 _equal _not_equal _greater _greater_equal _lesser _lesser_equal \
_logical_and _logical_or _logical_xor _grad_add elemwise_add elemwise_sub \
elemwise_minus elemwise_mul elemwise_div elemwise_mod elemwise_power \
elemwise_maximum elemwise_minimum elemwise_hypot elemwise_arctan2 \
elemwise_equal elemwise_not_equal elemwise_greater elemwise_greater_equal \
elemwise_lesser elemwise_lesser_equal elemwise_logical_and \
elemwise_logical_or elemwise_logical_xor".split()

SCALAR = "_plus_scalar _minus_scalar _rminus_scalar _mul_scalar _div_scalar \
_rdiv_scalar _mod_scalar _rmod_scalar _power_scalar _rpower_scalar \
_maximum_scalar _minimum_scalar _hypot_scalar _equal_scalar \
_not_equal_scalar _greater_scalar _greater_equal_scalar _lesser_scalar \
_lesser_equal_scalar".split()

BROADCAST = "broadcast_add broadcast_plus broadcast_sub broadcast_minus \
broadcast_mul broadcast_div broadcast_mod broadcast_power broadcast_maximum \
broadcast_minimum broadcast_hypot broadcast_arctan2 broadcast_equal \
broadcast_not_equal broadcast_greater broadcast_greater_equal \
broadcast_lesser broadcast_lesser_equal broadcast_logical_and \
broadcast_logical_or broadcast_logical_xor".split()

REDUCE = "sum _sum sum_axis mean mean_axis prod prod_axis nansum \
nansum_axis nanprod nanprod_axis max max_axis min min_axis".split()

RANDOM = "random_uniform random_normal random_exponential random_gamma \
random_poisson random_negative_binomial \
random_generalized_negative_binomial uniform normal".split()

# in this registry the underscore _sample_* names alias the global-param
# random_* samplers (attrs only); sample_* are the per-row-param forms
SAMPLE_GLOBAL = "_sample_uniform _sample_normal _sample_exponential \
_sample_gamma _sample_poisson _sample_negbinomial \
_sample_gennegbinomial".split()


def _build_specs():
    s = {}
    for n in UNARY:
        s[n] = ([_unit(3, 4)], {})
    for n in UNARY_POS:
        s[n] = ([_pos(3, 4)], {})
    s["arccos"] = ([_unit(3, 4)], {})
    s["arccosh"] = ([_pos(3, 4) + 1.0], {})
    s["erfinv"] = ([_unit(3, 4)], {})
    for n in BINARY:
        s[n] = ([_pos(3, 4), _pos(3, 4)], {})
    for n in SCALAR:
        s[n] = ([_pos(3, 4)], {"scalar": 2.0})
    for n in BROADCAST:
        s[n] = ([_pos(3, 4), _pos(1, 4)], {})
    for n in REDUCE:
        s[n] = ([_f(3, 4)], {"axis": 1})
    for n in RANDOM:
        s[n] = ([], {"shape": (3, 4)})
    for n in SAMPLE_GLOBAL:
        s[n] = ([], {"shape": (3, 4)})
    s["sample_uniform"] = ([_pos(3), _pos(3) + 2.0], {"shape": (5,)})
    s["sample_normal"] = ([_f(3), _pos(3)], {"shape": (5,)})
    s["sample_gamma"] = ([_pos(3), _pos(3)], {"shape": (5,)})
    s["sample_exponential"] = ([_pos(3)], {"shape": (5,)})
    s["sample_poisson"] = ([_pos(3) * 3], {"shape": (5,)})
    s["_sample_multinomial"] = s["sample_multinomial"] = (
        [np.full((2, 4), 0.25, "float32")], {"shape": (6,)})
    s["random_gamma"] = ([], {"shape": (3, 4), "alpha": 2.0, "beta": 1.0})
    s["random_poisson"] = ([], {"shape": (3, 4), "lam": 2.0})
    s["random_negative_binomial"] = ([], {"shape": (3,), "k": 3, "p": 0.5})
    s["random_generalized_negative_binomial"] = (
        [], {"shape": (3,), "mu": 2.0, "alpha": 0.5})
    s["shuffle"] = s["_shuffle"] = ([_f(6, 2)], {})

    # -- structure / matrix ------------------------------------------------
    s["Reshape"] = s["reshape"] = ([_f(2, 6)], {"shape": (3, 4)})
    s["Flatten"] = s["flatten"] = ([_f(2, 3, 4)], {})
    s["transpose"] = ([_f(2, 3)], {})
    s["expand_dims"] = ([_f(3, 4)], {"axis": 1})
    s["slice"] = ([_f(4, 5)], {"begin": (1, 0), "end": (3, 4)})
    s["slice_axis"] = ([_f(4, 5)], {"axis": 1, "begin": 1, "end": 4})
    s["slice_like"] = ([_f(4, 5), _f(2, 3)], {})
    s["clip"] = ([_f(3, 4)], {"a_min": -0.5, "a_max": 0.5})
    s["repeat"] = ([_f(2, 3)], {"repeats": 2, "axis": 1})
    s["tile"] = ([_f(2, 3)], {"reps": (2, 2)})
    s["reverse"] = s["flip"] = ([_f(3, 4)], {"axis": 1})
    s["stack"] = ([_f(3, 4), _f(3, 4)], {"axis": 0, "num_args": 2})
    s["Concat"] = s["concat"] = s["concatenate"] = (
        [_f(2, 3), _f(2, 3)], {"dim": 1, "num_args": 2})
    s["take"] = ([_f(5, 3), _idx(4, 5)], {})
    s["batch_take"] = ([_f(4, 3), _idx(4, 3)], {})
    s["choose_element_0index"] = ([_f(4, 3), _idx(4, 3)], {})
    s["pick"] = ([_f(4, 3), _idx(4, 3)], {})
    s["one_hot"] = ([_idx(5, 4)], {"depth": 4})
    s["where"] = ([(_f(3, 4) > 0).astype("float32"), _f(3, 4), _f(3, 4)], {})
    s["ones_like"] = s["zeros_like"] = ([_f(3, 4)], {})
    s["_zeros"] = s["zeros"] = ([], {"shape": (3, 4)})
    s["_ones"] = s["ones"] = ([], {"shape": (3, 4)})
    s["_full"] = s["full"] = ([], {"shape": (3, 4), "value": 2.5})
    s["_arange"] = s["arange"] = ([], {"start": 0, "stop": 10})
    s["_eye"] = s["eye"] = ([], {"N": 4})
    s["_copy"] = s["identity"] = ([_f(3, 4)], {})
    s["_identity_with_attr_like_rhs"] = ([_f(3, 4), _f(3, 4)], {})
    s["BlockGrad"] = s["block_grad"] = s["stop_gradient"] = ([_f(3, 4)], {})
    s["sort"] = ([_f(3, 6)], {"axis": 1})
    s["argsort"] = ([_f(3, 6)], {"axis": 1})
    s["topk"] = ([_f(3, 6)], {"k": 2, "axis": 1})
    s["argmax"] = s["argmin"] = ([_f(3, 6)], {"axis": 1})
    s["argmax_channel"] = ([_f(3, 6)], {})
    s["norm"] = ([_f(3, 4)], {})
    s["cast"] = s["Cast"] = ([_f(3, 4)], {"dtype": "float16"})
    s["SwapAxis"] = s["swapaxes"] = ([_f(2, 3, 4)], {"dim1": 1, "dim2": 2})
    s["squeeze"] = ([_f(3, 1, 4)], {"axis": 1})
    s["broadcast_to"] = ([_f(1, 4)], {"shape": (3, 4)})
    s["broadcast_axis"] = s["broadcast_axes"] = (
        [_f(1, 4)], {"axis": 0, "size": 3})
    s["Pad"] = s["pad"] = ([_f(2, 3, 4, 5)],
                           {"mode": "constant",
                            "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)})
    s["Crop"] = ([_f(1, 1, 8, 8)],
                 {"h_w": (4, 4), "num_args": 1, "center_crop": True})
    s["crop"] = ([_f(4, 5)], {"begin": (1, 0), "end": (3, 4)})
    s["smooth_l1"] = ([_f(3, 4)], {"scalar": 1.0})
    s["dot"] = ([_f(3, 4), _f(4, 5)], {})
    s["batch_dot"] = ([_f(2, 3, 4), _f(2, 4, 5)], {})
    s["ElementWiseSum"] = s["elemwise_sum"] = s["add_n"] = (
        [_f(3, 4), _f(3, 4), _f(3, 4)], {"num_args": 3})
    s["softmax"] = ([_f(3, 4)], {})
    s["log_softmax"] = ([_f(3, 4)], {})
    s["softmax_cross_entropy"] = ([_f(4, 5), _idx(4, 5)], {})
    s["IdentityAttachKLSparseReg"] = ([_unit(3, 4)], {})
    s["MakeLoss"] = s["make_loss"] = ([_pos(3, 4)], {})

    # -- linalg ------------------------------------------------------------
    s["linalg_gemm"] = ([_f(3, 4), _f(4, 5), _f(3, 5)], {})
    s["linalg_gemm2"] = ([_f(3, 4), _f(4, 5)], {})
    s["linalg_potrf"] = ([_spd()], {})
    s["linalg_potri"] = ([_tril()], {})
    s["linalg_sumlogdiag"] = ([_spd()], {})
    s["linalg_syrk"] = ([_f(3, 4)], {})
    s["linalg_trmm"] = ([_tril(), _f(4, 4)], {})
    s["linalg_trsm"] = ([_tril(), _f(4, 4)], {})

    # -- nn layers ---------------------------------------------------------
    s["Activation"] = ([_f(2, 8)], {"act_type": "relu"})
    s["SoftmaxActivation"] = ([_f(2, 8)], {})
    s["Softmax"] = s["SoftmaxOutput"] = ([_f(4, 5), _idx(4, 5)], {})
    s["LinearRegressionOutput"] = ([_f(4, 3), _f(4, 3)], {})
    s["MAERegressionOutput"] = ([_f(4, 3), _f(4, 3)], {})
    s["LogisticRegressionOutput"] = ([_f(4, 3), _f(4, 3)], {})
    s["SVMOutput"] = ([_f(4, 5), _idx(4, 5)], {})
    s["FullyConnected"] = s["fully_connected"] = (
        [_f(4, 6), _f(8, 6), _f(8)], {"num_hidden": 8})
    s["Convolution"] = s["conv"] = s["Convolution_v1"] = (
        [_f(2, 3, 8, 8), _f(4, 3, 3, 3), _f(4)],
        {"kernel": (3, 3), "num_filter": 4})
    s["Deconvolution"] = ([_f(2, 4, 4, 4), _f(4, 3, 3, 3), _f(3)],
                          {"kernel": (3, 3), "num_filter": 3})
    s["Pooling"] = s["Pooling_v1"] = (
        [_f(2, 3, 8, 8)], {"kernel": (2, 2), "stride": (2, 2),
                           "pool_type": "max"})
    s["BatchNorm"] = s["BatchNorm_v1"] = (
        [_f(2, 3, 4, 4), _pos(3), _f(3), np.zeros(3, "float32"),
         np.ones(3, "float32")], {})
    s["InstanceNorm"] = ([_f(2, 3, 4, 4), _pos(3), _f(3)], {})
    s["LayerNorm"] = ([_f(4, 6), _pos(6), _f(6)], {})
    s["L2Normalization"] = ([_f(3, 4)], {})
    s["LRN"] = ([_f(2, 4, 5, 5)], {"nsize": 3})
    s["LeakyReLU"] = ([_f(3, 4)], {"act_type": "leaky"})
    s["Dropout"] = ([_f(8, 8)], {"p": 0.5})
    s["Embedding"] = ([_idx(5, 7), _f(7, 3)],
                      {"input_dim": 7, "output_dim": 3})
    s["SliceChannel"] = s["split"] = ([_f(2, 6)],
                                      {"num_outputs": 2, "axis": 1})
    s["UpSampling"] = ([_f(1, 2, 4, 4)],
                       {"scale": 2, "sample_type": "nearest",
                        "num_args": 1})
    s["GridGenerator"] = ([_f(2, 6)],
                          {"transform_type": "affine",
                           "target_shape": (4, 4)})
    s["BilinearSampler"] = ([_f(1, 2, 5, 5), _unit(1, 2, 4, 4)], {})
    s["SpatialTransformer"] = (
        [_f(1, 2, 6, 6), _f(1, 6)],
        {"transform_type": "affine", "sampler_type": "bilinear",
         "target_shape": (4, 4)})
    s["ROIPooling"] = (
        [_f(1, 2, 8, 8),
         np.array([[0, 0, 0, 7, 7]], "float32")],
        {"pooled_size": (2, 2), "spatial_scale": 1.0})
    s["SequenceMask"] = ([_f(5, 3, 2), np.array([3, 2, 5], "float32")],
                         {"use_sequence_length": True})
    s["SequenceLast"] = ([_f(5, 3, 2), np.array([3, 2, 5], "float32")],
                         {"use_sequence_length": True})
    s["SequenceReverse"] = ([_f(5, 3, 2), np.array([3, 2, 5], "float32")],
                            {"use_sequence_length": True})

    s["MultiHeadAttention"] = s["_contrib_MultiHeadAttention"] = (
        [_f(2, 4, 8), _f(24, 8) * 0.2, _f(24) * 0.1, _f(8, 8) * 0.2,
         _f(8) * 0.1],
        {"num_heads": 2})
    s["_slice_assign"] = s["_crop_assign"] = (
        [_f(4, 4), _f(2, 2)], {"begin": (1, 1), "end": (3, 3)})
    s["_slice_assign_scalar"] = s["_crop_assign_scalar"] = (
        [_f(4, 4)], {"begin": (0, 0), "end": (2, 4), "scalar": 3.0})
    s["_CrossDeviceCopy"] = ([_f(3, 3)], {})

    # -- optimizer updates -------------------------------------------------
    s["sgd_update"] = ([_f(4), _f(4)], {"lr": 0.1})
    s["sgd_mom_update"] = ([_f(4), _f(4), _f(4)], {"lr": 0.1,
                                                   "momentum": 0.9})
    s["mp_sgd_update"] = ([_f(4), _f(4), _f(4)], {"lr": 0.1})
    s["mp_sgd_mom_update"] = ([_f(4), _f(4), _f(4), _f(4)],
                              {"lr": 0.1, "momentum": 0.9})
    s["adam_update"] = ([_f(4), _f(4), _f(4), _pos(4)], {"lr": 0.1})
    s["rmsprop_update"] = ([_f(4), _f(4), _pos(4)], {"lr": 0.1})
    s["rmspropalex_update"] = (
        [_f(4), _f(4) * 0.1, np.ones(4, "float32"),
         np.zeros(4, "float32"), np.zeros(4, "float32")], {"lr": 0.1})
    s["ftrl_update"] = ([_f(4), _f(4), _f(4), _pos(4)], {"lr": 0.1})
    return s


SPECS = _build_specs()

N_DRAWS = 100_000

# name, inputs, attrs (``shape`` added: N_DRAWS values), (mean, variance)
RANDOM_MOMENTS = [
    ("random_uniform", [], {"low": -1.0, "high": 3.0}, (1.0, 16.0 / 12)),
    ("random_normal", [], {"loc": 0.5, "scale": 2.0}, (0.5, 4.0)),
    ("random_gamma", [], {"alpha": 2.5, "beta": 0.5}, (1.25, 0.625)),
    ("random_exponential", [], {"lam": 4.0}, (0.25, 0.0625)),
    ("random_poisson", [], {"lam": 3.0}, (3.0, 3.0)),
    ("random_negative_binomial", [], {"k": 3, "p": 0.4}, (4.5, 11.25)),
    ("random_generalized_negative_binomial", [], {"mu": 2.0, "alpha": 0.5},
     (2.0, 4.0)),
    ("sample_uniform", [np.array([-1.0], np.float32),
                        np.array([3.0], np.float32)], {}, (1.0, 16.0 / 12)),
    ("sample_normal", [np.array([0.5], np.float32),
                       np.array([2.0], np.float32)], {}, (0.5, 4.0)),
    ("sample_gamma", [np.array([2.5], np.float32),
                      np.array([0.5], np.float32)], {}, (1.25, 0.625)),
    ("sample_exponential", [np.array([4.0], np.float32)], {},
     (0.25, 0.0625)),
    ("sample_poisson", [np.array([3.0], np.float32)], {}, (3.0, 3.0)),
]


def moments_ok(x, mean, var):
    """The sample mean and variance of ``x`` within 4 standard errors of
    ``mean`` and ``var`` (the variance's standard error from the sample's
    fourth central moment).  Returns (ok, sample mean, sample variance)."""
    x = np.asarray(x, np.float64).reshape(-1)
    d = x - x.mean()
    m2, m4 = np.mean(d ** 2), np.mean(d ** 4)
    ok = (abs(x.mean() - mean) < 4 * np.sqrt(var / x.size)
          and abs(m2 - var) < 4 * np.sqrt((m4 - m2 ** 2) / x.size))
    return ok, float(x.mean()), float(m2)


def is_random(name):
    """Whether the registered op ``name`` is a sampler: its values come
    from the generator, so two devices (or two packages) agree only in
    distribution."""
    from ..ops import registry

    return registry.get(name).compute.__module__.endswith(".random_ops")
