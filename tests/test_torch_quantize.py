"""The port's quantized serving against the JAX package, on the CPU, at a
tiny LM (vocab 61, 2 layers, d_model 32, 2 heads, page 8).

Quantization itself is held byte for byte: codes (compared as bytes) and
scales of ``mxnet_tpu_torch.quantize`` equal ``mxnet_tpu.quantize``'s.
Inside the port the per-precision contract holds bit for bit: a
quantized session's logits equal ``reference_last_logits`` over its
dequantized params at its KV precision.  Across the packages, quantized
sessions' logits agree within atol 1e-5 (fp32, different reduction
orders over the same dequantized values) and their greedy streams agree
exactly on traces whose every emitted token leads the runner-up by more
than 10x that tolerance.  Each JAX session is built once for the module.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import quantize as jq
from mxnet_tpu import serve as jserve
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.serve import model as jmodel
from mxnet_tpu.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from mxnet_tpu_torch import quantize as Q
from mxnet_tpu_torch import serve as tserve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as A
from mxnet_tpu_torch.ops import linear as L
from mxnet_tpu_torch.serve import model as tmodel
from mxnet_tpu_torch.serve.kv_cache import PagedKVCache

CFG = jserve.ModelConfig(vocab_size=61, num_layers=2, d_model=32,
                         num_heads=2, max_len=64)
PAGE = 8
ATOL = 1e-5
COMBOS = [("int8", ""), ("fp8", ""), ("", "int8"), ("", "fp8"),
          ("int8", "int8")]
# the combinations also served by a JAX session (one compile each, the
# file's cost): every mode of each field, and both fields at once
JAX_COMBOS = [("fp8", ""), ("", "fp8"), ("int8", "int8")]


def _bytes(a):
    """Codes of either package as their bytes (int8 codes too)."""
    if torch.is_tensor(a):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _same(port, jax_val):
    """Codes or scales: byte-equal, same shape."""
    want = np.asarray(jax_val)
    assert tuple(port.shape) == want.shape
    if want.dtype == np.float32:
        np.testing.assert_array_equal(port.numpy(), want)
    else:
        np.testing.assert_array_equal(_bytes(port), _bytes(want))


@pytest.fixture(scope="module")
def np_params():
    """Seeded weights as numpy, handed to both packages (drawn by the
    port: the JAX package's init_params would compile its sampler)."""
    cfg = tserve.ModelConfig(vocab_size=61, num_layers=2, d_model=32,
                             num_heads=2, max_len=64)
    return {k: v.numpy() for k, v in
            tserve.init_params(cfg, seed=3, device="cpu").items()}


# ---------------------------------------------------------------------------
# quantize.py byte for byte
# ---------------------------------------------------------------------------

def test_quant_mode_and_eligibility_match_jax():
    for raw in ("", "off", "none", "0", "fp32", None, False, "int8", "I8",
                " Int8 ", "fp8", "e4m3", "float8_e4m3fn", "F8"):
        assert Q.quant_mode(raw) == jq.quant_mode(raw), raw
    for raw in ("int4", "bf16"):
        with pytest.raises(MXNetError):
            Q.quant_mode(raw)
        with pytest.raises(JaxMXNetError):
            jq.quant_mode(raw)
    assert Q.quant_dtype("int8") == torch.int8
    assert Q.quant_dtype("e4m3") == torch.float8_e4m3fn
    for shape, dtype, floor in (((32, 32), np.float32, 1024),
                                ((1024,), np.float32, 1024),
                                ((8, 8), np.float32, 1024),
                                ((64, 64), np.int32, 1024),
                                ((8, 8), np.float32, 0),
                                ((1, 64, 32), np.float32, 1024)):
        assert Q.eligible(shape, dtype, floor) == \
            jq.eligible(shape, dtype, floor)
        torch_dtype = torch.from_numpy(np.zeros(1, dtype)).dtype
        assert Q.eligible(shape, torch_dtype, floor) == \
            jq.eligible(shape, dtype, floor)


def _arrays(mode):
    rs = np.random.RandomState(7)
    mat = (rs.randn(48, 64).astype(np.float32)
           * np.logspace(-2, 2, 48).astype(np.float32)[:, None])
    mat[5] = 0.0  # an all-zero channel: scale 1, codes 0
    qmax = jq.INT8_MAX if mode == "int8" else jq.FP8_MAX
    # every channel's amax is qmax / 4, so its scale is 1 / 4 exactly and
    # each value scales to a tie: k + .5 (int8), or the midpoint of two
    # e4m3 neighbours in [8, 16) (fp8)
    grid = (np.arange(16 * 40) % 64 - 32).reshape(16, 40).astype(np.float32)
    ties = (grid + 0.5) / 4 if mode == "int8" else \
        np.where(grid < 0, -1, 1) * (np.abs(grid) % 8 + 8.5) / 4
    ties[:, 0] = qmax / 4
    pos = (0.02 * rs.randn(1, 40, 32)).astype(np.float32)
    vec = rs.randn(100).astype(np.float32)
    return {"matrix": mat, "ties": ties.astype(np.float32), "pos": pos,
            "vector": vec}


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_array_matches_jax_bytewise(mode):
    for name, x in _arrays(mode).items():
        q, s = Q.quantize_array(torch.from_numpy(x), mode)
        jqv, js = jq.quantize_array(x, mode)
        assert q.dtype == Q.storage_dtype(mode)
        _same(q, jqv)
        _same(s, js)
        np.testing.assert_array_equal(
            Q.dequantize_array(q, s).numpy(), jq.dequantize_array(jqv, js))
    assert Q.quantize_array(torch.zeros(3, 4), mode)[1].flatten().tolist() \
        == [1.0, 1.0, 1.0]
    with pytest.raises(MXNetError):
        Q.quantize_array(torch.ones(4, 4), "")


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_params_tree_matches_jax(np_params, mode):
    tparams = {k: torch.from_numpy(v.copy()) for k, v in np_params.items()}
    got = Q.quantize_params(tparams, mode)
    # the JAX records as numpy, so that its dequantization runs in numpy
    want = {k: ({"q": np.asarray(v["q"]), "s": np.asarray(v["s"])}
                if jq.is_quantized(v) else v)
            for k, v in jq.quantize_params(np_params, mode).items()}
    assert sorted(got) == sorted(want)
    for name, rec in want.items():
        assert Q.is_quantized(got[name]) == jq.is_quantized(rec), name
        if jq.is_quantized(rec):
            _same(got[name]["q"], rec["q"])
            _same(got[name]["s"], rec["s"])
    assert Q.is_quantized(got["pos_embed"])
    assert tuple(got["pos_embed"]["s"].shape) == (1, 1, 1)
    assert not Q.is_quantized(got["blk0_ln1_gamma"])
    assert Q.quantize_params(got, mode)["lm_head_weight"] \
        is got["lm_head_weight"]
    assert Q.at_rest_bytes(got) == jq.at_rest_bytes(want)
    assert Q.at_rest_bytes(tparams) == jq.at_rest_bytes(np_params)
    full, jfull = Q.dequantize_params(got), jq.dequantize_params(want)
    for name in full:
        np.testing.assert_array_equal(full[name].numpy(),
                                      np.asarray(jfull[name]))
    # a JAX-quantized tree loads with its codes and scales (an e4m3 array
    # through its bytes), as the port's own quantization gives them
    loaded = tmodel.params_from_numpy(want, "cpu")
    for name, val in got.items():
        if Q.is_quantized(val):
            assert loaded[name]["q"].dtype == val["q"].dtype
            assert torch.equal(loaded[name]["q"], val["q"])
            assert torch.equal(loaded[name]["s"], val["s"])
        else:
            assert torch.equal(loaded[name], val)
    assert tmodel.config_from_params(loaded, 2) == \
        tmodel.config_from_params(tparams, 2)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_kv_quantize_rows_match_jax_bytewise(mode):
    import jax.numpy as jnp

    rs = np.random.RandomState(9)
    x = (rs.randn(3, 5, 2, 4).astype(np.float32)
         * np.logspace(-2, 2, 5).astype(np.float32)[None, :, None, None])
    x[0, 0] = 0.0
    x[2, 4] = 0.0
    q, s = Q.kv_quantize_rows(torch.from_numpy(x), mode)
    jqv, js = jq.kv_quantize_rows(jnp.asarray(x), mode)
    _same(q, jqv)
    _same(s, js)
    assert s[0, 0] == 1.0 and not q[0, 0].any()
    np.testing.assert_array_equal(Q.kv_dequantize(q, s).numpy(),
                                  np.asarray(jq.kv_dequantize(jqv, js)))
    with pytest.raises(MXNetError):
        Q.kv_quantize_rows(torch.from_numpy(x), "")


def nonfinite_rows():
    """Four KV rows (H 2, D 4): finite, one NaN, one +Inf, a NaN and a
    -Inf together."""
    x = np.random.RandomState(10).randn(4, 2, 4).astype(np.float32)
    x[1, 0, 2] = np.nan
    x[2, 1, 3] = np.inf
    x[3, 0, 0], x[3, 1, 1] = np.nan, -np.inf
    return x


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_kv_quantize_rows_non_finite_match_jax(mode):
    """The plain form of K9 on rows holding a NaN or an Inf, against the
    JAX package: scales exactly (1.0 for a NaN row, Inf for an Inf row);
    int8 codes byte for byte (a NaN quotient casts to 0 on the CPU, in
    both packages); e4m3 codes as decoded values, NaN where JAX's are NaN
    (a NaN byte's sign bit is the platform's)."""
    import jax.numpy as jnp

    x = nonfinite_rows()
    q, s = Q.kv_quantize_rows(torch.from_numpy(x), mode)
    jqv, js = jq.kv_quantize_rows(jnp.asarray(x), mode)
    _same(s, js)
    assert s[1] == 1.0 and s[2] == float("inf")
    if mode == "int8":
        _same(q, jqv)
        assert q[1, 0, 2] == 0 and q[2, 1, 3] == 0
    else:
        got = Q.codes_to_float(q).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jqv).astype(np.float32))
        assert np.isnan(got[1, 0, 2]) and np.isnan(got[2, 1, 3])


def test_page_bytes_match_jax():
    for mode in ("", "int8", "fp8", "e4m3"):
        assert PagedKVCache.page_bytes(8, 16, 128, 16, kv_quant=mode) == \
            JaxPagedKVCache.page_bytes(8, 16, 128, 16, kv_quant=mode)
    assert PagedKVCache.page_bytes(8, 16, 128, 16) == 2 << 20
    assert PagedKVCache.page_bytes(8, 16, 128, 16, "int8") == 525312


# ---------------------------------------------------------------------------
# the kernels' plain forms over quantized operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_linear_equals_plain_on_dequantized_weight(mode):
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 5, 48).astype(np.float32))
    q, s = Q.quantize_array(torch.from_numpy(
        rs.randn(40, 48).astype(np.float32)), mode)
    b = torch.from_numpy(rs.randn(40).astype(np.float32))
    w = Q.dequantize_array(q, s)
    rec = {"q": q, "s": s}
    for bias in (b, None):
        assert torch.equal(L.mi_linear(x, rec, bias),
                           L.mi_linear_plain(x, w, bias))
        assert torch.equal(L.mi_linear(x, rec, bias, exact=False),
                           L.mi_linear(x, w, bias, exact=False))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_paged_attention_equals_dequantized_pools(mode):
    rs = np.random.RandomState(4)
    page, h, d, s = 8, 2, 16, 3
    rows = torch.from_numpy(rs.randn(13, page, h, d).astype(np.float32))
    codes, scales = [], []
    for _ in range(2):
        c, sc = Q.kv_quantize_rows(rows * float(rs.rand() + 0.5), mode)
        codes.append(c)
        scales.append(sc)
    tables = torch.from_numpy(
        rs.permutation(12)[:12].reshape(s, 4).astype(np.int32))
    q = torch.from_numpy(rs.randn(s, h, 3, d).astype(np.float32))
    lengths = torch.tensor([[5, 6, 7], [17, 18, 19], [30, 31, 32]],
                           dtype=torch.int32)
    got = A.paged_attention(q, codes[0], codes[1], tables, lengths,
                            k_scale=scales[0], v_scale=scales[1])
    want = A.paged_attention_plain(
        q, Q.kv_dequantize(codes[0], scales[0]),
        Q.kv_dequantize(codes[1], scales[1]), tables, lengths)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_kv_append_plain_writes_the_jax_pools(mode):
    import jax.numpy as jnp

    rs = np.random.RandomState(5)
    layers, pages, page, h, d = 2, 6, 4, 2, 8
    k = rs.randn(7, h, d).astype(np.float32)
    v = rs.randn(7, h, d).astype(np.float32)
    k[2] = 0.0
    page_ids = np.array([0, 0, 3, 5, 2, 6, 6])  # two rows to trash (6)
    offs = np.array([0, 1, 3, 2, 0, 1, 1])
    cache = PagedKVCache(layers, h, d, page, pages, 2, 3, kv_quant=mode,
                         device="cpu")
    jcache = JaxPagedKVCache(layers, h, d, page, pages, 2, 3, kv_quant=mode)
    Q.kv_append_quantized(cache.k_pool[1], cache.v_pool[1],
                          cache.k_scale[1], cache.v_scale[1],
                          torch.from_numpy(page_ids), torch.from_numpy(offs),
                          torch.from_numpy(k), torch.from_numpy(v))
    for pool, scale, rows, got, got_s in (
            (jcache.k_pool, jcache.k_scale, k, cache.k_pool, cache.k_scale),
            (jcache.v_pool, jcache.v_scale, v, cache.v_pool, cache.v_scale)):
        pool, scale = jmodel._kv_append(
            pool, scale, 1, jnp.asarray(page_ids), jnp.asarray(offs),
            jnp.asarray(rows), mode)
        _same(got[:, :pages], np.asarray(pool)[:, :pages])
        _same(got_s[:, :pages], np.asarray(scale)[:, :pages])
    assert cache.pool_bytes() == jcache.pool_bytes()


def test_copy_on_write_carries_scale_rows():
    import jax.numpy as jnp

    kw = dict(num_layers=1, num_heads=2, head_dim=4, page_size=8,
              num_pages=10, slots=3, max_pages_per_slot=4, prefix_pages=-1,
              kv_quant="int8")
    jcache = JaxPagedKVCache(**kw)
    tcache = PagedKVCache(device="cpu", **kw)
    fill = (np.arange(np.prod(jcache.k_scale.shape), dtype=np.float32)
            .reshape(jcache.k_scale.shape) + 1.0)
    codes = (np.arange(np.prod(jcache.k_pool.shape)) % 251 - 125) \
        .astype(np.int8).reshape(jcache.k_pool.shape)
    jcache.k_scale = jcache.v_scale = jnp.asarray(fill)
    jcache.k_pool = jcache.v_pool = jnp.asarray(codes)
    tcache.k_scale, tcache.v_scale = (torch.from_numpy(fill.copy())
                                      for _ in range(2))
    tcache.k_pool, tcache.v_pool = (torch.from_numpy(codes.copy())
                                    for _ in range(2))
    toks = list(range(1, 21))
    for cache in (jcache, tcache):
        s0 = cache.alloc(20, 4, tokens=toks)
        cache.lengths[s0] = 20
        cache.register_prefix(s0, toks)
        s1 = cache.alloc(20, 4, tokens=toks, oversub=True)  # hits 2 pages
        assert cache.ensure_writable(s1, 0, 16) == 2
    assert tcache._tables.tolist() == jcache._tables.tolist()
    new = [int(p) for p in tcache._tables[1, :2]]
    old = [int(p) for p in tcache._tables[0, :2]]
    for a, b in zip(new, old):
        assert torch.equal(tcache.k_scale[:, a], tcache.k_scale[:, b])
        assert torch.equal(tcache.v_pool[:, a], tcache.v_pool[:, b])
    np.testing.assert_array_equal(tcache.k_scale.numpy(),
                                  np.asarray(jcache.k_scale))
    np.testing.assert_array_equal(tcache.v_pool.numpy(),
                                  np.asarray(jcache.v_pool))


# ---------------------------------------------------------------------------
# quantized sessions
# ---------------------------------------------------------------------------

def _sconf(**kw):
    base = dict(slots=3, page_size=PAGE, buckets=(16,), max_new=6,
                exact=True)
    base.update(kw)
    return base


def _trace(api, n=4, seed=31):
    rs = np.random.RandomState(seed)
    return [api.Request(rid=i, prompt=rs.randint(
        1, CFG.vocab_size, size=n_tok).tolist(), max_new=6, arrival_s=0.0)
        for i, n_tok in enumerate([5, 9, 14, 3][:n])]


def _recording(sess):
    """Wrap a session so each logits row is kept beside the transcript
    that produced it."""
    rows, seqs = [], {}
    prefill_fn, step_fn = sess.prefill, sess.step

    def prefill(slot, prompt):
        first, logits = prefill_fn(slot, prompt)
        rows.append((tuple(prompt), np.asarray(logits).copy()))
        seqs[slot] = list(prompt) + [first]
        return first, logits

    def step():
        toks, logits = step_fn()
        for slot, tok in toks.items():
            rows.append((tuple(seqs[slot]), np.asarray(logits[slot]).copy()))
            seqs[slot].append(tok)
        return toks, logits

    sess.prefill, sess.step = prefill, step
    return rows


def _run(api, sess):
    rows = _recording(sess)
    done, _ = api.Scheduler(sess, policy="continuous").run(_trace(api))
    assert all(not r.failed for r in done)
    return {r.rid: list(r.tokens) for r in done}, rows


@pytest.fixture(scope="module")
def runs(np_params):
    """For each (quant, kv_quant): the port session, its streams and
    logits rows, and (for JAX_COMBOS) the JAX session's streams and rows
    over the same trace."""
    out = {}
    for quant, kv_quant in COMBOS:
        conf = _sconf(quant=quant, kv_quant=kv_quant)
        tsess = tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                        config=tserve.ServeConfig(**conf),
                                        device="cpu")
        jrun = None
        if (quant, kv_quant) in JAX_COMBOS:
            jrun = _run(jserve, jserve.InferenceSession(
                np_params, num_heads=CFG.num_heads,
                config=jserve.ServeConfig(**conf)))
        out[quant, kv_quant] = (tsess, _run(tserve, tsess), jrun)
    return out


@pytest.mark.parametrize("quant,kv_quant", COMBOS)
def test_quantized_session_bitexact_vs_per_precision_oracle(runs, quant,
                                                            kv_quant):
    sess, (_, rows), _ = runs[quant, kv_quant]
    if quant:
        assert Q.is_quantized(sess.params["blk0_ffn1_weight"])
        assert sess.params_bytes_at_rest() < \
            Q.at_rest_bytes(sess.dequantized_params()) / 3.0
    if kv_quant:
        assert sess.cache.k_pool.dtype == Q.storage_dtype(kv_quant)
        assert sess.cache.k_scale.shape == sess.cache.k_pool.shape[:3]
    dq = sess.dequantized_params()
    assert len(rows) == 4 * 6
    for seq, logits in rows:
        ref = tmodel.reference_last_logits(dq, seq, sess.model, PAGE,
                                           exact=True, kv_quant=kv_quant)
        np.testing.assert_array_equal(logits, ref.numpy())


@pytest.mark.parametrize("quant,kv_quant", JAX_COMBOS)
def test_quantized_session_matches_jax_session(runs, quant, kv_quant):
    _, (streams, rows), (jstreams, jrows) = runs[quant, kv_quant]
    assert streams == jstreams
    want = dict(jrows)
    gaps = []
    for seq, logits in rows:
        np.testing.assert_allclose(logits, want[seq], rtol=0, atol=ATOL)
        top = np.sort(logits)[-2:]
        gaps.append(float(top[1] - top[0]))
    assert min(gaps) > 10 * ATOL


@pytest.mark.parametrize("draft", ["ngram", "layers:1"])
def test_kv_quant_spec_decoding_keeps_the_streams(np_params, runs, draft):
    _, (want, _), _ = runs["", "int8"]
    sess = tserve.InferenceSession(
        np_params, num_heads=CFG.num_heads, device="cpu",
        config=tserve.ServeConfig(**_sconf(kv_quant="int8", spec_k=3,
                                           draft=draft)))
    done, _ = tserve.Scheduler(sess, policy="continuous").run(
        _trace(tserve))
    assert {r.rid: list(r.tokens) for r in done} == want
    assert sess.spec_report()["verify_steps"] > 0
    if draft.startswith("layers"):
        assert sess.draft_cache.kv_quant == "int8"


def test_quantized_prefix_hit_suffix_prefill_bitexact(np_params):
    sess = tserve.InferenceSession(
        np_params, num_heads=CFG.num_heads, device="cpu",
        config=tserve.ServeConfig(**_sconf(buckets=(8, 16, 24), quant="fp8",
                                           kv_quant="int8",
                                           prefix_pages=-1)))
    dq = sess.dequantized_params()
    rs = np.random.RandomState(13)
    shared = rs.randint(1, CFG.vocab_size, size=16).tolist()
    a = shared + rs.randint(1, CFG.vocab_size, size=4).tolist()
    b = shared + rs.randint(1, CFG.vocab_size, size=5).tolist()
    slot = sess.try_alloc(len(a), 4, tokens=a)
    sess.prefill(slot, a)
    sess.release(slot)
    slot = sess.try_alloc(len(b), 4, tokens=b)
    assert sess.cache.cached_len(slot) == 16
    first, logits = sess.prefill(slot, b)

    def ref(seq):
        return tmodel.reference_last_logits(dq, seq, sess.model, PAGE,
                                            exact=True,
                                            kv_quant="int8").numpy()

    np.testing.assert_array_equal(logits, ref(b))
    _, logits = sess.step()
    np.testing.assert_array_equal(logits[slot], ref(b + [first]))


def test_quant_config_from_env_matches_jax(monkeypatch):
    for var, field, val in (("MXNET_SERVE_QUANT", "quant", "i8"),
                            ("MXNET_SERVE_QUANT", "quant", "off"),
                            ("MXNET_SERVE_KV_QUANT", "kv_quant", "e4m3"),
                            ("MXNET_SERVE_KV_QUANT", "kv_quant", "INT8")):
        monkeypatch.setenv(var, val)
        assert getattr(tserve.ServeConfig.from_env(), field) == \
            getattr(jserve.ServeConfig.from_env(), field)
        monkeypatch.delenv(var)
    for field in ("quant", "kv_quant"):
        with pytest.raises(MXNetError):
            tserve.ServeConfig(**{field: "int4"})
        with pytest.raises(JaxMXNetError):
            jserve.ServeConfig(**{field: "int4"})
