"""Hybrid serving stacks in the port — sliding-window layers over per-slot
KV rings and SSM layers over a per-slot state (``mxnet_tpu_torch/serve``,
``ops/attention.py``'s window half, ``ops/ssm_ops.py``) — on the CPU,
where the wrappers run the plain versions of K1, K2/K2q and K10.

The first part holds the port against the JAX package on numpy-seeded
inputs: the windowed flash forward and windowed decode attention (rtol
1e-5, atol 1e-6), the rotated ring table against ``_ring_gather``, and
the hybrid full-context forward (atol 1e-4; fp32, reductions in other
orders).  The rest are the twins of ``tests/test_serve_window.py``, each
held against the port's own ``reference_last_logits``, bit for bit.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import serve as jserve
from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.serve import model as jmodel
from mxnet_tpu_torch import serve as tserve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import ssm_ops as tssm
from mxnet_tpu_torch.serve import model as tmodel
from mxnet_tpu_torch.serve.kv_cache import PagedKVCache
from mxnet_tpu_torch.testing import faults

CFG = jserve.ModelConfig(vocab_size=61, num_layers=3, d_model=32,
                         num_heads=2, max_len=256)
PAGE = 8
WINDOW = 8
HYBRID = dict(layers="full,window,ssm", window=WINDOW)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("MXNET_FAULT_INJECT", raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def np_params():
    """The serving LM's parameters under the training names, drawn with
    numpy (the JAX package's ``init_params`` layout and scale)."""
    rs = np.random.RandomState(3)
    c, v = CFG.d_model, CFG.vocab_size

    def normal(*shape):
        return (0.02 * rs.randn(*shape)).astype(np.float32)

    params = {"tok_embed_weight": normal(v, c),
              "pos_embed": normal(1, CFG.max_len, c),
              "final_ln_gamma": np.ones(c, np.float32),
              "final_ln_beta": np.zeros(c, np.float32),
              "lm_head_weight": normal(v, c),
              "lm_head_bias": np.zeros(v, np.float32)}
    for i in range(CFG.num_layers):
        for name, shape in (("attn_in_weight", (3 * c, c)),
                            ("attn_out_weight", (c, c)),
                            ("ffn1_weight", (4 * c, c)),
                            ("ffn2_weight", (c, 4 * c))):
            params["blk%d_%s" % (i, name)] = normal(*shape)
        for name, n in (("attn_in_bias", 3 * c), ("attn_out_bias", c),
                        ("ffn1_bias", 4 * c), ("ffn2_bias", c),
                        ("ln1_beta", c), ("ln2_beta", c)):
            params["blk%d_%s" % (i, name)] = np.zeros(n, np.float32)
        for name in ("ln1_gamma", "ln2_gamma"):
            params["blk%d_%s" % (i, name)] = np.ones(c, np.float32)
    return params


def _session(np_params, **kw):
    sconf = dict(slots=2, page_size=PAGE, buckets=(16, 32), max_new=8,
                 exact=True)
    sconf.update(kw)
    return tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                   config=tserve.ServeConfig(**sconf),
                                   device="cpu")


@pytest.fixture(scope="module")
def hybrid_session(np_params):
    return _session(np_params, slots=3, **HYBRID)


def _ref_row(sess, seq):
    return tmodel.reference_last_logits(
        sess.params, seq, sess.model, sess.config.page_size, exact=True,
        kv_quant=sess.config.kv_quant).numpy()


def _greedy_oracle(sess, prompt, max_new):
    seq, out = list(prompt), []
    for _ in range(max_new):
        tok = int(np.argmax(_ref_row(sess, seq)))
        out.append(tok)
        seq.append(tok)
    return out


def _trace(n, seed, prompt_len=8, max_new=6):
    rs = np.random.RandomState(seed)
    return [tserve.Request(rid=i, prompt=rs.randint(
                1, CFG.vocab_size, size=prompt_len).tolist(),
                max_new=max_new, arrival_s=0.0) for i in range(n)]


def _jnp(*arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_windowed_flash_attention_matches_jax(causal):
    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(2, 2, 29, 16).astype(np.float32) for _ in range(3))
    want = np.asarray(jattn.flash_attention(*_jnp(q, k, v), causal=causal,
                                            block=PAGE, mi=True,
                                            window=WINDOW))
    got = tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal, block=PAGE, mi=True,
                                window=WINDOW)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ref = tattn.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal, window=WINDOW)
    jref = np.asarray(jattn.reference_attention(*_jnp(q, k, v),
                                                causal=causal, window=WINDOW))
    np.testing.assert_allclose(ref.numpy(), jref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("labelled", [False, True])
def test_windowed_decode_attention_matches_jax(labelled):
    """decode_attention with a window, with and without explicit position
    labels (a rotated context whose first page holds negative positions),
    per-slot and per-row horizons."""
    import jax.numpy as jnp

    rs = np.random.RandomState(4)
    s, h, q_rows, cap, d = 2, 2, 3, 32, 16
    q = rs.randn(s, h, q_rows, d).astype(np.float32)
    k, v = (rs.randn(s, h, cap, d).astype(np.float32) for _ in range(2))
    lengths = np.array([[20, 21, 22], [9, 10, 11]], np.int32)
    kpos = None
    if labelled:
        kpos = (np.array([[-8], [0]], np.int32)
                + np.arange(cap, dtype=np.int32)[None, :])
    want = np.asarray(jattn.decode_attention(
        *_jnp(q, k, v, lengths), block=PAGE, mi=True, window=WINDOW,
        k_positions=None if kpos is None else jnp.asarray(kpos)))
    got = tattn.decode_attention(
        *(torch.from_numpy(x) for x in (q, k, v, lengths)), block=PAGE,
        mi=True, window=WINDOW,
        k_positions=None if kpos is None else torch.from_numpy(kpos))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_rotated_ring_table_reads_the_rows_of_ring_gather():
    """The port's rotated table, read through the page gather, gives the
    rows and position labels of the JAX package's ``_ring_gather`` (the
    port's ring pool is the JAX one reshaped)."""
    import jax.numpy as jnp

    rs = np.random.RandomState(6)
    s, rp, h, d = 3, 4, 2, 4
    ring = rs.randn(1, s, rp * PAGE, h, d).astype(np.float32)
    pb_max = np.array([2, 7, 13], np.int32)
    ctx, _, kp = jmodel._ring_gather(jnp.asarray(ring), None, 0,
                                     jnp.asarray(pb_max), PAGE, "")
    pool = torch.from_numpy(ring.reshape(1, s * rp, PAGE, h, d))
    table, k_pos0 = tmodel.ring_table(torch.arange(s),
                                      torch.from_numpy(pb_max), rp, PAGE)
    got = tattn.gather_pages(pool[0], table)  # (S, H, RP * page, D)
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(),
                                  np.asarray(ctx))
    np.testing.assert_array_equal(
        tattn.table_positions(k_pos0, table, PAGE).numpy(), np.asarray(kp))


def test_hybrid_full_forward_matches_jax(np_params):
    """The hybrid stack's full-context forward (the oracle) against the JAX
    package's, on JAX-initialised weights: atol 1e-4."""
    import jax.numpy as jnp

    cfg = jserve.ModelConfig(vocab_size=61, num_layers=3, d_model=32,
                             num_heads=2, max_len=256, window=WINDOW,
                             layer_kinds=("full", "window", "ssm"))
    import jax

    toks = np.random.RandomState(1).randint(1, CFG.vocab_size, size=(2, 27))
    want = np.asarray(jax.jit(lambda p, t: jmodel.full_forward(
        p, t, cfg, exact=True, block=PAGE))(
        {k: jnp.asarray(v) for k, v in np_params.items()},
        jnp.asarray(toks)))
    params = tmodel.params_from_numpy(np_params, "cpu")
    tcfg = tmodel.ModelConfig(vocab_size=61, num_layers=3, d_model=32,
                              num_heads=2, max_len=256, window=WINDOW,
                              layer_kinds=("full", "window", "ssm"))
    got = tmodel.full_forward(params, torch.from_numpy(toks), tcfg,
                              exact=True, block=PAGE).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_windowed_flash_attention_with_grad_raises():
    q = torch.randn(1, 2, 16, 8, requires_grad=True)
    with pytest.raises(MXNetError, match="window"):
        tattn.flash_attention(q, q, q, window=4)
    with torch.no_grad():  # no autograd: the forward runs
        assert tattn.flash_attention(q, q, q, window=4).shape == q.shape


# ---------------------------------------------------------------------------
# config + cache bookkeeping (twins of test_serve_window.py)
# ---------------------------------------------------------------------------

def test_serve_config_hybrid_validation():
    with pytest.raises(MXNetError):
        tserve.ServeConfig(page_size=PAGE, buckets=(16,), window=-1)
    with pytest.raises(MXNetError):
        tserve.ServeConfig(page_size=PAGE, buckets=(16,), layers="full,conv")
    with pytest.raises(MXNetError):
        tserve.ServeConfig(page_size=PAGE, buckets=(16,),
                           layers="window,full")
    cfg = tserve.ServeConfig(page_size=PAGE, buckets=(16, 32), max_new=8,
                             **HYBRID)
    assert cfg.kinds_for(5) == ("full", "window", "ssm", "full", "window")
    assert tserve.ServeConfig(page_size=PAGE, buckets=(16,),
                              layers="full").kinds_for(3) == ()
    assert cfg.ring_pages == (WINDOW + 32 - 1 + PAGE - 1) // PAGE + 1
    spec = tserve.ServeConfig(page_size=PAGE, buckets=(16,), spec_k=20,
                              **HYBRID)
    jspec = jserve.ServeConfig(page_size=PAGE, buckets=(16,), spec_k=20,
                               **HYBRID)
    assert spec.ring_pages == jspec.ring_pages


def test_serve_config_hybrid_env(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_WINDOW", "24")
    monkeypatch.setenv("MXNET_SERVE_LAYERS", "window;ssm")
    cfg = tserve.ServeConfig.from_env()
    assert (cfg.window, cfg.layer_pattern) == (24, ("window", "ssm"))


def test_ring_cache_bookkeeping():
    cache = PagedKVCache(num_layers=3, num_heads=2, head_dim=4, page_size=8,
                         num_pages=4, slots=2, max_pages_per_slot=2,
                         layer_kinds=("full", "window", "ssm"), window=8,
                         ring_pages=3, device="cpu")
    assert (cache.n_full, cache.n_window, cache.n_ssm) == (1, 1, 1)
    assert cache.hybrid
    assert cache.k_pool.shape[0] == 1
    assert tuple(cache.kw_pool.shape) == (1, 2 * 3, 8, 2, 4)
    assert tuple(cache.ssm_state.shape) == (1, 2, 2, 4, 4)
    full_bytes = 2 * cache.k_pool.numel() * 4
    assert cache.pool_bytes() == full_bytes + cache.ring_bytes() \
        + cache.state_bytes()
    assert cache.ring_bytes() == 2 * 6 * 8 * 2 * 4 * 4
    cache.ssm_state.fill_(1.0)
    slot = cache.alloc(5, 8)
    assert float(cache.ssm_state[:, slot].abs().max()) == 0.0
    assert float(cache.ssm_state[:, 1 - slot].abs().min()) == 1.0
    # truncate stays lengths-only
    cache.lengths[slot] = 7
    cache.truncate(slot, 3)
    assert int(cache.lengths[slot]) == 4

    nofull = PagedKVCache(num_layers=2, num_heads=2, head_dim=4, page_size=8,
                          num_pages=1, slots=3, max_pages_per_slot=1,
                          layer_kinds=("window", "ssm"), window=8,
                          ring_pages=2, device="cpu")
    assert nofull.pages_needed(8, 8) == 0
    slots = [nofull.alloc(8, 8) for _ in range(3)]
    assert all(s is not None for s in slots)
    assert nofull.free_slots == 0


def test_ring_pool_bytes_match_jax():
    kw = dict(num_layers=3, num_heads=2, head_dim=4, page_size=8,
              num_pages=4, slots=2, max_pages_per_slot=2,
              layer_kinds=("full", "window", "ssm"), window=8, ring_pages=3)
    from mxnet_tpu.serve.kv_cache import PagedKVCache as JaxCache

    for mode in ("", "int8"):
        ours = PagedKVCache(kv_quant=mode, device="cpu", **kw)
        theirs = JaxCache(kv_quant=mode, **kw)
        assert ours.pool_bytes() == theirs.pool_bytes()
        assert ours.ring_tokens == theirs.ring_tokens


# ---------------------------------------------------------------------------
# bit-exactness: hybrid decode vs the hybrid oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["", "int8", "e4m3"])
def test_hybrid_decode_bitexact_vs_reference(np_params, kv_quant):
    """Prefill + decode through a full x window x ssm stack give the
    oracle's logits bit for bit, across position 16 (the window slides
    past the prompt and the ring wraps), at every KV precision."""
    sess = _session(np_params, max_new=16, kv_quant=kv_quant, **HYBRID)
    rs = np.random.RandomState(7)
    prompt = rs.randint(1, CFG.vocab_size, size=13).tolist()
    slot = sess.try_alloc(len(prompt), 8)
    first, logits = sess.prefill(slot, prompt)
    np.testing.assert_array_equal(logits, _ref_row(sess, prompt))
    seq = prompt + [first]
    for _ in range(6):
        toks, logs = sess.step()
        np.testing.assert_array_equal(logs[slot], _ref_row(sess, seq))
        seq.append(toks[slot])
    sess.release(slot)


def test_hybrid_chunked_prefill_wraps_the_ring_bitexact(np_params):
    """A prompt longer than the largest bucket prefills in two chunks: the
    SSM state crosses the chunk boundary, the second chunk's ring writes
    wrap over the first's, and the logits stay the oracle's."""
    sess = _session(np_params, max_new=24, **HYBRID)
    rs = np.random.RandomState(8)
    prompt = rs.randint(1, CFG.vocab_size, size=45).tolist()
    slot = sess.try_alloc(len(prompt), 8, resume=True)
    first, logits = sess.prefill(slot, prompt)
    np.testing.assert_array_equal(logits, _ref_row(sess, prompt))
    toks, logs = sess.step()
    np.testing.assert_array_equal(logs[slot], _ref_row(sess,
                                                       prompt + [first]))
    sess.release(slot)


def test_hybrid_cobatched_equals_solo(hybrid_session):
    sess = hybrid_session
    rs = np.random.RandomState(12)
    p = rs.randint(1, CFG.vocab_size, size=9).tolist()

    def run(neighbors):
        slot = sess.try_alloc(len(p), 6)
        first, _ = sess.prefill(slot, p)
        others = []
        for q in neighbors:
            s = sess.try_alloc(len(q), 6)
            sess.prefill(s, q)
            others.append(s)
        out = [first]
        for _ in range(5):
            toks, _ = sess.step()
            out.append(toks[slot])
        for s in [slot] + others:
            sess.release(s)
        return out

    solo = run([])
    crowd = run([rs.randint(1, CFG.vocab_size, size=14).tolist(),
                 rs.randint(1, CFG.vocab_size, size=6).tolist()])
    assert solo == crowd


def test_no_full_layers_session_decodes_and_admits_by_slots(np_params):
    sess = _session(np_params, slots=3, buckets=(16,), layers="window,ssm",
                    window=WINDOW)
    assert sess.cache.pages_needed(16, 8) == 0
    rs = np.random.RandomState(9)
    prompts = [rs.randint(1, CFG.vocab_size, size=11).tolist()
               for _ in range(3)]
    slots, seqs = [], []
    for p in prompts:
        slot = sess.try_alloc(len(p), 8)
        assert slot is not None
        first, logits = sess.prefill(slot, p)
        np.testing.assert_array_equal(logits, _ref_row(sess, p))
        slots.append(slot)
        seqs.append(list(p) + [first])
    for _ in range(4):
        toks, logs = sess.step()
        for slot, seq in zip(slots, seqs):
            np.testing.assert_array_equal(logs[slot], _ref_row(sess, seq))
            seq.append(toks[slot])
    for slot in slots:
        sess.release(slot)


# ---------------------------------------------------------------------------
# ops level: the windowed kernels' plain versions and the ring contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_decode_matches_flash_last_row(dtype):
    s, h, t, d, b = 2, 2, 24, 16, 8
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(s, h, t, d).astype(np.float32))
               .to(dtype) for _ in range(3))
    full = tattn.flash_attention(q, k, v, causal=True, block=b, mi=True,
                                 window=WINDOW)
    dec = tattn.decode_attention(q[:, :, -1:], k, v,
                                 torch.full((s,), t, dtype=torch.int32),
                                 block=b, mi=True, window=WINDOW)
    assert torch.equal(dec[:, :, 0].float(), full[:, :, -1].float())


def test_ring_rotation_with_position_labels_is_exact():
    """Rotating the context page by page with position labels gives the
    contiguous layout's output bit for bit; rows left of the window are
    exact no-ops — and the paged form over a ring pool and its rotated
    table gives the same bits."""
    s, h, t, d, b = 2, 2, 24, 16, 8
    rs = np.random.RandomState(4)
    q1 = torch.from_numpy(rs.randn(s, h, 1, d).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(s, h, t, d).astype(np.float32))
            for _ in range(2))
    lengths = torch.full((s,), t, dtype=torch.int32)
    pos = torch.arange(t, dtype=torch.int32).expand(s, t)

    def f(kk, vv, pp):
        return tattn.decode_attention(q1, kk, vv, lengths, block=b, mi=True,
                                      window=WINDOW, k_positions=pp)

    base = f(k, v, pos)
    for shift_pages in (1, 2):
        r = shift_pages * b
        rot = f(k.roll(r, 2), v.roll(r, 2), pos.roll(r, 1))
        assert torch.equal(rot, base)
    k_bad, v_bad = k.clone(), v.clone()
    k_bad[:, :, :t - WINDOW] = 1e6
    v_bad[:, :, :t - WINDOW] = -1e6
    assert torch.equal(f(k_bad, v_bad, pos), base)

    # the same context as a ring of 3 pages a slot, read through the
    # rotated table whose newest page is 2: the paged plain version
    rp = t // b
    pool = k.transpose(1, 2).reshape(s * rp, b, h, d)
    vpool = v.transpose(1, 2).reshape(s * rp, b, h, d)
    table, k_pos0 = tmodel.ring_table(torch.arange(s),
                                      torch.full((s,), rp - 1), rp, b)
    got = tattn.paged_attention(q1, pool, vpool, table, lengths, mi=True,
                                window=WINDOW, k_pos0=k_pos0)
    assert torch.equal(got, base)


def test_ssm_chunked_prefill_equals_serial_decode():
    s, t, h, d = 2, 16, 2, 8
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(s, t, h, d).astype(np.float32))
               for _ in range(3))
    gamma = tssm.ssm_decay(h)
    state0 = torch.zeros((s, h, d, d))
    y_full, s_full = tssm.ssm_scan(q, k, v, state0, gamma)
    y_a, s_mid = tssm.ssm_scan(q[:, :8], k[:, :8], v[:, :8], state0, gamma)
    y_b, s_chunk = tssm.ssm_scan(q[:, 8:], k[:, 8:], v[:, 8:], s_mid, gamma)
    assert torch.equal(torch.cat([y_a, y_b], 1), y_full)
    assert torch.equal(s_chunk, s_full)
    state, rows = state0, []
    for i in range(t):
        y_i, state = tssm.ssm_scan(q[:, i:i + 1], k[:, i:i + 1],
                                   v[:, i:i + 1], state, gamma)
        rows.append(y_i)
    assert torch.equal(torch.cat(rows, 1), y_full)
    assert torch.equal(state, s_full)
    valid = (torch.arange(t) < 10).expand(s, t)
    _, s_ragged = tssm.ssm_scan(q, k, v, state0, gamma, row_valid=valid)
    _, s_short = tssm.ssm_scan(q[:, :10], k[:, :10], v[:, :10], state0,
                               gamma)
    assert torch.equal(s_ragged, s_short)


# ---------------------------------------------------------------------------
# speculative decoding on hybrid stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["ngram", "layers:2"])
def test_hybrid_spec_decode_matches_oracle(np_params, draft):
    """Speculation commits exactly the serial greedy stream: the verify
    computes acceptance on the device and writes each slot's committed
    SSM state; rings roll back by length.  ``layers:2`` inherits the
    target's full,window prefix."""
    sess = _session(np_params, max_new=16, spec_k=3, draft=draft, **HYBRID)
    if draft.startswith("layers"):
        assert sess.draft_model.kinds == ("full", "window")
        assert sess.draft_cache.n_window == 1
    assert "limits" in sess.executables["verify"].inputs
    rs = np.random.RandomState(7)
    prompt = rs.randint(1, CFG.vocab_size, size=13).tolist()
    oracle = _greedy_oracle(sess, prompt, 10)
    slot = sess.try_alloc(len(prompt), 16)
    first, _ = sess.prefill(slot, prompt)
    got = [first]
    while len(got) < 10:
        got.extend(sess.spec_step()[slot])
    assert got[:10] == oracle
    stats = sess.spec_report()
    assert stats["verify_steps"] > 0
    assert stats["committed"] == len(got) - 1
    sess.release(slot)


def test_hybrid_verify_writes_the_committed_ssm_state(np_params):
    """The verify's snapshot select: after a speculative step the slot's
    SSM state is the serial decode's state at the commit point, bit for
    bit (a never-matching draft commits one token a step)."""
    spec = _session(np_params, max_new=16, spec_k=3, draft="ngram", **HYBRID)
    plain = _session(np_params, max_new=16, **HYBRID)
    prompt = list(range(3, 16))
    for sess in (spec, plain):
        sess.try_alloc(len(prompt), 16)
        sess.prefill(0, prompt)
    spec._ngram_propose = lambda slot, k: [0] * k  # never the greedy token
    for _ in range(3):
        committed = spec.spec_step()[0]
        assert len(committed) == 1
        toks, _ = plain.step()
        assert committed == [toks[0]]
        assert torch.equal(spec.cache.ssm_state[:, 0],
                           plain.cache.ssm_state[:, 0])


def test_hybrid_draft_with_ssm_layers_rejected(np_params):
    with pytest.raises(MXNetError, match="SSM"):
        _session(np_params, buckets=(16,), spec_k=2, draft="layers:2",
                 layers="full,ssm,window", window=WINDOW)


# ---------------------------------------------------------------------------
# preempt/resume, prefix opt-out, chaos, frozen executables
# ---------------------------------------------------------------------------

def test_hybrid_preempt_resume_bitexact_vs_never_evicted(np_params):
    """Eviction releases only the full layers' pages; resume re-prefills
    through the same entry points and rebuilds rings and SSM states, so
    every resumed stream equals the never-evicted greedy oracle."""
    sess = _session(np_params, slots=3, buckets=(8, 16), num_pages=5,
                    oversub=True, prefix_pages=-1, **HYBRID)
    reqs = _trace(3, seed=23, prompt_len=8, max_new=6)
    oracle = {r.rid: _greedy_oracle(sess, r.prompt, r.max_new)
              for r in reqs}
    sched = tserve.Scheduler(sess, policy="continuous")
    done, _ = sched.run(reqs)
    assert sched.stats["preemptions"] > 0
    assert sched.stats["resumes"] == sched.stats["preemptions"]
    for r in done:
        assert not r.failed, r.error
        assert r.tokens == oracle[r.rid]
    assert sess.cache.free_slots == sess.config.slots


def test_hybrid_prefix_cache_opts_out(np_params):
    sess = _session(np_params, buckets=(16,), prefix_pages=-1, **HYBRID)
    prompt = list(range(1, 17))
    for _ in range(2):
        oracle = _greedy_oracle(sess, prompt, 4)
        slot = sess.try_alloc(len(prompt), 4, tokens=prompt)
        first, _ = sess.prefill(slot, prompt)
        got = [first]
        for _ in range(3):
            toks, _ = sess.step()
            got.append(toks[slot])
        assert got == oracle
        sess.release(slot)
    assert sess.cache.prefix_stats["hits"] == 0
    assert sess.cache.prefix_stats["published_pages"] == 0


@pytest.mark.chaos
def test_chaos_kv_window_fault_isolates_request(np_params, monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_INJECT", "kv_window:raise:after=2")
    faults.reset()
    kw = dict(slots=3, buckets=(8, 16), **HYBRID)
    sess = _session(np_params, **kw)
    done, _ = tserve.Scheduler(sess, policy="continuous").run(
        _trace(3, seed=21, max_new=4))
    failed = [r for r in done if r.failed]
    ok = [r for r in done if not r.failed]
    assert len(failed) == 1 and "FaultInjected" in failed[0].error
    assert len(ok) == 2 and all(len(r.tokens) == 4 for r in ok)
    assert sess.cache.free_slots == sess.config.slots
    monkeypatch.delenv("MXNET_FAULT_INJECT")
    faults.reset()
    clean = _session(np_params, **kw)
    cdone, _ = tserve.Scheduler(clean, policy="continuous").run(
        _trace(3, seed=21, max_new=4))
    want = {r.rid: list(r.tokens) for r in cdone}
    for r in ok:
        assert list(r.tokens) == want[r.rid]


def test_hybrid_executables_frozen_and_guard_tagged(hybrid_session):
    """Hybrid stacks change the entry points' inputs (rings, states, the
    prefill's slot), never their set; the guards' names carry the window
    and the kinds, and each guard saw one signature."""
    sess = hybrid_session
    assert sess._guard_prefix.endswith("-w%dfws" % WINDOW)
    assert "slot" in sess.executables["prefill_16"].inputs
    rs = np.random.RandomState(13)
    reqs = [tserve.Request(rid=i, prompt=rs.randint(
                1, CFG.vocab_size, size=3 + 2 * i).tolist(),
                max_new=5, arrival_s=0.0) for i in range(6)]
    done, _ = tserve.Scheduler(sess, policy="continuous").run(reqs)
    assert all(not r.failed for r in done)
    assert sorted(sess.executables) == ["decode", "prefill_16", "prefill_32"]
    for name, snap in sess.guard_report().items():
        assert snap["traces"] == 1 and snap["signatures"] == 1, (name, snap)
