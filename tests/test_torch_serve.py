"""The port's serving path against the JAX package, at test_serve.py's
sizes (vocab 61, 2 layers, d_model 32, 2 heads, page 8).

JAX ``init_params(seed=3)`` weights go to the port through
``params_from_numpy``; the port runs on the CPU, where its wrappers take
the plain versions of the kernels.  Across the packages, logits agree
within atol 1e-5 (fp32, different reduction orders) and greedy token
streams agree exactly on a trace whose every emitted token leads the
runner-up by more than 10x that tolerance.  Inside the port, the serving
contracts of tests/test_serve.py hold bit for bit.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import serve as jserve
from mxnet_tpu.serve import model as jmodel
from mxnet_tpu.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from mxnet_tpu_torch import serve as tserve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import model as tmodel
from mxnet_tpu_torch.serve.kv_cache import PagedKVCache
from mxnet_tpu_torch.testing import faults

CFG = jserve.ModelConfig(vocab_size=61, num_layers=2, d_model=32,
                         num_heads=2, max_len=64)
PAGE = 8
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("MXNET_FAULT_INJECT", raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def np_params():
    return {k: np.asarray(v)
            for k, v in jmodel.init_params(CFG, seed=3).items()}


def _sconf(**kw):
    base = dict(slots=3, page_size=PAGE, buckets=(8, 16), max_new=8,
                exact=True)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def session(np_params):
    return tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                   config=tserve.ServeConfig(**_sconf()),
                                   device="cpu")


def _ref_row(sess, seq):
    return tmodel.reference_last_logits(sess.params, seq, sess.model, PAGE,
                                        exact=True).numpy()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exact", [True, False])
def test_full_forward_matches_jax(np_params, exact):
    import jax.numpy as jnp

    toks = np.random.RandomState(1).randint(1, CFG.vocab_size, size=(2, 13))
    want = np.asarray(jmodel.full_forward(
        {k: jnp.asarray(v) for k, v in np_params.items()},
        jnp.asarray(toks), CFG, exact=exact, block=PAGE))
    params = tmodel.params_from_numpy(np_params, "cpu")
    got = tmodel.full_forward(params, torch.from_numpy(toks),
                              tmodel.config_from_params(params, 2),
                              exact=exact, block=PAGE).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _trace(n, seed, max_new, lens=None, api=tserve):
    rs = np.random.RandomState(seed)
    lens = lens or [4 + i for i in range(n)]
    return [api.Request(rid=i, prompt=rs.randint(
                1, CFG.vocab_size, size=lens[i]).tolist(),
                max_new=max_new, arrival_s=0.0) for i in range(n)]


def _recording(sess):
    """Wrap the session so every emitted token's top-2 logit gap is kept."""
    gaps = []
    prefill_fn, step_fn = sess.prefill, sess.step

    def gap(row):
        top = np.sort(row)[-2:]
        return float(top[1] - top[0])

    def prefill(slot, prompt):
        first, logits = prefill_fn(slot, prompt)
        gaps.append(gap(logits))
        return first, logits

    def step():
        toks, logits = step_fn()
        gaps.extend(gap(logits[s]) for s in toks)
        return toks, logits

    sess.prefill, sess.step = prefill, step
    return gaps


def test_scheduler_streams_match_jax_session(np_params):
    """One continuous-batching trace through both packages' sessions: the
    greedy streams agree token for token."""
    sconf = _sconf(max_new=6)
    jsess = jserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                    config=jserve.ServeConfig(**sconf))
    tsess = tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                    config=tserve.ServeConfig(**sconf),
                                    device="cpu")
    gaps = _recording(tsess)
    lens = [5, 9, 14, 3, 11]
    jdone, _ = jserve.Scheduler(jsess, policy="continuous").run(
        _trace(5, 31, 6, lens, jserve))
    tdone, _ = tserve.Scheduler(tsess, policy="continuous").run(
        _trace(5, 31, 6, lens))
    assert all(not r.failed for r in tdone)
    assert [r.tokens for r in tdone] == [r.tokens for r in jdone]
    assert len(gaps) == 5 * 6 and min(gaps) > 10 * ATOL


# ---------------------------------------------------------------------------
# the serving contracts, inside the port
# ---------------------------------------------------------------------------

def test_paged_decode_bitexact_vs_reference(session):
    """Prefill + paged decode steps reproduce the port's full-context
    reference forward bit for bit, across a page boundary."""
    rs = np.random.RandomState(11)
    prompts = [rs.randint(1, CFG.vocab_size, size=n).tolist()
               for n in (5, 13)]
    slots, seqs = [], []
    for p in prompts:
        slot = session.try_alloc(len(p), 8)
        assert slot is not None
        first, last_logits = session.prefill(slot, p)
        np.testing.assert_array_equal(last_logits, _ref_row(session, p))
        slots.append(slot)
        seqs.append(list(p) + [first])
    for _ in range(7):
        toks, logits = session.step()
        for slot, seq in zip(slots, seqs):
            np.testing.assert_array_equal(logits[slot],
                                          _ref_row(session, seq))
            seq.append(toks[slot])
    for slot in slots:
        session.release(slot)


def test_cobatched_equals_solo_decode(session):
    """A request decodes the same tokens alone or co-batched."""
    rs = np.random.RandomState(12)
    p = rs.randint(1, CFG.vocab_size, size=6).tolist()

    def run(neighbors):
        slot = session.try_alloc(len(p), 6)
        first, _ = session.prefill(slot, p)
        others = []
        for q in neighbors:
            s = session.try_alloc(len(q), 6)
            session.prefill(s, q)
            others.append(s)
        out = [first]
        for _ in range(5):
            toks, _ = session.step()
            out.append(toks[slot])
        for s in [slot] + others:
            session.release(s)
        return out

    solo = run([])
    crowd = run([rs.randint(1, CFG.vocab_size, size=9).tolist(),
                 rs.randint(1, CFG.vocab_size, size=14).tolist()])
    assert solo == crowd


def test_prefix_hit_suffix_prefill_bitexact(np_params):
    """A prompt whose first two pages are published prefills only its
    suffix at offset 16 — and still matches the reference bit for bit."""
    sess = tserve.InferenceSession(
        np_params, num_heads=CFG.num_heads, device="cpu",
        config=tserve.ServeConfig(**_sconf(buckets=(8, 16, 24),
                                           prefix_pages=-1)))
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
    np.testing.assert_array_equal(logits, _ref_row(sess, b))
    toks, logits = sess.step()
    np.testing.assert_array_equal(logits[slot], _ref_row(sess, b + [first]))


def test_preempt_resume_bitexact_vs_never_evicted(np_params):
    """A 5-page oversubscribed pool under three growing requests must
    preempt; every resumed stream equals the serial full-context greedy
    stream (the never-evicted one)."""
    sess = tserve.InferenceSession(
        np_params, num_heads=CFG.num_heads, device="cpu",
        config=tserve.ServeConfig(**_sconf(num_pages=5, oversub=True,
                                           prefix_pages=-1)))
    reqs = _trace(3, 23, 6, lens=[8, 8, 8])
    oracle = {}
    for r in reqs:
        seq = list(r.prompt)
        for _ in range(r.max_new):
            seq.append(int(np.argmax(_ref_row(sess, seq))))
        oracle[r.rid] = seq[len(r.prompt):]
    sched = tserve.Scheduler(sess, policy="continuous")
    done, _ = sched.run(reqs)
    assert sched.stats["preemptions"] > 0
    assert sched.stats["resumes"] == sched.stats["preemptions"]
    assert sched.stats["peak_active"] == 3
    for r in done:
        assert not r.failed, r.error
        assert r.tokens == oracle[r.rid]
    assert sess.cache.free_slots == sess.config.slots


def _script(cache):
    """alloc / publish / prefix hit / copy-on-write / grow / truncate /
    release on one cache; returns its bookkeeping after each step."""
    snaps = []

    def snap():
        snaps.append((cache._tables.tolist(), cache.lengths.tolist(),
                      sorted(cache._free_pages), sorted(cache._free_slots),
                      dict(cache.prefix_stats), list(cache._retained),
                      {s: cache.cached_len(s) for s in range(cache.slots)}))

    toks = list(range(1, 21))
    s0 = cache.alloc(20, 4, tokens=toks)
    cache.lengths[s0] = 20
    cache.register_prefix(s0, toks)
    snap()
    s1 = cache.alloc(20, 4, tokens=toks, oversub=True)  # hits 2 pages
    snap()
    cache.ensure_writable(s1, 8, 9)  # shared pages -> private copies
    snap()
    cache.append_pages(s1, 30)
    cache.truncate(s0, 3)
    snap()
    cache.release(s0)
    snap()
    s2 = cache.alloc(9, 4, tokens=list(range(1, 10)))
    cache.release(s1)
    cache.release(s2)
    snap()
    return snaps


def test_kv_cache_bookkeeping_matches_jax():
    import jax.numpy as jnp

    kw = dict(num_layers=1, num_heads=2, head_dim=4, page_size=8,
              num_pages=10, slots=3, max_pages_per_slot=4, prefix_pages=-1)
    jcache = JaxPagedKVCache(**kw)
    tcache = PagedKVCache(device="cpu", **kw)
    # distinct page contents, so the copy-on-write copies are checkable
    fill = np.arange(np.prod(jcache.k_pool.shape), dtype=np.float32) \
        .reshape(jcache.k_pool.shape)
    jcache.k_pool = jcache.v_pool = jnp.asarray(fill)
    tcache.k_pool = torch.from_numpy(fill.copy())
    tcache.v_pool = torch.from_numpy(fill.copy())
    assert _script(tcache) == _script(jcache)
    np.testing.assert_array_equal(tcache.k_pool.numpy(),
                                  np.asarray(jcache.k_pool))
    assert tcache.pool_bytes() == 2 * fill.nbytes


def test_executables_and_admission(session):
    assert sorted(session.executables) == \
        ["decode", "prefill_16", "prefill_8"]
    with pytest.raises(MXNetError):
        session.bucket_for(17)
    with pytest.raises(MXNetError):
        session.try_alloc(4, max_new=99)
    with pytest.raises(MXNetError):
        session.try_alloc(0)


@pytest.mark.chaos
def test_chaos_decode_fault_isolates_request(session, monkeypatch):
    """A raise at one request's decode boundary fails that request only;
    the others complete their full generation."""
    monkeypatch.setenv("MXNET_FAULT_INJECT", "serve_decode:raise:after=2")
    faults.reset()
    reqs = _trace(3, 16, 6)
    done, _ = tserve.Scheduler(session, policy="continuous").run(reqs)
    failed = [r for r in done if r.failed]
    ok = [r for r in done if not r.failed]
    assert [r.rid for r in failed] == [1]
    assert "FaultInjected" in failed[0].error
    assert len(ok) == 2 and all(len(r.tokens) == 6 for r in ok)
    assert session.cache.free_slots == session.config.slots


# ---------------------------------------------------------------------------
# entry points and the slice's edges
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card(np_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device"):
        tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                config=tserve.ServeConfig(**_sconf()))
    cfg = tserve.ModelConfig(vocab_size=61, num_layers=2, d_model=32,
                             num_heads=2, max_len=64)
    with pytest.raises(MXNetError, match="device"):
        tserve.init_params(cfg, seed=0)


@pytest.mark.parametrize("field,value", [("window", 16),
                                         ("layers", "full,window"),
                                         ("layers", "full,ssm")])
def test_later_slice_fields_raise(field, value):
    """These fields raised while hybrid stacks were a later slice; now
    each does what the JAX package's ServeConfig does with it: a window
    alone is unused, a windowed pattern without a window raises, and a
    pattern cycles over the depth."""
    kw = dict(page_size=PAGE, buckets=(8, 16), **{field: value})
    try:
        want = jserve.ServeConfig(**kw)
    except Exception as exc:  # the JAX package's MXNetError
        with pytest.raises(MXNetError, match="window"):
            tserve.ServeConfig(**kw)
        assert "window" in str(exc)
        return
    got = tserve.ServeConfig(**kw)
    assert got.kinds_for(4) == want.kinds_for(4)
    assert got.ring_pages == want.ring_pages


def test_params_from_numpy(np_params):
    extra = dict(np_params, data=np.zeros(3), softmax_label=np.zeros(3))
    params = tmodel.params_from_numpy(extra, "cpu")
    assert sorted(params) == sorted(np_params)
    assert all(v.dtype == torch.float32 for v in params.values())
    rec = tmodel.params_from_numpy(
        {"lm_head_weight": {"q": np.array([[3, -7]], np.int8),
                            "s": np.array([[0.5]], np.float64)}},
        "cpu")["lm_head_weight"]
    assert rec["q"].dtype == torch.int8 and rec["q"].tolist() == [[3, -7]]
    assert rec["s"].dtype == torch.float32 and rec["s"].tolist() == [[0.5]]
