"""The port's speculative decoding against the JAX package, at
test_serve.py's sizes (vocab 61, 2 layers, d_model 32, 2 heads, page 8).

Twins of tests/test_spec_decode.py.  JAX ``init_params(seed=3)`` weights
go to the port through ``params_from_numpy``; the port runs on the CPU,
where its wrappers take the plain versions of the kernels and the
session's entry points run eagerly over their fixed input buffers.
Inside the port one ``K + 1``-row verify equals ``K + 1`` serial decode
steps bit for bit, so speculation never changes a stream.  Across the
packages, logits agree within atol 1e-5 (fp32, other reduction orders)
and greedy tokens agree exactly on traces whose every emitted token
leads the runner-up by more than 10x that tolerance.
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
SPEC_K = 3
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


def _session(np_params, **kw):
    return tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                   config=tserve.ServeConfig(**_sconf(**kw)),
                                   device="cpu")


@pytest.fixture(scope="module")
def plain_session(np_params):
    return _session(np_params)


@pytest.fixture(scope="module")
def spec_session(np_params):
    """Identity draft (layers:<full depth>): its proposals are the
    target's own tokens, so every window is accepted in full."""
    return _session(np_params, spec_k=SPEC_K,
                    draft="layers:%d" % CFG.num_layers)


def _trace(n, seed=14, max_new=8, eos=-1, lens=None, api=tserve):
    rs = np.random.RandomState(seed)
    lens = lens or [4 + i for i in range(n)]
    return [api.Request(rid=i, prompt=rs.randint(
                1, CFG.vocab_size, size=lens[i]).tolist(),
                max_new=max_new, arrival_s=0.0, eos_id=eos)
            for i in range(n)]


def _run(sess, reqs, api=tserve):
    done, _ = api.Scheduler(sess, policy="continuous").run(reqs)
    return {r.rid: list(r.tokens) for r in done}


def _gap(row):
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


# ---------------------------------------------------------------------------
# the table pad and the speculative config
# ---------------------------------------------------------------------------

def test_table_pad_columns_are_trash():
    kw = dict(num_layers=1, num_heads=2, head_dim=4, page_size=8,
              num_pages=4, slots=2, max_pages_per_slot=2, table_pad=1)
    cache = PagedKVCache(device="cpu", **kw)
    jcache = JaxPagedKVCache(**kw)
    assert cache.table_width == jcache.table_width == 3
    slot = cache.alloc(9, 7)  # needs exactly max_pages_per_slot
    jcache.alloc(9, 7)
    # the pad column stays trash even for a fully reserved slot
    assert cache._tables[slot, 2] == cache.trash_page
    assert cache._tables[slot, 0] != cache.trash_page
    assert cache._tables.tolist() == jcache._tables.tolist()
    assert tuple(cache.device_tables().shape) == (2, 3)
    assert tuple(cache.table_row(slot).shape) == (3,)
    with pytest.raises(MXNetError, match="table_pad"):
        PagedKVCache(device="cpu", **dict(kw, table_pad=-1))


@pytest.mark.parametrize("page", [1, 4, 8, 16])
def test_spec_pad_pages_matches_jax(page):
    for k in range(0, 20):
        kw = dict(page_size=page, buckets=(4 * page,), spec_k=k)
        ours, theirs = tserve.ServeConfig(**kw), jserve.ServeConfig(**kw)
        assert ours.spec_pad_pages == theirs.spec_pad_pages, (page, k)
        assert ours.spec_window == theirs.spec_window == k + 1


# ---------------------------------------------------------------------------
# verify_step and draft_propose: inside the port and across the packages
# ---------------------------------------------------------------------------

VCFG = jserve.ModelConfig(vocab_size=37, num_layers=2, d_model=16,
                          num_heads=2, max_len=32)
VPAGE, VPAGES, W = 4, 8, SPEC_K + 1
TABLES = [[0, 1, 2, VPAGES], [3, 4, 5, VPAGES]]
HIST = np.asarray([5, 3], np.int32)


@pytest.fixture(scope="module")
def verify_rig():
    """Weights, and pools holding unequal histories (slot 0: 5 rows, slot
    1: 3 rows) written by the port's serial decode steps."""
    cfg = tmodel.ModelConfig(**VCFG.__dict__)
    params = tmodel.init_params(cfg, seed=7, device="cpu")
    np_p = {k: v.numpy() for k, v in params.items()}
    shape = (cfg.num_layers, VPAGES + 1, VPAGE, cfg.num_heads, cfg.head_dim)
    k_pool, v_pool = torch.zeros(shape), torch.zeros(shape)
    tables = torch.tensor(TABLES, dtype=torch.int32)
    rs = np.random.RandomState(11)
    for j in range(int(HIST.max())):
        toks = torch.from_numpy(rs.randint(1, cfg.vocab_size, 2))
        lens = torch.from_numpy(np.minimum(j, HIST).astype(np.int32))
        tmodel.decode_step(params, toks, lens, tables, k_pool, v_pool, cfg,
                           VPAGE, exact=True)
    window = rs.randint(1, cfg.vocab_size, (2, W))
    return np_p, params, cfg, k_pool, v_pool, tables, window


def test_verify_bitexact_vs_serial_decode(verify_rig):
    """Logits and the written pools of one W-row verify equal W serial
    decode steps fed the same tokens, bit for bit."""
    _, params, cfg, k_pool, v_pool, tables, window = verify_rig
    sk, sv = k_pool.clone(), v_pool.clone()
    serial = []
    for j in range(W):
        _, logits = tmodel.decode_step(
            params, torch.from_numpy(window[:, j]),
            torch.from_numpy(HIST + j), tables, sk, sv, cfg, VPAGE,
            exact=True)
        serial.append(logits)
    serial = torch.stack(serial, dim=1)
    bk, bv = k_pool.clone(), v_pool.clone()
    greedy, logits = tmodel.verify_step(
        params, torch.from_numpy(window), torch.from_numpy(HIST), tables,
        bk, bv, cfg, VPAGE, exact=True)
    assert torch.equal(logits, serial)
    assert torch.equal(greedy, serial.argmax(-1).to(torch.int32))
    assert torch.equal(bk, sk) and torch.equal(bv, sv)


def _jax_args(rig):
    import jax.numpy as jnp

    np_p, _, _, k_pool, v_pool, _, _ = rig
    return ({k: jnp.asarray(v) for k, v in np_p.items()},
            jnp.asarray(TABLES, jnp.int32), jnp.asarray(k_pool.numpy()),
            jnp.asarray(v_pool.numpy()))


def test_verify_logits_match_jax(verify_rig):
    import jax
    import jax.numpy as jnp

    _, params, cfg, k_pool, v_pool, tables, window = verify_rig
    jp, jt, jk, jv = _jax_args(verify_rig)
    verify = jax.jit(lambda *a: jmodel.verify_step(*a, VCFG, VPAGE,
                                                   exact=True))
    _, want, wk, wv = verify(jp, jnp.asarray(window, jnp.int32),
                             jnp.asarray(HIST), jt, jk, jv)
    bk, bv = k_pool.clone(), v_pool.clone()
    _, got = tmodel.verify_step(params, torch.from_numpy(window),
                                torch.from_numpy(HIST), tables, bk, bv, cfg,
                                VPAGE, exact=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(bk.numpy(), np.asarray(wk), rtol=0, atol=ATOL)
    np.testing.assert_allclose(bv.numpy(), np.asarray(wv), rtol=0, atol=ATOL)


def test_draft_propose_tokens_match_jax(verify_rig, monkeypatch):
    """Slot 0 proposes (n_feed 1), slot 1 ingests (n_feed W): the tokens
    equal JAX's, on a trace whose every step's top-2 logit gap exceeds
    10x ATOL (recorded from the port's decode steps inside the scan)."""
    import jax
    import jax.numpy as jnp

    _, params, cfg, k_pool, v_pool, tables, window = verify_rig
    gaps = []
    decode = tmodel.decode_step

    def recording(*args, **kw):
        toks, logits = decode(*args, **kw)
        gaps.extend(_gap(row) for row in logits.numpy())
        return toks, logits

    monkeypatch.setattr(tmodel, "decode_step", recording)
    n_feed = np.asarray([1, W], np.int32)
    got = tmodel.draft_propose(params, torch.from_numpy(window),
                               torch.from_numpy(n_feed),
                               torch.from_numpy(HIST), tables,
                               k_pool.clone(), v_pool.clone(), cfg, VPAGE,
                               exact=True)
    jp, jt, jk, jv = _jax_args(verify_rig)
    propose = jax.jit(lambda *a: jmodel.draft_propose(*a, VCFG, VPAGE,
                                                      exact=True)[0])
    want = propose(jp, jnp.asarray(window, jnp.int32), jnp.asarray(n_feed),
                   jnp.asarray(HIST), jt, jk, jv)
    assert got.tolist() == np.asarray(want).tolist()
    assert len(gaps) == 2 * W and min(gaps) > 10 * ATOL


# ---------------------------------------------------------------------------
# acceptance: all, none, EOS inside the window, max_new
# ---------------------------------------------------------------------------

def test_accept_all_with_identity_draft(plain_session, spec_session):
    ref = _run(plain_session, _trace(4, seed=21))
    before = spec_session.spec_report()
    got = _run(spec_session, _trace(4, seed=21))
    after = spec_session.spec_report()
    assert got == ref
    d = {k: after[k] - before[k] for k in ("slot_steps", "proposed",
                                           "accepted", "committed")}
    assert d["accepted"] == d["proposed"] > 0
    assert d["committed"] / float(d["slot_steps"]) > 2.0
    assert d["committed"] == sum(len(v) - 1 for v in ref.values())


def test_accept_zero_never_matching_draft(np_params, plain_session,
                                          monkeypatch):
    ref = _run(plain_session, _trace(3, seed=22))
    bad = max(set(range(CFG.vocab_size))
              - set(t for v in ref.values() for t in v))
    sess = _session(np_params, spec_k=SPEC_K, draft="ngram")
    monkeypatch.setattr(sess, "_ngram_propose",
                        lambda slot, k, max_n=3: [bad] * k)
    got = _run(sess, _trace(3, seed=22))
    rep = sess.spec_report()
    assert got == ref
    assert rep["acceptance_rate"] == 0.0
    assert rep["tokens_per_verify_step"] == 1.0
    assert rep["committed"] == sum(len(v) - 1 for v in ref.values())


def test_eos_inside_speculated_window(plain_session, spec_session):
    base = _run(plain_session, _trace(1, seed=23))[0]
    eos = base[2]  # third emitted token: inside the first K+1 window
    ref = _run(plain_session, _trace(1, seed=23, eos=eos))
    got = _run(spec_session, _trace(1, seed=23, eos=eos))
    assert got == ref
    assert got[0][-1] == eos and len(got[0]) == 3
    assert spec_session.cache.free_slots == spec_session.config.slots


def test_max_new_respected_with_full_windows(spec_session):
    """max_new 6 is not a multiple of the window: the last window commits
    the remainder only, and both caches drain back to all-free."""
    got = _run(spec_session, _trace(3, seed=24, max_new=6))
    assert all(len(v) == 6 for v in got.values())
    assert spec_session.cache.free_pages == spec_session.cache.num_pages
    assert (spec_session.draft_cache.free_pages
            == spec_session.draft_cache.num_pages)


# ---------------------------------------------------------------------------
# session plumbing: executables, drafts, env, n-gram lookup
# ---------------------------------------------------------------------------

def test_executable_names_frozen(np_params, spec_session):
    names = ["decode", "draft", "prefill_16", "prefill_8", "verify"]
    assert sorted(spec_session.executables) == names
    assert len(names) == len(spec_session.config.buckets) + 3
    _run(spec_session, _trace(5, seed=25))
    assert sorted(spec_session.executables) == names
    ngram = _session(np_params, spec_k=SPEC_K, draft="ngram")
    assert sorted(ngram.executables) == ["decode", "prefill_16",
                                         "prefill_8", "verify"]
    # nothing is captured on the CPU: the names run the eager functions
    assert all(e.graph is None for e in ngram.executables.values())
    assert ngram.graph_report()["capture_s"] is None


def test_ngram_proposals_match_jax(np_params):
    sess = _session(np_params, spec_k=SPEC_K, draft="ngram")
    rs = np.random.RandomState(9)
    hists = [[5], [1, 2, 3, 1, 2], [7, 7, 7, 7], [1, 2, 3, 4, 5, 6],
             [4, 9, 4, 9, 4]] + [rs.randint(1, 6, size=n).tolist()
                                for n in (3, 8, 17, 30)]

    class JaxLike(object):
        _slot_history = {}

    for hist in hists:
        for k in (1, 3, 5):
            sess._slot_history[0] = list(hist)
            JaxLike._slot_history[0] = list(hist)
            assert sess._ngram_propose(0, k) == \
                jserve.InferenceSession._ngram_propose(JaxLike, 0, k), hist
    sess._slot_history.clear()


def test_draft_resolution_errors(np_params):
    with pytest.raises(MXNetError, match="spec_k == 0"):
        tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                config=tserve.ServeConfig(**_sconf()),
                                device="cpu", draft_params=dict(np_params))
    with pytest.raises(MXNetError, match="out of range"):
        _session(np_params, spec_k=2, draft="layers:9")
    with pytest.raises(MXNetError, match="integer"):
        _session(np_params, spec_k=2, draft="layers:two")
    with pytest.raises(MXNetError, match="no checkpoint found"):
        _session(np_params, spec_k=2, draft="/checkpoints/draft")
    small = {k: v for k, v in np_params.items()}
    small["tok_embed_weight"] = np_params["tok_embed_weight"][:40]
    with pytest.raises(MXNetError, match="draft vocab 40 != target vocab"):
        tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                config=tserve.ServeConfig(**_sconf(spec_k=2)),
                                device="cpu", draft_params=small)
    short = dict(np_params, pos_embed=np_params["pos_embed"][:, :16])
    with pytest.raises(MXNetError, match="draft max_len 16"):
        tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                config=tserve.ServeConfig(**_sconf(spec_k=2)),
                                device="cpu", draft_params=short)
    with pytest.raises(MXNetError, match="spec_k == 0"):
        _session(np_params).spec_step()


def test_spec_env_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_SPEC_K", "5")
    monkeypatch.setenv("MXNET_SERVE_DRAFT", "layers:1")
    cfg = tserve.ServeConfig.from_env(slots=2)
    assert cfg.spec_k == 5 and cfg.draft == "layers:1"
    assert cfg.spec_window == 6
    with pytest.raises(MXNetError, match="spec_k"):
        tserve.ServeConfig(spec_k=-1)


@pytest.mark.chaos
def test_chaos_verify_fault_isolates_request(spec_session, monkeypatch):
    """A raise at one request's verify boundary fails that request only;
    the others complete, and both caches drain back to all-free."""
    monkeypatch.setenv("MXNET_FAULT_INJECT", "serve_verify:raise:after=2")
    faults.reset()
    done, _ = tserve.Scheduler(spec_session, policy="continuous").run(
        _trace(3, seed=27, max_new=6))
    failed = [r for r in done if r.failed]
    ok = [r for r in done if not r.failed]
    assert [r.rid for r in failed] == [1]
    assert "FaultInjected" in failed[0].error
    assert len(ok) == 2 and all(len(r.tokens) == 6 for r in ok)
    assert spec_session.cache.free_slots == spec_session.config.slots
    assert spec_session.cache.free_pages == spec_session.cache.num_pages
    assert (spec_session.draft_cache.free_pages
            == spec_session.draft_cache.num_pages)


# ---------------------------------------------------------------------------
# whole streams across the packages
# ---------------------------------------------------------------------------

LENS = [5, 9, 14, 3, 11]


@pytest.fixture(scope="module")
def plain_streams(np_params):
    """The port's non-speculative streams of the trace, with the top-2
    logit gap of every emitted token."""
    sess = _session(np_params, max_new=6)
    gaps = []
    prefill_fn, step_fn = sess.prefill, sess.step

    def prefill(slot, prompt):
        first, logits = prefill_fn(slot, prompt)
        gaps.append(_gap(logits))
        return first, logits

    def step():
        toks, logits = step_fn()
        gaps.extend(_gap(logits[s]) for s in toks)
        return toks, logits

    sess.prefill, sess.step = prefill, step
    return _run(sess, _trace(5, 31, 6, lens=LENS)), gaps


@pytest.mark.parametrize("draft", ["ngram", "layers:1"])
def test_spec_streams_match_jax_session(np_params, plain_streams, draft):
    """One continuous-batching trace through both packages' speculative
    sessions: the port's streams equal its non-speculative ones, and the
    JAX package's, token for token."""
    ref, gaps = plain_streams
    assert len(gaps) == 5 * 6 and min(gaps) > 10 * ATOL
    sconf = _sconf(max_new=6, spec_k=SPEC_K, draft=draft)
    jsess = jserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                    config=jserve.ServeConfig(**sconf))
    tsess = _session(np_params, **sconf)
    want = _run(jsess, _trace(5, 31, 6, lens=LENS, api=jserve), api=jserve)
    got = _run(tsess, _trace(5, 31, 6, lens=LENS))
    assert got == ref
    assert got == want
    # the draft's own proposals carry no margin guarantee, so how many
    # each package's draft got accepted may differ by a near-tie; what
    # was committed may not
    ours, theirs = tsess.spec_report(), jsess.spec_report()
    assert ours["committed"] == theirs["committed"] == 5 * (6 - 1)
    assert 0 <= ours["accepted"] <= ours["proposed"]
