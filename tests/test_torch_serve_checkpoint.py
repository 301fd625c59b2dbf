"""Serving from checkpoints, the session's introspection, and the
serving half of autotune, against the JAX package at test_serve.py's
sizes (vocab 61, 2 layers, d_model 32, 2 heads, page 8).

The twin of tests/test_serve.py::test_from_checkpoint_roundtrip: a
checkpoint the JAX package writes is served by the port, whose logits
are within 1e-5 of the JAX session's on the same checkpoint (fp32,
different reduction orders) and bit for bit the port's own
``reference_last_logits``.  ``state_report``, ``reset_cold``,
``memory_analysis`` and ``fallback_count`` carry the JAX session's
keys; autotune records key and apply as the JAX package's do.
"""
import json

import numpy as np
import pytest
import torch

from mxnet_tpu import autotune as jtune
from mxnet_tpu import checkpoint as jck
from mxnet_tpu import serve as jserve
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu_torch import autotune as ttune
from mxnet_tpu_torch import checkpoint as tck
from mxnet_tpu_torch import quantize as tquant
from mxnet_tpu_torch import serve as tserve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import model as tmodel

CFG = tserve.ModelConfig(vocab_size=61, num_layers=2, d_model=32,
                         num_heads=2, max_len=64)
PAGE = 8
ATOL = 1e-5
SCONF = dict(slots=2, page_size=PAGE, buckets=(8,), max_new=4, exact=True)


@pytest.fixture(scope="module")
def np_params():
    return {k: v.numpy() for k, v in
            tmodel.init_params(CFG, seed=3, device="cpu").items()}


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory, np_params):
    """A v2 checkpoint the JAX package writes, with the transformer
    symbol (its MultiHeadAttention node records num_heads)."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    sym = jtransformer.get_symbol(vocab_size=CFG.vocab_size,
                                  num_layers=CFG.num_layers,
                                  d_model=CFG.d_model,
                                  num_heads=CFG.num_heads,
                                  seq_len=CFG.max_len)
    jck.CheckpointManager(d, prefix="lm", save_optimizer_states=False) \
        .save(epoch=1, symbol=sym, arg_params=np_params)
    return d


@pytest.fixture(scope="module")
def jax_session(jax_dir):
    return jserve.InferenceSession.from_checkpoint(
        jax_dir, prefix="lm", epoch=1, config=jserve.ServeConfig(**SCONF))


def _ref_row(sess, seq):
    return tmodel.reference_last_logits(sess.params, seq, sess.model, PAGE,
                                        exact=True).numpy()


# ---------------------------------------------------------------------------
# from_checkpoint
# ---------------------------------------------------------------------------

def test_from_checkpoint_serves_a_jax_checkpoint(jax_dir, jax_session):
    sess = tserve.InferenceSession.from_checkpoint(
        jax_dir, prefix="lm", epoch=1,
        config=tserve.ServeConfig(**SCONF), device="cpu")
    assert sess.model.num_heads == CFG.num_heads  # from the symbol
    assert all(t.device.type == "cpu" for t in sess.params.values())
    p = list(range(1, 8))
    slot = sess.try_alloc(len(p), 4)
    jslot = jax_session.try_alloc(len(p), 4)
    first, logits = sess.prefill(slot, p)
    jfirst, jlogits = jax_session.prefill(jslot, p)
    np.testing.assert_array_equal(logits, _ref_row(sess, p))
    np.testing.assert_allclose(logits, np.asarray(jlogits), rtol=0,
                               atol=ATOL)
    assert first == jfirst
    seq = list(p) + [first]
    for _ in range(3):
        toks, logits = sess.step()
        jtoks, jlogits = jax_session.step()
        np.testing.assert_array_equal(logits[slot], _ref_row(sess, seq))
        np.testing.assert_allclose(logits[slot],
                                   np.asarray(jlogits)[jslot], rtol=0,
                                   atol=ATOL)
        assert toks[slot] == jtoks[jslot]
        seq.append(toks[slot])
    sess.release(slot)
    jax_session.release(jslot)


def test_from_checkpoint_of_a_port_save_needs_num_heads(tmp_path,
                                                        np_params):
    d = str(tmp_path)
    tck.CheckpointManager(d, prefix="lm").save(
        epoch=2, arg_params={k: torch.from_numpy(v)
                             for k, v in np_params.items()})
    with pytest.raises(MXNetError, match="pass num_heads"):
        tserve.InferenceSession.from_checkpoint(d, prefix="lm",
                                                device="cpu")
    sess = tserve.InferenceSession.from_checkpoint(
        d, prefix="lm", num_heads=CFG.num_heads,
        config=tserve.ServeConfig(**SCONF), device="cpu")
    for k, v in np_params.items():
        assert torch.equal(sess.params[k], torch.from_numpy(v)), k


def test_checkpoint_directory_draft_equals_layers_draft(tmp_path,
                                                        np_params):
    """``ServeConfig.draft`` naming a checkpoint directory loads the
    draft through the checkpoint manager: a full-depth draft saved
    there proposes exactly what the ``layers:2`` identity draft does."""
    d = str(tmp_path)
    tck.CheckpointManager(d).save(epoch=1, arg_params={
        k: torch.from_numpy(v) for k, v in np_params.items()})
    streams = []
    for draft in (d, "layers:%d" % CFG.num_layers):
        sess = tserve.InferenceSession(
            np_params, num_heads=CFG.num_heads, device="cpu",
            config=tserve.ServeConfig(slots=2, page_size=PAGE,
                                      buckets=(8, 16), max_new=8,
                                      spec_k=2, draft=draft))
        assert sorted(sess.executables) == ["decode", "draft",
                                            "prefill_16", "prefill_8",
                                            "verify"]
        out, _ = tserve.Scheduler(sess).run(
            [tserve.Request(rid=i, prompt=[1 + i, 2, 3], max_new=8)
             for i in range(3)])
        streams.append({r.rid: r.tokens for r in out})
        assert sess.spec_report()["acceptance_rate"] == 1.0
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# state_report, reset_cold, memory_analysis, fallback_count
# ---------------------------------------------------------------------------

def test_state_report_matches_jax_and_round_trips(np_params, jax_session):
    sess = tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                   config=tserve.ServeConfig(**SCONF),
                                   device="cpu")
    base, jbase = sess.state_report(), jax_session.state_report()
    assert base == jbase  # same keys, same free lists, same pool bytes
    slot = sess.try_alloc(7, 4)
    sess.prefill(slot, list(range(1, 8)))
    sess.step()
    busy = sess.state_report()
    assert busy["active_slots"] == [slot] and busy != base
    sess.reset_cold()
    assert sess.state_report() == base


def test_state_report_carries_the_draft_cache(np_params):
    sess = tserve.InferenceSession(
        np_params, num_heads=CFG.num_heads, device="cpu",
        config=tserve.ServeConfig(slots=2, page_size=PAGE, buckets=(8,),
                                  max_new=4, spec_k=2, draft="layers:1"))
    base = sess.state_report()
    assert {"draft_free_slots", "draft_free_pages"} <= set(base)
    slot = sess.try_alloc(5, 4)
    sess.prefill(slot, [1, 2, 3, 4, 5])
    assert sess.state_report()["draft_free_slots"] == \
        base["draft_free_slots"] - 1
    sess.reset_cold()
    assert sess.state_report() == base


def test_memory_analysis_and_fallback_count(np_params, jax_session):
    sess = tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                   config=tserve.ServeConfig(**SCONF),
                                   device="cpu")
    jmem = jax_session.memory_analysis("decode")
    got = sess.memory_analysis("decode")
    assert set(got) <= set(jmem)
    assert "generated_code_size_in_bytes" not in got
    exe = sess.executables["decode"]
    assert got["argument_size_in_bytes"] == sum(
        t.numel() * t.element_size() for t in exe.inputs.values())
    assert got["temp_size_in_bytes"] == 0  # nothing captured on the CPU
    slot = sess.try_alloc(3, 4)
    sess.prefill(slot, [1, 2, 3])
    sess.step()
    after = sess.memory_analysis("decode")
    # the (slots,) int32 tokens and (slots, vocab) float32 logits of the
    # last call
    assert after["output_size_in_bytes"] == \
        SCONF["slots"] * 4 * (1 + CFG.vocab_size)
    assert set(sess.memory_analysis("prefill_8")) == set(got)
    with pytest.raises(MXNetError, match="the executable takes"):
        exe(tokens=np.zeros((SCONF["slots"] + 1,), np.int64))
    assert sess.fallback_count() == 0
    assert jax_session.fallback_count() == 0


# ---------------------------------------------------------------------------
# autotune, the serving half
# ---------------------------------------------------------------------------

def test_fingerprint_equals_jax(np_params):
    fp = jtune.fingerprint(np_params)
    assert ttune.fingerprint(np_params) == fp
    assert ttune.fingerprint({k: torch.from_numpy(v)
                              for k, v in np_params.items()}) == fp
    qrec = tquant.quantize_params(
        tmodel.params_from_numpy(np_params, "cpu"), "int8")
    assert ttune.fingerprint(qrec) == fp
    assert ttune.backend_name() == ("cpu" if not torch.cuda.is_available()
                                    else torch.cuda.get_device_name(0))


def test_search_records_match_jax_and_cache_hit(tmp_path):
    space = [ttune.Knob("buckets", [[8, 16], [8]]),
             ttune.Knob("quant", ["", "int8"])]
    jspace = [jtune.Knob(k.name, k.values) for k in space]
    rates = {("[8, 16]", ""): 100.0, ("[8]", ""): 120.0,
             ("[8]", "int8"): 121.0, ("[8, 16]", "int8"): 90.0}
    calls = []

    def measure(knobs):
        calls.append(dict(knobs))
        return {"metric": rates[(str(list(knobs["buckets"])),
                                 knobs["quant"])], "aux": {}}

    key = ttune.Key("serve", "abc123", backend="cpu")
    rec = ttune.search(measure, space, key,
                       store=ttune.AutotuneStore(str(tmp_path / "t")))
    jrec = jtune.search(measure, jspace,
                        jtune.Key("serve", "abc123", backend="cpu"),
                        store=jtune.AutotuneStore(str(tmp_path / "j")))
    assert sorted(rec) == sorted(jrec)
    for field in ("knobs", "metric", "baseline_metric", "measurements",
                  "knob_space", "speedup_vs_default", "cache_hit"):
        assert rec[field] == jrec[field], field
    assert rec["knobs"] == {"buckets": [8], "quant": ""}  # within 2 %
    n = len(calls)
    again = ttune.search(measure, space, key,
                         store=ttune.AutotuneStore(str(tmp_path / "t")))
    assert again["cache_hit"] and len(calls) == n
    # a record either package wrote is the other's cache hit
    hit = jtune.search(measure, jspace,
                       jtune.Key("serve", "abc123", backend="cpu"),
                       store=jtune.AutotuneStore(str(tmp_path / "t")))
    assert hit["cache_hit"] and len(calls) == n


def test_session_applies_a_cached_serve_record(tmp_path, monkeypatch,
                                               np_params):
    monkeypatch.setenv("MXNET_SERVE_SLOTS", "2")
    monkeypatch.setenv("MXNET_SERVE_PAGE", "8")
    monkeypatch.setenv("MXNET_SERVE_BUCKETS", "8,16")
    monkeypatch.setenv("MXNET_SERVE_MAX_NEW", "8")
    monkeypatch.setenv("MXNET_AUTOTUNE_DIR", str(tmp_path))
    # the JAX package writes the record; the port finds and applies it
    jtune.AutotuneStore().put(
        jtune.Key("serve", jtune.fingerprint(np_params),
                  backend=ttune.backend_name()),
        {"kind": "serve", "fingerprint": jtune.fingerprint(np_params),
         "mesh": "-", "backend": ttune.backend_name(),
         "knobs": {"buckets": [8], "kv_quant": "int8"}, "metric": 1.0})
    ttune.clear_applied()
    try:
        off = tserve.InferenceSession(np_params, num_heads=2, device="cpu")
        assert off.config.buckets == (8, 16)  # MXNET_AUTOTUNE unset
        monkeypatch.setenv("MXNET_AUTOTUNE", "1")
        sess = tserve.InferenceSession(np_params, num_heads=2,
                                       device="cpu")
        assert sess.config.buckets == (8,)
        assert sess.config.kv_quant == "int8"
        prov = ttune.provenance()
        assert len(prov) == 1 and prov[0]["where"] == "InferenceSession"
        assert prov[0]["applied"] == ["buckets", "kv_quant"]
        explicit = tserve.InferenceSession(
            np_params, num_heads=2, device="cpu",
            config=tserve.ServeConfig(**SCONF))
        assert explicit.config.buckets == (8,) and \
            explicit.config.kv_quant == ""
        assert len(ttune.provenance()) == 1
    finally:
        ttune.clear_applied()
    assert json.loads(json.dumps(prov))  # JSON-able, like the JAX log
