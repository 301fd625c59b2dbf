#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line of output each; any failure raises and the script
exits non-zero (it also refuses to run without a CUDA device, or outside
a checkout that holds ``mxnet_tpu_torch/``):

1. card — the card's name and power limit from ``nvidia-smi``, then the
   build of every kernel from ``mxnet_tpu_torch/csrc`` (build seconds).
2. kernels — each hand-written kernel against its plain PyTorch version
   at the serving path's shapes, with a stated tolerance: max error,
   ``kernel_ms``, ``plain_ms``, ``library_ms`` (one PyTorch call that
   computes the same function, timed as a yardstick and used nowhere in
   the port) and ``bound_ms`` (the larger of bytes over 3.35 TB/s and
   operations over the fp32 peak of 67 TFLOP/s, from the H100 SXM data
   sheet).  Timings are CUDA-event means over launches on a cold L2.
3. invariance — rows of the exact projection (K3) and of LayerNorm at
   M = 256 are bit-identical to the same rows computed alone.
4. serve — the transformer LM at the width of ``bench_transformer.py``'s
   default model (8 layers, d_model 2048, 16 heads, vocab 32768, max_len
   1024; random weights from seed 0) serves 16 requests through the
   continuous-batching scheduler.  Every request's first-token logits,
   and every token's logits of two whole streams, must equal the port's
   ``reference_last_logits`` bit for bit.  Launch counts are reset just
   before this phase and read just after; every kernel must have run.
5. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
ATTN_ATOL = 1e-5
ATTN_NOTE = ("atol 1e-5: fp32 on both sides; the D = 128 score dots and "
             "the per-block sums run in other orders, ~100 units of "
             "roundoff at these magnitudes")
LINEAR_SLACK = 2.0
LINEAR_NOTE = ("|diff| <= 2 C 2^-24 (|x| |w|^T + |b|): the worst-case "
               "fp32 error of two summation orders over C terms")


def log(phase, **fields):
    print("%s %s" % (phase, json.dumps(fields, sort_keys=True)), flush=True)


def serve_phase(dev, cfg, sconf, n_requests, prompt_lens, whole_streams=2,
                arrival_gap_s=0.05):
    """Serve ``n_requests`` greedy requests of numpy-seeded prompts through
    the continuous-batching scheduler on a session over ``init_params(cfg,
    seed=0)``, then hold every request's first-token logits, and every
    token's logits of ``whole_streams`` streams, against
    ``reference_last_logits`` bit for bit.  Returns the phase's numbers."""
    import torch

    from mxnet_tpu_torch import serve

    sess = serve.InferenceSession(serve.init_params(cfg, seed=0, device=dev),
                                  num_heads=cfg.num_heads, config=sconf,
                                  device=dev)
    rs = np.random.RandomState(0)
    reqs = [serve.Request(rid=i, prompt=rs.randint(
                1, cfg.vocab_size,
                size=int(rs.randint(prompt_lens[0], prompt_lens[1] + 1))
            ).tolist(), max_new=sconf.max_new, arrival_s=arrival_gap_s * i)
            for i in range(n_requests)]

    # record what a client sees: per stream, each transcript beside the
    # logits that chose its next token
    streams, slot_stream, step_ms = [], {}, []
    prefill_fn, step_fn = sess.prefill, sess.step

    def prefill(slot, prompt):
        first, logits = prefill_fn(slot, prompt)
        slot_stream[slot] = {"seq": list(prompt) + [first],
                             "checks": [(list(prompt), logits)]}
        streams.append(slot_stream[slot])
        return first, logits

    def step():
        t0 = time.perf_counter()
        toks, logits = step_fn()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for slot, tok in toks.items():
            st = slot_stream[slot]
            st["checks"].append((list(st["seq"]), logits[slot].copy()))
            st["seq"].append(tok)
        return toks, logits

    sess.prefill, sess.step = prefill, step
    done, makespan = serve.Scheduler(sess, policy="continuous").run(reqs)
    summary = serve.summarize(done, makespan)
    failed = [r.rid for r in done if r.failed]
    if failed or summary["completed"] != n_requests:
        raise AssertionError("requests failed: %r" % failed)
    if any(len(r.tokens) != sconf.max_new for r in done):
        raise AssertionError("a request stopped short of max_new")
    checked = 0
    for sid, st in enumerate(streams):
        for seq, logits in st["checks"][:None if sid < whole_streams else 1]:
            if not np.isfinite(logits).all():
                raise AssertionError("non-finite logits in stream %d" % sid)
            ref = serve.reference_last_logits(
                sess.params, seq, sess.model, sconf.page_size,
                exact=sconf.exact).cpu().numpy()
            if not np.array_equal(logits, ref):
                raise AssertionError(
                    "stream %d at length %d: logits differ from the "
                    "reference by %.3g" % (sid, len(seq),
                                           np.abs(logits - ref).max()))
            checked += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    sess.prefill, sess.step = prefill_fn, step_fn
    return sess, dict(requests=n_requests, completed=summary["completed"],
                tokens=summary["total_tokens"],
                tokens_per_s=summary["tokens_per_sec"],
                ttft_p50_ms=summary["ttft_p50_s"] * 1e3,
                ttft_p99_ms=summary["ttft_p99_s"] * 1e3,
                decode_step_ms_mean=float(np.mean(step_ms)),
                decode_steps=len(step_ms), makespan_s=makespan,
                bitexact_logits_checked=checked)


def profile_phase(sess, steps=4):
    """Device time by kernel over ``steps`` decode steps of a full batch
    (every slot at a 250-token prompt) and over one 256-row prefill, with
    the device's busy share of each window (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    groups = (("mi_linear", "linear_kernel"),
              ("paged_attention", "paged_attention_kernel"),
              ("flash_attention", "flash_forward_kernel"))
    rs = np.random.RandomState(1)
    prompts = [rs.randint(1, sess.model.vocab_size, size=250).tolist()
               for _ in range(sess.config.slots + 1)]
    slots = [sess.try_alloc(250, sess.config.max_new)
             for _ in range(sess.config.slots)]
    for slot, prompt in zip(slots, prompts):
        sess.prefill(slot, prompt)
    sess.step()  # warm

    def window(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
        for ev in prof.key_averages():
            us = ev.self_device_time_total
            if us <= 0:
                continue
            name = next((g for g, key in groups if key in ev.key), "other")
            by[name] += us / 1e3
        busy = sum(by.values())
        return dict(wall_ms=wall_ms, device_busy_ms=busy,
                    idle_share=max(0.0, 1.0 - busy / wall_ms),
                    device_ms_by_kernel=by)

    def decode():
        for _ in range(steps):
            sess.step()

    out = {"decode_steps": steps, "decode": window(decode)}
    sess.release(slots[-1])
    slot = sess.try_alloc(250, sess.config.max_new)
    out["prefill_256"] = window(lambda: sess.prefill(slot, prompts[-1]))
    for slot in sess.active_slots():
        sess.release(slot)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device — this script runs only on the "
                 "card")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch", "csrc")):
        sys.exit("chip_smoke: mxnet_tpu_torch/ is not beside this script")
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mxnet_tpu_torch import _cuda

    dev = torch.device("cuda")
    # -- 1. card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build_dir = _cuda.build()
    log("card", kind=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=_cuda.build_seconds, build_dir=os.path.relpath(build_dir,
                                                                here))

    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    errs = dict.fromkeys(_cuda.KERNELS, 0.0)

    def time_ms(fn, target_ms=300.0):
        """Mean CUDA-event time of ``fn`` per call, L2 flushed before
        every call (outside the timed window)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        once = (time.perf_counter() - t0) * 1e3
        reps = int(min(max(target_ms / max(once, 1e-3), 3), 50))
        pairs = []
        for _ in range(reps):
            flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    def record(name, case, err, ok, tolerance, kernel, plain, library,
               nbytes, flops):
        if not ok:
            raise AssertionError("%s %s: max error %.3g outside the "
                                 "tolerance (%s)" % (name, case, err,
                                                     tolerance))
        errs[name] = max(errs[name], float(err))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        row = dict(kernel=name, case=case, max_abs_err=float(err),
                   tolerance=tolerance, kernel_ms=time_ms(kernel),
                   plain_ms=time_ms(plain),
                   library_ms=time_ms(library) if library else None,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        log("kernel", **row)
        rows[(name, case)] = row

    # -- 2. kernels against their plain versions ----------------------------
    from mxnet_tpu_torch.ops import attention as A
    from mxnet_tpu_torch.ops import linear as L

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # K1: causal flash forward; the serving oracle's block is the page
    for n, h, t, d, causal, block in ((1, 16, 256, 128, True, 16),
                                      (1, 16, 1024, 128, True, 16),
                                      (1, 2, 37, 16, True, 16),
                                      (1, 2, 37, 16, False, 16)):
        q, k, v = randn(n, h, t, d), randn(n, h, t, d), randn(n, h, t, d)
        scale = 1.0 / d ** 0.5
        got = A.flash_attention(q, k, v, causal=causal, scale=scale,
                                block=block)
        want = A.flash_attention_plain(q, k, v, causal, scale, block,
                                       mi=True)
        pairs = n * h * (t * (t + 1) // 2 if causal else t * t)
        err = (got - want).abs().max().item()
        record("flash_attention", "n%d-h%d-T%d-D%d-%s-b%d"
               % (n, h, t, d, "causal" if causal else "full", block),
               err, err <= ATTN_ATOL, ATTN_NOTE,
               lambda: A.flash_attention(q, k, v, causal=causal, scale=scale,
                                         block=block),
               lambda: A.flash_attention_plain(q, k, v, causal, scale,
                                               block, mi=True),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, scale=scale),
               nbytes=4 * 4 * n * h * t * d, flops=4 * d * pairs)

    # K2: decode (8 slots, one query each; slot 7 idle) and prefill (one
    # slot, a 256-row bucket at offset 32 with per-row horizons)
    page, max_pages, h, d = 16, 18, 16, 128
    n_pages = 8 * max_pages
    k_pool = randn(n_pages + 1, page, h, d)
    v_pool = randn(n_pages + 1, page, h, d)
    rs = np.random.RandomState(5)
    tables = torch.from_numpy(rs.permutation(n_pages).reshape(
        8, max_pages).astype(np.int32)).to(dev)
    lens = rs.randint(24, max_pages * page + 1, size=8)
    lens[7] = 0
    cases = [("decode-S8-Q1", randn(8, h, 1, d), tables,
              torch.from_numpy(lens.astype(np.int32)).to(dev))]
    horizons = (32 + np.arange(256) + 1).astype(np.int32).reshape(1, 256)
    cases.append(("prefill-S1-Q256-offset32", randn(1, h, 256, d),
                  tables[:1].contiguous(), torch.from_numpy(horizons).to(dev)))
    for case, q, tab, hor in cases:
        got = A.paged_attention(q, k_pool, v_pool, tab, hor)
        want = A.paged_attention_plain(q, k_pool, v_pool, tab, hor)
        if case.startswith("decode") and got[7].abs().max().item() != 0.0:
            raise AssertionError("paged_attention: idle slot is not 0")
        hn = hor.cpu().numpy()
        per_slot = hn.max(axis=-1) if hn.ndim == 2 else hn
        nbytes = 4 * (2 * q.numel() + tab.numel() + hor.numel()
                      + 2 * int(per_slot.sum()) * h * d)
        err = (got - want).abs().max().item()
        record("paged_attention", case, err, err <= ATTN_ATOL, ATTN_NOTE,
               lambda: A.paged_attention(q, k_pool, v_pool, tab, hor),
               lambda: A.paged_attention_plain(q, k_pool, v_pool, tab, hor),
               None, nbytes=nbytes, flops=4 * d * h * int(hn.sum()))

    # K3: every projection shape of the path at decode and prefill rows.
    # Tolerance: both sides sum C products in fp32 in different orders,
    # so each output may differ by at most 2 * C * 2^-24 * sum|x||w|.
    for m in (1, 8, 256):
        for f, c in ((6144, 2048), (2048, 2048), (8192, 2048),
                     (2048, 8192), (32768, 2048)):
            x, w, b = randn(m, c), 0.02 * randn(f, c), 0.02 * randn(f)
            got = L.mi_linear(x, w, b)
            want = L.mi_linear_plain(x, w, b)
            bound = (LINEAR_SLACK * c * 2.0 ** -24
                     * (x.abs() @ w.abs().t() + b.abs()))
            diff = (got - want).abs()
            record("mi_linear", "M%d-F%d-C%d" % (m, f, c),
                   diff.max().item(), bool((diff <= bound).all()),
                   LINEAR_NOTE,
                   lambda: L.mi_linear(x, w, b),
                   lambda: L.mi_linear_plain(x, w, b),
                   lambda: torch.nn.functional.linear(x, w, b),
                   nbytes=4 * (m * c + f * c + f + m * f),
                   flops=2 * m * f * c)

    # -- 3. row-count invariance ------------------------------------------
    x = randn(256, 2048)
    for f in (6144, 8192, 32768):
        w, b = 0.02 * randn(f, 2048), 0.02 * randn(f)
        full = L.mi_linear(x, w, b)
        for r in range(0, 256, 5):
            if not torch.equal(L.mi_linear(x[r:r + 1], w, b), full[r:r + 1]):
                raise AssertionError("mi_linear row %d differs at M=1 vs "
                                     "M=256 (F=%d)" % (r, f))
    gamma, beta = 1 + 0.1 * randn(2048), 0.1 * randn(2048)
    from mxnet_tpu_torch.serve.model import _layer_norm

    full = _layer_norm(x, gamma, beta)
    for r in range(256):
        if not torch.equal(_layer_norm(x[r:r + 1], gamma, beta),
                           full[r:r + 1]):
            raise AssertionError("LayerNorm row %d differs at M=1 vs M=256"
                                 % r)
    log("invariance", mi_linear_rows_checked=3 * len(range(0, 256, 5)),
        layer_norm_rows_checked=256, bit_identical=True)

    # -- 4. serve at full width -------------------------------------------
    from mxnet_tpu_torch import serve

    cfg = serve.ModelConfig(vocab_size=32768, num_layers=8, d_model=2048,
                            num_heads=16, max_len=1024)
    sconf = serve.ServeConfig(slots=8, page_size=16, buckets=(64, 128, 256),
                              max_new=32, exact=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    sess, stats = serve_phase(dev, cfg, sconf, n_requests=16,
                              prompt_lens=(24, 250))
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    if min(launches.values()) < 1:
        raise AssertionError("a kernel never ran on the main path: %r"
                             % launches)
    log("serve", model="8L-d2048-h16-V32768",
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2.0 ** 30,
        launches=launches, **stats)
    log("profile", **profile_phase(sess))

    # -- 5. summary -------------------------------------------------------
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")]
    if bad:
        raise AssertionError("JAX or the JAX package was imported: %r"
                             % bad[:5])
    main_case = {"flash_attention": "n1-h16-T256-D128-causal-b16",
                 "paged_attention": "decode-S8-Q1",
                 "mi_linear": "M8-F6144-C2048"}
    replaces = {
        "flash_attention": "mxnet_tpu/ops/attention.py:497",
        "paged_attention": "mxnet_tpu/ops/attention.py:368",
        "mi_linear": "mxnet_tpu/serve/model.py:123",
    }
    kernels = []
    for name, (stem, _, _) in _cuda.KERNELS.items():
        row = rows[(name, main_case[name])]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/%s.cu" % stem,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": main_case[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
