"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: atol 1e-5 between an fp32 attention kernel and its plain
version (unit-normal inputs, the reductions run in other orders), and
K4_ATOL for the fp32 backward up to T = 1024, stated from its fp64
comparison; for
the bf16 tensor-core kernels K7/K8, the derived bound of
``mxnet_tpu_torch/testing/attention_sm90.py``; for the
projection, the worst-case bound of two fp32 summation orders; and
bit-equality where the serving contract demands it (row-count
invariance, decode == reference, each of the serving session's CUDA
graphs against the eager function it captured, and the quantized
kernels: K3q against K3 on the dequantized weight, K2q against K1 over
the fake-quantized context, K9's codes and scales against the plain
quantizer's).  The rtc kernels (``rtc.CudaKernel``,
compiled at run time) are held to the stated tolerance of each test.
The serving front's streams (a checkpoint restored onto the card, two
replicas on one card, a gateway's dispatch thread replaying graphs
captured on another) must equal a single session's token for token.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import _cuda, serve
from mxnet_tpu_torch import quantize as Q
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as A
from mxnet_tpu_torch.ops import linear as L
from mxnet_tpu_torch.testing import attention_sm90 as sm90
from mxnet_tpu_torch.testing import fp8_accum
from mxnet_tpu_torch.testing import paged_order

pytestmark = pytest.mark.cuda

ATOL = 1e-5
# K4 (fp32) against the plain version up to T = 1024: at n1 h16 T1024
# D128 K4's gradients lay within 2.9e-6 of fp64 truth and the plain
# version's within 7.6e-6 (chip_smoke.py's k4_accuracy line, NVIDIA H100
# 80GB HBM3, 700 W), so the two within 1.1e-5 of each other
K4_ATOL = 2e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


@pytest.mark.parametrize("t,d,causal,block", [(37, 40, True, 8),
                                              (37, 40, False, 8),
                                              (64, 128, True, 16),
                                              (5, 16, True, 128)])
def test_flash_attention_kernel_matches_plain(dev, t, d, causal, block):
    q, k, v = (_randn(dev, 2, 3, t, d, seed=s) for s in range(3))
    before = _cuda.launches["flash_attention"]
    got = A.flash_attention(q, k, v, causal=causal, block=block)
    assert _cuda.launches["flash_attention"] == before + 1
    want = A.flash_attention_plain(q, k, v, causal, 1.0 / d ** 0.5, block,
                                   mi=True)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nq,per_row", [(1, False), (24, True)])
def test_paged_attention_kernel_matches_plain(dev, nq, per_row):
    page, max_pages, h, d, s = 8, 5, 4, 64, 3
    k_pool = _randn(dev, s * max_pages + 1, page, h, d, seed=1)
    v_pool = _randn(dev, s * max_pages + 1, page, h, d, seed=2)
    rs = np.random.RandomState(0)
    tables = torch.from_numpy(rs.permutation(s * max_pages).reshape(
        s, max_pages).astype(np.int32)).to(dev)
    if per_row:
        lengths = np.array([[8 + j for j in range(nq)],
                            [1 + j for j in range(nq)], [0] * nq], np.int32)
    else:
        lengths = np.array([17, 0, max_pages * page], np.int32)
    lengths = torch.from_numpy(lengths).to(dev)
    q = _randn(dev, s, h, nq, d, seed=3)
    got = A.paged_attention(q, k_pool, v_pool, tables, lengths)
    want = A.paged_attention_plain(q, k_pool, v_pool, tables, lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    idle = 2 if per_row else 1
    assert torch.count_nonzero(got[idle]) == 0


def test_paged_row_equals_flash_row_bitwise(dev):
    page, h, d, t = 16, 2, 128, 45
    q, k, v = (_randn(dev, 1, h, t, d, seed=s) for s in range(3))
    full = A.flash_attention(q, k, v, causal=True, block=page)
    k_pool = torch.zeros(4, page, h, d, device=dev)
    v_pool = torch.zeros_like(k_pool)
    tables = torch.tensor([[3, 1, 0]], dtype=torch.int32, device=dev)
    for pos in range(t):
        pg, off = int(tables[0, pos // page]), pos % page
        k_pool[pg, off] = k[0, :, pos]
        v_pool[pg, off] = v[0, :, pos]
    row = A.paged_attention(q[:, :, t - 1:t].contiguous(), k_pool, v_pool,
                            tables, torch.tensor([t], dtype=torch.int32,
                                                 device=dev))
    assert torch.equal(row[0, :, 0], full[0, :, t - 1])


def _card_expf():
    """``expf`` as the exact kernels compute it: a run-time kernel built
    with their flags, one value a call, for ``merge_sequential``."""
    from mxnet_tpu_torch import rtc

    k = rtc.CudaKernel("if (threadIdx.x == 0) y[0] = expf(x[0]);",
                       [((1,), "float32")], ["x", "y"], grid=1, block=32,
                       name="card_expf")

    def exp(x):
        (y,) = k(x.reshape(1).cuda())
        return y.handle.cpu().reshape(x.shape)

    return exp


# T ragged, at a tile edge and the training length; 64 heads give 32-row
# tiles at T = 200 and 1024, one head 16-row tiles
@pytest.mark.parametrize("t", [37, 200, 1024])
@pytest.mark.parametrize("d", [40, 128])
@pytest.mark.parametrize("block", [16, 128])
def test_flash_rows_equal_merge_sequential_bitwise(dev, t, d, block):
    """K1 rows equal the one-warp-a-row order (``paged_order.
    merge_sequential`` with the card's expf) bit for bit, at the first
    row, tile edges and the last row, causal and not; the rows of head 0
    are the same bits whether the launch has 64 heads or one (other tile
    heights), and a rerun repeats them."""
    exp = _card_expf()
    q, k, v = (_randn(dev, 64, t, d, seed=20 + s) for s in range(3))
    scale = 1.0 / d ** 0.5
    rows = sorted({r for r in (0, 15, 16, 31, 32, 63, 64, t - 1) if r < t})
    for causal in (True, False):
        full = A.flash_attention(q, k, v, causal=causal, block=block)
        assert torch.equal(full, A.flash_attention(q, k, v, causal=causal,
                                                   block=block))
        one = A.flash_attention(q[:1], k[:1], v[:1], causal=causal,
                                block=block)
        assert torch.equal(one[0], full[0])
        qs = q[0].cpu() * torch.tensor(scale)
        kc, vc = k[0].cpu(), v[0].cpu()
        for r in rows if causal else rows[::3]:
            want, _ = paged_order.merge_sequential(
                qs[r], kc, vc, r + 1 if causal else t, block, exp)
            assert torch.equal(full[0, r].cpu(), want), (causal, r)


def _paged_sequence(dev, page, h, d, n_pages, max_pages):
    """q, k, v of one (1, h, n_pages * page, d) sequence, its K1 rows
    (block = page), and pools holding it through a shuffled table of
    ``max_pages`` entries; every other pool page is NaN, which no visible
    key may read."""
    t = n_pages * page
    q, k, v = (_randn(dev, 1, h, t, d, seed=10 + s) for s in range(3))
    full = A.flash_attention(q, k, v, causal=True, block=page)
    rs = np.random.RandomState(page + h + d)
    ids = rs.permutation(max_pages + 3)[:max_pages]
    k_pool = torch.full((max_pages + 4, page, h, d), float("nan"),
                        device=dev)
    v_pool = k_pool.clone()
    for b in range(n_pages):
        k_pool[ids[b]] = k[0, :, b * page:(b + 1) * page].transpose(0, 1)
        v_pool[ids[b]] = v[0, :, b * page:(b + 1) * page].transpose(0, 1)
    table = torch.from_numpy(ids.astype(np.int32)).to(dev)
    return q, full, k_pool, v_pool, table


# serving's geometry, and the odd geometries of the tests above
@pytest.mark.parametrize("page,h,d", [(16, 16, 128), (8, 4, 64),
                                      (16, 2, 128)])
def test_paged_decode_and_prefill_equal_flash_rows_bitwise(dev, page, h, d):
    n_pages = 64
    q, full, k_pool, v_pool, table = _paged_sequence(dev, page, h, d,
                                                     n_pages, n_pages + 2)
    # decode, 8 slots over the same pages: horizons of none, one key, a
    # page edge and the key after it, and up to all 64 pages
    hz = [0, 1, page, page + 1, 2 * page, 17 * page + 3,
          n_pages * page - 1, n_pages * page]
    tables = table.expand(8, -1).contiguous()
    lengths = torch.tensor(hz, dtype=torch.int32, device=dev)
    qd = torch.stack([q[0, :, max(n - 1, 0)] for n in hz])[:, :, None]
    before = _cuda.launches["paged_attention"]
    out = A.paged_attention(qd.contiguous(), k_pool, v_pool, tables,
                            lengths)
    assert _cuda.launches["paged_attention"] == before + 1
    assert torch.count_nonzero(out[0]) == 0
    for i, n in enumerate(hz[1:], 1):
        assert torch.equal(out[i, :, 0], full[0, :, n - 1]), n
    # prefill: per-row horizons offset + j + 1, serving's buckets (64 and
    # 256 rows), a ragged tile, a 16-row and a 5-row call (the verify's
    # width), offsets on and off a page edge
    for offset, nq in ((32, 256), (5, 37), (64, 64), (17, 16), (200, 5)):
        rows = q[:, :, offset:offset + nq].contiguous()
        horizons = torch.arange(offset + 1, offset + nq + 1,
                                dtype=torch.int32, device=dev)[None]
        out = A.paged_attention(rows, k_pool, v_pool, table[None],
                                horizons)
        assert torch.equal(out[0], full[0, :, offset:offset + nq])
        assert torch.equal(out, A.paged_attention(rows, k_pool, v_pool,
                                                  table[None], horizons))


@pytest.mark.parametrize("m,f,c", [(1, 70, 33), (8, 96, 64),
                                   (40, 130, 200)])
def test_mi_linear_kernel_matches_plain_and_is_row_invariant(dev, m, f, c):
    x, w = _randn(dev, m, c, seed=1), _randn(dev, f, c, seed=2)
    b = _randn(dev, f, seed=3)
    for bias in (b, None):
        got = L.mi_linear(x, w, bias)
        # two fp32 summation orders over C terms differ by at most
        # 2 C 2^-24 (|x| |w|^T + |b|)
        mag = x.abs() @ w.abs().t() + (bias.abs() if bias is not None else 0)
        diff = (got - L.mi_linear_plain(x, w, bias)).abs()
        assert bool((diff <= 2 * c * 2.0 ** -24 * mag).all())
        for r in range(m):
            assert torch.equal(L.mi_linear(x[r:r + 1], w, bias),
                               got[r:r + 1])


# row counts: decode (the streaming kernel up to 16), the verify's 40,
# prefill buckets, and the edges of the ring kernel's tiles
M_SWEEP = (1, 7, 8, 16, 17, 24, 40, 48, 64, 65, 128, 256)


def _unaligned(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    off = (-(buf.data_ptr() // 4) + 1) % 4
    return buf[off:off + x.numel()].view(x.shape).copy_(x)


# every projection of the serving path, and two shapes off the tiles (F
# not a multiple of the 16-feature slab; C past a 128-column stage, and C
# odd, which the tiled kernel takes)
@pytest.mark.parametrize("f,c", [(6144, 2048), (2048, 2048), (8192, 2048),
                                 (2048, 8192), (32768, 2048), (70, 200),
                                 (70, 33)])
def test_mi_linear_rows_do_not_depend_on_m(dev, f, c):
    x = _randn(dev, 300, c, seed=4)
    w, b = 0.02 * _randn(dev, f, c, seed=5), 0.02 * _randn(dev, f, seed=6)
    full = L.mi_linear(x[3:259], w, b)
    assert torch.equal(full, L.mi_linear(x[3:259], w, b))
    for m in M_SWEEP:
        got = L.mi_linear(x[3:3 + m], w, b)
        assert torch.equal(got, full[:m]), m
        assert torch.equal(got, L.mi_linear(x[3:3 + m], w, b)), m
        # rows 4 bytes off a 16-byte boundary take the tiled kernel
        assert torch.equal(L.mi_linear(_unaligned(x[3:3 + m]), w, b), got), m
    mag = x[3:11].abs() @ w.abs().t() + b.abs()
    diff = (full[:8] - L.mi_linear_plain(x[3:11], w, b)).abs()
    assert bool((diff <= 2 * c * 2.0 ** -24 * mag).all())


def test_wrappers_raise_instead_of_falling_back(dev):
    x = _randn(dev, 4, 8).double()
    with pytest.raises(MXNetError, match="float32"):
        L.mi_linear(x, x)
    with pytest.raises(MXNetError, match="does not take"):
        L.mi_linear(x.float(), _randn(dev, 3, 5))
    q = _randn(dev, 1, 1, 8, 8)
    with pytest.raises(MXNetError, match="window"):  # K7 has no window yet
        A.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), window=2)
    pool = _randn(dev, 3, 8, 1, 8)
    tables = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    q = _randn(dev, 1, 1, 1, 8)
    with pytest.raises(MXNetError, match="float32"):
        A.paged_attention(q.double(), pool, pool, tables, lengths)
    with pytest.raises(MXNetError, match="int32"):
        A.paged_attention(q, pool, pool, tables.long(), lengths)
    with pytest.raises(MXNetError, match="out of the kernel's range"):
        big = _randn(dev, 3, 8, 1, 320)
        A.paged_attention(_randn(dev, 1, 1, 1, 320), big, big, tables,
                          lengths)
    with pytest.raises(MXNetError, match="out of the kernel's range"):
        wide = _randn(dev, 3, 256, 1, 8)
        A.paged_attention(q, wide, wide, tables, lengths)


def test_serve_decode_bitexact_on_the_card(dev):
    cfg = serve.ModelConfig(vocab_size=61, num_layers=2, d_model=64,
                            num_heads=2, max_len=64)
    sess = serve.InferenceSession(
        serve.init_params(cfg, seed=3, device=dev), num_heads=2,
        config=serve.ServeConfig(slots=3, page_size=8, buckets=(8, 16),
                                 max_new=8))
    rs = np.random.RandomState(11)
    seqs = {}
    for n in (5, 13):
        p = rs.randint(1, cfg.vocab_size, size=n).tolist()
        slot = sess.try_alloc(n, 8)
        first, logits = sess.prefill(slot, p)
        ref = serve.reference_last_logits(sess.params, p, sess.model, 8)
        np.testing.assert_array_equal(logits, ref.cpu().numpy())
        seqs[slot] = p + [first]
    for _ in range(6):
        toks, logits = sess.step()
        for slot, seq in seqs.items():
            ref = serve.reference_last_logits(sess.params, seq, sess.model,
                                              8)
            np.testing.assert_array_equal(logits[slot], ref.cpu().numpy())
            seq.append(toks[slot])


def _spec_session(dev, **kw):
    cfg = serve.ModelConfig(vocab_size=61, num_layers=2, d_model=64,
                            num_heads=2, max_len=64)
    conf = dict(slots=3, page_size=8, buckets=(8, 16), max_new=8,
                spec_k=3, draft="layers:2")
    conf.update(kw)
    return serve.InferenceSession(serve.init_params(cfg, seed=3, device=dev),
                                  num_heads=2,
                                  config=serve.ServeConfig(**conf))


def _replay_equals_eager(sess, name, **values):
    """Replay ``name`` on ``values`` and run its eager function on the same
    buffers from the same pools: outputs and written pools bit-equal."""
    exe = sess.executables[name]
    caches = [c for c in (sess.cache, sess.draft_cache) if c is not None]
    saved = [(c.k_pool.clone(), c.v_pool.clone()) for c in caches]
    got = [t.clone() for t in exe(**values)] if name != "draft" \
        else [exe(**values).clone()]
    after = [(c.k_pool.clone(), c.v_pool.clone()) for c in caches]
    for c, (k, v) in zip(caches, saved):
        c.k_pool.copy_(k)
        c.v_pool.copy_(v)
    want = exe.fn(**exe.inputs)
    want = list(want) if name != "draft" else [want]
    for a, b in zip(got, want):
        assert torch.equal(a, b), name
    for c, (k, v) in zip(caches, after):
        assert torch.equal(c.k_pool, k) and torch.equal(c.v_pool, v), name


def test_serve_graphs_replay_equal_eager_bitwise(dev):
    """Every captured entry point — decode, each prefill bucket, verify and
    draft — gives the eager function's outputs and pool writes bit for
    bit: on live slots, again after its inputs change, and after the
    speculative step's truncate."""
    sess = _spec_session(dev)
    assert sorted(sess.executables) == ["decode", "draft", "prefill_16",
                                        "prefill_8", "verify"]
    assert all(e.graph is not None for e in sess.executables.values())
    assert sess.capture_s > 0 and sess.graph_pool_bytes > 0
    rs = np.random.RandomState(3)
    for n in (5, 13):
        p = rs.randint(1, 61, size=n).tolist()
        slot = sess.try_alloc(n, 8)
        bucket = sess.bucket_for(n)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = p
        _replay_equals_eager(sess, "prefill_%d" % bucket, tokens=toks,
                             length=n, offset=0,
                             table_row=sess.cache.table_row(slot))
        sess.prefill(slot, p)
    for _ in range(2):
        w = sess.config.spec_window
        toks = rs.randint(1, 61, size=(3, w))
        for cache, name in ((sess.cache, "verify"),
                            (sess.draft_cache, "draft")):
            extra = dict(n_feed=np.asarray([1, w, 2], np.int32)) \
                if name == "draft" else {}
            _replay_equals_eager(sess, name, tokens=toks,
                                 lengths=cache.device_lengths(),
                                 tables=cache.device_tables(), **extra)
        _replay_equals_eager(sess, "decode", tokens=toks[:, 0],
                             lengths=sess.cache.device_lengths(),
                             tables=sess.cache.device_tables())
        sess.spec_step()  # commits 1..W tokens, truncates the rest


def test_serve_graph_launches_follow_replays(dev):
    """A scheduler run's kernel launches are exactly the replays times the
    launches each graph recorded at capture: K3 4 a layer + the head and
    K2 once a layer, a step (the draft's W steps in one graph)."""
    sess = _spec_session(dev)
    per = sess.graph_report()["launches_per_replay"]
    layers, w = 2, sess.config.spec_window
    for name in ("decode", "verify", "prefill_8", "prefill_16"):
        assert per[name] == {"mi_linear": 4 * layers + 1,
                             "paged_attention": layers}, name
    assert per["draft"] == {"mi_linear": w * (4 * layers + 1),
                            "paged_attention": w * layers}
    before = dict(_cuda.launches)
    rs = np.random.RandomState(4)
    reqs = [serve.Request(rid=i, prompt=rs.randint(1, 61, size=4 + 3 * i)
                          .tolist(), max_new=8) for i in range(4)]
    done, _ = serve.Scheduler(sess, policy="continuous").run(reqs)
    assert all(not r.failed and len(r.tokens) == 8 for r in done)
    rep = sess.graph_report()
    assert rep["replays"]["verify"] > 0 and rep["replays"]["draft"] > 0
    for kernel in ("mi_linear", "paged_attention"):
        want = sum(rep["replays"][n] * per[n].get(kernel, 0) for n in per)
        assert _cuda.launches[kernel] - before[kernel] == want, kernel


# ---------------------------------------------------------------------------
# training slice: bf16 forward with lse (K7), the backward (K4 fp32, K8
# bf16), and one TrainStep
# ---------------------------------------------------------------------------
#
# Tolerance for bf16 results: each side rounds an fp32 value to bf16
# once, and the fp32 values differ by reduction order, so two results
# may sit one bf16 step apart: |diff| <= 2^-7 |want| + 1e-4 max|want|
# (the second term covers gradient entries that cancel toward zero in
# fp32 before the rounding).  K7/K8 also round P and dS to bf16 before
# their tensor-core products, which adds 2^-8 times the same contraction
# over absolute values (testing/attention_sm90.py, TOLERANCE_NOTE).  lse
# and fp32 gradients: atol 2e-5 (fp32 sums over up to 64 terms of order
# 1 in other orders).

def _bf16_close(got, want):
    got, want = got.float(), want.float()
    bound = 2.0 ** -7 * want.abs() + 1e-4 * want.abs().max()
    assert bool(((got - want).abs() <= bound).all()), \
        (got - want).abs().max().item()


def _sm90_close(got, want, bound):
    err, ratio = sm90.violation(got, want, bound)
    assert ratio <= 1.0, (err, ratio)


@pytest.mark.parametrize("t,d,causal,block", [(37, 64, True, 16),
                                              (37, 64, False, 16),
                                              (5, 128, True, 128)])
def test_flash_forward_bf16_with_lse_matches_plain(dev, t, d, causal, block):
    """bf16 runs K7, the tensor-core forward."""
    q, k, v = (_randn(dev, 2, 3, t, d, seed=s).bfloat16() for s in range(3))
    scale = 1.0 / d ** 0.5
    before = dict(_cuda.launches)
    got_out, got_lse = A._flash_forward_cuda(q, k, v, causal, scale, block,
                                             True)
    assert _cuda.launches["flash_attention_sm90"] == \
        before["flash_attention_sm90"] + 1
    assert _cuda.launches["flash_attention"] == before["flash_attention"]
    want_out, want_lse = A.flash_forward_plain(q, k, v, causal, scale,
                                               block)
    assert got_out.dtype == torch.bfloat16
    _sm90_close(got_out, want_out,
                sm90.forward_bound(q, k, v, want_out, causal, scale))
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,causal", [(37, True), (37, False), (8, True)])
def test_flash_backward_kernel_matches_plain(dev, dtype, t, causal):
    d, block, scale = 64, 16, 0.125
    q, k, v, g = (_randn(dev, 2, 2, t, d, seed=s).to(dtype)
                  for s in range(4))
    """fp32 runs K4, bf16 K8."""
    out, lse = A.flash_forward_plain(q, k, v, causal, scale, block)
    name = ("flash_attention_backward" if dtype == torch.float32
            else "flash_attention_backward_sm90")
    before = dict(_cuda.launches)
    got = A.flash_attention_backward(q, k, v, out, lse, g, causal, scale,
                                     block)
    assert {n: _cuda.launches[n] - before[n] for n in
            ("flash_attention_backward", "flash_attention_backward_sm90")
            if _cuda.launches[n] != before[n]} == {name: 1}
    want = A.flash_backward_plain(q, k, v, out, lse, g, causal, scale,
                                  block)
    bounds = sm90.backward_bounds(q, k, v, out, lse, g, want, causal, scale)
    for a, b, bound in zip(got, want, bounds):
        assert a.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
        else:
            _sm90_close(a, b, bound)


@pytest.mark.parametrize("d", [16, 40, 64, 128, 256])
@pytest.mark.parametrize("t", [37, 200, 1024])
def test_flash_backward_fp32_matches_plain_rerun_bitwise_and_is_linear(
        dev, t, d):
    """K4 (fp32) at ragged T and the training length, every head-dim
    class, causal and not: within K4_ATOL of the plain version, the same
    bits when run again, and exactly twice its result at 2 g."""
    q, k, v, g = (_randn(dev, 2, 2, t, d, seed=30 + s) for s in range(4))
    scale = 1.0 / d ** 0.5
    for causal in (True, False):
        out, lse = A.flash_forward_plain(q, k, v, causal, scale, 16)
        before = _cuda.launches["flash_attention_backward"]
        got = A.flash_attention_backward(q, k, v, out, lse, g, causal,
                                         scale, 16)
        assert _cuda.launches["flash_attention_backward"] == before + 1
        want = A.flash_backward_plain(q, k, v, out, lse, g, causal, scale,
                                      16)
        for a, b in zip(got, want):
            assert a.shape == q.shape and a.dtype == torch.float32
            torch.testing.assert_close(a, b, rtol=0, atol=K4_ATOL)
        again = A.flash_attention_backward(q, k, v, out, lse, g, causal,
                                           scale, 16)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        twice = A.flash_attention_backward(q, k, v, out, lse, 2 * g,
                                           causal, scale, 16)
        assert all(torch.equal(2 * a, b) for a, b in zip(got, twice))


@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("t", [5, 37, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_kernels_match_plain_rerun_bitwise_and_are_linear(dev, t, d,
                                                               causal):
    """K7 and K8 at ragged T and at head dims that pad (16, 80) or not,
    against the plain versions inside the derived bound; K8 gives the
    same bits on a rerun and exactly twice its result at 2 g."""
    q, k, v, g = (_randn(dev, 2, 3, t, d, seed=s).bfloat16()
                  for s in range(4))
    scale = 1.0 / d ** 0.5
    before = dict(_cuda.launches)
    out, lse = A._flash_forward_cuda(q, k, v, causal, scale, 128, True)
    want_out, want_lse = A.flash_forward_plain(q, k, v, causal, scale, 128)
    _sm90_close(out, want_out,
                sm90.forward_bound(q, k, v, want_out, causal, scale))
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)
    got = A._flash_backward_cuda(q, k, v, want_out, want_lse, g, causal,
                                 scale, 128)
    want = A.flash_backward_plain(q, k, v, want_out, want_lse, g, causal,
                                  scale, 128)
    for a, b, bound in zip(got, want, sm90.backward_bounds(
            q, k, v, want_out, want_lse, g, want, causal, scale)):
        assert a.shape == q.shape and a.dtype == torch.bfloat16
        _sm90_close(a, b, bound)
    again = A._flash_backward_cuda(q, k, v, want_out, want_lse, g, causal,
                                   scale, 128)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    twice = A._flash_backward_cuda(q, k, v, want_out, want_lse, 2 * g,
                                   causal, scale, 128)
    assert all(torch.equal(2 * a, b) for a, b in zip(got, twice))
    assert _cuda.launches["flash_attention_sm90"] == \
        before["flash_attention_sm90"] + 1
    assert _cuda.launches["flash_attention_backward_sm90"] == \
        before["flash_attention_backward_sm90"] + 3
    assert _cuda.launches["flash_attention"] == before["flash_attention"]


def test_sm90_kernels_take_strided_views_and_raise_above_256(dev):
    """The strided (n, h, T, D) heads the attention op cuts from its fused
    projection, and a strided cotangent, reach K7/K8's tensor maps where
    they lie and give the plain versions' results; a bf16 head_dim above
    256 raises instead of falling back."""
    qkv = _randn(dev, 2, 40, 3, 4, 64).bfloat16()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    g = _randn(dev, 2, 40, 4, 64, seed=5).bfloat16().transpose(1, 2)
    assert not (q.is_contiguous() or g.is_contiguous())
    views = A._sm90_operands(40, 64, q, k, v, g)[0]
    assert [x.data_ptr() for x in views] == [x.data_ptr()
                                             for x in (q, k, v, g)]
    out, lse = A._flash_forward_cuda(q, k, v, True, 0.125, 128, True)
    want, want_lse = A.flash_forward_plain(q, k, v, True, 0.125, 128)
    _sm90_close(out, want, sm90.forward_bound(q, k, v, want, True, 0.125))
    got = A._flash_backward_cuda(q, k, v, want, want_lse, g, True, 0.125,
                                 128)
    wants = A.flash_backward_plain(q, k, v, want, want_lse, g, True, 0.125,
                                   128)
    for a, b, bound in zip(got, wants, sm90.backward_bounds(
            q, k, v, want, want_lse, g, wants, True, 0.125)):
        _sm90_close(a, b, bound)
    big = _randn(dev, 1, 1, 8, 264).bfloat16()
    with pytest.raises(MXNetError, match="head_dim 264"):
        A.flash_attention(big, big, big)


def test_flash_attention_autograd_runs_both_kernels(dev):
    q, k, v = (_randn(dev, 1, 2, 20, 32, seed=s).requires_grad_()
               for s in range(3))
    before = dict(_cuda.launches)
    out = A.flash_attention(q, k, v, block=8)
    out.sum().backward()
    assert _cuda.launches["flash_attention"] == before["flash_attention"] + 1
    assert _cuda.launches["flash_attention_backward"] == \
        before["flash_attention_backward"] + 1
    qc, kc, vc = (x.detach().cpu().requires_grad_() for x in (q, k, v))
    A.flash_attention(qc, kc, vc, block=8).sum().backward()
    for a, b in zip((q, k, v), (qc, kc, vc)):
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=0, atol=2e-5)


def test_train_step_kernels_match_reference_impl(dev, monkeypatch):
    """One bf16 TrainStep through K7/K8 against the same step under
    MXNET_ATTN_IMPL=reference, from one state: the parameter update of
    every tensor within 5e-2 relative L2 (the two attention paths round
    to bf16 at other places; see chip_smoke.py's train-parity phase)."""
    from mxnet_tpu_torch import fused
    from mxnet_tpu_torch.models import transformer

    sym = transformer.get_symbol(vocab_size=96, num_layers=2, d_model=64,
                                 num_heads=2, seq_len=40)
    shapes = {"data": (2, 40), "softmax_label": (2, 40)}
    monkeypatch.setenv("MXNET_ATTN_BLOCK", "16")
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(0, 96, (2, 40)).astype(np.float32))
    batch = {"data": toks.to(dev), "softmax_label": toks.to(dev)}
    updates = {}
    for impl in ("auto", "reference"):
        monkeypatch.setenv("MXNET_ATTN_IMPL", impl)
        step = fused.TrainStep(sym, optimizer_params=dict(
            learning_rate=0.1, momentum=0.9, rescale_grad=0.5),
            compute_dtype="bfloat16", device=dev)
        params, aux, states = step.init_state(shapes, seed=0)
        before = dict(_cuda.launches)
        new, _, _, outs = step(params, aux, states, batch, None)
        ran = {n: _cuda.launches[n] - before[n] for n in before
               if n.startswith("flash") and _cuda.launches[n] != before[n]}
        assert ran == ({"flash_attention_sm90": 2,
                        "flash_attention_backward_sm90": 2}
                       if impl == "auto" else {})
        assert bool(torch.isfinite(outs[0]).all())
        updates[impl] = {n: (new[n] - params[n]).float() for n in params}
    for n, want in updates["reference"].items():
        got = updates["auto"][n]
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        assert rel < 5e-2, (n, rel)


# ---------------------------------------------------------------------------
# ResNet slice: K5 bn_stats, K6 bn_grad_sums, and Module.fit on the card
# ---------------------------------------------------------------------------
#
# K5/K6 against their plain versions: per channel, |diff| <= 3e-5 times
# the sum of the magnitudes of the terms (fp32 sums in two orders; see
# chip_smoke.py's BN_NOTE); a rerun gives the same bits (no atomics).

BN_SHAPES = [((256, 64, 112, 112), 1, torch.bfloat16),
             ((256, 3, 224, 224), 1, torch.bfloat16),
             ((256, 256, 56, 56), 1, torch.bfloat16),
             ((256, 2048, 7, 7), 1, torch.bfloat16),
             ((256, 56, 56, 256), 3, torch.bfloat16),
             ((256, 512, 28, 28), 1, torch.float32),
             ((3, 5, 7, 2), 1, torch.float32),
             ((6, 3, 5, 33), 3, torch.bfloat16)]


@pytest.mark.parametrize("shape,axis,dtype", BN_SHAPES)
def test_bn_kernels_match_plain_and_rerun_bitwise(dev, shape, axis, dtype):
    from mxnet_tpu_torch.ops import pallas_bn as BN

    x = (1.5 * _randn(dev, *shape, seed=1) + 0.3).to(dtype)
    # dy arrives from autograd possibly non-contiguous: a transposed view
    dy = _randn(dev, *shape, seed=2).to(dtype).transpose(0, 1).contiguous() \
        .transpose(0, 1)
    assert not dy.is_contiguous()
    dims = tuple(i for i in range(4) if i != axis)
    c = shape[axis]
    bshape = [1] * 4
    bshape[axis] = c
    before = dict(_cuda.launches)
    got = BN.bn_stats(x, axis)
    assert _cuda.launches["bn_stats"] == before["bn_stats"] + 1
    want = BN.bn_stats_plain(x, axis)
    xf = x.float()
    for g, w, m in zip(got, want, (xf.abs().sum(dims), (xf * xf).sum(dims))):
        assert g.dtype == torch.float32 and g.shape == (c,)
        assert bool(((g - w).abs() <= 3e-5 * m).all())
    assert all(torch.equal(a, b) for a, b in zip(got, BN.bn_stats(x, axis)))
    n = x.numel() // c
    mean = want[0] / n
    inv = torch.rsqrt((want[1] / n - mean * mean).clamp_min(0) + 2e-5)
    got = BN.bn_grad_sums(dy, x, mean, inv, axis)
    assert _cuda.launches["bn_grad_sums"] == before["bn_grad_sums"] + 1
    want = BN.bn_grad_sums_plain(dy, x, mean, inv, axis)
    dyf = dy.float()
    xhat = (xf - mean.view(bshape)) * inv.view(bshape)
    for g, w, m in zip(got, want, (dyf.abs().sum(dims),
                                   (dyf * xhat).abs().sum(dims))):
        assert bool(((g - w).abs() <= 3e-5 * m).all())
    assert all(torch.equal(a, b) for a, b in zip(
        got, BN.bn_grad_sums(dy, x, mean, inv, axis)))


def test_bn_wrappers_raise_instead_of_falling_back(dev):
    from mxnet_tpu_torch.ops import pallas_bn as BN

    x = _randn(dev, 2, 3, 4, 4)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        BN.bn_stats(x.half())
    with pytest.raises(MXNetError, match="dtypes"):
        BN.bn_grad_sums(x.bfloat16(), x, x[0, :, 0, 0], x[0, :, 0, 0])
    with pytest.raises(MXNetError, match="per-channel"):
        BN.bn_grad_sums(x, x, x[0, 0, 0], x[0, 0, 0])


def test_batch_norm_bf16_runs_k5_and_k6_once_each(dev):
    from mxnet_tpu_torch.ops import registry as reg

    x = _randn(dev, 4, 6, 5, 5).bfloat16().requires_grad_()
    g, b = (torch.ones(6, device=dev, dtype=torch.bfloat16,
                       requires_grad=True) for _ in range(2))
    mm = torch.zeros(6, device=dev, dtype=torch.bfloat16)
    mv = torch.ones(6, device=dev, dtype=torch.bfloat16)
    # a random cotangent: under ones, dx is 0 up to rounding
    cot = _randn(dev, 4, 6, 5, 5, seed=3).bfloat16()
    before = dict(_cuda.launches)
    out, _, _ = reg.get("BatchNorm").compute(reg.FrozenAttrs(
        {"fix_gamma": False, "__is_train__": True}), x, g, b, mm, mv)
    out.backward(cot)
    assert _cuda.launches["bn_stats"] == before["bn_stats"] + 1
    assert _cuda.launches["bn_grad_sums"] == before["bn_grad_sums"] + 1
    xc = x.detach().cpu().requires_grad_()
    gc, bc = (t.detach().cpu().requires_grad_() for t in (g, b))
    outc, _, _ = reg.get("BatchNorm").compute(reg.FrozenAttrs(
        {"fix_gamma": False, "__is_train__": True}), xc, gc, bc, mm.cpu(),
        mv.cpu())
    outc.backward(cot.cpu())
    for a, c in ((out, outc), (x.grad, xc.grad), (g.grad, gc.grad),
                 (b.grad, bc.grad)):
        _bf16_close(a.detach().cpu(), c.detach())


def test_module_fit_tiny_resnet_on_the_card(dev):
    """Two bf16 steps of the tiny ResNet through Module.fit on gpu(0): K5
    and K6 once per BatchNorm node per step, finite changed parameters."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import resnet

    sym = resnet.resnet(units=[1, 1], num_stages=2, filter_list=[8, 32, 64],
                        num_classes=10, image_shape=(3, 64, 64))
    n_bn = sum(1 for n in sym._topo() if not n.is_variable
               and n.op.name == "BatchNorm")
    rs = np.random.RandomState(0)
    x = rs.rand(8, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 10, 8).astype(np.float32)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind([("data", (4, 3, 64, 64))], [("softmax_label", (4,))])
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    before_params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    _cuda.reset_launches()
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1,
                                               "momentum": 0.9},
            compute_dtype="bfloat16")
    assert _cuda.launches["bn_stats"] == 2 * n_bn
    assert _cuda.launches["bn_grad_sums"] == 2 * n_bn
    for k, v in mod.get_params()[0].items():
        v = v.asnumpy()
        assert np.isfinite(v).all()
        if k != "bn_data_gamma":
            assert not np.array_equal(v, before_params[k]), k
    assert mod.get_params()[0]["fc1_weight"].context == mx.gpu(0)


# -- rtc: CUDA bodies compiled at run time ------------------------------

def _off16(t):
    """A contiguous copy of ``t`` that starts one float past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


_AXPY_BODIES = {
    torch.float32: "o[i] = 2.0f * x[i] + y[i];",
    torch.bfloat16: "o[i] = __float2bfloat16(2.0f * __bfloat162float(x[i])"
                    " + __bfloat162float(y[i]));",
    torch.float16: "o[i] = __float2half(2.0f * __half2float(x[i])"
                   " + __half2float(y[i]));",
}


@pytest.mark.parametrize("shape", [(33, 129), (1, 1), (3, 5), (257, 1023)])
@pytest.mark.parametrize("dtype", list(_AXPY_BODIES))
def test_rtc_kernel_matches_plain(dev, dtype, shape):
    """``o = 2x + y`` compiled at run time, in each dtype of the map: fp32
    on both sides with -fmad=false gives the same bits; bf16 and half
    compute in fp32 and round once on both sides.  In fp32 also the
    loss head's ``rtc_axpy`` (its grid-stride float4 loop and scalar
    tail; a view one float off a 16-byte boundary takes its scalar loop),
    bit-equal to ``axpy_plain`` and on a rerun."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.testing import rtc_ops

    body = ("const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "if (i < x_dims[0] * x_dims[1]) " + _AXPY_BODIES[dtype])
    x, y = (_randn(dev, *shape, seed=s).to(dtype) for s in (1, 2))
    k = rtc.CudaKernel(body, [(shape, dtype)], ["x", "y", "o"],
                       name="axpy_test")
    before = _cuda.launches.get("rtc:axpy_test", 0)
    (out,) = k(x, y)
    assert _cuda.launches["rtc:axpy_test"] == before + 1
    want = (2.0 * x.float() + y.float()).to(dtype)
    assert torch.equal(out.handle, want)
    if dtype != torch.float32:
        return
    for a, b in ((x, y), (_off16(x), _off16(y))):
        before = _cuda.launches.get("rtc:rtc_axpy", 0)
        got = rtc_ops.axpy(a, b)
        assert _cuda.launches["rtc:rtc_axpy"] == before + 1
        assert torch.equal(got, rtc_ops.axpy_plain(a, b))
        assert torch.equal(rtc_ops.axpy(a, b), got)


def test_rtc_cached_build_does_not_call_nvcc(dev, monkeypatch):
    from mxnet_tpu_torch import rtc

    body = ("const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "if (i < x_dims[0]) y[i] = x[i] + 1.0f;")
    x = _randn(dev, 1000)
    rtc.CudaKernel(body, [((1000,), "float32")], ["x", "y"])(x)

    def no_nvcc():
        raise AssertionError("a cached build called nvcc")

    monkeypatch.setattr(_cuda, "_nvcc", no_nvcc)
    monkeypatch.setattr(_cuda, "_rtc_entries", {})
    (y,) = rtc.CudaKernel(body, [((1000,), "float32")], ["x", "y"])(x)
    assert torch.equal(y.handle, x + 1.0)


def test_rtc_compile_error_carries_nvcc_message(dev):
    from mxnet_tpu_torch import rtc

    k = rtc.CudaKernel("this is not C++;", [((4,), "float32")], ["x", "y"],
                       name="broken")
    with pytest.raises(MXNetError, match="error") as err:
        k(_randn(dev, 4))
    assert "nvcc" in str(err.value)


@pytest.mark.parametrize("n", [1, 37, 256])
@pytest.mark.parametrize("c", [1, 3, 1000, 4097])
@pytest.mark.parametrize("scale", [1.0, 1e4])
def test_rtc_softmax_kernels_match_plain(dev, scale, c, n):
    """The softmax head's two kernels: probabilities within atol 1e-6
    (fp32, expf against torch's exp, one row sum each), and the backward
    bit-equal (one subtraction and one division on both sides), with
    labels outside [0, C) (-1, C, C + 0.5: no one), on rows held in
    registers (C <= 2048) and longer ones read in groups (4097), on
    float4 rows and on rows no float4 load can take (C not a multiple of
    4, or a view one float off a 16-byte boundary); reruns bit-equal."""
    from mxnet_tpu_torch.testing import rtc_ops

    x = scale * _randn(dev, n, c, seed=4)
    label = torch.randint(0, c, (n,), device=dev).float()
    for i, bad in ((1, -1.0), (2, float(c)), (3, c + 0.5)):
        label[i::5] = bad
    for logits in (x, _off16(x)):
        before = _cuda.launches.get("rtc:rtc_softmax_forward", 0)
        p = rtc_ops.softmax_forward(logits)
        assert _cuda.launches["rtc:rtc_softmax_forward"] == before + 1
        torch.testing.assert_close(p, rtc_ops.softmax_forward_plain(logits),
                                   rtol=0, atol=1e-6)
        assert torch.equal(rtc_ops.softmax_forward(logits), p)
        for probs in (p, _off16(p)):
            g = rtc_ops.softmax_backward(probs, label)
            assert torch.equal(g, rtc_ops.softmax_backward_plain(probs,
                                                                 label))
            assert torch.equal(rtc_ops.softmax_backward(probs, label), g)
    with pytest.raises(MXNetError, match="float32"):
        rtc_ops.softmax_forward(x.double())


def test_gluon_bf16_step_runs_k5_k6_once_per_batchnorm(dev):
    """One bf16 Gluon step of a tiny ResNetV1 on the card: K5 and K6 once
    per BatchNorm block, and a CustomOp loss head through both rtc softmax
    kernels once each."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.testing import rtc_ops  # noqa: F401  (rtc_softmax)

    net = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                          [8, 16, 16, 32, 32], classes=10, thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    n_bn = sum(1 for k in net.collect_params().keys()
               if k.endswith("_gamma"))
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.randn(8, 3, 16, 16).astype(np.float32), mx.gpu(0))
    y = mx.nd.array(rs.randint(0, 10, 8).astype(np.float32), mx.gpu(0))
    net(x)
    net.cast("bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "multi_precision": True})
    _cuda.reset_launches()
    with mx.autograd.record():
        out = net(x.astype("bfloat16")).astype("float32")
        loss = mx.nd.Custom(out, y, op_type="rtc_softmax")
    loss.backward()
    trainer.step(8)
    assert _cuda.launches["bn_stats"] == n_bn
    assert _cuda.launches["bn_grad_sums"] == n_bn
    assert _cuda.launches["rtc:rtc_softmax_forward"] == 1
    assert _cuda.launches["rtc:rtc_softmax_backward"] == 1
    for p in net.collect_params().values():
        assert bool(torch.isfinite(p.data().handle.float()).all()), p.name


def test_gluon_dataloader_prefetch_stages_onto_the_card(dev):
    """``DataLoader(prefetch=2)`` stages batches through pinned memory and
    a side stream: every batch arrives on the card, equal to the host
    data, in order; a worker error surfaces at ``next()``."""
    import mxnet_tpu_torch as mx

    X = np.arange(4000, dtype=np.float32).reshape(40, 100)
    y = np.arange(40, dtype=np.float32)
    loader = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(X, y),
                                      batch_size=8, prefetch=2,
                                      device=mx.gpu(0))
    batches = list(loader)
    assert len(batches) == 5
    for i, (xb, yb) in enumerate(batches):
        assert xb.handle.is_cuda and xb.context == mx.gpu(0)
        np.testing.assert_array_equal(xb.asnumpy(), X[8 * i:8 * i + 8])
        np.testing.assert_array_equal(yb.asnumpy(), y[8 * i:8 * i + 8])

    class Bad(mx.gluon.data.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError("bad sample %d" % i)

    with pytest.raises(ValueError, match="bad sample"):
        list(mx.gluon.data.DataLoader(Bad(), batch_size=2, prefetch=1,
                                      device=mx.gpu(0)))


# ---------------------------------------------------------------------------
# quantized serving: K3q, K2q, K9 and the quantized session's graphs
# ---------------------------------------------------------------------------
#
# The per-precision contract is bit-equality: K3q equals K3 on the
# dequantized weight, K2q equals K1 over the fake-quantized context, and
# K9's codes and scales equal the plain kv_quantize_rows byte for byte.

QMODES = ("int8", "fp8")


def _qrecord(w, mode):
    q, s = Q.quantize_array(w, mode)
    return {"q": q, "s": s}


# every projection of the serving path and two shapes off the tiles (F
# not a multiple of the 16-feature slab; C = 200 not a multiple of 16,
# which takes K3q's tiled kernel at every M, and C = 33 odd)
@pytest.mark.parametrize("mode", QMODES)
@pytest.mark.parametrize("f,c", [(6144, 2048), (2048, 2048), (8192, 2048),
                                 (2048, 8192), (32768, 2048), (70, 200),
                                 (70, 33)])
def test_mi_linear_q_equals_k3_on_dequantized_weight_bitwise(dev, mode, f,
                                                             c):
    x = _randn(dev, 300, c, seed=4)
    rec = _qrecord(0.02 * _randn(dev, f, c, seed=5), mode)
    b = 0.02 * _randn(dev, f, seed=6)
    w = Q.dequantize_array(rec["q"], rec["s"])
    full = L.mi_linear(x[3:259], rec, b)
    for m in M_SWEEP:
        before = dict(_cuda.launches)
        got = L.mi_linear(x[3:3 + m], rec, b)
        assert _cuda.launches["mi_linear_q"] == before["mi_linear_q"] + 1
        assert _cuda.launches["mi_linear"] == before["mi_linear"]
        assert torch.equal(got, L.mi_linear(x[3:3 + m], w, b)), m
        assert torch.equal(got, L.mi_linear(x[3:3 + m], rec, b)), m
        assert torch.equal(got, full[:m]), m
        assert torch.equal(L.mi_linear(_unaligned(x[3:3 + m]), rec, b),
                           got), m
    assert torch.equal(L.mi_linear(x[:8], rec), L.mi_linear(x[:8], w))


def _fake_quant(t, mode):
    """(1, h, T, d) keys or values quantized and dequantized per token."""
    q, s = Q.kv_quantize_rows(t.transpose(1, 2), mode)
    return Q.kv_dequantize(q, s).transpose(1, 2).contiguous()


@pytest.mark.parametrize("mode", QMODES)
@pytest.mark.parametrize("page,h,d", [(16, 16, 128), (8, 4, 64),
                                      (16, 2, 128)])
def test_paged_q_equals_flash_over_fake_quantized_context_bitwise(
        dev, mode, page, h, d):
    """K2q at decode, prefill (a full and a ragged 16-row tile) and verify
    (5 rows a slot) gives K1's rows over the fake-quantized context bit
    for bit; unused pool pages hold random codes and NaN scales."""
    n_pages, max_pages = 64, 66
    t = n_pages * page
    q, k, v = (_randn(dev, 1, h, t, d, seed=20 + s) for s in range(3))
    full = A.flash_attention(q, _fake_quant(k, mode), _fake_quant(v, mode),
                             causal=True, block=page)
    rs = np.random.RandomState(page + h + d)
    ids = rs.permutation(max_pages + 3)[:max_pages]
    dtype = Q.storage_dtype(mode)
    pools = [torch.randint(-128 if dtype == torch.int8 else 0,
                           128 if dtype == torch.int8 else 256,
                           (max_pages + 4, page, h, d), dtype=dtype,
                           device=dev) for _ in range(2)]
    scales = [torch.full((max_pages + 4, page), float("nan"), device=dev)
              for _ in range(2)]
    for src, pool, sc in ((k, pools[0], scales[0]), (v, pools[1], scales[1])):
        codes, s = Q.kv_quantize_rows(src[0].transpose(0, 1), mode)
        for b in range(n_pages):
            pool[ids[b]] = codes[b * page:(b + 1) * page]
            sc[ids[b]] = s[b * page:(b + 1) * page]
    table = torch.from_numpy(ids.astype(np.int32)).to(dev)
    kw = dict(k_scale=scales[0], v_scale=scales[1])
    hz = [0, 1, page, page + 1, 2 * page, 17 * page + 3, t - 1, t]
    tables = table.expand(8, -1).contiguous()
    qd = torch.stack([q[0, :, max(n - 1, 0)] for n in hz])[:, :, None]
    before = dict(_cuda.launches)
    out = A.paged_attention(qd.contiguous(), pools[0], pools[1], tables,
                            torch.tensor(hz, dtype=torch.int32, device=dev),
                            **kw)
    assert _cuda.launches["paged_attention_q"] == \
        before["paged_attention_q"] + 1
    assert _cuda.launches["paged_attention"] == before["paged_attention"]
    assert torch.count_nonzero(out[0]) == 0
    for i, n in enumerate(hz[1:], 1):
        assert torch.equal(out[i, :, 0], full[0, :, n - 1]), n
    deq = [Q.kv_dequantize(pool, sc) for pool, sc in zip(pools, scales)]
    for offset, nq in ((32, 256), (5, 37), (64, 64), (17, 16), (200, 5)):
        rows = q[:, :, offset:offset + nq].contiguous()
        horizons = torch.arange(offset + 1, offset + nq + 1,
                                dtype=torch.int32, device=dev)[None]
        out = A.paged_attention(rows, pools[0], pools[1], table[None],
                                horizons, **kw)
        assert torch.equal(out[0], full[0, :, offset:offset + nq])
        assert torch.equal(out, A.paged_attention(rows, pools[0], pools[1],
                                                  table[None], horizons,
                                                  **kw))
        assert torch.equal(out, A.paged_attention(rows, *deq, table[None],
                                                  horizons))
    # verify: 8 slots x 5 rows at horizons committed + j + 1
    committed = [3, page - 1, page, 40, 200, t - 300, t - 5, 0]
    hor = np.asarray(committed)[:, None] + np.arange(5) + 1
    qv = torch.stack([torch.stack([q[0, :, n - 1] for n in row], 1)
                      for row in hor])
    out = A.paged_attention(qv.contiguous(), pools[0], pools[1], tables,
                            torch.from_numpy(hor.astype(np.int32)).to(dev),
                            **kw)
    for i, row in enumerate(hor):
        for j, n in enumerate(row):
            assert torch.equal(out[i, :, j], full[0, :, n - 1]), (i, j)


def _kv_rows(dev, n, h, d, mode, seed):
    """(n, h, d) rows with the edge cases of the quantizer: exact .5 ties
    of x / scale (int8) or halfway between two e4m3 values, an all-zero
    row, a row of one value, and rows within an ulp of +-qmax * scale."""
    qmax = Q.INT8_MAX if mode == "int8" else Q.FP8_MAX
    m = max(n, 5)  # fewer than 5 rows: the last n of the edge cases
    x = _randn(dev, m, h, d, seed=seed) * torch.logspace(
        -3, 3, m, device=dev)[:, None, None]
    x[0] = 0.0
    x[1] = -2.5
    # row 2: amax = qmax / 4, so scale = 1 / 4 exactly, and every other
    # value scales to a tie: k + .5 (int8), or the midpoint of two e4m3
    # neighbours in [8, 16), where their spacing is 1
    grid = torch.arange(h * d, device=dev).reshape(h, d) % 64 - 32
    sign = torch.where(grid < 0, -1.0, 1.0)
    ties = (grid + 0.5) / 4 if mode == "int8" \
        else sign * (grid.abs() % 8 + 8.5) / 4
    ties[0, 0] = qmax / 4
    x[2] = ties
    x[3] = torch.nextafter(x[2], torch.full_like(x[2], float("inf")))
    x[4] = -x[3]
    return x[m - n:]


@pytest.mark.parametrize("mode", QMODES)
@pytest.mark.parametrize("n", [1, 8, 40, 256, 4096])
@pytest.mark.parametrize("h,d", [(16, 128), (16, 72)])
def test_kv_append_quantized_matches_plain_bytewise(dev, mode, n, h, d):
    """K9's codes and scales byte-equal to the plain form's, at a decode
    step's rows and above, at serving's H x D = 2048 (the registers'
    path) and at 16 x 72 (its strided loop), from contiguous rows and
    from the K and V thirds of an (N, 3, H, D) QKV output; reruns
    byte-equal."""
    page = 16
    n_pages = max(20, n // page + 4)
    krows = _kv_rows(dev, n, h, d, mode, seed=7)
    vrows = _kv_rows(dev, n, h, d, mode, seed=8)[torch.randperm(
        n, generator=torch.Generator().manual_seed(0)).to(dev)]
    rs = np.random.RandomState(n)
    slots = rs.permutation(n_pages * page)[:n]
    # up to three rows into the trash page (row 0)
    slots[n - min(3, n - 1):] = n_pages * page
    pages = torch.from_numpy(slots // page).to(dev)
    offsets = torch.from_numpy(np.where(slots == n_pages * page, 0,
                                        slots % page)).to(dev)
    dtype = Q.storage_dtype(mode)

    def fresh():
        return [torch.zeros(n_pages + 1, page, h, d, dtype=dtype, device=dev)
                for _ in range(2)] + [torch.ones(n_pages + 1, page,
                                                 device=dev)
                                      for _ in range(2)]

    got, want = fresh(), fresh()
    before = _cuda.launches["kv_append_quantized"]
    Q.kv_append_quantized(*got, pages, offsets, krows, vrows)
    assert _cuda.launches["kv_append_quantized"] == before + 1
    Q.kv_append_quantized_plain(*want, pages, offsets, krows, vrows)
    live = slice(0, n_pages)  # the trash page's winner is any of three
    for a, b in zip(got, want):
        assert torch.equal(a[live], b[live])
    # the plain form on the card equals it on the CPU too
    for rows, codes, scales in ((krows, got[0], got[2]),
                                (vrows, got[1], got[3])):
        cq, cs = Q.kv_quantize_rows(rows.cpu(), mode)
        keep = slots < n_pages * page
        at = (pages.cpu().numpy()[keep], offsets.cpu().numpy()[keep])
        assert torch.equal(codes.cpu()[at], cq[keep])
        assert torch.equal(scales.cpu()[at], cs[keep])
    again = fresh()
    Q.kv_append_quantized(*again, pages, offsets, krows, vrows)
    for a, b in zip(again, got):
        assert torch.equal(a[live], b[live])
    # strided rows (a fused QKV projection's K and V thirds) read alike
    qkv = torch.stack([krows, krows, vrows], 1)
    again = fresh()
    Q.kv_append_quantized(*again, pages, offsets, qkv[:, 1], qkv[:, 2])
    for a, b in zip(again, got):
        assert torch.equal(a[live], b[live])


@pytest.mark.parametrize("mode", QMODES)
@pytest.mark.parametrize("n", [6, 40])
@pytest.mark.parametrize("h,d", [(16, 128), (16, 72)])
def test_kv_append_quantized_non_finite_rows_follow_the_plain_form(dev, mode,
                                                                   n, h, d):
    """K9 on rows holding a NaN or an Inf (in the first and in the last
    warp's elements, alone and together, a whole NaN row) against the
    plain form on the CPU, which the JAX package's is held to
    (``test_torch_quantize.py``): scales equal (1.0 for a NaN row, Inf
    for an Inf row); e4m3 codes equal as values, NaN where the plain
    form's are NaN; int8 codes equal wherever the quotient x / scale is
    not NaN, and 0 where it is.  At a decode step's rows and above, on
    the registers' path (H x D = 2048) and the strided loop (16 x 72);
    reruns byte-equal."""
    rows = _randn(dev, n, h, d, seed=11)
    rows[1, 3, 5] = float("nan")
    rows[2, h - 1, d - 1] = float("inf")
    rows[3, 0, 0], rows[3, 9, 64] = float("nan"), -float("inf")
    rows[4] = float("nan")
    rows[5, 7, 7] = -float("inf")
    pages = torch.arange(n, device=dev)
    offsets = torch.zeros(n, dtype=torch.int64, device=dev)
    pools = [torch.zeros(n + 1, 4, h, d, dtype=Q.storage_dtype(mode),
                         device=dev) for _ in range(2)] + \
        [torch.ones(n + 1, 4, device=dev) for _ in range(2)]
    before = _cuda.launches["kv_append_quantized"]
    Q.kv_append_quantized(*pools, pages, offsets, rows, rows)
    assert _cuda.launches["kv_append_quantized"] == before + 1
    again = [torch.zeros_like(p) if p.dtype != torch.float32 else
             torch.ones_like(p) for p in pools]
    Q.kv_append_quantized(*again, pages, offsets, rows, rows)
    for a, b in zip(again, pools):
        assert torch.equal(a, b)
    cq, cs = Q.kv_quantize_rows(rows.cpu(), mode)
    assert cs[1] == 1.0 and cs[2] == float("inf") and cs[4] == 1.0
    nan_q = torch.isnan(rows.cpu() / cs[:, None, None])
    for codes, scales in ((pools[0], pools[2]), (pools[1], pools[3])):
        got_q = codes[pages, offsets].cpu()
        assert torch.equal(scales[pages, offsets].cpu(), cs)
        if mode == "int8":
            assert torch.equal(got_q[~nan_q], cq[~nan_q])
            assert not got_q[nan_q].any()
        else:
            torch.testing.assert_close(Q.codes_to_float(got_q),
                                       Q.codes_to_float(cq), rtol=0,
                                       atol=0, equal_nan=True)
            assert torch.isnan(Q.codes_to_float(got_q)[nan_q]).all()


def _quant_session(dev, **kw):
    cfg = serve.ModelConfig(vocab_size=61, num_layers=2, d_model=64,
                            num_heads=2, max_len=64)
    conf = dict(slots=3, page_size=8, buckets=(8, 16), max_new=8,
                quant="int8", kv_quant="int8", spec_k=3, draft="layers:2")
    conf.update(kw)
    return serve.InferenceSession(serve.init_params(cfg, seed=3, device=dev),
                                  num_heads=2,
                                  config=serve.ServeConfig(**conf))


@pytest.mark.parametrize("quant,kv_quant", [("int8", ""), ("fp8", ""),
                                            ("", "int8"), ("", "fp8"),
                                            ("int8", "int8"),
                                            ("fp8", "fp8")])
def test_serve_quant_decode_bitexact_on_the_card(dev, quant, kv_quant):
    sess = _quant_session(dev, quant=quant, kv_quant=kv_quant, spec_k=0,
                          draft="")
    dq = sess.dequantized_params()
    rs = np.random.RandomState(11)
    seqs = {}
    for n in (5, 13):
        p = rs.randint(1, 61, size=n).tolist()
        slot = sess.try_alloc(n, 8)
        first, logits = sess.prefill(slot, p)
        ref = serve.reference_last_logits(dq, p, sess.model, 8,
                                          kv_quant=kv_quant)
        np.testing.assert_array_equal(logits, ref.cpu().numpy())
        seqs[slot] = p + [first]
    for _ in range(6):
        toks, logits = sess.step()
        for slot, seq in seqs.items():
            ref = serve.reference_last_logits(dq, seq, sess.model, 8,
                                              kv_quant=kv_quant)
            np.testing.assert_array_equal(logits[slot], ref.cpu().numpy())
            seq.append(toks[slot])
    per = sess.graph_report()["launches_per_replay"]["decode"]
    assert per == {("mi_linear_q" if quant else "mi_linear"): 9,
                   ("paged_attention_q" if kv_quant
                    else "paged_attention"): 2,
                   **({"kv_append_quantized": 2} if kv_quant else {})}


def test_serve_quant_graphs_replay_equal_eager_and_launches_follow(dev):
    """Under quant and kv_quant every captured entry point gives its eager
    function's outputs and code and scale writes bit for bit, and a
    scheduler run's launches of K3q, K2q and K9 are the replays times the
    launches recorded at capture."""
    sess = _quant_session(dev)
    caches = [sess.cache, sess.draft_cache]

    def pools():
        return [t.clone() for c in caches for t in c.pools().values()]

    def restore(saved):
        for a, b in zip([t for c in caches for t in c.pools().values()],
                        saved):
            a.copy_(b)

    def check(name, **values):
        exe = sess.executables[name]
        saved = pools()
        got = exe(**values)
        got = [t.clone() for t in (got if name != "draft" else [got])]
        after = pools()
        restore(saved)
        want = exe.fn(**exe.inputs)
        want = list(want) if name != "draft" else [want]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        assert all(torch.equal(a, b) for a, b in zip(pools(), after)), name

    rs = np.random.RandomState(3)
    for n in (5, 13):
        p = rs.randint(1, 61, size=n).tolist()
        slot = sess.try_alloc(n, 8)
        bucket = sess.bucket_for(n)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = p
        check("prefill_%d" % bucket, tokens=toks, length=n, offset=0,
              table_row=sess.cache.table_row(slot))
        sess.prefill(slot, p)
    w = sess.config.spec_window
    toks = rs.randint(1, 61, size=(3, w))
    check("verify", tokens=toks, lengths=sess.cache.device_lengths(),
          tables=sess.cache.device_tables())
    check("draft", tokens=toks, n_feed=np.asarray([1, w, 2], np.int32),
          lengths=sess.draft_cache.device_lengths(),
          tables=sess.draft_cache.device_tables())
    check("decode", tokens=toks[:, 0], lengths=sess.cache.device_lengths(),
          tables=sess.cache.device_tables())
    for slot in sess.active_slots():
        sess.release(slot)
    per = sess.graph_report()["launches_per_replay"]
    assert per["decode"] == {"mi_linear_q": 9, "paged_attention_q": 2,
                             "kv_append_quantized": 2}
    for exe in sess.executables.values():
        exe.replays = 0
    before = dict(_cuda.launches)
    reqs = [serve.Request(rid=i, prompt=rs.randint(1, 61, size=4 + 3 * i)
                          .tolist(), max_new=8) for i in range(4)]
    done, _ = serve.Scheduler(sess, policy="continuous").run(reqs)
    assert all(not r.failed and len(r.tokens) == 8 for r in done)
    rep = sess.graph_report()
    for kernel in ("mi_linear_q", "paged_attention_q",
                   "kv_append_quantized"):
        want = sum(rep["replays"][n] * per[n].get(kernel, 0) for n in per)
        assert want > 0 and \
            _cuda.launches[kernel] - before[kernel] == want, kernel
    for kernel in ("mi_linear", "paged_attention"):
        assert _cuda.launches[kernel] == before[kernel], kernel


def test_quant_wrappers_raise_instead_of_falling_back(dev):
    x = _randn(dev, 4, 64)
    rec = _qrecord(_randn(dev, 32, 64), "fp8")
    with pytest.raises(MXNetError, match="uint8 bytes"):
        L.mi_linear(x, {"q": rec["q"].view(torch.float8_e4m3fn),
                        "s": rec["s"]})
    with pytest.raises(MXNetError, match="scales"):
        L.mi_linear(x, {"q": rec["q"], "s": rec["s"][:5]})
    with pytest.raises(MXNetError, match="different devices"):
        L.mi_linear(x, {"q": rec["q"], "s": rec["s"].cpu()})
    with pytest.raises(MXNetError, match="not a code tensor"):
        L.mi_linear(x, {"q": rec["q"].short(), "s": rec["s"]})
    pool = torch.zeros(3, 8, 1, 64, dtype=torch.int8, device=dev)
    sc = torch.ones(3, 8, device=dev)
    tables = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    q = _randn(dev, 1, 1, 1, 64)
    with pytest.raises(MXNetError, match="scale pools"):
        A.paged_attention(q, pool, pool, tables, lengths, k_scale=sc,
                          v_scale=sc[:2])
    with pytest.raises(MXNetError, match="scale pools"):
        A.paged_attention(q, pool, pool, tables, lengths, k_scale=sc,
                          v_scale=sc.cpu())
    with pytest.raises(MXNetError, match="both alike"):
        A.paged_attention(q, pool, pool.view(torch.uint8), tables, lengths,
                          k_scale=sc, v_scale=sc)
    with pytest.raises(MXNetError, match="one-byte pools"):
        A.paged_attention(q, pool, pool, tables, lengths)
    with pytest.raises(MXNetError, match="out of the kernel's range"):
        big = torch.zeros(3, 8, 1, 320, dtype=torch.int8, device=dev)
        A.paged_attention(_randn(dev, 1, 1, 1, 320), big, big, tables,
                          lengths, k_scale=sc, v_scale=sc)
    rows = _randn(dev, 2, 1, 64)
    pages = torch.zeros(2, dtype=torch.int64, device=dev)
    with pytest.raises(MXNetError, match="int64"):
        Q.kv_append_quantized(pool, pool, sc, sc, pages.int(), pages, rows,
                              rows)
    with pytest.raises(MXNetError, match="scale pool"):
        Q.kv_append_quantized(pool, pool, sc.double(), sc, pages, pages,
                              rows, rows)
    with pytest.raises(MXNetError, match="different devices"):
        Q.kv_append_quantized(pool, pool, sc, sc, pages, pages, rows.cpu(),
                              rows)
    with pytest.raises(MXNetError, match="float32"):
        Q.kv_append_quantized(pool, pool, sc, sc, pages, pages,
                              rows.double(), rows)


# ---------------------------------------------------------------------------
# hybrid stacks: K10 (the SSM scan), K1 with a window, K2/K2q over rings
# ---------------------------------------------------------------------------
#
# K10 against its plain version bit for bit: the plain version runs the
# kernel's operations in its order (ops/ssm_ops.py), one rounding each.

from mxnet_tpu_torch.ops import ssm_ops as SSM  # noqa: E402


def _ssm_inputs(dev, s, t, h, d, seed=0, state_scale=0.1):
    q, k, v = (_randn(dev, s, t, h, d, seed=seed + i) for i in range(3))
    state0 = state_scale * _randn(dev, s, h, d, d, seed=seed + 3)
    return q, k, v, state0, SSM.ssm_decay(h, dev)


# decode S8 T1, prefill S1 T256, verify S8 W5 (serving's shapes), odd D
@pytest.mark.parametrize("s,t,h,d,collect", [(8, 1, 16, 128, False),
                                             (1, 256, 16, 128, False),
                                             (8, 5, 16, 128, True),
                                             (3, 9, 2, 40, True),
                                             (2, 7, 3, 256, False)])
def test_ssm_scan_kernel_matches_plain_bitwise(dev, s, t, h, d, collect):
    q, k, v, state0, gamma = _ssm_inputs(dev, s, t, h, d)
    valid = torch.ones((s, t), dtype=torch.bool, device=dev)
    valid[0, t // 2:] = False
    for rv in (None, valid):
        before = _cuda.launches["ssm_scan"]
        got = SSM.ssm_scan(q, k, v, state0, gamma, row_valid=rv,
                           collect=collect)
        assert _cuda.launches["ssm_scan"] == before + 1
        want = SSM.ssm_scan_plain(q, k, v, state0, gamma, row_valid=rv,
                                  collect=collect)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # in place: the state pool itself is state0 and the output
    pool = state0.clone()
    _, st = SSM.ssm_scan(q, k, v, pool, gamma, out_state=pool)
    assert st.data_ptr() == pool.data_ptr()
    assert torch.equal(pool, SSM.ssm_scan_plain(q, k, v, state0, gamma)[1])


# K10's edges: rows off its 32-row chunk (T 1, 31, 33, 257) with padded
# rows on a chunk boundary, head dims 40 to 256 (D = 256 halves the
# chunk to fit shared memory), and grids (S x H x D/16 or D/32 CTAs)
# below and above the card's SM count
@pytest.mark.parametrize("s,t,h,d", [(1, 1, 2, 40), (2, 31, 4, 64),
                                     (1, 33, 16, 128), (1, 257, 16, 128),
                                     (3, 257, 2, 256), (16, 33, 16, 256),
                                     (40, 1, 16, 128), (5, 16, 3, 64)])
def test_ssm_scan_kernel_edges_match_plain_bitwise(dev, s, t, h, d):
    q, k, v, state0, gamma = _ssm_inputs(dev, s, t, h, d, seed=t + d)
    valid = torch.ones((s, t), dtype=torch.bool, device=dev)
    valid[0, t // 2:] = False
    valid[s - 1, [r for r in (0, 15, 16, 31, 32) if r < t]] = False
    for rv in (None, valid):
        for collect in (False, True):
            before = _cuda.launches["ssm_scan"]
            got = SSM.ssm_scan(q, k, v, state0, gamma, row_valid=rv,
                               collect=collect)
            assert _cuda.launches["ssm_scan"] == before + 1
            want = SSM.ssm_scan_plain(q, k, v, state0, gamma, row_valid=rv,
                                      collect=collect)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    # in place, keeping every row's state
    pool = state0.clone()
    y, st, snaps = SSM.ssm_scan(q, k, v, pool, gamma, row_valid=valid,
                                collect=True, out_state=pool)
    assert st.data_ptr() == pool.data_ptr()
    want = SSM.ssm_scan_plain(q, k, v, state0, gamma, row_valid=valid,
                              collect=True)
    for a, b in zip((y, pool, snaps), want):
        assert torch.equal(a, b)


# D = 40 leaves rows 40-63 of a thread's range empty: they must stay out
# of the update, since 0 x inf is a NaN where the plain version has none
@pytest.mark.parametrize("t", [1, 33])
def test_ssm_scan_kernel_padded_rows_keep_an_infinite_v(dev, t):
    q, k, v, state0, gamma = _ssm_inputs(dev, 2, t, 2, 40, seed=t)
    q, k = q.abs(), k.abs()
    v[:, 0, :, 3] = float("inf")
    v[:, -1, :, 7] = -float("inf")
    for collect in (False, True):
        got = SSM.ssm_scan(q, k, v, state0, gamma, collect=collect)
        want = SSM.ssm_scan_plain(q, k, v, state0, gamma, collect=collect)
        assert torch.isinf(want[0]).any()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_ssm_scan_kernel_chunked_serial_and_verify_agree_bitwise(dev):
    s, t, h, d = 2, 24, 16, 128
    q, k, v, state0, gamma = _ssm_inputs(dev, s, t, h, d, seed=5)
    y_full, s_full = SSM.ssm_scan(q, k, v, state0, gamma)
    _, s_mid = SSM.ssm_scan(q[:, :16], k[:, :16], v[:, :16], state0, gamma)
    y_b, s_chunk = SSM.ssm_scan(q[:, 16:], k[:, 16:], v[:, 16:], s_mid,
                                gamma)
    assert torch.equal(s_chunk, s_full) and torch.equal(y_b, y_full[:, 16:])
    state, serial = state0.clone(), []
    for i in range(t):
        y_i, _ = SSM.ssm_scan(q[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1],
                              state, gamma, out_state=state)
        assert torch.equal(y_i[:, 0], y_full[:, i])
        serial.append(state.clone())
    assert torch.equal(state, s_full)
    y_w, s_w, snaps = SSM.ssm_scan(q[:, 11:16], k[:, 11:16], v[:, 11:16],
                                   serial[10], gamma, collect=True)
    for j in range(5):
        assert torch.equal(snaps[j], serial[11 + j])
    assert torch.equal(s_w, serial[15])


def test_flash_window_kernel_matches_plain_and_window_zero_bits(dev):
    """K1 with a window against its plain version (atol 1e-5), and a
    window covering the whole sequence gives the unwindowed entry's bits
    (the window only raises lower bounds)."""
    for t, d, block, window in ((1024, 128, 16, 128), (37, 40, 8, 5),
                                (200, 64, 128, 33)):
        q, k, v = (_randn(dev, 1, 4, t, d, seed=s) for s in range(3))
        before = dict(_cuda.launches)
        got = A.flash_attention(q, k, v, block=block, window=window)
        assert _cuda.launches["flash_attention_window"] == \
            before["flash_attention_window"] + 1
        assert _cuda.launches["flash_attention"] == before["flash_attention"]
        want = A.flash_attention_plain(q, k, v, True, 1.0 / d ** 0.5, block,
                                       mi=True, window=window)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        for causal in (True, False):
            assert torch.equal(
                A.flash_attention(q, k, v, causal=causal, block=block,
                                  window=t),
                A.flash_attention(q, k, v, causal=causal, block=block))


def _ring_pools(rows, slots_last, rp, page):
    """Rings of ``rp`` pages a slot holding, for each (T, ...) array of
    ``rows`` (keys, values, and their scales over codes), the rows at
    positions 0 .. last (written in order, later over earlier), as serving
    writes them.  Rows nothing wrote hold NaN (fp32 and scales) or random
    codes."""
    s = len(slots_last)
    pools = []
    for x in rows:
        shape = (s * rp, page) + tuple(x.shape[1:])
        if x.dtype.is_floating_point:
            pools.append(torch.full(shape, float("nan"), device=x.device))
        else:
            pools.append(torch.randint(0, 100, shape, dtype=x.dtype,
                                       device=x.device))
    for slot, last in enumerate(slots_last):
        p = torch.arange(last + 1, device=rows[0].device)
        keep = p >= last + 1 - rp * page  # the latest write of each row
        p = p[keep]
        pg, off = slot * rp + (p // page) % rp, p % page
        for pool, x in zip(pools, rows):
            pool[pg, off] = x[p]
    return pools


def _ring_view(pb_max, rp, page, dev):
    from mxnet_tpu_torch.serve.model import ring_table

    pb = torch.tensor(pb_max, device=dev)
    return ring_table(torch.arange(len(pb_max), device=dev), pb, rp, page)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_paged_ring_rows_equal_windowed_flash_rows_bitwise(dev, mode):
    """K2 (K2q over one-byte rings) through rotated ring tables gives K1's
    windowed rows bit for bit at decode (8 slots, rings that have and
    have not wrapped), at the verify (5 rows a slot) and at a 256-row
    prefill; rows nothing wrote are NaN (fp32) and never read."""
    page, h, d, t, window = 16, 16, 128, 1024, 128
    rp = -(-(window + 256 - 1) // page) + 1  # serving's rings: 25 pages
    q, k, v = (_randn(dev, 1, h, t, d, seed=30 + s) for s in range(3))
    rows = [k[0].transpose(0, 1), v[0].transpose(0, 1)]  # (T, h, d)
    if mode:
        (kc, ks), (vc, vs) = (Q.kv_quantize_rows(x, mode) for x in rows)
        rows = [kc, vc, ks, vs]
        k, v = _fake_quant(k, mode), _fake_quant(v, mode)
    full = A.flash_attention(q, k, v, causal=True, block=page, window=window)
    name = "paged_attention_q_ring" if mode else "paged_attention_ring"

    def pools_of(lasts):
        pools = _ring_pools(rows, lasts, rp, page)
        if not mode:
            return pools, {}
        return pools[:2], dict(k_scale=pools[2], v_scale=pools[3])

    # decode: horizons n (position n - 1 newest), pb_max = (n - 1) // page
    hz = [1, page, page + 1, 200, rp * page, rp * page + 7, 900, t]
    pools, kw = pools_of([n - 1 for n in hz])
    table, k_pos0 = _ring_view([(n - 1) // page for n in hz], rp, page, dev)
    qd = torch.stack([q[0, :, n - 1] for n in hz])[:, :, None].contiguous()
    before = _cuda.launches[name]
    out = A.paged_attention(qd, *pools, table, torch.tensor(
        hz, dtype=torch.int32, device=dev), window=window, k_pos0=k_pos0,
        **kw)
    assert _cuda.launches[name] == before + 1
    for i, n in enumerate(hz):
        assert torch.equal(out[i, :, 0], full[0, :, n - 1]), n
    # verify: committed L, rows L .. L + 4 written, pb_max (L + 4) // page
    committed = [0, 3, page - 1, 140, 399, 400, 700, t - 5]
    pools, kw = pools_of([c + 4 for c in committed])
    table, k_pos0 = _ring_view([(c + 4) // page for c in committed], rp,
                               page, dev)
    hor = np.asarray(committed)[:, None] + np.arange(5) + 1
    qv = torch.stack([torch.stack([q[0, :, n - 1] for n in row], 1)
                      for row in hor]).contiguous()
    out = A.paged_attention(qv, *pools, table, torch.from_numpy(
        hor.astype(np.int32)).to(dev), window=window, k_pos0=k_pos0, **kw)
    for i, row in enumerate(hor):
        for j, n in enumerate(row):
            assert torch.equal(out[i, :, j], full[0, :, n - 1]), (i, j)
    # prefill: 256 rows at offset o (page-aligned), all written first
    for offset in (0, 256, 768):
        pools, kw = pools_of([offset + 255])
        table, k_pos0 = _ring_view([(offset + 255) // page], rp, page, dev)
        qrows = q[:, :, offset:offset + 256].contiguous()
        horizons = torch.arange(offset + 1, offset + 257, dtype=torch.int32,
                                device=dev)[None]
        out = A.paged_attention(qrows, *pools, table, horizons,
                                window=window, k_pos0=k_pos0, **kw)
        assert torch.equal(out[0], full[0, :, offset:offset + 256]), offset


def test_paged_ring_entry_at_window_zero_gives_the_plain_entrys_bits(dev):
    """The ring entries with window 0 and k_pos0 0 run the plain entries'
    operations: the same bits, at decode, verify and prefill, fp32 and
    int8."""
    page, h, d, n_pages = 16, 16, 128, 20
    q, full, k_pool, v_pool, table = _paged_sequence(dev, page, h, d,
                                                     n_pages, n_pages + 2)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    for nq in (1, 5, 64):
        rows = q[:, :, 100:100 + nq].contiguous()
        hor = torch.arange(101, 101 + nq, dtype=torch.int32,
                           device=dev)[None]
        a = A.paged_attention(rows, k_pool, v_pool, table[None], hor)
        b = A.paged_attention(rows, k_pool, v_pool, table[None], hor,
                              k_pos0=zero)
        assert torch.equal(a, b), nq


def _hybrid_session(dev, **kw):
    cfg = serve.ModelConfig(vocab_size=61, num_layers=3, d_model=64,
                            num_heads=2, max_len=128)
    conf = dict(slots=3, page_size=8, buckets=(8, 16), max_new=24,
                layers="full,window,ssm", window=8)
    conf.update(kw)
    return serve.InferenceSession(serve.init_params(cfg, seed=3, device=dev),
                                  num_heads=2,
                                  config=serve.ServeConfig(**conf))


@pytest.mark.parametrize("layers,kv_quant", [("full,window,ssm", ""),
                                             ("window,ssm", "int8"),
                                             ("full,window,ssm", "fp8")])
def test_serve_hybrid_decode_bitexact_on_the_card(dev, layers, kv_quant):
    """A hybrid stack's prefill and decode graphs give the oracle's logits
    bit for bit past the ring's wrap; a decode replay launches K3, K2 (full
    layers), K2 over rings (window layers) and K10 (SSM layers)."""
    sess = _hybrid_session(dev, layers=layers, kv_quant=kv_quant)
    rs = np.random.RandomState(11)
    seqs = {}
    for n in (5, 13, 21):
        p = rs.randint(1, 61, size=n).tolist()
        slot = sess.try_alloc(n, 16, resume=True)
        first, logits = sess.prefill(slot, p)
        ref = serve.reference_last_logits(sess.params, p, sess.model, 8,
                                          kv_quant=kv_quant)
        np.testing.assert_array_equal(logits, ref.cpu().numpy())
        seqs[slot] = p + [first]
    for _ in range(12):
        toks, logits = sess.step()
        for slot, seq in seqs.items():
            ref = serve.reference_last_logits(sess.params, seq, sess.model,
                                              8, kv_quant=kv_quant)
            np.testing.assert_array_equal(logits[slot], ref.cpu().numpy())
            seq.append(toks[slot])
    kinds = sess.model.kinds
    per = sess.graph_report()["launches_per_replay"]["decode"]
    suffix = "_q" if kv_quant else ""
    want = {"mi_linear": 4 * len(kinds) + 1,
            "paged_attention%s_ring" % suffix: kinds.count("window"),
            "ssm_scan": kinds.count("ssm")}
    if "full" in kinds:
        want["paged_attention%s" % suffix] = kinds.count("full")
    if kv_quant:
        want["kv_append_quantized"] = len(kinds) - kinds.count("ssm")
    assert per == want


def test_serve_hybrid_spec_graphs_and_launches_follow_replays(dev):
    """Speculation over a hybrid stack on the card: the streams equal
    plain decode's, each slot's committed SSM state is plain decode's,
    and the launches of K1-free serving kernels are replays times
    recorded."""
    plain = _hybrid_session(dev)
    spec = _hybrid_session(dev, spec_k=3, draft="layers:2")
    assert spec.draft_model.kinds == ("full", "window")
    rs = np.random.RandomState(4)
    prompts = [rs.randint(1, 61, size=4 + 5 * i).tolist() for i in range(3)]
    streams = []
    for sess in (plain, spec):
        reqs = [serve.Request(rid=i, prompt=p, max_new=16)
                for i, p in enumerate(prompts)]
        for exe in sess.executables.values():
            exe.replays = 0
        before = dict(_cuda.launches)
        done, _ = serve.Scheduler(sess, policy="continuous").run(reqs)
        assert all(not r.failed for r in done)
        streams.append([r.tokens for r in done])
        rep = sess.graph_report()
        per = rep["launches_per_replay"]
        for kernel in ("mi_linear", "paged_attention", "paged_attention_ring",
                       "ssm_scan"):
            want = sum(rep["replays"][n] * per[n].get(kernel, 0)
                       for n in per)
            assert want > 0 and \
                _cuda.launches[kernel] - before[kernel] == want, kernel
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# ops and optimizers: the card against the CPU
# ---------------------------------------------------------------------------

OPT_CASES = [("sgd", dict(momentum=0.9)), ("nag", dict(momentum=0.9)),
             ("dcasgd", dict(momentum=0.9)), ("adam", {}), ("adagrad", {}),
             ("rmsprop", {}), ("rmsprop", dict(centered=True)),
             ("adadelta", {}), ("ftrl", {}), ("adamax", {}), ("nadam", {}),
             ("test", {}), ("sgd", dict(momentum=0.9, multi_precision=True))]


@pytest.mark.parametrize("name,kw", OPT_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(OPT_CASES)])
def test_fused_update_on_the_card_matches_the_cpu(dev, name, kw):
    """Three ``fused_update`` steps of every optimizer (SGD also with
    bf16 weights and fp32 masters) on the card and on the CPU from the
    same weights and gradients, with ``rescale_grad``, ``clip_gradient``
    and weight decay: weights and states within rtol 1e-5, atol 1e-6 (the
    same elementwise fp32 arithmetic; the card's sqrt, division and pow
    are IEEE or within an ulp)."""
    from mxnet_tpu_torch import optimizer as opt

    mp = kw.get("multi_precision", False)
    o = opt.create(name, learning_rate=0.1, wd=0.01, rescale_grad=0.5,
                   clip_gradient=1.0, **kw)
    w = _randn(dev, 64, 33, seed=1)
    if mp:
        w = w.bfloat16()
    cw, gw = w.cpu(), w
    cs, gs = o.init_fused_state(cw), o.init_fused_state(gw)
    for t in range(1, 4):
        g = 3 * _randn(dev, 64, 33, seed=10 + t)
        cw, cs = o.fused_update(cw, g.cpu(), cs, 0.1, 0.01, t, None)
        gw, gs = o.fused_update(gw, g, gs, 0.1, 0.01, t, None)
    assert gw.is_cuda and gw.dtype == w.dtype
    torch.testing.assert_close(gw.cpu(), cw, rtol=1e-5, atol=1e-6)
    for a, b in zip(gs if isinstance(gs, tuple) else (gs,),
                    cs if isinstance(cs, tuple) else (cs,)):
        if b is not None:
            assert a.is_cuda
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


def test_ops_put_their_outputs_on_the_inputs_device(dev):
    """Every case of the sweep table (``testing/op_specs.py``: every op
    the port registers, the 123 of this slice among them): outputs on
    the card; an op without tensor inputs makes its output on the
    context's device (``mx.gpu()``)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import imperative_invoke
    from mxnet_tpu_torch.testing import op_specs

    with mx.gpu(0):
        for name in sorted(op_specs.SPECS):
            inputs, attrs = op_specs.SPECS[name]
            ins = [mx.nd.array(np.asarray(x), dtype=np.asarray(x).dtype)
                   for x in inputs]
            for out in imperative_invoke(name, ins, dict(attrs)):
                assert out._data.is_cuda, name
                assert out.context == mx.gpu(0), name


def test_adam_train_step_at_two_layers_runs_k7_k8_and_learns(dev):
    """The optim phase's step (bf16 ``TrainStep`` under Adam with
    ``clip_global_norm`` and a cosine schedule) at 2 layers, d_model 256:
    K7 and K8 once per layer a step, and over 6 steps on one batch the
    cross-entropy falls."""
    from mxnet_tpu_torch import fused, lr_scheduler
    from mxnet_tpu_torch.models import transformer

    cfg = dict(vocab_size=512, num_layers=2, d_model=256, num_heads=2,
               seq_len=128)
    step = fused.TrainStep(
        transformer.get_symbol(**cfg), optimizer="adam",
        optimizer_params=dict(learning_rate=3e-3, wd=0.01,
                              clip_global_norm=1.0, rescale_grad=0.5),
        compute_dtype="bfloat16", device=dev)
    state = list(step.init_state({"data": (2, 128),
                                  "softmax_label": (2, 128)}, seed=0))
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(0, 256, (2, 128)).astype(
        np.float32)).to(dev)
    sched = lr_scheduler.CosineScheduler(max_update=16, base_lr=3e-3,
                                         warmup_steps=2)
    before = dict(_cuda.launches)
    ces = []
    for t in range(1, 7):
        *state, outs = step(*state, {"data": toks, "softmax_label": toks},
                            None, lr=sched(t), t=t)
        p = outs[0].float().gather(1, toks.long().reshape(-1, 1))
        ces.append(float(-torch.log(p).mean()))
    for k in ("flash_attention_sm90", "flash_attention_backward_sm90"):
        assert _cuda.launches[k] - before[k] == 6 * cfg["num_layers"], k
    assert all(np.isfinite(ces)) and ces[-1] < ces[0], ces
    assert all(bool(torch.isfinite(v).all()) for v in state[0].values())


def _multistep_mlp(mx, bn=False):
    net = mx.sym.Variable("data")
    if bn:
        net = mx.sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                                 num_filter=8, name="conv1")
        net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.Convolution(net, kernel=(3, 3), num_filter=8,
                                 name="conv2")
        net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn2")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=64, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax", normalization="batch")


def _super_batch(dev, K, shape, seed=0):
    rs = np.random.RandomState(seed)
    return {"data": torch.from_numpy(rs.randn(K, *shape).astype(
                np.float32)).to(dev),
            "softmax_label": torch.from_numpy(rs.randint(
                0, 10, (K, shape[0])).astype(np.float32)).to(dev)}


def _clone_state(state):
    def one(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(one(e) for e in x)
        return x.clone()
    return [{k: one(v) for k, v in d.items()} for d in state]


def _assert_bitwise(got, want):
    for g, w in zip(got[:3], want[:3]):
        for k in w:
            gs = g[k] if isinstance(g[k], tuple) else (g[k],)
            ws = w[k] if isinstance(w[k], tuple) else (w[k],)
            for a, b in zip(gs, ws):
                if b is not None:
                    assert torch.equal(a, b), k
    for a, b in zip(got[3], want[3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, rescale_grad=1 / 32.)),
    ("adam", dict(learning_rate=0.01, wd=0.01, clip_global_norm=0.5,
                  rescale_grad=1 / 32.)),
])
def test_multistep_capture_equals_its_eager_loop_bitwise(dev, optimizer,
                                                         params):
    """A 4-step call captured as one CUDA graph gives the bits of the
    same 4 steps run eagerly (``run_eager``) from the same state; the
    next replay, at another lr and first step number, again equals the
    eager loop at those values (neither is frozen at capture)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fused

    step = fused.TrainStep(_multistep_mlp(mx), optimizer=optimizer,
                           optimizer_params=params, steps_per_call=4,
                           device=dev)
    state = step.init_state({"data": (32, 24), "softmax_label": (32,)})
    batch = _super_batch(dev, 4, (32, 24))
    want = step.run_eager(*_clone_state(state), batch, None, 0.1, 1)
    got = step(*state, batch, None, lr=0.1, t=1)
    _assert_bitwise(got, want)
    batch2 = _super_batch(dev, 4, (32, 24), seed=1)
    want2 = step.run_eager(*_clone_state(got[:3]), batch2, None, 0.03, 40)
    got2 = step(*got[:3], batch2, None, lr=0.03, t=40)
    _assert_bitwise(got2, want2)
    assert step.graph_report()[0]["replays"] == 2 and step._t == 43
    assert not torch.equal(got2[0]["fc1_weight"], want[0]["fc1_weight"])


def test_multistep_batchnorm_launches_are_replays_times_recorded(dev):
    """K5/K6 inside a captured 2-step call: each records once per
    BatchNorm per inner step at capture, and a run's launches equal the
    replays times those."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fused

    step = fused.TrainStep(_multistep_mlp(mx, bn=True), steps_per_call=2,
                           optimizer_params=dict(learning_rate=0.05,
                                                 momentum=0.9),
                           compute_dtype="bfloat16", device=dev)
    shapes = {"data": (16, 3, 12, 12), "softmax_label": (16,)}
    stats = step.compile(shapes)
    assert stats["launches"] == {"bn_stats": 4, "bn_grad_sums": 4}
    state = step.init_state(shapes, seed=1)
    before = dict(_cuda.launches)
    for call in range(3):
        state = step(*state, _super_batch(dev, 2, shapes["data"],
                                          seed=call), None)[:3]
    for k in ("bn_stats", "bn_grad_sums"):
        assert _cuda.launches[k] - before[k] == 3 * 4, k
    assert len(step.graph_report()) == 1
    assert all(bool(torch.isfinite(v).all()) for v in state[1].values())


def test_multistep_module_set_params_is_seen_by_the_next_replay(dev):
    """``Module.set_params`` between two 2-step calls rebinds the
    parameters; the next replay writes them into the graph's buffers
    first, so it equals the eager loop from the values set."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fused

    ctx = mx.gpu(0)
    mod = mx.mod.Module(_multistep_mlp(mx), context=ctx)
    mod.bind([("data", (32, 24))], [("softmax_label", (32,))])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", steps_per_call=2,
                       optimizer_params=dict(learning_rate=0.1,
                                             momentum=0.9))
    b1, b2 = (_super_batch(dev, 2, (32, 24), seed=s) for s in (0, 1))

    def fb(b):
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.NDArray(b["data"], ctx)],
            [mx.nd.NDArray(b["softmax_label"], ctx)]))

    fb(b1)
    rs = np.random.RandomState(7)
    new = {k: mx.nd.array(rs.randn(*v.shape).astype(np.float32) * 0.1, ctx)
           for k, v in mod.get_params()[0].items()}
    mod.set_params(new, {})
    params = {k: v._data.clone() for k, v in new.items()}
    states = _clone_state([mod._fused_states])[0]
    want = mod._fused.run_eager(params, {}, states, b2, None, 0.1, 3)
    fb(b2)
    assert mod._optimizer.num_update == 4
    got = {k: v._data for k, v in mod.get_params()[0].items()}
    for k, v in want[0].items():
        assert torch.equal(got[k], v), k
    assert isinstance(mod._fused, fused.TrainStep)
    assert mod._fused.graph_report()[0]["replays"] == 2


# ---------------------------------------------------------------------------
# the serving front: checkpoints, replicas, the gateway
# ---------------------------------------------------------------------------

def _front_params(dev):
    cfg = serve.ModelConfig(vocab_size=61, num_layers=2, d_model=32,
                            num_heads=2, max_len=64)
    return serve.init_params(cfg, seed=3, device=dev)


FRONT_CONF = dict(slots=3, page_size=8, buckets=(8, 16), max_new=8)


def _front_requests(n=8):
    return [serve.Request(rid=i, prompt=[1 + i, 2, 3], max_new=6)
            for i in range(n)]


def test_from_checkpoint_places_every_parameter_on_the_card(dev, tmp_path):
    """A checkpoint saved from the card loads back onto it (the default
    device) and serves the oracle's logits bit for bit."""
    from mxnet_tpu_torch import checkpoint

    params = _front_params(dev)
    checkpoint.CheckpointManager(str(tmp_path), prefix="lm").save(
        epoch=1, arg_params=params)
    sess = serve.InferenceSession.from_checkpoint(
        str(tmp_path), prefix="lm", num_heads=2,
        config=serve.ServeConfig(**FRONT_CONF))
    assert sess.device.type == "cuda"
    for k, v in sess.params.items():
        assert v.is_cuda and torch.equal(v, params[k]), k
    slot = sess.try_alloc(7, 4)
    _, logits = sess.prefill(slot, list(range(1, 8)))
    ref = serve.reference_last_logits(sess.params, list(range(1, 8)),
                                      sess.model, 8)
    np.testing.assert_array_equal(logits, ref.cpu().numpy())
    assert sess.memory_analysis("decode")["temp_size_in_bytes"] >= 0
    assert sess.memory_analysis("decode")["output_size_in_bytes"] > 0


def test_two_replicas_on_the_card_give_a_single_sessions_streams(dev):
    """Two sessions on one card keep their own pools and graphs: a
    two-replica set (one replica killed mid-run) streams what one
    session does, and each replica's launches are its replays times
    recorded."""
    import os

    from mxnet_tpu_torch.testing import faults

    params = _front_params(dev)
    conf = serve.ServeConfig(**FRONT_CONF)
    single = serve.InferenceSession(params, num_heads=2, config=conf)
    want, _ = serve.Scheduler(single).run(_front_requests())
    rs = serve.ReplicaSet(params, 2, config=conf, replicas=2,
                          rejoin_backoff_s=30.0)
    a, b = (r.session for r in rs.replicas)
    assert a.cache.k_pool.data_ptr() != b.cache.k_pool.data_ptr()
    assert a.executables["decode"].outputs[1].data_ptr() != \
        b.executables["decode"].outputs[1].data_ptr()
    before = dict(_cuda.launches)
    os.environ["MXNET_FAULT_INJECT"] = "serve_replica_kill:kill:after=5"
    faults.reset()
    try:
        out, _ = rs.run(_front_requests())
    finally:
        os.environ.pop("MXNET_FAULT_INJECT", None)
        faults.reset()
    assert rs.counters["deaths"] == 1
    assert {r.rid: r.tokens for r in out} == \
        {r.rid: r.tokens for r in want}
    want_k3 = 0
    for sess in (a, b):
        rep = sess.graph_report()
        want_k3 += sum(rep["replays"][n] *
                       rep["launches_per_replay"][n].get("mi_linear", 0)
                       for n in rep["replays"])
    assert _cuda.launches["mi_linear"] - before["mi_linear"] == want_k3


def test_gateway_round_trip_on_the_card(dev):
    """One request over HTTP/SSE to a gateway whose dispatch thread
    replays graphs captured on this thread: the stream equals the
    in-process run's."""
    import http.client
    import json

    params = _front_params(dev)
    conf = serve.ServeConfig(**FRONT_CONF)
    sess = serve.InferenceSession(params, num_heads=2, config=conf)
    want, _ = serve.Scheduler(sess).run(_front_requests(1))
    sess.reset_cold()
    baseline = sess.state_report()
    gw = serve.Gateway(sess, host="127.0.0.1", port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"rid": 0, "prompt": [1, 2, 3], "max_new": 6}))
        resp = conn.getresponse()
        body = resp.read().decode()
        conn.close()
    finally:
        gw.stop()
    assert resp.status == 200
    events = [json.loads(ln[len("data: "):]) for ln in body.split("\n\n")
              if ln.startswith("data: ")]
    assert [e["token"] for e in events if "token" in e] == want[0].tokens
    assert events[-1]["done"] and events[-1]["tokens"] == want[0].tokens
    assert sess.state_report() == baseline


# -- fp8 training: K12 (scaled cast) and K11 (fp8 GEMM) ---------------------

# K11 against its plain version (the codes decoded to fp32, a full fp32
# matmul, then the scales).  The products are exact, but Hopper's fp8
# wgmma cuts each addend of a k32 step 13 bits below the step's largest
# exponent (measured by mxnet_tpu_torch/testing/fp8_accum.py), and K11
# adds each 128-deep stage into fp32: an output may differ by
# fp8_ops.fp8_gemm_error_bound, derived from those cuts in the header of
# csrc/fp8_gemm.cu (~1.7e-2 of fp8_gemm_magnitude, the sum of its
# |products| where no code is subnormal; errors of 1.2e-4 to 3.1e-4
# measured over random signs, 1.5e-3 over one sign: NVIDIA H100 80GB
# HBM3, 700 W), plus one bf16 rounding of a bf16 output.  That bound is
# a worst case, loose against a kernel that drops part of its sum; so a
# sample of each product's outputs must also equal the emulation of the
# measured sum (testing/fp8_accum.py::emulate_k11) exactly.


def _fp8_operand(dev, rows, cols, seed, dtype=torch.bfloat16):
    x = _randn(dev, rows, cols, seed=seed) * (10.0 ** (seed % 3 - 1))
    return x.to(dtype)


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [(37, 21), (1, 5), (130, 200),
                                       (8192, 2048)])
def test_fp8_cast_kernel_equals_plain_bitwise(dev, kind, dtype, rows, cols):
    from mxnet_tpu_torch.ops import fp8_ops as F8

    x = _fp8_operand(dev, rows, cols, rows + cols, getattr(torch, dtype))
    flat = x.view(-1)
    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                             float("nan"), 1e30, -1e30], device=dev)
    flat[:min(7, flat.numel())] = specials[:min(7, flat.numel())].to(x.dtype)
    scale = torch.tensor(0.0371, device=dev)
    before = _cuda.launches["fp8_cast"]
    got = F8.fp8_cast(x, scale, kind, codes=True, transposed=True)
    amax_only = F8.fp8_cast(x, None, kind, codes=False)
    assert _cuda.launches["fp8_cast"] == before + 2
    want = F8.fp8_cast_plain(x, scale, kind, codes=True, transposed=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a in (got[2], amax_only[2]):
        assert a.isnan().item() == want[2].isnan().item()
    # without the NaN, the exact max
    flat[4] = 0.0
    got = F8.fp8_cast(x, scale, kind, codes=False)[2]
    assert torch.equal(got, F8.fp8_cast_plain(x, scale, kind,
                                              codes=False)[2])


def _boundary_values(kind, scale):
    """Values whose quotient by ``scale`` lies on a rounding boundary
    between two codes of ``kind`` or within two fp32 ulps of one, both
    signs; qmax and its neighbours, values past it; +-0, +-Inf, NaN of
    both signs and fp32 subnormals (fp32)."""
    from mxnet_tpu_torch.ops import fp8_ops as F8

    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    vals = F8.decode(codes, kind)
    vals = torch.unique(vals[torch.isfinite(vals) & (vals >= 0)])
    mids = (vals[1:] + vals[:-1]) / 2  # exact in fp32
    near = (mids * scale).view(torch.int32)
    steps = torch.tensor([-2, -1, 0, 1, 2], dtype=torch.int32)
    around = (near[:, None] + steps).reshape(-1).view(torch.float32)
    qmax = torch.tensor(F8.QMAX[kind] * scale)
    edge = (qmax.view(torch.int32) + steps).view(torch.float32)
    special = torch.tensor([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                            0x7FC00000, 0xFFC00000, 0x00000001, 0x80000001,
                            0x00400000, 0x807FFFFF], dtype=torch.int64) \
        .to(torch.int32).view(torch.float32)
    pos = torch.cat([around, edge, edge * 4.0, mids * scale])
    return torch.cat([pos, -pos, special])


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols,offset", [(37, 203, 0), (130, 264, 0),
                                              (1, 5, 0), (67, 256, 1)])
@pytest.mark.parametrize("scale", [0.5, 0.0371])
def test_fp8_cast_bit_equal_at_code_boundaries_and_specials(
        dev, kind, dtype, rows, cols, offset, scale):
    """K12 against its plain version, bit for bit, on an operand seeded
    with values at and beside the codes' rounding boundaries (exact ties
    at a power-of-two scale), qmax, saturation, signed zeros, infinities,
    NaN of both signs and subnormals; rows and columns off the 8-value
    run; an operand whose base is off 16 bytes (``offset``: the scalar
    loads); each output alone and together; the amax with and without a
    NaN."""
    from mxnet_tpu_torch.ops import fp8_ops as F8

    dt = getattr(torch, dtype)
    vals = _boundary_values(kind, scale)
    n = rows * cols
    rs = np.random.RandomState(rows + cols + kind)
    fill = torch.from_numpy(rs.randn(n).astype(np.float32)) * scale * 20
    idx = torch.from_numpy(rs.permutation(n)[:min(n, vals.numel())])
    fill[idx] = vals[:idx.numel()]
    if n < vals.numel():  # a tiny operand still gets a NaN and an Inf
        fill[:2] = torch.tensor([float("nan"), -float("inf")])
    flat = torch.zeros(n + offset, dtype=dt, device=dev)
    flat[offset:] = fill.to(dev).to(dt)
    x = flat[offset:].view(rows, cols)
    s = torch.tensor(scale, device=dev)
    for kw in (dict(codes=True, transposed=True, amax=True),
               dict(codes=True, transposed=False, amax=False),
               dict(codes=False, transposed=True, amax=True),
               dict(codes=False, transposed=False, amax=True)):
        got = F8.fp8_cast(x, s, kind, **kw)
        want = F8.fp8_cast_plain(x, s, kind, **kw)
        for g, w in zip(got[:2], want[:2]):
            assert (g is None) == (w is None)
            assert g is None or torch.equal(g, w)
        if kw["amax"]:  # a NaN's payload is not part of the contract
            assert got[2].isnan().item() == want[2].isnan().item()
            assert got[2].isnan().item() or torch.equal(got[2], want[2])
    # the amax without the NaNs: the exact max
    x.masked_fill_(torch.isnan(x), 0.0)
    got = F8.fp8_cast(x, None, kind, codes=False)[2]
    assert torch.equal(got, F8.fp8_cast_plain(x, None, kind,
                                              codes=False)[2])


def _gemm_case(dev, M, N, K, a_kind, b_kind, seed=0):
    from mxnet_tpu_torch.ops import fp8_ops as F8

    a = F8.fp8_cast(_fp8_operand(dev, M, K, seed), torch.tensor(
        0.01, device=dev), a_kind, amax=False)[0]
    b = F8.fp8_cast(_fp8_operand(dev, N, K, seed + 1), torch.tensor(
        0.02, device=dev), b_kind, amax=False)[0]
    return a, b, torch.tensor(0.01, device=dev), torch.tensor(0.02,
                                                               device=dev)


# K11's shapes: ragged M, N and K (K off the 128-deep stage), M under one
# tile, more tiles than the card has SMs (33 x 33, 17 x 9: the persistent
# loop's uneven last round), and N at both epilogues — the TMA store
# (output rows of a multiple of 16 bytes: N = 2048, 4160, 1000, and N =
# 260 or 1100 in fp32) and the stores from registers (N = 21, 3, 1030,
# and N = 260 or 1100 in bf16)
@pytest.mark.parametrize("a_kind,b_kind", [(0, 0), (1, 0), (0, 1)])
@pytest.mark.parametrize("M,N,K", [(37, 21, 40), (5, 3, 16),
                                   (130, 260, 300), (8192, 2048, 2048),
                                   (4224, 4160, 2048), (2100, 1100, 160),
                                   (1000, 1030, 272), (100, 1000, 2000)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_fp8_gemm_kernel_matches_plain_and_reruns_bitwise(
        dev, a_kind, b_kind, M, N, K, out_dtype):
    from mxnet_tpu_torch.ops import fp8_ops as F8

    a, b, sa, sb = _gemm_case(dev, M, N, K, a_kind, b_kind, seed=M)
    odt = getattr(torch, out_dtype)
    before = _cuda.launches["fp8_gemm"]
    got = F8.fp8_gemm(a, b, a_kind, b_kind, sa, sb, odt)
    assert _cuda.launches["fp8_gemm"] == before + 1
    assert got.dtype == odt and tuple(got.shape) == (M, N)
    want = F8.fp8_gemm_plain(a, b, a_kind, b_kind, sa, sb, torch.float32)
    mag = F8.fp8_gemm_magnitude(a, b, a_kind, b_kind, sa, sb)
    bound = F8.fp8_gemm_error_bound(
        mag, K, want if odt == torch.bfloat16 else None)
    excess = ((got.float() - want).abs() - bound).max().item()
    assert excess <= 0, excess
    # the bound is a worst case; the measured sum holds each output
    # exactly: a sample equal to the emulation of fp8 wgmma's sum
    bad, sampled = fp8_accum.sample_mismatches(a, b, a_kind, b_kind, sa, sb,
                                               got, seed=M + K)
    assert bad == 0, (bad, sampled)
    assert torch.equal(F8.fp8_gemm(a, b, a_kind, b_kind, sa, sb, odt), got)


def test_fp8_dot_on_the_card_matches_the_cpu(dev):
    """The autograd function (K12 casts, K11 products) against the same
    function on the CPU (the plain versions), forward and both
    gradients, fp32: relative L2 within 5e-4, the fp8 wgmma's rounding
    of each k32 step (see fp8_ops.fp8_gemm_error_bound; 1.1e-4 measured)."""
    from mxnet_tpu_torch import quantize as Q

    rs = np.random.RandomState(0)
    x = rs.randn(4, 33, 96).astype(np.float32)
    w = rs.randn(80, 96).astype(np.float32)
    cot = rs.randn(4, 33, 80).astype(np.float32)
    res = []
    for d in (dev, torch.device("cpu")):
        tx = torch.from_numpy(x).to(d).requires_grad_()
        tw = torch.from_numpy(w).to(d).requires_grad_()
        scales = torch.tensor([[0.01, 0.005]], device=d)
        with Q.fp8_trace(scales) as tr:
            out = Q.fp8_apply_dot(tx, tw, "fc", 1)
        (out * torch.from_numpy(cot).to(d)).sum().backward()
        res.append([t.detach().cpu() for t in (out, tx.grad, tw.grad,
                                               tr.amax[0])])
    for g, c in zip(res[0][:3], res[1][:3]):
        assert ((g - c).norm() / c.norm()).item() < 5e-4
    assert torch.equal(res[0][3], res[1][3])


def test_fp8_wrappers_raise_instead_of_falling_back(dev):
    from mxnet_tpu_torch.ops import fp8_ops as F8

    x = torch.ones(4, 8, device=dev)
    with pytest.raises(MXNetError, match="scale"):
        F8.fp8_cast(x, torch.ones(2, device=dev), F8.E4M3)
    a = torch.zeros(4, 16, dtype=torch.uint8, device=dev)
    with pytest.raises(MXNetError, match="multiple of 16"):
        F8.fp8_gemm(a[:, :12].contiguous(), a[:, :12].contiguous(), 0, 0,
                    torch.ones((), device=dev), torch.ones((), device=dev))


def test_fp8_scaler_multistep_capture_with_poisoned_step_equals_eager(
        dev, monkeypatch):
    """fp8 with the loss scaler through a captured 4-step call whose third
    inner batch holds a NaN: the graph's params, states, outputs, health
    stats and carried state (scale, streak, amax history) equal the same
    4 steps run eagerly from the same state, bit for bit; the poisoned
    step was skipped and the scale backed off; K11 and K12 ran their
    per-step counts."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fused
    from mxnet_tpu_torch.health import DynamicLossScaler, StepHealth

    monkeypatch.setenv("MXNET_FP8", "on")

    def make():
        return fused.TrainStep(
            _multistep_mlp(mx), optimizer="sgd",
            optimizer_params=dict(learning_rate=0.1, momentum=0.9,
                                  rescale_grad=1 / 32.),
            steps_per_call=4, device=dev,
            health=StepHealth(scaler=DynamicLossScaler(
                init_scale=256.0, growth_interval=2)))

    def bits(t):  # NaN-aware: the poisoned step's outputs hold NaNs
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    graph_step, eager_step = make(), make()
    state = graph_step.init_state({"data": (32, 24), "softmax_label": (32,)})
    batch = _super_batch(dev, 4, (32, 24))
    batch["data"][2, 0, 0] = float("nan")
    # one clean call first: the history holds amaxes before the capture
    clean = _super_batch(dev, 4, (32, 24), seed=3)
    state = graph_step.run_eager(*state, clean, None, 0.1, 1)[:3]
    eager_step.load_hstate(graph_step.export_hstate())
    want = eager_step.run_eager(*_clone_state(state), batch, None, 0.1, 5)
    want_h, want_stats = eager_step.export_hstate(), eager_step.last_health
    _cuda.reset_launches()
    got = graph_step(*state, batch, None, lr=0.1, t=5)
    _assert_bitwise(got[:3] + ([bits(o) for o in got[3]],),
                    want[:3] + ([bits(o) for o in want[3]],))
    got_h = graph_step.export_hstate()
    for k in want_h:
        assert np.array_equal(got_h[k], want_h[k]), k
    for k in want_stats:
        assert torch.equal(bits(graph_step.last_health[k]),
                           bits(want_stats[k])), k
    assert graph_step.last_health["nonfinite"].tolist() == [False, False,
                                                            True, False]
    # 1024 after the clean call; grown to 2048 by step 2, halved by the
    # poisoned step 3 (the stats hold each step's scale going in)
    assert graph_step.last_health["loss_scale"].tolist() == [1024.0, 1024.0,
                                                             2048.0, 1024.0]
    assert graph_step.loss_scale == 1024.0
    assert graph_step._fp8_sites == 2
    # the lazy capture's warm-up step and the replay's 4: per step K11's
    # forward, dx (not for fc1, whose input is the data) and dw, and K12's
    # x and w casts, the cotangent's amax pass and cast, a site each
    assert _cuda.launches["fp8_gemm"] == 5 * (3 * 2 - 1)
    assert _cuda.launches["fp8_cast"] == 5 * 4 * 2


@pytest.mark.parametrize("dropout", [True, False])
def test_remat_with_dropout_in_a_captured_call_equals_no_remat(dev, dropout):
    """remat=True inside a captured 2-step call: with dropout the whole
    forward is one checkpoint whose recompute draws the masks the first
    forward drew (copies of the inner generators registered with the
    graph); without, the forward runs as checkpointed segments.  Either
    way every replay's update equals the call captured without remat,
    bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fused

    def sym():
        net = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(net, num_hidden=64, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        if dropout:
            net = mx.sym.Dropout(net, p=0.5)
        net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
        return mx.sym.SoftmaxOutput(net, name="softmax")

    outs = []
    for remat in (None, True):
        step = fused.TrainStep(sym(), optimizer="sgd",
                               optimizer_params=dict(learning_rate=0.1),
                               steps_per_call=2, remat=remat, device=dev)
        state = step.init_state({"data": (32, 24), "softmax_label": (32,)})
        for i in range(3):
            res = step(*state, _super_batch(dev, 2, (32, 24), seed=i),
                       None, lr=0.1, t=1 + 2 * i)
            state = res[:3]
        outs.append(res)
    _assert_bitwise(outs[1], outs[0])


# last in the file: a capture that fails leaves no state behind, but no
# other test should depend on that
def test_multistep_capture_failure_raises(dev, monkeypatch):
    """A step that reads a value back to the host cannot be captured:
    the multi-step call raises, and no eager loop runs in its place."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import fused

    step = fused.TrainStep(_multistep_mlp(mx), steps_per_call=2,
                           device=dev)
    state = step.init_state({"data": (8, 24), "softmax_label": (8,)})
    plain = fused.TrainStep._step
    calls = []

    def syncing(self, *args):
        out = plain(self, *args)
        calls.append(float(out[3][0].sum()))
        return out

    monkeypatch.setattr(fused.TrainStep, "_step", syncing)
    with pytest.raises(MXNetError, match="capturing the call"):
        step(*state, _super_batch(dev, 2, (8, 24)), None)
    assert len(calls) == 1  # the warm-up step; no eager loop after
    torch.cuda.synchronize()


def test_serve_capture_failure_raises(dev, monkeypatch):
    """A function that reads a value back to the host cannot be captured:
    the session raises, and runs no eager step in the graph's place."""
    from mxnet_tpu_torch.serve import session as S

    decode = S.decode_step

    def syncing(*args, **kw):
        out = decode(*args, **kw)
        out[0].cpu()
        return out

    monkeypatch.setattr(S, "decode_step", syncing)
    with pytest.raises(MXNetError, match="capturing 'decode'"):
        _spec_session(dev, spec_k=0, draft="")
    torch.cuda.synchronize()
