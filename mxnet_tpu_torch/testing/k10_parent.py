"""K10, the SSM scan (``csrc/ssm_scan.cu``), against another checkout's
build of the same source and against other shapes of itself, in one
process on one card.

Run on a card from the repository's root, with the other checkout's
files unpacked under a directory that ``.gitignore`` lists::

    git archive <commit> mxnet_tpu_torch/csrc | tar -x -C build/parent
    python -m mxnet_tpu_torch.testing.k10_parent build/parent

It builds ``<dir>/mxnet_tpu_torch/csrc/ssm_scan.cu`` with this
checkout's flags (``flash_parent.build_other``), and this checkout's
source once a design in :data:`SHAPES` and :data:`ABLATIONS` (string
patches of the launch rule, the chunk's rows or the input copies, which
raise if the shipped source no longer has the patched text; one nvcc
each, all at once; ``--no-shapes`` skips them), and prints one JSON line
a case:

- K10 at :data:`CASES` (chip_smoke's three serving cases first, then the
  card tests' shapes and edges: rows off the 32-row chunk, padded rows
  on a chunk boundary, head dims 40 to 256, grids below and above the
  SM count, in place with ``collect``), each with every row valid and
  with padded rows: outputs, final state and snapshots the same bits
  from both builds and the plain version, one launch a call; the
  serving cases timed in turns other, this, this, other, with the
  profiler's device time of each build and a PyTorch copy of the state's
  bytes timed alike (``state_copy_ms``, the memory's pace under this
  timing: L2 flushed before each call);
- each shape of :data:`SHAPES` at the serving cases: bits equal to the
  shipped shape's, CUDA-event time beside the shipped shape's; and the
  :data:`ABLATIONS` (parts of the kernel left out, so other bits): the
  time each part takes;
- one hybrid session (``layers="full,window,ssm"``, window 128, the
  serving LM at full width) a build, each profiled by chip_smoke's
  ``profile_phase`` (4 decode steps of a full batch at 250-token
  prompts, graph replays, and one 256-row prefill): K10's device ms
  there, in turns other, this, this, other.

Times are CUDA-event means (L2 flushed, each window opened behind a
device spin, as chip_smoke times kernels).  A case whose bits differ
raises after its line.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import shutil
import subprocess
import sys

import torch

from .. import _cuda
from .flash_parent import build_other, in_turns, swapped, time_ms

__all__ = ["main", "CASES", "SHAPES", "ABLATIONS"]

KERNELS = ("ssm_scan",)

# (S, T, H, D, collect): chip_smoke's decode, prefill and verify, the
# card tests' shapes, then rows off the chunk (T 1, 17, 31, 33, 257),
# head dims 40 to 256, S x H x column blocks from 2 CTAs to 4096
CASES = ((8, 1, 16, 128, False), (1, 256, 16, 128, False),
         (8, 5, 16, 128, True), (3, 9, 2, 40, True), (2, 7, 3, 256, False),
         (2, 24, 16, 128, False), (1, 1, 2, 40, True), (2, 31, 4, 64, True),
         (1, 33, 16, 128, False), (1, 257, 16, 128, True),
         (3, 257, 2, 256, False), (16, 33, 16, 256, False),
         (40, 1, 16, 128, True), (5, 16, 3, 64, True), (1, 17, 1, 128, True))
SERVING = CASES[:3]

_RULE = """int launch_shape(const Params& p, cudaStream_t stream) {
  if (p.T <= kFewRows) return launch_dc<4, 32, 4, 4, false>(p, stream);
  return launch_dc<2, 16, 1, 1, true>(p, stream);
}"""
_ROWS = "constexpr int kMaxRows = 32;"
_FEW, _MANY = (4, 32, 4, 4, False), (2, 16, 1, 1, True)


def _shape(lp, jb, jt, minb, pipe):
    return "launch_dc<%d, %d, %d, %d, %s>" % (lp, jb, jt, minb,
                                             "true" if pipe else "false")


def _rule(few, many):
    return _RULE.replace(_shape(*_FEW), _shape(*few)) \
        .replace(_shape(*_MANY), _shape(*many))


def _name(kind, lp, jb, jt, minb, pipe):
    return "%s_lp%d_jb%d_jt%d_min%d%s" % (kind, lp, jb, jt, minb,
                                          "_pipe" if pipe else "")


# other shapes: (LP partial indices a thread, JB columns a CTA, JT columns
# a thread, CTAs an SM the registers must allow, rows read ahead) for
# decode and verify (T <= 8) and for more rows, and the chunk's rows
SHAPES = dict(
    [(_name("few", *f), [(_RULE, _rule(f, _MANY))])
     for f in ((4, 32, 1, 2, False), (8, 32, 1, 4, False),
               (2, 32, 4, 4, False), (4, 32, 2, 4, False),
               (4, 32, 4, 4, True))]
    + [(_name("many", *m), [(_RULE, _rule(_FEW, m))])
       for m in ((1, 16, 1, 1, True), (1, 16, 2, 1, True),
                 (2, 16, 2, 1, True), (2, 16, 1, 1, False))]
    + [("rows8", [(_ROWS, "constexpr int kMaxRows = 8;")]),
       ("rows16", [(_ROWS, "constexpr int kMaxRows = 16;")])])

# the row loops: a whole chunk of valid rows as straight-line blocks of
# four rows, against the two-row loop that runs every other chunk
_WHOLE = "      if (rows % 4 == 0 && (mask & all) == all && p.states == nullptr) {"
SHAPES["whole_chunk_off"] = [(_WHOLE, _WHOLE.replace(") {", " && rows < 0) {"))]
# rows i >= D tested in every row whatever D (the shipped kernel tests
# them only where D < 32 DC)
SHAPES["pad_test_always"] = [("  if (p.D == kWarp * DC)\n",
                              "  if (p.D < 0)\n")]

# the inputs copied so that a warp's copies land on adjacent stage words
# (each lane reading the value i that belongs there: uncoalesced reads)
_COPIES = ("  // Each thread copies k and q at the same values i",
           "  // lane r's row of chunk c is valid")
_COPIES_ADJACENT = """  auto stage_index = [](int pos) {
    return pos / (DC * LP) + NL * ((pos / DC) % LP) + kWarp * (pos % DC);
  };
  auto issue = [&](int c) {
    if (c < nchunks) {
      float* const stg = smem + (c % kStages) * SF;
      const int t0 = c * RC, rows = min(RC, p.T - t0);
      const size_t b0 = base + static_cast<size_t>(t0) * HD;
      for (int x = tid; x < rows * DP; x += NT) {
        const int r = x / DP, i = stage_index(x % DP);
        if (i < p.D) {
          cp_async4(stg + x, p.k + b0 + r * HD + i);
          cp_async4(stg + RC * DP + x, p.q + b0 + r * HD + i);
        }
      }
      for (int x = tid; x < rows * JB; x += NT) {
        const int r = x / JB, jj = x % JB;
        if (j0 + jj < p.D)
          cp_async4(stg + 2 * RC * DP + x, p.v + b0 + r * HD + j0 + jj);
      }
    }
    cp_commit();
  };
  auto scale_q = [&](int c) {
    if (c >= nchunks) return;
    float* const qs = smem + (c % kStages) * SF + RC * DP;
    const int rows = min(RC, p.T - c * RC);
    for (int x = tid; x < rows * DP; x += NT)
      if (stage_index(x % DP) < p.D) qs[x] = __fmul_rn(qs[x], p.scale);
  };
"""


def _copies_adjacent(src):
    a, b = src.index(_COPIES[0]), src.index(_COPIES[1])
    return src[:a] + _COPIES_ADJACENT + src[b:]


# ablations (other bits; they show where the time goes): no readout
# phase; no copies or scaling after the first chunks (stale inputs)
SHAPES["copies_adjacent"] = [_copies_adjacent]

ABLATIONS = {
    "ablation_no_readout": [
        ("    if (c > 0) readout(c - 1, last);",
         "    if (c < 0) readout(c - 1, last);"),
        ("  if (nchunks > 0) readout(nchunks - 1, last);",
         "  if (nchunks < 0) readout(nchunks - 1, last);")],
    "ablation_no_copies": [
        ("    issue(c + 2);",
         "    if (c + 2 < kStages) issue(c + 2); else cp_commit();"),
        ("    scale_q(c + 1);", "    if (c + 1 < kStages) scale_q(c + 1);")],
}


def _emit(row):
    print(json.dumps(row), flush=True)


def _patch(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError("k10_parent: the shipped source lacks %r"
                           % old[:60])
    return text.replace(old, new)


def build_shapes(shapes=SHAPES):
    """This checkout's ssm_scan.cu once a shape, patched and built at
    once; {name: entries}."""
    with open(os.path.join(_cuda.CSRC, "ssm_scan.cu")) as f:
        src = f.read()
    root = os.path.join(_cuda.BUILD_ROOT, os.pardir, "k10_shapes")

    def one(item):
        name, patches = item
        text = src
        for patch in patches:
            text = patch(text) if callable(patch) else _patch(text, *patch)
        tree = os.path.join(root, name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(_cuda.CSRC, os.path.join(tree, "mxnet_tpu_torch",
                                                 "csrc"))
        with open(os.path.join(tree, "mxnet_tpu_torch", "csrc",
                               "ssm_scan.cu"), "w") as f:
            f.write(text)
        return name, build_other(tree, KERNELS, "k10_shape_" + name)
    with concurrent.futures.ThreadPoolExecutor(len(shapes)) as pool:
        return dict(pool.map(one, shapes.items()))


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


def case_inputs(s, t, h, d, seed=0):
    """q, k, v, state0 (0.1 x unit normal), gamma, and a mask with padded
    rows: slot 0's second half (a bucket's tail), and in the last slot
    rows 0, 15, 16, 31 and 32 (a chunk's first row and both sides of the
    16- and 32-row chunks' boundaries)."""
    from ..ops import ssm_ops as SSM

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v = (_randn(gen, s, t, h, d) for _ in range(3))
    state0 = 0.1 * _randn(gen, s, h, d, d)
    valid = torch.ones((s, t), dtype=torch.bool, device="cuda")
    valid[0, t // 2:] = False
    if s > 1:
        valid[s - 1, [r for r in (0, 15, 16, 31, 32) if r < t]] = False
    return q, k, v, state0, SSM.ssm_decay(h, "cuda"), valid


def _bits_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _device_ms(cs, fn, reps=20):
    """The profiler's device time of K10 a call of ``fn``."""
    prof = cs.profiled_window(lambda: [fn() for _ in range(reps)],
                              (("ssm_scan", ("ssm_scan_kernel",)),))
    seen = prof["kernels_by_group"]["ssm_scan"]
    return prof["device_ms_by_group"]["ssm_scan"] / seen if seen else None


def _cases(cs, other):
    from ..ops import ssm_ops as SSM

    for n, (s, t, h, d, collect) in enumerate(CASES):
        q, k, v, state0, gamma, valid = case_inputs(s, t, h, d, seed=n)
        row = dict(kernel="ssm_scan", case="S%d-T%d-H%d-D%d%s"
                   % (s, t, h, d, "-collect" if collect else ""))
        ok = True
        for tag, rv in (("", None), ("_padded", valid)):
            def fn():
                return SSM.ssm_scan(q, k, v, state0, gamma, row_valid=rv,
                                    collect=collect)
            before = _cuda.launches["ssm_scan"]
            mine = fn()
            once = _cuda.launches["ssm_scan"] == before + 1
            with swapped(other):
                theirs = fn()
            plain = SSM.ssm_scan_plain(q, k, v, state0, gamma, row_valid=rv,
                                       collect=collect)
            row["bit_identical" + tag] = _bits_equal(mine, theirs)
            row["equals_plain" + tag] = _bits_equal(mine, plain)
            row["one_launch" + tag] = once
            ok = ok and once and row["bit_identical" + tag] \
                and row["equals_plain" + tag]
            del mine, theirs, plain
        # in place, with every row's state kept
        pool = state0.clone()
        got = SSM.ssm_scan(q, k, v, pool, gamma, row_valid=valid,
                           collect=True, out_state=pool)
        plain = SSM.ssm_scan_plain(q, k, v, state0, gamma, row_valid=valid,
                                   collect=True)
        row["in_place_collect_equals_plain"] = \
            got[1].data_ptr() == pool.data_ptr() and _bits_equal(got, plain)
        ok = ok and row["in_place_collect_equals_plain"]
        del got, plain, pool
        if (s, t, h, d, collect) in SERVING:
            def fn():
                return SSM.ssm_scan(q, k, v, state0, gamma, collect=collect)
            row["ms"] = in_turns(other, fn)
            # the state's bytes moved by one PyTorch copy (read once,
            # written once, or once a row with collect), timed alike
            dst = torch.empty((t if collect else 1,) + tuple(state0.shape),
                              device="cuda")
            row["state_copy_ms"] = time_ms(lambda: dst.copy_(
                state0.expand_as(dst)))
            del dst
            row["device_ms"] = _device_ms(cs, fn)
            with swapped(other):
                row["device_ms_other"] = _device_ms(cs, fn)
        _emit(row)
        if not ok:
            raise AssertionError("K10 %s: %r" % (row["case"], row))
        del q, k, v, state0


def _shapes(shapes):
    from ..ops import ssm_ops as SSM

    for n, (s, t, h, d, collect) in enumerate(SERVING):
        q, k, v, state0, gamma, valid = case_inputs(s, t, h, d, seed=n)

        def fn(rv=None):
            return SSM.ssm_scan(q, k, v, state0, gamma, row_valid=rv,
                                collect=collect)
        mine, mine_padded = fn(), fn(valid)
        row = dict(kernel="ssm_scan", case="S%d-T%d-H%d-D%d%s"
                   % (s, t, h, d, "-collect" if collect else ""),
                   shipped_ms=time_ms(fn))
        for name, entries in shapes.items():
            with swapped(entries):
                row[name + "_bit_identical"] = \
                    _bits_equal(fn(), mine) and \
                    _bits_equal(fn(valid), mine_padded)
                row[name + "_ms"] = time_ms(fn)
        row["shipped_ms_again"] = time_ms(fn)
        _emit(row)
        del q, k, v, state0, mine, mine_padded


def _hybrid(cs, other):
    """One hybrid session a build (its graphs captured under that build),
    profiled in turns."""
    from .. import serve

    cfg = serve.ModelConfig(vocab_size=32768, num_layers=8, d_model=2048,
                            num_heads=16, max_len=1024)
    conf = serve.ServeConfig(slots=8, page_size=16, buckets=(64, 128, 256),
                             max_new=1024 - 256 - 32, exact=True,
                             window=cs.HYBRID_WINDOW,
                             layers="full,window,ssm")
    params = serve.init_params(cfg, seed=0, device="cuda")
    sessions = {}
    for side in ("other", "this"):
        with swapped(other) if side == "other" else \
                contextlib.nullcontext():
            sessions[side] = serve.InferenceSession(
                params, num_heads=cfg.num_heads, config=conf, device="cuda")
    out = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        with swapped(other) if side == "other" else \
                contextlib.nullcontext():
            prof = cs.profile_phase(sessions[side])
        out[side].append({
            "decode_4_steps": _k10(prof["decode"]),
            "decode_replay_ms": prof["decode_replay_ms"],
            "prefill_256": _k10(prof["prefill_256"])})
    _emit(dict(case="hybrid-full,window,ssm-8L-d2048-h16", **out))


def _k10(prof):
    return dict(wall_ms=prof["wall_ms"],
                device_busy_ms=prof["device_busy_ms"],
                idle_share=prof["idle_share"],
                k10_device_ms=prof["device_ms_by_group"]["ssm_scan"],
                k10_launches=prof["kernels_by_group"]["ssm_scan"],
                device_ms_by_group=prof["device_ms_by_group"])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    skip_shapes = "--no-shapes" in argv
    argv = [a for a in argv if not a.startswith("--")]
    # chip_smoke.py (the checkout's root) holds the profiler helpers
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build()
    other = build_other(argv[0] if argv else os.path.join("build", "parent"),
                        KERNELS, "k10_parent")
    shapes = {} if skip_shapes else build_shapes(dict(SHAPES, **ABLATIONS))
    _emit({"card": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()})
    _cases(cs, other)
    torch.cuda.empty_cache()
    if shapes:
        _shapes(shapes)
        torch.cuda.empty_cache()
    _hybrid(cs, other)


if __name__ == "__main__":
    main()
