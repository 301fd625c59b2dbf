"""How Hopper's fp8 ``wgmma`` accumulates, measured through K11
(``csrc/fp8_gemm.cu``) on crafted operands, and K11 and a variant that
does not promote held against the derived bound
(``ops/fp8_ops.py::fp8_gemm_error_bound``).

Run on a card from the repository's root::

    python -m mxnet_tpu_torch.testing.fp8_accum [--probes]

K11 sums each 128-deep stage as four m64n128k32 ``wgmma`` from zero and
adds the stage into an fp32 total.  With K = 128, scales 1 and an fp32
output, an output is one stage's accumulator exactly; products placed in
the stage's last k32 slice (columns 96-127, zeros before) are one
``wgmma`` from zero.  Each probe is one output: row e of ``a`` and row e
of ``b`` hold its products (exact products of two fp8 values), and the
diagonal of the product is read.  It prints one JSON line a probe
family, each probe's result beside the exact sum:

- ``keep``: 2^8, then 2^(8-f) (and its negative): which f survive, i.e.
  how many bits below the largest addend's leading bit the sum keeps;
- ``round``: 2^8 with 1.5, 1.75 and 0.75 units of the last kept bit,
  both signs: truncation toward zero, toward -inf, or to nearest;
- ``pairs``: 2^8 and two 0.75-unit products d positions apart: whether
  products are added exactly in groups before they are cut;
- ``groups``: 2^8, -2^8, then 2^-12 at position q: the first q whose
  tiny product survives the cancellation marks where a new alignment of
  the slice starts;
- ``straddle``: addends whose sum crosses a power of two, with a
  product at the last kept bit of the largest addend: whether the
  normalised sum is cut again;
- ``exponent``: whether a product's place on the grid follows its true
  leading bit or the sum of its factors' exponents (a significand
  product of 2 or more; a subnormal factor);
- ``normalise``: 2^8 + 2^8 and a product on the first grid whose sum
  falls between two steps of the carried sum's grid: cut or rounded;
- ``carry``: a sum left in the accumulator by slice 3, then slice 4's
  products (larger, zero, or smaller): whether the running sum is cut
  like a product;
- ``exponent_e5m2``: the ``exponent`` and ``keep`` questions for e5m2
  first factors (the LM's dx and dw take e5m2 cotangents), a subnormal
  one among them;
- ``stats``: K11 against the plain version over random data (signed
  like the card test's, and one-signed) at K = 128, 160, 2048 and 8192,
  e4m3 x e4m3 and e5m2 x e4m3 (two cases with many e5m2 subnormals):
  the largest error over Σ|a·b| and over the derived bound, and how many
  outputs of :func:`sample_mismatches`'s sample differ from
  :func:`emulate_k11` (the measured model, no fitted constant);
- ``nopromote``: the same with a variant of K11 that keeps the whole K
  in the ``wgmma`` accumulator (a string patch of the shipped source, as
  ``testing.fp8_variants`` builds its designs), which must go over the
  bound at K = 8192 and differ from the shipped K11's emulation.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from .. import _cuda
from ..ops.fp8_ops import E4M3, E5M2, MIN_NORMAL_EXP, WGMMA_KEPT_BITS
from .flash_parent import build_other, swapped

__all__ = ["main", "probe_sums", "wgmma_step", "emulate_k11",
           "sample_mismatches"]

_ONE_SLICE = 96  # the stage's last k32 slice starts here


def _floor_log2(x):
    """floor(log2 |x|), exactly, for x != 0 (0 elsewhere)."""
    _, e = np.frexp(np.where(x != 0, np.abs(x), 1.0))
    return e - 1


def wgmma_step(c, p, pe):
    """One m64n128k32 fp8 ``wgmma`` as measured on the H100 (the probe
    families of this module): the running sums ``c`` (n,) and the
    products ``p`` (n, 32) of each output are aligned to the largest
    exponent E among them (a product's is ``pe`` (n, 32), the sum of its
    factors' exponent fields; the running sum's its own) and each is cut
    toward zero to a multiple of 2^(E - 13); the cut values are added
    exactly; a sum that carries to 2^(E + 1) or past is cut toward zero
    again, 13 bits below its own leading bit.  float64 in and out (every
    value here is exact)."""
    c = np.asarray(c, np.float64)
    p = np.asarray(p, np.float64)
    x = np.concatenate([c[:, None], p], axis=1)
    big = np.abs(x).max(axis=1)
    pe = np.where(p != 0, pe, -10 ** 6)
    e = np.maximum(np.where(c != 0, _floor_log2(c), -10 ** 6),
                   pe.max(axis=1))
    e = np.where(big > 0, e, 0)
    u = np.ldexp(1.0, e - WGMMA_KEPT_BITS)[:, None]
    s = (np.trunc(x / u) * u).sum(axis=1)
    es = _floor_log2(s)
    us = np.ldexp(1.0, es - WGMMA_KEPT_BITS)
    s = np.where(np.abs(s) >= np.ldexp(1.0, e + 1), np.trunc(s / us) * us, s)
    return np.where(big > 0, s, 0.0)


def emulate_k11(av, bv, sa=1.0, sb=1.0, promote=True, a_kind=E4M3,
                b_kind=E4M3):
    """K11's fp32 outputs for rows of decoded values ``av``, ``bv`` (n,
    K) of kinds ``a_kind``, ``b_kind``: each 128-deep stage four
    ``wgmma_step`` from zero, added into an fp32 total (``promote``), or,
    without promotion, the whole K summed in the steps' running sum; then
    x s_a x s_b in fp32.  A factor's exponent is its exponent field, the
    kind's least normal exponent for a subnormal value."""
    av, bv = np.asarray(av, np.float64), np.asarray(bv, np.float64)
    n, k = av.shape
    stages = -(-k // 128)
    pad = ((0, 0), (0, stages * 128 - k))
    prod = np.pad(av * bv, pad)
    pe = np.pad(np.maximum(_floor_log2(av), MIN_NORMAL_EXP[a_kind])
                + np.maximum(_floor_log2(bv), MIN_NORMAL_EXP[b_kind]), pad)
    total = np.zeros(n, np.float32)
    part = np.zeros(n)
    for st in range(stages):
        for kk in range(4):
            keep = kk > 0 or (not promote and st > 0)
            cols = slice(st * 128 + 32 * kk, st * 128 + 32 * (kk + 1))
            part = wgmma_step(part if keep else np.zeros(n), prod[:, cols],
                              pe[:, cols])
        if promote:
            total = (total + part.astype(np.float32)).astype(np.float32)
    if not promote:
        total = part.astype(np.float32)
    return ((total * np.float32(sa)).astype(np.float32)
            * np.float32(sb)).astype(np.float32)


def sample_mismatches(a, b, a_kind, b_kind, sa, sb, got, promote=True,
                      seed=0):
    """How many of a sample of K11's outputs ``got`` (M, N; fp32 or bf16)
    for codes ``a`` (M, K), ``b`` (N, K) differ from :func:`emulate_k11`
    (one rounding to bf16 for a bf16 ``got``), and the sample's size.  The
    sample: the 8 x 8 corner and 16 rows by 16 columns drawn from
    ``seed`` (the last row and column among them).  Values are compared,
    so the sign of a zero is not (K11 writes +0 where its sum is 0).

    The emulation is the accumulator measured on the card, so K11's
    outputs equal it bit for bit (``fp8_accum`` on an H100): this holds
    the kernel far more tightly than :func:`fp8_ops.fp8_gemm_error_bound`,
    which a kernel that drops part of its sum may still meet."""
    from ..ops import fp8_ops as F8

    m, n = got.shape
    rs = np.random.RandomState(seed)
    rows = np.unique(np.r_[rs.randint(0, m, 15), m - 1])
    cols = np.unique(np.r_[rs.randint(0, n, 15), n - 1])
    pairs = {(r, c) for r in range(min(m, 8)) for c in range(min(n, 8))}
    pairs |= {(int(r), int(c)) for r in rows for c in cols}
    ri, ci = (np.array(x) for x in zip(*sorted(pairs)))
    ur, rinv = np.unique(ri, return_inverse=True)
    uc, cinv = np.unique(ci, return_inverse=True)
    dev = a.device
    av = F8.decode(a[torch.as_tensor(ur, device=dev)], a_kind).double()
    bv = F8.decode(b[torch.as_tensor(uc, device=dev)], b_kind).double()
    emu = emulate_k11(av.cpu().numpy()[rinv], bv.cpu().numpy()[cinv],
                      float(sa), float(sb), promote, a_kind, b_kind)
    emu = torch.from_numpy(emu).to(got.dtype).float().numpy()
    mine = got[torch.as_tensor(ri, device=got.device),
               torch.as_tensor(ci, device=got.device)].float().cpu().numpy()
    return int((emu != mine).sum()), len(ri)


def _emit(row):
    print(json.dumps(row), flush=True)


def _factor(p):
    """(a, b), both e4m3 values, with a * b == p exactly: p's significand
    (at most 4 bits) on a, the rest of its power of two on b."""
    if p == 0:
        return 0.0, 0.0
    m, e = abs(p), 0
    while m >= 2.0:
        m, e = m / 2.0, e + 1
    while m < 1.0:
        m, e = m * 2.0, e - 1
    if (m * 8) != int(m * 8):
        raise ValueError("%r needs more than e4m3's 4 significant bits" % p)
    ea = max(-6, min(8, e))
    eb = e - ea
    if not -9 <= eb <= 8:
        raise ValueError("%r is outside two e4m3 factors' range" % p)
    return (m if p > 0 else -m) * 2.0 ** ea, 2.0 ** eb


_TORCH_FP8 = {E4M3: torch.float8_e4m3fn, E5M2: torch.float8_e5m2}


def _codes(vals, kind=E4M3):
    t = torch.tensor(vals, dtype=torch.float32)
    back = t.to(_TORCH_FP8[kind]).float()
    if not torch.equal(back, t):
        raise ValueError("a probe value is not a value of kind %d" % kind)
    return t.to(_TORCH_FP8[kind]).view(torch.uint8)


def probe_sums(probes, a_kind=E4M3, b_kind=E4M3):
    """K11's fp32 result for each probe, a list of (position, product or
    its two factors) pairs in one 128-deep stage (a product alone is
    factored into two e4m3 values); returns [(result, exact sum)]."""
    from ..ops import fp8_ops as F8

    n = len(probes)
    a = [[0.0] * 128 for _ in range(n)]
    b = [[0.0] * 128 for _ in range(n)]
    exact = []
    for e, probe in enumerate(probes):
        total = 0.0
        for pos, p in probe:  # a product, or its two factors
            a[e][pos], b[e][pos] = p if isinstance(p, tuple) else _factor(p)
            total += a[e][pos] * b[e][pos]
        exact.append(total)  # exact: few terms
    ca, cb = _codes(a, a_kind).cuda(), _codes(b, b_kind).cuda()
    one = torch.ones((), device="cuda")
    out = F8.fp8_gemm(ca, cb, a_kind, b_kind, one, one, torch.float32)
    res = out.diagonal().double().cpu().tolist()
    return list(zip(res, exact))


def _family(name, labels, probes):
    kinds = _KINDS.get(name, (E4M3, E4M3))
    rows = probe_sums(probes, *kinds)
    _emit(dict(family=name, kinds=kinds, probes=[
        dict(label=lab, result=r, exact=x, kept=(r == x))
        for lab, (r, x) in zip(labels, rows)]))


def _probes():
    s0 = _ONE_SLICE
    big = 256.0
    labels, probes = {}, {}

    def add(fam, lab, probe):
        labels.setdefault(fam, []).append(lab)
        probes.setdefault(fam, []).append(probe)
    for f in range(1, 24):
        for sign in (1, -1):
            add("keep", "f%d%s" % (f, "+" if sign > 0 else "-"),
                [(s0, big), (s0 + 1, sign * 2.0 ** (8 - f))])
    for f in range(10, 18):
        for frac in (1.5, 1.75, 0.75, 1.25):
            for sign in (1, -1):
                add("round", "f%d x%g %s" % (f, frac, "+" if sign > 0 else "-"),
                    [(s0, big), (s0 + 1, sign * frac * 2.0 ** (8 - f))])
    for f in (12, 13, 14, 15):
        for d in range(1, 31):
            add("pairs", "f%d d%d" % (f, d),
                [(s0, big), (s0 + 1, 0.75 * 2.0 ** (8 - f)),
                 (s0 + 1 + d, 0.75 * 2.0 ** (8 - f))])
    for q in range(2, 32):
        add("groups", "q%d" % q,
            [(s0, big), (s0 + 1, -big), (s0 + q, 2.0 ** -12)])
    for q in range(0, 30):  # the cancelling pair later in the slice
        add("groups_late", "q%d" % q,
            [(s0 + q, big), (s0 + q + 1, -big), (s0 + 31, 2.0 ** -12)])
    for f in range(10, 18):
        # 240 + 16 = 256: the largest addend's leading bit is 2^7
        add("straddle", "f%d" % f,
            [(s0, 240.0), (s0 + 1, 16.0), (s0 + 2, 2.0 ** (7 - f))])
        add("straddle_two", "f%d" % f,
            [(s0, big), (s0 + 1, big), (s0 + 2, 2.0 ** (8 - f))])
    # which exponent sets the grid: a product whose significands multiply
    # to 2 or more (1.5 x 1.5 = 2.25: its leading bit one above the sum of
    # the factors' exponents), and one with a subnormal factor (2^-7 =
    # 0.5 x 2^-6 in e4m3), each beside a product one step below the grid
    # the true leading bit would give
    # (-64 keeps the sum below the next power of two, so no carry cuts it)
    for f in (12, 13, 14):
        add("exponent", "1.5 x 1.5 x 2^7 - 64 + 2^(8-%d)" % f,
            [(s0, (1.5, 1.5 * 2.0 ** 7)), (s0 + 1, -64.0),
             (s0 + 2, 2.0 ** (8 - f))])
        add("exponent", "2^-7 x 2^8 + 2^(1-%d)" % f,
            [(s0, (2.0 ** -7, 2.0 ** 8)), (s0 + 1, 2.0 ** (1 - f))])
    # the same with e5m2 first factors (the LM's cotangents): a subnormal
    # one (2^-15 = 0.5 x 2^-14) beside 2^(-7-f) (whose grid is 2^-19 if
    # the product counts at -14 + 8, 2^-20 at its true -7); a
    # significand product of 2 or more (1.5 x 1.5); and plain normal
    # values, kept 13 bits below the largest
    for f in (12, 13, 14):
        add("exponent_e5m2", "2^-15 x 2^8 + 2^(-7-%d)" % f,
            [(s0, (2.0 ** -15, 2.0 ** 8)),
             (s0 + 1, (2.0 ** -14, 2.0 ** (7 - f)))])
        add("exponent_e5m2", "1.5 x 1.5 x 2^7 - 64 + 2^(8-%d)" % f,
            [(s0, (1.5, 1.5 * 2.0 ** 7)), (s0 + 1, (-1.0, 64.0)),
             (s0 + 2, (2.0 ** -f, 2.0 ** 8))])
        add("exponent_e5m2", "256 + 2^(8-%d)" % f,
            [(s0, (1.0, 256.0)), (s0 + 1, (2.0 ** -f, 2.0 ** 8))])
    # a sum that carries past the largest addend's leading bit, its low
    # bits 1.5 / 3.5 units of the carried sum's last kept bit: cut toward
    # zero or rounded to nearest
    for lo in (0.09375, 0.21875, 0.046875):
        for sign in (1, -1):
            add("normalise", "%s512 + %g" % ("+" if sign > 0 else "-", lo),
                [(s0, sign * big), (s0 + 1, sign * big),
                 (s0 + 2, sign * lo)])
    for f in range(10, 18):
        low = 2.0 ** (8 - f)
        # slice 3 leaves 256 + low in the accumulator
        add("carry", "f%d then 512" % f,
            [(64, big), (65, low), (s0, 512.0)])
        add("carry", "f%d then zeros" % f, [(64, big), (65, low)])
        add("carry", "f%d then 1" % f, [(64, big), (65, low), (s0, 1.0)])
        # slice 3 leaves 256 + 2^(7-f): 240 + 16 + 2^(7-f), one bit more
        # than the slice's own grid keeps only if the carry is exact
        add("carry_straddle", "f%d then zeros" % f,
            [(64, 240.0), (65, 16.0), (66, 2.0 ** (7 - f))])
    return labels, probes


# probe families whose operands are not both e4m3: (a's kind, b's kind)
_KINDS = {"exponent_e5m2": (E5M2, E4M3)}


def _random_codes(m, k, seed, one_signed, kind=E4M3, scale=0.01):
    from ..ops import fp8_ops as F8

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda")
    if one_signed:
        x = x.abs()
    return F8.fp8_cast(x.bfloat16(), torch.tensor(scale, device="cuda"),
                       kind, amax=False)[0]


# (K, one-signed, M, N, a's kind, a's cast scale): e4m3 x e4m3, then e5m2
# x e4m3 as the LM's dx and dw take them, the last two cast at 2^13, so
# that a's values |x| < 0.5 fall below e5m2's least normal 2^-14
STATS = ((128, False, 2048, 1024, E4M3, 0.01),
         (160, False, 2100, 1100, E4M3, 0.01),
         (160, True, 2100, 1100, E4M3, 0.01),
         (2048, False, 1024, 1024, E4M3, 0.01),
         (8192, False, 512, 512, E4M3, 0.01),
         (8192, True, 512, 512, E4M3, 0.01),
         (2048, False, 1024, 1024, E5M2, 0.01),
         (2048, False, 1024, 1024, E5M2, 2.0 ** 13),
         (160, True, 2100, 1100, E5M2, 2.0 ** 13))


def _stats(label, entries=None):
    """K11 (or ``entries``) against the plain version, the bound, and the
    emulation on :func:`sample_mismatches`'s sample."""
    from ..ops import fp8_ops as F8

    rows = []
    for k, one_signed, m, n, a_kind, a_scale in STATS:
        a = _random_codes(m, k, m + k, one_signed, a_kind, a_scale)
        b = _random_codes(n, k, n + k + 1, one_signed)
        s = torch.tensor(0.01, device="cuda")
        with swapped(entries) if entries else contextlib.nullcontext():
            got = F8.fp8_gemm(a, b, a_kind, F8.E4M3, s, s, torch.float32)
        want = F8.fp8_gemm_plain(a, b, a_kind, F8.E4M3, s, s)
        mag = F8.fp8_gemm_magnitude(a, b, a_kind, F8.E4M3, s, s)
        err = (got - want).abs()
        bound = F8.fp8_gemm_error_bound(mag, k)
        # the emulation of the shipped, promoting K11 against the
        # kernel's outputs (none may differ for K11; a variant should
        # fail), and the emulation of what the kernel does
        bad, size = sample_mismatches(a, b, a_kind, F8.E4M3, s, s, got)
        own = sample_mismatches(a, b, a_kind, F8.E4M3, s, s, got,
                                promote=entries is None)[0]
        av = F8.decode(a, a_kind).abs()
        low = 2.0 ** MIN_NORMAL_EXP[a_kind]
        sub = float(((av > 0) & (av < low)).float().mean())
        rows.append(dict(K=k, M=m, N=n, one_signed=one_signed,
                         a_kind=a_kind, a_subnormal_share=sub,
                         sample=size, sample_mismatches=bad,
                         own_model_mismatches=own,
                         max_err_over_mag=float((err / mag).max()),
                         mean_err_over_mag=float((err / mag).mean()),
                         max_err_over_bound=float((err / bound).max()),
                         over_bound=int((err > bound).sum())))
        del a, b, av, got, want, mag, err, bound
    _emit(dict(family=label, cases=rows))


_PROMOTE = """          Wgmma<kA, kB>::run(part, desc_k(a_tile, kBM, 64 * wg, kk),
                             desc_k(b_tile, kBN, 0, kk), kk > 0);"""
_NO_PROMOTE = """          Wgmma<kA, kB>::run(part, desc_k(a_tile, kBM, 64 * wg, kk),
                             desc_k(b_tile, kBN, 0, kk), it > 0 || kk > 0);"""
_ADD = "        for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);"
_KEEP = "        for (int i = 0; i < 64; ++i) acc[i] = part[i];"


def no_promotion_build():
    """K11 with the whole K summed in the ``wgmma`` accumulator: the
    shipped source with two exact patches (each must apply once)."""
    with open(os.path.join(_cuda.CSRC, "fp8_gemm.cu")) as f:
        src = f.read()
    for old, new in ((_PROMOTE, _NO_PROMOTE), (_ADD, _KEEP)):
        if src.count(old) != 1:
            raise RuntimeError("fp8_accum: the shipped K11 lacks %r"
                               % old[:60])
        src = src.replace(old, new)
    tree = os.path.join(_cuda.BUILD_ROOT, os.pardir, "fp8_accum")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, os.path.join(tree, "mxnet_tpu_torch", "csrc"))
    with open(os.path.join(tree, "mxnet_tpu_torch", "csrc", "fp8_gemm.cu"),
              "w") as f:
        f.write(src)
    return build_other(tree, ("fp8_gemm",), "fp8_accum_build")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    _emit({"card": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()})
    _cuda.build()
    labels, probes = _probes()
    for fam in labels:
        _family(fam, labels[fam], probes[fam])
    if "--probes" in argv:
        return
    _stats("stats")
    _stats("nopromote", no_promotion_build())


if __name__ == "__main__":
    main()
