"""K11's error bound (``mxnet_tpu_torch/ops/fp8_ops.py::
fp8_gemm_error_bound``) against the emulation of Hopper's fp8 ``wgmma``
(``mxnet_tpu_torch/testing/fp8_accum.py::emulate_k11``), on the CPU.

The emulation is the accumulator as measured on the card (a k32 step cuts
each of its addends toward zero 13 bits below the largest exponent among
them, a product counting with its factors' exponent fields, and a sum that
carries is cut again); it reproduces the card's sums recorded below, and
there it gives K11's own bits, e5m2 factors included.  Over random and
adversarial operands K11's emulated outputs stay within the bound, and a
form of K11 that does not promote its 128-deep stages to fp32 goes over
it at K = 8192.  The card's checks also hold sampled outputs of K11 equal
to the emulation (``fp8_accum.sample_mismatches``), which must flag a
single wrong output.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import fp8_ops as F8
from mxnet_tpu_torch.testing import fp8_accum as A

# (products at their positions in a 128-deep stage, K11's fp32 result on
# an NVIDIA H100 80GB HBM3 at 700 W, testing/fp8_accum.py's probes)
MEASURED = [
    ([(96, 256.0), (97, 2.0 ** -5)], 256.03125),   # 13 bits below 2^8 kept
    ([(96, 256.0), (97, 2.0 ** -6)], 256.0),       # 14 bits below: cut
    ([(96, 256.0), (97, -1.75 * 2.0 ** -4)], 255.90625),  # toward zero
    ([(96, 256.0), (97, 0.75 * 2.0 ** -4), (117, 0.75 * 2.0 ** -4)],
     256.0625),                                    # each product cut alone
    ([(96, 256.0), (97, -256.0), (113, 2.0 ** -12)], 0.0),  # one alignment
    ([(96, 240.0), (97, 16.0), (98, 2.0 ** -6)], 256.0),    # a carry cuts
    ([(96, 256.0), (97, 256.0), (98, 0.21875)], 512.1875),  # toward zero
    ([(96, -256.0), (97, -256.0), (98, -0.21875)], -512.1875),
    ([(64, 256.0), (65, 2.0 ** -5), (96, 512.0)], 768.0),   # the running
    ([(64, 256.0), (65, 2.0 ** -5)], 256.03125),            # sum is cut too
    # a product aligns by its factors' exponent fields: 1.5 x 1.5 x 2^7
    # counts as 2^7, so 2^-6 stays; 2^-7 (subnormal) x 2^8 counts as 2^2
    ([(96, (1.5, 1.5 * 2.0 ** 7)), (97, -64.0), (98, 2.0 ** -6)], 224.015625),
    ([(96, (2.0 ** -7, 2.0 ** 8)), (97, 2.0 ** -12)], 2.0),
]


@pytest.mark.parametrize("probe,want", MEASURED)
def test_emulation_gives_the_sums_measured_on_the_card(probe, want):
    a, b = np.zeros((1, 128)), np.zeros((1, 128))
    for pos, p in probe:
        a[0, pos], b[0, pos] = p if isinstance(p, tuple) else A._factor(p)
    assert float(A.emulate_k11(a, b)[0]) == want


# the same for e5m2 first factors (a's kind; b e4m3), as the LM's dx and
# dw take them: an e5m2 subnormal (2^-15) counts at its exponent field
# -14, so 2^-15 x 2^8 sets the grid at 2^(-6 - 13) and 2^-20 is cut
MEASURED_E5M2 = [
    ([(96, (2.0 ** -15, 256.0)), (97, (2.0 ** -14, 2.0 ** -5))],
     0.007814407348632812),
    ([(96, (2.0 ** -15, 256.0)), (97, (2.0 ** -14, 2.0 ** -6))], 0.0078125),
    ([(96, (1.5, 192.0)), (97, (-1.0, 64.0)), (98, (2.0 ** -14, 256.0))],
     224.015625),
    ([(96, (1.0, 256.0)), (97, (2.0 ** -13, 256.0))], 256.03125),
    ([(96, (1.0, 256.0)), (97, (2.0 ** -14, 256.0))], 256.0),
]


@pytest.mark.parametrize("probe,want", MEASURED_E5M2)
def test_emulation_gives_the_e5m2_sums_measured_on_the_card(probe, want):
    a, b = np.zeros((1, 128)), np.zeros((1, 128))
    for pos, (x, y) in probe:
        a[0, pos], b[0, pos] = x, y
    assert float(A.emulate_k11(a, b, a_kind=F8.E5M2)[0]) == want


def _e4m3(x):
    t = torch.from_numpy(np.clip(x, -448.0, 448.0).astype(np.float32))
    return t.to(torch.float8_e4m3fn).double().numpy()


def _operands(kind, n, k, seed):
    rs = np.random.RandomState(seed)
    if kind == "worst":  # each step: 2^8, then 31 products just under its
        a = np.full((n, k), 1.875 * 2.0 ** -6)  # grid (2^-5), all cut to 0
        a[:, ::32] = 256.0
        return a, np.ones((n, k))
    a, b = rs.randn(n, k) * 30.0, rs.randn(n, k) * 30.0
    if kind == "subnormal":  # a's codes mostly subnormal (below 2^-6)
        a = a * 2.0 ** -11
    if kind != "signed":
        a, b = np.abs(a), np.abs(b)
    return _e4m3(a), _e4m3(b)


def _magnitude(a, b, sa=1.0, sb=1.0):
    codes = [torch.from_numpy(x.astype(np.float32)).to(torch.float8_e4m3fn)
             .view(torch.uint8) for x in (a, b)]
    return F8.fp8_gemm_magnitude(codes[0], codes[1], F8.E4M3, F8.E4M3,
                                 torch.tensor(sa), torch.tensor(sb))


@pytest.mark.parametrize("kind,k", [("signed", 32), ("signed", 160),
                                    ("one-signed", 160),
                                    ("one-signed", 1024), ("worst", 128),
                                    ("worst", 160), ("one-signed", 8192),
                                    ("subnormal", 160)])
def test_emulated_k11_stays_within_the_bound(kind, k):
    a, b = _operands(kind, 48, k, seed=k)
    sa, sb = 0.01, 0.02
    got = A.emulate_k11(a, b, sa, sb).astype(np.float64)
    exact = (a * b).sum(axis=1) * sa * sb
    # each output's own row of a against its own row of b
    mag = _magnitude(a, b, sa, sb).diagonal()
    bound = F8.fp8_gemm_error_bound(mag, k).double().numpy()
    err = np.abs(got - exact)
    assert (err <= bound).all(), (err / bound).max()
    if kind != "signed":  # the cuts add up where the products share a sign
        assert (err > 0).all()


def test_a_k11_that_does_not_promote_goes_over_the_bound():
    a, b = _operands("one-signed", 48, 8192, seed=3)
    exact = (a * b).sum(axis=1)
    mag = _magnitude(a, b).diagonal()
    bound = F8.fp8_gemm_error_bound(mag, 8192).double().numpy()
    promoted = np.abs(A.emulate_k11(a, b) - exact)
    unpromoted = np.abs(A.emulate_k11(a, b, promote=False) - exact)
    assert (promoted <= bound).all()
    assert (unpromoted > 2 * bound).all(), (unpromoted / bound).min()


@pytest.mark.parametrize("a_kind,out_dtype", [(F8.E4M3, torch.float32),
                                              (F8.E5M2, torch.bfloat16)])
def test_sampled_check_flags_a_single_wrong_output(a_kind, out_dtype):
    """``fp8_accum.sample_mismatches`` (the card's exact check of K11)
    finds no difference in outputs made by the emulation, and finds one
    output moved by one unit in the last place, in its corner or among
    its random rows and columns."""
    m, n, k = 40, 24, 200
    rs = np.random.RandomState(7)
    a = F8.fp8_cast(torch.from_numpy(rs.randn(m, k).astype(np.float32)),
                    torch.tensor(0.01), a_kind, amax=False)[0]
    b = F8.fp8_cast(torch.from_numpy(rs.randn(n, k).astype(np.float32)),
                    torch.tensor(0.02), F8.E4M3, amax=False)[0]
    sa, sb = torch.tensor(0.01), torch.tensor(0.02)
    av = F8.decode(a, a_kind).double().numpy()
    bv = F8.decode(b, F8.E4M3).double().numpy()
    full = A.emulate_k11(np.repeat(av, n, axis=0), np.tile(bv, (m, 1)),
                         0.01, 0.02, a_kind=a_kind).reshape(m, n)
    got = torch.from_numpy(full).to(out_dtype)
    bad, size = A.sample_mismatches(a, b, a_kind, F8.E4M3, sa, sb, got)
    assert bad == 0 and size >= 64 + 16 * 8
    for r, c in ((0, 0), (m - 1, n - 1)):
        moved = got.clone()
        moved[r, c] = torch.nextafter(moved[r, c].float(),
                                      torch.tensor(np.inf)).to(out_dtype)
        if moved[r, c] == got[r, c]:  # bf16: one step of its own grid
            moved[r, c] = got[r, c].float() * (1 + 2.0 ** -7)
        assert A.sample_mismatches(a, b, a_kind, F8.E4M3, sa, sb,
                                   moved)[0] == 1
