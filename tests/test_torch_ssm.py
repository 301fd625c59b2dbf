"""The port's SSM recurrence (``mxnet_tpu_torch/ops/ssm_ops.py``, kernel
K10's plain version on the CPU) against the JAX package's
``mxnet_tpu/ops/ssm_ops.py``.

Inputs are made with numpy from a seed and given to both.  Across the
packages the outputs and states agree within rtol 1e-5, atol 1e-6 (fp32;
the readout's sum over D runs in another order there).  Inside the port,
the recurrence contract holds bit for bit: one T-row scan == chunks ==
serial single rows == a W-row ``collect`` scan's snapshots, and padded
rows leave the state exactly unchanged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import ssm_ops as jssm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import ssm_ops as tssm

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, s, t, h, d, state_scale=0.0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(s, t, h, d).astype(np.float32) for _ in range(3))
    state0 = (state_scale * rs.randn(s, h, d, d)).astype(np.float32)
    return q, k, v, state0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("heads", [1, 4, 24])
def test_ssm_decay_bit_equal_to_jax(heads):
    want = np.asarray(jssm.ssm_decay(heads))
    got = tssm.ssm_decay(heads).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    with pytest.raises(MXNetError):
        tssm.ssm_decay(0)


@pytest.mark.parametrize("d", [32, 48, 16])
def test_ssm_scan_matches_jax(d):
    """Outputs, final state and every snapshot against the JAX scan, with
    padded rows and a nonzero starting state."""
    s, t, h = 2, 9, 2
    q, k, v, state0 = _inputs(1, s, t, h, d, state_scale=0.1)
    valid = np.ones((s, t), bool)
    valid[0, 6:] = False
    valid[1, 3] = False
    gamma = np.asarray(jssm.ssm_decay(h))
    jy, js, jstates = jssm.ssm_scan(
        *(jnp.asarray(x) for x in (q, k, v, state0)), jnp.asarray(gamma),
        row_valid=jnp.asarray(valid), collect=True)
    ty, ts, tstates = tssm.ssm_scan(*_t(q, k, v, state0),
                                    torch.from_numpy(np.array(gamma)),
                                    row_valid=torch.from_numpy(valid),
                                    collect=True)
    for got, want in ((ty, jy), (ts, js), (tstates, jstates)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert float(ty[0, 6:].abs().max()) == 0.0  # padded rows output 0


def test_ssm_chunked_equals_serial_equals_collect_bitwise():
    """One T = 16 scan == two chunks of 8 == 16 single rows == the
    snapshots of a collect scan, bit for bit (the serving contract)."""
    s, t, h, d = 2, 16, 2, 32
    q, k, v, state0 = _t(*_inputs(5, s, t, h, d))
    gamma = tssm.ssm_decay(h)
    y_full, s_full = tssm.ssm_scan(q, k, v, state0, gamma)

    y_a, s_mid = tssm.ssm_scan(q[:, :8], k[:, :8], v[:, :8], state0, gamma)
    y_b, s_chunk = tssm.ssm_scan(q[:, 8:], k[:, 8:], v[:, 8:], s_mid, gamma)
    assert torch.equal(torch.cat([y_a, y_b], dim=1), y_full)
    assert torch.equal(s_chunk, s_full)

    state, rows, serial_states = state0, [], []
    for i in range(t):
        y_i, state = tssm.ssm_scan(q[:, i:i + 1], k[:, i:i + 1],
                                   v[:, i:i + 1], state, gamma)
        rows.append(y_i)
        serial_states.append(state)
    assert torch.equal(torch.cat(rows, dim=1), y_full)
    assert torch.equal(state, s_full)

    # a W-row verify from the state after row 10: its snapshots are the
    # serial states, its last one the final state
    w = 5
    y_w, s_w, snaps = tssm.ssm_scan(q[:, 11:11 + w], k[:, 11:11 + w],
                                    v[:, 11:11 + w], serial_states[10],
                                    gamma, collect=True)
    assert snaps.shape == (w, s, h, d, d)
    for j in range(w):
        assert torch.equal(snaps[j], serial_states[11 + j])
    assert torch.equal(s_w, serial_states[15])
    assert torch.equal(y_w, y_full[:, 11:16])


def test_ssm_padded_rows_are_an_exact_identity():
    """Rows marked invalid pass the state through untouched (a select, not
    a multiply by 0) and output 0: a ragged scan equals the short one."""
    s, t, h, d = 2, 12, 2, 32
    q, k, v, state0 = _t(*_inputs(7, s, t, h, d, state_scale=0.3))
    gamma = tssm.ssm_decay(h)
    valid = torch.arange(t)[None, :] < torch.tensor([[10], [4]])
    y_r, s_r, snaps = tssm.ssm_scan(q, k, v, state0, gamma, row_valid=valid,
                                    collect=True)
    for b, n in ((0, 10), (1, 4)):
        y_s, s_s = tssm.ssm_scan(q[b:b + 1, :n], k[b:b + 1, :n],
                                 v[b:b + 1, :n], state0[b:b + 1], gamma)
        assert torch.equal(s_r[b:b + 1], s_s)
        assert torch.equal(y_r[b:b + 1, :n], y_s)
        assert float(y_r[b, n:].abs().max()) == 0.0
        for j in range(n, t):  # every snapshot past the end is the state
            assert torch.equal(snaps[j, b], s_s[0])
    # an all-padded row leaves a nonzero state bit for bit as it was
    none = torch.zeros((s, 1), dtype=torch.bool)
    _, same = tssm.ssm_scan(q[:, :1], k[:, :1], v[:, :1], state0, gamma,
                            row_valid=none)
    assert torch.equal(same, state0)


def test_ssm_readout_order_is_lane_partials_then_butterfly():
    """The plain readout sums in K10's order: lane l over i = l, l + 32,
    ... from +0, then the xor butterfly 16, 8, 4, 2, 1 (emulated here one
    lane and one scalar add at a time)."""
    rs = np.random.RandomState(3)
    d = 64
    qv = rs.randn(d).astype(np.float32)
    m = rs.randn(d, 3).astype(np.float32)
    got = tssm._readout(torch.from_numpy(qv)[None], torch.from_numpy(m)[None])
    for j in range(3):
        lanes = []
        for lane in range(32):
            p = np.float32(0.0)
            for i in range(lane, d, 32):
                p = np.float32(p + np.float32(qv[i] * m[i, j]))
            lanes.append(p)
        o = 16
        while o:
            lanes = [np.float32(lanes[x] + lanes[x ^ o]) for x in range(32)]
            o //= 2
        assert got[0, j].numpy().view(np.uint32) == \
            np.float32(lanes[0]).view(np.uint32)


@pytest.mark.parametrize("lp", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [40, 128])
def test_ssm_readout_in_k10s_threads_is_the_plain_order(lp, d):
    """K10 (csrc/ssm_scan.cu) splits a column's readout over 32 / lp
    threads: thread l0 holds partials l = l0 + (32 / lp) m, adds the
    tree's levels o = 16 .. 32 / lp itself and leaves one value; one
    thread adds the levels below over those values.  A thread's rows i
    >= D (zero q, k and state) are left out of the update and the
    partial, so an infinite v (column 3) gives the plain version's +inf,
    where 0 x inf would give a NaN.  Emulated one scalar add at a time,
    it gives the plain readout's bits."""
    rs = np.random.RandomState(lp + d)
    dc = -(-d // 32)
    nl = 32 // lp
    g = np.float32(0.96875)
    qv = np.zeros(32 * dc, np.float32)
    kv = np.zeros(32 * dc, np.float32)
    qv[:d] = np.abs(rs.randn(d))
    kv[:d] = np.abs(rs.randn(d))
    vv = np.r_[-np.abs(rs.randn(3)), np.inf].astype(np.float32)
    st = np.zeros((32 * dc, 4), np.float32)
    st[:d] = rs.randn(d, 4)
    with np.errstate(invalid="ignore"):  # the padded rows' 0 x inf
        st = ((g * st).astype(np.float32) + (kv[:, None] * vv[None, :])
              .astype(np.float32)).astype(np.float32)
    want = tssm._readout(torch.from_numpy(qv[:d])[None],
                         torch.from_numpy(st[:d])[None])
    assert want[0, 3].item() == np.inf
    for j in range(4):
        left = []
        for l0 in range(nl):
            pm = []
            for m in range(lp):
                lane, p = l0 + nl * m, np.float32(0.0)
                for c in range(dc):
                    i = lane + 32 * c
                    if i < d:
                        p = np.float32(p + np.float32(qv[i] * st[i, j]))
                pm.append(p)
            w = lp // 2
            while w:
                pm = [np.float32(pm[m] + pm[m + w]) for m in range(w)]
                w //= 2
            left.append(pm[0])
        o = nl // 2
        while o:
            left = [np.float32(left[x] + left[x + o]) for x in range(o)]
            o //= 2
        assert want[0, j].numpy().view(np.uint32) == \
            np.float32(left[0]).view(np.uint32)


def test_ssm_scan_rejects_bad_shapes():
    q, k, v, state0 = _t(*_inputs(0, 1, 2, 2, 8))
    gamma = tssm.ssm_decay(2)
    with pytest.raises(MXNetError, match="state0"):
        tssm.ssm_scan(q, k, v, state0[:, :1], gamma)
    with pytest.raises(MXNetError, match="S, T, H, D"):
        tssm.ssm_scan(q[0], k[0], v[0], state0, gamma)
