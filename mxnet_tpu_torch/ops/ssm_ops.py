"""The linear-attention (SSM) recurrence of hybrid serving stacks.

Counterpart of ``mxnet_tpu/ops/ssm_ops.py``.  The layer is retention-style
linear attention with a fixed per-head decay and no parameters of its own
(the block's ``attn_in`` projections feed it):

    state_t = gamma_h * state_{t-1} + k_t (outer) v_t      # (D, D) a head
    y_t     = (q_t * scale) . state_t                      # (D,)

:func:`ssm_scan` is kernel K10 (``csrc/ssm_scan.cu``) on CUDA tensors and
its plain version :func:`ssm_scan_plain` on CPU tensors.  Both run the
same operations per row whatever the row count: a chunked prefill over T
rows, T single-row decode steps, a W-row speculative verify and the
full-context oracle give the same states and outputs bit for bit.  The
readout's sum over the state's first axis runs in the kernel's fixed
order (lane partials over ``i = l, l + 32, ...``, then the warp
butterfly), which the plain version reproduces with tensor ops, so the
two give the same bits too.  Padded rows (``row_valid`` False) leave the
state exactly unchanged and output 0.
"""
from __future__ import annotations

import torch

from .. import _cuda
from ..base import MXNetError

__all__ = ["ssm_decay", "ssm_scan", "ssm_scan_plain"]

_LANES = 32  # csrc/ssm_scan.cu: a warp's lanes split the state's rows
_MAX_HEAD_DIM = 256


def ssm_decay(num_heads, device=None):
    """The fixed per-head decay ``gamma_h = 1 - 2**-(5 + h)`` (float32,
    shape (H,)): head 0 remembers ~32 tokens, each further head doubles
    the horizon.  Bit-equal to the JAX package's."""
    if num_heads < 1:
        raise MXNetError("ssm_decay: num_heads must be >= 1, got %d"
                         % num_heads)
    h = torch.arange(num_heads, dtype=torch.float32, device=device)
    return 1.0 - torch.exp2(-(5.0 + h))


def _readout(q, new):
    """sum_i q[..., i] * new[..., i, :] in K10's order: lane l's partial
    over i = l, l + 32, ... from +0, then the butterfly 16, 8, 4, 2, 1
    (commutative adds, so ``p[:o] + p[o:2o]`` is lane 0's tree)."""
    d = q.shape[-1]
    pad = -d % _LANES
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
        new = torch.nn.functional.pad(new, (0, 0, 0, pad))
    part = torch.zeros(q.shape[:-1] + (_LANES, new.shape[-1]),
                       dtype=torch.float32, device=q.device)
    for c in range(0, q.shape[-1], _LANES):
        part = part + q[..., c:c + _LANES, None] * new[..., c:c + _LANES, :]
    o = _LANES // 2
    while o:
        part = part[..., :o, :] + part[..., o:2 * o, :]
        o //= 2
    return part[..., 0, :]


def _prepare(q, state0, scale):
    if q.dim() != 4:
        raise MXNetError("ssm_scan: expected (S, T, H, D) inputs, got %r"
                         % (tuple(q.shape),))
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s, _, h, _ = q.shape
    if tuple(state0.shape) != (s, h, d, d):
        raise MXNetError("ssm_scan: state0 %r does not match (S, H, D, D) "
                         "= %r" % (tuple(state0.shape), (s, h, d, d)))
    return float(scale)


def ssm_scan_plain(q, k, v, state0, gamma, scale=None, row_valid=None,
                   collect=False):
    """Plain version of kernel K10: a loop over the T rows with the JAX
    package's per-row operations (``new = g * state + k (outer) v``, a
    ``where`` on padded rows, the readout in K10's order, padded outputs
    0).  Returns ``(y, state)`` or, with ``collect``, ``(y, state,
    states)``; see :func:`ssm_scan`."""
    scale = _prepare(q, state0, scale)
    t = q.shape[1]
    q32 = q.float() * scale
    k32, v32 = k.float(), v.float()
    g = gamma.float()[:, None, None]
    state = state0.float()
    ys, snaps = [], []
    for i in range(t):
        new = g * state + k32[:, i, :, :, None] * v32[:, i, :, None, :]
        if row_valid is not None:
            valid = row_valid[:, i].bool()
            new = torch.where(valid[:, None, None, None], new, state)
        yt = _readout(q32[:, i], new)
        if row_valid is not None:
            yt = torch.where(valid[:, None, None], yt, torch.zeros_like(yt))
        ys.append(yt)
        if collect:
            snaps.append(new)
        state = new
    if ys:
        y = torch.stack(ys, dim=1)
    else:
        y = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    if collect:
        states = torch.stack(snaps) if snaps else state.new_zeros(
            (0,) + tuple(state.shape))
        return y, state, states
    return y, state


def _ssm_scan_cuda(q, k, v, state0, gamma, scale, row_valid, collect,
                   out_state):
    s, t, h, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != tuple(q.shape):
            raise MXNetError("ssm_scan: %s %r does not match q %r"
                             % (name, tuple(x.shape), tuple(q.shape)))
    tensors = [q, k, v, state0, gamma]
    if any(x.dtype != torch.float32 for x in tensors):
        raise MXNetError("ssm_scan: the CUDA kernel takes float32 inputs")
    if tuple(gamma.shape) != (h,):
        raise MXNetError("ssm_scan: gamma %r, expected (%d,)"
                         % (tuple(gamma.shape), h))
    if d > _MAX_HEAD_DIM:
        raise MXNetError("ssm_scan: head_dim %d above the kernel's %d"
                         % (d, _MAX_HEAD_DIM))
    if row_valid is not None:
        if tuple(row_valid.shape) != (s, t):
            raise MXNetError("ssm_scan: row_valid %r, expected (%d, %d)"
                             % (tuple(row_valid.shape), s, t))
        tensors.append(row_valid)
        row_valid = row_valid.to(torch.bool).contiguous()
    if out_state is not None:
        if out_state.dtype != torch.float32 \
                or tuple(out_state.shape) != tuple(state0.shape) \
                or not out_state.is_contiguous():
            raise MXNetError("ssm_scan: out_state must be a contiguous "
                             "float32 %r" % (tuple(state0.shape),))
        tensors.append(out_state)
    if any(x.device != q.device for x in tensors):
        raise MXNetError("ssm_scan: inputs on different devices")
    q, k, v, gamma = (x.contiguous() for x in (q, k, v, gamma))
    if not state0.is_contiguous():
        state0 = state0.contiguous()
    y = torch.empty_like(q)
    states = (torch.empty((t,) + tuple(state0.shape), dtype=torch.float32,
                          device=q.device) if collect else None)
    if out_state is not None:
        state, state_ptr = out_state, out_state.data_ptr()
    elif collect and t:  # the last snapshot is the state: no second copy
        state, state_ptr = states[t - 1], None
    else:
        state = torch.empty_like(state0)
        state_ptr = state.data_ptr()
    with torch.cuda.device(q.device):
        _cuda.launch("ssm_scan", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     state0.data_ptr(), gamma.data_ptr(),
                     row_valid.data_ptr() if row_valid is not None else None,
                     y.data_ptr(), state_ptr,
                     states.data_ptr() if collect else None, s, t, h, d,
                     scale, _cuda.stream_of(q))
    return (y, state, states) if collect else (y, state)


def ssm_scan(q, k, v, state0, gamma, scale=None, row_valid=None,
             collect=False, out_state=None):
    """Scan the linear-attention recurrence over T rows.

    q/k/v: (S, T, H, D); state0: (S, H, D, D) float32, the state before
    row 0; gamma: (H,) float32 decay; row_valid: optional (S, T) bool,
    False rows (bucket padding) leave the state exactly unchanged and
    output 0.  Returns ``(y, state)``, y (S, T, H, D) float32 and the
    state after the last row, or with ``collect`` ``(y, state, states)``,
    states (T, S, H, D, D) the state after each row.  On CUDA tensors this
    is kernel K10, which writes the final state into ``out_state`` when
    given (``state0`` itself updates in place); on CPU tensors
    :func:`ssm_scan_plain` (``out_state``, if given, is copied into)."""
    scale = _prepare(q, state0, scale)
    if q.is_cuda:
        return _ssm_scan_cuda(q, k, v, state0, gamma, scale, row_valid,
                              collect, out_state)
    res = ssm_scan_plain(q, k, v, state0, gamma, scale, row_valid, collect)
    if out_state is not None:
        out_state.copy_(res[1])
        res = (res[0], out_state) + res[2:]
    return res
