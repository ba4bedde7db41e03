"""Recurrent sequence mixers in plain PyTorch: xLSTM's mLSTM and sLSTM,
Griffin's (RecurrentGemma's) causal depthwise conv1d and RG-LRU.

The JAX package computes these outside any Pallas kernel, so plain
PyTorch is their port on every device.  Each function keeps the numeric
form the reference has for it, not one shared form: the sequence RG-LRU
takes ``sqrt(max(1 - exp(2 log_a), 1e-12))``, the step
``sqrt(max(1 - a a, 1e-12))``; :func:`conv1d` and :func:`conv1d_carry`
sum in ``x.dtype``, :func:`conv1d_step` in f32.  The sequence RG-LRU
combines its elements in the reference's associative-scan order (the
odd/even recursion of ``jax.lax.associative_scan``).  Every recurrent
state is f32, with the log-domain stabilizer ``m`` of arXiv:2405.04517
for the two xLSTM cells.

The jitted reference reads the conv's output in two roundings: its
linears take the ``x.dtype`` sum, its RG-LRU (which casts to f32) the sum
with the last add unrounded (XLA drops a bf16 rounding that an f32 cast
reads right away).  So :func:`conv1d` and :func:`conv1d_carry` return
that f32 sum; rounded to ``x.dtype`` it is the reference's conv1d.

On the card, a decode step's sums over a row (the mLSTM's ``C q`` and
``n q`` and its gates' ``w_if`` product, the sLSTM's recurrent product)
go through :func:`layers.row_sum` over a row-major product, whose order
does not depend on how many slots the step carries (hazard H2: a batched
product's library kernel, and a strided row's sum, are chosen by the
batch).  On the CPU they sum in the jitted reference's order
(:func:`_contract`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import cuda
from repro_torch.models import cpu_math, layers

F32 = torch.float32


# ---------------------------------------------------------------------------
# causal depthwise conv1d
# ---------------------------------------------------------------------------

def _taps(xp: torch.Tensor, kernel: torch.Tensor, s: int) -> torch.Tensor:
    """sum_i xp[:, i:i+s] * kernel[w-1-i], left to right, each product and
    each add but the last rounded to xp's dtype -> f32."""
    w = kernel.shape[0]
    k = kernel.to(xp.dtype)
    y = xp[:, 0:s] * k[w - 1]
    for i in range(1, w - 1):
        y = y + xp[:, i:i + s] * k[w - 1 - i]
    if w == 1:
        return y.float()
    return y.float() + (xp[:, w - 1:w - 1 + s] * k[0]).float()


def conv1d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x (B, S, D), kernel (W, D) depthwise causal:
    y_t = sum_w kernel[w] x_{t-w}, zeros before the sequence; f32, its
    last add unrounded (``.to(x.dtype)`` is the reference's result)."""
    w = kernel.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, w - 1, 0))
    return _taps(xp, kernel, x.shape[1])


def conv1d_carry(buf: torch.Tensor, x: torch.Tensor,
                 kernel: torch.Tensor) -> torch.Tensor:
    """Chunked-prefill form: the left context is the (B, W-1, D) carry
    buffer of the previous chunk instead of zeros (f32 as
    :func:`conv1d`)."""
    xp = torch.cat([buf.to(x.dtype), x], dim=1)
    return _taps(xp, kernel, x.shape[1])


def conv1d_carry_out(buf: torch.Tensor, x: torch.Tensor,
                     valid_len: int) -> torch.Tensor:
    """The carry after a chunk: the last W-1 *valid* inputs (with
    ``valid_len`` < W-1 the old buffer's tail is kept; padding never enters
    the history)."""
    w1 = buf.shape[1]
    hist = torch.cat([buf.to(x.dtype), x], dim=1)
    return hist[:, valid_len:valid_len + w1]


def conv1d_step(buf: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor):
    """Decode step: buf (B, W-1, D) the previous inputs, x (B, 1, D).
    Sums the W taps in f32 and rounds once -> (y (B, 1, D), new buf).

    On the CPU in the jitted reference's order.  Its einsum is a
    vector-matrix product a channel (the taps against the (W, B) history),
    which XLA's CPU emitter sums over the taps in order, as one chain of
    fused multiply-adds an output where the host has FMA, except a lone
    column of its 8-wide tiles (the last where B = 1 mod 8; the first at
    B = 2) and every output on a host without FMA: those round each
    product first."""
    hist = torch.cat([buf, x], dim=1)                       # (B, W, D)
    h32, k32 = hist.to(F32), kernel.flip(0).to(F32)
    if cuda.on_card(hist):
        y = torch.einsum("bwd,wd->bd", h32, k32)
    else:
        b, fma = hist.shape[0], cpu_math.host_fma()
        h32, k32 = h32.transpose(1, 2), k32.t()[None]
        y = cpu_math.lanes_dot(h32, k32, fma=fma)
        lone = [b - 1] * (b % 8 == 1) + [0] * (b == 2)
        if fma and lone:
            y[lone] = cpu_math.lanes_dot(h32[lone], k32, fma=False)
    return y[:, None].to(x.dtype), hist[:, 1:]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

class RGLRUState(NamedTuple):
    h: torch.Tensor   # (B, D) f32

    @classmethod
    def zeros(cls, b: int, d: int, device) -> "RGLRUState":
        return cls(torch.zeros((b, d), dtype=F32, device=device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(cpu_math.exp(-x.abs()))


def _log_a(lam: torch.Tensor, r_gate: torch.Tensor, c: float):
    return (-c * _softplus(lam.to(F32))) * torch.sigmoid(r_gate.to(F32))


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Along axis 1: a0, b0, a1, b1, ... (a may be one longer than b)."""
    n = a.shape[1] + b.shape[1]
    out = a.new_empty((a.shape[0], n) + tuple(a.shape[2:]))
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _assoc_scan(elems):
    """``jax.lax.associative_scan(_combine, elems, axis=1)`` in its
    combine order: pairs reduced, the half scanned recursively, the even
    elements combined from the odd results."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _assoc_scan(list(reduced))
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd],
                        [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def rglru(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
          lam: torch.Tensor, c: float, state: RGLRUState,
          valid: torch.Tensor | None = None):
    """Sequence form: x, r_gate, i_gate (B, S, D) (gates pre-sigmoid), lam
    (D,) raw Lambda.  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t),
    a_t = exp(-c softplus(lam) sigmoid(r_t)).  ``valid`` (B, S) bool makes
    padding steps the identity (a = 1, b = 0), so a ragged chunk's final
    state is the unpadded one.  x may be f32 where the gates are not (the
    conv's unrounded sum).  -> (h (B, S, D) in the gates' dtype, the
    model's; new state)."""
    log_a = _log_a(lam, r_gate, c)                          # (B, S, D)
    gated = torch.sigmoid(i_gate.to(F32)) * x.to(F32)
    if valid is not None:
        keep = valid[..., None]
        log_a = torch.where(keep, log_a, 0.0)
        gated = torch.where(keep, gated, 0.0)
    a = cpu_math.exp(log_a)
    b_t = cpu_math.sqrt(torch.clamp(1.0 - cpu_math.exp(2.0 * log_a),
                                    min=1e-12)) * gated
    a_all = torch.cat([torch.ones_like(state.h[:, None]), a], dim=1)
    b_all = torch.cat([state.h[:, None], b_t], dim=1)
    _, h_all = _assoc_scan([a_all, b_all])
    return h_all[:, 1:].to(r_gate.dtype), RGLRUState(h_all[:, -1])


def rglru_step(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
               lam: torch.Tensor, c: float, state: RGLRUState):
    """One decode token: x, r_gate, i_gate (B, 1, D)."""
    a = cpu_math.exp(_log_a(lam, r_gate[:, 0], c))
    gated = torch.sigmoid(i_gate[:, 0].to(F32)) * x[:, 0].to(F32)
    h = a * state.h + cpu_math.sqrt(torch.clamp(1.0 - a * a,
                                                min=1e-12)) * gated
    return h[:, None].to(x.dtype), RGLRUState(h)


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------

def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -_softplus(-x)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last axis, in an order a row keeps whatever
    the rows beside it (:func:`layers.row_sum`).  The product is laid out
    row-major first: a product of a transposed operand keeps its strides,
    and a reduction over a strided row orders its sum by the number of
    rows (hazard H2)."""
    return layers.row_sum((a * b).contiguous())[..., 0]


def _contract(eq: str, a: torch.Tensor, b: torch.Tensor, lanes: int = 1,
              fma: bool = True) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` for one contracted index, f32.  On the
    CPU it sums in the jitted reference's order (``cpu_math.lanes_dot``),
    which XLA's CPU dot emitters fix by the operands' layout; at the
    shapes the tests hold: 4 lanes for the chunk's q k^T and C q and the
    gates' ``w_if`` product, 8 for the step's C q, one lane for P V, q n, the
    step's n q and the memory's update, unfused products for the chunk's
    row-by-row sum of the weighted q k^T (fault F5: the mLSTM's
    normalizer cancels, so the last bits of these sums decide bf16
    roundings and, on some traces, greedy tokens).  On the card
    ``torch.einsum``."""
    if cuda.on_card(a):
        return torch.einsum(eq, a, b)
    ins, out = eq.split("->")
    ia, ib = ins.split(",")
    (c,) = [x for x in ia if x in ib and x not in out]

    def lay(t, idx):
        # the output's axes (1 where t lacks one), then the contracted one
        t = t.permute(*[idx.index(x) for x in out if x in idx],
                      idx.index(c))
        shape = [t.shape[[x for x in out if x in idx].index(x)]
                 if x in idx else 1 for x in out]
        return t.reshape(*shape, t.shape[-1])
    return cpu_math.lanes_dot(lay(a, ia), lay(b, ib), lanes, fma)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over axis 1.  On the CPU each prefix is
    summed left to right in x's dtype, as the jitted reference's
    ``reduce_window`` does (torch's CPU cumsum accumulates in f64); on the
    card torch's scan, one launch."""
    if cuda.on_card(x):
        return torch.cumsum(x, dim=1)
    out = x.clone()
    for t in range(1, x.shape[1]):
        out[:, t] = out[:, t - 1] + x[:, t]
    return out


def rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) in f32, each row summed alone: on the card in
    an order that does not depend on how many rows there are (hazard H2;
    a decode step's rows are its slots), on the CPU in the reference's
    order (:func:`_contract`)."""
    x = x.to(F32)
    if cuda.on_card(x):
        return _dot(x[..., None, :], w.to(F32).t().contiguous())
    flat = _contract("mk,kn->mn", x.reshape(-1, x.shape[-1]), w.to(F32),
                     lanes=4)
    return flat.reshape(*x.shape[:-1], w.shape[-1])


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, NH, dh, dh) stabilized matrix memory C exp(-m)
    n: torch.Tensor   # (B, NH, dh)
    m: torch.Tensor   # (B, NH)

    @classmethod
    def zeros(cls, b: int, nh: int, dh: int, device,
              lead: tuple = (), rows: int | None = None) -> "MLSTMState":
        """The fresh state (``m`` at -1e30); ``lead`` prepends axes (a
        segment's layers); ``rows`` of ``c`` (a block of its first dh
        axis, the ``v`` side) in place of all dh."""
        def z(*shape):
            return torch.zeros(lead + shape, dtype=F32, device=device)
        return cls(z(b, nh, dh if rows is None else rows, dh), z(b, nh, dh),
                   torch.full(lead + (b, nh), -1e30, dtype=F32,
                              device=device))


def mlstm_step(state: MLSTMState, q, k, v, i_raw, f_raw):
    """One token: q, k, v (B, NH, dh); i_raw, f_raw (B, NH) ->
    (h (B, NH, dh) f32, new state)."""
    lf = _log_sigmoid(f_raw.to(F32))
    i32 = i_raw.to(F32)
    m_new = torch.maximum(lf + state.m, i32)
    fp = cpu_math.exp(lf + state.m - m_new)
    ip = cpu_math.exp(i32 - m_new)
    k32, v32, q32 = k.to(F32), v.to(F32), q.to(F32)
    c = fp[..., None, None] * state.c + ip[..., None, None] * (
        v32[..., :, None] * k32[..., None, :])
    n = fp[..., None] * state.n + ip[..., None] * k32
    if cuda.on_card(c):
        num, nq = _dot(c, q32[..., None, :]), _dot(n, q32)
    else:
        num = _contract("bhij,bhj->bhi", c, q32, lanes=8)
        nq = _contract("bhj,bhj->bh", n, q32)
    den = torch.maximum(nq.abs(), cpu_math.exp(-m_new))
    return num / den[..., None], MLSTMState(c, n, m_new)


def mlstm_sequential(q, k, v, i_raw, f_raw, state: MLSTMState):
    """The oracle: :func:`mlstm_step` over time.  q, k, v (B, S, NH, dh);
    i_raw, f_raw (B, S, NH)."""
    hs = []
    for t in range(q.shape[1]):
        h, state = mlstm_step(state, q[:, t], k[:, t], v[:, t], i_raw[:, t],
                              f_raw[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), state


def _mlstm_chunk(st: MLSTMState, qt, kt, vt, it, ft):
    """One chunk of :func:`mlstm_chunkwise`: the quadratic form inside it
    and the carried state's share, then the boundary update."""
    chunk = qt.shape[1]
    qt, kt, vt = qt.to(F32), kt.to(F32), vt.to(F32)
    it, ft = it.to(F32), ft.to(F32)
    lf = _log_sigmoid(ft)                                   # (B, L, NH)
    bcum = _cumsum(lf)
    g = bcum[:, -1]                                         # (B, NH)
    # log-scales: inter a_t = b_t + m_prev; intra D_ts = b_t - b_s + i_s
    a_inter = bcum + st.m[:, None, :]
    dmat = bcum[:, :, None, :] - bcum[:, None, :, :] + it[:, None, :, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=qt.device))
    dmat = torch.where(tri[None, :, :, None], dmat, -torch.inf)
    m_t = torch.maximum(a_inter, dmat.amax(dim=2))          # (B, L, NH)
    w_inter = cpu_math.exp(a_inter - m_t)
    w_intra = cpu_math.exp(dmat - m_t[:, :, None, :])          # (B, t, s, NH)
    sqk = _contract("blhd,bshd->blsh", qt, kt, lanes=4)
    wq = w_intra * sqk
    num = (_contract("blsh,bshd->blhd", wq, vt)
           + w_inter[..., None] * _contract("blhd,bhed->blhe", qt, st.c,
                                            lanes=4))
    den = (_contract("blsh,blsh->blh", w_intra, sqk, fma=False)
           + w_inter * _contract("blhd,bhd->blh", qt, st.n))
    den = torch.maximum(den.abs(), cpu_math.exp(-m_t))
    h = num / den[..., None]                                # (B, L, NH, dh)
    # boundary update
    scale_s = g[:, None, :] - bcum + it
    m_new = torch.maximum(g + st.m, scale_s.amax(dim=1))
    w_old = cpu_math.exp(g + st.m - m_new)
    w_s = cpu_math.exp(scale_s - m_new[:, None, :])            # (B, L, NH)
    c_new = (w_old[..., None, None] * st.c
             + _contract("blhd,blhe->bhde", w_s[..., None] * vt, kt))
    n_new = (w_old[..., None] * st.n
             + _contract("blh,blhd->bhd", w_s, kt))
    return MLSTMState(c_new, n_new, m_new), h


def mlstm_chunkwise(q, k, v, i_raw, f_raw, state: MLSTMState, chunk: int):
    """Chunkwise-parallel mLSTM: q, k, v (B, S, NH, dh), i_raw, f_raw
    (B, S, NH) -> (h (B, S, NH, dh) f32, the state after S).  A ragged
    tail is padded with finite state-neutral gates (i = -1e30: nothing
    inserted; f = +1e30: no decay), so the returned state is the unpadded
    one; inside a chunk the causal mask is -inf.  Chunks run in order,
    each as the reference's scan body."""
    b, s, nh, dh = q.shape
    pad = (-s) % chunk
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   for a in (q, k, v))
        i_raw = torch.nn.functional.pad(i_raw, (0, 0, 0, pad), value=-1e30)
        f_raw = torch.nn.functional.pad(f_raw, (0, 0, 0, pad), value=1e30)
    hs = []
    for j in range(0, s + pad, chunk):
        cut = slice(j, j + chunk)
        state, h = _mlstm_chunk(state, q[:, cut], k[:, cut], v[:, cut],
                                i_raw[:, cut], f_raw[:, cut])
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :s], state


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, D) stabilized cell
    n: torch.Tensor   # (B, D)
    m: torch.Tensor   # (B, D)
    h: torch.Tensor   # (B, D) output (enters the recurrence)

    @classmethod
    def zeros(cls, b: int, d: int, device, lead: tuple = ()) -> "SLSTMState":
        def z():
            return torch.zeros(lead + (b, d), dtype=F32, device=device)
        return cls(z(), z(), torch.full(lead + (b, d), -1e30, dtype=F32,
                                        device=device), z())


def slstm_step(state: SLSTMState, x_gates, r_kernel, nh: int):
    """x_gates (B, 4D), the input's preactivations; r_kernel (4, NH, dh,
    dh), the block-diagonal recurrent weights applied to h.  -> (new
    state, h (B, D) f32)."""
    b, d4 = x_gates.shape
    d = d4 // 4
    dh = d // nh
    hprev = state.h.reshape(b, 1, nh, 1, dh)
    rec = _dot(hprev, r_kernel.to(F32).transpose(-1, -2).contiguous())
    gates = x_gates.to(F32).reshape(b, 4, nh, dh) + rec
    zt = cpu_math.tanh(gates[:, 0]).reshape(b, d)
    it = gates[:, 1].reshape(b, d)
    lf = _log_sigmoid(gates[:, 2]).reshape(b, d)
    ot = torch.sigmoid(gates[:, 3]).reshape(b, d)
    m_new = torch.maximum(lf + state.m, it)
    fp, ip = cpu_math.exp(lf + state.m - m_new), cpu_math.exp(it - m_new)
    c = fp * state.c + ip * zt
    n = fp * state.n + ip
    h = ot * c / torch.maximum(n, cpu_math.exp(-m_new))
    return SLSTMState(c, n, m_new, h), h


def slstm_sequence(x_gates, r_kernel, state: SLSTMState, nh: int,
                   valid: torch.Tensor | None = None):
    """x_gates (B, S, 4D) -> (h (B, S, D) f32, the state after S): the
    true recurrence, one step per token.  ``valid`` (B, S) bool passes the
    state through unchanged at padding steps (chunked prefill)."""
    hs = []
    for t in range(x_gates.shape[1]):
        new, h = slstm_step(state, x_gates[:, t], r_kernel, nh)
        if valid is not None:
            keep = valid[:, t, None]
            new = SLSTMState(*(torch.where(keep, a, o)
                               for a, o in zip(new, state)))
        state = new
        hs.append(h)
    return torch.stack(hs, dim=1), state
