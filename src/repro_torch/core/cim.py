"""Behavioral circuit model of the paper's CiM array (paper §III–IV).

A phenomenological model of the ReRAM array and the modified peripheral
sensing of Fig. 2, calibrated to the paper's operating points:

* Cu/HfO2/Pt ReRAM: LRS = 10 kOhm, HRS = 3 GOhm;
* bit-line precharge V_BL = 100 mV;
* accessed-cell currents I(LRS) = 7.85 uA (series access-FET resistance
  R_ACC = V/I - LRS = 2.74 kOhm), I(HRS) = 33 pA; two accessed cells sum on
  the sense line (I_11 = 15.7 uA, I_01 = 7.87 uA, I_00 ~ 0.1 nA);
* unaccessed-cell leakage 774 pA (LRS) and 28 pA (HRS), state-dependent
  constants as the paper reports them.

Currents are float32 tensors on any device, as in the reference (JAX's
default float32); every function treats the trailing two axes of the
resistance as (rows, cols) and broadcasts over leading bank axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import logic

V_BL = 0.1                    # bit-line precharge (V)
LRS = 10e3                    # low-resistance state (Ohm)
HRS = 3e9                     # high-resistance state (Ohm)
R_ACC = V_BL / 7.85e-6 - LRS  # access-FET on-resistance ~ 2.74 kOhm
LEAK_LRS = 774e-12            # unaccessed LRS leakage (A)
LEAK_HRS = 28e-12             # unaccessed HRS leakage (A)
R_MIRROR = 12e3               # current-mirror load: V_node = I * R_MIRROR
GM_OVER_I = 2.0               # V_t mismatch -> reference shift (1/V)
READ_REF = 4e-6               # memory-mode read reference (one cell)


class ArrayState(NamedTuple):
    """One CiM array, or a stack of banks sharing geometry.

    ``r`` is (..., rows, cols) resistance in Ohm, float32."""
    r: torch.Tensor
    leak_lrs: torch.Tensor
    leak_hrs: torch.Tensor


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def make_array(bits, lrs=LRS, hrs=HRS, leak_lrs=LEAK_LRS,
               leak_hrs=LEAK_HRS) -> ArrayState:
    """Program an array from a (..., rows, cols) 0/1 matrix ('1' -> LRS);
    leading axes are independent banks."""
    bits = torch.as_tensor(bits)
    dev = bits.device
    r = torch.where(bits.bool(), _f32(lrs, dev), _f32(hrs, dev))
    return ArrayState(r, _f32(leak_lrs, dev), _f32(leak_hrs, dev))


def write(state: ArrayState, row: int, col: int, bit) -> ArrayState:
    """Memory-mode write of cell (row, col) in every bank (``bit`` may be
    bank-shaped); returns a new state, the old one is untouched."""
    new_r = torch.where(torch.as_tensor(bit, device=state.r.device).bool(),
                        _f32(LRS, state.r.device), _f32(HRS, state.r.device))
    r = state.r.clone()
    r[..., row, col] = new_r
    return state._replace(r=r)


def _wl_one_hot(num_rows: int, *row_indices, device=None) -> torch.Tensor:
    """OR of one-hot row selects: (..., P, rows) for (..., P) indices."""
    rows = torch.arange(num_rows, device=device)
    wl = torch.zeros((), dtype=torch.bool, device=device)
    for idx in row_indices:
        wl = wl | (rows == torch.as_tensor(idx, device=device)[..., None])
    return wl


def sl_currents(state: ArrayState, wl_mask: torch.Tensor) -> torch.Tensor:
    """Sense-line current per column for a word-line mask (..., rows):
    accessed rows contribute V_BL / (R_cell + R_ACC), unaccessed rows their
    state-dependent leakage; the column sums are the analog result."""
    accessed = wl_mask.bool()[..., :, None]
    i_on = V_BL / (state.r + R_ACC)
    is_lrs = state.r < (LRS + HRS) / 2
    i_leak = torch.where(is_lrs, state.leak_lrs, state.leak_hrs)
    return torch.where(accessed, i_on, i_leak).sum(-2)


def compute(state: ArrayState, row_a, row_b, op: str = "xor", offset1=0.0,
            offset2=0.0) -> torch.Tensor:
    """Single-cycle in-memory Boolean op between two rows, all columns.

    ``row_a``/``row_b`` are ints (one row pair) or integer arrays (..., P)
    naming P pairs per bank; the result gains a (..., P) prefix."""
    dev = state.r.device
    ra, rb = torch.as_tensor(row_a, device=dev), torch.as_tensor(row_b,
                                                                 device=dev)
    wl = _wl_one_hot(state.r.shape[-2], ra, rb, device=dev)
    if ra.ndim or rb.ndim:
        state = state._replace(r=state.r[..., None, :, :])
    i_sl = sl_currents(state, wl)
    return logic.sense_datapath(i_sl, logic.op_table()[op], offset1, offset2)


def read(state: ArrayState, row, offset=0.0) -> torch.Tensor:
    """Memory-mode read of one row, or (P,)/(..., P) rows."""
    dev = state.r.device
    rv = torch.as_tensor(row, device=dev)
    wl = _wl_one_hot(state.r.shape[-2], rv, device=dev)
    if rv.ndim:
        state = state._replace(r=state.r[..., None, :, :])
    return sl_currents(state, wl) > (READ_REF + offset)


def node_voltages(i_cell: torch.Tensor, i_ref: torch.Tensor):
    """CSA internal nodes (Fig. 5(e)): the mirror turns current to voltage."""
    return i_cell * R_MIRROR, i_ref * R_MIRROR


def vt_offset_to_iref_shift(delta_vt: torch.Tensor,
                            i_ref: float) -> torch.Tensor:
    """Comparator V_t mismatch -> equivalent reference-current shift,
    dI = (gm/I) * I_ref * dVt."""
    return delta_vt * GM_OVER_I * i_ref
