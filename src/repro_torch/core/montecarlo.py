"""Monte-Carlo variation analysis (paper §V, Fig. 5) and array scalability.

* The 5000-point Monte-Carlo over Gaussian LRS/HRS (3 sigma = 10 % of the
  mean) and comparator V_t (sigma = 25 mV): sense-line currents, CSA node
  voltages (Fig. 5(c), 5(d)) and the per-input error rate of the XOR
  datapath.
* The max-rows-against-HRS/LRS analysis (Fig. 5(b)): leakage from the
  unaccessed rows drags I_00 toward REF1; the row budget is where the
  worst-case '00' current crosses it, with margin.

Each world is split into its **draws** (:class:`Draws`: the normals and
the unaccessed cells' bits, from an explicit ``torch.Generator``) and a
deterministic **evaluation** of them (:func:`evaluate`), which computes
every sample x bank at once.  The evaluation follows the reference's f32
arithmetic step for step (true divisions, the reference's mean; only the
row sums are rounded once from f64), so given the reference's own draws
it reproduces its results; JAX's threefry
stream itself is not reproduced, so :func:`run` gives other worlds than
the reference from the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import cim, logic

SIGMA_FRAC = 0.10 / 3.0   # 3 sigma = 10 % of the mean
SIGMA_VT = 25e-3          # V
_F32 = torch.float32


class Draws(NamedTuple):
    """The random part of ``samples x banks`` worlds of one column: the
    accessed pair and ``rows - 2`` unaccessed cells."""
    z_lrs: torch.Tensor      # (samples, banks, rows) standard normals
    z_hrs: torch.Tensor      # (samples, banks, rows)
    z_vt1: torch.Tensor      # (samples, banks) CSA1 V_t normal
    z_vt2: torch.Tensor      # (samples, banks) CSA2 V_t normal
    unacc: torch.Tensor      # (samples, banks, rows - 2) bool, LRS if True

    def to(self, device) -> "Draws":
        return Draws(*(t.to(device) for t in self))


class MCResult(NamedTuple):
    """Leading axes are (samples,) for ``banks=1`` (the paper's setup) or
    (samples, banks); every bank is an independent array with its own
    device and V_t world."""
    i_sl: torch.Tensor        # (samples[, banks], 3) currents, s = 0, 1, 2
    v_cell: torch.Tensor      # (samples[, banks], 3) CSA n_CELL voltages
    v_ref: torch.Tensor       # (samples[, banks], 2) n_REF (REF1, REF2)
    xor_out: torch.Tensor     # (samples[, banks], 3) bool datapath (XOR)
    xnor_out: torch.Tensor    # (samples[, banks], 3)
    error_rate: torch.Tensor  # (3,) fraction mis-sensed (XOR), all worlds
    margins: torch.Tensor     # (samples[, banks], 2) (I01-REF1, REF2-I01)


def _div(a, b):
    """``a / b`` in f32 as a true division: torch computes a Python number
    over a tensor as ``reciprocal(b) * a``, which rounds differently."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.div(torch.as_tensor(a, dtype=_F32),
                         torch.as_tensor(b, dtype=_F32))
    return a / b


def draw(generator: torch.Generator, samples: int = 5000, rows: int = 3,
         banks: int = 1) -> Draws:
    """Draw ``samples x banks`` worlds on ``generator``'s device."""
    if rows < 2:
        raise ValueError(f"a column needs the 2 accessed rows, got {rows}")
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev, dtype=_F32)

    z_lrs = normal(samples, banks, rows)
    z_hrs = normal(samples, banks, rows)
    z_vt1 = normal(samples, banks)
    z_vt2 = normal(samples, banks)
    unacc = torch.rand((samples, banks, rows - 2), generator=generator,
                       device=dev) < 0.5
    return Draws(z_lrs, z_hrs, z_vt1, z_vt2, unacc)


def evaluate(d: Draws) -> MCResult:
    """Currents, sense outputs, voltages and margins of every drawn world,
    on the draws' device."""
    samples, banks, rows = d.z_lrs.shape
    dev = d.z_lrs.device
    lrs = cim.LRS * (1.0 + SIGMA_FRAC * d.z_lrs)
    hrs = cim.HRS * (1.0 + SIGMA_FRAC * d.z_hrs)
    dvt1 = SIGMA_VT * d.z_vt1
    dvt2 = SIGMA_VT * d.z_vt2

    # the accessed pair in states (0,0), (0,1), (1,1) over the unaccessed
    # cells: bits (samples, banks, 3, rows)
    pair = torch.tensor([[False, False], [False, True], [True, True]],
                        device=dev)
    bits = torch.cat([pair.expand(samples, banks, 3, 2),
                      d.unacc[:, :, None, :].expand(-1, -1, 3, -1)], dim=-1)
    r = torch.where(bits, lrs[:, :, None, :], hrs[:, :, None, :])
    i_on = _div(cim.V_BL, r + cim.R_ACC)
    i_leak = torch.where(bits, torch.tensor(cim.LEAK_LRS, dtype=_F32,
                                            device=dev),
                         torch.tensor(cim.LEAK_HRS, dtype=_F32, device=dev))
    wl = torch.arange(rows, device=dev) < 2
    # a column's row sum accumulates in f64 and rounds once, so it does not
    # depend on a device's reduction order (the reference's f32 sum lies
    # within ~1e-6 of it at 512 rows)
    i_s = torch.where(wl, i_on, i_leak).sum(dim=-1, dtype=torch.float64)
    i_s = i_s.to(_F32)                                       # (S, B, 3)

    off1 = cim.vt_offset_to_iref_shift(dvt1, logic.REF_LO)[..., None]
    off2 = cim.vt_offset_to_iref_shift(dvt2, logic.REF_HI)[..., None]
    ops = logic.op_table()
    xor_o = logic.sense_datapath(i_s, ops["xor"], off1, off2)
    xnor_o = logic.sense_datapath(i_s, ops["xnor"], off2, off1)
    v_cell, _ = cim.node_voltages(i_s, i_s)
    ref1, ref2 = logic.REF_LO + off1, logic.REF_HI + off2
    v_ref = torch.cat([ref1, ref2], dim=-1) * cim.R_MIRROR
    margins = torch.cat([i_s[..., 1:2] - ref1, ref2 - i_s[..., 1:2]], dim=-1)
    want = torch.tensor([False, True, False], device=dev)
    # the reference's mean: the count times 1/n, as XLA computes it
    err = (xor_o != want).to(_F32).sum(dim=(0, 1)) * (1.0 / (samples * banks))
    res = [i_s, v_cell, v_ref, xor_o, xnor_o, margins]
    if banks == 1:
        res = [x[:, 0] for x in res]
    i_s, v_cell, v_ref, xor_o, xnor_o, margins = res
    return MCResult(i_s, v_cell, v_ref, xor_o, xnor_o, err, margins)


def run(generator: torch.Generator, samples: int = 5000, rows: int = 3,
        banks: int = 1, device="cuda") -> MCResult:
    """The paper's 5000-point Monte-Carlo: draws from ``generator`` (on its
    own device), evaluated on ``device``.  ``banks > 1`` gives each bank of
    a stack its own world; ``error_rate`` aggregates over samples and
    banks."""
    dev = resolve_device(device)
    return evaluate(draw(generator, samples, rows, banks).to(dev))


# ---------------------------------------------------------------------------
# Fig. 5(b): max rows against the on/off ratio
# ---------------------------------------------------------------------------

def max_rows(lrs=cim.LRS, hrs=cim.HRS, margin_frac: float = 0.5):
    """Largest row count for which the worst-case '00' current stays below
    ``margin_frac * REF1``.

    Worst case: every unaccessed cell is LRS.  The paper's leak constants
    scale with 1/R:
      I_00(N) = 2 * V/(hrs + R_ACC) + (N-2) * LEAK_LRS * (LRS_nom / lrs)
    Returns an f32 tensor (0-d for scalar inputs)."""
    lrs = torch.as_tensor(lrs, dtype=_F32)
    i_acc_00 = _div(2 * cim.V_BL, hrs + cim.R_ACC)
    leak_lrs = cim.LEAK_LRS * _div(cim.LRS, lrs)
    budget = margin_frac * logic.REF_LO - i_acc_00
    return torch.floor(_div(budget, leak_lrs)) + 2


def max_rows_sweep(ratios, vary: str = "lrs"):
    """Fig. 5(b): sweep HRS/LRS by varying LRS (the paper's black line) or
    HRS; ``ratios`` is a 1-d f32 tensor."""
    ratios = torch.as_tensor(ratios, dtype=_F32)
    if vary == "lrs":
        return max_rows(lrs=_div(cim.HRS, ratios), hrs=cim.HRS)
    return max_rows(lrs=cim.LRS, hrs=cim.LRS * ratios)
