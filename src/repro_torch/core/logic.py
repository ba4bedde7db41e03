"""Reference-current -> Boolean-operation selection (paper §III, Fig. 2(b)).

The modified sense amplifier feeds the sense-line current into two CSAs
with references REF1/REF2 and combines their outputs with one inverter and
one AND gate.  The SL current is monotone in the number of '1' cells among
the two accessed ones (s = a + b in {0, 1, 2}), so the AND of comparators
is an interval predicate on s: XOR is s == 1, AND s == 2, OR s >= 1.  The
complement ops (XNOR/NAND/NOR) take the CSA's complementary output rail,
free in the same cycle.

The digital twin of that mechanism, and the functional spec the circuit
model (:mod:`repro_torch.core.cim`) is held to.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OpSpec(NamedTuple):
    """Reference placement (amps) + output-rail selection for one op."""
    name: str
    ref1: float          # CSA1 reference current (A)
    ref2: float          # CSA2 reference current (A)
    invert_out: bool     # take OUT_B of the final AND (complementary rail)


# Nominal current levels of the calibrated array (paper Fig. 4(d)):
I_00 = 100e-12   # both accessed cells HRS + nominal leakage
I_01 = 7.87e-6   # one LRS
I_11 = 15.7e-6   # both LRS

# References as the paper sets them (XOR: 4 uA / 12 uA).
REF_LO = 4e-6    # in (I_00, I_01)
REF_HI = 12e-6   # in (I_01, I_11)
REF_INF = 1.0    # above any SL current: disables the second comparator


def op_table() -> dict[str, OpSpec]:
    return {
        # out = (I > ref1) AND NOT (I > ref2)        -> 1 iff ref1 < I <= ref2
        "xor":  OpSpec("xor",  REF_LO, REF_HI, False),   # s == 1
        "and":  OpSpec("and",  REF_HI, REF_INF, False),  # s == 2
        "or":   OpSpec("or",   REF_LO, REF_INF, False),  # s >= 1
        # complementary rail of the same datapath (single cycle):
        "xnor": OpSpec("xnor", REF_LO, REF_HI, True),    # s != 1
        "nand": OpSpec("nand", REF_HI, REF_INF, True),   # s < 2
        "nor":  OpSpec("nor",  REF_LO, REF_INF, True),   # s == 0
    }


def sense_datapath(i_sl: torch.Tensor, spec: OpSpec, offset1=0.0,
                   offset2=0.0) -> torch.Tensor:
    """The two-CSA + inverter + AND datapath of Fig. 2(c).

    ``offset1/2`` model comparator input-referred offset as an equivalent
    reference-current shift (the Monte-Carlo perturbation)."""
    c1 = i_sl > (spec.ref1 + offset1)
    c2 = i_sl > (spec.ref2 + offset2)
    out = torch.logical_and(c1, torch.logical_not(c2))
    return torch.logical_xor(out, torch.tensor(spec.invert_out,
                                               device=out.device))


def truth_table(spec: OpSpec) -> list[tuple[int, int, int]]:
    """Evaluate the datapath over the nominal current levels -> (a, b, out)."""
    levels = {(0, 0): I_00, (0, 1): I_01, (1, 0): I_01, (1, 1): I_11}
    rows = []
    for (a, b), i in levels.items():
        out = bool(sense_datapath(torch.tensor(i, dtype=torch.float32), spec))
        rows.append((a, b, int(out)))
    return rows
