"""Application-level models: Table I latency and the XNOR-Net speedup.

* :func:`xnornet_speedup` — the paper's Eq. (1):
      S = c*N_W*N_I / (c*N_W*N_I / N_O + N_I)
  (c channels, N_W filter h*w, N_I input h*w, N_O XNOR ops per cycle),
  evaluated at the paper's c = 256, N_W = 14^2, N_I = 3^2, in f32 with
  true divisions (torch takes a Python number over a tensor as a
  reciprocal times the number, which rounds differently).
* :func:`design_cycles` — Table I as a cycle model: a bulk op of n_bits on
  a CiM array of row width W costs latency_cycles * ceil(n_bits / W).
* :func:`tpu_n_o` — the reference's N_O for packed uint32 lanes on a TPU
  v5e's vector unit, kept as the reference states it.

These are models from the paper and the reference, not measurements of
any card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Table I of the paper: (technology, extra transistors, latency cycles)
TABLE_I = {
    "pinatubo":        ("CMOS", 7, 3),
    "felix":           ("Crossbar", None, 3),
    "cmos_memristive": ("CMOS", 16, 2),
    "xorim":           ("CMOS", 12, 3),
    "sixor":           ("Memristor", None, 1),
    "this_work":       ("CMOS", 13, 1),
}


def xnornet_speedup(n_o, c: int = 256, n_w: int = 14 ** 2,
                    n_i: int = 3 ** 2) -> torch.Tensor:
    """Paper Eq. (1), in f32.  Ideal limit: S -> N_O / (1 + N_O/(c*N_W))."""
    n_o = torch.as_tensor(n_o, dtype=torch.float32)
    num = torch.tensor(c * n_w * n_i, dtype=torch.float32)
    return torch.div(num, torch.div(num, n_o) + n_i)


def xornet_speedup(n_o, c: int = 256, n_w: int = 14 ** 2, n_i: int = 3 ** 2,
                   fp_reduction: float = 0.3984) -> torch.Tensor:
    """XOR-Net variant: 39.84 % fewer full-precision ops per layer."""
    n_o = torch.as_tensor(n_o, dtype=torch.float32)
    num = torch.tensor(c * n_w * n_i, dtype=torch.float32)
    return torch.div(num, torch.div(num, n_o) + (1.0 - fp_reduction) * n_i)


def design_cycles(design: str, n_bits: int, row_width: int = 512) -> int:
    """Total cycles for a bulk bitwise op of n_bits on a given design."""
    _, _, lat = TABLE_I[design]
    return lat * -(-n_bits // row_width)


def copy_verify_cycles(rows: int, design: str = "this_work") -> int:
    """Duplicating ``rows`` unique rows in a 2*rows bank: 2 activation
    cycles per copied row plus one XOR stream per row for verification."""
    _, _, lat = TABLE_I[design]
    return rows * 2 + rows * lat


class TpuBitEngine(NamedTuple):
    sublanes: int = 8
    lanes: int = 128
    word_bits: int = 32
    vpu_issue: int = 4      # VPU ops/cycle (4 ALUs per port group, v5e-class)

    @property
    def n_o(self) -> int:
        """Bit-XNORs per TPU core cycle for packed operands."""
        return self.sublanes * self.lanes * self.word_bits * self.vpu_issue


def tpu_n_o() -> int:
    return TpuBitEngine().n_o
