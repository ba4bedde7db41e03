"""Architecture config schema (the JAX package's ``configs/base.py`` with
torch dtypes).

A frozen :class:`ArchConfig` fully determines parameter shapes;
:meth:`ArchConfig.smoke` gives the reduced same-family config the CPU
tests use, scaled exactly as the JAX package scales it so both packages
build the same smoke model.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 => d_model // n_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    local_window: int = 2048

    # depth plan: `pattern` tiles across depth; each maximal run of equal
    # kinds is one segment with its parameters stacked on a leading axis
    pattern: tuple = ("attn",)

    # the paper's technique: binary (XNOR-Net) projections
    quant: str = "none"            # "none" | "xnor"

    # numerics / serving
    dtype: Any = torch.bfloat16
    kv_cache_dtype: str = "bf16"   # "bf16" | "i8" (fixed-point decode cache)
    kv_i8_scale: float = 32.0      # fixed-point scale for the i8 cache
    block_size: int = 16           # paged KV-cache tokens per block
    prefill_chunk: int = 32        # chunked-prefill piece size (serve)
    fused_decode: str = "auto"     # "on": the paged decode kernel for
                                   # C == 1 attention; "off": the gather /
                                   # mask / softmax chain; "auto": "on" on
                                   # the card, "off" on the CPU
    notes: str = ""

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")

    # --- depth plan ---------------------------------------------------------
    def layer_kinds(self) -> list[str]:
        reps = -(-self.n_layers // len(self.pattern))
        return list((self.pattern * reps)[: self.n_layers])

    def segments(self) -> list[tuple[str, int]]:
        """Maximal runs of equal block kinds."""
        segs: list[tuple[str, int]] = []
        for k in self.layer_kinds():
            if segs and segs[-1][0] == k:
                segs[-1] = (k, segs[-1][1] + 1)
            else:
                segs.append((k, 1))
        return segs

    # --- derived ------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (pad ids are never sampled)."""
        return -(-self.vocab // 256) * 256

    def smoke(self, **over) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        scale: dict[str, Any] = dict(
            n_layers=max(2, min(4, len(self.pattern))),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 // self.q_per_kv) if self.q_per_kv <= 4 else 1,
            d_head=16,
            d_ff=128,
            vocab=256,
            local_window=32,
            block_size=8,
            prefill_chunk=8,
            name=self.name + "-smoke",
        )
        if len(self.pattern) > 1:
            scale["n_layers"] = len(self.pattern)
        scale.update(over)
        return dataclasses.replace(self, **scale)
