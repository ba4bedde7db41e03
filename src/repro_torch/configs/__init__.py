"""Architecture registry: ``--arch <id>`` resolution.

``get(name)`` also accepts ``<name>+xnor`` for the binary-quantized
variant (the paper's technique as a config axis).  The port carries the
dense attention archs its serving path runs.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.qwen2_7b import CONFIG as qwen2_7b
from repro_torch.configs.qwen3_4b import CONFIG as qwen3_4b

ALL: dict[str, ArchConfig] = {c.name: c for c in [qwen2_7b, qwen3_4b]}


def get(name: str) -> ArchConfig:
    quant = "none"
    if name.endswith("+xnor"):
        name, quant = name[: -len("+xnor")], "xnor"
    cfg = ALL[name]
    if quant != "none":
        cfg = dataclasses.replace(cfg, quant=quant, name=cfg.name + "+xnor")
    return cfg


__all__ = ["ALL", "ArchConfig", "get"]
