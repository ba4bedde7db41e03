"""Architecture registry: ``--arch <id>`` resolution.

``get(name)`` also accepts ``<name>+xnor`` for the binary-quantized
variant (the paper's technique as a config axis).  The port carries the
reference's eleven archs: the dense attention archs (Qwen2-7B, Qwen3-4B,
Phi-4-mini, Qwen3-14B), xLSTM-350M (``mlstm`` + ``slstm``), the
mixture-of-experts archs (``moe``: Llama-4-Scout, Moonlight-16B-A3B), the
hybrid RecurrentGemma (``rglru`` + ``local``), the vision-language
Llama-3.2-Vision (``cross``), the encoder-decoder Whisper (``enc`` +
``dec``) and the paper's own XNOR-CNN classifier (``bindense``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.configs.qwen2_7b import CONFIG as qwen2_7b
from repro_torch.configs.qwen3_4b import CONFIG as qwen3_4b
from repro_torch.configs.phi4_mini_3_8b import CONFIG as phi4_mini_3_8b
from repro_torch.configs.qwen3_14b import CONFIG as qwen3_14b
from repro_torch.configs.xlstm_350m import CONFIG as xlstm_350m
from repro_torch.configs.recurrentgemma_2b import CONFIG as recurrentgemma_2b
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as moonshot
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as llama4_scout
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as llama_vision
from repro_torch.configs.whisper_tiny import CONFIG as whisper_tiny
from repro_torch.configs.xnor_cnn import CONFIG as xnor_cnn

ALL: dict[str, ArchConfig] = {
    c.name: c for c in [qwen2_7b, qwen3_4b, phi4_mini_3_8b, qwen3_14b,
                        xlstm_350m, llama4_scout, moonshot,
                        recurrentgemma_2b, llama_vision, whisper_tiny,
                        xnor_cnn]}


def get(name: str) -> ArchConfig:
    quant = "none"
    if name.endswith("+xnor"):
        name, quant = name[: -len("+xnor")], "xnor"
    cfg = ALL[name]
    if quant != "none":
        cfg = dataclasses.replace(cfg, quant=quant, name=cfg.name + "+xnor")
    return cfg


__all__ = ["ALL", "SHAPES", "ArchConfig", "ShapeConfig", "get",
           "shape_applicable"]
