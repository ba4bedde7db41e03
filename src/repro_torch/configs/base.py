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

    # MoE (GShard top-k routing; experts and router stay full precision)
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # cross-attention context (vlm) / encoder-decoder (audio)
    n_ctx_tokens: int = 0          # modality tokens a request brings (patch
                                   # embeddings or encoder frames)
    encoder_layers: int = 0        # > 0: enc-dec; the encoder runs "enc"

    # recurrent blocks (xLSTM, RG-LRU)
    conv_width: int = 4            # causal depthwise conv1d taps
    mlstm_chunk: int = 64          # chunkwise-parallel mLSTM chunk length
    proj_factor: float = 2.0       # xLSTM mLSTM up-projection
    rglru_c: float = 8.0           # Griffin's fixed decay sharpness

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
    supports_long_context: bool = False
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

    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def encoder_segments(self) -> list[tuple[str, int]]:
        """The encoder's depth plan for enc-dec archs, [] otherwise."""
        return [("enc", self.encoder_layers)] if self.is_encdec() else []

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
            mlstm_chunk=8,
            block_size=8,
            prefill_chunk=8,
            name=self.name + "-smoke",
        )
        if self.n_experts:
            scale.update(n_experts=4, top_k=min(self.top_k, 2),
                         d_ff_expert=32)
        if self.n_ctx_tokens:
            scale.update(n_ctx_tokens=16)
        if self.encoder_layers:
            scale.update(encoder_layers=2)
        if len(self.pattern) > 1:
            scale["n_layers"] = len(self.pattern)
        scale.update(over)
        return dataclasses.replace(self, **scale)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Spec rules: long_* only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 524k dense KV decode is the "
                       "quadratic regime sub-quadratic archs exist to avoid "
                       "(DESIGN.md §5)")
    return True, ""
