"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B; hf]: MoE 64e top-6.

DeepSeek-V3-style fine-grained experts (d_ff=1408 per expert); the
assignment specifies 64 experts, top-6 routing, GQA kv=16 (== n_heads:
effectively MHA).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840,
    pattern=("moe",),
    n_experts=64, top_k=6, d_ff_expert=1408,
    rope_theta=50000.0,
)
