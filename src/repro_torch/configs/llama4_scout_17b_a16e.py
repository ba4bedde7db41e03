"""Llama-4-Scout-17B-16E [hf:meta-llama; unverified]: MoE 16e top-1.

Early-fusion multimodality is out of the assigned backbone scope (text
backbone only).  Every layer's FFN is a 16-expert top-1 MoE per the
assignment line (d_ff=8192 per expert).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    pattern=("moe",),
    n_experts=16, top_k=1, d_ff_expert=8192,
    rope_theta=500000.0,
)
