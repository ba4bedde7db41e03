"""Qwen3-4B [hf:Qwen/Qwen3-8B family; hf]: dense GQA with qk_norm."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, d_head=128,
    qkv_bias=False, qk_norm=True, rope_theta=1e6,
    notes="per-head RMS qk_norm before RoPE (Qwen3).",
)
