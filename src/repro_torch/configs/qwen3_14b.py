"""Qwen3-14B [hf:Qwen/Qwen3-8B family; hf]: dense GQA with qk_norm."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, d_head=128,
    qkv_bias=False, qk_norm=True, rope_theta=1e6,
)
