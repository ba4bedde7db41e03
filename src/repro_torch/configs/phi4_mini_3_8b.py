"""Phi-4-mini 3.8B [arXiv:2412.08905; hf]: dense GQA, RoPE + SwiGLU."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064,
    qkv_bias=False, qk_norm=False, rope_theta=10000.0,
    notes="RoPE SwiGLU GQA kv=8; 200k vocab.",
)
