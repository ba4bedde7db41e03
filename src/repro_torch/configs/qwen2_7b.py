"""Qwen2-7B [arXiv:2407.10671; hf]: dense GQA, QKV bias."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    qkv_bias=True, qk_norm=False, rope_theta=1e6,
    notes="GQA kv=4, QKV bias; d_head=128.",
)
