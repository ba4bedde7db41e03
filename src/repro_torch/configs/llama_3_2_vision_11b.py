"""Llama-3.2-11B-Vision: a Llama-3.1-8B-class trunk with a vision
cross-attention layer every 5th layer (40 layers, 8 of them ``cross``).

The vision tower is a stub: a request brings its precomputed patch
embeddings, ``n_ctx_tokens`` x ``d_model``, as its context.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    n_ctx_tokens=1600,
    rope_theta=500000.0,
)
