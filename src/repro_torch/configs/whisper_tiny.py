"""Whisper-tiny (arXiv:2212.04356): encoder-decoder.

A 4-layer bidirectional encoder over precomputed frame embeddings (the
strided-conv audio front end is a stub: a request brings its (1500,
d_model) frames as its context) and a 4-layer decoder whose layers
self-attend and cross-attend to the encoded frames.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    pattern=("dec",),
    encoder_layers=4, n_ctx_tokens=1500,
    rope_theta=10000.0,
    notes="enc-dec; decoder cross-attends to 1500 encoder frames.",
)
