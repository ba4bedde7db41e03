"""RecurrentGemma-2B [arXiv:2402.19427; hf]: Griffin RG-LRU + local attn 1:2.

Depth plan (rglru, rglru, local) tiled over 26 layers (tail = 2 rglru).
MQA (kv=1) local attention with a 2048 window; the RG-LRU state does not
grow with the sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, d_head=256,
    pattern=("rglru", "rglru", "local"),
    local_window=2048, conv_width=4, rglru_c=8.0,
    rope_theta=10000.0,
    supports_long_context=True,
)
