"""xLSTM-350M (arXiv:2405.04517): mLSTM and sLSTM blocks.

The xLSTM[7:1] depth plan: every 8th block is sLSTM, the rest mLSTM (24
layers, 3 superblocks).  ``d_ff`` is 0: the blocks carry their own up and
down projections (``proj_factor``), no separate FFN.  The state a slot
keeps does not grow with the sequence: an mLSTM layer's matrix memory and
an sLSTM layer's per-unit scalars.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    proj_factor=2.0, mlstm_chunk=64, conv_width=4,
    supports_long_context=True,
    notes="O(1)-state per token; long_500k applicable.",
)
