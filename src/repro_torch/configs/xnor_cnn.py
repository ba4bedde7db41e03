"""The paper's own workload as an arch: an XNOR-Net binary-dense image
classifier served through the LM machinery (Fig. 1(c) / §VI, Fig. 6).

Tiny by construction: the full config is already smoke-scale, because the
paper's classifier is a few binary dense layers over 16x16 images.  The
class ids are vocab ids: a request is one ``QUERY_TOKEN`` prompt with the
image's pixel bands as its context and ``max_new_tokens=1``; the greedy
token is the class.
"""
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import bcnn  # registers the "bindense" kind

CONFIG = ArchConfig(
    name="xnor-cnn",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=bcnn.VOCAB,
    pattern=("bindense",),
    n_ctx_tokens=4,                # 16x16 image -> 4 bands of 64 pixels
    quant="xnor",                  # the binary path is the workload
    dtype=torch.float32,
    block_size=8,
    prefill_chunk=8,
    notes="XNOR-CNN stripe classifier; bindense kind registered by "
          "repro.models.bcnn",
)
