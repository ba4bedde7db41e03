"""XOR-fold parity digest: wrapper of ``csrc/parity.cu``.

Replaces ``repro/kernels/parity.py::parity_digest`` and the chunk-level
XLA fold of ``repro/core/engine.py::CimEngine.digest_chunks``: the kernel
takes a leading chunk axis, and a plain digest is its one-chunk case.
CPU tensors run the plain version
(:func:`repro_torch.kernels.ref.parity_digest`); CUDA tensors launch the
kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda, ref

MAX_WIDTH = 1024            # the kernel folds spans of at most 1024 words


def parity_digest(words: torch.Tensor, digest_width: int = 128,
                  chunk_words: int | None = None) -> torch.Tensor:
    """(n,) int32 words -> (n_chunks, digest_width) int32 digest rows.

    Row ``c`` XOR-folds words ``[c*chunk_words, (c+1)*chunk_words)`` into
    ``digest_width`` lanes (word ``i`` of the chunk into lane
    ``i % digest_width``); ``chunk_words`` (a multiple of the width)
    defaults to the whole stream.  Missing words of a ragged last row count
    as zero, so no buffer is padded."""
    cuda.check(words.ndim == 1, f"parity_digest needs (n,) words, got "
               f"{tuple(words.shape)}")
    n = words.numel()
    if chunk_words is None:
        chunk_words = max(digest_width, -(-n // digest_width) * digest_width)
    cuda.check(digest_width > 0 and chunk_words > 0
               and chunk_words % digest_width == 0,
               f"chunk_words {chunk_words} must be a positive multiple of "
               f"digest_width {digest_width}")
    if not cuda.use_kernel(words):
        return ref.parity_digest(words, digest_width, chunk_words)
    cuda.check(digest_width <= MAX_WIDTH,
               f"the parity kernel takes digest widths up to {MAX_WIDTH}, "
               f"got {digest_width}")
    cuda.check(words.dtype == torch.int32 and words.is_contiguous(),
               f"parity_digest takes contiguous int32 words, got "
               f"{words.dtype}")
    n_chunks = max(1, -(-n // chunk_words))
    out = torch.zeros((n_chunks, digest_width), dtype=torch.int32,
                      device=words.device)
    if n == 0:
        return out
    with torch.cuda.device(words.device):
        cuda.launch("parity_digest", words.data_ptr(), n, chunk_words,
                    digest_width, out.data_ptr(), cuda.stream(words))
    parity_digest.launches += 1
    return out


parity_digest.launches = 0
