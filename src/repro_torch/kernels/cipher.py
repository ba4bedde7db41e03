"""Counter-mode XOR stream cipher: wrapper of ``csrc/cipher.cu``.

Replaces ``repro/kernels/cipher.py::xor_cipher``.  CPU tensors run the
plain version (:func:`repro_torch.kernels.ref.xor_cipher`); CUDA tensors
launch the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda, ref


def xor_cipher(words: torch.Tensor, key0: int, key1: int,
               counter: int = 0) -> torch.Tensor:
    """Encrypt or decrypt (an involution) a flat int32 word buffer: word
    ``i`` XOR ``keystream_word((i + counter) mod 2**32, key0, key1)``.
    Keys and counter are integers in [0, 2**32)."""
    cuda.check(words.ndim == 1, f"xor_cipher needs (n,) words, got "
               f"{tuple(words.shape)}")
    key0, key1, counter = int(key0), int(key1), int(counter)
    for name, v in (("key0", key0), ("key1", key1), ("counter", counter)):
        cuda.check(0 <= v <= ref.MASK, f"{name} {v} is not a uint32")
    if not cuda.use_kernel(words):
        return ref.xor_cipher(words, key0, key1, counter)
    cuda.check(words.dtype == torch.int32 and words.is_contiguous(),
               f"xor_cipher takes contiguous int32 words, got {words.dtype}")
    out = torch.empty_like(words)
    if words.numel() == 0:
        return out
    with torch.cuda.device(words.device):
        cuda.launch("xor_cipher", words.data_ptr(), out.data_ptr(),
                    words.numel(), key0, key1, counter, cuda.stream(words))
    xor_cipher.launches += 1
    return out


xor_cipher.launches = 0
