"""XOR stream encryption — the paper's Fig. 1(b) application.

Leaves are encrypted with a counter-mode XOR pad before they leave the
device or host and decrypted on restore (XOR is an involution: the same
call).  Keys are derived per leaf from a root key and the leaf's tree
path, so no two leaves reuse a pad position.

The host path works on numpy byte views; :func:`encrypt_device` runs the
cipher kernel through a :class:`repro_torch.core.engine.CimEngine`.  Both
use one byte layout (:func:`repro_torch.core.verify.np_words` /
:func:`repro_torch.kernels.ops.as_words`), so bytes encrypted on one path
decrypt on the other.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.core.engine import CimEngine
from repro_torch.core.verify import np_words


def pad_path(step: int, leaf_key: str) -> str:
    """Pad-derivation path of a checkpoint leaf written at ``step``."""
    return f"{step}/{leaf_key}"


def derive_key(root_key: bytes | str, leaf_path: str):
    """(key0, key1, counter_base) uint32 triple from root key + leaf path."""
    if isinstance(root_key, str):
        root_key = root_key.encode()
    h = hashlib.sha256(root_key + b"\x00" + leaf_path.encode()).digest()
    k0, k1, ctr = (int.from_bytes(h[i:i + 4], "little") for i in (0, 4, 8))
    return np.uint32(k0), np.uint32(k1), np.uint32(ctr)


def _np_keystream(idx: np.ndarray, k0: np.uint32, k1: np.uint32) -> np.ndarray:
    """Numpy twin of the keystream (bitwise equal)."""
    with np.errstate(over="ignore"):
        h = idx.astype(np.uint32) * np.uint32(0x9E3779B9) + k0
        h ^= k1
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def encrypt_np(arr: np.ndarray, root_key: bytes | str,
               leaf_path: str) -> np.ndarray:
    """Encrypt (or decrypt) a numpy array's bytes -> uint8 buffer of the
    same byte length."""
    k0, k1, ctr = derive_key(root_key, leaf_path)
    words, nbytes = np_words(arr)
    idx = np.arange(words.size, dtype=np.uint32) + ctr
    return (words ^ _np_keystream(idx, k0, k1)).view(np.uint8)[:nbytes]


def decrypt_np(buf: np.ndarray, root_key: bytes | str, leaf_path: str,
               dtype, shape) -> np.ndarray:
    """Inverse of :func:`encrypt_np`, restoring dtype/shape."""
    plain = encrypt_np(buf, root_key, leaf_path)
    return plain.view(dtype).reshape(shape).copy()


def encrypt_device(buf: torch.Tensor, root_key: bytes | str, leaf_path: str,
                   engine: CimEngine | None = None,
                   device="cuda") -> torch.Tensor:
    """Cipher an int32 word buffer where it lies, through ``engine`` (its
    stats account the pass) or a throwaway engine on ``device``."""
    k0, k1, ctr = derive_key(root_key, leaf_path)
    eng = engine if engine is not None else CimEngine(device=device)
    return eng.stream_cipher(buf, (int(k0), int(k1)), counter=int(ctr))


def encrypt_np_via_device_staged(arr: np.ndarray, root_key: bytes | str,
                                 leaf_path: str, engine: CimEngine):
    """Dispatch the device cipher of a host array now; the returned
    ``materialize()`` brings the uint8 bytes back (the only sync point)."""
    nbytes = np.asarray(arr).nbytes
    enc = encrypt_device(engine._words(arr), root_key, leaf_path,
                         engine=engine)

    def materialize() -> np.ndarray:
        out = enc.cpu().numpy().view(np.uint8)
        return out[:nbytes].copy() if nbytes != out.size else out

    return materialize


def encrypt_np_via_device(arr: np.ndarray, root_key: bytes | str,
                          leaf_path: str, engine: CimEngine) -> np.ndarray:
    """Device-routed twin of :func:`encrypt_np` (bitwise equal bytes)."""
    return encrypt_np_via_device_staged(arr, root_key, leaf_path, engine)()


def decrypt_np_via_device(buf: np.ndarray, root_key: bytes | str,
                          leaf_path: str, dtype, shape,
                          engine: CimEngine) -> np.ndarray:
    """Inverse of :func:`encrypt_np_via_device`, restoring dtype/shape."""
    plain = encrypt_np_via_device(buf, root_key, leaf_path, engine)
    return plain.view(dtype).reshape(shape).copy()
