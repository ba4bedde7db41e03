"""Carry the JAX package's parameters into the port.

``from_jax(cfg, tree)`` takes the reference's float parameter tree with
its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's tree: the same nested keys and layouts, leaves as
torch tensors in the config's dtypes.  Both packages then compute the same
function, which is what the parity tests hold them to.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.params import ParamDef


def _tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: carry the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dtype).contiguous()


def from_jax(cfg, tree: dict, device="cpu") -> dict:
    """Convert a reference parameter tree (numpy leaves) for ``cfg``.

    Raises if the tree's keys or shapes differ from the port's declaration.
    """
    def walk(defs, sub, path):
        if isinstance(defs, dict):
            if not isinstance(sub, dict) or set(sub) != set(defs):
                raise ValueError(f"{path or 'root'}: keys "
                                 f"{sorted(sub) if isinstance(sub, dict) else sub!r}"
                                 f" != {sorted(defs)}")
            return {k: walk(defs[k], sub[k], f"{path}/{k}") for k in defs}
        d: ParamDef = defs
        if tuple(np.shape(sub)) != tuple(d.shape):
            raise ValueError(f"{path}: shape {np.shape(sub)} != {d.shape}")
        return _tensor(sub, d.dtype).to(device)
    return walk(lm.param_defs(cfg), tree, "")
