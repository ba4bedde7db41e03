"""Carry the JAX package's parameters into the port.

``from_jax(cfg, tree)`` takes the reference's float parameter tree with
its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's tree: the same nested keys and layouts, leaves as
torch tensors in the config's dtypes.  Both packages then compute the same
function, which is what the parity tests hold them to.

``from_numpy(tree)`` carries any nested dict / list / tuple of numpy
leaves (a classifier's weights, a tree to digest or encrypt) into tensors
of the same dtypes, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.params import ParamDef


def _tensor(a: np.ndarray, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A numpy array as a tensor with the same bits (``dtype`` None) or
    converted to ``dtype``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: carry the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return (t if dtype is None else t.to(dtype)).contiguous()


def from_numpy(tree, device="cpu"):
    """Nested dicts, lists and tuples of numpy arrays (ml_dtypes' bfloat16
    included) -> the same structure of tensors holding the same bits;
    ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device) for v in tree)
    return _tensor(tree).to(device)


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
