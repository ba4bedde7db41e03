"""AdamW with f32 moments over (possibly bf16) parameters, and
global-norm clipping.

The moments mirror the parameter tree.  Leaves are visited in the
reference's order (sorted dict keys, :func:`core.verify.
tree_flatten_with_path`), which is also the order the global norm sums
them in.  :func:`update` writes the parameters and the moments in place
(at full width the optimizer state is two f32 copies of the model, and a
second set would not fit beside them) and returns them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import verify

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: dict
    v: dict


def _leaves(tree) -> list:
    return [leaf for _, leaf in verify.tree_flatten_with_path(tree)]


def _zeros(params, device=None) -> dict:
    return verify.tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32,
                              device=device or p.device), params)


def init(params) -> AdamWState:
    first = _leaves(params)[0]
    return AdamWState(torch.zeros((), dtype=torch.int32, device=first.device),
                      _zeros(params), _zeros(params))


def abstract(params) -> AdamWState:
    """The state's shapes and dtypes as ``meta`` tensors."""
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                      _zeros(params, "meta"), _zeros(params, "meta"))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, in leaf order."""
    return torch.sqrt(sum(g.float().square().sum() for g in _leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / norm), each in its dtype;
    the global norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return verify.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                           grads), gn


@torch.no_grad()
def update(params, grads, state: AdamWState, lr, *, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, max_norm=1.0):
    """One AdamW step after clipping -> (params, state, global norm).
    Matrices (``ndim >= 2``, layer-stacked norm scales among them) are
    decayed; vectors are not.  ``params``, ``state.m`` and ``state.v`` are
    written in place."""
    grads, gnorm = clip_by_global_norm(grads, max_norm)
    step = state.step + 1
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=step.device),
                          step.to(F32))
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=step.device),
                          step.to(F32))
    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(state.m), _leaves(state.v)):
        g32 = g.float()
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(g32 * (1 - b2) * g32)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if p.ndim >= 2:  # decay matrices only (vectors exempt)
            u = u + weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, AdamWState(step, state.m, state.v), gnorm
