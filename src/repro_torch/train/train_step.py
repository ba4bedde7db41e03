"""The training step: loss and gradients through autograd (with optional
sequential microbatch accumulation), the LR schedule and AdamW.

Everything runs on the device the state lies on.  The XNOR layers train
through the float straight-through estimator (``bitpack.binarize_ste``),
so no kernel has a backward to port.  ``grad_compress="onebit_pod"`` and
``state_pspecs`` need a multi-pod mesh, which the port does not have
yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import verify
from repro_torch.models import lm
from repro_torch.optim import adamw, schedule

_MESH = "needs a device mesh: ROADMAP queue 1 item 6 (distributed/)"


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_state(cfg, seed: int = 0, *, device="cuda") -> TrainState:
    """Fresh parameters drawn from ``seed`` (``lm.init_params``) and zero
    moments, on ``device`` (CUDA unless the caller asks for the CPU)."""
    params = lm.init_params(cfg, seed, device=device)
    return TrainState(params, adamw.init(params))


def abstract_state(cfg) -> TrainState:
    """The state's shapes and dtypes as ``meta`` tensors: the ``like``
    tree ``ckpt.restore`` (and the ``Runner``) restores into."""
    params = lm.abstract_params(cfg)
    return TrainState(params, adamw.abstract(params))


def state_pspecs(cfg, rules):
    raise NotImplementedError(f"state_pspecs {_MESH}")


def _leaves(tree) -> list:
    return [leaf for _, leaf in verify.tree_flatten_with_path(tree)]


def _value_and_grad(cfg, params, batch: dict, q_chunk: int):
    """-> (loss, metrics, grads shaped and typed like ``params``); a leaf
    the loss does not read gets zeros."""
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    it = iter(leaves)
    live = verify.tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = lm.loss_fn(cfg, live, batch, q_chunk=q_chunk)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    git = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            verify.tree_map(lambda _: next(git), params))


def _grads(cfg, params, batch: dict, q_chunk: int = 0, microbatch: int = 1,
           acc_dtype=torch.float32):
    """Loss, metrics and gradients of ``batch``.  ``microbatch`` > 1 splits
    the batch into that many equal parts run one after another, the
    gradients summed in ``acc_dtype`` (each part's rounded once as it is
    added) and averaged in f32; the loss is the parts' mean and the
    metrics the last part's."""
    if microbatch <= 1:
        return _value_and_grad(cfg, params, batch, q_chunk)
    b = batch["tokens"].shape[0]
    if b % microbatch:
        raise ValueError(f"batch {b} is not a multiple of microbatch "
                         f"{microbatch}")
    mb = b // microbatch
    acc = verify.tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                device=p.device), params)
    loss_sum = 0.0
    for i in range(microbatch):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, metrics, grads = _value_and_grad(cfg, params, part, q_chunk)
        for a, g in zip(_leaves(acc), _leaves(grads)):
            a.add_(g.to(acc_dtype))
        loss_sum = loss_sum + loss
    grads = verify.tree_map(lambda g: g.float() / microbatch, acc)
    return loss_sum / microbatch, metrics, grads


def train_step(cfg, state: TrainState, batch: dict, step, *,
               peak_lr: float = 3e-4, warmup: int = 100, total: int = 10000,
               q_chunk: int = 0, microbatch: int = 1,
               grad_compress: str = "none", mesh=None, rules=None,
               acc_dtype=torch.float32):
    """One optimizer step -> (state, metrics {ce, aux, tokens, loss,
    gnorm, lr}).  ``batch`` holds tensors on the state's device; ``step``
    addresses the schedule.  The parameters and moments are updated in
    place (:func:`optim.adamw.update`)."""
    if grad_compress != "none":
        raise NotImplementedError(f"grad_compress={grad_compress!r} {_MESH}")
    loss, metrics, grads = _grads(cfg, state.params, batch, q_chunk,
                                  microbatch, acc_dtype)
    lr = schedule.warmup_cosine(step, peak_lr=peak_lr, warmup=warmup,
                                total=total).to(loss.device)
    params, opt, gnorm = adamw.update(state.params, grads, state.opt, lr)
    metrics = dict(metrics, loss=loss, gnorm=gnorm, lr=lr)
    return TrainState(params, opt), metrics
