"""The training step: loss and gradients through autograd (with optional
sequential microbatch accumulation), the LR schedule and AdamW.

Everything runs on the device the state lies on.  The XNOR layers train
through the float straight-through estimator (``bitpack.binarize_ste``),
so no kernel has a backward to port.

With a ``mesh`` (a ``DeviceMesh`` of ``launch.mesh``) the step is the
reference's sharded program, written out over ``torch.distributed``
under the rules its train cells lower with, ``{"batch": the batch axes,
"tp": "model", "ep": "model"}`` (``ctx.activation_rules``): each rank
keeps only its blocks of the parameters and of both moments
(:func:`state_pspecs`: head-aligned, ``sharding.Heads``), runs
``lm.loss_fn`` on its block of the batch with the global batch's means,
and updates its blocks.  The ``attn``, ``local`` and ``moe`` layers
compute on the rank's heads, ``d_ff`` block and experts, ``rglru``,
``mlstm``, ``slstm`` and ``bindense`` on their blocks (``blocks.py``),
the CE on its vocab block (no rank holds a (tokens, vocab) tensor); the
context kinds' layers are gathered whole.  A layer's FSDP blocks are gathered inside its
checkpoint, just before it runs, and again by its recompute; each
gather's backward sums the layer's gradient over the batch axes and
hands the rank its block as the backward pass reaches it.  No step
holds the whole tree.  It computes the same function as the
single-device step, ``microbatch`` > 1 included.
``grad_compress="onebit_pod"`` exchanges one-bit gradients across the
mesh's ``pod`` axis.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import bitpack, verify
from repro_torch.distributed import ctx, sharding
from repro_torch.models import lm
from repro_torch.models import params as pdefs
from repro_torch.optim import adamw, schedule
from repro_torch.train import serve_step


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_state(cfg, seed: int = 0, *, device="cuda", mesh=None,
               rules=None) -> TrainState:
    """Fresh parameters drawn from ``seed`` (``lm.init_params``) and zero
    moments, on ``device`` (CUDA unless the caller asks for the CPU).
    With a ``mesh``: this rank's blocks of them under ``rules``
    (:data:`sharding.DEFAULT_RULES` by default; :func:`state_pspecs`),
    each leaf drawn whole and freed once its block is cut."""
    params = lm.init_params(cfg, seed, device=device)
    if mesh is not None:
        params = shard_params(cfg, params, mesh, rules)
    return TrainState(params, adamw.init(params))


def shard_params(cfg, params: dict, mesh, rules=None) -> dict:
    """This rank's blocks of a whole parameter tree under ``rules``.  The
    tree is emptied as it goes: each whole leaf is freed once its block
    is cut."""
    def cut(tree: dict, specs: dict) -> dict:
        out = {}
        for k in sorted(tree):
            v = tree.pop(k)
            out[k] = cut(v, specs[k]) if isinstance(v, dict) \
                else sharding.shard(v, specs[k], mesh)
        return out
    return cut(params, _pspecs(cfg, rules))


def abstract_state(cfg) -> TrainState:
    """The state's shapes and dtypes as ``meta`` tensors: the ``like``
    tree ``ckpt.restore`` (and the ``Runner``) restores into."""
    params = lm.abstract_params(cfg)
    return TrainState(params, adamw.abstract(params))


def _pspecs(cfg, rules) -> dict:
    return lm.param_pspecs(cfg, rules or sharding.DEFAULT_RULES,
                           head_aligned=True)


def state_pspecs(cfg, rules) -> TrainState:
    """The state's placements: the parameters' for them and both moments,
    and the step counter whole.  The parameters' are head-aligned
    (``lm.param_pspecs(..., head_aligned=True)``): an ``attn`` or ``moe``
    layer's dims of heads split into whole heads, so each rank computes
    on its heads; where the heads divide evenly over ``model`` these are
    the reference's ceil-div blocks."""
    pspec = _pspecs(cfg, rules)
    return TrainState(pspec, adamw.AdamWState((), pspec, pspec))


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


def _onebit_pod_allreduce(grads: list, group, scales=None,
                          slab: int = 1 << 26) -> list:
    """Majority-vote one-bit gradient exchange across the pod axis
    (``group``: the ranks that differ only in their pod).  Each pod packs
    its gradient's sign bits (32 to a word), all-gathers the planes and
    its L1 scale, and every pod rebuilds sign(sum of votes + 0.5) times
    the mean scale.  Only uint32 planes and one scalar a tensor cross the
    pod axis.  ``scales`` (one f32 scalar a leaf) replaces each leaf's
    ``mean(|g|)`` where the rank holds a block of it; the signs are packed
    and voted in ``slab``-element pieces (a multiple of 32), which changes
    no bit."""
    out = []
    for i, g in enumerate(grads):
        flat = g.reshape(-1)
        n = flat.numel()
        scale = g.float().abs().mean() if scales is None else scales[i]
        planes = torch.cat([bitpack.pack_bits(bitpack.pad_to_word(
            flat[s:s + slab].float())) for s in range(0, n, slab)])
        all_planes = torch.stack(sharding.all_gather(planes, group))
        mean_scale = torch.cat(sharding.all_gather(scale.reshape(1),
                                                   group)).mean()
        res = torch.empty(n, dtype=torch.float32, device=g.device)
        for s in range(0, n, slab):
            m = min(slab, n - s)
            votes = bitpack.unpack_bits(
                all_planes[:, s // 32:(s + m + 31) // 32], m)
            res[s:s + m] = mean_scale * torch.sign(votes.sum(0) + 0.5)
        out.append(res.reshape(g.shape).to(g.dtype))
    return out


def _pod_vote(grads: list, specs: list, defs: list, mesh,
              copies: list | None = None) -> list:
    """:func:`_onebit_pod_allreduce` over this rank's gradient blocks:
    where a pod splits a leaf over its other axes, the leaf's L1 scale is
    summed over them first (each element once: ``copies`` as
    :func:`_copies` gives them, ``sharding.copies`` by default); block
    padding stays zero."""
    pods = sharding.axis_size(mesh, "pod")
    inner = sharding.axis_group(mesh, tuple(
        a for a in mesh.mesh_dim_names if a != "pod"))
    valid = [sharding.unpad(g, d.shape, s, mesh)
             for g, s, d in zip(grads, specs, defs)]
    if copies is None:
        copies = [sharding.copies(s, mesh) for s in specs]
    scales = None
    if sharding.group_size(inner) > 1:
        scales = [sharding.all_reduce(
            (v.float().abs().sum() / (c // pods)) if isinstance(c, int)
            else (g.float().abs() / (c / pods)).sum(),
            inner) / math.prod(d.shape)
            for g, v, c, d in zip(grads, valid, copies, defs)]
    voted = _onebit_pod_allreduce(valid, sharding.axis_group(mesh, "pod"),
                                  scales)
    out = []
    for g, v, s, d in zip(grads, voted, specs, defs):
        block = torch.zeros_like(g)
        sharding.unpad(block, d.shape, s, mesh).copy_(v)
        out.append(block)
    return out


def _shared_heads(spec, mesh):
    """-> (dim, the :class:`sharding.Heads` entry, each rank's KV heads
    [lo, hi)) of a leaf whose KV heads are held by more than one rank of
    its axis (a block of query heads that does not align with the KV
    groups reads KV heads another rank reads too), else None."""
    for dim, entry in enumerate(spec):
        if not isinstance(entry, sharding.Heads) or entry.per == 1:
            continue
        k = sharding.axis_size(mesh, entry.axes)
        spans = [sharding.head_blocks(entry.n_heads, entry.per, k, i)[1:]
                 for i in range(k)]
        if sum(hi - lo for lo, hi in spans) > entry.n_heads // entry.per:
            return dim, entry, spans
    return None


def _sum_shared_heads(grads: list, specs: list, mesh) -> list:
    """Each KV head's gradient summed over the ranks holding it: a rank's
    gradient of its copy holds its own query heads' share.  Every rank
    folds the holders' terms in rank order, so the copies stay equal."""
    out = []
    for g, spec in zip(grads, specs):
        shared = _shared_heads(spec, mesh)
        if shared is None:
            out.append(g)
            continue
        dim, entry, spans = shared
        parts = sharding.all_gather(
            g, sharding.axis_group(mesh, entry.axes))
        lo, hi = spans[sharding.axis_index(mesh, entry.axes)]
        total = torch.zeros_like(g)
        for h in range(lo, hi):
            acc = total.narrow(dim, (h - lo) * entry.size, entry.size)
            for part, (lo_j, hi_j) in zip(parts, spans):
                if lo_j <= h < hi_j:
                    acc.add_(part.narrow(dim, (h - lo_j) * entry.size,
                                         entry.size))
        out.append(total)
    return out


def _copies(spec, mesh, block: torch.Tensor):
    """How many ranks hold each element of a leaf's block, for the global
    norm: ``sharding.copies``, times a shared KV head's holders along its
    dim (a tensor then)."""
    n = sharding.copies(spec, mesh)
    shared = _shared_heads(spec, mesh)
    if shared is None:
        return n
    dim, entry, spans = shared
    lo, hi = spans[sharding.axis_index(mesh, entry.axes)]
    per = [n * sum(lo_j <= h < hi_j for lo_j, hi_j in spans)
           for h in range(lo, hi)]
    per += [n] * (block.shape[dim] // entry.size - len(per))
    shape = [1] * block.ndim
    shape[dim] = block.shape[dim]
    return torch.tensor(per, dtype=torch.float32, device=block.device
                        ).repeat_interleave(entry.size).reshape(shape)


def _sharded_value_and_grad(cfg, params, batch: dict, q_chunk: int, mesh,
                            rules, onebit: bool):
    """-> (loss, metrics, this rank's gradient blocks as a list in leaf
    order) of ``batch`` (the global batch or a microbatch of it), its
    rows split over ``sharding.batch_axes``."""
    b = batch["tokens"].shape[0]
    ba = sharding.batch_axes(mesh, b)
    names = sharding._names(ba)
    if onebit and "pod" not in names:
        raise ValueError(f"onebit_pod splits the batch over pods: "
                         f"batch {b} on mesh {mesh.mesh_dim_names}")
    # the pods' sum is the one-bit vote's
    sum_axes = tuple(a for a in names if not (onebit and a == "pod"))
    # every rank makes the multi-axis groups together, before any use
    sharding.axis_group(mesh, sum_axes)
    dspecs = sharding.data_specs(mesh, b, "ctx" in batch)
    local = {k: sharding.shard(v, dspecs[k], mesh) for k, v in batch.items()}
    blocks = [p.detach().requires_grad_(True) for p in _leaves(params)]
    it = iter(blocks)
    live = verify.tree_map(lambda _: next(it), params)
    rules_tp = {"batch": ba, "tp": "model", "ep": "model"}
    with torch.enable_grad(), ctx.activation_rules(rules_tp, mesh):
        view = serve_step._view(cfg, live, mesh, rules, sum_axes)
        loss, metrics = lm.loss_fn(cfg, view, local, q_chunk=q_chunk,
                                   batch_sum=sharding.batch_sum(mesh,
                                                                sum_axes))
        del view, live
        # a rank's graph holds the same nodes as every other rank's, so
        # the backward's collectives (each gather's sum over the batch
        # axes, each ctx.enter's over model) meet in one order
        grads = torch.autograd.grad(loss, blocks, allow_unused=True)
    grads = [torch.zeros_like(b) if g is None else g
             for b, g in zip(blocks, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _sharded_grads(cfg, params, batch: dict, q_chunk: int, mesh, rules,
                   onebit: bool, microbatch: int = 1,
                   acc_dtype=torch.float32):
    """-> (loss, metrics, this rank's gradient blocks, the blocks'
    copies, a sum over every rank) of the sharded step.  ``microbatch``
    > 1: microbatch i is the global batch's rows [i mb, (i + 1) mb), as
    the reference reshapes it, split over the mesh like a batch of mb
    rows; the rank's gradient blocks are summed in ``acc_dtype`` (each
    part's rounded once) and averaged in f32, the loss is the parts'
    mean and the metrics the last part's (``_grads``)."""
    defs = pdefs.leaves(lm.param_defs(cfg))
    specs = pdefs.leaves(_pspecs(cfg, rules))
    if onebit and any("pod" in sharding._names(a) for s in specs
                      for a in s):
        raise ValueError("onebit_pod keeps the parameters whole across "
                         "pods; these rules place them over 'pod'")
    world = sharding.axis_group(mesh, mesh.mesh_dim_names)
    b = batch["tokens"].shape[0]
    if b % microbatch:
        raise ValueError(f"batch {b} is not a multiple of microbatch "
                         f"{microbatch}")
    mb = b // microbatch
    if microbatch <= 1:
        loss, metrics, grads = _sharded_value_and_grad(
            cfg, params, batch, q_chunk, mesh, rules, onebit)
    else:
        acc, loss = None, 0.0
        for i in range(microbatch):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            part_loss, metrics, grads = _sharded_value_and_grad(
                cfg, params, part, q_chunk, mesh, rules, onebit)
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=acc_dtype, device=g.device)
                       for g in grads]
            for a, g in zip(acc, grads):
                a.add_(g.to(acc_dtype))
            del grads
            loss = loss + part_loss
        grads = [a.float() / microbatch for a in acc]
        loss = loss / microbatch
    grads = _sum_shared_heads(grads, specs, mesh)
    copies = [_copies(s, mesh, g) for s, g in zip(specs, grads)]
    if onebit:
        grads = _pod_vote(grads, specs, defs, mesh, copies)
        pod = sharding.axis_group(mesh, "pod")
        n = sharding.group_size(pod)
        loss = sharding.all_reduce(loss.clone(), pod) / n
        metrics = {k: sharding.all_reduce(v.float(), pod) / n
                   for k, v in metrics.items()}
    git = iter(grads)
    return (loss, metrics, verify.tree_map(lambda _: next(git), params),
            copies, lambda x: sharding.all_reduce(x.clone(), world))


def train_step(cfg, state: TrainState, batch: dict, step, *,
               peak_lr: float = 3e-4, warmup: int = 100, total: int = 10000,
               q_chunk: int = 0, microbatch: int = 1,
               grad_compress: str = "none", mesh=None, rules=None,
               acc_dtype=torch.float32):
    """One optimizer step -> (state, metrics {ce, aux, tokens, loss,
    gnorm, lr}).  ``batch`` holds tensors on the state's device; ``step``
    addresses the schedule.  The parameters and moments are updated in
    place (:func:`optim.adamw.update`).

    With a ``mesh``: ``state`` holds this rank's blocks (:func:`init_state`
    with the same mesh and ``rules``), ``batch`` is the global batch (the
    step takes this rank's block, ``sharding.data_specs``), and the
    metrics are the global batch's.  ``grad_compress="onebit_pod"`` needs
    a ``pod`` axis that splits the batch: each pod's gradients (summed
    within the pod) go through the one-bit vote, and loss and metrics are
    the pods' mean.  ``microbatch`` > 1 splits the global batch as the
    single-device step does, each part over the mesh."""
    if grad_compress not in ("none", "onebit_pod"):
        raise ValueError(f"unknown grad_compress {grad_compress!r}")
    onebit = grad_compress == "onebit_pod"
    if mesh is None:
        if onebit:
            raise ValueError("grad_compress='onebit_pod' needs a mesh with "
                             "a 'pod' axis")
        loss, metrics, grads = _grads(cfg, state.params, batch, q_chunk,
                                      microbatch, acc_dtype)
        copies = psum = None
    else:
        if onebit and "pod" not in mesh.mesh_dim_names:
            raise ValueError("grad_compress='onebit_pod' needs a mesh with "
                             "a 'pod' axis")
        loss, metrics, grads, copies, psum = _sharded_grads(
            cfg, state.params, batch, q_chunk, mesh,
            rules or sharding.DEFAULT_RULES, onebit, microbatch, acc_dtype)
    lr = schedule.warmup_cosine(step, peak_lr=peak_lr, warmup=warmup,
                                total=total).to(loss.device)
    params, opt, gnorm = adamw.update(state.params, grads, state.opt, lr,
                                      copies=copies, psum=psum)
    metrics = dict(metrics, loss=loss, gnorm=gnorm, lr=lr)
    return TrainState(params, opt), metrics
