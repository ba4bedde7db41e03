"""The static-batch serving loop, the baseline the engine is measured
against (``launch/serve.py --static``):

  prefill_step    — consume a full prompt, build the dense decode state;
  decode_step     — one token for the whole batch against that state;
  sample          — greedy / temperature sampling from the last logits;
  generate_static — batch prefill + eager per-token decode, uniform shapes;
  generate        — compatibility wrapper over the continuous-batching
                    engine (slot-dense layout, float weights).

Mirrors ``repro/train/serve_step.py``; keys are
:mod:`repro_torch.core.prng` keys.  ``generate_static`` and ``generate``
run on ``device`` (CUDA unless the caller asks for the CPU).

With a ``mesh`` (a ``DeviceMesh`` of ``launch.mesh``) the two steps are
the reference's sharded serving programs, written out over
``torch.distributed`` under ``ctx.activation_rules`` (``{"batch": the
batch axes, "tp": "model", "ep": "model"}``): ``params`` holds this
rank's blocks (:func:`shard_params` under ``rules``; ``rules["fsdp"] =
None`` is the reference's serving placement, the parameters whole over
the data axis), the rank computes its block of the batch over the batch
axes (``sharding.batch_axes``), and the layers of every kind but the
context kinds (``enc``, ``cross``, ``dec``) compute tensor and expert
parallel over ``model``: a rank keeps its blocks of heads, ``d_ff``,
experts, channels and vocab (the head-aligned
placements of ``lm.param_pspecs(..., head_aligned=True)``) and computes
on them.  A layer's FSDP blocks are gathered just before it runs and
dropped after (``ctx.Segment``); a kind with no tensor-parallel form has
its layer gathered over ``model`` too and computes as on one device; the
embedding and the head are gathered at their use.  No step holds the
whole tree.  The decode state is held as ``lm.decode_state_pspecs(...,
head_aligned=True)`` places it: its batch rows, the KV heads of a
tensor-parallel layer's cache that the rank's query heads read, and
whole in every other dim.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.xnor_layers import PackedLinear
from repro_torch.distributed import ctx, sharding
from repro_torch.models import lm
from repro_torch.models import params as pdefs
from repro_torch.models.params import tree_map


def _packed(params) -> bool:
    return any(isinstance(v, PackedLinear) or (isinstance(v, dict)
                                               and _packed(v))
               for v in params.values())


def _specs(cfg, params, rules):
    """-> (placements, whole shapes) of ``params``' leaves, the packed
    serve form's where it is packed; head-aligned."""
    rules = dict(rules or sharding.DEFAULT_RULES)
    if rules.get("fsdp") == "off":       # the reference's serving placement
        rules["fsdp"] = None
    packed = _packed(params)
    specs = (lm.packed_param_pspecs if packed else lm.param_pspecs)(
        cfg, rules, head_aligned=True)
    return specs, pdefs.shapes(lm.param_defs(cfg), packed)


def shard_params(cfg, params: dict, mesh, rules=None) -> dict:
    """This rank's blocks of a whole (float or packed) parameter tree."""
    def one(p, s, _):
        if isinstance(p, PackedLinear):
            return PackedLinear(sharding.shard(p.pb, s.pb, mesh),
                                sharding.shard(p.beta, s.beta, mesh), p.k)
        return sharding.shard(p, s, mesh)
    return tree_map(one, params, *_specs(cfg, params, rules))


def _view(cfg, params: dict, mesh, rules, sum_axes=None) -> dict:
    """The tree the layers read: a segment's blocks gathered a layer at a
    time (over ``model`` too for a kind without a tensor-parallel form),
    the embedding's at their use, the rest gathered now.  ``sum_axes``:
    the sharded train step's batch axes, over which each gather's
    backward sums the gradient (``ctx.gather_leaf``)."""
    specs, shapes = _specs(cfg, params, rules)
    out = {}
    for key, blocks in params.items():
        if key.startswith(("seg", "enc")) and isinstance(blocks, dict):
            # a segment's layer-stacked leaves
            keep = ("model",) if lm._tensor_parallel(key) else ()
            out[key] = ctx.Segment(blocks, specs[key], shapes[key], mesh,
                                   keep, sum_axes)
        elif isinstance(blocks, dict):
            out[key] = ctx.Leaves(blocks, specs[key], shapes[key], mesh,
                                  ("model",), sum_axes)
        else:
            out[key] = ctx.gather_leaf(blocks, specs[key], shapes[key], mesh,
                                       (), sum_axes)
    return out


def _rules(mesh, batch: int) -> dict:
    return {"batch": sharding.batch_axes(mesh, batch), "tp": "model",
            "ep": "model"}


def prefill_step(cfg, params, batch: dict, s_max: int, *, q_chunk: int = 0,
                 mesh=None, rules=None):
    """batch {tokens (B, S), [ctx (B, T_ctx, d)]} -> (logits (B, 1, V),
    dense DecodeState).  With a ``mesh``: ``params`` are this rank's
    blocks, ``batch`` the global batch, and the logits and the state this
    rank's block of the batch (a ``cross`` or enc-dec arch's context cut
    with it; the state's KV heads as the module docstring says)."""
    if mesh is None:
        return lm.prefill(cfg, params, batch["tokens"], s_max=s_max,
                          ctx=batch.get("ctx"), q_chunk=q_chunk)
    b = batch["tokens"].shape[0]
    specs = sharding.data_specs(mesh, b, "ctx" in batch)
    batch = {k: sharding.shard(v, specs[k], mesh) for k, v in batch.items()}
    with ctx.activation_rules(_rules(mesh, b), mesh):
        return lm.prefill(cfg, _view(cfg, params, mesh, rules),
                          batch["tokens"], s_max=s_max, ctx=batch.get("ctx"),
                          q_chunk=q_chunk)


def decode_step(cfg, params, token: torch.Tensor, state: lm.DecodeState, *,
                mesh=None, rules=None):
    """token (B, 1) -> (logits (B, 1, V), state).  With a ``mesh``:
    ``params`` are this rank's blocks, ``token`` the global batch's, and
    ``state`` and the logits this rank's block of the batch."""
    if mesh is None:
        return lm.decode_step(cfg, params, token, state)
    b = token.shape[0]
    token = sharding.shard(token, (sharding.batch_axes(mesh, b), None), mesh)
    with ctx.activation_rules(_rules(mesh, b), mesh):
        return lm.decode_step(cfg, _view(cfg, params, mesh, rules), token,
                              state)


def sample(logits: torch.Tensor, key: torch.Tensor | None = None,
           temperature: float = 0.0) -> torch.Tensor:
    """(B, S, V) logits -> (B, 1) int32 tokens from the last position."""
    last = logits[:, -1]
    if temperature > 0.0:
        last = last / temperature + prng.gumbel(key, last.shape)
    return last.argmax(dim=-1).to(torch.int32)[:, None]


@torch.inference_mode()
def generate_static(cfg, params, prompt: torch.Tensor, n_new: int,
                    ctx: torch.Tensor | None = None,
                    temperature: float = 0.0,
                    key: torch.Tensor | None = None, *,
                    device="cuda") -> torch.Tensor:
    """The static-batch loop: batch prefill, then one eager decode step
    per token at uniform shapes -> (B, n_new) int32 on ``device``.  ``ctx``
    (B, T_ctx, d) is each row's modality context (frames for an enc-dec
    arch, encoded in the prefill).  Logits are sliced to the true vocab
    (pad ids are never sampled); the key is folded with the step index
    before each decode draw."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    prompt = prompt.to(dev)
    if key is not None:
        key = key.to(dev)
    s_max = prompt.shape[1] + n_new
    batch = {"tokens": prompt}
    if ctx is not None:
        batch["ctx"] = ctx.to(dev)
    logits, state = prefill_step(cfg, params, batch, s_max)
    tok = sample(logits[..., :cfg.vocab], key, temperature)
    out = [tok]
    for i in range(n_new - 1):
        if key is not None:
            key = prng.fold_in(key, i)
        logits, state = decode_step(cfg, params, tok, state)
        tok = sample(logits[..., :cfg.vocab], key, temperature)
        out.append(tok)
    return torch.cat(out, dim=1)


def generate(cfg, params, prompt: torch.Tensor, n_new: int,
             ctx: torch.Tensor | None = None, temperature: float = 0.0,
             key: torch.Tensor | None = None, *,
             device="cuda") -> torch.Tensor:
    """Each prompt row as one engine request on ``device`` (row ``i`` of
    ``ctx`` its context), slot-dense layout, float weights
    (``pack=False``): the reference's compatibility contract; the engine
    seed is drawn from ``key`` as the reference draws it -> (B, n_new)
    int32 on the host."""
    from repro_torch.serve import Request, ServeEngine

    b, p = prompt.shape
    seed = 0 if key is None else prng.randint(key, 0, 2**31 - 1)
    eng = ServeEngine(cfg, params, slots=b, s_max=p + n_new,
                      temperature=temperature, seed=seed, pack=False,
                      paged=False, device=device)
    prompt_h = prompt.cpu().numpy().astype(np.int32)
    ctx_h = None if ctx is None else ctx.cpu().numpy()
    for i in range(b):
        eng.submit(Request(rid=i, prompt=prompt_h[i], max_new_tokens=n_new,
                           ctx=None if ctx_h is None else ctx_h[i]))
    report = eng.run()
    return torch.from_numpy(np.stack([report.tokens(i) for i in range(b)])
                            ).to(torch.int32)
