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
``torch.distributed``: ``params`` holds this rank's blocks
(:func:`shard_params` under ``rules``; ``rules["fsdp"] = None`` is the
reference's serving placement, the parameters whole over the data axis),
every leaf is gathered whole at the step's start (``sharding.gather``, as
the sharded train step does), and the rank computes its block of the
batch over the batch axes (``sharding.batch_axes``).  The decode state
is held as ``lm.decode_state_pspecs`` places it over the batch axes, and
whole in its other dims: the port splits activations over the batch
axes only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.xnor_layers import PackedLinear
from repro_torch.distributed import sharding
from repro_torch.models import lm
from repro_torch.models.params import tree_map


def _packed(params) -> bool:
    return any(isinstance(v, PackedLinear) or (isinstance(v, dict)
                                               and _packed(v))
               for v in params.values())


def _specs(cfg, params, rules):
    """-> (placements, meta tree of whole shapes) of ``params``, the
    packed serve form's where it is packed."""
    rules = dict(rules or sharding.DEFAULT_RULES)
    if rules.get("fsdp") == "off":       # the reference's serving placement
        rules["fsdp"] = None
    if _packed(params):
        return (lm.packed_param_pspecs(cfg, rules),
                lm.packed_abstract_params(cfg))
    return lm.param_pspecs(cfg, rules), lm.abstract_params(cfg)


def shard_params(cfg, params: dict, mesh, rules=None) -> dict:
    """This rank's blocks of a whole (float or packed) parameter tree."""
    def one(p, s, _):
        if isinstance(p, PackedLinear):
            return PackedLinear(sharding.shard(p.pb, s.pb, mesh),
                                sharding.shard(p.beta, s.beta, mesh), p.k)
        return sharding.shard(p, s, mesh)
    return tree_map(one, params, *_specs(cfg, params, rules))


def whole_params(cfg, params: dict, mesh, rules=None) -> dict:
    """Every leaf gathered whole from the ranks' blocks."""
    def one(p, s, like):
        if isinstance(p, PackedLinear):
            return PackedLinear(
                sharding.gather(p.pb, s.pb, mesh, like.pb.shape),
                sharding.gather(p.beta, s.beta, mesh, like.beta.shape), p.k)
        return sharding.gather(p, s, mesh, like.shape)
    return tree_map(one, params, *_specs(cfg, params, rules))


def prefill_step(cfg, params, batch: dict, s_max: int, *, q_chunk: int = 0,
                 mesh=None, rules=None):
    """batch {tokens (B, S), [ctx (B, T_ctx, d)]} -> (logits (B, 1, V),
    dense DecodeState).  With a ``mesh``: ``params`` are this rank's
    blocks, ``batch`` the global batch, and the logits and the state this
    rank's block of the batch (a ``cross`` or enc-dec arch's context cut
    with it)."""
    if mesh is not None:
        params = whole_params(cfg, params, mesh, rules)
        specs = sharding.data_specs(mesh, batch["tokens"].shape[0],
                                    "ctx" in batch)
        batch = {k: sharding.shard(v, specs[k], mesh)
                 for k, v in batch.items()}
    return lm.prefill(cfg, params, batch["tokens"], s_max=s_max,
                      ctx=batch.get("ctx"), q_chunk=q_chunk)


def decode_step(cfg, params, token: torch.Tensor, state: lm.DecodeState, *,
                mesh=None, rules=None):
    """token (B, 1) -> (logits (B, 1, V), state).  With a ``mesh``:
    ``params`` are this rank's blocks, ``token`` the global batch's, and
    ``state`` and the logits this rank's block of the batch."""
    if mesh is not None:
        params = whole_params(cfg, params, mesh, rules)
        ba = sharding.batch_axes(mesh, token.shape[0])
        token = sharding.shard(token, (ba, None), mesh)
    return lm.decode_step(cfg, params, token, state)


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
