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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.models import lm
from repro_torch.models.params import tree_map


def prefill_step(cfg, params, batch: dict, s_max: int):
    """batch {tokens (B, S), [ctx (B, T_ctx, d)]} -> (logits (B, 1, V),
    dense DecodeState)."""
    return lm.prefill(cfg, params, batch["tokens"], s_max=s_max,
                      ctx=batch.get("ctx"))


def decode_step(cfg, params, token: torch.Tensor, state: lm.DecodeState):
    """token (B, 1) -> (logits (B, 1, V), state)."""
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
