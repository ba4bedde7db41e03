"""The sharded serving steps over eight gloo ranks on the CPU, on the
(pod, data, model) = (2, 2, 2) mesh, against the single-process
``prefill_step`` / ``decode_step`` of the same package.

Each rank keeps its blocks of the parameters (float, or the packed serve
form of a ``+xnor`` arch; the default ZeRO-3 placement and the
reference's serving placement ``fsdp="off"``), gathers each layer's FSDP
blocks just before the layer (the ``attn`` layers compute tensor
parallel over ``model``; the vlm's ``cross`` layers are gathered whole),
and computes its block of the batch (8 rows over (pod, data): two a
rank) with its block of the dense decode state.  A prefill of 12
tokens, then two decode steps of teacher-forced tokens; every rank's
logits rows of each step are held against the same rows of the
single-process steps, in f32 at ``rtol = atol = 1e-5`` (the same
function on a quarter of the rows: only a product's blocking by the row
count can move a last bit), and their greedy tokens must be equal.
llama-3.2-vision's ``cross`` layers read a per-row context, which the
step cuts with the batch."""

import numpy as np
import pytest
import torch

from mesh_ranks import serve_rank
import repro_torch.configs as configs
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.train import serve_step

torch.set_num_threads(1)

B, S, S_MAX = 8, 12, 16
TOL = dict(rtol=1e-5, atol=1e-5)
OFF = dict(sharding.DEFAULT_RULES, fsdp="off")
CASES = {"qwen2-7b": ("qwen2-7b", False, None),
         "qwen2-7b+xnor packed": ("qwen2-7b+xnor", True, None),
         "qwen2-7b+xnor packed fsdp off": ("qwen2-7b+xnor", True, OFF),
         "llama-3.2-vision-11b+xnor packed": ("llama-3.2-vision-11b+xnor",
                                              True, None)}


def _batch(cfg) -> dict:
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
           "next": [rng.integers(0, cfg.vocab, (B, 1), dtype=np.int32)
                    for _ in range(2)]}
    if cfg.n_ctx_tokens:
        out["ctx"] = rng.standard_normal(
            (B, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    return out


def _single(arch: str, packed: bool, batch: dict) -> list:
    cfg = configs.get(arch).smoke(dtype=torch.float32)
    params = lm.init_params(cfg, 0, device="cpu")
    if packed:
        params = lm.pack_params(cfg, params)
    data = {k: torch.from_numpy(v) for k, v in batch.items() if k != "next"}
    with torch.inference_mode():
        logits, state = serve_step.prefill_step(cfg, params, data, S_MAX)
        steps = [logits.float().numpy()]
        for tok in batch["next"]:
            logits, state = serve_step.decode_step(
                cfg, params, torch.from_numpy(tok), state)
            steps.append(logits.float().numpy())
    return steps


@pytest.fixture(scope="module")
def runs():
    batches = {name: _batch(configs.get(arch).smoke())
               for name, (arch, _, _) in CASES.items()}
    cases = {name: (arch, packed, rules, batches[name])
             for name, (arch, packed, rules) in CASES.items()}
    ranks = mesh_mod.run_ranks(serve_rank, 8, cases, S_MAX, device="cpu",
                               timeout_s=600)
    return batches, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_steps_match_single_process(name, runs):
    batches, ranks = runs
    arch, packed, _ = CASES[name]
    want = _single(arch, packed, batches[name])
    for r in ranks:
        got = r[name]
        pod, data, _ = got["coord"]
        rows = slice((2 * pod + data) * 2, (2 * pod + data) * 2 + 2)
        assert len(got["logits"]) == len(want) == 3
        for step, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w[rows], **TOL,
                                       err_msg=f"{name} step {step}")
            assert np.array_equal(g[:, -1].argmax(-1),
                                  w[rows][:, -1].argmax(-1)), (name, step)


def test_decode_state_is_split_over_the_batch_axes_only():
    """The reference's placement of the dense state (its KV heads over
    ``model``) and the shape of a rank's rows of it; the port's own
    placement, its query heads' KV heads a rank, is held in
    ``test_torch_mesh_tp.py``."""
    cfg = configs.get("qwen2-7b").smoke()
    spec = lm.decode_state_pspecs(cfg, ("pod", "data"), "heads", 2)
    cache = spec.seg_states[0]
    assert cache.k == (None, ("pod", "data"), "model", None, None)
    one = lm.decode_state_spec(cfg, B // 4, S_MAX, device="meta")
    k = one.seg_states[0].k
    assert k.shape == (cfg.n_layers, B // 4, cfg.n_kv_heads, S_MAX,
                       cfg.d_head)
