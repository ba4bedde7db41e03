"""Tensor- and expert-parallel serving over eight gloo ranks on the CPU,
on the (pod, data, model) = (2, 2, 2) mesh: the cases of
``test_torch_mesh_tp.py`` in f32 (each rank's rows of the batch against
the same rows of the single-process steps at ``rtol = atol = 1e-5``,
greedy tokens equal), what one decode step gathers, and the greedy
tokens of the reference's own sharded program.

On this mesh the batch is split over (pod, data) and the parameters'
FSDP blocks over ``data``: a decode step gathers each layer's ``data``
blocks just before the layer (and the embedding's at its use), and
nothing over ``model`` for the ``attn`` kind; the bytes it takes in for
parameters equal its blocks of every leaf split over ``data`` (one other
rank's block each, two ranks on ``data``).

The reference's program: ``repro.models.lm.prefill`` / ``decode_step``
jitted over 8 host devices on the same mesh under ``activation_rules``
(as ``tests/test_distributed.py`` runs the train step), qwen2-7b's smoke
config at 6 query and 2 KV heads, f32, from the reference's own
parameters; the port's sharded steps from those parameters must pick
the same greedy token at every step."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mesh_ranks import tp_params, tp_rank
from test_torch_mesh_tp import (CASES, QWEN, S_MAX, batch_of, case_dicts,
                                hold, single)
from repro_torch.core.xnor_layers import PackedLinear
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = {name: c for name, c in CASES.items() if c[2] == "float32"}
COUNTED = "qwen2-7b+xnor"


def _rows(coord) -> slice:
    pod, data, _ = coord
    return slice((2 * pod + data) * 2, (2 * pod + data) * 2 + 2)


@pytest.fixture(scope="module")
def ranks():
    return mesh_mod.run_ranks(tp_rank, 8, (2, 2, 2), ("pod", "data",
                                                      "model"),
                              case_dicts(F32, count=COUNTED), S_MAX, False,
                              device="cpu", timeout_s=600)


@pytest.mark.parametrize("name", list(F32))
def test_tensor_parallel_steps_on_pods_match_single_process(name, ranks):
    arch, over, dtype, packed = F32[name]
    want = single(arch, over, dtype, packed, batch_of(256))
    for r in ranks:
        hold(name, r["cases"][name]["logits"], want, dtype,
             _rows(r["coord"]))


def test_decode_step_gathers_its_fsdp_blocks_a_layer_at_a_time(ranks):
    """The parameter bytes one decode step takes in are the rank's blocks
    of the leaves split over ``data`` (each gathered once, from the one
    other rank on ``data``); no parameter is gathered over ``model``."""
    for r in ranks:
        got = r["cases"][COUNTED]
        calls = got["gathers"]["calls"]
        assert calls and all(axes == ["data"] for axes, _ in calls)
        on_data = _on_data(tp_params(*F32[COUNTED])[0])
        assert set(on_data) == set(got["blocks"])
        want = sum(nbytes for key, (nbytes, _) in got["blocks"].items()
                   if on_data[key])
        assert sum(n for _, n in calls) == want
        assert got["gathers"]["total"] > want    # and the activations


def _on_data(cfg) -> dict:
    """Leaf key -> whether the serving placement splits it over
    ``data``."""
    specs = lm.packed_param_pspecs(cfg, sharding.DEFAULT_RULES,
                                   head_aligned=True)
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{path}/{k}".lstrip("/"))
        elif isinstance(t, PackedLinear):
            walk(t.pb, path + "/0")          # verify.leaf_key's keys
            walk(t.beta, path + "/1")
        else:
            out[path] = "data" in {a for e in t for a in sharding._names(e)}
    walk(specs, "")
    return out


REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.configs as configs
    from repro.distributed import sharding
    from repro.distributed.ctx import activation_rules
    from repro.launch import mesh as mesh_mod
    from repro.models import lm

    out, s_max = sys.argv[1], int(sys.argv[2])
    data = np.load(out + "/batch.npz")
    cfg = configs.get("qwen2-7b").smoke(n_heads=6, n_kv_heads=2,
                                        dtype=jnp.float32)
    mesh = mesh_mod.make_smoke_mesh(8)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    ba = sharding.batch_axes(mesh, data["tokens"].shape[0])
    pspec = sharding.tree_named(mesh, lm.param_pspecs(
        cfg, dict(sharding.DEFAULT_RULES)))
    sspec = sharding.tree_named(mesh, lm.decode_state_pspecs(
        cfg, ba, "heads", 2))
    tok = NamedSharding(mesh, P(ba, None))
    lsp = NamedSharding(mesh, P(ba, None, "model"))
    with mesh, activation_rules({"batch": ba, "tp": "model", "ep": "model"}):
        pre = jax.jit(lambda p, t: lm.prefill(cfg, p, t, None, s_max=s_max),
                      in_shardings=(pspec, tok), out_shardings=(lsp, sspec))
        dec = jax.jit(lambda p, t, s: lm.decode_step(cfg, p, t, s),
                      in_shardings=(pspec, tok, sspec),
                      out_shardings=(lsp, sspec))
        logits, state = pre(params, jnp.asarray(data["tokens"]))
        steps = [np.asarray(logits)[:, -1]]
        for k in ("next0", "next1"):
            logits, state = dec(params, jnp.asarray(data[k]), state)
            steps.append(np.asarray(logits)[:, -1])
    np.save(out + "/tokens.npy", np.stack(steps)[..., :cfg.vocab].argmax(-1))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    np.savez(out + "/params.npz", **{
        "/".join(str(k.key) for k in path): np.asarray(v)
        for path, v in leaves})
""")


def _nest(flat) -> dict:
    tree: dict = {}
    for key in flat.files:
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def test_greedy_tokens_equal_the_reference_sharded_program(tmp_path):
    batch = batch_of(256, seed=9)
    np.savez(tmp_path / "batch.npz", tokens=batch["tokens"],
             next0=batch["next"][0], next1=batch["next"][1])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp_path),
                        str(S_MAX)], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "tokens.npy")                   # (3, B)
    params = _nest(np.load(tmp_path / "params.npz"))
    case = dict(arch="qwen2-7b", over=QWEN, dtype="float32", packed=False,
                batch=batch, params=params)
    ranks = mesh_mod.run_ranks(tp_rank, 8, (2, 2, 2), ("pod", "data",
                                                       "model"),
                               {"ref": case}, S_MAX, False, device="cpu",
                               timeout_s=600)
    for r in ranks:
        got = np.stack([s[:, -1, :256].argmax(-1)
                        for s in r["cases"]["ref"]["logits"]])
        assert np.array_equal(got, want[:, _rows(r["coord"])])
