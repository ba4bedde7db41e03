"""The port's threefry twin (``repro_torch.core.prng``) against
``jax.random`` with ``jax_threefry_partitionable=True``.

Keys, ``fold_in``, ``split``, ``bits`` and ``uniform`` must be bitwise;
``gumbel`` applies two ``log``s, torch's and XLA's, which differ in the
last bit, so it is held within ``GUMBEL_ULPS`` ulps of ``max(|g|, 1)``
(each log is within one ulp of the other: the outer one moves g by one
ulp, the inner one by one ulp relative, which is about 2^-23 absolute).
The engine's sampler then gives the reference's tokens on logits from a
seed: a token that differs would have to sit on a near-tie of
``row / T + g`` closer than that bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.serve import engine as jengine
from repro.train import serve_step as jserve_step
import repro_torch.configs as configs
from repro_torch.core import prng
from repro_torch.serve import engine
from repro_torch.train import serve_step

SEEDS = [0, 5, 123456, 2**31 - 1]
DATA = [0, 1, 1_000_003, 2**31 - 2]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 4), (4, 256)]
GUMBEL_ULPS = 2


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32).astype(np.int64)


def test_jax_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    k, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(_u32(k), tk.numpy())
    for d in DATA:
        assert np.array_equal(_u32(jax.random.fold_in(k, d)),
                              prng.fold_in(tk, d).numpy()), d
    assert np.array_equal(_u32(jax.random.split(k)), prng.split(tk).numpy())
    assert np.array_equal(_u32(jax.random.split(k, 5)),
                          prng.split(tk, 5).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bitwise(seed, shape):
    for d in DATA:
        k = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        tk = prng.fold_in(prng.PRNGKey(seed), d)
        assert np.array_equal(_u32(jax.random.bits(k, shape)),
                              prng.bits(tk, shape).numpy())
        want = np.asarray(jax.random.uniform(k, shape))
        got = prng.uniform(tk, shape).numpy()
        assert np.array_equal(want.view(np.int32), got.view(np.int32))
        tiny = float(jnp.finfo(jnp.float32).tiny)
        want = np.asarray(jax.random.uniform(k, shape, minval=tiny))
        got = prng.uniform(tk, shape, tiny, 1.0).numpy()
        assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_batched_keys_equal_one_key_at_a_time():
    """The engine draws every row's noise at once from (B, 2) keys."""
    tk = prng.PRNGKey(3)
    seeds = torch.tensor([0, 7, 2**31 - 2, 12345])
    keys = prng.fold_in(tk, seeds)
    rows = prng.gumbel(keys, (300,))
    for i, s in enumerate(seeds.tolist()):
        assert torch.equal(rows[i], prng.gumbel(prng.fold_in(tk, s), (300,)))


@pytest.mark.parametrize("seed", [0, 9])
def test_gumbel_within_ulps(seed):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 77)
    tk = prng.fold_in(prng.PRNGKey(seed), 77)
    want = np.asarray(jax.random.gumbel(k, (8, 4096)))
    got = prng.gumbel(tk, (8, 4096)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert np.all(np.abs(got - want) <= GUMBEL_ULPS * ulp)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches(seed):
    k, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for lo, hi in [(0, 2**31 - 1), (3, 17), (0, 256)]:
        assert int(jax.random.randint(k, (), lo, hi)) == \
            prng.randint(tk, lo, hi)


@pytest.mark.parametrize("temperature", [0.0, 0.3, 0.8, 1.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_tokens_match_reference(temperature, dtype):
    """The engine's sampler on the same logits, engine key and
    (request, step) seeds draws the reference's tokens."""
    jcfg = jconfigs.get("qwen3-4b").smoke()
    cfg = configs.get("qwen3-4b").smoke()
    rng = np.random.default_rng(int(temperature * 10))
    for trial in range(6):
        lg = rng.standard_normal((5, 1, cfg.padded_vocab)).astype(np.float32)
        lg *= 2.0
        seeds = rng.integers(0, 2**31 - 1, 5).astype(np.int32)
        jl = jnp.asarray(lg).astype(dtype)
        tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(
            getattr(torch, dtype))
        want = np.asarray(jengine._sample_tokens(
            jcfg, jl, jax.random.PRNGKey(trial), jnp.asarray(seeds),
            temperature))
        got = engine._sample_tokens(cfg, tl, prng.PRNGKey(trial),
                                    torch.from_numpy(seeds), temperature)
        assert np.array_equal(want, got.numpy()), trial


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_static_sample_matches_reference(temperature):
    rng = np.random.default_rng(11)
    lg = rng.standard_normal((3, 2, 512)).astype(np.float32) * 2.0
    want = jserve_step.sample(jnp.asarray(lg), jax.random.PRNGKey(4),
                              temperature)
    got = serve_step.sample(torch.from_numpy(lg), prng.PRNGKey(4),
                            temperature)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_builds_seeds_only_when_sampling(temperature, monkeypatch):
    """Greedy decode draws nothing, so the engine copies no seeds to the
    device: ``_sample_tokens`` gets None at T = 0 and the (request, step)
    seeds above it, and the tokens equal a run whose sampler is handed
    the seeds every step."""
    cfg = configs.get("qwen3-4b").smoke(dtype=torch.float32)
    from repro_torch.models import lm
    from repro_torch.serve import synthetic_trace
    params = lm.init_params(cfg, 3, device="cpu")
    trace = synthetic_trace(3, cfg.vocab, seed=2, prompt_lens=(4, 7),
                            new_tokens=(3, 5))
    seen = []
    sample = engine._sample_tokens

    def spy(cfg_, logits, key, seeds, t):
        seen.append(seeds)
        if seeds is None:              # what a seed-taking sampler draws
            seeds = torch.zeros(logits.shape[0], dtype=torch.int32)
        return sample(cfg_, logits, key, seeds, t)

    def run():
        eng = engine.ServeEngine(cfg, params, slots=2, s_max=24, seed=1,
                                 temperature=temperature, device="cpu")
        for r in trace:
            eng.submit(r)
        rep = eng.run()
        return [rep.tokens(r.rid).tolist() for r in trace]

    want = run()
    monkeypatch.setattr(engine, "_sample_tokens", spy)
    assert run() == want
    assert seen
    if temperature == 0.0:
        assert all(s is None for s in seen)
    else:
        assert all(isinstance(s, torch.Tensor) and s.dtype == torch.int32
                   for s in seen)
