"""The Monte-Carlo variation analysis and the speedup models of the port
against the JAX reference, on the CPU.

The reference draws each world from a threefry key (``_one_sample``:
``split(key, 5)``, two normal vectors, two normal scalars, a Bernoulli
vector).  The tests replay that key schedule in JAX to get the exact
draws, hand them to the port's evaluation as numpy, and compare with
``repro.core.montecarlo.run`` on the same key: currents and voltages at
rtol 1e-6 (4e-6 for 512-row columns, whose f32 row sums XLA and the port
round differently), sense outputs and error rates exactly.  Margins are
differences of two such currents (I_01 - REF1 ~ 4 uA from ~8 uA), so they
are held at the same rtol of the currents they are taken from:
atol = rtol * max |I_SL|.  The
port's own torch draws are checked statistically against the
reference's: means within 4 standard errors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import montecarlo as jmc
from repro.core import speedup as jspeedup
from repro_torch.core import cim, montecarlo, speedup


def _reference_draws(key, samples, rows, banks) -> montecarlo.Draws:
    """The draws ``repro.core.montecarlo.run`` makes from ``key``."""
    keys = jax.random.split(key, samples * banks)

    def one(k):
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        return (jax.random.normal(k1, (rows,)), jax.random.normal(k2, (rows,)),
                jax.random.normal(k3, ()), jax.random.normal(k4, ()),
                jax.random.bernoulli(k5, 0.5, (rows - 2,)))
    out = jax.vmap(one)(keys)
    return montecarlo.Draws(*(
        torch.from_numpy(np.array(x).reshape(samples, banks, *x.shape[1:]))
        for x in out))


FLOATS = ("i_sl", "v_cell", "v_ref", "margins")
BOOLS = ("xor_out", "xnor_out", "error_rate")


@pytest.mark.parametrize("samples,rows,banks,rtol", [
    (400, 3, 1, 1e-6), (300, 3, 4, 1e-6), (50, 16, 3, 1e-6),
    # the engine's bank geometry: XLA's f32 sum of a column's 512 rows is
    # itself ~1e-6 from the exact sum (1.0e-6 at worst over three keys),
    # so two summation orders are held at 4e-6
    (64, 512, 8, 4e-6)])
def test_evaluation_on_reference_draws_matches_reference(samples, rows,
                                                         banks, rtol):
    key = jax.random.PRNGKey(samples + rows + banks)
    want = jmc.run(key, samples=samples, rows=rows, banks=banks)
    got = montecarlo.evaluate(_reference_draws(key, samples, rows, banks))
    i_scale = float(np.abs(np.asarray(want.i_sl)).max())
    for name in FLOATS:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape and g.dtype == np.float32, name
        atol = rtol * i_scale if name == "margins" else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
    for name in BOOLS:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


def _exact_column_sums(d: montecarlo.Draws) -> np.ndarray:
    """Each column's current from the reference's f32 terms (the two
    accessed cells' V / (R + R_ACC), the unaccessed cells' leak constants),
    summed exactly in f64 with numpy -> (samples, banks, 3)."""
    f = np.float32
    lrs = f(cim.LRS) * (f(1.0) + f(montecarlo.SIGMA_FRAC) * d.z_lrs.numpy())
    hrs = f(cim.HRS) * (f(1.0) + f(montecarlo.SIGMA_FRAC) * d.z_hrs.numpy())
    pair = np.array([[False, False], [False, True], [True, True]])
    r = np.where(pair, lrs[:, :, None, :2], hrs[:, :, None, :2])
    i_on = (f(cim.V_BL) / (r + f(cim.R_ACC))).astype(np.float64).sum(-1)
    leak = np.where(d.unacc.numpy(), f(cim.LEAK_LRS), f(cim.LEAK_HRS))
    return i_on + leak.astype(np.float64).sum(-1)[..., None]


def _row_sum_gaps(key, samples=64, rows=512, banks=8):
    """Relative gaps of the reference's and the port's f32 column sums
    from the exact sum, and from each other."""
    d = _reference_draws(key, samples, rows, banks)
    want = np.asarray(jmc.run(key, samples=samples, rows=rows,
                              banks=banks).i_sl, np.float64)
    got = montecarlo.evaluate(d).i_sl.numpy().astype(np.float64)
    exact = _exact_column_sums(d)
    return {"reference-exact": np.abs(want - exact) / exact,
            "port-exact": np.abs(got - exact) / exact,
            "port-reference": np.abs(got - want) / exact}


@pytest.mark.parametrize("seed", [584, 587, 3])
def test_512_row_gap_is_the_reference_rounding(seed):
    """The port rounds each column's exact sum once (half an f32 ulp,
    2^-24 relative); its gap from the reference is then the reference's own
    f32 summation error, which is why 512-row columns are held at 4e-6."""
    gaps = _row_sum_gaps(jax.random.PRNGKey(seed))
    assert gaps["port-exact"].max() <= 2.0 ** -24
    assert np.all(gaps["port-reference"]
                  <= gaps["reference-exact"] + 2.0 ** -24)
    assert gaps["port-reference"].max() < 4e-6


def test_evaluation_sees_a_failing_world():
    """V_t draws far enough out to mis-sense: the error rate is the count of
    mis-sensed XOR outputs times 1/n."""
    key = jax.random.PRNGKey(7)
    d = _reference_draws(key, 200, 3, 1)
    d = d._replace(z_vt1=d.z_vt1 * 60.0, z_vt2=d.z_vt2 * 60.0)
    got = montecarlo.evaluate(d)
    assert got.error_rate.sum() > 0
    want_xor = torch.tensor([False, True, False])
    assert torch.equal(got.error_rate,
                       (got.xor_out != want_xor).float().sum(0) * (1 / 200))


def test_run_statistics_match_reference():
    samples = 5000
    want = jmc.run(jax.random.PRNGKey(0), samples=samples)
    g = torch.Generator().manual_seed(0)
    got = montecarlo.run(g, samples=samples, device="cpu")
    assert got.i_sl.shape == (samples, 3) and got.margins.shape == (samples, 2)
    for name in FLOATS:
        w = np.asarray(getattr(want, name), np.float64)
        x = getattr(got, name).double().numpy()
        se = np.sqrt(w.var(0) / samples + x.var(0) / samples)
        assert np.all(np.abs(x.mean(0) - w.mean(0)) <= 4 * se + 1e-30), name
    assert np.array_equal(got.error_rate.numpy(), np.asarray(want.error_rate))
    assert float(got.error_rate.sum()) == 0.0       # the paper's result


def test_run_draws_on_the_generator_and_is_reproducible():
    a = montecarlo.run(torch.Generator().manual_seed(3), samples=32, rows=8,
                       banks=2, device="cpu")
    b = montecarlo.run(torch.Generator().manual_seed(3), samples=32, rows=8,
                       banks=2, device="cpu")
    assert a.i_sl.shape == (32, 2, 3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="accessed"):
        montecarlo.draw(torch.Generator(), rows=1)


def test_max_rows_and_sweep_match_reference():
    assert float(montecarlo.max_rows()) == float(jmc.max_rows())
    for lrs, hrs, frac in ((5e3, 3e9, 0.5), (20e3, 1e9, 0.3), (1e4, 3e7, 0.9)):
        assert float(montecarlo.max_rows(lrs, hrs, frac)) == \
            float(jmc.max_rows(lrs, hrs, frac))
    ratios = np.logspace(2, 6, 17).astype(np.float32)
    for vary in ("lrs", "hrs"):
        want = np.asarray(jmc.max_rows_sweep(jnp.asarray(ratios), vary))
        got = montecarlo.max_rows_sweep(torch.from_numpy(ratios), vary)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want), vary


def test_speedup_models_match_reference():
    n_o = np.array([1, 2, 8, 64, 512, 4096, 32768, 131072, 1 << 20],
                   np.float32)
    for kw in ({}, {"c": 64, "n_w": 9, "n_i": 196}):
        assert np.array_equal(speedup.xnornet_speedup(n_o, **kw).numpy(),
                              np.asarray(jspeedup.xnornet_speedup(n_o, **kw)))
        assert np.array_equal(speedup.xornet_speedup(n_o, **kw).numpy(),
                              np.asarray(jspeedup.xornet_speedup(n_o, **kw)))
    assert float(speedup.xnornet_speedup(512)) == \
        float(jspeedup.xnornet_speedup(512))
    assert speedup.TABLE_I == jspeedup.TABLE_I
    for design in speedup.TABLE_I:
        for n_bits in (1, 511, 512, 513, 10 ** 6):
            assert speedup.design_cycles(design, n_bits) == \
                jspeedup.design_cycles(design, n_bits)
            assert speedup.design_cycles(design, n_bits, 128) == \
                jspeedup.design_cycles(design, n_bits, 128)
        assert speedup.copy_verify_cycles(100, design) == \
            jspeedup.copy_verify_cycles(100, design)
    assert speedup.tpu_n_o() == jspeedup.tpu_n_o()
    assert speedup.TpuBitEngine(sublanes=4).n_o == \
        jspeedup.TpuBitEngine(sublanes=4).n_o


if __name__ == "__main__":
    # the readings behind the 512-row tolerance, over 20 keys:
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_montecarlo.py
    worst = {}
    for seed in range(20):
        for k, v in _row_sum_gaps(jax.random.PRNGKey(seed)).items():
            worst[k] = max(worst.get(k, 0.0), float(v.max()))
    print("largest relative gap over 20 keys, 64 samples x 8 banks x 512 "
          "rows:", worst)
