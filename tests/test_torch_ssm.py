"""The port's RG-LRU half of ``repro.models.ssm`` against the reference.

Inputs are made with numpy from a seed and fed to both packages; the
reference runs eagerly (each op compiled on its own) and jitted, as its
serve engine runs it.  What is held:

* ``conv1d`` / ``conv1d_carry`` sum the taps in ``x.dtype`` left to right,
  as the reference does, and return the sum in f32 with its last add
  unrounded (what the jitted reference's RG-LRU reads): rounded to
  ``x.dtype``, bitwise against the eager reference in f32 and bf16, and
  against the jitted one in bf16.  Jitted f32 contracts each multiply-add
  into an FMA (one rounding, not two), which moves a sum by about an ulp
  of the taps' largest term.
* ``conv1d_step`` sums its f32 products through an einsum; XLA's CPU dot
  is an FMA chain over the taps.  bf16 results are bitwise; f32 ones are
  within the f32 bound below.
* ``rglru`` / ``rglru_step``: the combine order is the reference's
  associative scan (the odd/even recursion), so what differs is XLA's and
  torch's f32 ``exp``, ``log1p`` and ``sigmoid`` in the last bit on a share
  of inputs.  f32 state and outputs: within ``F32_ULPS`` ulps of the
  tensor's largest magnitude (readings over seeds 0-2 at S 8, 33 and 64:
  at most 1.3); bf16 outputs within one bf16 ulp of each element (plus the
  same f32 bound near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm

F32_ULPS = 4.0
EPS32 = 2.0 ** -23


def _close_f32(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    bound = F32_ULPS * EPS32 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _close_bf16(got, want, scale):
    """One bf16 ulp of each element, or the f32 bound of ``scale``."""
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        rtol=2.0 ** -7, atol=F32_ULPS * EPS32 * float(np.abs(scale).max()))


def _f(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.fixture(scope="module", params=[0, 1])
def inputs(request):
    rng = np.random.default_rng(request.param)
    b, s, d = 3, 33, 64
    return dict(
        x=rng.standard_normal((b, s, d)).astype(np.float32),
        r=(rng.standard_normal((b, s, d)) * 2).astype(np.float32),
        i=(rng.standard_normal((b, s, d)) * 2).astype(np.float32),
        lam=rng.standard_normal(d).astype(np.float32),
        h0=rng.standard_normal((b, d)).astype(np.float32),
        k=(rng.standard_normal((4, d)) * 0.5).astype(np.float32),
        buf=rng.standard_normal((b, 3, d)).astype(np.float32),
        # ragged: full, mid-chunk, shorter than the conv taps
        valid=np.arange(s)[None, :] < np.array([s, 20, 2])[:, None])


def _pair(a, jdt, tdt):
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("jit", [False, True])
def test_conv1d_forms(inputs, jdt, tdt, jit):
    jx, tx = _pair(inputs["x"], jdt, tdt)
    jb, tb = _pair(inputs["buf"], jdt, tdt)
    k = inputs["k"]
    jk, tk = jnp.asarray(k), torch.from_numpy(k)
    wrap = jax.jit if jit else (lambda f: f)
    bitwise = tdt == torch.bfloat16 or not jit
    for want, got32 in (
            (wrap(jssm.conv1d)(jx, jk), ssm.conv1d(tx, tk)),
            (wrap(jssm.conv1d_carry)(jb, jx, jk), ssm.conv1d_carry(tb, tx, tk)),
            (wrap(jssm.conv1d_carry)(jnp.zeros_like(jb), jx, jk),
             ssm.conv1d(tx, tk))):               # a zero carry is conv1d
        assert got32.dtype == torch.float32
        got = got32.to(tdt)
        if bitwise:
            np.testing.assert_array_equal(_f(got), _f(want))
        else:
            _close_f32(_f(got), _f(want))
    ya, ba = wrap(jssm.conv1d_step)(jb, jx[:, :1], jk)
    yb, bb = ssm.conv1d_step(tb, tx[:, :1], tk)
    np.testing.assert_array_equal(_f(bb), _f(ba))
    if tdt == torch.bfloat16:
        np.testing.assert_array_equal(_f(yb), _f(ya))
    else:
        _close_f32(_f(yb), _f(ya))


@pytest.mark.parametrize("n_valid", [0, 1, 2, 3, 5, 33])
def test_conv1d_carry_out(inputs, n_valid):
    """The carry keeps the last W-1 valid inputs; with fewer valid than
    W-1 the old buffer's tail stays (bitwise: a pure slice)."""
    jx, tx = _pair(inputs["x"], jnp.bfloat16, torch.bfloat16)
    jb, tb = _pair(inputs["buf"], jnp.bfloat16, torch.bfloat16)
    np.testing.assert_array_equal(
        _f(ssm.conv1d_carry_out(tb, tx, n_valid)),
        _f(jssm.conv1d_carry_out(jb, jx, n_valid)))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_rglru_sequence(inputs, jdt, tdt, jit, ragged):
    """The sequence form with a nonzero carry (and ragged ``valid``: the
    padded steps are the identity, so a row's final state is its state at
    its last valid token)."""
    jx, tx = _pair(inputs["x"], jdt, tdt)
    jr, tr = _pair(inputs["r"], jdt, tdt)
    ji, ti = _pair(inputs["i"], jdt, tdt)
    lam, h0, valid = inputs["lam"], inputs["h0"], inputs["valid"]
    fn = jax.jit(jssm.rglru, static_argnums=4) if jit else jssm.rglru
    jy, jst = fn(jx, jr, ji, jnp.asarray(lam), 8.0,
                 jssm.RGLRUState(jnp.asarray(h0)),
                 valid=jnp.asarray(valid) if ragged else None)
    ty, tst = ssm.rglru(tx, tr, ti, torch.from_numpy(lam), 8.0,
                        ssm.RGLRUState(torch.from_numpy(h0)),
                        valid=torch.from_numpy(valid) if ragged else None)
    assert ty.dtype == tdt and tst.h.dtype == torch.float32
    _close_f32(tst.h.numpy(), np.asarray(jst.h))
    if tdt == torch.float32:
        _close_f32(_f(ty), _f(jy))
    else:
        _close_bf16(_f(ty), _f(jy), np.asarray(jst.h))
    if ragged and tdt == torch.float32:
        # row 2 has 2 valid tokens: the padding steps keep h_1 exactly
        np.testing.assert_array_equal(tst.h[2].numpy(), ty[2, 1].numpy())


def test_rglru_scan_order_is_the_references():
    """The odd/even recursion, not a running product: against
    ``jax.lax.associative_scan`` on the same f32 (a, b) elements, the
    combine order gives the same bits at every length up to 40."""
    rng = np.random.default_rng(5)
    for n in range(1, 41):
        a = rng.uniform(0.5, 1.0, (2, n, 8)).astype(np.float32)
        b = rng.standard_normal((2, n, 8)).astype(np.float32)

        def combine(left, right):
            return left[0] * right[0], right[0] * left[1] + right[1]
        _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                     jnp.asarray(b)), axis=1)
        _, got = ssm._assoc_scan([torch.from_numpy(a), torch.from_numpy(b)])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("jit", [False, True])
def test_rglru_step(inputs, jdt, tdt, jit):
    jx, tx = _pair(inputs["x"][:, :1], jdt, tdt)
    jr, tr = _pair(inputs["r"][:, :1], jdt, tdt)
    ji, ti = _pair(inputs["i"][:, :1], jdt, tdt)
    lam, h0 = inputs["lam"], inputs["h0"]
    fn = jax.jit(jssm.rglru_step, static_argnums=4) if jit else \
        jssm.rglru_step
    jy, jst = fn(jx, jr, ji, jnp.asarray(lam), 8.0,
                 jssm.RGLRUState(jnp.asarray(h0)))
    ty, tst = ssm.rglru_step(tx, tr, ti, torch.from_numpy(lam), 8.0,
                             ssm.RGLRUState(torch.from_numpy(h0)))
    _close_f32(tst.h.numpy(), np.asarray(jst.h))
    if tdt == torch.float32:
        _close_f32(_f(ty), _f(jy))
    else:
        _close_bf16(_f(ty), _f(jy), np.asarray(jst.h))


def test_step_continues_the_sequence(inputs):
    """The port's own two forms agree: S steps of ``rglru_step`` from the
    carry end where one ``rglru`` call over the S tokens ends (f32 bound:
    the forms compute sqrt(1 - a^2) two ways, as the reference's do)."""
    x, r, i = (torch.from_numpy(inputs[n][:, :8]) for n in "xri")
    lam = torch.from_numpy(inputs["lam"])
    st = ssm.RGLRUState(torch.from_numpy(inputs["h0"]))
    _, whole = ssm.rglru(x, r, i, lam, 8.0, st)
    for t in range(8):
        _, st = ssm.rglru_step(x[:, t:t + 1], r[:, t:t + 1], i[:, t:t + 1],
                               lam, 8.0, st)
    np.testing.assert_allclose(st.h.numpy(), whole.h.numpy(), rtol=1e-5,
                               atol=1e-5)
