"""The port's optimizers against the JAX package's, on the CPU.

- the schedules at every step of a 100-step run: within 4 f32 ulp
  (``SCHED_TOL``; ``cos`` is the platform's, 2 ulp apart at 3 steps);
- AdamW, tensor for tensor over three steps on a tree shaped like a
  model's (bf16 matrices, an f32 layer-stacked norm scale, an f32
  vector): parameters, both moments, the step and the global norm within
  ``ADAM_TOL`` (the global norm's sums run in another order, and
  ``b ** step`` is the platform's f32 pow), with the stacked (n_layers,
  d) norm scale decayed as the reference decays it (``ndim >= 2``) and
  the vector not;
- one-bit compression: ``compress_leaf``'s planes bitwise, its scale
  and residual within 1e-6, the decompressed leaf within 1e-6; the
  error-feedback property of the reference's own test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch.core import bitpack
from repro_torch.optim import adamw, compress, schedule

SCHED_TOL = dict(rtol=2 ** -21, atol=1e-12)
ADAM_TOL = dict(rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["warmup_cosine", "wsd"])
def test_schedules_match_reference(name):
    kw = dict(peak_lr=3e-3, warmup=10, total=100)
    want = np.asarray(getattr(jschedule, name)(jnp.arange(100), **kw))
    got = getattr(schedule, name)(torch.arange(100), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **SCHED_TOL)
    for step in (0, 9, 10, 55, 99):
        assert float(getattr(schedule, name)(step, **kw)) == \
            pytest.approx(float(want[step]), rel=2 ** -21)


def test_schedules_shape():
    """The reference test's shape of both curves."""
    lr = schedule.warmup_cosine(torch.arange(100), peak_lr=1.0, warmup=10,
                                total=100)
    assert float(lr[0]) == 0.0 and abs(float(lr[10]) - 1.0) < 1e-6
    assert float(lr[99]) < 0.2
    lr2 = schedule.wsd(torch.arange(100), peak_lr=1.0, warmup=10, total=100)
    assert abs(float(lr2[50]) - 1.0) < 1e-6 and float(lr2[99]) < 0.2


def _tree(rng):
    return {"embed": {"tokens": rng.standard_normal((16, 8)),
                      "final_norm": 1 + 0.1 * rng.standard_normal(8)},
            "seg0_attn": {"ln1": 1 + 0.1 * rng.standard_normal((2, 8)),
                          "attn_wq": rng.standard_normal((2, 8, 8)) / 3}}


DTYPES = {"tokens": "bfloat16", "final_norm": "float32", "ln1": "float32",
          "attn_wq": "bfloat16"}


def _both(tree):
    """The same leaves in both packages.  The torch leaves are copies:
    ``np.asarray`` of an f32 JAX array is a view of its buffer, and the
    port's AdamW writes its parameters in place, possibly before the
    reference's asynchronously dispatched step has read them."""
    j = {k: {n: jnp.asarray(v, DTYPES[n]) for n, v in sub.items()}
         for k, sub in tree.items()}
    t = {k: {n: torch.from_numpy(np.array(j[k][n], np.float32, copy=True))
             .to(getattr(torch, DTYPES[n])) for n in sub}
         for k, sub in tree.items()}
    return j, t


def _close(t, j, **tol):
    for k in j:
        for n in j[k]:
            np.testing.assert_allclose(t[k][n].float().numpy(),
                                       np.asarray(j[k][n], np.float32),
                                       **tol, err_msg=f"{k}/{n}")


def test_adamw_matches_reference_tensor_for_tensor():
    rng = np.random.default_rng(0)
    jp, tp = _both(_tree(rng))
    jst, tst = jadamw.init(jp), adamw.init(tp)
    for i in range(3):
        jg, tg = _both(_tree(rng))
        lr = 1e-2 * (i + 1)
        jp, jst, jn = jax.jit(jadamw.update)(jp, jg, jst, jnp.float32(lr))
        tp, tst, tn = adamw.update(tp, tg, tst, torch.tensor(lr))
        np.testing.assert_allclose(float(tn), float(jn), **ADAM_TOL)
        _close(tp, jp, rtol=2 ** -7 if i else 1e-6, atol=1e-9)
        _close(tst.m, jst.m, **ADAM_TOL)
        _close(tst.v, jst.v, **ADAM_TOL)
        assert int(tst.step) == int(jst.step) == i + 1


def test_adamw_decays_stacked_norm_scales_not_vectors():
    """With zero gradients the update is the decay alone: a (n_layers, d)
    norm scale shrinks by lr * wd * p (the reference stacks a segment's
    norms, so they are matrices to its ``ndim >= 2`` rule); a vector
    stays."""
    p = {"ln1": torch.ones((2, 8)), "final_norm": torch.ones(8)}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    p, _, gn = adamw.update(p, g, adamw.init(p), 0.5, weight_decay=0.1)
    assert float(gn) == 0.0
    assert torch.equal(p["ln1"], torch.full((2, 8), 1 - 0.5 * 0.1))
    assert torch.equal(p["final_norm"], torch.ones(8))
    jp = {"ln1": jnp.ones((2, 8)), "final_norm": jnp.ones(8)}
    jp, _, _ = jadamw.update(jp, jax.tree.map(jnp.zeros_like, jp),
                             jadamw.init(jp), 0.5, weight_decay=0.1)
    np.testing.assert_array_equal(np.asarray(jp["ln1"]), p["ln1"].numpy())


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    jg, tg = _both(_tree(rng))
    jc, jn = jadamw.clip_by_global_norm(jg, 0.5)
    tc, tn = adamw.clip_by_global_norm(tg, 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close(tc, jc, rtol=2 ** -7, atol=1e-9)
    assert all(tc[k][n].dtype == tg[k][n].dtype for k in tg for n in tg[k])


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([5.0, -3.0])}
    st = adamw.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, st, _ = adamw.update(params, grads, st, lr=0.05,
                                     weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.2


def test_adamw_abstract_is_meta():
    p = {"a": torch.zeros((3, 4), dtype=torch.bfloat16), "b": torch.ones(2)}
    st = adamw.abstract(p)
    assert st.step.device.type == "meta" and st.step.dtype == torch.int32
    assert st.m["a"].shape == (3, 4) and st.m["a"].dtype == torch.float32
    assert st.v["b"].device.type == "meta"


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 4096])
def test_compress_leaf_matches_reference(n):
    rng = np.random.default_rng(n)
    g = rng.standard_normal(n).astype(np.float32)
    e = (0.1 * rng.standard_normal(n)).astype(np.float32)
    g[: n // 7] = 0.0                     # zeros pack as +1
    jplanes, jscale, je = jcompress.compress_leaf(jnp.asarray(g),
                                                  jnp.asarray(e))
    planes, scale, ne = compress.compress_leaf(torch.from_numpy(g),
                                               torch.from_numpy(e))
    np.testing.assert_array_equal(bitpack.to_numpy_u32(planes),
                                  np.asarray(jplanes))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)
    np.testing.assert_allclose(ne.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-6)
    back = compress.decompress_leaf(planes, scale, (n,), torch.bfloat16)
    jback = jcompress.decompress_leaf(jplanes, jscale, (n,), jnp.bfloat16)
    assert back.dtype == torch.bfloat16
    np.testing.assert_allclose(back.float().numpy(),
                               np.asarray(jback, np.float32), rtol=2 ** -8)


def test_compress_grads_round_trip_tree():
    rng = np.random.default_rng(2)
    _, tg = _both(_tree(rng))
    st = compress.init(tg)
    comp, st2 = compress.compress_grads(tg, st)
    back = compress.decompress_grads(comp, tg)
    for k in tg:
        for n in tg[k]:
            g = tg[k][n].float()
            planes, scale = comp[k][n]
            assert back[k][n].dtype == tg[k][n].dtype
            np.testing.assert_allclose(
                (back[k][n].float() + st2.error[k][n]).numpy(), g.numpy(),
                rtol=2 ** -7, atol=1e-2 * float(scale))
    assert compress.abstract(tg).error["embed"]["tokens"].device.type == \
        "meta"


def test_onebit_compression_error_feedback():
    """The reference's property: with the residual carried, the sum of
    the compressed gradients tracks the sum of the true ones, off by
    exactly the final residual."""
    rng = np.random.default_rng(0)
    g_seq = [torch.from_numpy(rng.standard_normal(64).astype(np.float32))
             * 0.1 for _ in range(50)]
    e = torch.zeros(64)
    acc_true, acc_comp = torch.zeros(64), torch.zeros(64)
    for g in g_seq:
        planes, scale, e = compress.compress_leaf(g, e)
        acc_true += g
        acc_comp += compress.decompress_leaf(planes, scale, (64,),
                                             torch.float32)
    np.testing.assert_allclose((acc_true - acc_comp).numpy(), e.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert float(e.norm()) < 0.5 * float(acc_true.norm())
