"""The port's mixture-of-experts FFN and ``moe`` block against the JAX
package's, on the CPU.

Inputs and weights are made from a seed with numpy (blocks: converted from
``jax.random`` parameters) and fed to both packages; the reference runs
jitted, as its engine runs it.  What is held:

- routing (the chosen experts, the kept mask, each kept choice's queue
  place): bitwise, read from the reference's own ``top_k`` and combine
  einsum inside its jitted program;
- ``y``: in f32 within ``Y_F32_TOL`` (the expert products' f32 sums run
  in another order: about 2^-22 of |y|); in bf16 within one bf16 ulp
  (2^-7 relative) of |y| plus one of the expert outputs it sums,
  ``sum_j w_j |ye_j|`` (a different f32 summation order inside an expert
  product changes its bf16 rounding in about one element of 256, and a
  token's top-k sum may cancel far below its terms), with the rate of
  differing elements printed;
- the aux loss: allclose at ``AUX_TOL``.
"""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import moe as jmoe
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.models import blocks, lm, moe

from test_torch_layers import BF16_LOGIT_BOUND, _chunk_and_decode

MOONSHOT, LLAMA4 = "moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"
Y_F32_TOL = dict(rtol=1e-5, atol=1e-6)
AUX_TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs(name, dtype, **over):
    return (jconfigs.get(name).smoke(dtype=jnp.dtype(dtype), **over),
            configs.get(name).smoke(dtype=getattr(torch, dtype), **over))


@contextlib.contextmanager
def _recording(rec: dict):
    """Record the reference's routing from inside its jitted program: the
    ``top_k`` indices and the combine einsum's kept mask and place
    one-hots, through ``jax.debug.callback``."""
    top_k, einsum = jax.lax.top_k, jnp.einsum

    def keep(name, v):
        jax.debug.callback(lambda v: rec.__setitem__(name, np.asarray(v)),
                           v, ordered=True)

    def tk(x, k):
        out = top_k(x, k)
        keep("idx", out[1])
        return out

    def es(spec, *ops, **kw):
        if spec == "gtk,gtke,gtkc->gtec":
            keep("keep", ops[1])
            keep("pos", jnp.argmax(ops[2], axis=-1))
        return einsum(spec, *ops, **kw)
    jax.lax.top_k, jnp.einsum = tk, es
    try:
        yield
    finally:
        jax.lax.top_k, jnp.einsum = top_k, einsum


def _both(a: np.ndarray, dtype: str):
    """A numpy array as a reference array of ``dtype`` and the port's
    tensor holding the same values."""
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _weights(cfg, rng, router=None):
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    w = {"router": (rng.standard_normal((d, e)) / 8 if router is None
                    else router),
         "w1": rng.standard_normal((e, d, ff)) / 8,
         "w3": rng.standard_normal((e, d, ff)) / 8,
         "w2": rng.standard_normal((e, ff, d)) / 6}
    return {k: v.astype(np.float32) for k, v in w.items()}


def _hold_y(got: torch.Tensor, want, dtype: str, label: str,
            terms: np.ndarray | float = 0.0) -> None:
    """f32 at ``Y_F32_TOL``; bf16 within 2^-7 (|y| + ``terms``), one ulp
    of y and one of the magnitudes it sums."""
    a = got.float().numpy()
    b = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert a.shape == b.shape and np.isfinite(a).all()
    if dtype == "float32":
        np.testing.assert_allclose(a, b, **Y_F32_TOL)
        return
    bound = 2.0 ** -7 * (np.abs(b) + terms)
    assert (np.abs(a - b) <= bound).all(), (label, np.abs(a - b).max())
    print(f"{label}: {(a != b).mean():.4%} of the bf16 elements differ, "
          f"the largest by {np.abs(a - b).max()}")


def _run(name, dtype, x, router=None, valid=None, seed=0, **over):
    """Both packages' moe_ffn on the same inputs -> (port cfg, routing,
    y, aux; reference y, aux, routing; the port's sum_j w_j |ye_j|)."""
    jcfg, cfg = _cfgs(name, dtype, **over)
    w = _weights(cfg, np.random.default_rng(seed), router)
    jp, tp = {}, {}
    for k, v in w.items():
        jp[k], tp[k] = _both(v, "float32" if k == "router" else dtype)
    jx, tx = _both(x, dtype)
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid.copy())
    rec = {}
    with _recording(rec):
        jy, jaux = jax.jit(lambda p, x, v: jmoe.moe_ffn(jcfg, p, x, v))(
            jp, jx, jv)
    ty, taux = moe.moe_ffn(cfg, tp, tx, tv)
    b, s, d = x.shape
    tg = min(moe.group_len(cfg), s)
    xg = tx.reshape(b * s // tg, tg, d)
    vg = None if tv is None else tv.reshape(xg.shape[:2])
    r = moe.route(cfg, tp["router"], xg, vg)
    terms = moe.combine(cfg, r, moe.experts(cfg, tp, xg, r).abs(),
                        cfg.dtype).reshape(b, s, d).numpy()
    return cfg, r, ty, taux, jy, jaux, rec, terms


def _hold_routing(r, rec) -> None:
    np.testing.assert_array_equal(r.idx.numpy(), rec["idx"])
    np.testing.assert_array_equal(r.keep.numpy(), rec["keep"])
    kept = rec["keep"].sum(-1) > 0
    np.testing.assert_array_equal(r.pos.numpy()[kept],
                                  rec["pos"][kept].astype(np.float32))
    np.testing.assert_array_equal(r.pos.numpy()[~kept], 0)


CASES = {
    # moonshot's smoke: E 4, top-2, group 1024 (one group a sequence)
    "moonshot": (MOONSHOT, (2, 24), {}),
    # E 16, top-6: group_len 512, so a 1,024-token batch is two groups
    "e16-top6": (MOONSHOT, (1, 1024), dict(n_experts=16, top_k=6)),
    # llama4's smoke: top-1
    "llama4": (LLAMA4, (2, 24), {}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_reference(case, dtype):
    name, (b, s), over = CASES[case]
    x = np.random.default_rng(1).standard_normal(
        (b, s, 64)).astype(np.float32)
    cfg, r, ty, taux, jy, jaux, rec, terms = _run(name, dtype, x, **over)
    assert (moe.group_len(cfg), r.idx.shape[:2]) == (
        (512, (2, 512)) if case == "e16-top6" else (1024, (b, s)))
    _hold_routing(r, rec)
    _hold_y(ty, jy, dtype, f"{case} {dtype}", terms)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [MOONSHOT, LLAMA4])
def test_valid_masks_a_ragged_tail(name, dtype):
    """A chunk's padding (the last 5 of 16 tokens): no place, no weight,
    out of the aux loss; the real tokens route as the reference's."""
    x = np.random.default_rng(2).standard_normal((1, 16, 64)).astype(
        np.float32)
    valid = np.arange(16)[None] < 11
    _, r, ty, taux, jy, jaux, rec, terms = _run(
        name, dtype, x, valid=valid, capacity_factor=0.5)
    _hold_routing(r, rec)
    assert not r.keep[0, 11:].any() and (ty[0, 11:] == 0).all()
    _hold_y(ty, jy, dtype, f"{name} ragged {dtype}", terms)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forced_drop_keeps_capacity(dtype):
    """The reference's drop case: capacity factor 0.25, top-1, a router
    that sends every token whose features sum above zero to expert 0 (the
    rest tie at zero and go to expert 1, the lower index).  Expert 0
    keeps exactly ``capacity`` tokens, in token order; the others' output
    is exactly zero."""
    d, e = 64, 4
    router = np.zeros((d, e), np.float32)
    router[:, 0] = 100.0
    x = np.random.default_rng(4).standard_normal((1, 32, d)).astype(
        np.float32) + 1.0
    cfg, r, ty, _, jy, _, rec, terms = _run(
        LLAMA4, dtype, x, router=router, capacity_factor=0.25, top_k=1)
    _hold_routing(r, rec)
    to0 = (r.idx[0, :, 0] == 0).numpy()
    assert to0.sum() > moe.capacity(cfg, 32) == 2
    kept0 = r.keep[0, :, 0, 0].numpy() > 0
    assert kept0.sum() == moe.capacity(cfg, 32)
    assert np.array_equal(np.flatnonzero(kept0), np.flatnonzero(to0)[:2])
    dropped = (r.keep.sum((-1, -2)) == 0)[0].numpy()
    assert (ty[0, dropped] == 0).all()
    _hold_y(ty, jy, dtype, f"forced drop {dtype}", terms)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["moonshot", "e16-top6"])
def test_zero_router_ties_pick_the_lower_index(case, dtype):
    """A zero router: every probability ties at 1/E, so every token picks
    experts 0 .. k-1 (``jax.lax.top_k``'s order), and the queues fill
    choice-major."""
    name, (b, s), over = CASES[case]
    e = over.get("n_experts", 4)
    x = np.random.default_rng(5).standard_normal((b, s, 64)).astype(
        np.float32)
    cfg, r, ty, taux, jy, jaux, rec, terms = _run(
        name, dtype, x, router=np.zeros((64, e), np.float32), **over)
    _hold_routing(r, rec)
    assert (r.idx == torch.arange(cfg.top_k)).all()
    _hold_y(ty, jy, dtype, f"zero router {case} {dtype}", terms)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)


@pytest.mark.parametrize("d", [1, 6, 31, 32, 33, 64, 2048, 2560, 5120])
def test_padded_row_sum(d):
    """``layers.row_sum``'s card form (fault F4: fewer than ``SUM_ROWS``
    rows summed in a ``SUM_ROWS``-row buffer), run on the CPU: torch's sum
    bit for bit, at 1 to 15 rows, whatever the buffer's unset rows hold;
    with ``square``, RMSNorm's sum of squares."""
    from repro_torch.models import layers
    x = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (5, 3, d)).astype(np.float32))
    got = layers._padded_sum(x)
    assert got.shape == (5, 3, 1)
    assert torch.equal(got, x.sum(-1, keepdim=True))
    assert torch.equal(layers._padded_sum(x[:1, :1]), got[:1, :1])
    assert torch.equal(layers.row_sum(x), x.sum(-1, keepdim=True))
    sq = (x * x).sum(-1, keepdim=True)
    assert torch.equal(layers._padded_sum(x, square=True), sq)
    assert torch.equal(layers.row_sum(x, square=True), sq)


def test_group_must_divide_the_tokens():
    """B * S not a whole number of groups raises, as the reference
    asserts: 600 tokens against moonshot's 512-token groups."""
    cfg = configs.get(MOONSHOT)
    p = {"router": torch.zeros(8, cfg.n_experts)}
    with pytest.raises(ValueError, match="dispatch groups"):
        moe.moe_ffn(dataclasses.replace(cfg, d_model=8), p,
                    torch.zeros(1, 600, 8))
    assert moe.capacity(cfg, 32) == 3 and moe.capacity(cfg, 1) == 1
    assert moe.capacity(cfg, 512) == int(512 * 6 / 64 * 1.25)


@pytest.mark.parametrize("user", [True, False])
def test_expert_products_sum_in_f32(user, monkeypatch):
    """On the card each expert product runs with PyTorch's bf16
    reduced-precision reduction off (the reference sums in f32), and the
    caller's setting is back once ``experts`` returns, also where it
    raises.  The card's branch is taken here on host tensors (``moe``'s
    ``cuda.on_card`` answers True); the CPU's products are
    ``cpu_math.bmm``'s, held by the reference tests of this file."""
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        user)
    seen, bmm = [], torch.bmm

    def recording(*a, **k):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return bmm(*a, **k)
    monkeypatch.setattr(torch, "bmm", recording)
    cfg = configs.get(MOONSHOT).smoke(dtype=torch.bfloat16)
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                    else torch.bfloat16)
          for k, v in _weights(cfg, np.random.default_rng(3)).items()}
    xg = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    r = moe.route(cfg, tp["router"], xg)
    monkeypatch.setattr(moe, "cuda",
                        types.SimpleNamespace(on_card=lambda t: True))
    ye = moe.experts(cfg, tp, xg, r)
    assert seen == [False] * 3 and ye.dtype == torch.bfloat16
    assert matmul.allow_bf16_reduced_precision_reduction is user
    tp["w2"] = tp["w2"][:, :1]
    with pytest.raises(RuntimeError):
        moe.experts(cfg, tp, xg, r)
    assert matmul.allow_bf16_reduced_precision_reduction is user


# -- the block ----------------------------------------------------------------

def _block_setup(name, dtype, seed):
    jcfg, cfg = _cfgs(name, dtype)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.from_jax(cfg, jax.tree.map(np.asarray, jp))
    return (jcfg, {k: v[0] for k, v in jp["seg0_moe"].items()},
            cfg, {k: v[0] for k, v in tp["seg0_moe"].items()})


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [MOONSHOT, LLAMA4])
def test_block_fwd_and_dense_decode(name, dtype):
    """``MoeBlock.fwd`` over 9 tokens (and the KV state it returns) and
    three dense decode steps from it, against the jitted reference block:
    f32 at 1e-4; bf16 within one ulp of the reference's output (bitwise
    but for the expert products' summation order)."""
    jcfg, jpl, cfg, tpl = _block_setup(name, dtype, 3)
    jb, tb = jblocks.KINDS["moe"], blocks.registry.get("moe")
    assert tb is blocks.MoeBlock
    rng = np.random.default_rng(1)
    opts = jblocks.FwdOpts(want_state=True, s_max=40)
    jfwd = jax.jit(lambda p, x: jb.fwd(jcfg, p, x, None, opts))
    jdec = jax.jit(lambda p, x, s, pos: jb.decode(jcfg, p, x, s, pos, None))

    def hold(got, want, label):
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                       atol=1e-4)
        else:
            _hold_y(got, want, dtype, label)
    jx, tx = _both(rng.standard_normal((2, 9, 64)), dtype)
    jy, _, js = jfwd(jpl, jx)
    ty, ts = tb.fwd(cfg, tpl, tx, blocks.FwdOpts(want_state=True, s_max=40))
    hold(ty, jy, f"{name} fwd")
    for step in range(3):
        jx, tx = _both(rng.standard_normal((2, 1, 64)), dtype)
        jy, js = jdec(jpl, jx, js, jnp.int32(9 + step))
        ty = tb.decode(cfg, tpl, tx, ts,
                       torch.tensor(9 + step, dtype=torch.int32), None)
        hold(ty, jy, f"{name} decode {step}")
    np.testing.assert_allclose(_np(ts.k), _np(js.k), rtol=1e-4, atol=1e-4)


CHUNK_CASES = [(MOONSHOT + "+xnor", {}, True),
               (MOONSHOT, dict(capacity_factor=0.5), False),
               (LLAMA4, {}, False),
               (LLAMA4 + "+xnor", dict(capacity_factor=0.5), True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,over,packed", CHUNK_CASES)
def test_chunk_and_decode_logits(name, over, packed, dtype, monkeypatch):
    """The model's chunked prefill (two chunks of 8, the second ragged)
    and two paged decode steps beside a dead slot, through both packages
    (``test_torch_layers._chunk_and_decode``): f32 logits at 1e-4, bf16
    within ``BF16_LOGIT_BOUND``.  At capacity factor 0.5 an expert keeps
    2 places of a chunk's 16 choices (top-2) or 8 (top-1): the port's
    chunks must drop choices there, which the logits then hold."""
    drops = []
    route = moe.route

    def counted(*a, **k):
        r = route(*a, **k)
        if r.idx.shape[1] > 1:
            drops.append(int(r.mask.sum() - r.keep.sum()))
        return r
    monkeypatch.setattr(moe, "route", counted)
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else dict(rtol=0, atol=BF16_LOGIT_BOUND))
    n = 0
    for got, want in _chunk_and_decode(name, over, packed, dtype):
        np.testing.assert_allclose(got, want, **tol)
        n += 1
    assert n == 4 and len(drops) == 4          # 2 chunks x 2 layers
    assert sum(drops) > 0 or "capacity_factor" not in over, drops


def test_moe_tree_and_packing():
    """The MoE leaves: router f32 (n, d, E), experts (n, E, d, ff) and
    (n, E, ff, d) in cfg.dtype, none packed under +xnor (only the four
    attention projections become sign planes)."""
    cfg = configs.get(MOONSHOT + "+xnor").smoke()
    defs = lm.param_defs(cfg)["seg0_moe"]
    n, d, e, ff = 2, 64, 4, 32
    assert defs["moe_router"].shape == (n, d, e)
    assert defs["moe_router"].dtype == torch.float32
    assert defs["moe_w1"].shape == defs["moe_w3"].shape == (n, e, d, ff)
    assert defs["moe_w2"].shape == (n, e, ff, d)
    assert not any(v.binarize for k, v in defs.items() if k.startswith("moe_"))
    packed = lm.pack_params(cfg, lm.init_params(cfg, 0, device="cpu"))
    seg = packed["seg0_moe"]
    assert {k for k, v in seg.items() if not isinstance(v, torch.Tensor)} \
        == {"attn_wq", "attn_wk", "attn_wv", "attn_wo"}
    assert lm.prefix_cache_eligible(cfg) and lm.prefix_table_class(cfg) == \
        "full"


def test_full_size_active_experts():
    """moonshot at full size: 64 experts, top-6, capacity 1 a decode slot
    and 3 in a 32-token chunk; a 600-token dense prefill is refused."""
    cfg = configs.get(MOONSHOT)
    assert (moe.group_len(cfg), moe.capacity(cfg, 1),
            moe.capacity(cfg, 32)) == (512, 1, 3)
    jcfg = jconfigs.get(MOONSHOT)
    assert moe.capacity(cfg, 512) == jmoe.capacity(jcfg, 512)
    assert moe.group_len(cfg) == jmoe.group_len(jcfg)
    llama = configs.get(LLAMA4)
    assert moe.group_len(llama) == jmoe.group_len(jconfigs.get(LLAMA4))


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_moe.py   # bf16 differing rates
    for case in sorted(CASES):
        test_moe_ffn_matches_reference(case, "bfloat16")
    test_forced_drop_keeps_capacity("bfloat16")
