"""The port's model path against the JAX reference at smoke size.

The reference's parameters (``repro.models.lm.init_params``) are carried
into the port with ``repro_torch.convert.from_jax``; both packages then
run one chunked-prefill piece and one paged decode step over the same
block tables, and the logits are compared.  CPU: both packages run the
unfused chain (their ``fused_decode="auto"`` picks the kernels only on a
TPU or a card); the ``_fused`` cases run the port's fused route as the
card does.  f32 logits agree to 1e-4 (reduction order differs, signs do
not).  In bf16 the port rounds where the reference's jitted program
rounds (the SwiGLU gate step by step, ln2 on the f32 residual sum): the
FFN is bitwise, and the logits are held within ``BF16_LOGIT_BOUND``,
measured by ``python tests/test_torch_layers.py``.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.models import layers as jlayers
from repro.models import lm as jlm
import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.kernels import ops, paged_attn
from repro_torch.models import attention, blocks, layers, lm
from repro_torch.serve import ServeEngine

CASES = [("qwen2-7b+xnor", {}, True),          # the slice: packed residency
         ("qwen2-7b+xnor", {}, False),         # float binary (STE forward)
         ("qwen3-4b", {}, False),              # full precision, qk_norm
         ("qwen3-4b", {"kv_cache_dtype": "i8"}, False)]


def _cfgs(name, over):
    jcfg = jconfigs.get(name).smoke(dtype=jnp.float32, **over)
    cfg = configs.get(name).smoke(dtype=torch.float32, **over)
    return jcfg, cfg


def _params(jcfg, cfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.from_jax(cfg, jax.tree.map(np.asarray, jp))


def test_configs_match_reference():
    for name in ("qwen2-7b+xnor", "qwen3-4b"):
        for full in (True, False):
            j = jconfigs.get(name)
            t = configs.get(name)
            if not full:
                j, t = j.smoke(), t.smoke()
            for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                      "d_ff", "vocab", "d_head", "qkv_bias", "qk_norm",
                      "rope_theta", "quant", "block_size", "prefill_chunk",
                      "padded_vocab", "q_per_kv"):
                assert getattr(t, f) == getattr(j, f), (name, f)
            assert t.segments() == j.segments()
    full = configs.get("qwen2-7b+xnor")
    assert full.dtype == torch.bfloat16 and full.d_head == 128
    assert full.q_per_kv == 7


def test_from_jax_rejects_mismatched_tree():
    jcfg, cfg = _cfgs("qwen2-7b+xnor", {})
    jp, _ = _params(jcfg, cfg)
    tree = jax.tree.map(np.asarray, jp)
    del tree["embed"]["lm_head"]
    with pytest.raises(ValueError):
        convert.from_jax(cfg, tree)


def _chunk_and_decode(name, over, packed, dtype, seed=1):
    """One slot's two prefill chunks (the second ragged) and two decode
    steps beside a dead slot, through both packages on the same converted
    weights and block tables.  Yields ``(port logits, reference logits)``
    per step and checks the positions and slot 0's cached keys at the end
    (at the f32 tolerance; bf16 keys are held through the logits).  The
    reference runs jitted in bf16, as its serve engine runs it: XLA's
    excess precision (a bf16 sum read by an f32 cast keeps its f32 value)
    is part of what the port matches."""
    jcfg = jconfigs.get(name).smoke(dtype=jnp.dtype(str(dtype)[6:]), **over)
    cfg = configs.get(name).smoke(dtype=dtype, **over)
    jp, tp = _params(jcfg, cfg, seed=seed)
    if packed:
        jp, tp = jlm.pack_params(jcfg, jp), lm.pack_params(cfg, tp)
    jchunk, jdecode = jlm.prefill_chunk_step, jlm.paged_decode_step
    if dtype == torch.bfloat16:
        jchunk = jax.jit(functools.partial(jchunk, jcfg))
        jdecode = jax.jit(functools.partial(jdecode, jcfg))
    else:
        jchunk = functools.partial(jchunk, jcfg)
        jdecode = functools.partial(jdecode, jcfg)
    slots, s_max, bs, c = 2, 32, jcfg.block_size, jcfg.prefill_chunk
    widths = jlm.paged_table_widths(jcfg, s_max, bs, c)
    assert widths == lm.paged_table_widths(cfg, s_max, bs, c)
    n_blocks = 1 + slots * widths["full"]
    jstate = jlm.paged_decode_state_spec(jcfg, slots, s_max,
                                         n_blocks=n_blocks, block_size=bs,
                                         abstract=False)
    tstate = lm.paged_decode_state_spec(cfg, slots, n_blocks=n_blocks,
                                        block_size=bs, device="cpu")
    # slot 0 owns blocks 1..W, slot 1 the next W, in permuted order
    rng = np.random.default_rng(0)
    ids = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    table = ids.reshape(slots, widths["full"])
    prompt = rng.integers(0, jcfg.vocab, size=(2 * c,)).astype(np.int32)
    n_last = c - 3                                   # a ragged second chunk
    for j, n_valid in enumerate((c, n_last)):
        toks = np.zeros((1, c), np.int32)
        toks[0, :n_valid] = prompt[j * c:j * c + n_valid]
        jl, jstate = jchunk(
            jp, jnp.asarray(toks), jstate, jnp.int32(0),
            jnp.int32(n_valid), {"full": jnp.asarray(table[:1])},
            fresh=jnp.asarray(j == 0), start=jnp.int32(0))
        tl, tstate = lm.prefill_chunk_step(
            cfg, tp, torch.from_numpy(toks), tstate, 0, n_valid,
            {"full": torch.from_numpy(table[:1].copy())}, fresh=j == 0)
        yield tl.float().numpy(), np.asarray(jl.astype(jnp.float32))
    assert np.array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
    # decode: slot 0 continues, slot 1 is dead (zeroed table row, inactive)
    dtable = table.copy()
    dtable[1] = 0
    token = np.array([[5], [0]], np.int32)
    active = np.array([True, False])
    for _ in range(2):
        jl, jstate = jdecode(
            jp, jnp.asarray(token), jstate,
            {"full": jnp.asarray(dtable)}, active=jnp.asarray(active))
        tl, tstate = lm.paged_decode_step(
            cfg, tp, torch.from_numpy(token), tstate,
            {"full": torch.from_numpy(dtable)},
            active=torch.from_numpy(active))
        jl = np.asarray(jl.astype(jnp.float32))
        yield tl[0].float().numpy(), jl[0]
        token[0, 0] = int(np.argmax(jl[0, -1, :jcfg.vocab]))
    assert np.array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
    if dtype == torch.float32:
        jk = np.asarray(jstate.seg_states[0].k)
        tk = tstate.seg_states[0].k.float().numpy()
        live = np.unique(table[0])                   # slot 0's blocks
        np.testing.assert_allclose(tk[:, live],
                                   jk[:, live].astype(np.float32),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,over,packed", CASES)
def test_prefill_chunk_and_decode_logits(name, over, packed):
    for got, want in _chunk_and_decode(name, over, packed, torch.float32):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The port's fused route on the CPU: ``fused_mode("auto")`` resolves
    as on the card, so the packed linears take ``ops.xnor_linear_fused``
    and decode attention ``paged_attn.paged_decode_attention``, each
    running its plain version on CPU tensors.  -> calls per route."""
    calls = {"xnor_linear_fused": 0, "paged_decode_attention": 0}
    resolve = ops.fused_mode
    monkeypatch.setattr(ops, "fused_mode",
                        lambda mode="auto", device="cuda":
                        resolve(mode, "cuda"))
    for mod, name in ((ops, "xnor_linear_fused"),
                      (paged_attn, "paged_decode_attention")):
        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("name,over,packed", CASES)
def test_prefill_chunk_and_decode_logits_fused(name, over, packed,
                                               fused_on_cpu):
    """f32, through the fused route the card takes (the fused linear and
    the paged decode op, here their plain versions) against the
    reference's unfused chain: the same 1e-4."""
    for got, want in _chunk_and_decode(name, over, packed, torch.float32):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    n = configs.get(name).smoke().n_layers
    assert fused_on_cpu["paged_decode_attention"] == 2 * n
    assert fused_on_cpu["xnor_linear_fused"] == (4 * 7 * n if packed else 0)


# bf16 logits: |port - reference| <= 2^-6, one bf16 ulp of a logit in
# [2, 4) (the smoke logits stay under 3.5).  Readings over parameter seeds
# 0-11 of every case (``python tests/test_torch_layers.py``), in units of
# 2^-6: the port reads 0 on 43 of 48 runs, 0.25 on three, 1.0 on two (seeds
# 0 and 6 of qwen3-4b; last-bit f32 differences that remain, rounded
# through bf16: reduction order, XLA's and torch's rsqrt and exp).  With
# one of its bf16 matches undone (``_undone``: gate, ln2, cpu) the
# qwen3-4b cases read 1.0-2.75 and exceed the bound on 67 of 72 runs,
# every fault at seed 0 or 1 (the seeds below); the binarized qwen2-7b+xnor
# logits stay within it but for one run (35.9, cpu at seed 6), so its
# faults are held by the bitwise gate and FFN tests and the serve traces.
# No bound separates every fault run: the sound maximum is one ulp, and
# the five qwen3-4b fault runs within it read exactly that.
BF16_LOGIT_BOUND = 2.0 ** -6


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,over,packed", CASES)
def test_prefill_chunk_and_decode_logits_bf16(name, over, packed, seed):
    for got, want in _chunk_and_decode(name, over, packed, torch.bfloat16,
                                       seed=seed):
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_BOUND)


def _bf16_gate_inputs(n=20000, seed=0):
    """Seeded bf16 (g, u): Gaussian at three scales; g past the points
    where the sigmoid's exp overflows or its reciprocal turns subnormal
    (|g| near 87-89, 100, 1e30, inf); tiny g and u whose products are
    subnormal; zeros of both signs."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n) * rng.choice([1.0, 4.0, 30.0], n)
    u = rng.standard_normal(n) * rng.choice([1.0, 4.0, 30.0], n)
    edge = np.array([-1e30, -100, -89, -88.75, -88.5, -88.25, -88, -87.5,
                     -87.25, -87, -86, 86, 87, 87.5, 88, 88.5, 89, 100, 1e30,
                     np.inf, -np.inf, 0.0, -0.0, 2e-38, -2e-38, 1.5e-38,
                     -1.2e-38, 1e-39, -1e-39, 9e-41, 3.0, -3.0])
    tiny = rng.uniform(-3e-38, 3e-38, 256)
    g = np.concatenate([g, edge, tiny, rng.standard_normal(256)])
    u = np.concatenate([u, rng.standard_normal(edge.size) * 2,
                        rng.standard_normal(256), tiny])
    return g.astype(np.float32), u.astype(np.float32)


@contextlib.contextmanager
def _flushing_subnormals():
    """Torch's CPU arithmetic with subnormal inputs and results flushed to
    zero, as XLA's CPU backend runs it: ``torch.set_flush_denormal`` on
    this thread, and one intra-op thread, since the mode is per thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


def test_silu_mul_bitwise_bf16():
    """The SwiGLU gate silu(g) * u against ``jax.nn.silu(g) * u`` (jitted,
    bf16), with subnormals flushed as XLA's CPU flushes them: equal in
    value and sign, on Gaussian inputs, on the edges and on every bf16 g.
    Without the flush the two differ only where a subnormal arises."""
    g, u = _bf16_gate_inputs()
    gate = jax.jit(lambda g, u: jax.nn.silu(g) * u)
    want = np.asarray(gate(jnp.asarray(g, jnp.bfloat16),
                           jnp.asarray(u, jnp.bfloat16)).astype(jnp.float32))
    tg, tu = torch.from_numpy(g).bfloat16(), torch.from_numpy(u).bfloat16()
    with _flushing_subnormals():
        got = layers.silu_mul(tg, tu).float().numpy()
    assert np.array_equal(got, want, equal_nan=True)
    assert np.array_equal(np.signbit(got), np.signbit(want))
    # the cases the edges were chosen for did occur
    s = 1 / (1 + torch.exp(-tg))
    assert ((s > 0) & (s < torch.finfo(torch.bfloat16).tiny)).any()
    assert ((want == 0) & (g != 0) & (u != 0)).sum() > 10
    # outside the flush, departures lie only where a subnormal arises: in
    # an input, in the sigmoid, in silu(g) or in the product (an f32
    # product just under the least normal rounds up to it in bf16)
    keep = layers.silu_mul(tg, tu).float().numpy()
    steps = [keep, g, u, s.float().numpy(), (tg * s).float().numpy()]
    tiny = torch.finfo(torch.bfloat16).tiny
    sub = np.any([np.abs(v) <= tiny for v in steps], axis=0)
    off = ~((keep == want) | (np.isnan(keep) & np.isnan(want)))
    assert off.any() and not (off & ~sub).any()
    # torch.sigmoid, which rounds once from f32, is not the reference
    old = (tg * torch.sigmoid(tg)).float().numpy()
    silu = np.asarray(jax.jit(jax.nn.silu)(
        jnp.asarray(g, jnp.bfloat16)).astype(jnp.float32))
    assert (old != silu).mean() > 0.1
    # every bf16 g, against a few u (subnormal and huge ones among them)
    g = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    for uv in (1.0, -1.5, 1e-38, 2e-38, 1e30):
        want = gate(jnp.asarray(g, jnp.bfloat16),
                    jnp.full(g.shape, uv, jnp.bfloat16))
        with _flushing_subnormals():
            got = layers.silu_mul(torch.from_numpy(g).bfloat16(),
                                  torch.full(g.shape, uv,
                                             dtype=torch.bfloat16))
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)),
                              equal_nan=True), uv


@pytest.mark.parametrize("packed", [True, False])
def test_ffn_bitwise_bf16(packed):
    """The bf16 FFN of qwen2-7b+xnor (integer linears: packed, or the
    float binary path) against ``repro.models.layers.ffn`` jitted: bitwise."""
    jcfg = jconfigs.get("qwen2-7b+xnor").smoke(dtype=jnp.bfloat16)
    cfg = configs.get("qwen2-7b+xnor").smoke(dtype=torch.bfloat16)
    jp, tp = _params(jcfg, cfg, seed=3)
    if packed:
        jp, tp = jlm.pack_params(jcfg, jp), lm.pack_params(cfg, tp)
    for layer in range(jcfg.n_layers):
        jf = {k[4:]: jax.tree.map(lambda a: a[layer], v)
              for k, v in jp["seg0_attn"].items() if k.startswith("ffn_")}
        tf = {k[4:]: v for k, v in
              blocks.layer_params(tp["seg0_attn"], layer).items()
              if k.startswith("ffn_")}
        x = np.random.default_rng(layer).standard_normal(
            (3, 8, jcfg.d_model)).astype(np.float32) * 2
        want = jax.jit(lambda p, x: jlayers.ffn(jcfg, p, x))(
            jf, jnp.asarray(x, jnp.bfloat16))
        got = layers.ffn(cfg, tf, torch.from_numpy(x).bfloat16())
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))


def test_entry_points_need_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = configs.get("qwen2-7b+xnor").smoke(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, 0)
    params = lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, slots=1, s_max=16)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen2-7b+xnor", "--smoke"])
    assert serve.main(["--arch", "qwen2-7b+xnor", "--smoke", "--device",
                       "cpu", "--requests", "2", "--new-tokens", "3",
                       "--prompt-len", "8"]) == 0


@pytest.mark.parametrize("name", ["qwen2-7b+xnor", "qwen2-7b"])
def test_unfused_decode_matches_reference(name):
    """fused_decode="off": the decode step's attention runs the gather /
    mask / softmax chain (on any device — the reference's XLA code has no
    kernel); one prefill chunk and one decode step match the reference's
    logits at this suite's tolerance."""
    jcfg, cfg = _cfgs(name, {"fused_decode": "off"})
    jp, tp = _params(jcfg, cfg, seed=2)
    if cfg.quant == "xnor":
        jp, tp = jlm.pack_params(jcfg, jp), lm.pack_params(cfg, tp)
    bs, c = cfg.block_size, cfg.prefill_chunk
    w = lm.paged_table_widths(cfg, 32, bs, c)["full"]
    jstate = jlm.paged_decode_state_spec(jcfg, 1, 32, n_blocks=1 + w,
                                         block_size=bs, abstract=False)
    tstate = lm.paged_decode_state_spec(cfg, 1, n_blocks=1 + w,
                                        block_size=bs, device="cpu")
    table = np.arange(1, 1 + w, dtype=np.int32)[None]
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(1, c)).astype(np.int32)
    jl, jstate = jlm.prefill_chunk_step(
        jcfg, jp, jnp.asarray(toks), jstate, jnp.int32(0), jnp.int32(c),
        {"full": jnp.asarray(table)}, fresh=jnp.asarray(True),
        start=jnp.int32(0))
    tl, tstate = lm.prefill_chunk_step(
        cfg, tp, torch.from_numpy(toks), tstate, 0, c,
        {"full": torch.from_numpy(table.copy())}, fresh=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    token = np.array([[int(np.argmax(np.asarray(jl)[0, -1, :cfg.vocab]))]],
                     np.int32)
    jl, _ = jlm.paged_decode_step(jcfg, jp, jnp.asarray(token), jstate,
                                  {"full": jnp.asarray(table)})
    tl, _ = lm.paged_decode_step(cfg, tp, torch.from_numpy(token), tstate,
                                 {"full": torch.from_numpy(table.copy())})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


@contextlib.contextmanager
def _undone(what: str | None):
    """The port with one of its bf16 matches to the reference undone:
    ``"gate"`` computes the SwiGLU gate as g * torch.sigmoid(g) * u,
    ``"ln2"`` feeds the second RMSNorm the bf16-rounded residual sum,
    ``"cpu"`` takes the fused ops on the CPU (``fused_mode("auto")`` as on
    the card: decode attention without the bf16 rounding of P)."""
    def attn_ffn(cls, cfg, p, x, state, table, pos, valid):
        h = layers.rms_norm(x, p["ln1"])
        x = x + attention.paged_attention(cfg, blocks._sub(p, "attn_"), h,
                                          state, table, pos, valid=valid)
        h = layers.rms_norm(x, p["ln2"])
        return x + layers.ffn(cfg, blocks._sub(p, "ffn_"), h)

    if what is None:
        yield
        return
    resolve = ops.fused_mode
    owner, attr, new = {
        "gate": (layers, "silu_mul", lambda g, u: g * torch.sigmoid(g) * u),
        "ln2": (blocks.AttnBlock, "_attn_ffn", classmethod(attn_ffn)),
        "cpu": (ops, "fused_mode", lambda mode="auto", device="cuda":
                resolve(mode, "cuda"))}[what]
    old = owner.__dict__[attr]
    setattr(owner, attr, new)
    try:
        yield
    finally:
        setattr(owner, attr, old)


def _readings(faults=(None, "gate", "ln2", "cpu"), ops_too=True):
    """The measurements behind ``BF16_LOGIT_BOUND`` and behind the last-bit
    differences recorded as reference behaviour: the bf16 logits over
    parameter seeds 0-11 of every case, as the port stands and with each
    of its bf16 matches undone (the faults the bound must catch), then how
    often single ops differ between XLA (jitted, CPU) and torch on the
    same Gaussian inputs."""
    for fault in faults:
        for name, over, packed in CASES:
            worst, share = [], []
            with _undone(fault):
                for seed in range(12):
                    d = np.concatenate([np.abs(got - want).ravel() for
                                        got, want in _chunk_and_decode(
                                            name, over, packed,
                                            torch.bfloat16, seed=seed)])
                    worst.append(float(d.max()) * 64)
                    share.append(float((d > 0).mean()))
            print(f"bf16 logits, {fault or 'no'} match undone, {name} {over} "
                  f"packed={packed}, per seed 0-11: max |port - reference| "
                  f"in units of 2^-6 {worst}; share of logits that differ "
                  f"{share}", flush=True)
    if not ops_too:
        return
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1_000_000).astype(np.float32)
    ops = {
        "f32 exp (x ~ N(0, 3))": (lambda a: jnp.exp(a), torch.exp, 3 * x),
        "f32 rsqrt (|x| + 1e-6)": (jax.lax.rsqrt, torch.rsqrt,
                                   np.abs(x) + 1e-6),
    }
    for label, (jf, tf, a) in ops.items():
        want = np.asarray(jax.jit(jf)(jnp.asarray(a)))
        got = tf(torch.from_numpy(a)).numpy()
        print(f"{label}: {(got != want).mean() * 100:.2f} % of 1e6 differ")
    from repro.models import layers as jl
    xb = x.reshape(-1, 64)
    jx = jnp.asarray(xb, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda a: jl.rms_norm(a, jnp.ones(64)))(jx)
                      .astype(jnp.float32))
    got = layers.rms_norm(torch.from_numpy(xb).bfloat16(),
                          torch.ones(64)).float().numpy()
    print(f"bf16 rms_norm (d 64): {(got != want).mean() * 100:.3f} % of "
          f"outputs differ")
    w = rng.standard_normal((64, 128)).astype(np.float32) * 0.1
    want = np.asarray(jax.jit(lambda a, b: jnp.einsum("mk,kn->mn", a, b))(
        jx, jnp.asarray(w, jnp.bfloat16)).astype(jnp.float32))
    got = torch.matmul(torch.from_numpy(xb).bfloat16(),
                       torch.from_numpy(w).bfloat16()).float().numpy()
    print(f"bf16 matmul (K 64, N 128): {(got != want).mean() * 100:.3f} % "
          f"of outputs differ")


if __name__ == "__main__":
    # python tests/test_torch_layers.py [gate|ln2|cpu ...]: those faults'
    # logits only; with no argument, every reading
    import sys
    if sys.argv[1:]:
        _readings(sys.argv[1:], ops_too=False)
    else:
        _readings()
