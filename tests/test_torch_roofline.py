"""The roofline of one rank's program traced on the ``meta`` device, against
the JAX package's roofline and serving audit.

Held equal to the reference: ``SHAPES`` and ``shape_applicable`` (11 archs
x 4 shapes); the decode state's placements (22 arch variants x
``kv_shard`` in {heads, seq} x two batch-axis choices); the paged layer
classes; the packed serve tree's shapes and dtypes (uint32 planes are
int32 in the port); ``decode_roofline_bytes``, the ring factors and the
report's strings for the same dicts; the byte floor of a smoke engine's
decode step.  Held on the trace itself: the fused paged decode is one
dispatch and the unfused chain more; a smoke qwen2-7b+xnor decode step
launches 7 fused linears and one paged decode a layer; under
``dry_run(card=False)`` a meta trace dispatches what a CPU run
dispatches, op for op; outside ``dry_run`` a meta tensor raises; on
``meta`` no launch count moves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jconfigs
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.roofline import analysis as janalysis
from repro.roofline import report as jreport
from test_torch_reference import reference_engine as JServeEngine
import repro_torch.configs as configs
from repro_torch.core.xnor_layers import PackedLinear
from repro_torch.kernels import cuda, ref
from repro_torch.kernels import paged_attn as kpaged
from repro_torch.kernels import xnor_gemm as kxnor
from repro_torch.models import lm
from repro_torch.models.params import tree_map
from repro_torch.roofline import analysis, report
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)

ARCHS = sorted(configs.ALL)
VARIANTS = [a + s for a in ARCHS for s in ("", "+xnor")]


# -- shapes, placements, trees ------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_applicability_equal_the_reference(arch):
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in configs.SHAPES.items():
        want = jconfigs.SHAPES[name]
        assert (shape.name, shape.kind, shape.seq_len, shape.global_batch) \
            == (want.name, want.kind, want.seq_len, want.global_batch)
        assert configs.shape_applicable(configs.get(arch), shape) == \
            jconfigs.shape_applicable(jconfigs.get(arch), want)


def _ref_specs(tree) -> list:
    from jax.sharding import PartitionSpec as P
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _port_specs(cfg, spec: lm.DecodeState) -> list:
    """The placements in the state's leaf order: laid over the state's
    own structure, since a placement is a tuple too."""
    from repro_torch.models import blocks
    like = lm.decode_state_spec(cfg, 1, 1, device="meta")
    out = [spec.pos]
    for st, sp in zip(like.seg_states, spec.seg_states):
        blocks.state_map(lambda leaf, s: out.append(s) or leaf, st, sp)
    return out + ([spec.ctx] if spec.ctx is not None else [])


@pytest.mark.parametrize("arch", VARIANTS)
def test_decode_state_pspecs_equal_the_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for kv_shard in ("heads", "seq"):
        for ba in ("data", ("pod", "data")):
            want = _ref_specs(jlm.decode_state_pspecs(jcfg, ba, kv_shard, 16))
            got = _port_specs(cfg, lm.decode_state_pspecs(cfg, ba, kv_shard,
                                                          16))
            assert got == want, (kv_shard, ba)


@pytest.mark.parametrize("arch", VARIANTS)
def test_paged_layer_classes_equal_the_reference(arch):
    assert lm.paged_decode_layer_classes(configs.get(arch)) == \
        jlm.paged_decode_layer_classes(jconfigs.get(arch))


def _same_leaf(got: torch.Tensor, want) -> None:
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)
    name = "int32" if want.dtype == jnp.uint32 else str(want.dtype)
    assert str(got.dtype).removeprefix("torch.") == name


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_abstract_params_equal_the_reference(arch):
    got = lm.packed_abstract_params(configs.get(arch + "+xnor"))
    want = jlm.packed_abstract_params(jconfigs.get(arch + "+xnor"))

    def walk(g, w):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                walk(g[k], w[k])
        elif type(w).__name__ == "PackedLinear":
            assert isinstance(g, PackedLinear) and g.k == w.k
            _same_leaf(g.pb, w.pb)
            _same_leaf(g.beta, w.beta)
        else:
            _same_leaf(g, w)
    walk(got, want)
    assert analysis.tree_bytes(got) == sum(
        int(np.prod(x.shape)) * x.dtype.itemsize
        for x in jax.tree_util.tree_leaves(want))


def test_xnor_dot_float_equals_the_reference():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 70)).astype(np.float32)
    b = rng.standard_normal((9, 70)).astype(np.float32)
    a[0, :3] = 0.0
    got = ref.xnor_dot_float(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.xnor_dot_float(a, b)))


# -- the floor, the factors, the report ---------------------------------------

def test_decode_floor_and_ring_factors_equal_the_reference():
    for n in range(1, 17):
        for kind in janalysis._FACTORS:
            assert analysis._FACTORS[kind](n) == janalysis._FACTORS[kind](n)
    assert set(analysis._FACTORS) == set(janalysis._FACTORS)
    kw = dict(param_bytes=1_234_567, widths={"full": 9, "win": 3},
              layers_per_class={"full": 5, "win": 2}, slots=4,
              block_size=16, n_kv_heads=2, d_head=64, kv_itemsize=2,
              io_bytes=77)
    assert analysis.decode_roofline_bytes(**kw) == \
        janalysis.decode_roofline_bytes(**kw)
    assert analysis.decode_roofline_bytes(**dict(kw, widths={}, io_bytes=0)) \
        == 1_234_567


def _cells() -> dict:
    rng = np.random.default_rng(1)
    cells = {}
    for i, (arch, shape, mesh) in enumerate(
            [("qwen2-7b", "train_4k", "single"),
             ("qwen2-7b", "decode_32k", "multi"),
             ("whisper-tiny", "long_500k", "multi"),
             ("xlstm-350m", "prefill_32k", "single"),
             ("moonshot-v1-16b-a3b", "train_4k", "multi")]):
        r = {"arch": arch, "shape": shape, "mesh": mesh}
        if i == 2:
            r.update(status="skipped", reason="full attention")
        elif i == 4:
            r.update(status="error", error="ValueError('microbatch')")
        else:
            t = rng.random(3)
            r.update(status="ok", n_devices=256 if mesh == "single" else 512,
                     params=float(rng.integers(1e8, 2e10)),
                     t_compile_s=float(rng.random() * 9),
                     t_compute_s=t[0], t_memory_s=t[1], t_collective_s=t[2],
                     bottleneck=["compute", "memory", "collective"][i % 3],
                     useful_flops_frac=float(rng.random()),
                     roofline_frac=float(rng.random()),
                     memory_analysis={"peak_bytes": float(
                         rng.integers(1e9, 9e10))})
        cells[(arch, shape, mesh)] = r
    return cells


def test_report_strings_equal_the_reference():
    cells = _cells()
    for mesh in ("single", "multi"):
        assert report.dryrun_table(cells, mesh) == \
            jreport.dryrun_table(cells, mesh)
        assert report.roofline_table(cells, mesh) == \
            jreport.roofline_table(cells, mesh)
    assert report.summarize(cells) == jreport.summarize(cells)
    assert report.serve_decode_header() == jreport.serve_decode_header()
    for r in cells.values():
        if r["status"] == "ok":
            assert analysis.format_row("x", r) == janalysis.format_row("x", r)
            s = dict(r, hlo_bytes_per_chip=3.5e9, roofline_bytes=1.25e9,
                     dispatches=196)
            assert report.serve_decode_row("x", s) == \
                jreport.serve_decode_row("x", s)
    assert report.serve_decode_row("x", {}) == jreport.serve_decode_row("x", {})


def test_report_reads_the_dryrun_json(tmp_path):
    import json
    cells = _cells()
    for (arch, shape, mesh), r in cells.items():
        (tmp_path / f"{arch}_{shape}_{mesh}.json").write_text(json.dumps(r))
    (tmp_path / "qwen2-7b_train_4k_single_tag.json").write_text(
        json.dumps(cells[("qwen2-7b", "train_4k", "single")]))
    assert report.load(str(tmp_path)) == jreport.load(str(tmp_path))
    assert report.load(str(tmp_path), tag="tag") == jreport.load(
        str(tmp_path), tag="tag")


# -- the trace ----------------------------------------------------------------

def _paged_case():
    b, kv, g, dh, bs, w = 3, 2, 4, 16, 8, 5
    meta = dict(device="meta")
    return (torch.empty((b, kv, g, dh), **meta),
            torch.empty((1 + b * w, kv, bs, dh), **meta),
            torch.empty((1 + b * w, kv, bs, dh), **meta),
            torch.empty((b, w), dtype=torch.int32, **meta),
            torch.empty((b,), dtype=torch.int32, **meta))


def test_fused_paged_decode_is_one_dispatch_and_the_chain_more():
    """The port's form of the reference's ``test_kernel_is_one_dispatch``:
    traced along the card's branches, the wrapper is one dispatch; the
    plain gather / mask / softmax chain is strictly more."""
    args = _paged_case()
    before = kpaged.paged_decode_attention.launches
    nf = analysis.dispatch_count(kpaged.paged_decode_attention, *args,
                                 window=0, scale=0.25, card=True)
    nu = analysis.dispatch_count(ref.paged_decode, *args, window=0,
                                 scale=0.25, card=True)
    assert nf == 1
    assert nu > nf
    assert kpaged.paged_decode_attention.launches == before


def test_the_kernel_record_is_its_cost_and_no_launch_is_counted():
    args = _paged_case()
    b, kv, g, dh = args[0].shape
    _, counter = analysis.trace(kpaged.paged_decode_attention, *args,
                                card=True)
    want = kpaged.cost(b, kv, g, dh, 8, 5, 4, 4)
    assert counter.kernels == {"paged_decode_attention": {
        "launches": 1, "bytes": want.bytes, "ops": want.ops}}
    x = torch.empty((4, 70), dtype=torch.bfloat16, device="meta")
    pb = torch.empty((9, 3), dtype=torch.int32, device="meta")
    beta = torch.empty((9,), device="meta")
    before = kxnor.xnor_linear_fused.launches
    out, counter = analysis.trace(kxnor.xnor_linear_fused, x, pb, beta, 70)
    assert out.shape == (4, 9) and out.dtype == torch.float32
    assert counter.kernels["xnor_linear_fused"]["bytes"] == \
        kxnor.linear_cost(4, 9, 70, 2).bytes
    assert kxnor.xnor_linear_fused.launches == before
    # the CPU's branch runs the plain version on meta: no kernel
    _, counter = analysis.trace(kxnor.xnor_linear_fused, x, pb, beta, 70,
                                card=False)
    assert counter.kernels == {} and counter.dispatches > 1


def test_meta_outside_dry_run_raises():
    x = torch.empty((4, 70), device="meta")
    with pytest.raises(ValueError, match="dry_run"):
        cuda.on_card(x)
    with pytest.raises(ValueError, match="dry_run"):
        kxnor.xnor_linear_fused(x, torch.empty((9, 3), dtype=torch.int32,
                                               device="meta"),
                                torch.empty((9,), device="meta"), 70)
    with cuda.dry_run(card=True):
        assert cuda.on_card(x)
    with cuda.dry_run(card=False):
        assert not cuda.on_card(x)
    assert cuda.on_card(torch.device("cuda")) and not cuda.on_card("cpu")


def _meta(t):
    if isinstance(t, PackedLinear):
        return PackedLinear(_meta(t.pb), _meta(t.beta), t.k)
    return torch.empty_like(t, device="meta")


def test_smoke_decode_step_launches_seven_linears_and_one_paged_a_layer():
    cfg = configs.get("qwen2-7b+xnor").smoke()
    eng = ServeEngine(cfg, lm.init_params(cfg, 0, device="cpu"), slots=4,
                      s_max=32, device="cpu")
    from repro_torch.models import blocks
    state = lm.DecodeState(
        _meta(eng._state.pos),
        [blocks.state_map(_meta, s) for s in eng._state.seg_states], None)
    tables = {c: torch.empty(t.shape, dtype=torch.int32, device="meta")
              for c, t in eng._tables.items()}
    params = lm.packed_abstract_params(cfg)
    tokens = torch.empty((4, 1), dtype=torch.int32, device="meta")
    active = torch.empty((4,), dtype=torch.bool, device="meta")
    with torch.inference_mode():
        _, counter = analysis.trace(lm.paged_decode_step, cfg, params,
                                    tokens, state, tables, active=active)
    launches = {k: v["launches"] for k, v in counter.kernels.items()}
    assert launches == {"xnor_linear_fused": 7 * cfg.n_layers,
                        "paged_decode_attention": cfg.n_layers}


class _Ops(TorchDispatchMode):
    """Records, in order, every aten op the roofline counts as a dispatch
    (views, allocations and metadata ops are not)."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not (func.is_view
                or func._overloadpacket.__name__ in analysis._ALLOC):
            self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _prefill_decode(cfg, params, tokens, ctx):
    logits, state = lm.prefill(cfg, params, tokens, s_max=24, ctx=ctx)
    logits2, _ = lm.decode_step(cfg, params, tokens[:, -1:], state)
    return logits, logits2


@pytest.mark.parametrize("arch", ["qwen2-7b+xnor", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-2b+xnor", "xlstm-350m",
                                  "llama-3.2-vision-11b+xnor"])
def test_meta_trace_of_the_cpu_branch_dispatches_what_the_cpu_runs(arch):
    """A dense prefill and a decode step on CPU tensors, then on ``meta``
    tensors of the same shapes under ``dry_run(card=False)``: the same
    dispatches in the same order, so every device decision (``row_sum``,
    MoE routing, the SSMs' sums, ``fused_mode``) took the CPU's branch."""
    cfg = configs.get(arch).smoke()
    params = lm.pack_params(cfg, lm.init_params(cfg, 0, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 10), generator=gen,
                           dtype=torch.int32)
    ctx = None
    if cfg.n_ctx_tokens:
        ctx = torch.randn((2, cfg.n_ctx_tokens, cfg.d_model), generator=gen)
    with torch.inference_mode():
        with _Ops() as cpu:
            _prefill_decode(cfg, params, tokens, ctx)
        margs = (tree_map(_meta, params), _meta(tokens),
                 None if ctx is None else _meta(ctx))
        with cuda.dry_run(card=False), _Ops() as meta:
            _prefill_decode(cfg, *margs)
    assert meta.names == cpu.names


@pytest.mark.parametrize("arch", ["qwen2-7b+xnor", "recurrentgemma-2b+xnor"])
def test_engine_decode_floor_equals_the_reference(arch):
    """``ServeEngine.decode_roofline()``'s byte floor equals the reference
    engine's at smoke size with the same slots, s_max and block size; the
    audit moves no launch count and no step; the dense layout raises in
    both packages."""
    geom = dict(slots=3, s_max=40, block_size=8)
    jcfg, cfg = jconfigs.get(arch).smoke(), configs.get(arch).smoke()
    jeng = JServeEngine(jcfg, jlm.init_params(jcfg, jax.random.PRNGKey(0)),
                        **geom)
    eng = ServeEngine(cfg, lm.init_params(cfg, 0, device="cpu"),
                      device="cpu", **geom)
    before = (kxnor.xnor_linear_fused.launches,
              kpaged.paged_decode_attention.launches)
    r = eng.decode_roofline()
    assert r["roofline_bytes"] == jeng.decode_roofline()["roofline_bytes"]
    assert r["achieved_bytes"] == r["hlo_bytes_per_chip"] > 0
    assert r["dispatches"] == eng.stats.decode_dispatches > 0
    assert eng.stats.decode_steps == 0
    assert before == (kxnor.xnor_linear_fused.launches,
                      kpaged.paged_decode_attention.launches)
    for e in (JServeEngine(jcfg, jeng.params, paged=False, slots=2,
                           s_max=16),
              ServeEngine(cfg, eng.params, paged=False, slots=2, s_max=16,
                          pack=False, device="cpu")):
        with pytest.raises(ValueError, match="paged"):
            e.decode_roofline()
