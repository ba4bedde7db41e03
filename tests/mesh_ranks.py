"""What each gloo rank of the ``test_torch_mesh_*`` tests runs.

This module imports neither JAX nor the JAX package: ``launch.mesh.
run_ranks`` spawns processes that import it by name, and each returns
numpy arrays to the test, which holds them against the reference."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.core import bitpack, verify
from repro_torch.core.engine import ShardedCimEngine
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import params as pdefs
from repro_torch.optim import adamw
from repro_torch.train import train_step as ttrain


def _u32(t: torch.Tensor) -> np.ndarray:
    return bitpack.to_numpy_u32(t)


# -- the sharded engine ----------------------------------------------------

def engine_cases(seed: int = 0, n_random: int = 20) -> list[dict]:
    """The reference's 8-way property sweep (random sizes up to 200,000
    words, digest widths 32/96/128/256, counters anywhere in 2^32), then
    the edges: one word, a length that is no multiple of 128, a counter
    that wraps 2^32 inside the buffer, an empty buffer.  Every case also
    takes ``digest_chunks`` at a chunk that need not be a multiple of the
    width (the engine aligns it up), 1 to ~16 rows."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(1, 200_000)) for _ in range(n_random)]
    cases = []
    for n in sizes + [1, 3 * 1024 + 5, 70_001, 0]:
        width = int(rng.choice([32, 96, 128, 256]))
        ctr = int(rng.integers(0, 2**32))
        cases.append(dict(
            n=n, width=width, ctr=ctr,
            a=rng.integers(0, 2**32, n, dtype=np.uint32),
            b=rng.integers(0, 2**32, n, dtype=np.uint32),
            key=rng.integers(0, 2**32, 2, dtype=np.uint32),
            chunk=int(rng.integers(n // 16 + 1, 3 * n // 2 + 2))))
    cases[-3]["ctr"] = 2**32 - 1000          # wraps inside the buffer
    cases[-2]["ctr"] = 2**32 - 3
    return cases


def engine_rank(rank: int, world: int, seed: int, device="cpu") -> dict:
    """Every case through a ``world``-rank ShardedCimEngine on ``device``
    -> this rank's chunks of xor / xnor / ciphertext, the digests, the
    digest rows, the round trip, the cycle model and the bytes that
    crossed ranks."""
    mesh = mesh_mod.make_engine_mesh(world, device=device)
    eng = ShardedCimEngine(mesh, device=device)
    assert eng.geometry.devices == world
    sharding.reset_counts()
    out = []
    for c in engine_cases(seed):
        a, b = (bitpack.from_numpy_u32(c[k]).to(device) for k in "ab")
        key = [int(k) for k in c["key"]]
        enc = eng.stream_cipher(a, key, counter=c["ctr"])
        start, stop = eng.local_range(c["n"])
        back = eng.stream_cipher_local(enc, key, c["n"], counter=c["ctr"])
        out.append(dict(
            range=(start, stop), xor=_u32(eng.xor(a, b)),
            xnor=_u32(eng.xnor(a, b)), cipher=_u32(enc),
            round_trip=bool(torch.equal(back, a[start:stop])),
            digest=_u32(eng.digest(a, c["width"])),
            chunks=_u32(eng.digest_chunks(a, c["chunk"], c["width"]))))
    return dict(cases=out, cycles=eng.cycles_for(1 << 22),
                digest_bytes=sharding.all_gather.bytes,
                other_bytes=sharding.all_reduce.bytes)


# -- the sharded train step ------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _blocks(tree) -> dict:
    return {verify.leaf_key(p): _np(t)
            for p, t in verify.tree_flatten_with_path(tree)}


def train_rank(rank: int, cases: dict, step: int, schedule: dict) -> dict:
    """One sharded step of each arch of ``cases`` {arch: (config
    overrides, the reference's parameters, the batch)} (smoke, f32) on
    the (pod, data, model) = (2, 2, 2) mesh -> {arch: this rank's
    gradient and updated parameter blocks (zero-padded), the metrics and
    the bytes of its state}."""
    mesh = mesh_mod.make_smoke_mesh(8, device="cpu")
    return {arch: _train_case(mesh, arch, *case, step, schedule)
            for arch, case in cases.items()}


def _train_case(mesh, arch, over, params, batch, step, schedule) -> dict:
    cfg = configs.get(arch).smoke(dtype=torch.float32, **over)
    blocks = ttrain.shard_params(cfg, convert.from_jax(cfg, params), mesh)
    state = ttrain.TrainState(blocks, adamw.init(blocks))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, grads, _, _ = ttrain._sharded_grads(
        cfg, state.params, batch, 0, mesh, sharding.DEFAULT_RULES, False)
    nbytes = sum(t.numel() * t.element_size()
                 for _, t in verify.tree_flatten_with_path(state))
    new, metrics = ttrain.train_step(cfg, state, batch, step, **schedule,
                                     mesh=mesh)
    return dict(coord=mesh.get_coordinate(), grads=_blocks(grads),
                params=_blocks(new.params), state_bytes=nbytes,
                metrics={k: float(v) for k, v in metrics.items()})


# -- the one-bit exchange --------------------------------------------------

def onebit_rank(rank: int, pods: list, split: list) -> dict:
    """On the (2, 2, 2) mesh, every rank of pod p holding ``pods[p]`` (a
    list of whole leaves): ``_onebit_pod_allreduce`` over the pod axis ->
    the voted leaves and the bytes that crossed.  Then ``split`` [(spec,
    [pod 0's leaf, pod 1's leaf])]: ``_pod_vote`` over this rank's blocks
    of them (a leaf's L1 scale summed over the pod's other axes first)
    -> this rank's voted blocks and its mesh coordinate."""
    mesh = mesh_mod.make_smoke_mesh(8, device="cpu")
    pod = mesh.get_local_rank("pod")
    leaves = [torch.from_numpy(g).to(getattr(torch, dt))
              for g, dt in pods[pod]]
    sharding.reset_counts()
    out = ttrain._onebit_pod_allreduce(
        leaves, sharding.axis_group(mesh, "pod"))
    crossed = sharding.all_gather.bytes
    specs = [spec for spec, _ in split]
    defs = [pdefs.ParamDef(gs[pod].shape, spec) for spec, gs in split]
    blocks = [sharding.shard(torch.from_numpy(gs[pod]), spec, mesh)
              for spec, gs in split]
    voted = ttrain._pod_vote(blocks, specs, defs, mesh)
    return dict(out=[_np(t) for t in out], bytes=crossed,
                coord=mesh.get_coordinate(), voted=[_np(t) for t in voted])


def onebit_step_rank(rank: int, arch: str, batch: dict, step: int,
                     schedule: dict) -> dict:
    """One ``grad_compress="onebit_pod"`` step on a (pod, data, model) =
    (2, 1, 1) mesh from seeded parameters -> the updated parameters, the
    metrics and the bytes that crossed the pod axis."""
    cfg = configs.get(arch).smoke(dtype=torch.float32)
    mesh = mesh_mod.make_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
    state = ttrain.init_state(cfg, 0, device="cpu", mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    sharding.reset_counts()
    new, metrics = ttrain.train_step(cfg, state, batch, step, **schedule,
                                     mesh=mesh, grad_compress="onebit_pod")
    return dict(params=_blocks(new.params), bytes=sharding.all_gather.bytes,
                reduced=sharding.all_reduce.bytes,
                metrics={k: float(v) for k, v in metrics.items()})


# -- the sharded serving steps ---------------------------------------------

def serve_rank(rank: int, cases: dict, s_max: int) -> dict:
    """The sharded ``prefill_step`` and two ``decode_step``s of each case
    {name: (arch, packed, rules, batch)} (smoke, f32, parameters from seed
    0) on the (pod, data, model) = (2, 2, 2) mesh, the decode tokens
    teacher-forced from ``batch["next"]`` -> {name: this rank's logits
    rows of each step, its mesh coordinate}."""
    from repro_torch.models import lm
    from repro_torch.train import serve_step
    mesh = mesh_mod.make_smoke_mesh(8, device="cpu")
    out = {}
    for name, (arch, packed, rules, batch) in cases.items():
        cfg = configs.get(arch).smoke(dtype=torch.float32)
        params = lm.init_params(cfg, 0, device="cpu")
        if packed:
            params = lm.pack_params(cfg, params)
        blocks = serve_step.shard_params(cfg, params, mesh, rules)
        del params
        data = {k: torch.from_numpy(v) for k, v in batch.items()
                if k != "next"}
        with torch.inference_mode():
            logits, state = serve_step.prefill_step(
                cfg, blocks, data, s_max, mesh=mesh, rules=rules)
            steps = [_np(logits)]
            for tok in batch["next"]:
                logits, state = serve_step.decode_step(
                    cfg, blocks, torch.from_numpy(tok), state, mesh=mesh,
                    rules=rules)
                steps.append(_np(logits))
        out[name] = dict(coord=mesh.get_coordinate(), logits=steps)
    return out


# -- tensor- and expert-parallel serving -----------------------------------

def tp_rank(rank: int, shape: tuple, axes: tuple, cases: dict,
            s_max: int, units: bool) -> dict:
    """The sharded ``prefill_step`` and two teacher-forced ``decode_step``s
    of each case {name: dict(arch, over, dtype, packed, params, batch,
    count)} (smoke; parameters from seed 0, or the reference's numpy tree
    ``params``) on a ``shape`` mesh named ``axes`` -> {"coord", "cases":
    {name: this rank's logits rows of each step, and with ``count`` what
    the second decode step gathered (:func:`_count_gathers`)}, "units":
    the unit checks of :func:`_tp_units` (with ``units``)}."""
    mesh = mesh_mod.make_mesh(shape, axes, "cpu")
    out = {"coord": mesh.get_coordinate(), "cases": {}}
    for name, case in cases.items():
        out["cases"][name] = _tp_case(mesh, s_max, **case)
    if units:
        out["units"] = _tp_units(mesh)
    return out


def tp_params(arch: str, over: dict, dtype: str, packed: bool,
              params=None):
    """(config, the whole parameter tree) of a ``tp_rank`` case."""
    from repro_torch.models import lm
    cfg = configs.get(arch).smoke(dtype=getattr(torch, dtype), **over)
    tree = lm.init_params(cfg, 0, device="cpu") if params is None \
        else convert.from_jax(cfg, params)
    return cfg, lm.pack_params(cfg, tree) if packed else tree


def _tp_case(mesh, s_max, arch, over, dtype, packed, batch, params=None,
             count=False) -> dict:
    from repro_torch.train import serve_step
    cfg, whole = tp_params(arch, over, dtype, packed, params)
    blocks = serve_step.shard_params(cfg, whole, mesh)
    del whole
    data = {k: torch.from_numpy(v) for k, v in batch.items() if k != "next"}
    out = {}
    with torch.inference_mode():
        logits, state = serve_step.prefill_step(cfg, blocks, data, s_max,
                                                mesh=mesh)
        steps = [_np(logits)]
        for i, tok in enumerate(batch["next"]):
            with _count_gathers(count and i == 1) as seen:
                logits, state = serve_step.decode_step(
                    cfg, blocks, torch.from_numpy(tok), state, mesh=mesh)
            steps.append(_np(logits))
        out["logits"] = steps
    if count:
        out["gathers"] = seen
        out["blocks"] = {verify.leaf_key(p): (t.numel() * t.element_size(),
                                              tuple(t.shape))
                         for p, t in verify.tree_flatten_with_path(blocks)}
        if hasattr(state.seg_states[0], "k"):
            out["kv_heads"] = int(state.seg_states[0].k.shape[2])
    return out


class _count_gathers:
    """While on: every ``sharding.gather`` call (a parameter's blocks
    gathered) as (the mesh axes it gathers over, the bytes this rank took
    in), and the bytes every ``all_gather`` took in, in ``["total"]``."""

    def __init__(self, on: bool):
        self.on, self.seen = on, {"calls": [], "total": 0}

    def __enter__(self):
        if not self.on:
            return self.seen
        self.orig = sharding.gather
        seen = self.seen

        def counted(block, spec, mesh, shape, sum_axes=None):
            before = sharding.all_gather.bytes
            out = self.orig(block, spec, mesh, shape, sum_axes)
            axes = sorted({a for e in spec for a in sharding._names(e)
                           if sharding.axis_size(mesh, a) > 1})
            seen["calls"].append((axes, sharding.all_gather.bytes - before))
            return out
        sharding.gather = counted
        sharding.reset_counts()
        return seen

    def __exit__(self, *exc):
        if self.on:
            sharding.gather = self.orig
            self.seen["total"] = sharding.all_gather.bytes


def _tp_units(mesh) -> dict:
    """On the rank's mesh: the vocab-parallel lookup against the whole
    table's rows, and moonshot's top-2 combine of a decode step (its
    rows from this rank's experts only) against the single-process
    combine, both under the serving steps' context."""
    from repro_torch.distributed import ctx
    from repro_torch.models import layers, moe
    from repro_torch.models import params as pdefs
    rules = {"batch": None, "tp": "model", "ep": "model"}
    g = torch.Generator().manual_seed(11)
    table = torch.randn((256, 64), generator=g, dtype=torch.bfloat16)
    tokens = torch.randint(0, 256, (3, 5), generator=g)
    cfg = configs.get("moonshot-v1-16b-a3b").smoke(dtype=torch.bfloat16)
    defs = moe.moe_defs(cfg, 1)
    p = {k: v[0] for k, v in pdefs.init(defs, g, "cpu").items()}
    x = torch.randn((8, 1, cfg.d_model), generator=g).to(cfg.dtype)
    xg = x.reshape(8, 1, cfg.d_model)
    r = moe.route(cfg, p["router"], xg)
    whole = moe.combine(cfg, r, moe.experts(cfg, p, xg, r), cfg.dtype)
    with ctx.activation_rules(rules, mesh):
        _, start, stop = ctx.extent(256)
        emb = layers.embed({"tokens": sharding.shard(
            table, ("model", None), mesh)}, tokens)
        e0, ne = moe._local(cfg)
        pb = {k: sharding.shard(v, ("model", None, None), mesh)
              for k, v in p.items() if k != "router"}
        pb["router"] = p["router"]
        ye = moe.experts(cfg, pb, xg, r)
        split = moe.combine(cfg, r, ye, cfg.dtype)
    return {"embed": bool(torch.equal(emb, table[tokens])),
            "embed_bits": bool(torch.equal(emb.view(torch.int16),
                                           table[tokens].view(torch.int16))),
            "experts": (e0, ne), "combine": bool(torch.equal(split, whole))}


def tp_block_rows_rank(rank: int, arch: str, dtype: str,
                       device="cuda", kind: str | None = None) -> list:
    """One layer of ``kind`` (``arch``'s first by default), binarized
    and packed at full width, this rank's head-aligned blocks of it on a
    (data, model) = (1, 2) mesh, in the dense decode the sharded serving
    step runs from a random state, at 1 to 8 slots -> for each slot
    count, the elements of its rows that differ from each slot run alone
    (hazard H2 at the model axis's sums and gathers)."""
    import dataclasses

    from repro_torch.distributed import ctx
    from repro_torch.models import blocks, registry
    mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), device)
    cfg = dataclasses.replace(configs.get(arch), dtype=getattr(torch, dtype))
    block = registry.get(kind or cfg.segments()[0][0])
    defs = block.defs(cfg, 1)
    g = torch.Generator(device=device)
    g.manual_seed(cfg.d_model + 1)
    rules = dict(sharding.DEFAULT_RULES, fsdp=None)
    whole = pdefs.pack(defs, pdefs.init(defs, g, device))
    specs = pdefs.pack_pspecs(defs, rules, head_aligned=True)

    def cut(w, s):
        if hasattr(w, "pb"):
            return type(w)(sharding.shard(w.pb, s.pb, mesh),
                           sharding.shard(w.beta, s.beta, mesh), w.k)
        return sharding.shard(w, s, mesh)
    p = blocks.layer_params({k: cut(w, specs[k]) for k, w in whole.items()},
                            0)
    del whole
    slots, s_max = 8, 32
    cache = block.state_spec(cfg, 1, slots, s_max, device)
    state = blocks.state_map(lambda leaf, s: sharding.shard(torch.randn(
        leaf.shape, generator=g, device=device).to(leaf.dtype),
        (None, *s), mesh), cache, block.tp_state_pspec(cfg, None))
    leaves = blocks.state_leaves(state)
    start = [t.clone() for t in leaves]
    pos = torch.tensor([5, 17, 30, 0, 9, 22, 13, 31], device=device)
    x = torch.randn((slots, 1, cfg.d_model), generator=g,
                    device=device).to(cfg.dtype)

    def step(lo, hi):
        for leaf, t in zip(leaves, start):
            leaf.copy_(t)
        st = blocks.state_map(lambda leaf: leaf[0, lo:hi], state)
        return block.decode(cfg, p, x[lo:hi], st, pos[lo:hi], None)
    rules = {"batch": None, "tp": "model", "ep": "model"}
    with torch.inference_mode(), ctx.activation_rules(rules, mesh), \
            ctx.layers_of(block.tensor_parallel):
        alone = torch.cat([step(j, j + 1) for j in range(slots)])
        return [int((step(0, n) != alone[:n]).sum())
                for n in range(1, slots + 1)]


# -- tensor- and expert-parallel training ----------------------------------

def tp_train_rank(rank: int, shape: tuple, axes: tuple, cases: dict,
                  step: int, schedule: dict) -> dict:
    """One sharded step of each case {name: dict(arch, over, params (the
    reference's numpy tree), batch, microbatch, count)} (smoke, f32) on a
    ``shape`` mesh named ``axes`` -> {"coord", "cases": {name: this rank's
    gradient and updated parameter blocks (zero-padded), the metrics and,
    with ``count``, what the gradient pass gathered and allocated
    (:class:`_step_probe`)}}."""
    mesh = mesh_mod.make_mesh(shape, axes, "cpu")
    out = {"coord": mesh.get_coordinate(), "cases": {}}
    for name, case in cases.items():
        out["cases"][name] = _tp_train_case(mesh, step, schedule, **case)
    return out


def _tp_train_case(mesh, step, schedule, arch, over, params, batch,
                   microbatch=1, count=False, gather_bytes=None) -> dict:
    """``gather_bytes``: ``ctx.GATHER_BYTES`` for the case (0: every
    model-axis sum takes the ring all-reduce, the MoE combine its f32
    partial sums)."""
    from repro_torch.distributed import ctx
    from repro_torch.models import lm
    cfg = configs.get(arch).smoke(dtype=torch.float32, **over)
    blocks = ttrain.shard_params(cfg, convert.from_jax(cfg, params), mesh)
    state = ttrain.TrainState(blocks, adamw.init(blocks))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    limit = ctx.GATHER_BYTES
    if gather_bytes is not None:
        ctx.GATHER_BYTES = gather_bytes
    try:
        with _step_probe(count, cfg, mesh) as seen:
            _, _, grads, _, _ = ttrain._sharded_grads(
                cfg, state.params, batch, 0, mesh, sharding.DEFAULT_RULES,
                False, microbatch)
        new, metrics = ttrain.train_step(cfg, state, batch, step,
                                         **schedule, mesh=mesh,
                                         microbatch=microbatch)
    finally:
        ctx.GATHER_BYTES = limit
    out = dict(grads=_blocks(grads), params=_blocks(new.params),
               metrics={k: float(v) for k, v in metrics.items()})
    if count:
        out["probe"] = seen
        out["layers"], out["embed"] = _gathered_bytes(
            cfg, lm.param_pspecs(cfg, sharding.DEFAULT_RULES,
                                 head_aligned=True), mesh)
    return out


def _gathered_bytes(cfg, specs: dict, mesh) -> tuple[list, int]:
    """-> (the bytes each layer's gathers hand the rank, in depth order;
    the embedding's): a leaf's whole dims but ``model`` for a
    tensor-parallel kind's layer, wherever an axis of its placement
    splits it."""
    from repro_torch.distributed import ctx
    from repro_torch.models import lm

    def gathered(spec, shape, dtype, keep) -> int:
        gather, kept = ctx._split(spec, keep)
        if all(sharding.axis_size(mesh, a) == 1 for a in gather):
            return 0
        size = np.prod(sharding.block_shape(shape, kept, mesh))
        return int(size) * dtype.itemsize
    defs = lm.param_defs(cfg)
    layers = []
    for i, (kind, n) in enumerate(cfg.segments()):
        key = f"seg{i}_{kind}"
        keep = ("model",) if lm._tensor_parallel(key) else ()
        for _ in range(n):
            layers.append(sum(
                gathered(specs[key][k][1:], d.shape[1:], d.dtype, keep)
                for k, d in defs[key].items()))
    embed = sum(gathered(specs["embed"][k], d.shape, d.dtype, ("model",))
                for k, d in defs["embed"].items())
    return layers, embed


class _step_probe:
    """While on: every parameter gather (``sharding.gather``) that took
    bytes in, as (pass, the bytes it hands the rank), the pass "fwd"
    until the gradient pass starts (``torch.autograd.grad``) and "bwd"
    after (the layers' recompute); the most gathered bytes alive at once
    (each gather's storage followed to its release); and the largest
    op output whose last dim is the padded vocab (a (tokens, vocab)
    logits tensor would be one)."""

    def __init__(self, on: bool, cfg, mesh):
        self.on, self.cfg = on, cfg
        self.seen = {"calls": [], "live_max": 0, "vocab_outputs": 0}

    def __enter__(self):
        if not self.on:
            return self.seen
        import weakref

        from torch.utils._python_dispatch import TorchDispatchMode
        seen, live, phase = self.seen, [0], ["fwd"]
        self.orig = sharding.gather, torch.autograd.grad

        def counted(block, spec, mesh, shape, sum_axes=None):
            before = sharding.all_gather.bytes
            out = self.orig[0](block, spec, mesh, shape, sum_axes)
            if sharding.all_gather.bytes > before:
                n = out.numel() * out.element_size()
                seen["calls"].append((phase[0], n))
                live[0] += n
                seen["live_max"] = max(seen["live_max"], live[0])
                weakref.finalize(out.untyped_storage(),
                                 lambda: live.__setitem__(0, live[0] - n))
            return out

        def grad(*args, **kw):
            phase[0] = "bwd"
            return self.orig[1](*args, **kw)
        vocab = self.cfg.padded_vocab

        class Outputs(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in (out if isinstance(out, (list, tuple)) else [out]):
                    if isinstance(t, torch.Tensor) and t.ndim >= 2 \
                            and t.shape[-1] == vocab:
                        seen["vocab_outputs"] = max(seen["vocab_outputs"],
                                                    t.numel())
                return out
        sharding.gather, torch.autograd.grad = counted, grad
        self.mode = Outputs()
        self.mode.__enter__()
        return seen

    def __exit__(self, *exc):
        if self.on:
            self.mode.__exit__(*exc)
            sharding.gather, torch.autograd.grad = self.orig


def tp_layer_grad_rank(rank: int, arch: str, dtype: str,
                       device="cuda") -> dict:
    """One layer of ``arch``'s first kind at full width, in ``dtype``,
    forward and backward through its checkpoint (``blocks._layer_fwd``,
    the layer gathered inside it) on this rank's head-aligned blocks on a
    (data, model) = (1, 2) mesh, against the single-process layer on the
    whole leaves, the same input and upstream gradient -> {"x": the
    input's gradient against the single process's, "leaves": {key: each
    leaf's gradient block's largest error over the whole gradient's
    largest |g|}, "y": the output's largest error over its largest |y|,
    "replicated": the gradients of the leaves replicated over ``model``
    and of the input, as numpy, for the test to compare across ranks}."""
    import dataclasses

    from repro_torch.distributed import ctx
    from repro_torch.models import blocks, registry
    mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), device)
    cfg = dataclasses.replace(configs.get(arch), dtype=getattr(torch, dtype))
    kind = cfg.segments()[0][0]
    block = registry.get(kind)
    defs = block.defs(cfg, 1)
    g = torch.Generator(device=device)
    g.manual_seed(cfg.d_model + 7)
    whole = pdefs.init(defs, g, device)
    specs = pdefs.pspecs(defs, sharding.DEFAULT_RULES, head_aligned=True)
    b, s = 2, 64
    x = torch.randn((b, s, cfg.d_model), generator=g, device=device).to(
        cfg.dtype)
    dy = torch.randn((b, s, cfg.d_model), generator=g, device=device).to(
        cfg.dtype)

    def loss_of(p, xin, opts_ctx):
        with opts_ctx:
            y, aux, _ = blocks._layer_fwd(cfg, block, p, 0, xin,
                                          blocks.FwdOpts(), None, True)
        total = (y.float() * dy.float()).sum()
        return y, total if aux is None else total + aux

    live = {k: w.detach().requires_grad_(True) for k, w in whole.items()}
    x1 = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y1, l1 = loss_of(live, x1, contextlib.nullcontext())
        gw = torch.autograd.grad(l1, [x1, *live.values()])
    want = dict(zip(["x", *live], gw))
    y1 = y1.detach()
    del live, l1
    bl = {k: sharding.shard(w, specs[k], mesh).requires_grad_(True)
          for k, w in whole.items()}
    shapes = {k: tuple(d.shape) for k, d in defs.items()}
    seg = ctx.Segment(bl, specs, shapes, mesh, ("model",))
    x2 = x.detach().requires_grad_(True)
    rules = {"batch": None, "tp": "model", "ep": "model"}
    with torch.enable_grad():
        y2, l2 = loss_of(seg, x2, ctx.activation_rules(rules, mesh))
        got = dict(zip(["x", *bl], torch.autograd.grad(
            l2, [x2, *bl.values()])))
    # a KV head that both ranks' query heads read: the train step sums
    # its holders' shares
    keys = list(bl)
    got.update(zip(keys, ttrain._sum_shared_heads(
        [got[k] for k in keys], [specs[k] for k in keys], mesh)))
    out = {"y": float((y2.detach().float() - y1.float()).abs().max())
           / float(y1.float().abs().max()), "leaves": {}, "replicated": {}}
    for key, gb in got.items():
        w = want[key] if key == "x" else sharding.shard(want[key],
                                                        specs[key], mesh)
        top = float(want[key].float().abs().max())
        out["leaves"][key] = float((gb.float() - w.float()).abs().max()) \
            / max(top, 1e-30)
        if key == "x" or "model" not in {a for e in specs[key]
                                         for a in sharding._names(e)}:
            out["replicated"][key] = gb.detach().float().cpu().numpy()
    return out
