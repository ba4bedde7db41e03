#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                    # the run below
    python3 chip_smoke.py --path-readings    # the readings behind the
                                             # limits of check_paths

Phases (any failure raises and the script exits non-zero):

1. Environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, and the build of the eight kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel,
   with the first design of ``xnor_gemm``, ``xnor_gemm_rowtile.cu``, as a
   yardstick beside them); the registers, static shared memory and spills
   ptxas reports for flash attention, paged decode, the fused XNOR linear
   and ``xnor_gemm``, and the HGMMA (wgmma) and UTMALDG (TMA load)
   instructions in the built flash library (``cuobjdump -sass``).
2. Each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it and at the edge cases (ragged K, ±1
   activations, bf16, int8 pools, a wrapping window ring, G = 7; ragged
   M, N and Kw; buffer lengths 1 to 128·512 + 3, misaligned starts,
   digest widths 64 to 256 and 96, counters that wrap 2^32; flash
   attention at dh 8 to 256, bq != bk, BH 1 to 3, a sequence that is not
   a multiple of the kernel's tile, causal and full, f32 and bf16, held
   at ``FLASH_TOL``; the table shape in bf16 and in f32; paged decode at
   one bf16 ulp too, and at long context: qwen2-7b's decode geometry over
   a 2048-column table, 32k keys a slot, printed on its own line).
   ``xnor_gemm`` at each of its shapes held bitwise (planes offset by a
   word on either side; the C plan against ``gemm_plan``) and timed beside
   its first design and its plain version, and held past the first
   design's limits (Kw > 7264, M > 524280).
   The fused XNOR linear at each qwen2-7b linear shape, M = 4 and 32, held
   bitwise against its plain version summed in the kernel's order, and one
   decode step's 196 fused linears (7 a layer x 28) timed as one CUDA
   graph beside their byte bound.  Times come from CUDA events over many
   launches, rotating through enough input copies to exceed the 50 MB L2
   cache where the path finds its data cold.
3. The serving slice: full-width, full-depth qwen2-7b+xnor in bf16, random
   weights from a seeded generator on the card, packed at load by the pack
   kernel, served by a 4-slot ServeEngine (s_max 128) over 8 requests of
   8-64 prompt tokens and 8-16 new tokens, half opening with a shared
   32-token prefix.  Launch counts are zeroed just before and read just
   after; every kernel of the path must have launched.  Then one prefill
   chunk and one decode step run on the kernel path with every kernel
   launch held against its plain version on the same inputs, and the
   kernel path is held end to end against the plain path run apart (see
   ``check_paths``), in bf16 and in f32 (two seeds) at the same width and
   depth; a control, paged decode giving its plain version's output one
   ulp up at every element, must fail the bf16 check.
4. The integer chain at checkpoint scale: the same seeded 7.6 B-parameter
   bf16 tree (15.2 GB), leaf by leaf through one CimEngine — digest,
   encrypt, decrypt, verify_copy of the decrypted leaf against the
   original, digest again; a one-bit flip must fail verify_copy and move
   exactly one digest bit; the engine's cycle count must equal the bits
   streamed.  Then a DigestCache scrub of a ServeEngine's resident packed
   weights: prime, an unchanged pass (no dirty chunk), one changed word
   (exactly one dirty chunk).  Digests and ciphertext are held against the
   plain versions bitwise afterwards.
5. The binary layers: the XNOR-CNN classifier (256 -> 512 -> 2) on 256
   stripe images, packed path against float path; the unfused prepacked
   linear (binarize -> xnor_gemm -> scale) at every qwen2-7b linear shape,
   M = 4 and 32, bitwise against its plain path; and a 2-request
   full-width ServeEngine run with ``fused_decode="off"``, which must not
   launch the paged decode kernel.

6. Long-context attention at qwen2-7b's geometry: 28 query heads over
   K/V expanded from 4 KV heads, S = 32768, dh = 128, bf16, causal and
   full, through ``flash_attention`` (its own entry; the model's prefill
   does not call it, as in the reference); held against the one-shot
   plain version on 2 heads within one bf16 ulp, timed against SDPA.
7. The checkpoint layer on the card through one CimEngine, over the full
   28-layer bf16 qwen2-7b tree (15.2 GB): an encrypted, write-verified
   save; one leaf changed in place and a delta saved with a primed
   DigestCache (exactly that leaf stored); ``check`` of both steps; one
   byte of a member flipped inside a valid container (``check`` names
   exactly that leaf), then flipped back; a bitwise ``restore``; and
   ``restore_packed`` into a ServeEngine that answers 2 requests with the
   same greedy tokens as an engine built from the in-memory tree.
8. The paper's Monte-Carlo (5000 points, 3 rows) and the engine's bank
   stack (8 banks x 512 rows) on the card, the card's evaluation held
   against the CPU's on the same draws; Eq. (1) over the paper's N_O
   sweep.

The line before the last is a JSON object listing every ported kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
# "f32" is the CUDA-core rate, also used for the word-wise integer ops
# (XOR, multiply) of the streaming kernels: the table has no int32 entry
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
L2_BYTES = 50 * 2**20
ROOT_KEY = "chip-smoke-root-key"
MASK = 0xFFFFFFFF


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str, source: str) -> list[str]:
    """Registers, static shared memory and spills of each kernel that
    ``-Xptxas -v`` reported for ``<source>.cu`` in this run's build log
    (dynamic shared memory is set at launch and not in this report)."""
    import re
    section = log.split(f"== {source}.cu ==", 1)
    if len(section) < 2:
        return ["not measured (library not built in this run)"]
    rows, name, spill = [], None, ""
    for line in section[1].split("\n== ", 1)[0].splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            short = re.search(r"(flash_wgmma|flash_f32|paged_split|"
                              r"xnor_linear|xnor_gemm)_kernel(I\w+?EE)?",
                              name)
            name = short.group(0) if short else name
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            rows.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return rows


def sass_counts(lib: Path) -> str:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in a built
    library, from ``cuobjdump -sass``; "not measured" without it."""
    import shutil
    from repro_torch.kernels import cuda
    tool = Path(cuda._nvcc()).with_name("cuobjdump")
    exe = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if exe is None:
        return "not measured (no cuobjdump)"
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return f"not measured (cuobjdump exit {out.returncode})"
    text = out.stdout
    return (f"{text.count('HGMMA')} HGMMA, {text.count('UTMALDG')} UTMALDG "
            f"instructions")


def time_ms(fn, argsets, calls: int, replays: int = 5) -> float:
    """Device ms per call.  ``calls`` calls, cycling through ``argsets``,
    are captured in one CUDA graph, which is replayed and timed with CUDA
    events: the host's per-call overhead (Python, checks, ctypes) is not in
    the number, only the kernels and the gaps between them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in argsets[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*argsets[i % len(argsets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def copies(make, nbytes: int):
    """Enough independent input sets to exceed the L2 cache."""
    n = max(2, -(-2 * L2_BYTES // max(nbytes, 1)))
    return [make() for _ in range(min(n, 512))]


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


LINEAR_SHAPES = {"wq/wo": (3584, 3584), "wk/wv": (512, 3584),
                 "w1/w3": (18944, 3584), "w2": (3584, 18944)}   # (N, K)


def kernel_checks(gpu: str) -> dict:
    """Phase 2: every kernel against its plain version on the card."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import bitpack, xnor_layers
    from repro_torch.kernels import cuda
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import paged_attn as kpaged
    from repro_torch.kernels import xnor_gemm as kxnor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def both(fn, *args, **kw):
        k = fn(*args, **kw)
        with cuda.plain_reference():
            p = fn(*args, **kw)
        torch.cuda.synchronize()
        return k, p

    rec = {}
    linears = LINEAR_SHAPES

    # -- pack ----------------------------------------------------------------
    err = 0.0
    for name, (n, k) in linears.items():
        w = randn(n, k, dtype=torch.bfloat16)
        (kp, ka), (pp, pa) = both(kpack.pack, w)
        assert torch.equal(kp, pp), f"pack planes differ at {name}"
        # kernel alpha is f32, plain alpha is rounded through bf16
        torch.testing.assert_close(ka, pa, rtol=2 ** -8, atol=0)
        err = max(err, (ka - pa).abs().max().item())
    x = randn(33, 45)
    x[0, :3] = torch.tensor([-0.0, 0.0, float("nan")])
    (kp, ka), (pp, pa) = both(kpack.pack, x)
    assert torch.equal(kp, pp), "pack planes differ at ragged K"
    torch.testing.assert_close(ka, pa, rtol=1e-6, atol=0, equal_nan=True)
    n, k = linears["w1/w3"]
    kw = bitpack.packed_width(k)
    nbytes = n * k * 2 + n * kw * 4 + n * 4
    sets = copies(lambda: (randn(n, k, dtype=torch.bfloat16),), n * k * 2)
    ms = time_ms(kpack.pack, sets, 50)
    with cuda.plain_reference():
        plain = time_ms(kpack.pack, sets[:2], 2, 2)
    b_ms, b_by = bound(nbytes, 2 * n * k, "bf16")
    rec["pack"] = dict(
        name="pack", route="cuda",
        source="src/repro_torch/kernels/csrc/pack.cu",
        replaces="src/repro/kernels/pack.py:45", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"[pack] bf16 ({n}, {k}): {ms} ms, plain {plain} ms, bound "
          f"{b_ms} ms ({b_by}); alpha max abs err {err}  [{gpu}]")

    # -- fused XNOR linear: each qwen2-7b shape at M = 4 (decode) and 32 (a
    # prefill chunk); bitwise against the plain version summed in the
    # kernel's order, within the reference's tolerances of the plain one --
    err, shapes = 0.0, {}
    for name, (n, k) in linears.items():
        wp = xnor_layers.pack_weights(randn(n, k, dtype=torch.bfloat16))
        pb, beta = wp
        kw = pb.shape[1]
        for m in (4, 32):
            pm1 = torch.where(randn(m, k) >= 0, 1.0, -1.0)
            kk, pp = both(kxnor.xnor_linear_fused, pm1, pb, beta, k)
            assert torch.equal(kk, pp), f"±1 dots differ at {name} M={m}"
            xf = randn(m, k)
            kk, pp = both(kxnor.xnor_linear_fused, xf, pb, beta, k)
            assert torch.equal(
                kk, kxnor.linear_kernel_order(xf, pb, beta, k)), \
                f"f32 differs from the kernel-order plain one, {name} M={m}"
            torch.testing.assert_close(kk, pp, rtol=2e-5, atol=2e-5)
            xb = xf.to(torch.bfloat16)
            kk, pp = both(kxnor.xnor_linear_fused, xb, pb, beta, k)
            assert torch.equal(
                kk, kxnor.linear_kernel_order(xb, pb, beta, k)), \
                f"bf16 differs from the kernel-order plain one, {name} M={m}"
            # kernel alpha f32 vs plain alpha rounded to bf16: <= 2^-9 rel
            torch.testing.assert_close(kk, pp, rtol=2 ** -8, atol=1e-6)
            e = (kk - pp).abs().max().item()
            nbytes = m * k * 2 + n * kw * 4 + n * 4 + m * n * 4
            sets = copies(lambda: (randn(m, k, dtype=torch.bfloat16),
                                   *xnor_layers.pack_weights(
                                       randn(n, k, dtype=torch.bfloat16)),
                                   k), n * kw * 4)
            ms = time_ms(kxnor.xnor_linear_fused, sets, 200)
            with cuda.plain_reference():
                plain = time_ms(kxnor.xnor_linear_fused, sets[:2], 2, 2)
            gemm = time_ms(F.linear, copies(
                lambda: (xb, randn(n, k, dtype=torch.bfloat16)), n * k * 2),
                200)
            b_ms, b_by = bound(nbytes, 2 * m * n * k, "int8")
            plan = kxnor.linear_plan(m, n, k)
            print(f"[xnor_linear_fused] {name} M={m} N={n} K={k}: {ms} ms, "
                  f"plain {plain} ms, bound {b_ms} ms ({b_by}), dense bf16 "
                  f"F.linear of the same shape {gemm} ms; max abs err {e}; "
                  f"plan {plan.grid[0] * plan.grid[1]} blocks, split "
                  f"{plan.split}, cluster {plan.cluster}  [{gpu}]")
            shapes[f"{name} M={m}"] = dict(ms=ms, plain_ms=plain,
                                           bound_ms=b_ms, bound_by=b_by,
                                           max_abs_err=e)
            if name == "w1/w3" and m == 4:
                rec["xnor_linear_fused"] = dict(
                    name="xnor_linear_fused", route="cuda",
                    source="src/repro_torch/kernels/csrc/xnor_linear.cu",
                    replaces="src/repro/kernels/xnor_gemm.py:150",
                    max_abs_err=e, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)
            err = max(err, e)
            del sets
    print(f"[xnor_linear_fused shapes] {json.dumps(shapes)}")
    # a ragged K (not a word multiple)
    w = randn(9, 70)
    pb, beta = xnor_layers.pack_weights(w)
    x = randn(5, 70)
    kk, pp = both(kxnor.xnor_linear_fused, x, pb, beta, 70)
    torch.testing.assert_close(kk, pp, rtol=2e-5, atol=2e-5)
    assert torch.equal(kk, kxnor.linear_kernel_order(x, pb, beta, 70))
    # a K too wide for one block: split across the cluster, ragged N, two
    # row passes, f32
    assert kxnor.linear_plan(33, 70, 40000, 4).split > 1
    pb, beta = xnor_layers.pack_weights(randn(70, 40000))
    x = randn(33, 40000)
    kk, pp = both(kxnor.xnor_linear_fused, x, pb, beta, 40000)
    torch.testing.assert_close(kk, pp, rtol=2e-5, atol=2e-5)
    assert torch.equal(kk, kxnor.linear_kernel_order(x, pb, beta, 40000))
    decode_step_linears(gpu, randn)

    # -- paged decode attention ----------------------------------------------
    B, KV, G, dh, bs, W = 4, 4, 7, 128, 16, 8
    n_blocks = 1 + B * W
    scale = dh ** -0.5

    def case(dtype, i8):
        q = randn(B, KV, G, dh, dtype=dtype)
        ck = randn(n_blocks, KV, bs, dh)
        cv = randn(n_blocks, KV, bs, dh)
        if i8:
            ck = torch.clamp(torch.round(ck * 32), -127, 127).to(torch.int8)
            cv = torch.clamp(torch.round(cv * 32), -127, 127).to(torch.int8)
        else:
            ck, cv = ck.to(dtype), cv.to(dtype)
        perm = torch.randperm(B * W, generator=g, device=dev)
        table = (perm.reshape(B, W) + 1).to(torch.int32)
        return q, ck, cv, table

    pos_main = torch.tensor([79, 63, 40, 17], dtype=torch.int32, device=dev)
    pos_ring = torch.tensor([45, 80, 300, 127], dtype=torch.int32, device=dev)
    err = 0.0
    for dtype, i8 in [(torch.float32, False), (torch.bfloat16, False),
                      (torch.bfloat16, True), (torch.float32, True)]:
        rtol, atol = FLASH_TOL[str(dtype).removeprefix("torch.")]
        q, ck, cv, table = case(dtype, i8)
        sc, osc = (scale / 32, 1 / 32) if i8 else (scale, 1.0)
        for window, pos in ((0, pos_main), (40, pos_ring)):
            kk, pp = both(kpaged.paged_decode_attention, q, ck, cv, table,
                          pos, window=window, scale=sc, out_scale=osc)
            torch.testing.assert_close(kk.float(), pp.float(), rtol=rtol,
                                       atol=atol)
            if dtype == torch.bfloat16 and not i8 and window == 0:
                err = (kk.float() - pp.float()).abs().max().item()
    # timed over input sets (q, pools, table) rotated past the L2 cache:
    # on the serving path each layer's pool is cold
    sets = copies(lambda: (*case(torch.bfloat16, False), pos_main),
                  B * KV * G * dh * 2 + 2 * n_blocks * KV * bs * dh * 2)
    q, ck, cv, table, _ = sets[0]
    live = int((pos_main // bs + 1).sum())          # blocks this data reads
    nbytes = (q.numel() * 2 * 2 + live * KV * 2 * bs * dh * 2
              + table.numel() * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4 * KV * G * dh * int((pos_main + 1).sum()),
                       "bf16")
    ms = time_ms(lambda *a: kpaged.paged_decode_attention(
        *a, window=0, scale=scale), sets, 200)
    with cuda.plain_reference():
        plain = time_ms(lambda *a: kpaged.paged_decode_attention(
            *a, window=0, scale=scale), sets[:2], 10, 2)
    # library yardstick: SDPA over K/V already gathered to dense (B, KV,
    # cap, dh) with the position mask (the gather itself is not timed)
    mask = (torch.arange(W * bs, device=dev)[None]
            <= pos_main[:, None].long())[:, None, None, :]

    def gathered(q, ck, cv, table, _):
        idx = table.long()
        return (q, ck[idx].permute(0, 2, 1, 3, 4).reshape(B, KV, W * bs, dh),
                cv[idx].permute(0, 2, 1, 3, 4).reshape(B, KV, W * bs, dh),
                mask)

    lib = time_ms(lambda a, b_, c, m: F.scaled_dot_product_attention(
        a, b_, c, attn_mask=m), [gathered(*s) for s in sets], 200)
    rec["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attn.cu",
        replaces="src/repro/kernels/paged_attn.py:146", max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    print(f"[paged_decode_attention] bf16 B={B} KV={KV} G={G} dh={dh} "
          f"bs={bs} W={W} pos={pos_main.tolist()}, {len(sets)} input sets "
          f"rotated: {ms} ms, plain {plain} "
          f"ms, SDPA on pre-gathered K/V {lib} ms, bound {b_ms} ms ({b_by});"
          f" max abs err {err}  [{gpu}]")
    return rec


def decode_step_linears(gpu: str, randn) -> None:
    """One decode step's fused linears: a layer's seven launches at M = 4
    in ``LINEARS`` order, 28 layers of their own weights and activations
    (817 MB of planes, past L2), captured in one CUDA graph; printed
    beside the step's byte bound."""
    import torch

    from repro_torch.core import xnor_layers
    from repro_torch.kernels import xnor_gemm as kxnor

    shape = {"wq": "wq/wo", "wk": "wk/wv", "wv": "wk/wv", "wo": "wq/wo",
             "w1": "w1/w3", "w3": "w1/w3", "w2": "w2"}
    calls, nbytes = [], 0
    for _ in range(28):
        for lin in LINEARS:
            n, k = LINEAR_SHAPES[shape[lin]]
            pb, beta = xnor_layers.pack_weights(
                randn(n, k, dtype=torch.bfloat16))
            calls.append((randn(4, k, dtype=torch.bfloat16), pb, beta, k))
            nbytes += 4 * k * 2 + pb.numel() * 4 + n * 4 + 4 * n * 4
    step = time_ms(kxnor.xnor_linear_fused, calls, len(calls), 5) * len(calls)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[xnor_linear_fused decode step] {len(calls)} launches (7 a layer "
          f"x 28, M = 4) in one CUDA graph: {step} ms, bound {b_ms} ms "
          f"({step / b_ms} x)  [{gpu}]")
    del calls
    torch.cuda.empty_cache()


def paged_long(gpu: str) -> dict:
    """Phase 2, paged decode at long context: qwen2-7b's decode geometry
    (B 4, KV 4, G 7, dh 128, bs 16) over a 2048-column table (32768 keys a
    slot), positions (32767, 24575, 16383, 8191), bf16 pools (268 MB, of
    which 167.8 MB live).  Held against the plain version at one bf16 ulp,
    timed beside SDPA on K/V already gathered and the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cuda
    from repro_torch.kernels import paged_attn as kpaged

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 6)
    B, KV, G, dh, bs, W = 4, 4, 7, 128, 16, 2048
    n_blocks = 1 + B * W
    scale = dh ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q = randn(B, KV, G, dh)
    ck, cv = randn(n_blocks, KV, bs, dh), randn(n_blocks, KV, bs, dh)
    perm = torch.randperm(B * W, generator=g, device=dev)
    table = (perm.reshape(B, W) + 1).to(torch.int32)
    pos = torch.tensor([32767, 24575, 16383, 8191], dtype=torch.int32,
                       device=dev)
    args = (q, ck, cv, table, pos)
    kk = kpaged.paged_decode_attention(*args, scale=scale)
    with cuda.plain_reference():
        pp = kpaged.paged_decode_attention(*args, scale=scale)
    torch.cuda.synchronize()
    rtol, atol = FLASH_TOL["bfloat16"]
    torch.testing.assert_close(kk.float(), pp.float(), rtol=rtol, atol=atol)
    err = (kk.float() - pp.float()).abs().max().item()
    del kk, pp
    live = int((pos // bs + 1).sum())
    nbytes = (q.numel() * 2 * 2 + live * KV * 2 * bs * dh * 2
              + table.numel() * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4 * KV * G * dh * int((pos + 1).sum()),
                       "bf16")
    ms = time_ms(lambda *a: kpaged.paged_decode_attention(*a, scale=scale),
                 [args], 20)
    with cuda.plain_reference():
        plain = time_ms(lambda *a: kpaged.paged_decode_attention(
            *a, scale=scale), [args], 2, 2)
    idx = table.long()
    gk = ck[idx].permute(0, 2, 1, 3, 4).reshape(B, KV, W * bs, dh)
    gv = cv[idx].permute(0, 2, 1, 3, 4).reshape(B, KV, W * bs, dh)
    mask = (torch.arange(W * bs, device=dev)[None]
            <= pos[:, None].long())[:, None, None, :]
    lib = time_ms(lambda a, b_, c, m: F.scaled_dot_product_attention(
        a, b_, c, attn_mask=m), [(q, gk, gv, mask)], 20)
    print(f"[paged_decode_attention long] bf16 B={B} KV={KV} G={G} dh={dh} "
          f"bs={bs} W={W} pos={pos.tolist()}: {ms} ms "
          f"({nbytes / ms / 1e6} GB/s, {b_ms / ms * 100} % of its bound), "
          f"plain {plain} ms, SDPA on pre-gathered K/V {lib} ms, bound "
          f"{b_ms} ms ({b_by}); max abs err {err} at {FLASH_TOL['bfloat16']}"
          f" (rtol, atol)  [{gpu}]")
    del gk, gv, ck, cv
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                max_abs_err=err)


LEAF_WORDS = 28 * 3584 * 3584 // 2   # a layer-stacked wq leaf, bf16 words
FIRST_GEMM = "xnor_gemm_rowtile"     # the first design, the yardstick


def start_first_design_build():
    """Start nvcc on ``csrc/xnor_gemm_rowtile.cu`` (the first design of
    ``xnor_gemm``, outside the port's build) beside the port's own builds;
    -> the running process and the library it writes."""
    from repro_torch.kernels import cuda
    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = cuda.BUILD_DIR / f"lib{FIRST_GEMM}.so"
    cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o",
           str(lib), str(cuda.CSRC / f"{FIRST_GEMM}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


_FIRST = {}


def first_design_gemm():
    """The first design's ``xnor_gemm`` entry point as a function of
    (pa, pb, valid_k), like the wrapper but with no checks or count."""
    import ctypes

    import torch

    from repro_torch.kernels import cuda
    f = ctypes.CDLL(str(_FIRST["lib"])).xnor_gemm
    f.argtypes = cuda.ENTRY_POINTS["xnor_gemm"][1]
    f.restype = ctypes.c_int

    def run(pa, pb, valid_k):
        out = torch.empty((pa.shape[0], pb.shape[0]), dtype=torch.int32,
                          device=pa.device)
        err = f(pa.data_ptr(), pb.data_ptr(), out.data_ptr(), pa.shape[0],
                pb.shape[0], pa.shape[1], valid_k, cuda.stream(pa))
        assert err == 0, f"{FIRST_GEMM} failed to launch: cudaError {err}"
        return out
    return run


def c_gemm_plan(m: int, n: int, kw: int) -> list:
    """The plan ``csrc/xnor_gemm.cu`` launches for these shapes."""
    import ctypes

    from repro_torch.kernels import cuda
    got = (ctypes.c_int * 5)()
    cuda.launch("xnor_gemm_plan", m, n, kw, ctypes.addressof(got))
    return list(got)


def integer_kernel_checks(gpu: str, linears: dict) -> dict:
    """Phase 2, the integer chain's kernels against their plain versions:
    bitwise at the path's shapes and edges, then timed past L2."""
    import torch

    from repro_torch.kernels import bulk as kbulk
    from repro_torch.kernels import cipher as kcipher
    from repro_torch.kernels import cuda
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import parity as kparity
    from repro_torch.kernels import xnor_gemm as kxnor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)

    def words(n):
        return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=g,
                             device=dev, dtype=torch.int32)

    def planes(m, k):
        return kpack.pack(torch.randn((m, k), generator=g, device=dev)
                          .to(torch.bfloat16))[0]

    def held(fn, *args):
        k = fn(*args)
        with cuda.plain_reference():
            p = fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(k, p), f"{fn.__name__} differs from its plain " \
            f"version at {[tuple(a.shape) if hasattr(a, 'shape') else a for a in args]}"
        return k

    def row(name, src, replaces, ms, plain, nbytes, ops, kind, lib):
        b_ms, b_by = bound(nbytes, ops, kind)
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{src}",
                    replaces=replaces, max_abs_err=0.0, ms=ms,
                    plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib)

    rec = {}
    # -- xnor_gemm: quickstart, XNOR-CNN, every qwen2-7b linear, ragged;
    # timed beside the first design (csrc/xnor_gemm_rowtile.cu) ---------
    first = first_design_gemm()
    shapes = [("quickstart", 64, 32, 256), ("xnor-cnn", 256, 512, 512),
              ("ragged 5x9x70", 5, 9, 70), ("ragged 17x40x200", 17, 40, 200)]
    shapes += [(f"{name} M={m}", m, n, k) for name, (n, k) in linears.items()
               for m in (4, 32)]
    per_shape = {}
    for label, m, n, k in shapes:
        pa, pb = planes(m, k), planes(n, k)
        out = held(kxnor.xnor_gemm, pa, pb, k)
        kw = pa.shape[1]
        assert tuple(c_gemm_plan(m, n, kw)) == tuple(
            kxnor.gemm_plan(m, n, kw)), label
        off = torch.cat([pa.new_zeros(1), pa.reshape(-1)])[1:].reshape(m, kw)
        assert torch.equal(held(kxnor.xnor_gemm, off, pb, k), out), label
        offb = torch.cat([pb.new_zeros(1), pb.reshape(-1)])[1:].reshape(n, kw)
        assert torch.equal(held(kxnor.xnor_gemm, pa, offb, k), out), label
        assert torch.equal(first(pa, pb, k), out), label
        sets = copies(lambda: (planes(m, k), planes(n, k), k), n * kw * 4)
        ms = time_ms(kxnor.xnor_gemm, sets, 200)
        first_ms = time_ms(first, sets, 200)
        with cuda.plain_reference():
            plain = time_ms(kxnor.xnor_gemm, sets[:2], 2, 2)
        r = row("xnor_gemm", "xnor_gemm.cu", "src/repro/kernels/xnor_gemm.py:80",
                ms, plain, (m + n) * kw * 4 + m * n * 4, 2 * m * n * k, "int8",
                None)
        print(f"[xnor_gemm] {label} ({m}, {kw}) x ({n}, {kw}), K={k}: {ms} "
              f"ms, first design {first_ms} ms, plain {plain} ms, bound "
              f"{r['bound_ms']} ms ({r['bound_by']}); plan "
              f"{tuple(kxnor.gemm_plan(m, n, kw))}  [{gpu}]")
        per_shape[label] = dict(ms=ms, first_design_ms=first_ms,
                                plain_ms=plain, bound_ms=r["bound_ms"])
        if label == "w1/w3 M=4":
            rec["xnor_gemm"] = r
        del sets
    print(f"[xnor_gemm shapes] {json.dumps(per_shape)}")
    # past the first design's limits: Kw > 7264 (its shared memory) and M >
    # 524280 (its grid rows); a K split 16 ways; held, not timed
    for m, n, kw in ((3, 40, 9375), (20, 33, 7265), (600_000, 17, 8),
                     (4, 3584, 592)):
        pa = words(m * kw).reshape(m, kw)
        pb = words(n * kw).reshape(n, kw)
        out = held(kxnor.xnor_gemm, pa, pb, 32 * kw)
        off = torch.cat([pa.new_zeros(1), pa.reshape(-1)])[1:].reshape(m, kw)
        assert torch.equal(held(kxnor.xnor_gemm, off, pb, 32 * kw), out)
        print(f"[xnor_gemm] held bitwise past the first design's limits: "
              f"M={m}, N={n}, Kw={kw}, plan "
              f"{tuple(kxnor.gemm_plan(m, n, kw))}")
    torch.cuda.empty_cache()

    # -- edges of the streaming kernels: lengths, alignment, widths, wrap;
    # bulk_xor at its block (256 quads) and peel edges, a and b at each
    # offset mod 16 bytes alike and apart --
    for n in (2, 3, 4, 5, 1023, 1024, 1025, 1027, 1031, 256 * 4 * 3 + 7):
        a, b = words(n + 3), words(n + 3)
        pairs = [(a[i:i + n], b[i:i + n]) for i in range(4)]
        for x, y in pairs + [(a[1:1 + n], b[2:2 + n]), (a[:n], b[3:3 + n])]:
            for inv in (False, True):
                held(kbulk.bulk_xor, x, y, inv)
    for n in (1, 127, 128, 129, 128 * 512 + 3):
        a, b = words(n + 1), words(n + 1)
        for x, y in ((a[:n], b[:n]), (a[1:], b[1:])):
            for inv in (False, True):
                held(kbulk.bulk_xor, x, y, inv)
            for width in (64, 96, 128, 256):
                held(kparity.parity_digest, x, width)
                held(kparity.parity_digest, x, width, 2 * width)
            for ctr in (0, 12345, 2 ** 32 - 5):
                ct = held(kcipher.xor_cipher, x, 0x9E3779B9, 0x0BADF00D, ctr)
                assert torch.equal(kcipher.xor_cipher(
                    ct, 0x9E3779B9, 0x0BADF00D, ctr), x), "not an involution"
    x = words(128 * 512 + 3)
    d0 = kparity.parity_digest(x)
    x[33333] ^= 1 << 5
    assert popcount_bits(d0, kparity.parity_digest(x)) == 1, \
        "one flip, one digest bit"

    # -- timed on a layer-stacked leaf's size (719 MB), past L2 ------------
    n = LEAF_WORDS
    sets = copies(lambda: (words(n), words(n)), n * 4)
    ms = time_ms(kbulk.bulk_xor, sets, 20)
    with cuda.plain_reference():
        plain = time_ms(kbulk.bulk_xor, sets, 2, 2)
    lib = time_ms(torch.bitwise_xor, sets, 20)
    rec["bulk_xor"] = row("bulk_xor", "bulk.cu", "src/repro/kernels/bulk.py:39",
                          ms, plain, 12 * n, n, "f32", lib)
    print(f"[bulk_xor] {n} words: {ms} ms, plain {plain} ms, "
          f"torch.bitwise_xor {lib} ms, bound {rec['bulk_xor']['bound_ms']} "
          f"ms  [{gpu}]")
    sets = [(s[0],) for s in sets]
    ms = time_ms(kparity.parity_digest, sets, 20)
    with cuda.plain_reference():
        plain = time_ms(kparity.parity_digest, sets, 2, 2)
    rec["parity_digest"] = row("parity_digest", "parity.cu",
                               "src/repro/kernels/parity.py:47", ms, plain,
                               4 * n + 512, n, "f32", None)
    print(f"[parity_digest] {n} words: {ms} ms, plain {plain} ms, bound "
          f"{rec['parity_digest']['bound_ms']} ms  [{gpu}]")
    sets = [(w, 0x9E3779B9, 0x0BADF00D, 2 ** 32 - 5) for (w,) in sets]
    ms = time_ms(kcipher.xor_cipher, sets, 20)
    with cuda.plain_reference():
        plain = time_ms(kcipher.xor_cipher, sets, 2, 2)
    rec["xor_cipher"] = row("xor_cipher", "cipher.cu",
                            "src/repro/kernels/cipher.py:47", ms, plain, 8 * n,
                            12 * n, "f32", None)
    print(f"[xor_cipher] {n} words: {ms} ms, plain {plain} ms, bound "
          f"{rec['xor_cipher']['bound_ms']} ms  [{gpu}]")
    return rec


def serve_slice(gpu: str) -> dict:
    """Phase 3: full qwen2-7b+xnor through the port's ServeEngine."""
    import numpy as np
    import torch

    import repro_torch.configs as configs
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import paged_attn as kpaged
    from repro_torch.kernels import xnor_gemm as kxnor
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeEngine, synthetic_trace

    cfg = configs.get("qwen2-7b+xnor")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab, cfg.dtype) == (28, 3584, 28, 4, 18944,
                                                152064, torch.bfloat16)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[slice] init {cfg.name}: {lm.pdefs.count(lm.param_defs(cfg))} "
          f"params in {time.perf_counter() - t0} s")

    base = synthetic_trace(8, cfg.vocab, seed=SEED,
                           prompt_lens=(8, 16, 24, 32),
                           new_tokens=(8, 12, 16))
    prefix = np.random.default_rng([SEED, 0xC1A]).integers(
        0, cfg.vocab, size=32).astype(np.int32)
    trace = [Request(r.rid, np.concatenate([prefix, r.prompt])
                     if r.rid % 2 == 0 else r.prompt, r.max_new_tokens)
             for r in base]
    assert all(8 <= len(r.prompt) <= 64 for r in trace)

    kernels = (kpack.pack, kxnor.xnor_linear_fused,
               kpaged.paged_decode_attention)
    for f in kernels:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, slots=4, s_max=128, device="cuda")
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    peak_load = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for r in trace:
        eng.submit(r)
    report = eng.run()
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in kernels}
    peak_serve = torch.cuda.max_memory_allocated()

    done = [s for s in report.sessions.values() if s.done]
    assert len(done) == len(trace), f"{len(done)}/{len(trace)} completed"
    for s in done:
        assert len(s.tokens) == s.request.max_new_tokens
        assert all(0 <= t < cfg.vocab for t in s.tokens)
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"
    st = report.stats
    ttft = report.ttft_quantiles((0.5, 0.95))
    lat = report.latency_quantiles((0.5, 0.95))
    print(f"[slice] load + pack {t_pack} s, peak memory at load "
          f"{peak_load / 2**30} GiB  [{gpu}]")
    print(f"[slice] served {len(done)}/{len(trace)} requests, "
          f"{report.generated} tokens in {report.wall} s -> "
          f"{report.tok_per_s} tok/s; {st.prefills} prefills "
          f"({st.prefill_chunks} chunks), {st.decode_steps} decode steps; "
          f"prefix hits {st.prefix_hits}, cow {st.cow_copies}  [{gpu}]")
    print(f"[slice] TTFT p50 {ttft[0.5] * 1e3} ms p95 {ttft[0.95] * 1e3} ms;"
          f" latency p50 {lat[0.5] * 1e3} ms p95 {lat[0.95] * 1e3} ms; "
          f"peak memory while serving {peak_serve / 2**30} GiB  [{gpu}]")
    print(f"[slice] main-path launches {launches}")

    # one prefill chunk and one decode step: kernel path vs plain path
    toks = torch.from_numpy(trace[0].prompt[None, :cfg.prefill_chunk].copy())
    nxt = int(trace[0].prompt[cfg.prefill_chunk])
    check_paths(cfg, eng.params, toks, nxt, gpu)
    try:                         # the control: a kernel that rounds one way
        with attention_rounding_up(1):
            check_paths(cfg, eng.params, toks, nxt, gpu)
        failed = ""
    except AssertionError as e:
        failed = str(e)
    print(f"[slice] control, paged decode one ulp up at every element: "
          f"check_paths failed with {failed!r}  [{gpu}]")
    assert "inputs drifted" in failed and "rounds one way" in failed, \
        "check_paths' bf16 holds must each fail a kernel that rounds one way"
    del eng
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    for seed in (SEED, SEED + 1):
        params32 = lm.pack_params(cfg32, lm.init_params(cfg32, seed,
                                                        device="cuda"))
        check_paths(cfg32, params32, toks, nxt, gpu, seed=seed)
        del params32
        torch.cuda.empty_cache()
    return launches


def popcount_bits(a, b) -> int:
    """Number of bits in which two int32 tensors differ."""
    import numpy as np
    x = (a ^ b).cpu().numpy().view(np.uint8)
    return int(np.unpackbits(x).sum())


def integer_chain(gpu: str) -> dict:
    """Phase 4: digest, encrypt, decrypt and verify the full qwen2-7b tree
    leaf by leaf through one CimEngine, then scrub a ServeEngine's resident
    packed weights with a DigestCache."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.core import encrypt, engine, incremental, verify
    from repro_torch.kernels import bulk as kbulk
    from repro_torch.kernels import cipher as kcipher
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels import parity as kparity
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    cfg = configs.get("qwen2-7b+xnor")
    params = lm.init_params(cfg, SEED, device="cuda")
    leaves = [(verify.leaf_key(p), t)
              for p, t in verify.tree_flatten_with_path(params)]
    n_params = sum(t.numel() for _, t in leaves)
    tree_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    assert n_params > 7.6e9, n_params
    torch.cuda.synchronize()
    print(f"[chain] {cfg.name}: {len(leaves)} leaves, {n_params} params, "
          f"{tree_bytes / 1e9} GB")

    kernels = (kbulk.bulk_xor, kparity.parity_digest, kcipher.xor_cipher)
    for f in kernels:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    eng = engine.CimEngine(device="cuda")
    want_bits = []                   # the bits each engine call streams
    events = {p: [] for p in ("digest", "encrypt", "decrypt", "verify",
                              "redigest")}

    def timed(name, fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        events[name].append((start, end))
        return out

    t0 = time.perf_counter()
    digs = {}
    for key, t in leaves:
        digs[key] = timed("digest", eng.digest, t)
        want_bits.append(t.numel() * t.element_size() * 8)
    for key, t in leaves:
        words = ops.as_words(t)                   # a view: no copy
        nbits = words.numel() * 32
        ct = timed("encrypt", encrypt.encrypt_device, words, ROOT_KEY, key,
                   eng)
        assert not bool(eng.verify_copy(ct, words)), f"{key}: ciphertext " \
            "equals plaintext"
        pt = timed("decrypt", encrypt.encrypt_device, ct, ROOT_KEY, key, eng)
        del ct
        back = pt.view(t.dtype)[:t.numel()].reshape(t.shape)
        assert bool(timed("verify", eng.verify_copy, back, t)), \
            f"{key}: decrypted leaf differs from the original"
        assert torch.equal(timed("redigest", eng.digest, back), digs[key]), \
            f"{key}: digest moved through encrypt + decrypt"
        del pt, back
        want_bits += [nbits, nbits, nbits, nbits,
                      t.numel() * t.element_size() * 8]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    passes = {name: sum(a.elapsed_time(b) for a, b in ev)
              for name, ev in events.items()}

    # one flipped bit in one leaf
    key, t = leaves[[k for k, _ in leaves].index("embed/tokens")]
    bad = t.clone()
    bad_words = ops.as_words(bad)                 # a view of bad
    bad_words[bad_words.numel() // 3] ^= 1 << 11
    assert not bool(eng.verify_copy(bad, t)), "a flipped bit went unseen"
    d_bad = eng.digest(bad)
    assert popcount_bits(d_bad, digs[key]) == 1, "one flip, one digest bit"
    want_bits += [t.numel() * t.element_size() * 8] * 2
    del bad, bad_words
    want_cycles = sum(eng.cycles_for(b) for b in want_bits)
    st = eng.stats.snapshot()
    assert (st.cycles, st.bit_ops, st.calls) == (
        want_cycles, sum(want_bits), len(want_bits)), (st, want_cycles)

    # the scrub IntegrityScrubber runs, over the resident packed weights
    serve = ServeEngine(cfg, params, slots=1, s_max=64, device="cuda")
    cache = incremental.DigestCache(engine=eng)
    cache.digests(serve.params)
    prime = cache.last
    before = cache.digests(serve.params)
    clean = cache.last
    assert clean.dirty_chunks == 0 and clean.clean_leaves == clean.leaves
    plane = serve.params["seg0_attn"]["ffn_w2"].pb
    plane.view(-1)[plane.numel() // 2 + 5] ^= 1 << 3
    after = cache.digests(serve.params)
    hit = cache.last
    assert hit.dirty_chunks == 1 and hit.clean_leaves == hit.leaves - 1, hit
    fb, fa = ({verify.leaf_key(p): d
               for p, d in verify.tree_flatten_with_path(x)}
              for x in (before, after))
    moved = [k for k in fa if (fa[k] != fb[k]).any()]
    assert moved == ["seg0_attn/ffn_w2/0"], moved
    resident = sum(x.numel() * x.element_size() for _, x in
                   verify.tree_flatten_with_path(serve.params))
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in kernels}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the integer chain"
    del serve, cache

    # held against the plain versions (after the counts were read): two
    # digests, and one leaf's ciphertext cut into chunks
    flat = dict(leaves)
    for key in ("embed/tokens", "seg0_attn/attn_wq"):
        with cuda.plain_reference():
            plain = ops.digest(flat[key])
        assert torch.equal(plain, digs[key]), f"{key}: digest != plain"
    key = "seg0_attn/attn_wo"
    words = ops.as_words(flat[key])
    k0, k1, ctr = (int(v) for v in encrypt.derive_key(ROOT_KEY, key))
    ct = kcipher.xor_cipher(words, k0, k1, ctr)
    step = 1 << 25
    for s0 in range(0, words.numel(), step):
        with cuda.plain_reference():
            plain = ops.stream_cipher(words[s0:s0 + step], (k0, k1),
                                      (ctr + s0) & MASK)
        assert torch.equal(ct[s0:s0 + step], plain), f"{key} @ {s0}"
    del params, flat, leaves, words, ct, t
    torch.cuda.empty_cache()

    gb = tree_bytes / 1e9
    rates = {name: gb / (ms / 1e3) for name, ms in passes.items()}
    print(f"[chain] digest, encrypt, decrypt, verify_copy and re-digest of "
          f"all {len(digs)} leaves ({gb} GB) in {wall} s wall; device ms "
          f"per pass {passes}; GB/s over the tree {rates} against "
          f"{HBM_BYTES_PER_S / 1e9} GB/s of HBM  [{gpu}]")
    print(f"[chain] engine stats: {st.cycles} cycles = cycles_for the "
          f"{st.bit_ops} bits streamed in {st.calls} calls; by op "
          f"{st.by_op}; peak memory {peak / 2**30} GiB  [{gpu}]")
    print(f"[chain] scrub of the resident packed weights ({resident / 1e9} "
          f"GB, {prime.leaves} leaves, {prime.chunks} chunks): prime "
          f"{prime}, unchanged {clean}, one word changed {hit}  [{gpu}]")
    print(f"[chain] main-path launches {launches}")
    assert peak < 25 * 2 ** 30, f"peak {peak / 2**30} GiB"
    return launches


def binary_layers(gpu: str, linears: dict) -> dict:
    """Phase 5: the XNOR-CNN classifier, the unfused prepacked linear at
    every qwen2-7b shape, and a full-width serve run with
    ``fused_decode="off"``."""
    import numpy as np
    import torch

    import repro_torch.configs as configs
    from repro_torch.core import xnor_layers
    from repro_torch.kernels import cuda
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import paged_attn as kpaged
    from repro_torch.kernels import xnor_gemm as kxnor
    from repro_torch.models import lm, xnor_classifier
    from repro_torch.serve import ServeEngine, synthetic_trace

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    x_np, _ = xnor_classifier.make_data(np.random.default_rng(SEED), 256)
    images = torch.from_numpy(x_np).to(dev)
    cnn = xnor_classifier.init(g, dev)
    layer_in = [(torch.randn((m, k), generator=g, device=dev)
                 .to(torch.bfloat16), *xnor_layers.pack_weights(
                     torch.randn((n, k), generator=g, device=dev)
                     .to(torch.bfloat16)), k)
                for n, k in linears.values() for m in (4, 32)]
    cfg = dataclasses.replace(configs.get("qwen2-7b+xnor"),
                              fused_decode="off")
    params = lm.init_params(cfg, SEED, device="cuda")
    trace = synthetic_trace(2, cfg.vocab, seed=SEED, prompt_lens=(24, 40),
                            new_tokens=(8,))
    torch.cuda.synchronize()

    kernels = (kpack.pack, kxnor.xnor_gemm, kxnor.xnor_linear_fused,
               kpaged.paged_decode_attention)
    for f in kernels:
        f.launches = 0
    logits_packed = xnor_classifier.forward(cnn, images, packed=True)
    outs = [xnor_layers.xnor_linear_prepacked(x, pb, beta, k, mode="off")
            for x, pb, beta, k in layer_in]
    eng = ServeEngine(cfg, params, slots=2, s_max=64, device="cuda")
    del params
    for r in trace:
        eng.submit(r)
    report = eng.run()
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in kernels}
    done = [s for s in report.sessions.values() if s.done]
    assert len(done) == 2 and all(
        len(s.tokens) == s.request.max_new_tokens for s in done)
    assert launches["xnor_gemm"] > 0 and launches["pack"] > 0, launches
    assert launches["xnor_linear_fused"] > 0, launches
    assert launches["paged_decode_attention"] == 0, launches
    del eng
    torch.cuda.empty_cache()

    # held against the float path and the plain versions (not counted)
    logits_float = xnor_classifier.forward(cnn, images, packed=False)
    assert torch.isfinite(logits_packed).all()
    assert logits_packed.shape == (256, xnor_classifier.N_CLS)
    torch.testing.assert_close(logits_packed, logits_float, rtol=1e-3,
                               atol=1e-3)
    err = (logits_packed - logits_float).abs().max().item()
    h = torch.tanh(images @ cnn["w_in"].T)
    kk = xnor_layers.xnor_linear(h, cnn["w_mid"], packed=True)
    with cuda.plain_reference():
        pp = xnor_layers.xnor_linear(h, cnn["w_mid"], packed=True)
    assert torch.equal(kk, pp), "XNOR-CNN binary layer differs from plain"
    for (x, pb, beta, k), y in zip(layer_in, outs):
        with cuda.plain_reference():
            plain = xnor_layers.xnor_linear_prepacked(x, pb, beta, k,
                                                      mode="off")
        assert torch.equal(y, plain), f"unfused linear {tuple(x.shape)} x " \
            f"{tuple(pb.shape)} differs from its plain path"
    print(f"[binary] XNOR-CNN 256 -> 512 -> 2 on 256 images: packed vs float "
          f"path max abs diff {err}; the binary layer bitwise equal to its "
          f"plain version  [{gpu}]")
    print(f"[binary] unfused prepacked linear (pack -> xnor_gemm -> scale) "
          f"bitwise equal to its plain path at {len(outs)} shapes "
          f"(every qwen2-7b linear, M = 4 and 32)  [{gpu}]")
    print(f"[binary] fused_decode='off' serve run: {report.generated} tokens "
          f"for 2 requests in {report.wall} s; launches {launches}  [{gpu}]")
    return launches


QWEN_ATTN = dict(heads=28, kv_heads=4, dh=128)   # qwen2-7b's attention


def qwen_qkv(g, s: int):
    """q (28, S, 128) and K/V expanded from 4 KV heads as
    ``models/attention.py::_expand_kv`` repeats them, bf16."""
    import torch
    h, kv, dh = QWEN_ATTN["heads"], QWEN_ATTN["kv_heads"], QWEN_ATTN["dh"]

    def randn(n):
        return torch.randn((n, s, dh), generator=g, device="cuda").to(
            torch.bfloat16)
    q = randn(h)
    k, v = (randn(kv).repeat_interleave(h // kv, dim=0) for _ in range(2))
    return q, k, v


def attention_flops(bh: int, s: int, dh: int, causal: bool) -> float:
    """4 * dh flops per query-key pair the mask keeps."""
    return 4.0 * dh * bh * (s * (s + 1) / 2 if causal else s * s)


# The attention holds (flash attention and paged decode).  Each kernel and
# its plain versions compute in f32 from upcast inputs (the flash kernel's
# bf16 instance rounds P to bf16 for its P.V product, 2^-9 of |o| with no
# systematic sign) and round once to the output dtype: f32 at the
# reference suite's 2e-5; bf16 within one bf16 ulp of the expected value
# (2^-7 of it) plus 1e-5 of f32 noise near zero.  With random inputs |o|
# is about sqrt(e / position) (0.009 at 32k keys), so a looser absolute
# limit would pass a kernel that drops most keys of the late rows.
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2 ** -7, 1e-5)}


def hold_flash(got, want) -> float:
    """Hold a flash output at :data:`FLASH_TOL` -> max abs error."""
    import torch
    rtol, atol = FLASH_TOL[str(got.dtype).removeprefix("torch.")]
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    return (got.float() - want.float()).abs().max().item()


def flash_checks(gpu: str) -> dict:
    """Phase 2, flash attention against its plain version (the tiled
    online-softmax recurrence) at the edges, then timed past L2 at the
    table shape: BH = 28, S = 4096, dh = 128, bf16, causal."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cuda
    from repro_torch.kernels import flash_attn as kflash

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    edges = [(1, 64, 8, 32, 32), (3, 128, 16, 16, 64), (1, 256, 32, 64, 16),
             (3, 192, 128, 64, 32), (2, 80, 24, 16, 16), (1, 64, 256, 32, 32)]
    for bh, s, dh, bq, bk in edges:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((bh, s, dh), generator=g, device=dev)
                       .to(dtype) for _ in range(3))
            for causal in (True, False):
                kk = kflash.flash_attention(q, k, v, causal=causal, bq=bq,
                                            bk=bk)
                with cuda.plain_reference():
                    pp = kflash.flash_attention(q, k, v, causal=causal,
                                                bq=bq, bk=bk)
                torch.cuda.synchronize()
                assert kk.dtype == dtype
                err[dtype] = max(err[dtype], hold_flash(kk, pp))
    print(f"[flash_attention] edges {edges} (BH, S, dh, bq, bk) x causal/full"
          f" held against the tiled plain version at {FLASH_TOL} (rtol, "
          f"atol): max abs err f32 {err[torch.float32]}, bf16 "
          f"{err[torch.bfloat16]}  [{gpu}]")

    h, dh, s = QWEN_ATTN["heads"], QWEN_ATTN["dh"], 4096
    nbytes = 4 * h * s * dh * 2
    sets = copies(lambda: qwen_qkv(g, s), 3 * h * s * dh * 2)
    kk = kflash.flash_attention(*sets[0], causal=True)
    with cuda.plain_reference():
        pp = kflash.flash_attention(*sets[0], causal=True)
    torch.cuda.synchronize()
    e = hold_flash(kk, pp)
    # the same shape in f32, where a rounding to bf16 cannot hide an error
    q32, k32, v32 = (t.float() for t in sets[0])
    kk = kflash.flash_attention(q32, k32, v32, causal=True)
    with cuda.plain_reference():
        pp = kflash.flash_attention(q32, k32, v32, causal=True)
    torch.cuda.synchronize()
    e32 = hold_flash(kk, pp)
    del kk, pp, q32, k32, v32
    ms = time_ms(lambda *a: kflash.flash_attention(*a, causal=True), sets, 10,
                 3)
    with cuda.plain_reference():
        plain = time_ms(lambda *a: kflash.flash_attention(*a, causal=True),
                        sets[:2], 2, 2)
    lib = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=True), sets, 10, 3)
    b_ms, b_by = bound(nbytes, attention_flops(h, s, dh, True), "bf16")
    flops = attention_flops(h, s, dh, True)
    print(f"[flash_attention] bf16 causal BH={h} S={s} dh={dh}, {len(sets)} "
          f"input sets rotated: {ms} ms ({flops / ms / 1e9} TFLOP/s), plain "
          f"{plain} ms, SDPA {lib} ms ({flops / lib / 1e9} TFLOP/s), bound "
          f"{b_ms} ms ({b_by}); max abs err {e} (f32 at the same shape: "
          f"{e32})  [{gpu}]")
    return {"flash_attention": dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn.py:82", max_abs_err=e, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)}


def long_context(gpu: str) -> dict:
    """Phase 6: flash attention at qwen2-7b's geometry over 32768 tokens."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as kflash

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    s = 32768
    q, k, v = qwen_qkv(g, s)
    h, dh = q.shape[0], q.shape[2]
    torch.cuda.synchronize()

    kflash.flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = {c: kflash.flash_attention(q, k, v, causal=c) for c in (True,
                                                                  False)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kflash.flash_attention.launches
    assert launches == 2, launches
    print(f"[long] flash_attention bf16 BH={h} S={s} dh={dh}, causal and "
          f"full: {wall} s wall; launches {launches}  [{gpu}]")

    # held against the one-shot plain version (4.3 GB of scores a head)
    err = 0.0
    for causal, o in outs.items():
        assert o.shape == q.shape and o.dtype == torch.bfloat16
        assert torch.isfinite(o).all()
        for i in (0, 1):
            want = kflash.flash_attention_ref(q[i:i + 1], k[i:i + 1],
                                              v[i:i + 1], causal)
            err = max(err, hold_flash(o[i:i + 1], want))
            del want
            torch.cuda.empty_cache()
    del outs
    for causal in (True, False):
        ms = time_ms(lambda *a: kflash.flash_attention(*a, causal=causal),
                     [(q, k, v)], 1, 2)
        lib = time_ms(lambda a, b, c: F.scaled_dot_product_attention(
            a[None], b[None], c[None], is_causal=causal), [(q, k, v)], 1, 2)
        flops = attention_flops(h, s, dh, causal)
        b_ms, b_by = bound(4 * q.numel() * 2, flops, "bf16")
        print(f"[long] {'causal' if causal else 'full'}: kernel {ms} ms "
              f"({flops / ms / 1e9} TFLOP/s), SDPA {lib} ms "
              f"({flops / lib / 1e9} TFLOP/s), bound {b_ms} ms ({b_by})  "
              f"[{gpu}]")
    print(f"[long] heads 0 and 1 held against the one-shot plain version "
          f"at {FLASH_TOL['bfloat16']} (rtol, atol): max abs err {err}  "
          f"[{gpu}]")
    del q, k, v
    torch.cuda.empty_cache()
    return {"flash_attention": launches}


def flip_member_byte(npz: Path, member: str, index: int) -> None:
    """XOR one byte of a member's array data and rewrite the member's CRC-32
    in its local header and in the central directory: the container stays
    valid, so only the parity digest can see the change.  Flipping the same
    byte again undoes it."""
    import struct
    import zipfile
    import zlib

    with zipfile.ZipFile(npz) as zf:
        info = zf.getinfo(member)
        data = bytearray(zf.read(member))
    pos = 10 + struct.unpack("<H", data[8:10])[0] + index   # past .npy header
    data[pos] ^= 0xFF
    crc = struct.pack("<I", zlib.crc32(data))
    with open(npz, "r+b") as f:
        f.seek(info.header_offset)
        name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len + pos)
        f.write(bytes([data[pos]]))
        f.seek(info.header_offset + 14)
        f.write(crc)
        size = f.seek(0, 2)
        tail_at = max(0, size - (1 << 20))
        f.seek(tail_at)
        tail = f.read()
        name = member.encode()
        i = tail.find(b"PK\x01\x02")
        while i >= 0:
            n = struct.unpack("<H", tail[i + 28:i + 30])[0]
            if tail[i + 46:i + 46 + n] == name:
                f.seek(tail_at + i + 16)
                f.write(crc)
                return
            i = tail.find(b"PK\x01\x02", i + 4)
    raise RuntimeError(f"{member} has no central directory entry in {npz}")


def checkpoint_layer(gpu: str) -> dict:
    """Phase 7: save, delta, check, tamper, restore and restore_packed of
    the full bf16 qwen2-7b tree through one CimEngine on the card."""
    import shutil

    import torch

    import repro_torch.configs as configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import encrypt, engine, incremental, verify
    from repro_torch.kernels import cipher as kcipher
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import paged_attn as kpaged
    from repro_torch.kernels import parity as kparity
    from repro_torch.kernels import xnor_gemm as kxnor
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine, synthetic_trace

    # the full 28-layer tree: 15.2 GB fits the card's host (96 GiB) and
    # its disk (75 GB free) with room to spare; nothing is cut
    cfg = configs.get("qwen2-7b+xnor")
    directory = ROOT / "experiments" / "chip_smoke_ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    params = lm.init_params(cfg, SEED, device="cuda")
    leaves = dict((verify.leaf_key(p), t)
                  for p, t in verify.tree_flatten_with_path(params))
    gb = sum(t.numel() * t.element_size() for t in leaves.values()) / 1e9
    n_leaves = len(leaves)
    changed, tampered = "seg0_attn/attn_wo", "seg0_attn/attn_bq"
    trace = synthetic_trace(2, cfg.vocab, seed=SEED, prompt_lens=(16, 24),
                            new_tokens=(8,))
    torch.cuda.synchronize()

    kernels = (kparity.parity_digest, kcipher.xor_cipher, kpack.pack,
               kxnor.xnor_linear_fused, kpaged.paged_decode_attention)
    for f in kernels:
        f.launches = 0
    eng = engine.CimEngine(device="cuda")
    times = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    t_all = time.perf_counter()
    try:
        cache = incremental.DigestCache(engine=eng)
        timed("prime", cache.digests, params)
        timed("save", ckpt.save, str(directory), 1, params,
              root_key=ROOT_KEY, engine=eng)
        leaves[changed][0].neg_()                  # one leaf, in place
        m2 = timed("save_delta", ckpt.save_delta, str(directory), 2, params,
                   root_key=ROOT_KEY, engine=eng, cache=cache)
        stored = [k for k, m in m2["leaves"].items() if m["stored_in"] == 2]
        assert stored == [changed], stored
        del cache
        torch.cuda.empty_cache()
        for step in (1, 2):
            ok, bad = timed(f"check {step}", ckpt.check, str(directory), step,
                            root_key=ROOT_KEY, engine=eng)
            assert ok and not bad, (step, bad)

        npz = directory / "ckpt_00000001.npz"
        member = tampered.replace("/", "__") + ".npy"
        flip_member_byte(npz, member, 4321)
        ok, bad = timed("check tampered", ckpt.check, str(directory), 2,
                        root_key=ROOT_KEY, engine=eng)
        assert not ok and bad == [tampered], bad
        flip_member_byte(npz, member, 4321)
        assert ckpt.check(str(directory), 2, root_key=ROOT_KEY, engine=eng,
                          leaves=[tampered]) == (True, [])

        tree, step = timed("restore", ckpt.restore, str(directory), None,
                           lm.abstract_params(cfg), root_key=ROOT_KEY,
                           engine=eng)
        assert step == 2
        for p, t in verify.tree_flatten_with_path(tree):
            want = leaves[verify.leaf_key(p)]
            assert t.dtype == want.dtype and t.shape == want.shape
            assert torch.equal(t.reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8)), p
        del tree
        torch.cuda.empty_cache()

        packed, _ = timed("restore_packed", ckpt.restore_packed,
                          str(directory), None, cfg, root_key=ROOT_KEY,
                          engine=eng)
        tokens = {}
        for name, tree in (("restored", packed), ("in-memory", params)):
            serve = ServeEngine(cfg, tree, slots=2, s_max=64, device="cuda")
            for r in trace:
                serve.submit(r)
            report = serve.run()
            tokens[name] = {rid: list(s.tokens)
                            for rid, s in report.sessions.items()}
            del serve
            torch.cuda.empty_cache()
        del packed
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_all
        launches = {f.__name__: f.launches for f in kernels}
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    assert tokens["restored"] == tokens["in-memory"], tokens
    assert all(len(t) == 8 for t in tokens["restored"].values()), tokens
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched in the checkpoint phase"

    # where the time goes: device time of the digest and cipher over the
    # tree, and the host copies of its bytes, measured apart
    events = []
    for key, t in leaves.items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        words = eng._words(t)
        eng.digest(words)
        ct = encrypt.encrypt_device(words, ROOT_KEY, key, eng)
        end.record()
        events.append((start, end))
        del ct
    torch.cuda.synchronize()
    kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    big = leaves["seg0_attn/ffn_w1"]
    t0 = time.perf_counter()
    host = big.cpu()
    d2h = big.numel() * 2 / (time.perf_counter() - t0) / 1e9
    t0 = time.perf_counter()
    host.cuda()
    torch.cuda.synchronize()
    h2d = big.numel() * 2 / (time.perf_counter() - t0) / 1e9
    del host, params, leaves, big
    torch.cuda.empty_cache()

    rates = {name: gb * (2 if name == "checks" else 1) / t for name, t in (
        ("save", times["save"]), ("checks", times["check 1"]
                                  + times["check 2"]),
        ("restore", times["restore"]), ("restore_packed",
                                        times["restore_packed"]))}
    print(f"[ckpt] {cfg.name} float tree, {n_leaves} leaves "
          f"of {gb} GB, encrypted, through one CimEngine: seconds {times}; "
          f"GB/s of tree {rates}; phase wall {wall} s  [{gpu}]")
    print(f"[ckpt] delta stored exactly {stored}; check named exactly "
          f"[{tampered!r}] after one byte of its member flipped inside a "
          f"valid container; restore bitwise equal; restore_packed engine "
          f"tokens equal the in-memory engine's: {tokens['restored']}  "
          f"[{gpu}]")
    print(f"[ckpt] where the time goes: digest + cipher kernels over the tree "
          f"{kernel_s} s of device time; D2H {d2h} GB/s and H2D {h2d} GB/s "
          f"(pageable, one 3.8 GB leaf), i.e. {gb / d2h} s and {gb / h2d} s "
          f"for the tree; the rest of each pass is the disk and the zip "
          f"(CRC) on the host  [{gpu}]")
    print(f"[ckpt] engine stats {eng.stats.cycles} cycles, "
          f"{eng.stats.bit_ops} bits in {eng.stats.calls} calls; "
          f"launches {launches}")
    return launches


def monte_carlo(gpu: str) -> None:
    """Phase 8: the paper's Monte-Carlo and the bank stack's, on the card,
    held against the CPU's evaluation of the same draws."""
    import torch

    from repro_torch.core import engine, montecarlo, speedup

    geo = engine.BankGeometry()
    setups = (("paper", 5000, 3, 1), ("bank stack", 5000, geo.rows,
                                      geo.banks))
    for label, samples, rows, banks in setups:
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 6)
        montecarlo.run(g, samples=8, rows=rows, banks=banks)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = montecarlo.run(g, samples=samples, rows=rows, banks=banks)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        m = res.margins.reshape(-1, 2).double()
        rate = res.error_rate.tolist()
        print(f"[mc] {label}: {samples} samples x {banks} banks x {rows} rows "
              f"in {dt * 1e3} ms; XOR error rate per input {rate}; margins "
              f"(I01-REF1, REF2-I01) mean {m.mean(0).tolist()} A, std "
              f"{m.std(0).tolist()} A  [{gpu}]")

        d = montecarlo.draw(torch.Generator().manual_seed(SEED + 7), samples,
                            rows, banks)
        card, cpu = montecarlo.evaluate(d.to("cuda")), montecarlo.evaluate(d)
        scale = cpu.i_sl.abs().max().item()
        for name in ("i_sl", "v_cell", "v_ref", "margins"):
            atol = 1e-6 * scale if name == "margins" else 0.0
            torch.testing.assert_close(getattr(card, name).cpu(),
                                       getattr(cpu, name), rtol=1e-6,
                                       atol=atol)
        for name in ("xor_out", "xnor_out", "error_rate"):
            assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
        print(f"[mc] {label}: the card's evaluation equals the CPU's on the "
              f"same draws (floats at rtol 1e-6, outputs and rates exactly)"
              f"  [{gpu}]")
    n_o = torch.tensor([64, 256, 1024, 4096, 16384, 65536],
                       dtype=torch.float32, device="cuda")
    print(f"[mc] Eq. (1) XNOR-Net speedup at N_O {n_o.int().tolist()}: "
          f"1-cycle {speedup.xnornet_speedup(n_o).tolist()}, 3-cycle "
          f"{speedup.xnornet_speedup(n_o / 3).tolist()}, XOR-Net "
          f"{speedup.xornet_speedup(n_o).tolist()}; max rows at the nominal "
          f"HRS/LRS {float(montecarlo.max_rows())}")


LINEARS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")   # launch order per layer
# check_paths' bf16 limits, from ``--path-readings`` (PERF.md §6: over 12
# prompts the kernel path's largest readings were 1.46e-3, 3.9e-4 and a z
# of 1.39 at 14 differing elements; the one-ulp-up controls drift 4.3e-3
# and 5.9e-3 and read z 445 and 630): the logits' relative L2 gap where no
# sign bit differs, the fused-linear inputs' relative L2 gap up to the
# first differing sign bit, and how far the count of the paged decode
# kernel's differences from its plain version that lie above it may stray
# from half of them, in standard deviations of a fair coin (sqrt(n) / 2)
BF16_PATH_LOGITS = 3e-3
BF16_TRACK = 1.5e-3
BF16_ATTN_Z = 4.0


def first_flip(xs_a, xs_b):
    """Walk two runs' fused-linear inputs launch by launch: the largest
    relative L2 gap up to and including the first launch whose sign bits
    differ, and where that first differing bit is (None if none does)."""
    drift = 0.0
    for i, (a, b) in enumerate(zip(xs_a, xs_b)):
        drift = max(drift, ((a - b).norm() / b.norm()).item())
        diff = (a >= 0) != (b >= 0)
        if diff.any():
            r, c = (int(v) for v in diff.nonzero()[0])
            return drift, dict(
                launch=i, layer=i // len(LINEARS),
                linear=LINEARS[i % len(LINEARS)], row=r, col=c,
                x_a=a[r, c].item(), x_b=b[r, c].item(),
                row_mean_abs=b[r].abs().mean().item(),
                bits=int(diff.sum()))
    return drift, None


def check_paths(cfg, params, toks, nxt: int, gpu: str, seed: int = SEED):
    """One prefill chunk and one decode step, kernel path against plain
    path.

    Held per launch: every fused linear and paged attention of the kernel
    path against its plain version on the same inputs (the fused linear
    2e-5 in f32 and 2^-8 in bf16, where the kernel's f32 alpha and the
    reference's bf16-rounded alpha differ by up to 2^-9; attention at
    :data:`FLASH_TOL`), and every fused linear bitwise against the plain
    version summed in the kernel's order (:func:`linear_kernel_order`).

    Held end to end: the kernel path against the plain path with the
    kernel's alpha, run apart, the prefill chunk from a fresh state and the
    decode step from the same state.  A sign binarization turns an
    activation that sits within rounding of zero into the other bit, and
    28 binarized layers amplify one such bit into logits that differ by
    tens of percent.  So: the two paths' fused-linear inputs must track
    each other (relative L2 within 1e-4 in f32, :data:`BF16_TRACK` in
    bf16) at every launch up to and including the first whose sign bits
    differ; where no bit differs, the logits must agree to 1e-3 relative
    L2 in f32 and to :data:`BF16_PATH_LOGITS` in bf16.  In bf16 the paged
    decode kernel's
    one-ulp differences from its plain version travel downstream (the
    second RMSNorm reads the unrounded residual sum, every fused linear's
    f32 alpha reads every element), so bf16 also holds the kernel path
    against the plain path with the kernel's alpha and the kernel's
    attention values at the f32 criteria (1e-3; the linears alone), and
    holds the attention kernel's differences from its plain version to no
    rounding direction: of the n elements where they differ, the number
    above the plain value lies within :data:`BF16_ATTN_Z` standard
    deviations of a fair coin's (sqrt(n) / 2) of n / 2.  The limits come
    from ``python3 chip_smoke.py --path-readings``, which runs this check
    on more prompts and on controls that are within one ulp at every
    launch but round one way.

    Reported (f32): the same walk for the kernel path against the plain
    path with the reference's alpha, and for that plain path against
    itself with every fused linear's output scaled by 1 + 2^-23 (one f32
    ulp), which shows how far one ulp carries."""
    import types
    from unittest import mock

    import torch

    from repro_torch.kernels import cuda, ops, ref
    from repro_torch.kernels import paged_attn as kpaged
    from repro_torch.kernels.xnor_gemm import linear_kernel_order
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm

    f32 = cfg.dtype == torch.float32
    tol_lin = 2e-5 if f32 else 2 ** -8
    rtol_attn, atol_attn = FLASH_TOL["float32" if f32 else "bfloat16"]
    track_tol = 1e-4 if f32 else BF16_TRACK
    logit_tol = 1e-3 if f32 else BF16_PATH_LOGITS
    ref_linear, fused = ref.xnor_linear_fused, ops.xnor_linear_fused
    name = f"{cfg.name} {str(cfg.dtype)[6:]} seed {seed}"

    bs, w = cfg.block_size, 128 // cfg.block_size
    table = torch.arange(1, 1 + 4 * w, dtype=torch.int32,
                         device="cuda").reshape(4, w)
    dtable = table.clone()
    dtable[1:] = 0
    active = torch.tensor([True, False, False, False], device="cuda")
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    tok[0, 0] = nxt
    held = {"xnor_linear_fused": 0, "paged_decode_attention": 0}
    worst = dict.fromkeys(held, 0.0)
    ups = [0, 0, 0]        # attention: above plain, differing, elements
    fails = []

    def attn_held(*args, **kw):
        k = kpaged.paged_decode_attention(*args, **kw)
        with cuda.plain_reference():
            p = kpaged.paged_decode_attention(*args, **kw)
        torch.testing.assert_close(k.float(), p.float(), rtol=rtol_attn,
                                   atol=atol_attn)
        d = k.float() - p.float()
        ups[0] += int((d > 0).sum())
        ups[1] += int((d != 0).sum())
        ups[2] += d.numel()
        held["paged_decode_attention"] += 1
        worst["paged_decode_attention"] = max(
            worst["paged_decode_attention"],
            (k.float() - p.float()).abs().max().item())
        return k

    def attn_kernel_values(*args, **kw):
        """Inside the plain path: the plain version, then the kernel on the
        same inputs, held at FLASH_TOL; the kernel's values go on."""
        p = kpaged.paged_decode_attention(*args, **kw)
        token = cuda._plain.set(False)
        try:
            k = kpaged.paged_decode_attention(*args, **kw)
        finally:
            cuda._plain.reset(token)
        torch.testing.assert_close(k.float(), p.float(), rtol=rtol_attn,
                                   atol=atol_attn)
        return k

    def run(step, state, *, kernel, plain=linear_kernel_order, scale=1.0,
            kernel_attn=False):
        """-> (logits (1, 1, V) f32, state after, fused-linear inputs)."""
        xs = []

        def lin(x, pb, beta, valid_k):
            xs.append(x.float().clone())
            out = fused(x, pb, beta, valid_k)
            if kernel:
                r = ref_linear(x, pb, beta, valid_k)
                torch.testing.assert_close(out, r, rtol=tol_lin, atol=1e-6)
                assert torch.equal(out, linear_kernel_order(
                    x, pb, beta, valid_k)), "fused linear differs from its " \
                    "plain version summed in the kernel's order"
                worst["xnor_linear_fused"] = max(
                    worst["xnor_linear_fused"], (out - r).abs().max().item())
                held["xnor_linear_fused"] += 1
            return out * scale if scale != 1.0 else out

        if state is None:
            state = lm.paged_decode_state_spec(cfg, 4, n_blocks=1 + 4 * w,
                                               block_size=bs, device="cuda")
        else:
            state = lm.DecodeState(state.pos.clone(), [
                type(st)(*(t.clone() for t in st))
                for st in state.seg_states])
        patches = [mock.patch.object(ops, "xnor_linear_fused", lin),
                   mock.patch.object(ref, "xnor_linear_fused", plain)]
        if kernel or kernel_attn:
            patches.append(mock.patch.object(attn_mod, "paged_attn",
                                             types.SimpleNamespace(
                                                 paged_decode_attention=
                                                 attn_held if kernel else
                                                 attn_kernel_values)))
        with contextlib.ExitStack() as stack, torch.inference_mode():
            for pt in patches:
                stack.enter_context(pt)
            if not kernel:
                stack.enter_context(cuda.plain_reference())
            if step == "prefill_chunk":
                logits, state = lm.prefill_chunk_step(
                    cfg, params, toks.cuda(), state, 0, toks.shape[1],
                    {"full": table[:1]}, fresh=True)
            else:
                logits, state = lm.paged_decode_step(
                    cfg, params, tok, state, {"full": dtable}, active=active)
        assert len(xs) == len(LINEARS) * cfg.n_layers, len(xs)
        logits = logits[:1].float()
        assert torch.isfinite(logits).all()
        assert logits.shape == (1, 1, cfg.padded_vocab), logits.shape
        return logits, state, xs

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def walk(step, lk, xk, other, xo, what):
        drift, flip = first_flip(xk, xo)
        r = rel(lk, other)
        print(f"[slice] {name} {step}, kernel path vs {what}, run apart: "
              f"logits relative L2 {r}; inputs tracked within {drift} up to "
              f"the first differing sign bit {flip}  [{gpu}]")
        return drift, flip, r

    start = None                 # the decode step starts from the plain
    for step in ("prefill_chunk", "decode_step"):     # path's prefill state
        lk, _, xk = run(step, start, kernel=True)
        lp, after, xp = run(step, start, kernel=False)
        drift, flip, r = walk(step, lk, xk, lp, xp,
                              "plain path with the kernel's alpha")
        if drift > track_tol:
            fails.append(f"{step}: inputs drifted {drift}")
        if flip is None and r > logit_tol:
            fails.append(f"{step}: no sign bit differs, logits {r}")
        if not f32:
            la, _, xa = run(step, start, kernel=False, kernel_attn=True)
            drift, flip, r = walk(step, lk, xk, la, xa, "plain path with "
                                  "the kernel's alpha and attention values")
            if drift > track_tol:
                fails.append(f"{step}: inputs drifted {drift} (kernel's "
                             f"attention values)")
            if flip is None and r > 1e-3:
                fails.append(f"{step}: no sign bit differs, logits {r} "
                             f"(kernel's attention values)")
        if f32:
            lr, _, xr = run(step, start, kernel=False, plain=ref_linear)
            drift, flip = first_flip(xk, xr)
            print(f"[slice] {name} {step}, kernel path vs plain path with "
                  f"the reference's alpha (reported): logits relative L2 "
                  f"{rel(lk, lr)}; inputs tracked within {drift} up to the "
                  f"first differing sign bit {flip}  [{gpu}]")
            lu, _, xu = run(step, start, kernel=False, plain=ref_linear,
                            scale=1.0 + 2 ** -23)
            drift, flip = first_flip(xu, xr)
            print(f"[slice] {name} {step}, plain path vs itself with every "
                  f"fused linear's output scaled by 1 + 2^-23 (reported): "
                  f"logits relative L2 {rel(lu, lr)}; inputs tracked within "
                  f"{drift} up to the first differing sign bit {flip}  "
                  f"[{gpu}]")
        start = after
    n_lin = len(LINEARS) * cfg.n_layers * 2
    assert held == {"xnor_linear_fused": n_lin,
                    "paged_decode_attention": cfg.n_layers}, held
    print(f"[slice] {name}: {held} launches of one prefill chunk + one "
          f"decode step each held against the plain version on the same "
          f"inputs (the fused linear also bitwise against the plain version "
          f"summed in the kernel's order); max abs err {worst}  [{gpu}]")
    z = (2 * ups[0] - ups[1]) / max(ups[1], 1) ** 0.5
    print(f"[slice] {name}: paged decode differs from its plain version at "
          f"{ups[1]} of {ups[2]} elements, {ups[0]} of them above it (z "
          f"{z} against no rounding direction)  [{gpu}]")
    if not f32 and abs(z) > BF16_ATTN_Z:
        fails.append(f"paged decode rounds one way: {ups[0]} of its "
                     f"{ups[1]} differences lie above the plain version")
    assert not fails, f"{name}: {fails}"


@contextlib.contextmanager
def attention_rounding_up(every: int):
    """A control for :func:`check_paths`: the paged decode "kernel" gives
    its plain version's output moved one ulp toward +inf at every
    ``every``-th element, within one ulp of the plain version at every
    launch but rounding one way."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels import paged_attn as kpaged
    kernel = kpaged.paged_decode_attention

    def attn(*args, **kw):
        if cuda._plain.get():
            return kernel(*args, **kw)
        with cuda.plain_reference():
            p = kernel(*args, **kw)
        step = (p > 0).short() - (p < 0).short()
        if every > 1:
            step[..., 1::every] = 0
        return (p.view(torch.int16) + step).view(p.dtype)

    kpaged.paged_decode_attention = attn
    try:
        yield
    finally:
        kpaged.paged_decode_attention = kernel


def path_readings(gpu: str, n_prompts: int = 12) -> None:
    """The readings behind :func:`check_paths`' bf16 limits: the check on
    full qwen2-7b+xnor in bf16 over the smoke's first prompt and
    ``n_prompts - 1`` seeded ones, with the paged decode kernel as built
    and with two controls that stay within one bf16 ulp of the plain
    version at every launch but round one way (its output moved one ulp
    toward +inf at every element, or at every other element).  Prints each
    run's readings and whether it passed; a control must fail."""
    import numpy as np
    import torch

    import repro_torch.configs as configs
    from repro_torch.models import lm
    from repro_torch.serve import synthetic_trace

    cfg = configs.get("qwen2-7b+xnor")
    params = lm.pack_params(cfg, lm.init_params(cfg, SEED, device="cuda"))
    base = synthetic_trace(8, cfg.vocab, seed=SEED,
                           prompt_lens=(8, 16, 24, 32),
                           new_tokens=(8, 12, 16))
    prefix = np.random.default_rng([SEED, 0xC1A]).integers(
        0, cfg.vocab, size=32).astype(np.int32)
    prompts = [np.concatenate([prefix, base[0].prompt])]
    rng = np.random.default_rng([SEED, 0xBF16])
    prompts += [rng.integers(0, cfg.vocab, size=cfg.prefill_chunk + 1)
                .astype(np.int32) for _ in range(n_prompts - 1)]
    for label, every in (("kernel", 0), ("one ulp up, every element", 1),
                         ("one ulp up, every other element", 2)):
        for i, p in enumerate(prompts):
            toks = torch.from_numpy(p[None, :cfg.prefill_chunk].copy())
            t0 = time.perf_counter()
            try:
                with (attention_rounding_up(every) if every else
                      contextlib.nullcontext()):
                    check_paths(cfg, params, toks,
                                int(p[cfg.prefill_chunk]), gpu)
                verdict = "passed"
            except AssertionError as e:
                verdict = f"FAILED {e}"
            print(f"[readings] {label}, prompt {i}: {verdict} "
                  f"({time.perf_counter() - t0} s)", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda

    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    first, _FIRST["lib"] = start_first_design_build()
    cuda.build()
    for name in cuda.ENTRY_POINTS:
        cuda.fn(name)
    first_log, _ = first.communicate()
    assert first.returncode == 0, f"nvcc failed for {FIRST_GEMM}:\n{first_log}"
    print(f"kernels built and loaded in {time.perf_counter() - t0} s "
          f"(nvcc {cuda.build_seconds()} s)")
    for line in cuda.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    for source in ("flash_attn", "paged_attn", "xnor_linear", "xnor_gemm"):
        for row in ptxas_summary(cuda.build_log(), source):
            print(f"[ptxas] {source}.cu {row}")
    print(f"[sass] flash_attn: {sass_counts(cuda.build()['flash_attn'])}")
    if sys.argv[1:] == ["--path-readings"]:
        path_readings(gpu)
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 products
    torch.backends.cudnn.allow_tf32 = False         # stay f32 on the card
    rec = kernel_checks(gpu)
    paged_long(gpu)
    rec.update(integer_kernel_checks(gpu, LINEAR_SHAPES))
    rec.update(flash_checks(gpu))
    launches = serve_slice(gpu)
    launches.update(integer_chain(gpu))
    launches["xnor_gemm"] = binary_layers(gpu, LINEAR_SHAPES)["xnor_gemm"]
    launches.update(long_context(gpu))
    checkpoint_layer(gpu)
    monte_carlo(gpu)
    kernels = []
    for key in ("pack", "xnor_linear_fused", "paged_decode_attention",
                "xnor_gemm", "bulk_xor", "parity_digest", "xor_cipher",
                "flash_attention"):
        r = dict(rec[key])
        r["launches"] = launches[key]
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
