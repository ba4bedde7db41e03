#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                    # the run below
    python3 chip_smoke.py --path-readings [ARCH]   # the readings behind
                                             # the limits of check_paths
                                             # (qwen2-7b+xnor by default,
                                             # recurrentgemma-2b+xnor,
                                             # moonshot-v1-16b-a3b+xnor or
                                             # llama-3.2-vision-11b+xnor)
    python3 chip_smoke.py --moe              # phase 2's MoE shapes and
                                             # phase 3d alone
    python3 chip_smoke.py --vlm              # phase 2's context-arch
                                             # shapes and phase 3e alone
    python3 chip_smoke.py --xlstm            # phase 2's xlstm-350m and
                                             # xnor-cnn shapes, the xLSTM
                                             # H2 probe and phase 3f alone
    python3 chip_smoke.py --train            # phase 9 alone: training,
                                             # transcribe and classify
    python3 chip_smoke.py --mesh             # phase 10 alone: the mesh
    python3 chip_smoke.py --slot-bits        # fault F4's probe: whether a
                                             # slot's bits hang on the batch
    python3 chip_smoke.py --paged-plans      # paged decode at W 2048, the
                                             # fixed split plan against a
                                             # batch-sized one, B 1 to 32
    python3 chip_smoke.py --roofline         # phase 11 alone, on phase
                                             # 3's engine built alone

Phases (any failure raises and the script exits non-zero):

1. Environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, and the build of the eight kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
   the registers, static shared memory and spills
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
   its plain version, and held at long K and tall M (Kw > 7264,
   M > 524280).
   The fused XNOR linear at each qwen2-7b linear shape, M = 4 and 32, held
   bitwise against its plain version summed in the kernel's order, and one
   decode step's 196 fused linears (7 a layer x 28) timed as one CUDA
   graph beside their byte bound.  Times come from CUDA events over many
   launches, rotating through enough input copies to exceed the 50 MB L2
   cache where the path finds its data cold.  The other ported archs
   (``other_arch_kernels``): the fused linear at recurrentgemma-2b's,
   phi4-mini's and qwen3-14b's shapes, M 4 and 32, bitwise in the
   kernel's order, and one recurrentgemma decode step's 200 fused linears
   as a CUDA graph; paged decode at recurrentgemma's local geometry (B 4,
   KV 1, G 10, dh 256, bs 16, a 130-column ring at window 2048) in bf16,
   f32 and int8, held and timed against its byte bound, SDPA on gathered
   K/V and the plain version, at G 9-16 x dh 256, and at phi4-mini's and
   qwen3-14b's geometry.  The MoE archs (``moe_arch_kernels``): the fused
   linear at moonshot-v1-16b-a3b's (2048 -> 2048) and llama4-scout's
   shapes, M 4 and 32, bitwise in the kernel's order, and one moonshot
   decode step's 192 fused linears as a CUDA graph; paged decode at
   moonshot's geometry (B 4, KV 16, G 1, dh 128, bs 16) over W 8 and
   W 2048 in bf16, f32 and int8, held and timed against its byte bound,
   SDPA and the plain version.  The context archs (``vlm_arch_kernels``):
   the fused linear at llama-3.2-vision-11b's and whisper-tiny's shapes,
   M 4 and 32 and, where a linear reads a context, M 1,600 (the cross
   layers' wk/wv) and M 1,500 (the encoder), bitwise in the kernel's
   order; llama's M 4 and M 1,600 timed against their bounds; one
   llama-3.2-vision decode step's 264 fused linears (7 a layer x 32 attn
   + 5 a layer x 8 cross) as a CUDA graph; hazard H2's probe of decode
   cross-attention (the batched form against each slot alone, reported;
   the port's per-slot form held equal to itself at a batch of one);
   paged decode at llama's
   (KV 8, G 4, dh 128) and whisper's (KV 6, G 1, dh 64) geometry over
   W 8 and W 2048 in bf16, f32 and int8, held and timed against its byte
   bound, SDPA and the plain version.  xlstm-350m and xnor-cnn
   (``xlstm_arch_kernels``): the fused linear at their shapes (the
   sLSTM's K 1,344 = 42 words, xnor-cnn's K 64), M 4 and 32, bitwise in
   the kernel's order, each timed at M 4; one xlstm decode step's 135
   fused linears and one xnor-cnn step's 4 as CUDA graphs; hazard H2's
   probe of the mLSTM's and sLSTM's decode at full width, 1 to 8 slots,
   output rows and states bitwise against each slot alone (a gate).
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
3b. The rest of the serving tier on phase 3's model and
   trace (``serving_tier``): a 2-replica Router with the kill drill
   against one engine at temperature 0.8, encrypted migration wires and
   the integrity scrubber with a flipped-word control; cross-slot
   migration; the slot-dense layout and ``generate_static`` against the
   paged engine in f32.  Its five kernels are held against their plain
   versions at every shape the phase gives them (``LaunchHolds``: every
   paged decode launch, the first 28 of each shape of the others), but
   for one timed run each of the engine and the Router, which must repeat
   the held runs' tokens at shapes that were held.
3c. RecurrentGemma (``recurrent_serving``): full-width, full-depth
   recurrentgemma-2b+xnor (18 rglru + 8 local layers) in bf16, packed at
   load, a 4-slot paged ServeEngine (block 16, chunk 32, prefix caching
   off) over phase 3's 8 requests and one of 2,100 prompt tokens, which
   wraps the 2,048-token window ring.  Every launch of pack, the fused
   linear and paged decode in one run held against its plain version at
   every shape (``LaunchHolds``), an unheld timed run repeating its
   tokens (tok/s, TTFT, peak memory, 200 + 8 launches per decode step);
   the long session migrated mid-decode 4 -> 2 slots through an encrypted
   wire (ring blocks, f32 ``h``, bf16 conv buffer) keeping its tokens;
   ``check_paths`` in bf16 at this arch's limits and f32, with the
   one-ulp-up control failing; f32 dense = paged on the short requests.
3d. Mixture of experts (``moe_serving``, ``llama4_serving``): full-width,
   full-depth moonshot-v1-16b-a3b+xnor (48 moe layers, 64 experts of
   d_ff 1408, top-6; 56 GB of bf16 weights, the attention packed at
   load), a 4-slot paged ServeEngine (block 16, chunk 32, s_max 128,
   prefix caching on) over phase 3's 8 requests with every launch held
   (``LaunchHolds``), an unheld timed run repeating its tokens (tok/s,
   TTFT, peak memory, 192 + 48 launches per decode step); with the prefix
   cache off (a hit changes the dispatch groups), a 2-slot engine
   repeating a 4-slot one's tokens and a session migrated 4 -> 2 slots
   through an encrypted wire,
   ``check_paths`` in bf16 at this arch's limits (a differing expert
   choice ends the walk as a differing sign bit does) with the control
   failing and in f32 at 8 of the 48 layers (the f32 tree does not fit);
   then llama4-scout-17b-a16e+xnor at full width and 4 of 48 layers, a
   2-slot and a 1-slot engine over 4 requests, every launch held, the
   same tokens.
3e. The context archs (``whisper_serving``, ``vlm_serving``; the
   engine gates of ``ctx_serving``): full-width, full-depth
   whisper-tiny+xnor (a 4-layer encoder over 1,500 frames, 4 dec layers,
   each request's frames encoded once at admission) and
   llama-3.2-vision-11b+xnor (40 layers, 8 of them cross, over 1,600 x
   4,096 patch embeddings a request; 18.6 GiB of bf16 weights), packed at
   load, each served by a 4-slot paged ServeEngine (block 16, chunk 32,
   s_max 128, prefix caching on) over phase 3's 8 requests with a seeded
   context each, the shared-prefix half sharing one (``ctx_trace``):
   every launch of pack, the fused linear and paged decode held
   (``LaunchHolds``), a 2-slot engine with the same tokens, an unheld
   timed run repeating them (tok/s, TTFT, peak memory; 36 + 4 and 264 +
   32 launches every decode step), a session migrated mid-decode 4 -> 2
   slots through an encrypted wire carrying its context and per-slot
   ``ctx_kv``, held then unheld; whisper in f32 dense = paged (4 and 2
   slots) = ``generate_static``; llama-vision's ``check_paths`` in bf16 at its
   limits with the control failing, and in f32 at full depth (a 39 GB
   tree).
3f. xLSTM and the paper's classifier (``xlstm_serving``,
   ``xnor_cnn_serving``): full-width, full-depth xlstm-350m+xnor (21
   ``mlstm`` + 3 ``slstm`` layers, d 1024, the mLSTM's 4 x 512 x 512 f32
   memory a slot a layer; no pool, so no prefix cache), packed at load,
   a 4-slot ServeEngine (chunk 32, s_max 128) over phase 3's 8 requests:
   every launch held (``LaunchHolds``), a 2-slot engine with the same
   tokens, two unheld timed runs repeating them (tok/s, TTFT, peak
   memory, 135 fused linears every decode step), a session migrated
   mid-decode 4 -> 2 slots through an encrypted wire of its per-slot
   state (84 MiB of f32 memory), held then unheld; in f32 dense = paged
   on 8 prompts of one prefill chunk (the agreement on phase 3's trace,
   whose prompts the two layouts chunk differently, printed).  Then
   xnor-cnn (2 ``bindense`` layers, f32): 12 stripe images drawn on the
   card with ``bcnn.synthetic_images``, each a one-token request with its
   pixel bands as context: every launch held, the 2-slot engine's and
   the plain path's classes equal to the 4-slot kernel path's, prefill
   logits within 1e-4 of the plain path's.
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
7. The checkpoint layer on the card through one CimEngine, over the bf16
   qwen2-7b tree at full width, cut to 4 of its 28 layers (4.1 GB, to
   keep the script near 600 s): an encrypted, write-verified
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

9. Training, then the workloads on top of it (``training``, run last):
   9a 20 ``train_step``s of qwen2-7b+xnor, bf16, at full width and 4 of
   its 28 layers (2.02 B parameters; the full-depth state needs
   sharding) on ``synthetic.Pipeline`` batches of 4 x 256 tokens, peak
   lr 1e-3, warmup 10, per-layer remat: loss and gnorm finite every step
   and the reference test's learning gate; median step, tokens/s, peak
   memory, model FLOP/s printed.  9b the same seed, config and batches
   at smoke size in f32 on the card and the CPU, 3 steps, each from the
   CPU's state: loss, gnorm, gradients and parameters within the CPU
   tests' tolerances.  9c the ``Runner`` drill on full whisper-tiny+xnor
   (4 enc + 4 dec layers over 1,500-frame contexts): 20 straight steps
   against 10 with encrypted saves every 5, the newest checkpoint
   truncated (the runner falls back to step 5), a resume and the steps
   to 20, at the reference test's restart tolerances, every
   ``parity_digest`` and ``xor_cipher`` launch held.  9d
   ``TranscriptionService`` on whisper-tiny+xnor at T 0.8, 3 streams x 2
   windows: 1 slot = 4 slots, every launch of pack, the fused linear and
   paged decode held, tok/s of an unheld run.  9e ``ClassifierService``:
   ``train_classifier`` 150 steps on the card, train accuracy >= 0.95,
   served accuracy >= 0.9 on 32 held-out images, packed = float-sign
   classes, every launch held.  Each sub-phase's seconds are printed.

10. The mesh (``mesh_phase``, run last), ranks spawned over gloo on the
   one card (``launch.mesh.run_ranks``; NCCL refuses two ranks on one
   GPU).  10a ``ShardedCimEngine`` at 4 ranks (axis ``bank``): the
   reference's 20-case property sweep (sizes to 200,000 words, digest
   widths 32/96/128/256, counters) and its edges in the global form, and
   a 4 GB buffer, 1 GB a rank, in the local form; xor, xnor, the cipher
   and its round trip, digests and digest rows bitwise equal to the
   single-device ``CimEngine`` on the card (its outputs over the whole
   buffer cut to each rank's chunk); every launch of ``bulk_xor``,
   ``parity_digest`` and ``xor_cipher`` held bitwise against its plain
   version; GB/s a rank per pass (unheld, the 4 ranks at once) and the
   bytes that crossed ranks (the digests).  10b the sharded train step:
   qwen2-7b+xnor, bf16, full width, ``MESH_LAYERS`` of 28 layers (the
   deepest two ranks fit on the card after phases 1-9), batch
   4 x 256, 2 ranks on ``data`` with ZeRO-3 blocks of the parameters and
   both moments; two steps, each held against the single-process step
   from the same state on the card (rank 0 alone, then freed: step 0
   from the seed, step 1 from the sharded state after step 0 made whole)
   at the CPU tests' bf16 tolerances: loss and ce, gnorm, every rank's
   gradient blocks, and its parameter blocks where AdamW's move is
   settled; each rank's state bytes, peak memory and host seconds inside
   the collectives.  10c ``grad_compress="onebit_pod"`` at 2 ranks on ``pod``
   (``MESH_ONEBIT_LAYERS`` layers): one step bit for bit against the
   plain composition (each pod's unsharded gradients, the majority vote
   written out, AdamW), and the bytes of sign planes that crossed.  A
   rank that fails fails the script.

11. The roofline and the dry-run against the card (``roofline_phase``,
   run after 3b on phase 3's drained engine): the datasheet constants of
   ``roofline.analysis`` and ``paged_attn.H100_SMS`` against the card;
   ``ServeEngine.decode_roofline`` (one decode step traced on ``meta``)
   against one real step at 4 slots: its launches of the fused linear and
   paged decode equal to the wrappers' counts (196 and 28), its dispatches
   printed beside the step's CUDA kernel launches, the step's device busy
   time at least the byte floor at HBM's rate; the dry-run of 9a's and
   10b's cells in this process beside their readings, 10b's state bytes a
   rank exactly the shard's.

The line before the last is a JSON object listing every ported kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
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


def plain_step_ms(fn, calls) -> float:
    """Device-clock ms of ``fn``'s plain version over ``calls`` in order,
    one pass after a warm-up call, timed with CUDA events (the plain
    path's many small launches are not captured in a graph)."""
    import torch

    from repro_torch.kernels import cuda
    with cuda.plain_reference():
        fn(*calls[0])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for a in calls:
            fn(*a)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end)


def copies(make, nbytes: int):
    """Enough independent input sets to exceed the L2 cache."""
    n = max(2, -(-2 * L2_BYTES // max(nbytes, 1)))
    return [make() for _ in range(min(n, 512))]


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """-> (the least ms the card could take for a launch's work, "bytes" or
    "operations"): the larger of its bytes over HBM's rate and its
    operations over their peak, ``roofline.analysis``'s datasheet figures.
    Called on a wrapper's ``cost``."""
    from repro_torch.roofline.analysis import HBM_BW, PEAK_OPS
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bytes_ms(nbytes: float) -> float:
    """ms to move ``nbytes`` at HBM's datasheet rate."""
    from repro_torch.roofline.analysis import HBM_BW
    return nbytes / HBM_BW * 1e3


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
    sets = copies(lambda: (randn(n, k, dtype=torch.bfloat16),), n * k * 2)
    ms = time_ms(kpack.pack, sets, 50)
    with cuda.plain_reference():
        plain = time_ms(kpack.pack, sets[:2], 2, 2)
    b_ms, b_by = bound(*kpack.cost(n, k))
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
            b_ms, b_by = bound(*kxnor.linear_cost(m, n, k))
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
    b_ms, b_by = bound(*kpaged.cost(B, KV, G, dh, bs, W, 2, 2, live,
                                    int((pos_main + 1).sum())))
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
            nbytes += kxnor.linear_cost(4, n, k).bytes
    step = time_ms(kxnor.xnor_linear_fused, calls, len(calls), 5) * len(calls)
    b_ms = bytes_ms(nbytes)
    plain = plain_step_ms(kxnor.xnor_linear_fused, calls)
    print(f"[xnor_linear_fused decode step] {len(calls)} launches (7 a layer "
          f"x 28, M = 4) in one CUDA graph: {step} ms, bound {b_ms} ms "
          f"({step / b_ms} x); the plain version {plain} ms  [{gpu}]")
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
    cost = kpaged.cost(B, KV, G, dh, bs, W, 2, 2, live, int((pos + 1).sum()))
    nbytes = cost.bytes
    b_ms, b_by = bound(*cost)
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


def slot_bits(gpu: str) -> None:
    """Fault F4's probe: whether a slot's bits hang on the batch.  Each
    row-coupled op of a moonshot-v1-16b-a3b+xnor decode step (full width,
    one layer's weights), every row at B 2 to 32 against its bits alone;
    then :func:`engine_bits`."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.models import layers, lm
    from repro_torch.models import moe as moe_mod

    cfg = dataclasses.replace(configs.get("moonshot-v1-16b-a3b+xnor"),
                              n_layers=1)
    params = lm.init_params(cfg, SEED, device="cuda")
    # each row-coupled op alone: every row at B 2..32 against it alone, f32
    # rows that are not bf16 values (a bf16 value's square is exact in f32,
    # and sums of them hide a changed order)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)
    d = cfg.d_model
    x = torch.randn((32, 1, d), generator=g, device="cuda")
    lay = {k: v[0] for k, v in params["seg0_moe"].items()}
    moe_p = {k[4:]: v for k, v in lay.items() if k.startswith("moe_")}
    cands = {
        "torch sum of squares": lambda x: (x * x).sum(-1),
        "row_sum of squares": lambda x: layers.row_sum(x, square=True),
        "rms_norm": lambda x: layers.rms_norm(x, lay["ln2"],
                                              dtype=cfg.dtype),
        "router product (cuBLAS)": lambda x: torch.matmul(
            x, lay["moe_router"]),
        "route at decode": lambda x: moe_mod.route(
            cfg, lay["moe_router"], x.to(cfg.dtype)).probs,
        "lm head bf16": lambda x: torch.matmul(
            x.to(cfg.dtype), params["embed"]["lm_head"]),
        "moe_ffn": lambda x: moe_mod.moe_ffn(cfg, moe_p, x.to(cfg.dtype))[0],
    }
    with torch.inference_mode():
        for name, fn in cands.items():
            alone = [fn(x[j:j + 1]) for j in range(32)]
            bad = [b for b in (2, 3, 4, 8, 15, 16, 17, 32)
                   if not all(torch.equal(r[None], alone[j])
                              for j, r in enumerate(fn(x[:b].contiguous())))]
            print(f"[slot-bits] {name}: some row differs from its bits alone "
                  f"at B {bad}  [{gpu}]")
    del params
    torch.cuda.empty_cache()
    engine_bits(gpu)


def engine_bits(gpu: str, n_layers: int = 48, steps: int = 8) -> None:
    """F4's probe at the engine: full-width moonshot-v1-16b-a3b+xnor at
    ``n_layers`` layers served over phase 3's trace by a 4-slot and a
    2-slot paged engine (prefix cache off), and the 2-slot one twice; every
    prefill chunk's and decode step's logits recorded per (request, chunk
    or token), and in the first ``steps`` engine steps every layer
    function's output row of each decoding request; prints where each
    pair of runs first parts, and the first op that differs there."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attn as kpaged
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers, lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(configs.get("moonshot-v1-16b-a3b+xnor"),
                              n_layers=n_layers)
    params = lm.init_params(cfg, SEED, device="cuda")
    trace = slice_trace(cfg.vocab)
    sites = [(layers, "rms_norm"), (layers, "apply_rope"),
             (layers, "logits"), (attn_mod, "paged_attention"),
             (kpaged, "paged_decode_attention"), (ops, "xnor_linear_fused"),
             (moe_mod, "route"), (moe_mod, "experts"), (moe_mod, "combine"),
             (moe_mod, "moe_ffn")]

    def row(name, out, slot):
        if name == "route":
            return torch.cat([out.probs[slot].flatten(),
                              out.idx[slot].flatten().float()])
        if name == "experts":
            return out[:, slot]
        if isinstance(out, tuple):
            out = out[0]
        return out[slot]

    def run(slots):
        eng = ServeEngine(cfg, params, slots=slots, s_max=128,
                          prefix_cache=False, device="cuda")
        rec, ops_rec, step, live = {}, {}, [0], {}
        chunk, decode = lm.prefill_chunk_step, lm.paged_decode_step
        orig = {(m, f): getattr(m, f) for m, f in sites}

        def chunk_rec(*a, **k):
            logits, st = chunk(*a, **k)
            slot = a[4]
            sess = eng.pool.active[slot]
            j = eng._prefilling[slot].next_chunk
            rec[("chunk", sess.request.rid, j)] = (step[0], logits[0].float()
                                                   .clone())
            return logits, st

        def decode_rec(*a, **k):
            live.clear()
            if step[0] < steps:
                live.update({slot: ("token", sess.request.rid,
                                    len(sess.tokens))
                             for slot, sess in eng.pool.active.items()
                             if slot not in eng._prefilling})
            logits, st = decode(*a, **k)
            live.clear()
            for slot, sess in eng.pool.active.items():
                if slot not in eng._prefilling:
                    rec[("token", sess.request.rid, len(sess.tokens))] = (
                        step[0], logits[slot].float().clone())
            return logits, st

        def wrap(f, fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                for slot, key in live.items():
                    ops_rec.setdefault(key, []).append(
                        (f, row(f, out, slot).float().clone()))
                return out
            wrapped.__dict__ = fn.__dict__     # one launch count
            return wrapped
        lm.prefill_chunk_step, lm.paged_decode_step = chunk_rec, decode_rec
        for (m, f), fn in orig.items():
            setattr(m, f, wrap(f, fn))
        try:
            for r in trace:
                eng.submit(r)
            while eng.step():
                step[0] += 1
        finally:
            lm.prefill_chunk_step, lm.paged_decode_step = chunk, decode
            for (m, f), fn in orig.items():
                setattr(m, f, fn)
        return rec, ops_rec

    runs = {"4 slots": run(4), "2 slots": run(2), "2 slots again": run(2)}
    for x, y in (("4 slots", "2 slots"), ("2 slots", "2 slots again")):
        (a, oa), (b, ob) = runs[x], runs[y]
        keys = sorted(set(a) & set(b), key=lambda k: (k[1], k[0], k[2]))
        bad = [(k, a[k][0], b[k][0], int((a[k][1] != b[k][1]).sum()))
               for k in keys if not torch.equal(a[k][1], b[k][1])]
        first = {}
        for k, sa, sb, n in bad:
            first.setdefault(k[1], (k, sa, sb, n))
        print(f"[slot-bits] engines at {n_layers} layers, {x} against {y}: "
              f"{len(keys)} logits rows compared, {len(bad)} differ; the "
              f"first a request ((kind, rid, index), step there, step "
              f"here, elements) {sorted(first.values())}  [{gpu}]")
        for k, *_ in sorted(first.values()):
            if k in oa and k in ob:
                d = [(i, na, int((ta != tb).sum()), ta.numel())
                     for i, ((na, ta), (nb, tb)) in enumerate(
                         zip(oa[k], ob[k]))
                     if na != nb or not torch.equal(ta, tb)]
                print(f"[slot-bits]   {k}: {len(oa[k])} op rows, the first "
                      f"differing (record, op, elements, of) {d[:6]}  "
                      f"[{gpu}]")
    del params, runs
    torch.cuda.empty_cache()


def paged_plans(gpu: str, batches=(1, 4, 16, 32)) -> None:
    """``--paged-plans``: paged decode at W = 2048 (qwen2-7b's decode
    geometry, bf16) at each batch, with the split plan sized for
    ``PLAN_SLOTS`` slots whatever the batch (the port's) and with a plan
    sized for the launch's batch (before the plan was fixed), each held
    against the plain version at one bf16 ulp, timed and printed beside
    the byte bound.  Slots sit at positions 32767, 24575, 16383, 8191 in
    turn."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels import paged_attn as kpaged

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    KV, G, dh, bs, W = 4, 7, 128, 16, 2048
    scale = dh ** -0.5
    rtol, atol = FLASH_TOL["bfloat16"]
    fixed = kpaged.PLAN_SLOTS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in batches:
        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
        q = randn(b, KV, G, dh)
        ck, cv = randn(1 + b * W, KV, bs, dh), randn(1 + b * W, KV, bs, dh)
        table = (torch.randperm(b * W, generator=g, device=dev) + 1
                 ).reshape(b, W).to(torch.int32)
        pos = torch.tensor([32767 - 8192 * (i % 4) for i in range(b)],
                           dtype=torch.int32, device=dev)
        args = (q, ck, cv, table, pos)
        with cuda.plain_reference():
            pp = kpaged.paged_decode_attention(*args, scale=scale)
        live = int((pos // bs + 1).sum())
        b_ms, b_by = bound(*kpaged.cost(b, KV, G, dh, bs, W, 2, 2, live,
                                        int((pos + 1).sum())))
        row = {}
        for label, slots in (("fixed", fixed), ("batch", b)):
            kpaged.PLAN_SLOTS = slots
            try:
                kk = kpaged.paged_decode_attention(*args, scale=scale)
                torch.testing.assert_close(kk.float(), pp.float(),
                                           rtol=rtol, atol=atol)
                ms = time_ms(lambda *a: kpaged.paged_decode_attention(
                    *a, scale=scale), [args], 20)
                row[label] = (kpaged.split_plan(W, KV, sms), ms)
            finally:
                kpaged.PLAN_SLOTS = fixed
        print(f"[paged plans] bf16 B={b} KV={KV} G={G} dh={dh} bs={bs} W={W}"
              f": plan (n_split, cols) {row['fixed'][0]} for {fixed} slots "
              f"{row['fixed'][1]} ms; plan for the batch {row['batch'][0]} "
              f"{row['batch'][1]} ms; bound {b_ms} ms ({b_by})  [{gpu}]",
              flush=True)
        del q, ck, cv, args, pp, kk
        torch.cuda.empty_cache()


# the other ported archs' linear shapes (N, K), in launch order per kind
OTHER_LINEARS = {
    "recurrentgemma-2b": {"d x d": (2560, 2560), "wk/wv": (256, 2560),
                          "w1/w3": (7680, 2560), "w2": (2560, 7680)},
    "phi4-mini-3.8b": {"d x d": (3072, 3072), "wk/wv": (1024, 3072),
                       "w1/w3": (8192, 3072), "w2": (3072, 8192)},
    "qwen3-14b": {"d x d": (5120, 5120), "wk/wv": (1024, 5120),
                  "w1/w3": (17408, 5120), "w2": (5120, 17408)}}
RG_SHAPE = {"w_gate": "d x d", "w_x": "d x d", "w_r": "d x d",
            "w_i": "d x d", "w_out": "d x d", "wq": "d x d", "wo": "d x d",
            "wk": "wk/wv", "wv": "wk/wv", "w1": "w1/w3", "w3": "w1/w3",
            "w2": "w2"}
# recurrentgemma-2b's local attention at decode: B 4, KV 1, G 10, dh 256,
# bs 16, a 130-column ring (window 2048 + a 32-token chunk - 1)
RG_PAGED = dict(b=4, kv=1, g=10, dh=256, bs=16, w=130, window=2048)


def other_arch_kernels(gpu: str) -> dict:
    """Phase 2 for the archs beside qwen2-7b: the fused linear at each of
    recurrentgemma-2b's, phi4-mini's and qwen3-14b's shapes, M 4 and 32,
    bitwise in the kernel's order (recurrentgemma's timed at M 4 beside
    its byte bound), and one recurrentgemma decode step's 200 fused
    linears as one CUDA graph; paged decode at recurrentgemma's local
    geometry in bf16, f32 and int8 (held, timed past L2 against its byte
    bound, SDPA on K/V already gathered and the plain version), at G 9-16
    x dh 256 (bf16, f32, int8; monotone and ring), and at phi4-mini's and
    qwen3-14b's decode geometry.  -> the recurrentgemma paged decode
    reading."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.core import xnor_layers
    from repro_torch.kernels import cuda
    from repro_torch.kernels import paged_attn as kpaged
    from repro_torch.kernels import xnor_gemm as kxnor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 18)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def both(fn, *args, **kw):
        k = fn(*args, **kw)
        with cuda.plain_reference():
            p = fn(*args, **kw)
        torch.cuda.synchronize()
        return k, p

    # -- the fused linear at the other archs' shapes -------------------------
    for arch, shapes in OTHER_LINEARS.items():
        row = {}
        for name, (n, k) in shapes.items():
            pb, beta = xnor_layers.pack_weights(randn(n, k,
                                                      dtype=torch.bfloat16))
            for m in (4, 32):
                for dt in (torch.float32, torch.bfloat16):
                    x = randn(m, k, dtype=dt)
                    kk, pp = both(kxnor.xnor_linear_fused, x, pb, beta, k)
                    assert torch.equal(kk, kxnor.linear_kernel_order(
                        x, pb, beta, k)), f"{arch} {name} M={m} {dt}"
                    f32 = dt == torch.float32
                    torch.testing.assert_close(
                        kk, pp, rtol=2e-5 if f32 else 2 ** -8,
                        atol=2e-5 if f32 else 1e-6)
            if arch == "recurrentgemma-2b":
                kw = pb.shape[1]
                sets = copies(lambda: (randn(4, k, dtype=torch.bfloat16),
                                       *xnor_layers.pack_weights(
                                           randn(n, k, dtype=torch.bfloat16)),
                                       k), n * kw * 4)
                ms = time_ms(kxnor.xnor_linear_fused, sets, 200)
                b_ms, b_by = bound(*kxnor.linear_cost(4, n, k))
                row[name] = dict(N=n, K=k, ms=ms, bound_ms=b_ms)
                del sets
        print(f"[xnor_linear_fused {arch}] held bitwise in the kernel's "
              f"order at {list(shapes.values())} (N, K), M 4 and 32, f32 "
              f"and bf16" + (f"; bf16 M=4 timings {json.dumps(row)}"
                             if row else "") + f"  [{gpu}]")

    # one recurrentgemma decode step: 18 rglru layers x 8 linears and 8
    # local layers x 7, each layer its own weights, M = 4, one CUDA graph
    cfg = configs.get("recurrentgemma-2b+xnor")
    calls, nbytes = [], 0
    for kind in cfg.layer_kinds():
        for lin in KIND_LINEARS[kind]:
            n, k = OTHER_LINEARS["recurrentgemma-2b"][RG_SHAPE[lin]]
            pb, beta = xnor_layers.pack_weights(
                randn(n, k, dtype=torch.bfloat16))
            calls.append((randn(4, k, dtype=torch.bfloat16), pb, beta, k))
            nbytes += kxnor.linear_cost(4, n, k).bytes
    assert len(calls) == 200, len(calls)
    step = time_ms(kxnor.xnor_linear_fused, calls, len(calls), 5) * len(calls)
    b_ms = bytes_ms(nbytes)
    plain = plain_step_ms(kxnor.xnor_linear_fused, calls)
    print(f"[xnor_linear_fused recurrentgemma decode step] {len(calls)} "
          f"launches (8 a rglru layer x 18, 7 a local layer x 8, M = 4) in "
          f"one CUDA graph: {step} ms, bound {b_ms} ms ({step / b_ms} x); "
          f"the plain version {plain} ms  [{gpu}]")
    del calls
    torch.cuda.empty_cache()

    # -- paged decode ----------------------------------------------------------
    def case(b, kv, gq, dh, bs, w, dtype, i8):
        q = randn(b, kv, gq, dh, dtype=dtype)
        ck, cv = randn(1 + b * w, kv, bs, dh), randn(1 + b * w, kv, bs, dh)
        if i8:
            ck = torch.clamp(torch.round(ck * 32), -127, 127).to(torch.int8)
            cv = torch.clamp(torch.round(cv * 32), -127, 127).to(torch.int8)
        else:
            ck, cv = ck.to(dtype), cv.to(dtype)
        table = (torch.randperm(b * w, generator=g, device=dev) + 1
                 ).reshape(b, w).to(torch.int32)
        return q, ck, cv, table

    def held(args, window, i8, dtype):
        dh = args[0].shape[-1]
        sc, osc = ((dh ** -0.5) / 32, 1 / 32) if i8 else (dh ** -0.5, 1.0)
        kk, pp = both(kpaged.paged_decode_attention, *args, window=window,
                      scale=sc, out_scale=osc)
        rtol, atol = FLASH_TOL[str(dtype)[6:]]
        torch.testing.assert_close(kk.float(), pp.float(), rtol=rtol,
                                   atol=atol)
        return (kk.float() - pp.float()).abs().max().item()

    edges = {}
    for gq in range(9, 17):
        for dtype, i8 in ((torch.bfloat16, False), (torch.float32, False),
                          (torch.bfloat16, True)):
            for w, window, p in ((8, 0, [127, 0, 64, 17]),
                                 (130, 2048, [2099, 3000, 45, 2048])):
                args = (*case(4, 1, gq, 256, 16, w, dtype, i8),
                        torch.tensor(p, dtype=torch.int32, device=dev))
                edges[gq] = max(edges.get(gq, 0.0),
                                held(args, window, i8, dtype))
    others = {}
    for arch in ("phi4-mini-3.8b", "qwen3-14b"):
        c = configs.get(arch)
        for dtype in (torch.bfloat16, torch.float32):
            args = (*case(4, c.n_kv_heads, c.q_per_kv, c.d_head, 16, 16,
                          dtype, False),
                    torch.tensor([255, 100, 17, 0], dtype=torch.int32,
                                 device=dev))
            others[f"{arch} {str(dtype)[6:]}"] = held(args, 0, False, dtype)
    print(f"[paged_decode_attention] held against the plain version: G 9-16 "
          f"x dh 256 edges (bf16, f32, int8; monotone W 8 and ring W 130) "
          f"{edges}; phi4-mini / qwen3-14b geometry {others}  [{gpu}]")
    r = RG_PAGED
    return paged_readings(gpu, "recurrentgemma", r, r["w"],
                          [2099, 4000, 2047, 700], randn, g,
                          window=r["window"])["bfloat16"]


LEAF_WORDS = 28 * 3584 * 3584 // 2   # a layer-stacked wq leaf, bf16 words
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

    def row(name, src, replaces, ms, plain, cost, lib):
        b_ms, b_by = bound(*cost)
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{src}",
                    replaces=replaces, max_abs_err=0.0, ms=ms,
                    plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib)

    rec = {}
    # -- xnor_gemm: quickstart, XNOR-CNN, every qwen2-7b linear, ragged --
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
        sets = copies(lambda: (planes(m, k), planes(n, k), k), n * kw * 4)
        ms = time_ms(kxnor.xnor_gemm, sets, 200)
        with cuda.plain_reference():
            plain = time_ms(kxnor.xnor_gemm, sets[:2], 2, 2)
        r = row("xnor_gemm", "xnor_gemm.cu", "src/repro/kernels/xnor_gemm.py:80",
                ms, plain, kxnor.gemm_cost(m, n, kw, k), None)
        print(f"[xnor_gemm] {label} ({m}, {kw}) x ({n}, {kw}), K={k}: {ms} "
              f"ms, plain {plain} ms, bound "
              f"{r['bound_ms']} ms ({r['bound_by']}); plan "
              f"{tuple(kxnor.gemm_plan(m, n, kw))}  [{gpu}]")
        per_shape[label] = dict(ms=ms, plain_ms=plain,
                                bound_ms=r["bound_ms"])
        if label == "w1/w3 M=4":
            rec["xnor_gemm"] = r
        del sets
    print(f"[xnor_gemm shapes] {json.dumps(per_shape)}")
    # long K and tall M: Kw > 7264 and M > 524280; a K split 16 ways; held,
    # not timed
    for m, n, kw in ((3, 40, 9375), (20, 33, 7265), (600_000, 17, 8),
                     (4, 3584, 592)):
        pa = words(m * kw).reshape(m, kw)
        pb = words(n * kw).reshape(n, kw)
        out = held(kxnor.xnor_gemm, pa, pb, 32 * kw)
        off = torch.cat([pa.new_zeros(1), pa.reshape(-1)])[1:].reshape(m, kw)
        assert torch.equal(held(kxnor.xnor_gemm, off, pb, 32 * kw), out)
        print(f"[xnor_gemm] held bitwise at long K / tall M: "
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
                          ms, plain, kbulk.cost(n), lib)
    print(f"[bulk_xor] {n} words: {ms} ms, plain {plain} ms, "
          f"torch.bitwise_xor {lib} ms, bound {rec['bulk_xor']['bound_ms']} "
          f"ms  [{gpu}]")
    sets = [(s[0],) for s in sets]
    ms = time_ms(kparity.parity_digest, sets, 20)
    with cuda.plain_reference():
        plain = time_ms(kparity.parity_digest, sets, 2, 2)
    rec["parity_digest"] = row("parity_digest", "parity.cu",
                               "src/repro/kernels/parity.py:47", ms, plain,
                               kparity.cost(n), None)
    print(f"[parity_digest] {n} words: {ms} ms, plain {plain} ms, bound "
          f"{rec['parity_digest']['bound_ms']} ms  [{gpu}]")
    sets = [(w, 0x9E3779B9, 0x0BADF00D, 2 ** 32 - 5) for (w,) in sets]
    ms = time_ms(kcipher.xor_cipher, sets, 20)
    with cuda.plain_reference():
        plain = time_ms(kcipher.xor_cipher, sets, 2, 2)
    rec["xor_cipher"] = row("xor_cipher", "cipher.cu",
                            "src/repro/kernels/cipher.py:47", ms, plain,
                            kcipher.cost(n), None)
    print(f"[xor_cipher] {n} words: {ms} ms, plain {plain} ms, bound "
          f"{rec['xor_cipher']['bound_ms']} ms  [{gpu}]")
    return rec


def slice_trace(vocab: int) -> list:
    """The serving phases' trace: 8 requests of 8-64 prompt tokens and
    8-16 new tokens, half opening with a shared 32-token prefix."""
    import numpy as np

    from repro_torch.serve import Request, synthetic_trace

    base = synthetic_trace(8, vocab, seed=SEED, prompt_lens=(8, 16, 24, 32),
                           new_tokens=(8, 12, 16))
    prefix = np.random.default_rng([SEED, 0xC1A]).integers(
        0, vocab, size=32).astype(np.int32)
    trace = [Request(r.rid, np.concatenate([prefix, r.prompt])
                     if r.rid % 2 == 0 else r.prompt, r.max_new_tokens)
             for r in base]
    assert all(8 <= len(r.prompt) <= 64 for r in trace)
    return trace


def serve_slice(gpu: str) -> tuple:
    """Phase 3: full qwen2-7b+xnor through the port's ServeEngine ->
    (its kernels' launches, the drained engine, which phase 11 audits)."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.kernels import pack as kpack
    from repro_torch.kernels import paged_attn as kpaged
    from repro_torch.kernels import xnor_gemm as kxnor
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    cfg = configs.get("qwen2-7b+xnor")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab, cfg.dtype) == (28, 3584, 28, 4, 18944,
                                                152064, torch.bfloat16)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[slice] init {cfg.name}: {lm.pdefs.count(lm.param_defs(cfg))} "
          f"params in {time.perf_counter() - t0} s")

    trace = slice_trace(cfg.vocab)
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
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    for seed in (SEED, SEED + 1):
        params32 = lm.pack_params(cfg32, lm.init_params(cfg32, seed,
                                                        device="cuda"))
        check_paths(cfg32, params32, toks, nxt, gpu, seed=seed)
        del params32
        torch.cuda.empty_cache()
    return launches, eng


# Readings the dry-run of phase 11 is held to (my chip runs, PRs 22-23;
# NVIDIA H100 80GB HBM3, 700 W): 9a's peak device memory, 10b's train
# state and peak a rank
READ_9A_PEAK_GIB = 37.25
READ_10B_STATE_BYTES = 17_497_901_060
READ_10B_PEAK_GIB = 33.04


def phase3_engine():
    """Phase 3's engine, built alone: the seeded full-width, full-depth
    qwen2-7b+xnor tree, packed at load, 4 slots, s_max 128."""
    import repro_torch.configs as configs
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine
    cfg = configs.get("qwen2-7b+xnor")
    return ServeEngine(cfg, lm.init_params(cfg, SEED, device="cuda"),
                       slots=4, s_max=128, device="cuda")


def roofline_phase(gpu: str, eng) -> None:
    """Phase 11: the roofline and the dry-run against the card, on phase
    3's drained engine (full-width, full-depth qwen2-7b+xnor, 4 slots).

    The datasheet constants against the card (its SM count, the split
    plan's ``H100_SMS``, and its memory, ``CARD_BYTES``); the engine's
    decode audit (``ServeEngine.decode_roofline``: one paged decode step
    and its sampling traced on ``meta``) against one real decode step with
    all four slots decoding: the audit's launches of the fused linear and
    paged decode must equal the wrappers' counts over the real step, its
    dispatches are printed beside the step's CUDA kernel launches
    (``torch.profiler``), and the step's device busy time must be at least
    the floor, ``roofline_bytes`` at HBM's rate.  Then the dry-run of two
    cells the card ran, traced in this process (``meta``, a ``fake``
    process group): 9a (1 rank, 4 of 28 layers, batch 4 x 256) and 10b (2
    ranks on data, 8 layers), beside their readings; 10b's state bytes a
    rank must equal the shard's exactly, the peaks' ratios are printed."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import paged_attn as kpaged
    from repro_torch.kernels import xnor_gemm as kxnor
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.roofline import analysis
    from repro_torch.serve import Request

    props = torch.cuda.get_device_properties(0)
    print(f"[roofline] SMs {props.multi_processor_count} (H100_SMS "
          f"{kpaged.H100_SMS}), total_memory {props.total_memory} bytes "
          f"(CARD_BYTES {analysis.CARD_BYTES})  [{gpu}]")
    assert props.multi_processor_count == kpaged.H100_SMS
    assert 0.97 * analysis.CARD_BYTES <= props.total_memory \
        <= analysis.CARD_BYTES

    t0 = time.perf_counter()
    audit = eng.decode_roofline()
    t_audit = time.perf_counter() - t0
    want = {k: v["launches"] for k, v in audit["kernels"].items()}

    cfg = eng.cfg
    for i, r in enumerate(slice_trace(cfg.vocab)[:eng.slots]):
        eng.submit(Request(100 + i, r.prompt, 24))
    while eng._prefilling or len(eng.pool.active) < eng.slots:
        eng.step()
    eng.step()                                   # a warm decode step
    torch.cuda.synchronize()
    kernels = (kxnor.xnor_linear_fused, kpaged.paged_decode_attention)
    for f in kernels:
        f.launches = 0
    eng.step()
    torch.cuda.synchronize()
    got = {f.__name__: f.launches for f in kernels}
    steps = 3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    cuda_launches = sum(e.count for e in dev) / steps
    floor_ms = audit["roofline_bytes"] / analysis.HBM_BW * 1e3
    print(f"[roofline] decode audit of {cfg.name} at {eng.slots} slots "
          f"({t_audit} s): {audit['dispatches']} dispatches, kernels "
          f"{want}; roofline bytes {audit['roofline_bytes']} (floor "
          f"{floor_ms} ms at HBM's rate), achieved bytes "
          f"{audit['achieved_bytes']}, t_memory {audit['t_memory_s'] * 1e3}"
          f" ms, t_compute {audit['t_compute_s'] * 1e3} ms  [{gpu}]")
    print(f"[roofline] one real decode step: launches {got}; profiled over "
          f"{steps} steps: {cuda_launches} CUDA kernel launches a step "
          f"against the audit's {audit['dispatches']} dispatches, device "
          f"busy {busy_ms} ms a step against the floor {floor_ms} ms "
          f"({busy_ms / floor_ms} x)  [{gpu}]")
    assert got == {"xnor_linear_fused": want.get("xnor_linear_fused"),
                   "paged_decode_attention":
                   want.get("paged_decode_attention")}, (got, want)
    assert busy_ms > 0, "the profile shows no device time"
    assert busy_ms >= floor_ms, \
        f"busy {busy_ms} ms under the floor {floor_ms} ms: a count is wrong"
    eng.run()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    r9 = dryrun.trace_cell(train_cfg(), ShapeConfig("9a", "train", 256, 4),
                           None)
    with dryrun.fake_group(2):
        mesh = mesh_mod.make_mesh((2, 1), ("data", "model"), device="cpu")
        r10 = dryrun.trace_cell(_mesh_cfg(MESH_LAYERS),
                                ShapeConfig("10b", "train", 256, 4), mesh)
    t_dry = time.perf_counter() - t0
    p9 = r9["memory_analysis"]["peak_bytes"] / 2**30
    p10 = r10["memory_analysis"]["peak_bytes"] / 2**30
    print(f"[roofline] dry-run 9a (1 rank, 4 of 28 layers, batch 4 x 256):"
          f" state {r9['state_bytes']} bytes, peak {p9} GiB against the "
          f"reading {READ_9A_PEAK_GIB} GiB ({p9 / READ_9A_PEAK_GIB} x), "
          f"{r9['dispatches']} dispatches, t = ({r9['t_compute_s'] * 1e3}, "
          f"{r9['t_memory_s'] * 1e3}) ms  [{gpu}]")
    print(f"[roofline] dry-run 10b (2 ranks on data, {MESH_LAYERS} layers):"
          f" state {r10['state_bytes']} bytes a rank against the shard's "
          f"{READ_10B_STATE_BYTES}, peak {p10} GiB against the reading "
          f"{READ_10B_PEAK_GIB} GiB ({p10 / READ_10B_PEAK_GIB} x), "
          f"collectives {r10['collectives']}; both traced in {t_dry} s  "
          f"[{gpu}]")
    assert r10["state_bytes"] == READ_10B_STATE_BYTES


class LaunchHolds:
    """Per-launch holds (phase 3b's first).  Patches the five wrappers of
    the serving tier and ``bulk_xor`` where the port reaches them (module
    attributes); while
    :attr:`active`, each launch is held against its plain version on the
    same inputs: every paged decode launch at :data:`FLASH_TOL`, and the
    first :attr:`per_key` launches of each shape of the others — the fused
    linear within 2e-5 (f32) or 2^-8 (bf16, the kernel's f32 alpha against
    the reference's rounded one) and bitwise against the plain version
    summed in the kernel's order, ``pack``'s planes bitwise and alpha
    within 1e-6 or 2^-8, ``bulk_xor``, ``parity_digest`` and
    ``xor_cipher`` bitwise.
    While not active (the timed runs), each launch's shape is recorded so
    that :meth:`check` can require it to be one that was held."""

    def __init__(self, per_key: int = 28):
        from repro_torch.kernels import bulk, cipher, pack, paged_attn
        from repro_torch.kernels import parity, xnor_gemm
        self.per_key, self.active = per_key, False
        self.held, self.worst, self.unheld = {}, {}, set()
        self.sites = {"xnor_linear_fused": xnor_gemm, "pack": pack,
                      "paged_decode_attention": paged_attn,
                      "parity_digest": parity, "xor_cipher": cipher,
                      "bulk_xor": bulk}
        self.orig = {n: getattr(m, n) for n, m in self.sites.items()}

    @staticmethod
    def key(name, args, kw) -> tuple:
        a = args[0]
        dt = str(a.dtype)[6:]
        if name == "xnor_linear_fused":
            return (name, dt, a.shape[0], args[1].shape[0], args[3])
        if name == "paged_decode_attention":
            return (name, dt, str(args[1].dtype)[6:], a.shape[0],
                    args[3].shape[1], kw.get("window", 0))
        if name == "pack":
            return (name, dt, *a.shape)
        if name == "xor_cipher":
            return (name, a.numel())
        if name == "bulk_xor":
            return (name, a.numel(), bool(kw.get("invert", False)))
        return (name, a.numel(), *args[1:], *sorted(kw.items()))

    def _hold(self, name, out, args, kw) -> float:
        import torch

        from repro_torch.kernels import cuda
        from repro_torch.kernels.xnor_gemm import linear_kernel_order
        with cuda.plain_reference():
            p = self.orig[name](*args, **kw)
        if name == "xnor_linear_fused":
            f32 = args[0].dtype == torch.float32
            torch.testing.assert_close(out, p, rtol=2e-5 if f32 else 2 ** -8,
                                       atol=2e-5 if f32 else 1e-6)
            assert torch.equal(out, linear_kernel_order(*args)), \
                f"fused linear {self.key(name, args, kw)} differs from its " \
                "plain version summed in the kernel's order"
            return (out - p).abs().max().item()
        if name == "paged_decode_attention":
            rtol, atol = FLASH_TOL[str(args[0].dtype)[6:]]
            torch.testing.assert_close(out.float(), p.float(), rtol=rtol,
                                       atol=atol)
            return (out.float() - p.float()).abs().max().item()
        if name == "pack":
            assert torch.equal(out[0], p[0]), f"pack planes differ at " \
                f"{self.key(name, args, kw)}"
            rtol = 1e-6 if args[0].dtype == torch.float32 else 2 ** -8
            torch.testing.assert_close(out[1], p[1], rtol=rtol, atol=0)
            return (out[1] - p[1]).abs().max().item()
        assert torch.equal(out, p), f"{name} differs from its plain version " \
            f"at {self.key(name, args, kw)}"
        return 0.0

    def _wrap(self, name):
        fn = self.orig[name]

        @functools.wraps(fn, updated=())
        def held(*args, **kw):
            out = fn(*args, **kw)
            if not args[0].is_cuda:
                return out
            k = self.key(name, args, kw)
            if not self.active:
                self.unheld.add(k)
            elif (name == "paged_decode_attention"
                  or self.held.get(k, 0) < self.per_key):
                self.held[k] = self.held.get(k, 0) + 1
                self.worst[name] = max(self.worst.get(name, 0.0),
                                       self._hold(name, out, args, kw))
            return out
        # the wrapper counts ``fn.launches += 1`` through the module name,
        # which is now ``held``: one attribute dict keeps one count
        held.__dict__ = fn.__dict__
        return held

    def __enter__(self):
        for n, m in self.sites.items():
            setattr(m, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, m in self.sites.items():
            setattr(m, n, self.orig[n])

    @contextlib.contextmanager
    def off(self):
        """Launches inside run unheld (timed runs); their shapes are kept."""
        self.active = False
        try:
            yield
        finally:
            self.active = True

    def check(self, gpu: str, label: str = "tier") -> None:
        """Print what was held; fail unless every shape launched unheld was
        also held."""
        for name in self.sites:
            keys = sorted(k[1:] for k in self.held if k[0] == name)
            n = sum(v for k, v in self.held.items() if k[0] == name)
            shown = "" if name in ("bulk_xor", "parity_digest",
                                   "xor_cipher") else \
                f"; shapes {keys}"
            print(f"[{label}] held against the plain version: {name}, {n} "
                  f"launches at {len(keys)} shapes, max abs err "
                  f"{self.worst.get(name)}{shown}  [{gpu}]")
        missing = self.unheld - set(self.held)
        assert not missing, f"shapes launched but never held: {missing}"


def serving_tier(gpu: str) -> dict:
    """Phase 3b: the rest of the serving tier on phase 3's model (the same
    seeded full-width, full-depth qwen2-7b+xnor tree, bf16) and trace.

    (a) temperature 0.8, seed 0: one 4-slot ServeEngine against a
        2-replica Router (4 slots each, s_max 128, scrub every 4 router
        steps) with the kill drill at router step 6; every request must
        finish with the single engine's tokens, a session must migrate,
        a scrub pass must cover the packed weights and find nothing; then
        one flipped word of a live replica's packed weights must be
        exactly one corruption.
    (c) cross-slot migration: a session exported mid-decode from a 4-slot
        engine, restored into a 2-slot engine, must finish with the
        never-migrated tokens, at s_max 128 (table width 8) and 512 (32,
        where a split plan sized by the batch would cut the paged decode
        walk 16 ways at 4 slots and 32 at 2); the head GEMM sees another
        batch too.
    (b) the slot-dense layout and the static loop, greedy, in f32 at the
        same width and depth: dense = paged = generate_static; in bf16
        the number of the 8 requests on which dense and paged agree is
        printed, and beside it paged with the unfused decode chain.
    And rows 0-1 of one 4-slot paged decode launch must equal a 2-slot
    launch's bitwise on the same pools, W 8 and 32, bf16 and f32.

    The five kernels are held against their plain versions at every shape
    (:class:`LaunchHolds`), but for the two timed runs of (a): the single
    engine and the Router run once held, for the gates, and once unheld,
    for the readings (tok/s, ms per migration and per scrub pass), which
    must repeat the held run's tokens; every shape the timed runs launch
    must have been held.  Launch counts of the five kernels are zeroed
    before (a) and read after (b); each must be above zero."""
    with LaunchHolds() as holds:
        holds.active = True
        launches = tier_runs(gpu, holds)
    holds.check(gpu)
    return launches


def tier_runs(gpu: str, holds: LaunchHolds) -> dict:
    """The runs of :func:`serving_tier`, inside its holds."""
    import gc
    import shutil

    import torch

    import repro_torch.configs as configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels import paged_attn as kpaged
    from repro_torch.models import lm
    from repro_torch.serve import Router, ServeEngine
    from repro_torch.train import serve_step

    kernels = [holds.orig[n] for n in (     # the wrappers themselves
        "xnor_linear_fused", "pack", "paged_decode_attention",
        "parity_digest", "xor_cipher")]
    cfg = configs.get("qwen2-7b+xnor")
    trace = slice_trace(cfg.vocab)
    directory = ROOT / "experiments" / "chip_smoke_router"
    shutil.rmtree(directory, ignore_errors=True)
    params = lm.init_params(cfg, SEED, device="cuda")
    for f in kernels:
        f.launches = 0

    def tokens(rep, rids):
        return {rid: rep.tokens(rid).tolist() for rid in rids}

    def serve(eng):
        for r in trace:
            eng.submit(r)
        rep = eng.run()
        torch.cuda.synchronize()
        assert all(s.done for s in rep.sessions.values())
        return rep

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    rids = [r.rid for r in trace]
    tier = dict(s_max=128, temperature=0.8, seed=SEED)
    want = tokens(serve(ServeEngine(cfg, params, slots=4, **tier)), rids)
    with holds.off():
        single = serve(ServeEngine(cfg, params, slots=4, **tier))
    print(f"[tier] single 4-slot engine, T=0.8, unheld: {single.generated} "
          f"tokens in {single.wall} s -> {single.tok_per_s} tok/s; tokens "
          f"as the held run's: {tokens(single, rids) == want}  [{gpu}]")
    assert tokens(single, rids) == want, "the unheld run's tokens differ"

    def kill_drill(label):
        """-> (router, report, ms of each migration and scrub pass)."""
        router = Router(cfg, params, 2, slots=4,
                        ckpt_dir=str(directory / label), epoch_steps=4,
                        **tier)
        timed = {"migrate": [], "scrub": []}

        def timing(name, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                timed[name].append((time.perf_counter() - t0) * 1e3)
                return out
            return run
        router.migrate = timing("migrate", router.migrate)
        router.scrub = timing("scrub", router.scrub)
        for r in trace:
            router.submit(r)
        rep = router.run(kill_at=6)
        torch.cuda.synchronize()
        del router.migrate, router.scrub      # the timing wrappers' cycle
        done = sum(s.done for s in rep.sessions.values())
        diverged = [rid for rid in rids
                    if rep.tokens(rid).tolist() != want[rid]]
        leaves = sum(r.scrub_weight_leaves for r in rep.replicas)
        print(f"[tier] router 2 x 4 slots, kill at step 6, {label}: "
              f"{rep.generated} tokens in {rep.wall} s -> {rep.tok_per_s} "
              f"tok/s; killed {rep.killed}, {len(rep.migrations)} migrations "
              f"{[m[:3] for m in rep.migrations]}, {len(diverged)} requests "
              f"diverged, {done}/{len(trace)} finished; {rep.scrub_passes} "
              f"scrub passes over {leaves} weight leaves and "
              f"{sum(r.scrub_idle_blocks for r in rep.replicas)} idle "
              f"blocks, {rep.scrub_corruptions} corruptions  [{gpu}]")
        assert done == len(trace), f"{done}/{len(trace)} finished"
        assert not diverged, f"router tokens diverged on requests {diverged}"
        assert rep.migrations, "the kill drill migrated no session"
        assert leaves > 0, "no scrub pass covered the packed weights"
        assert rep.scrub_corruptions == 0, "the scrubber reported corruption"
        return router, rep, timed

    router, rep, _ = kill_drill("held")
    del router, rep
    free()
    with holds.off():
        router, rep, timed = kill_drill("unheld")
    wire = sum(f.stat().st_size for f in (directory / "unheld").rglob("*")
               if f.is_file())
    print(f"[tier] ms per migration (export, save, restore, import), unheld "
          f"run: {timed['migrate']}; encrypted wire {wire} bytes in all, "
          f"{wire / len(rep.migrations)} a migration  [{gpu}]")
    print(f"[tier] ms per scrub pass (both replicas), unheld run: "
          f"{timed['scrub']}  [{gpu}]")
    # the control: one flipped word of a live replica's packed weights
    alive = [h for h in router.replicas if h.alive]
    pb = alive[0].engine.params["seg0_attn"]["ffn_w1"].pb
    pb.view(-1)[12345] ^= 1 << 3
    flipped = router.scrub()
    pb.view(-1)[12345] ^= 1 << 3
    restored = router.scrub()
    print(f"[tier] control, one flipped word of replica "
          f"{alive[0].index}'s w1 planes: {flipped} corruption(s); flipped "
          f"back: {restored}  [{gpu}]")
    assert flipped == 1, f"the flipped word gave {flipped} corruptions"
    assert restored == 0
    del router, rep, alive, pb
    free()

    # (c) cross-slot migration: 4-slot source, 2-slot destination, at the
    # phase's table width (W 8) and at W 32, where a split plan sized by
    # the batch would cut the walk 16 ways at 4 slots and 32 ways at 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cross_slot = {}
    for s_max in (128, 512):
        geom = dict(tier, s_max=s_max)
        base = want if s_max == 128 else tokens(
            serve(ServeEngine(cfg, params, slots=4, **geom)), rids)
        a = ServeEngine(cfg, params, slots=4, **geom)
        for r in trace:
            a.submit(r)
        sess = None
        while sess is None:
            assert a.step(), "the trace never reached a mid-decode session"
            live = [x for slot, x in a.pool.active.items()
                    if x.tokens and not x.done and slot not in a._prefilling]
            sess = live[0] if live else None
        rid = sess.request.rid
        b = ServeEngine(cfg, params, slots=2, **geom)
        d = str(directory / f"cross_slot_{s_max}")
        ckpt.save(d, 1, a.export_session(rid), root_key=ROOT_KEY)
        restored, _ = ckpt.restore(d, 1, b.export_spec(sess.request),
                                   root_key=ROOT_KEY)
        b.import_session(sess.request, restored)
        a.release_migrated(rid)
        moved = b.run().tokens(rid).tolist()
        rest = a.run()
        others = all(rest.tokens(x).tolist() == base[x]
                     for x in rids if x != rid)
        w = a._widths["full"]
        cross_slot[s_max] = moved == base[rid] and others
        print(f"[tier] cross-slot migration, s_max {s_max} (W {w}; split "
              f"plan (n_split, cols) "
              f"{kpaged.split_plan(w, cfg.n_kv_heads, sms)} at any slots): "
              f"request {rid} after {len(sess.tokens)} tokens, 4-slot -> "
              f"2-slot engine: "
              f"{'identical' if moved == base[rid] else 'DIFFERENT'} to the "
              f"never-migrated tokens (others identical: {others})  [{gpu}]")
        del a, b
        free()
    assert all(cross_slot.values()), f"cross-slot migration: {cross_slot}"

    # bf16, greedy: dense against paged, printed as a count
    greedy = dict(s_max=128, seed=SEED)
    paged = tokens(serve(ServeEngine(cfg, params, slots=4, **greedy)), rids)
    dense = tokens(serve(ServeEngine(cfg, params, slots=4, paged=False,
                                     **greedy)), rids)
    # and paged decode through the gather / softmax chain (P rounded to
    # bf16 before P.V, as the dense layout computes it) in place of the
    # kernel, which keeps P in f32
    chain = tokens(serve(ServeEngine(
        dataclasses.replace(cfg, fused_decode="off"), params, slots=4,
        **greedy)), rids)
    for name, other in (("paged", paged), ("paged, unfused decode", chain)):
        agree = sum(other[x] == dense[x] for x in rids)
        common = [next((i for i, (p, q) in enumerate(zip(other[x], dense[x]))
                        if p != q), len(other[x])) for x in rids]
        print(f"[tier] bf16 greedy: dense and {name} agree on {agree}/"
              f"{len(rids)} requests; tokens in common before they part "
              f"{common} of {[len(dense[x]) for x in rids]}  [{gpu}]")
    del params
    free()

    # (b) f32, greedy: dense = paged = generate_static
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = lm.init_params(cfg32, SEED, device="cuda")
    eng = ServeEngine(cfg32, params32, slots=4, paged=False, **greedy)
    paged = tokens(serve(ServeEngine(cfg32, params32, slots=4, **greedy)),
                   rids)
    del params32
    dense = tokens(serve(eng), rids)
    static = {r.rid: serve_step.generate_static(
        cfg32, eng.params, torch.from_numpy(r.prompt[None]).cuda(),
        r.max_new_tokens)[0].tolist() for r in trace}
    print(f"[tier] f32 greedy: dense = paged on "
          f"{sum(dense[x] == paged[x] for x in rids)}/8, generate_static = "
          f"dense on {sum(static[x] == dense[x] for x in rids)}/8  [{gpu}]")
    assert dense == paged, "f32: the dense layout's tokens differ from paged"
    assert static == dense, "f32: generate_static differs from the engine"
    del eng
    free()
    launches = {f.__name__: f.launches for f in kernels}
    print(f"[tier] launches in the phase: {launches}  [{gpu}]")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched in the serving tier"

    # the kernel alone: rows 0-1 of a 4-slot launch against a 2-slot one on
    # the same pools, full tables (W 8 and 32), bf16 and f32: bitwise (each
    # launch also held against the plain version)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 17)
    kv, gq, dh, bs = cfg.n_kv_heads, cfg.q_per_kv, cfg.d_head, cfg.block_size
    rows = {}
    for w, dt in ((8, torch.bfloat16), (32, torch.bfloat16),
                  (8, torch.float32), (32, torch.float32)):
        q = torch.randn((4, kv, gq, dh), generator=g, device="cuda").to(dt)
        ck, cv = (torch.randn((1 + 4 * w, kv, bs, dh), generator=g,
                              device="cuda").to(dt) for _ in range(2))
        table = (torch.randperm(4 * w, generator=g, device="cuda") + 1
                 ).reshape(4, w).to(torch.int32)
        pos = torch.full((4,), w * bs - 1, dtype=torch.int32, device="cuda")
        o4 = kpaged.paged_decode_attention(q, ck, cv, table, pos,
                                           scale=dh ** -0.5)
        o2 = kpaged.paged_decode_attention(q[:2].contiguous(), ck, cv,
                                           table[:2].contiguous(),
                                           pos[:2].contiguous(),
                                           scale=dh ** -0.5)
        rows[f"W {w} {str(dt)[6:]}"] = int((o4[:2] != o2).sum())
    print(f"[tier] paged decode, slots 0-1 of a 4-slot launch against a "
          f"2-slot launch, elements differing of {2 * kv * gq * dh}: "
          f"{rows}  [{gpu}]")
    assert not any(rows.values()), f"a slot's bits depend on the batch: {rows}"
    shutil.rmtree(directory, ignore_errors=True)
    free()
    print(f"[tier] device memory still allocated after the phase "
          f"{torch.cuda.memory_allocated() / 2**30} GiB  [{gpu}]")
    return launches


def recurrent_trace(vocab: int) -> list:
    """Phase 3c's trace: phase 3's 8 requests, then one of a 2,100-token
    prompt and 16 new tokens, which wraps the 2,048-token window ring."""
    import numpy as np

    from repro_torch.serve import Request

    long_ = np.random.default_rng([SEED, 0x2100]).integers(
        0, vocab, size=2100).astype(np.int32)
    return slice_trace(vocab) + [Request(8, long_, 16)]


def migrate(cfg, params, trace, want, geom, directory, gpu, rid=8,
            label="recurrent", expect=("torch.float32", "torch.bfloat16",
                                       130), ctx_kv=None,
            slot_leaves=None) -> None:
    """A migration mid-decode: request ``rid`` (phase 3c: request 8, 2,100
    prompt tokens) exported after 4 decoded tokens from a 4-slot engine,
    saved encrypted, restored against a 2-slot engine's spec and imported
    there; both engines finish, and every request keeps ``want``'s tokens.
    ``expect`` is the wire's per-slot ``h`` and conv dtypes (None where
    the kind has none) and its pool rows' width; ``ctx_kv`` the dtype and
    (T_ctx, KV, dh) of the cross layers' per-slot keys and values, which
    travel beside the request's raw context (None: the kind has none).
    ``slot_leaves``, where given, replaces both: the set of (dtype, shape
    past the layer axis) of every per-slot leaf, on a wire with no pool
    blocks.  Prints the wire's leaves, its bytes and the ms from export to
    import."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.serve import ServeEngine

    a = ServeEngine(cfg, params, device="cuda", **geom)
    for r in trace:
        a.submit(r)
    long_ = a.sessions[rid]
    while len(long_.tokens) < 4:
        assert a.step(), f"request {rid} never reached decode"
    b = ServeEngine(cfg, params, device="cuda", **dict(geom, slots=2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wire = a.export_session(rid)
    ckpt.save(str(directory), 1, wire, root_key=ROOT_KEY)
    restored, _ = ckpt.restore(str(directory), 1,
                               b.export_spec(long_.request),
                               root_key=ROOT_KEY)
    b.import_session(long_.request, restored)
    a.release_migrated(rid)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    segs = wire["state"]["segs"]
    ring = {tuple(x[0].k.shape) for x in segs if x[0] is not None}
    if slot_leaves is not None:
        from repro_torch.models.blocks import state_leaves
        leaves = {"per_slot": {(str(t.dtype), tuple(t.shape[1:]))
                               for x in segs for t in state_leaves(x[1])},
                  "ring": ring}
        assert leaves["per_slot"] == slot_leaves and not ring, leaves
    else:
        rec = [x[1] for x in segs
               if x[1] is not None and hasattr(x[1][0], "h")]
        kvs = [x[1] for x in segs if x[1] is not None
               and not hasattr(x[1][0], "h")]
        leaves = {"h": {str(x[0].h.dtype) for x in rec},
                  "conv": {str(x[1].dtype) for x in rec},
                  "ctx_kv": {(str(t.dtype), tuple(t.shape[2:])) for x in kvs
                             for t in x},
                  "ring": ring}
        h, conv, width = expect
        assert leaves["h"] == ({h} if h else set()), leaves
        assert leaves["conv"] == ({conv} if conv else set()), leaves
        assert leaves["ctx_kv"] == ({ctx_kv} if ctx_kv else set()), leaves
        assert leaves["ring"] and all(shape[1] == width
                                      for shape in leaves["ring"]), leaves
    req = long_.request
    assert ("ctx" in wire) == (req.ctx is not None) and (
        req.ctx is None or wire["ctx"].shape == req.ctx.shape), wire.keys()
    nbytes = sum(f.stat().st_size for f in directory.rglob("*")
                 if f.is_file())
    moved = b.run().tokens(rid).tolist()
    rest = a.run()
    others = all(rest.tokens(r.rid).tolist() == want[r.rid] for r in trace
                 if r.rid != rid)
    print(f"[{label}] migration ({directory.name}) of request {rid} after "
          f"{len(long_.tokens)} tokens ({len(long_.request.prompt)} prompt "
          f"tokens), 4-slot -> 2-slot engine: "
          f"{'identical' if moved == want[rid] else 'DIFFERENT'} to the "
          f"never-migrated tokens (others identical: {others}); {ms} ms "
          f"(export, encrypted save, restore, import), {nbytes} bytes on "
          f"disk; wire leaves {leaves} per segment  [{gpu}]")
    assert moved == want[rid] and others, "migration changed tokens"


def recurrent_serving(gpu: str) -> dict:
    """Phase 3c: full recurrentgemma-2b+xnor (26 layers: 18 rglru, 8 local;
    d 2560, vocab 256,000, MQA G 10 at dh 256, window 2048), bf16 weights
    from a seeded generator on the card, packed at load, served by a
    4-slot paged ServeEngine (block 16, chunk 32, s_max 2176) over
    :func:`recurrent_trace`.

    Gates: prefix caching off; pack, the fused linear and paged decode
    launched on the main path, every launch of the held run held against
    its plain version at every shape (:class:`LaunchHolds`), and one
    unheld timed run repeating its tokens; :func:`check_paths` in f32 and
    bf16 (this arch's limits) and the one-ulp-up control failing them; a
    session migrated mid-decode (the long one, after its ring wrapped)
    from the 4-slot engine to a 2-slot one through an encrypted wire,
    keeping its tokens; in f32, the dense and paged layouts' tokens equal
    on the 8 short requests.  -> launch counts of the three kernels."""
    import gc
    import shutil
    import statistics

    import torch

    import repro_torch.configs as configs
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    cfg = configs.get("recurrentgemma-2b+xnor")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab, cfg.local_window,
            cfg.dtype) == (26, 2560, 10, 1, 256, 7680, 256000, 2048,
                           torch.bfloat16)
    assert [k for k, _ in cfg.segments()].count("local") == 8
    trace = recurrent_trace(cfg.vocab)
    rids = [r.rid for r in trace]
    geom = dict(slots=4, s_max=2176, block_size=16, prefill_chunk=32)
    directory = ROOT / "experiments" / "chip_smoke_recurrent"
    shutil.rmtree(directory, ignore_errors=True)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def serve(eng, requests=trace):
        for r in requests:
            eng.submit(r)
        rep = eng.run()
        torch.cuda.synchronize()
        assert all(s.done for s in rep.sessions.values())
        return rep

    def tokens(rep, which=rids):
        return {rid: rep.tokens(rid).tolist() for rid in which}

    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[recurrent] init {cfg.name}: "
          f"{lm.pdefs.count(lm.param_defs(cfg))} params in "
          f"{time.perf_counter() - t0} s")
    with LaunchHolds() as holds:
        kernels = [holds.orig[n] for n in ("pack", "xnor_linear_fused",
                                           "paged_decode_attention")]
        holds.active = True
        for f in kernels:
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        eng = ServeEngine(cfg, params, device="cuda", **geom)
        assert eng.prefix_caching is False, "prefix caching must be off"
        assert eng._widths == {"win": 130}, eng._widths
        held = serve(eng)
        launches = {f.__name__: f.launches for f in kernels}
        want = tokens(held)
        for s in held.sessions.values():
            assert len(s.tokens) == s.request.max_new_tokens
            assert all(0 <= t < cfg.vocab for t in s.tokens)
        for name, n in launches.items():
            assert n > 0, f"kernel {name} never launched on the main path"
        print(f"[recurrent] main-path launches (held run) {launches}  "
              f"[{gpu}]")
        del eng
        free()

        # the unheld timed run, launches read around every decode step
        with holds.off():
            torch.cuda.reset_peak_memory_stats()
            eng = ServeEngine(cfg, params, device="cuda", **geom)
            per_step, decode_once = [], eng._decode_once

            def counted():
                before = [f.launches for f in kernels[1:]]
                decode_once()
                per_step.append(tuple(f.launches - b for f, b in
                                      zip(kernels[1:], before)))
            eng._decode_once = counted
            rep = serve(eng)
            del eng._decode_once
            peak = torch.cuda.max_memory_allocated()
        assert tokens(rep) == want, "the unheld run's tokens differ"
        ttft = rep.ttft_quantiles((0.5, 0.95))
        st = rep.stats
        print(f"[recurrent] unheld run: {rep.generated} tokens in {rep.wall} "
              f"s -> {rep.tok_per_s} tok/s; TTFT p50 {ttft[0.5] * 1e3} ms "
              f"p95 {ttft[0.95] * 1e3} ms; {st.prefill_chunks} prefill "
              f"chunks, {st.decode_steps} decode steps; peak device memory "
              f"{peak / 2**30} GiB; tokens as the held run's: True  [{gpu}]")
        print(f"[recurrent] launches per decode step (fused linear, paged "
              f"decode): median "
              f"{statistics.median(p[0] for p in per_step)}, "
              f"{statistics.median(p[1] for p in per_step)} over "
              f"{len(per_step)} steps  [{gpu}]")
        assert per_step and all(p == (200, 8) for p in per_step), per_step

        # migration mid-decode, 4 -> 2 slots, after the long request's ring
        # wrapped: the wire carries the ring blocks, h (f32), conv (bf16);
        # once held (the gate), once unheld (the timing)
        migrate(cfg, params, trace, want, geom, directory / "held", gpu)
        with holds.off():
            migrate(cfg, params, trace, want, geom, directory / "unheld",
                    gpu)
        free()
    holds.check(gpu, "recurrent")
    shutil.rmtree(directory, ignore_errors=True)

    # the kernel path against the plain path, bf16 (this arch's limits)
    # and f32; and the control that rounds one way
    pparams = lm.pack_params(cfg, params)
    toks = torch.from_numpy(trace[0].prompt[None, :cfg.prefill_chunk]
                            .copy())
    nxt = int(trace[0].prompt[cfg.prefill_chunk])
    check_paths(cfg, pparams, toks, nxt, gpu)
    try:
        with attention_rounding_up(1):
            check_paths(cfg, pparams, toks, nxt, gpu)
        failed = ""
    except AssertionError as e:
        failed = str(e)
    print(f"[recurrent] control, paged decode one ulp up at every "
          f"element: check_paths failed with {failed!r}  [{gpu}]")
    assert "inputs drifted" in failed and "rounds one way" in failed, \
        "check_paths' bf16 holds must each fail a kernel that rounds one way"
    del pparams, params
    free()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = lm.init_params(cfg32, SEED, device="cuda")
    check_paths(cfg32, lm.pack_params(cfg32, params32), toks, nxt, gpu)
    short = trace[:8]
    f32 = dict(slots=4, s_max=128)
    paged = tokens(serve(ServeEngine(cfg32, params32, device="cuda",
                                     **f32), short), rids[:8])
    dense = tokens(serve(ServeEngine(cfg32, params32, device="cuda",
                                     paged=False, **f32), short),
                   rids[:8])
    print(f"[recurrent] f32 greedy: dense = paged on "
          f"{sum(dense[x] == paged[x] for x in rids[:8])}/8  [{gpu}]")
    assert dense == paged, "f32: the dense layout's tokens differ"
    del params32
    free()
    return launches


# moonshot-v1-16b-a3b's attention projections (all four 2048 -> 2048) and
# llama4-scout's (q/o 5120 -> 5120, k/v 5120 -> 1024), (N, K)
MOE_LINEARS = {"moonshot-v1-16b-a3b": {"wq/wk/wv/wo": (2048, 2048)},
               "llama4-scout-17b-a16e": {"wq/wo": (5120, 5120),
                                         "wk/wv": (1024, 5120)}}
# moonshot-v1-16b-a3b's decode attention: B 4, KV 16, G 1 (MHA), dh 128,
# bs 16; W 8 is phase 3d's table (s_max 128), W 2048 a 32k-key one
MOE_PAGED = dict(b=4, kv=16, g=1, dh=128, bs=16)


def paged_readings(gpu: str, label: str, geom: dict, w: int, pos,
                   randn, gen, window: int = 0) -> dict:
    """Paged decode at ``geom`` over a W-column table (a ring of ``window``
    keys where nonzero): held in bf16, f32 and int8 pools against the
    plain version, and timed over input sets rotated past L2 (each
    layer's pool is cold on the serving path) beside its byte bound, SDPA
    on K/V already gathered (the position or window mask; the gather is
    not timed) and the plain version.  -> {pool label: reading}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cuda
    from repro_torch.kernels import paged_attn as kpaged

    dev = torch.device("cuda")
    b, kv, gq, dh, bs = (geom[k] for k in ("b", "kv", "g", "dh", "bs"))
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    cap = w * bs

    def case(dtype, i8):
        q = randn(b, kv, gq, dh, dtype=dtype)
        ck, cv = randn(1 + b * w, kv, bs, dh), randn(1 + b * w, kv, bs, dh)
        if i8:
            ck = torch.clamp(torch.round(ck * 32), -127, 127).to(torch.int8)
            cv = torch.clamp(torch.round(cv * 32), -127, 127).to(torch.int8)
        else:
            ck, cv = ck.to(dtype), cv.to(dtype)
        table = (torch.randperm(b * w, generator=gen, device=dev) + 1
                 ).reshape(b, w).to(torch.int32)
        return q, ck, cv, table, pos

    live = kpaged.live_columns(pos, w, bs, window)
    kslot = torch.arange(cap, device=dev)[None]
    if window:
        age = torch.remainder(torch.remainder(pos.long()[:, None], cap)
                              - kslot, cap)
        valid = age < torch.clamp(pos.long()[:, None] + 1, max=window)
    else:
        valid = kslot <= pos.long()[:, None]
    keys = int(valid.sum())
    out = {}
    for dtype, i8 in ((torch.bfloat16, False), (torch.float32, False),
                      (torch.bfloat16, True)):
        sc, osc = ((dh ** -0.5) / 32, 1 / 32) if i8 else (dh ** -0.5, 1.0)

        def run(*a, sc=sc, osc=osc):
            return kpaged.paged_decode_attention(*a, window=window, scale=sc,
                                                 out_scale=osc)
        args = case(dtype, i8)
        kk = run(*args)
        with cuda.plain_reference():
            pp = run(*args)
        rtol, atol = FLASH_TOL[str(dtype)[6:]]
        torch.testing.assert_close(kk.float(), pp.float(), rtol=rtol,
                                   atol=atol)
        err = (kk.float() - pp.float()).abs().max().item()
        item = 1 if i8 else dtype.itemsize
        qb = dtype.itemsize
        per_set = b * kv * gq * dh * qb + 2 * (1 + b * w) * kv * bs * dh * item
        sets = copies(lambda: case(dtype, i8), per_set)
        ms = time_ms(run, sets, 200)
        with cuda.plain_reference():
            plain = time_ms(run, sets[:2], 10, 2)
        b_ms, b_by = bound(*kpaged.cost(b, kv, gq, dh, bs, w, qb, item,
                                        int(live.sum()), keys))
        lib = None
        if not i8:
            mask = valid[:, None, None, :]

            def gathered(q, ck, cv, table, _):
                idx = table.long()
                return (q, ck[idx].permute(0, 2, 1, 3, 4).reshape(
                    b, kv, cap, dh), cv[idx].permute(0, 2, 1, 3, 4).reshape(
                    b, kv, cap, dh), mask)
            lib = time_ms(lambda a, b_, c, m: F.scaled_dot_product_attention(
                a, b_, c, attn_mask=m), [gathered(*x) for x in sets], 200)
        name = f"{str(dtype)[6:]}{' int8 pools' if i8 else ''}"
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib, max_abs_err=err)
        print(f"[paged_decode_attention {label} W={w} {name}] held, max abs "
              f"err {err}; {len(sets)} input sets rotated: {ms} ms, plain "
              f"{plain} ms, SDPA on pre-gathered K/V {lib} ms, bound {b_ms} "
              f"ms ({b_by}), {keys} live keys in {int(live.sum())} live "
              f"columns, pos {pos.tolist()}  [{gpu}]")
        del sets
        torch.cuda.empty_cache()
    return out


def moe_arch_kernels(gpu: str) -> dict:
    """Phase 2 for the mixture-of-experts archs: the fused linear at
    moonshot-v1-16b-a3b's (2048 -> 2048) and llama4-scout's (5120 -> 5120,
    5120 -> 1024) attention shapes, M 4 and 32, f32 and bf16, bitwise in
    the kernel's order (moonshot's timed at M 4 against its byte bound);
    one moonshot decode step's 192 fused linears (4 a layer x 48) as one
    CUDA graph against the step's byte bound; paged decode at moonshot's
    geometry (B 4, KV 16, G 1, dh 128, bs 16) over W 8 and W 2048 tables
    (:func:`paged_readings`).  -> the W 8 bf16 paged reading."""
    import torch

    from repro_torch.core import xnor_layers
    from repro_torch.kernels import cuda
    from repro_torch.kernels import xnor_gemm as kxnor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 19)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for arch, shapes in MOE_LINEARS.items():
        row = {}
        for name, (n, k) in shapes.items():
            pb, beta = xnor_layers.pack_weights(randn(n, k,
                                                      dtype=torch.bfloat16))
            for m in (4, 32):
                for dt in (torch.float32, torch.bfloat16):
                    x = randn(m, k, dtype=dt)
                    kk = kxnor.xnor_linear_fused(x, pb, beta, k)
                    with cuda.plain_reference():
                        pp = kxnor.xnor_linear_fused(x, pb, beta, k)
                    assert torch.equal(kk, kxnor.linear_kernel_order(
                        x, pb, beta, k)), f"{arch} {name} M={m} {dt}"
                    f32 = dt == torch.float32
                    torch.testing.assert_close(
                        kk, pp, rtol=2e-5 if f32 else 2 ** -8,
                        atol=2e-5 if f32 else 1e-6)
            if arch == "moonshot-v1-16b-a3b":
                kw = pb.shape[1]
                sets = copies(lambda: (randn(4, k, dtype=torch.bfloat16),
                                       *xnor_layers.pack_weights(
                                           randn(n, k, dtype=torch.bfloat16)),
                                       k), n * kw * 4)
                ms = time_ms(kxnor.xnor_linear_fused, sets, 200)
                b_ms, _ = bound(*kxnor.linear_cost(4, n, k))
                row[name] = dict(N=n, K=k, ms=ms, bound_ms=b_ms)
                del sets
        print(f"[xnor_linear_fused {arch}] held bitwise in the kernel's "
              f"order at {list(shapes.values())} (N, K), M 4 and 32, f32 "
              f"and bf16" + (f"; bf16 M=4 timings {json.dumps(row)}"
                             if row else "") + f"  [{gpu}]")

    # one moonshot decode step: 48 layers x 4 linears (2048 -> 2048), each
    # layer its own weights, M = 4, one CUDA graph
    calls, nbytes = [], 0
    for _ in range(48 * 4):
        n, k = MOE_LINEARS["moonshot-v1-16b-a3b"]["wq/wk/wv/wo"]
        pb, beta = xnor_layers.pack_weights(randn(n, k, dtype=torch.bfloat16))
        calls.append((randn(4, k, dtype=torch.bfloat16), pb, beta, k))
        nbytes += kxnor.linear_cost(4, n, k).bytes
    step = time_ms(kxnor.xnor_linear_fused, calls, len(calls), 5) * len(calls)
    b_ms = bytes_ms(nbytes)
    plain = plain_step_ms(kxnor.xnor_linear_fused, calls)
    print(f"[xnor_linear_fused moonshot decode step] {len(calls)} launches "
          f"(4 a layer x 48, M = 4) in one CUDA graph: {step} ms, bound "
          f"{b_ms} ms ({step / b_ms} x); the plain version {plain} ms  "
          f"[{gpu}]")
    del calls
    torch.cuda.empty_cache()

    w8 = paged_readings(gpu, "moonshot", MOE_PAGED, 8, [127, 100, 64, 17],
                        randn, g)
    paged_readings(gpu, "moonshot", MOE_PAGED, 2048,
                   [32767, 20000, 4095, 17], randn, g)
    return w8["bfloat16"]


def moe_serving(gpu: str) -> dict:
    """Phase 3d: full moonshot-v1-16b-a3b+xnor (48 moe layers: d 2048, MHA
    with 16 heads of 128, 64 experts of d_ff 1408, top-6, vocab 163,840),
    bf16 weights from a seeded generator on the card (28.1 B parameters,
    56 GB), the attention packed at load, served by a 4-slot paged
    ServeEngine (block 16, chunk 32, s_max 128, prefix caching on) over
    phase 3's 8 requests.

    Gates: pack, the fused linear and paged decode launched on the main
    path, every launch of the held runs held against its plain version at
    every shape (:class:`LaunchHolds`); one unheld timed run repeating the
    held run's tokens (tok/s, TTFT, peak memory; 192 fused linears and 48
    paged decodes every decode step); with the prefix cache off (a hit
    changes a request's dispatch groups, and the slot count decides the
    hits), the same tokens from a 4-slot and a 2-slot engine, and a
    session migrated mid-decode from the one to the other through an
    encrypted wire, keeping its tokens; :func:`check_paths` in bf16 at
    this arch's limits with the one-ulp-up control failing them, and in
    f32 at full width and 8 of the 48 layers (the f32 tree at full depth,
    112 GB, does not fit the card).  -> launch counts of the three
    kernels."""
    import gc
    import shutil
    import statistics

    import torch

    import repro_torch.configs as configs
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    cfg = configs.get("moonshot-v1-16b-a3b+xnor")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.n_experts, cfg.top_k, cfg.d_ff_expert,
            cfg.vocab, cfg.dtype) == (48, 2048, 16, 16, 128, 64, 6, 1408,
                                      163840, torch.bfloat16)
    trace = slice_trace(cfg.vocab)
    rids = [r.rid for r in trace]
    geom = dict(slots=4, s_max=128, block_size=16, prefill_chunk=32)
    directory = ROOT / "experiments" / "chip_smoke_moe"
    shutil.rmtree(directory, ignore_errors=True)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def serve(eng):
        for r in trace:
            eng.submit(r)
        rep = eng.run()
        torch.cuda.synchronize()
        assert all(s.done for s in rep.sessions.values())
        return rep

    def tokens(rep):
        return {rid: rep.tokens(rid).tolist() for rid in rids}

    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = lm.pdefs.count(lm.param_defs(cfg))
    print(f"[moe] init {cfg.name}: {n_params} params, "
          f"{torch.cuda.memory_allocated() / 2**30} GiB on the card, in "
          f"{time.perf_counter() - t0} s")
    with LaunchHolds() as holds:
        kernels = [holds.orig[n] for n in ("pack", "xnor_linear_fused",
                                           "paged_decode_attention")]
        holds.active = True
        for f in kernels:
            f.launches = 0
        eng = ServeEngine(cfg, params, device="cuda", **geom)
        assert eng.prefix_caching, "prefix caching must be on for moe"
        assert eng._widths == {"full": 8}, eng._widths
        held = serve(eng)
        launches = {f.__name__: f.launches for f in kernels}
        want = tokens(held)
        for s in held.sessions.values():
            assert len(s.tokens) == s.request.max_new_tokens
            assert all(0 <= t < cfg.vocab for t in s.tokens)
        for name, n in launches.items():
            assert n > 0, f"kernel {name} never launched on the main path"
        st = held.stats
        assert st.prefix_hits > 0, "the shared prefix was never hit"
        print(f"[moe] main-path launches (held run) {launches}; prefix hits "
              f"{st.prefix_hits}, cow {st.cow_copies}  [{gpu}]")
        del eng
        free()
        # a prefix hit shortens a request's dispatch groups, and the slot
        # count decides which requests hit (DESIGN.md §14: a hit is not
        # promised a miss's tokens), so the slot counts are held against
        # each other with the cache off
        off = {n: tokens(serve(ServeEngine(cfg, params, device="cuda",
                                           prefix_cache=False,
                                           **dict(geom, slots=n))))
               for n in (4, 2)}
        print(f"[moe] held, prefix cache off: the 2-slot engine's tokens as "
              f"the 4-slot one's on {sum(off[2][r] == off[4][r] for r in rids)}"
              f"/8; at 4 slots, cache on as off on "
              f"{sum(want[r] == off[4][r] for r in rids)}/8  [{gpu}]")
        assert off[2] == off[4], "the 2-slot engine's tokens differ"
        free()

        # the unheld timed run, launches read around every decode step
        with holds.off():
            torch.cuda.reset_peak_memory_stats()
            eng = ServeEngine(cfg, params, device="cuda", **geom)
            per_step, decode_once = [], eng._decode_once

            def counted():
                before = [f.launches for f in kernels[1:]]
                decode_once()
                per_step.append(tuple(f.launches - b for f, b in
                                      zip(kernels[1:], before)))
            eng._decode_once = counted
            rep = serve(eng)
            del eng._decode_once
            peak = torch.cuda.max_memory_allocated()
            del eng
        assert tokens(rep) == want, "the unheld run's tokens differ"
        ttft = rep.ttft_quantiles((0.5, 0.95))
        st = rep.stats
        print(f"[moe] unheld run: {rep.generated} tokens in {rep.wall} s -> "
              f"{rep.tok_per_s} tok/s; TTFT p50 {ttft[0.5] * 1e3} ms p95 "
              f"{ttft[0.95] * 1e3} ms; {st.prefill_chunks} prefill chunks, "
              f"{st.decode_steps} decode steps, prefix hits "
              f"{st.prefix_hits}; peak device memory {peak / 2**30} GiB; "
              f"tokens as the held run's: True  [{gpu}]")
        print(f"[moe] launches per decode step (fused linear, paged "
              f"decode): median {statistics.median(p[0] for p in per_step)}"
              f", {statistics.median(p[1] for p in per_step)} over "
              f"{len(per_step)} steps  [{gpu}]")
        assert per_step and all(p == (192, 48) for p in per_step), per_step

        # a session migrated mid-decode 4 -> 2 slots through an encrypted
        # wire (pool blocks only: the kind has no per-slot state), the
        # cache off (the move reschedules the source's queue); held, then
        # unheld for the ms
        mig = dict(rid=0, label="moe", expect=(None, None, 8))
        mgeom = dict(geom, prefix_cache=False)
        migrate(cfg, params, trace, off[4], mgeom, directory / "held", gpu,
                **mig)
        with holds.off():
            migrate(cfg, params, trace, off[4], mgeom, directory / "unheld",
                    gpu, **mig)
        free()
    holds.check(gpu, "moe")
    shutil.rmtree(directory, ignore_errors=True)

    # the kernel path against the plain path, bf16 at this arch's limits,
    # with the control that rounds one way; then f32 at 8 of 48 layers
    pparams = lm.pack_params(cfg, params)
    toks = torch.from_numpy(trace[0].prompt[None, :cfg.prefill_chunk]
                            .copy())
    nxt = int(trace[0].prompt[cfg.prefill_chunk])
    check_paths(cfg, pparams, toks, nxt, gpu)
    try:
        with attention_rounding_up(1):
            check_paths(cfg, pparams, toks, nxt, gpu)
        failed = ""
    except AssertionError as e:
        failed = str(e)
    print(f"[moe] control, paged decode one ulp up at every element: "
          f"check_paths failed with {failed!r}  [{gpu}]")
    assert "inputs drifted" in failed and "rounds one way" in failed, \
        "check_paths' bf16 holds must each fail a kernel that rounds one way"
    del pparams, params
    free()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=8)
    params32 = lm.init_params(cfg32, SEED, device="cuda")
    check_paths(cfg32, lm.pack_params(cfg32, params32), toks, nxt, gpu)
    del params32
    free()
    return launches


def llama4_serving(gpu: str) -> dict:
    """Phase 3d, llama4-scout-17b-a16e+xnor at full width (d 5120, 40 heads
    over 8 KV heads, 16 experts of d_ff 8192, top-1, vocab 202,048) and 4
    of its 48 layers (21 GB of bf16; the full 203 GB fits no single
    card), the attention packed at load: a 2-slot paged engine serves 4
    short requests with every launch of the three kernels held against
    its plain version, and a 1-slot engine gives the same tokens.  ->
    launch counts of the three kernels."""
    import gc

    import torch

    import repro_torch.configs as configs
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine, synthetic_trace

    cfg = dataclasses.replace(configs.get("llama4-scout-17b-a16e+xnor"),
                              n_layers=4)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            cfg.n_experts, cfg.top_k, cfg.d_ff_expert, cfg.vocab) == (
        5120, 40, 8, 128, 16, 1, 8192, 202048)
    trace = synthetic_trace(4, cfg.vocab, seed=SEED + 4,
                            prompt_lens=(8, 16, 24, 40), new_tokens=(8, 12))
    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[llama4] init {cfg.name} at 4 of 48 layers: "
          f"{lm.pdefs.count(lm.param_defs(cfg))} params, "
          f"{torch.cuda.memory_allocated() / 2**30} GiB on the card, in "
          f"{time.perf_counter() - t0} s")
    got = {}
    with LaunchHolds() as holds:
        kernels = [holds.orig[n] for n in ("pack", "xnor_linear_fused",
                                           "paged_decode_attention")]
        holds.active = True
        for f in kernels:
            f.launches = 0
        for slots in (2, 1):
            eng = ServeEngine(cfg, params, slots=slots, s_max=64,
                              device="cuda")
            for r in trace:
                eng.submit(r)
            rep = eng.run()
            torch.cuda.synchronize()
            assert all(s.done and len(s.tokens) == s.request.max_new_tokens
                       for s in rep.sessions.values())
            got[slots] = {r.rid: rep.tokens(r.rid).tolist() for r in trace}
            if slots == 2:
                launches = {f.__name__: f.launches for f in kernels}
            del eng
    holds.check(gpu, "llama4")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"
    print(f"[llama4] main-path launches (2 slots) {launches}; 1-slot tokens "
          f"as the 2-slot ones' on "
          f"{sum(got[1][r] == got[2][r] for r in got[2])}/4  [{gpu}]")
    assert got[1] == got[2], "llama4: the 1-slot engine's tokens differ"
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# llama-3.2-vision-11b's projections (the trunk's and the cross layers'
# alike) and whisper-tiny's (encoder and decoder alike), (N, K); the ctx
# projections run at M = the context's rows: the cross layers' wk/wv over
# 1,600 patch rows, and every encoder linear over 1,500 frames
VLM_LINEARS = {"llama-3.2-vision-11b": {"wq/wo": (4096, 4096),
                                        "wk/wv": (1024, 4096),
                                        "w1/w3": (14336, 4096),
                                        "w2": (4096, 14336)},
               "whisper-tiny": {"wq/wk/wv/wo": (384, 384),
                                "w1/w3": (1536, 384), "w2": (384, 1536)}}
VLM_CTX_ROWS = {"llama-3.2-vision-11b": (1600, ("wk/wv",)),
                "whisper-tiny": (1500, ("wq/wk/wv/wo", "w1/w3", "w2"))}
# decode attention: llama-3.2-vision's self-attention (KV 8, G 4, dh 128)
# and whisper's decoder (KV 6, G 1, dh 64), 4 slots, bs 16
VLM_PAGED = {"llama-3.2-vision-11b": dict(b=4, kv=8, g=4, dh=128, bs=16),
             "whisper-tiny": dict(b=4, kv=6, g=1, dh=64, bs=16)}


def vlm_arch_kernels(gpu: str) -> dict:
    """Phase 2 for the context archs: the fused linear at
    llama-3.2-vision-11b's and whisper-tiny's shapes, M 4 and 32 and, for
    the linears that read a context, M 1,600 (the cross layers' wk/wv over
    the patch rows) and M 1,500 (the encoder over the frames), f32 and
    bf16, bitwise in the kernel's order and within 2e-5 / 2^-8 of the
    plain version; llama's at M 4 and its ctx projection at M 1,600 timed
    against their byte bounds; one llama-3.2-vision decode step's 264
    fused linears (7 a layer x 32 attn + 5 a layer x 8 cross) as one CUDA
    graph against the step's byte bound; paged decode at both archs'
    geometry over W 8 and W 2048 tables (:func:`paged_readings`).  -> the
    W 8 bf16 paged readings by arch."""
    import torch

    from repro_torch.core import xnor_layers
    from repro_torch.kernels import cuda
    from repro_torch.kernels import xnor_gemm as kxnor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 20)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for arch, shapes in VLM_LINEARS.items():
        ctx_m, ctx_names = VLM_CTX_ROWS[arch]
        row = {}
        for name, (n, k) in shapes.items():
            pb, beta = xnor_layers.pack_weights(randn(n, k,
                                                      dtype=torch.bfloat16))
            ms = (4, 32) + ((ctx_m,) if name in ctx_names else ())
            for m in ms:
                for dt in (torch.float32, torch.bfloat16):
                    x = randn(m, k, dtype=dt)
                    kk = kxnor.xnor_linear_fused(x, pb, beta, k)
                    with cuda.plain_reference():
                        pp = kxnor.xnor_linear_fused(x, pb, beta, k)
                    assert torch.equal(kk, kxnor.linear_kernel_order(
                        x, pb, beta, k)), f"{arch} {name} M={m} {dt}"
                    f32 = dt == torch.float32
                    torch.testing.assert_close(
                        kk, pp, rtol=2e-5 if f32 else 2 ** -8,
                        atol=2e-5 if f32 else 1e-6)
            if arch == "llama-3.2-vision-11b":
                for m in (4, ctx_m) if name in ctx_names else (4,):
                    sets = copies(lambda: (
                        randn(m, k, dtype=torch.bfloat16),
                        *xnor_layers.pack_weights(
                            randn(n, k, dtype=torch.bfloat16)), k),
                        kxnor.linear_cost(m, n, k).bytes)
                    ms_ = time_ms(kxnor.xnor_linear_fused, sets, 50)
                    b_ms, b_by = bound(*kxnor.linear_cost(m, n, k))
                    plain = plain_step_ms(kxnor.xnor_linear_fused,
                                          sets[:2]) / 2
                    row[f"{name} M={m}"] = dict(ms=ms_, plain_ms=plain,
                                                bound_ms=b_ms, bound_by=b_by)
                    del sets
        print(f"[xnor_linear_fused {arch}] held bitwise in the kernel's "
              f"order at {list(shapes.values())} (N, K), M 4 and 32, and M "
              f"{ctx_m} at {list(ctx_names)}, f32 and bf16"
              + (f"; bf16 timings {json.dumps(row)}" if row else "")
              + f"  [{gpu}]")
        torch.cuda.empty_cache()

    # one llama-3.2-vision decode step: 32 attn layers x 7 linears and 8
    # cross layers x 5 (their wk/wv ran over the context at prefill), each
    # layer its own weights, M = 4, one CUDA graph
    shapes = VLM_LINEARS["llama-3.2-vision-11b"]
    per_layer = {"attn": ["wq/wo", "wk/wv", "wk/wv", "wq/wo", "w1/w3",
                          "w1/w3", "w2"],
                 "cross": ["wq/wo", "wq/wo", "w1/w3", "w1/w3", "w2"]}
    kinds = (["attn"] * 4 + ["cross"]) * 8
    calls, nbytes = [], 0
    for kind in kinds:
        for name in per_layer[kind]:
            n, k = shapes[name]
            pb, beta = xnor_layers.pack_weights(randn(n, k,
                                                      dtype=torch.bfloat16))
            calls.append((randn(4, k, dtype=torch.bfloat16), pb, beta, k))
            nbytes += kxnor.linear_cost(4, n, k).bytes
    assert len(calls) == 264
    step = time_ms(kxnor.xnor_linear_fused, calls, len(calls), 5) * len(calls)
    b_ms = bytes_ms(nbytes)
    plain = plain_step_ms(kxnor.xnor_linear_fused, calls)
    print(f"[xnor_linear_fused llama-3.2-vision decode step] {len(calls)} "
          f"launches (7 a layer x 32 attn + 5 a layer x 8 cross, M = 4) in "
          f"one CUDA graph: {step} ms, bound {b_ms} ms ({nbytes} bytes; "
          f"{step / b_ms} x); the plain version {plain} ms  [{gpu}]")
    del calls
    torch.cuda.empty_cache()

    cross_batch_probe(gpu, randn)
    w8 = {}
    for arch, geom in VLM_PAGED.items():
        label = arch.split("-")[0] + f" (KV {geom['kv']}, G {geom['g']}, " \
            f"dh {geom['dh']})"
        w8[arch] = paged_readings(gpu, label, geom, 8, [127, 100, 64, 17],
                                  randn, g)
        paged_readings(gpu, label, geom, 2048, [32767, 20000, 4095, 17],
                       randn, g)
    return w8


def cross_batch_probe(gpu: str, randn) -> None:
    """Hazard H2 at decode: one cross-attention layer at each context
    arch's full width, 8 slots, bf16 and f32.  Prints, for 2 to 8 slots,
    how many output elements of the batched form (``cross_attention``:
    every slot's products in one library call) differ from each slot run
    alone in that form, and asserts that the port's decode form
    (``decode_cross_attention``: each slot alone, its query heads grouped
    over the unexpanded KV heads) differs in none from itself at a batch
    of one."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.core import xnor_layers
    from repro_torch.models import attention as attn_mod

    for arch in VLM_PAGED:
        for dt in (torch.bfloat16, torch.float32):
            cfg = dataclasses.replace(configs.get(arch + "+xnor"), dtype=dt)
            d, hd = cfg.d_model, cfg.n_heads * cfg.d_head
            kvd = cfg.n_kv_heads * cfg.d_head
            p = {name: xnor_layers.pack_linear(randn(d, n, dtype=dt))
                 for name, n in (("wq", hd), ("wk", kvd), ("wv", kvd))}
            p["wo"] = xnor_layers.pack_linear(randn(hd, d, dtype=dt))
            kv = [attn_mod.make_ctx_kv(   # per slot, as admission runs it
                cfg, p, randn(1, cfg.n_ctx_tokens, d, dtype=dt) * 0.1)
                for _ in range(8)]
            kv = tuple(torch.cat(t) for t in zip(*kv))
            x = randn(8, 1, d, dtype=dt)
            alone, port_alone = (torch.cat([f(
                cfg, p, x[j:j + 1], tuple(t[j:j + 1] for t in kv))
                for j in range(8)]) for f in (
                    attn_mod.cross_attention,
                    attn_mod.decode_cross_attention))
            batched, port = {}, {}
            for b in range(2, 9):
                sub = tuple(t[:b] for t in kv)
                batched[b] = int((attn_mod.cross_attention(
                    cfg, p, x[:b], sub) != alone[:b]).sum())
                port[b] = int((attn_mod.decode_cross_attention(
                    cfg, p, x[:b], sub) != port_alone[:b]).sum())
            print(f"[cross_attention {arch} {str(dt)[6:]}] decode rows "
                  f"differing from each slot alone, of {d} a slot, by "
                  f"slots: batched form {batched}; the port's form "
                  f"{port}; the port's form alone against the batched "
                  f"form alone: {int((port_alone != alone).sum())} "
                  f"differ, max |d| "
                  f"{float((port_alone.float() - alone.float()).abs().max())}"
                  f"  [{gpu}]")
            assert not any(port.values()), port
            del p, kv
    torch.cuda.empty_cache()


def ctx_trace(vocab: int, n_ctx: int, d_model: int) -> list:
    """Phase 3's 8 requests, each with its own seeded (n_ctx, d_model)
    context (0.1 x standard normal, f32); the shared-prefix half shares
    one context, so its prefix blocks can be shared."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng([SEED, 0xC7C7, n_ctx])

    def draw():
        return (rng.standard_normal((n_ctx, d_model)) * 0.1).astype(
            np.float32)
    shared = draw()
    return [Request(r.rid, r.prompt, r.max_new_tokens,
                    ctx=shared if r.rid % 2 == 0 else draw())
            for r in slice_trace(vocab)]


def ctx_serving(gpu: str, arch: str, per_step: tuple, ctx_kv: tuple,
                label: str):
    """Phase 3e's engine gates on a context arch at full width and depth,
    bf16 weights from a seeded generator on the card, packed at load: a
    4-slot paged ServeEngine (block 16, chunk 32, s_max 128, prefix
    caching on) over :func:`ctx_trace`, every launch of pack, the fused
    linear and paged decode held against its plain version at every shape
    (:class:`LaunchHolds`); a 2-slot engine repeating its tokens; one
    unheld timed run repeating them (tok/s, TTFT, peak memory, ``per_step``
    fused linears and paged decodes every decode step); a session migrated
    mid-decode 4 -> 2 slots through an encrypted wire that carries its
    context and the per-slot ``ctx_kv`` (``ctx_kv``: dtype, (T_ctx, KV,
    dh)), held and then unheld.  -> (cfg, params, trace, launch counts)."""
    import gc
    import shutil
    import statistics

    import torch

    import repro_torch.configs as configs
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    cfg = configs.get(arch)
    trace = ctx_trace(cfg.vocab, cfg.n_ctx_tokens, cfg.d_model)
    rids = [r.rid for r in trace]
    geom = dict(slots=4, s_max=128, block_size=16, prefill_chunk=32)
    directory = ROOT / "experiments" / f"chip_smoke_{label}"
    shutil.rmtree(directory, ignore_errors=True)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def serve(eng):
        for r in trace:
            eng.submit(r)
        rep = eng.run()
        torch.cuda.synchronize()
        assert all(s.done for s in rep.sessions.values())
        return rep

    def tokens(rep):
        return {rid: rep.tokens(rid).tolist() for rid in rids}

    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[{label}] init {cfg.name}: {lm.pdefs.count(lm.param_defs(cfg))} "
          f"params, {torch.cuda.memory_allocated() / 2**30} GiB on the "
          f"card, in {time.perf_counter() - t0} s")
    with LaunchHolds() as holds:
        kernels = [holds.orig[n] for n in ("pack", "xnor_linear_fused",
                                           "paged_decode_attention")]
        holds.active = True
        for f in kernels:
            f.launches = 0
        eng = ServeEngine(cfg, params, device="cuda", **geom)
        assert eng.prefix_caching, f"prefix caching must be on for {arch}"
        assert eng._widths == {"full": 8}, eng._widths
        held = serve(eng)
        launches = {f.__name__: f.launches for f in kernels}
        want = tokens(held)
        for s in held.sessions.values():
            assert len(s.tokens) == s.request.max_new_tokens
            assert all(0 <= t < cfg.vocab for t in s.tokens)
        for name, n in launches.items():
            assert n > 0, f"kernel {name} never launched on the main path"
        st = held.stats
        assert st.prefix_hits > 0, "the shared prefix was never hit"
        print(f"[{label}] main-path launches (held run) {launches}; prefix "
              f"hits {st.prefix_hits}, cow {st.cow_copies}  [{gpu}]")
        del eng
        free()
        two = tokens(serve(ServeEngine(cfg, params, device="cuda",
                                       **dict(geom, slots=2))))
        print(f"[{label}] held: the 2-slot engine's tokens as the 4-slot "
              f"one's on {sum(two[r] == want[r] for r in rids)}/8  [{gpu}]")
        assert two == want, "the 2-slot engine's tokens differ"
        free()

        # the unheld timed run, launches read around every decode step
        with holds.off():
            torch.cuda.reset_peak_memory_stats()
            eng = ServeEngine(cfg, params, device="cuda", **geom)
            counts, decode_once = [], eng._decode_once

            def counted():
                before = [f.launches for f in kernels[1:]]
                decode_once()
                counts.append(tuple(f.launches - b for f, b in
                                    zip(kernels[1:], before)))
            eng._decode_once = counted
            rep = serve(eng)
            del eng._decode_once
            peak = torch.cuda.max_memory_allocated()
            del eng
        assert tokens(rep) == want, "the unheld run's tokens differ"
        ttft = rep.ttft_quantiles((0.5, 0.95))
        st = rep.stats
        print(f"[{label}] unheld run: {rep.generated} tokens in {rep.wall} s "
              f"-> {rep.tok_per_s} tok/s; TTFT p50 {ttft[0.5] * 1e3} ms p95 "
              f"{ttft[0.95] * 1e3} ms; {st.prefill_chunks} prefill chunks, "
              f"{st.decode_steps} decode steps, prefix hits "
              f"{st.prefix_hits}; peak device memory {peak / 2**30} GiB; "
              f"tokens as the held run's: True  [{gpu}]")
        print(f"[{label}] launches per decode step (fused linear, paged "
              f"decode): median {statistics.median(p[0] for p in counts)}, "
              f"{statistics.median(p[1] for p in counts)} over "
              f"{len(counts)} steps  [{gpu}]")
        assert counts and all(p == per_step for p in counts), counts

        # a session migrated mid-decode 4 -> 2 slots through an encrypted
        # wire: attention blocks, the per-slot ctx_kv and the raw context;
        # held, then unheld for the ms
        mig = dict(rid=0, label=label, expect=(None, None, 8), ctx_kv=ctx_kv)
        migrate(cfg, params, trace, want, geom, directory / "held", gpu,
                **mig)
        with holds.off():
            migrate(cfg, params, trace, want, geom, directory / "unheld",
                    gpu, **mig)
        free()
    holds.check(gpu, label)
    shutil.rmtree(directory, ignore_errors=True)
    return cfg, params, trace, launches


def whisper_serving(gpu: str) -> dict:
    """Phase 3e, whisper-tiny+xnor at full width and depth (a 4-layer
    encoder over 1,500 frames, 4 ``dec`` layers: d 384, 6 heads of 64,
    vocab 51,865), each request's frames encoded once at admission:
    :func:`ctx_serving`'s gates with 36 fused linears and 4 paged decodes
    every decode step, and in f32 the dense layout, the paged one and
    ``generate_static`` giving the same tokens.  -> launch counts of the
    three kernels."""
    import gc

    import torch

    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine
    from repro_torch.train import serve_step

    cfg, params, trace, launches = ctx_serving(
        gpu, "whisper-tiny+xnor", (36, 4),
        ("torch.bfloat16", (1500, 6, 64)), "whisper")
    assert (cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab,
            cfg.n_ctx_tokens) == (4, 4, 384, 6, 6, 64, 1536, 51865, 1500)
    del params
    rids = [r.rid for r in trace]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = lm.init_params(cfg32, SEED, device="cuda")

    def tokens(eng):
        for r in trace:
            eng.submit(r)
        rep = eng.run()
        return {rid: rep.tokens(rid).tolist() for rid in rids}
    f32 = dict(slots=4, s_max=128, device="cuda")
    paged = tokens(ServeEngine(cfg32, params32, **f32))
    two = tokens(ServeEngine(cfg32, params32, **dict(f32, slots=2)))
    print(f"[whisper] f32 greedy: the 2-slot paged engine's tokens as the "
          f"4-slot one's on {sum(two[x] == paged[x] for x in rids)}/8  "
          f"[{gpu}]")
    assert two == paged, "f32: the 2-slot engine's tokens differ"
    eng = ServeEngine(cfg32, params32, paged=False, **f32)
    dense = tokens(eng)
    static = {r.rid: serve_step.generate_static(
        cfg32, eng.params, torch.from_numpy(r.prompt[None]).cuda(),
        r.max_new_tokens, ctx=torch.from_numpy(r.ctx[None]).cuda()
    )[0].tolist() for r in trace}
    print(f"[whisper] f32 greedy: dense = paged on "
          f"{sum(dense[x] == paged[x] for x in rids)}/8, generate_static = "
          f"dense on {sum(static[x] == dense[x] for x in rids)}/8  [{gpu}]")
    assert dense == paged, "f32: the dense layout's tokens differ from paged"
    assert static == dense, "f32: generate_static differs from the engine"
    del eng, params32
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def vlm_serving(gpu: str) -> dict:
    """Phase 3e, llama-3.2-vision-11b+xnor at full width and depth (40
    layers, every 5th ``cross``: d 4096, 32 heads over 8 KV heads of 128,
    d_ff 14,336, vocab 128,256), each request with its own 1,600 x 4,096
    context of patch embeddings: :func:`ctx_serving`'s gates with 264
    fused linears and 32 paged decodes every decode step; then
    :func:`check_paths` on the first request's prompt and context in bf16
    at this arch's limits with the one-ulp-up control failing them, and
    in f32 at full depth (a 39 GB tree).  -> launch counts of the three
    kernels."""
    import gc

    import torch

    from repro_torch.models import lm

    cfg, params, trace, launches = ctx_serving(
        gpu, "llama-3.2-vision-11b+xnor", (264, 32),
        ("torch.bfloat16", (1600, 8, 128)), "vlm")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab, cfg.n_ctx_tokens,
            cfg.dtype) == (40, 4096, 32, 8, 128, 14336, 128256, 1600,
                           torch.bfloat16)
    assert sum(n for k, n in cfg.segments() if k == "cross") == 8

    # the kernel path against the plain path, bf16 at this arch's limits,
    # with the control that rounds one way; then f32 at full depth
    pparams = lm.pack_params(cfg, params)
    toks = torch.from_numpy(trace[0].prompt[None, :cfg.prefill_chunk]
                            .copy())
    nxt = int(trace[0].prompt[cfg.prefill_chunk])
    ctx = torch.from_numpy(trace[0].ctx[None])
    check_paths(cfg, pparams, toks, nxt, gpu, ctx=ctx)
    try:
        with attention_rounding_up(1):
            check_paths(cfg, pparams, toks, nxt, gpu, ctx=ctx)
        failed = ""
    except AssertionError as e:
        failed = str(e)
    print(f"[vlm] control, paged decode one ulp up at every element: "
          f"check_paths failed with {failed!r}  [{gpu}]")
    assert "inputs drifted" in failed and "rounds one way" in failed, \
        "check_paths' bf16 holds must each fail a kernel that rounds one way"
    del pparams, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = lm.init_params(cfg32, SEED, device="cuda")
    pparams32 = lm.pack_params(cfg32, params32)
    del params32
    check_paths(cfg32, pparams32, toks, nxt, gpu, ctx=ctx)
    del pparams32
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# xlstm-350m's binarized linears at full width (N, K): the mLSTM's
# up-projections 1024 -> 2048, q / k / v 2048 -> 2048, down 2048 -> 1024;
# the sLSTM's gates 1024 -> 4096 and GLU 1024 -> 2688, 1344 -> 1024 (K 42
# words); xnor-cnn's binary layers 64 -> 256 -> 64 (K 2 and 8 words)
XLSTM_LINEARS = {"xlstm-350m": {"mlstm w_up/w_gate": (2048, 1024),
                                "mlstm wq/wk/wv": (2048, 2048),
                                "mlstm w_down": (1024, 2048),
                                "slstm w_gates": (4096, 1024),
                                "slstm w_up": (2688, 1024),
                                "slstm w_down": (1024, 1344)},
                 "xnor-cnn": {"w_up": (256, 64), "w_down": (64, 256)}}
# one decode step's launches in layer order, by kind
XLSTM_STEP = {"mlstm": ["mlstm w_up/w_gate", "mlstm w_up/w_gate",
                        "mlstm wq/wk/wv", "mlstm wq/wk/wv", "mlstm wq/wk/wv",
                        "mlstm w_down"],
              "slstm": ["slstm w_gates", "slstm w_up", "slstm w_down"],
              "bindense": ["w_up", "w_down"]}


def xlstm_arch_kernels(gpu: str) -> dict:
    """Phase 2 for xlstm-350m and xnor-cnn: the fused linear at each of
    their shapes, M 4 and 32, f32 and bf16, bitwise in the kernel's order
    and within 2e-5 / 2^-8 of the plain version; each shape at M 4 (bf16
    for xlstm, f32 for xnor-cnn, their dtypes) timed against its byte
    bound and the plain version; one decode step's fused linears of each
    arch (xlstm: 6 a layer x 21 mLSTM + 3 x 3 sLSTM = 135; xnor-cnn: 2 x 2)
    as one CUDA graph against the step's byte bound.  Then hazard H2's
    probe of the two xLSTM blocks' decode (:func:`xlstm_batch_probe`).
    -> the per-shape and per-step readings."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.core import xnor_layers
    from repro_torch.kernels import cuda
    from repro_torch.kernels import xnor_gemm as kxnor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 21)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = {}
    for arch, shapes in XLSTM_LINEARS.items():
        dt_time = torch.float32 if arch == "xnor-cnn" else torch.bfloat16
        item = 4 if dt_time == torch.float32 else 2
        row = {}
        for name, (n, k) in shapes.items():
            pb, beta = xnor_layers.pack_weights(randn(n, k, dtype=dt_time))
            for m in (4, 32):
                for dt in (torch.float32, torch.bfloat16):
                    x = randn(m, k, dtype=dt)
                    kk = kxnor.xnor_linear_fused(x, pb, beta, k)
                    with cuda.plain_reference():
                        pp = kxnor.xnor_linear_fused(x, pb, beta, k)
                    assert torch.equal(kk, kxnor.linear_kernel_order(
                        x, pb, beta, k)), f"{arch} {name} M={m} {dt}"
                    f32 = dt == torch.float32
                    torch.testing.assert_close(
                        kk, pp, rtol=2e-5 if f32 else 2 ** -8,
                        atol=2e-5 if f32 else 1e-6)
            nbytes = kxnor.linear_cost(4, n, k, item).bytes
            sets = copies(lambda: (
                randn(4, k, dtype=dt_time),
                *xnor_layers.pack_weights(randn(n, k, dtype=dt_time)), k),
                nbytes)
            ms = time_ms(kxnor.xnor_linear_fused, sets, 50)
            b_ms, b_by = bound(*kxnor.linear_cost(4, n, k, item))
            plain = plain_step_ms(kxnor.xnor_linear_fused, sets[:2]) / 2
            row[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by)
            del sets
        print(f"[xnor_linear_fused {arch}] held bitwise in the kernel's "
              f"order at {list(shapes.values())} (N, K), M 4 and 32, f32 "
              f"and bf16; M 4 {str(dt_time)[6:]} timings {json.dumps(row)}"
              f"  [{gpu}]")
        out[arch] = row
        torch.cuda.empty_cache()

        # one decode step's fused linears, each layer its own weights
        cfg = configs.get(arch)
        calls, nbytes = [], 0
        for kind in cfg.layer_kinds():
            for name in XLSTM_STEP[kind]:
                n, k = shapes[name]
                pb, beta = xnor_layers.pack_weights(randn(n, k,
                                                          dtype=dt_time))
                calls.append((randn(4, k, dtype=dt_time), pb, beta, k))
                nbytes += kxnor.linear_cost(4, n, k, item).bytes
        step = time_ms(kxnor.xnor_linear_fused, calls, len(calls),
                       5) * len(calls)
        b_ms = bytes_ms(nbytes)
        plain = plain_step_ms(kxnor.xnor_linear_fused, calls)
        print(f"[xnor_linear_fused {arch} decode step] {len(calls)} "
              f"launches (M = 4, {str(dt_time)[6:]}) in one CUDA graph: "
              f"{step} ms, bound {b_ms} ms ({nbytes} bytes; {step / b_ms} "
              f"x); the plain version {plain} ms  [{gpu}]")
        out[arch + " step"] = dict(launches=len(calls), ms=step,
                                   bound_ms=b_ms, plain_ms=plain)
        del calls
        torch.cuda.empty_cache()
    xlstm_batch_probe(gpu)
    return out


def xlstm_batch_probe(gpu: str) -> None:
    """Hazard H2 at decode for the xLSTM kinds: one mLSTM and one sLSTM
    layer of xlstm-350m+xnor at full width, packed, bf16 and f32, decoding
    8 slots from a random per-slot state (the mLSTM's 4 MiB memory a slot
    among it).  For 1 to 8 slots, each slot's output row and its new
    state must be the bits it gets decoding alone: the reductions over a
    step's rows (the mLSTM's C q and |n q|, the f32 ``w_if`` product, the
    sLSTM's recurrent product, RMSNorm) go through ``layers.row_sum``.
    Prints the elements that differ by slot count (all must be 0)."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.models import blocks, registry
    from repro_torch.models import params as pdefs

    dev = torch.device("cuda")
    for kind in ("mlstm", "slstm"):
        for dt in (torch.bfloat16, torch.float32):
            cfg = dataclasses.replace(configs.get("xlstm-350m+xnor"),
                                      dtype=dt)
            block = registry.get(kind)
            defs = block.defs(cfg, 1)
            g = torch.Generator(device=dev)
            g.manual_seed(SEED + 22)
            p = blocks.layer_params(pdefs.pack(defs, pdefs.init(defs, g,
                                                                dev)), 0)
            state = block.state_spec(cfg, 1, 8, 0, dev)
            for leaf in blocks.state_leaves(state):
                leaf.copy_(torch.randn(leaf.shape, generator=g,
                                       device=dev).to(leaf.dtype))
            start = [t.clone() for t in blocks.state_leaves(state)]
            x = torch.randn((8, 1, cfg.d_model), generator=g,
                            device=dev).to(dt)

            def step(lo, hi):
                for leaf, t in zip(blocks.state_leaves(state), start):
                    leaf.copy_(t)
                st = blocks.state_map(lambda l: l[:, lo:hi], state)
                y = block.decode(cfg, p, x[lo:hi], blocks._layer(st, 0),
                                 None, None)
                return [y] + [l[0, lo:hi].clone()
                              for l in blocks.state_leaves(state)]
            alone = [torch.cat(t) for t in zip(*(step(j, j + 1)
                                                for j in range(8)))]
            differ = {}
            for b in range(2, 9):
                got = step(0, b)
                differ[b] = sum(int((a != w[:b]).sum())
                                for a, w in zip(got, alone))
            print(f"[{kind} {str(dt)[6:]} H2] decode output and state "
                  f"elements differing from each slot alone, by slots: "
                  f"{differ}  [{gpu}]")
            assert not any(differ.values()), (kind, dt, differ)
            del p, state, start
    torch.cuda.empty_cache()


def xlstm_serving(gpu: str) -> dict:
    """Phase 3f, xlstm-350m+xnor at full width and depth (24 layers, 21
    ``mlstm`` and 3 ``slstm``: d 1024, 4 heads, the mLSTM's memory 4 x 512
    x 512 f32 a slot a layer; vocab 50,304), bf16 weights from a seeded
    generator on the card, packed at load, served by a 4-slot ServeEngine
    (chunk 32, s_max 128) over phase 3's 8 requests.  No table class, so
    no pool: the per-slot state is the whole decode state, and prefix
    caching is off.

    Gates: pack and the fused linear launched on the main path, every
    launch of the held run held against its plain version at every shape
    (:class:`LaunchHolds`); a 2-slot engine with the same tokens; an
    unheld timed run repeating them (tok/s, TTFT, peak memory, 135 fused
    linears every decode step); a session migrated mid-decode 4 -> 2
    slots through an encrypted wire carrying its per-slot state (its
    bytes printed), held then unheld; in f32, the dense layout's tokens
    equal to the paged one's on 8 prompts of one prefill chunk, where both
    layouts chunk the mLSTM alike (on phase 3's trace, chunked otherwise,
    the agreement is printed).  -> launch counts of the two kernels."""
    import gc
    import shutil
    import statistics

    import torch

    import repro_torch.configs as configs
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine, synthetic_trace

    cfg = configs.get("xlstm-350m+xnor")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.proj_factor,
            cfg.mlstm_chunk, cfg.conv_width, cfg.vocab, cfg.dtype) == (
        24, 1024, 4, 2.0, 64, 4, 50304, torch.bfloat16)
    assert [k for k, _ in cfg.segments()] == ["mlstm", "slstm"] * 3
    trace = slice_trace(cfg.vocab)
    rids = [r.rid for r in trace]
    geom = dict(slots=4, s_max=128, prefill_chunk=32)
    directory = ROOT / "experiments" / "chip_smoke_xlstm"
    shutil.rmtree(directory, ignore_errors=True)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def serve(eng, requests=trace):
        for r in requests:
            eng.submit(r)
        rep = eng.run()
        torch.cuda.synchronize()
        assert all(s.done for s in rep.sessions.values())
        return rep

    def tokens(rep):
        return {rid: rep.tokens(rid).tolist() for rid in rids}

    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"[xlstm] init {cfg.name}: {lm.pdefs.count(lm.param_defs(cfg))} "
          f"params, {torch.cuda.memory_allocated() / 2**30} GiB on the "
          f"card, in {time.perf_counter() - t0} s")
    with LaunchHolds() as holds:
        kernels = [holds.orig[n] for n in ("pack", "xnor_linear_fused")]
        holds.active = True
        for f in kernels:
            f.launches = 0
        eng = ServeEngine(cfg, params, device="cuda", **geom)
        assert eng.blocks is None and not eng.prefix_caching, \
            "xlstm has no pool and no prefix cache"
        assert eng._widths == {}, eng._widths
        held = serve(eng)
        launches = {f.__name__: f.launches for f in kernels}
        want = tokens(held)
        for s in held.sessions.values():
            assert len(s.tokens) == s.request.max_new_tokens
            assert all(0 <= t < cfg.vocab for t in s.tokens)
        for name, n in launches.items():
            assert n > 0, f"kernel {name} never launched on the main path"
        print(f"[xlstm] main-path launches (held run) {launches}  [{gpu}]")
        del eng
        free()
        two = tokens(serve(ServeEngine(cfg, params, device="cuda",
                                       **dict(geom, slots=2))))
        print(f"[xlstm] held: the 2-slot engine's tokens as the 4-slot "
              f"one's on {sum(two[r] == want[r] for r in rids)}/8  [{gpu}]")
        assert two == want, "the 2-slot engine's tokens differ"
        free()

        # the unheld timed runs (two, for a spread), launches read around
        # every decode step
        with holds.off():
            runs = []
            for _ in range(2):
                torch.cuda.reset_peak_memory_stats()
                eng = ServeEngine(cfg, params, device="cuda", **geom)
                counts, decode_once = [], eng._decode_once

                def counted(decode_once=decode_once, counts=counts):
                    before = kernels[1].launches
                    decode_once()
                    counts.append(kernels[1].launches - before)
                eng._decode_once = counted
                rep = serve(eng)
                peak = torch.cuda.max_memory_allocated()
                del eng
                assert tokens(rep) == want, "the unheld run's tokens differ"
                runs.append(rep.tok_per_s)
                assert counts and all(c == 135 for c in counts), counts
        ttft = rep.ttft_quantiles((0.5, 0.95))
        st = rep.stats
        print(f"[xlstm] unheld runs: {rep.generated} tokens, tok/s {runs} "
              f"(median {statistics.median(runs)}); TTFT p50 "
              f"{ttft[0.5] * 1e3} ms p95 {ttft[0.95] * 1e3} ms; "
              f"{st.prefill_chunks} prefill chunks, {st.decode_steps} decode "
              f"steps; peak device memory {peak / 2**30} GiB; 135 fused "
              f"linears every decode step; tokens as the held run's: True  "
              f"[{gpu}]")

        # a session migrated mid-decode 4 -> 2 slots through an encrypted
        # wire of its per-slot state alone (no pool); held, then unheld
        di, nh = int(cfg.proj_factor * cfg.d_model), cfg.n_heads
        dh = di // nh
        slot_leaves = {("torch.float32", (1, nh, dh, dh)),
                       ("torch.float32", (1, nh, dh)),
                       ("torch.float32", (1, nh)),
                       ("torch.bfloat16", (1, cfg.conv_width - 1, di)),
                       ("torch.float32", (1, cfg.d_model))}
        mig = dict(rid=0, label="xlstm", slot_leaves=slot_leaves)
        migrate(cfg, params, trace, want, geom, directory / "held", gpu,
                **mig)
        with holds.off():
            migrate(cfg, params, trace, want, geom, directory / "unheld",
                    gpu, **mig)
        free()
    holds.check(gpu, "xlstm")
    shutil.rmtree(directory, ignore_errors=True)
    del params
    free()

    # f32: the slot-dense layout (the whole prompt in one prefill, the
    # mLSTM in chunks of min(64, S)) against the paged one (prefill chunks
    # of 32).  On 8 prompts of exactly one prefill chunk both run the same
    # chunked form, so the tokens must be equal; on phase 3's trace (8-64
    # tokens) the chunkings differ, and the f32 sums with them: printed
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = lm.init_params(cfg32, SEED, device="cuda")
    f32 = dict(slots=4, s_max=128, device="cuda")
    one = synthetic_trace(8, cfg.vocab, seed=SEED + 1, prompt_lens=(32,),
                          new_tokens=(8, 12, 16))
    agree = {}
    for label, reqs in (("one", one), ("phase3", trace)):
        paged, dense = ({r.rid: rep.tokens(r.rid).tolist() for r in reqs}
                        for rep in (serve(ServeEngine(cfg32, params32, **f32),
                                          reqs),
                                    serve(ServeEngine(cfg32, params32,
                                                      paged=False, **f32),
                                          reqs)))
        agree[label] = (sum(dense[r.rid] == paged[r.rid] for r in reqs),
                        dense == paged)
    print(f"[xlstm] f32 greedy, dense = paged: on 8 one-chunk (32-token) "
          f"prompts {agree['one'][0]}/8; on phase 3's trace, chunked "
          f"differently, {agree['phase3'][0]}/8  [{gpu}]")
    assert agree["one"][1], \
        "f32: the dense layout's tokens differ on one-chunk prompts"
    del params32
    free()
    return launches


def xnor_cnn_serving(gpu: str) -> dict:
    """Phase 3f, the paper's classifier served as an arch: xnor-cnn (2
    ``bindense`` layers, d 64, d_ff 256, f32; nothing to cut), weights from
    a seeded generator on the card, packed at load.  12 classification
    requests built with the port's ``bcnn.synthetic_images`` (drawn on the
    card) and ``bcnn.image_ctx``: one ``QUERY_TOKEN`` prompt, the image's
    four 64-pixel bands as the context, 1 new token.  Gates: pack and the
    fused linear launched on the main path and every launch held; a
    2-slot engine with the 4-slot one's classes; the same engine run on
    the plain path (``cuda.plain_reference``) with the same classes, and
    the prefill logits of all 12 images within 1e-4 of the plain path's.
    -> launch counts of the two kernels."""
    import numpy as np
    import torch

    import repro_torch.configs as configs
    from repro_torch.core import prng
    from repro_torch.kernels import cuda
    from repro_torch.models import bcnn, lm
    from repro_torch.serve import Request, ServeEngine

    cfg = configs.get("xnor-cnn")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_ctx_tokens,
            cfg.vocab, cfg.quant, cfg.dtype) == (2, 64, 256, 4, 4, "xnor",
                                                 torch.float32)
    images, labels = bcnn.synthetic_images(prng.PRNGKey(SEED,
                                                        device="cuda"), 12)
    assert images.is_cuda and images.shape == (12, 16, 16)
    ctx = bcnn.image_ctx(cfg, images)
    prompt = np.array([bcnn.QUERY_TOKEN], np.int32)
    trace = [Request(i, prompt, 1, ctx=ctx[i]) for i in range(12)]
    params = lm.init_params(cfg, SEED, device="cuda")

    def classes(slots):
        eng = ServeEngine(cfg, params, slots=slots, s_max=8, device="cuda")
        for r in trace:
            eng.submit(r)
        rep = eng.run()
        return [rep.tokens(i).tolist() for i in range(12)]

    with LaunchHolds() as holds:
        kernels = [holds.orig[n] for n in ("pack", "xnor_linear_fused")]
        holds.active = True
        for f in kernels:
            f.launches = 0
        four = classes(4)
        launches = {f.__name__: f.launches for f in kernels}
        for name, n in launches.items():
            assert n > 0, f"kernel {name} never launched on the main path"
        two = classes(2)
    holds.check(gpu, "xnor-cnn")
    with cuda.plain_reference():
        plain = classes(4)
    toks = torch.full((12, 1), bcnn.QUERY_TOKEN, dtype=torch.int64,
                      device="cuda")
    pparams = lm.pack_params(cfg, params)
    kl, _ = lm.prefill(cfg, pparams, toks, 8, ctx=torch.from_numpy(ctx)
                       .cuda())
    with cuda.plain_reference():
        pl, _ = lm.prefill(cfg, pparams, toks, 8,
                           ctx=torch.from_numpy(ctx).cuda())
    err = float((kl - pl).abs().max())
    print(f"[xnor-cnn] main-path launches {launches}; classes of 12 images "
          f"(labels {labels.tolist()}): {[t[0] for t in four]}; the 2-slot "
          f"engine's as the 4-slot one's: {two == four}; the plain path's: "
          f"{plain == four}; prefill logits max |kernel - plain| {err}  "
          f"[{gpu}]")
    assert all(len(t) == 1 and 0 <= t[0] < cfg.vocab for t in four)
    assert two == four, "xnor-cnn: the 2-slot engine's classes differ"
    assert plain == four, "xnor-cnn: the plain path's classes differ"
    assert err <= 1e-4, err
    return launches


# ---------------------------------------------------------------------------
# phase 9: training, then the transcribe and classify workloads
# ---------------------------------------------------------------------------

# tests/test_torch_train.py's tolerances for one f32 step against the
# reference, which 9b holds the card to against the CPU
TRAIN_METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_GRAD_REL = 2e-5
TRAIN_SETTLED = 1e-3
TRAIN_PARAM_TOL = dict(rtol=1e-5, atol=2e-6)
# tests/test_train_integration.py's restart tolerances (9c)
RESTART_TOL = dict(rtol=2e-2, atol=2e-3)
RESTART_LOSS = 2e-2
TRAIN_KEY = "chip-smoke-train-key"


def train_cfg():
    """9a's configuration: qwen2-7b+xnor, bf16, at full width with its
    depth cut from 28 layers to 4 (at 28 the training state, bf16
    parameters and gradients and f32 moments, is ~91 GB: it needs the
    sharding of ROADMAP item 6)."""
    import repro_torch.configs as configs
    return dataclasses.replace(configs.get("qwen2-7b+xnor"), n_layers=4)


def train_main(gpu: str) -> dict:
    """9a: 20 train_steps of :func:`train_cfg` on ``synthetic.Pipeline``
    batches of 4 x 256 tokens (peak lr 1e-3, warmup 10): loss and gnorm finite every step, and the
    reference test's learning gate (the last 5 losses' mean under the
    first 5's by 0.05).  The reference test's 3e-3 is a smoke-width rate:
    at full width AdamW's steps of ~lr an element are 40 % of a w2 weight
    (init 1/sqrt(18,944)), the binary layers' signs churn, and the loss
    rose from 12.44 to 12.93 (PERF.md, Findings).  Prints the median step,
    tokens/s, peak device memory and model FLOP/s (6 N_active tokens over
    the step)."""
    import math
    import statistics

    import torch

    from repro_torch.data import synthetic
    from repro_torch.models import lm
    from repro_torch.train import train_step as train_mod

    cfg, batch, seq, steps, lr = train_cfg(), 4, 256, 20, 1e-3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = train_mod.init_state(cfg, SEED, device="cuda")
    pipe = synthetic.Pipeline(cfg, batch, seq, seed=SEED)
    losses, gnorms, times = [], [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = synthetic.to_device(pipe.get(step), "cuda")
        state, m = train_mod.train_step(cfg, state, b, step, peak_lr=lr,
                                        warmup=10, total=steps)
        losses.append(float(m["loss"]))            # waits for the step
        gnorms.append(float(m["gnorm"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    tokens = batch * seq
    flops = lm.model_flops(cfg, "train", tokens)
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"[train] {cfg.name} x {cfg.n_layers} layers, {cfg.dtype}: "
          f"{lm.param_count(cfg)} params ({lm.active_param_count(cfg)} "
          f"active), batch {batch} x {seq}, {steps} steps at lr {lr}: first "
          f"step {times[0] * 1e3} ms, median step {step_s * 1e3} ms, "
          f"{tokens / step_s} tokens/s, peak device memory {peak / 2**30} "
          f"GiB, model FLOP/s {flops / step_s} ({flops} a step)  [{gpu}]")
    print(f"[train] losses {losses}; gnorms {gnorms}; first-5 mean {first}, "
          f"last-5 mean {last}  [{gpu}]")
    assert all(math.isfinite(x) for x in losses + gnorms), "non-finite step"
    assert last < first - 0.05, f"9a did not learn: {first} -> {last}"
    del state
    return {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "peak_gib": peak / 2**30, "flop_s": flops / step_s}


def _leaf_dict(tree) -> dict:
    from repro_torch.core import verify
    return {verify.leaf_key(p): t
            for p, t in verify.tree_flatten_with_path(tree)}


def train_card_vs_cpu(gpu: str):
    """9b: one seed, config (qwen2-7b+xnor smoke, f32) and batches on the
    card and on the CPU, ``steps`` steps, each taken by both devices from
    the CPU's state (the claim the CPU tests make is one step's).  Each
    step's loss, ce and gnorm within ``TRAIN_METRIC_TOL``, its gradients
    within ``TRAIN_GRAD_REL`` of each leaf's largest |g|, and the
    parameters after it within ``TRAIN_PARAM_TOL`` where the step is
    settled, else within two learning rates: the CPU tests' tolerances
    against the reference.  Settled: the first moment after the step at
    least ``TRAIN_SETTLED`` of its leaf's largest (on the first step that
    is |g| itself, as in the CPU tests; later, a moment that cancels to
    near zero amplifies the gradient's last bits as a near-zero gradient
    does).  The worst readings print before the gates."""
    import numpy as np
    import torch

    import repro_torch.configs as configs
    from repro_torch.core import verify
    from repro_torch.data import synthetic
    from repro_torch.train import train_step as train_mod

    cfg = configs.get("qwen2-7b+xnor").smoke(dtype=torch.float32)
    pipe = synthetic.Pipeline(cfg, 4, 32, seed=SEED)
    steps, lr, devices = 3, 3e-3, ("cuda", "cpu")
    kw = dict(peak_lr=lr, warmup=0, total=steps)
    state = train_mod.init_state(cfg, SEED, device="cpu")
    worst = {"metric": 0.0, "grad": 0.0, "param": 0.0, "unsettled": 0.0}
    fails = []
    for step in range(steps):
        host = pipe.get(step)
        out = {}
        for d in devices:
            st = verify.tree_map(lambda t: t.to(d, copy=True), state)
            b = synthetic.to_device(host, d)
            _, _, g = train_mod._grads(cfg, st.params, b)
            st, m = train_mod.train_step(cfg, st, b, step, **kw)
            out[d] = (m, _leaf_dict(g), _leaf_dict(st.params),
                      _leaf_dict(st.opt.m), st)
        (mc, gc_, pc, _, _), (mh, gh, ph, mom, state) = (out[devices[0]],
                                                         out[devices[1]])
        for k in ("loss", "ce", "gnorm"):
            a, w = float(mc[k]), float(mh[k])
            worst["metric"] = max(worst["metric"], abs(a - w) / abs(w))
            if abs(a - w) > TRAIN_METRIC_TOL["atol"] \
                    + TRAIN_METRIC_TOL["rtol"] * abs(w):
                fails.append((step, k, a, w))
        for key, want in gh.items():
            w, got = want.numpy(), gc_[key].cpu().numpy()
            scale = np.abs(w).max()
            err = float(np.abs(got - w).max()) / max(scale, 1e-30)
            worst["grad"] = max(worst["grad"], err)
            if err > TRAIN_GRAD_REL:
                fails.append((step, "grad " + key, err))
            mo = np.abs(mom[key].numpy())
            firm = mo >= TRAIN_SETTLED * mo.max()
            pw, pg = ph[key].numpy(), pc[key].cpu().numpy()
            d_all = np.abs(pg - pw)
            room = TRAIN_PARAM_TOL["atol"] + TRAIN_PARAM_TOL["rtol"] \
                * np.abs(pw)
            worst["param"] = max(worst["param"],
                                 float((d_all[firm] / room[firm]).max(
                                     initial=0.0)))
            worst["unsettled"] = max(worst["unsettled"],
                                     float(d_all.max()) / lr)
            if np.any(d_all[firm] > room[firm]) or np.any(
                    d_all > 2 * lr + room):
                fails.append((step, "param " + key,
                              float(d_all[firm].max(initial=0.0))))
    print(f"[train] 9b {cfg.name} f32, {steps} steps, {devices[0]} against "
          f"{devices[1]}: max relative loss / ce / gnorm diff "
          f"{worst['metric']}, max grad diff / leaf max {worst['grad']}, "
          f"max settled param diff / its tolerance {worst['param']}, max "
          f"param diff / lr {worst['unsettled']}; failures {fails}  [{gpu}]")
    assert not fails, fails
    return worst


def _no_checkpoint():
    raise AssertionError("the runner found no checkpoint to resume")


def train_runner_drill(gpu: str) -> dict:
    """9c: whisper-tiny+xnor at full width and depth (4 enc + 4 dec
    layers over 1,500-frame contexts): 20 straight steps against 10 steps
    with encrypted ``Runner`` saves every 5, the newest checkpoint
    truncated (the runner must fall back to step 5), a resume and the
    steps to 20.  Final parameters at the reference test's restart
    tolerances (params rtol 2e-2 / atol 2e-3, last loss within 2e-2);
    every ``parity_digest`` and ``xor_cipher`` launch held against its
    plain version.  -> their launch counts; the save and restore seconds
    printed."""
    import shutil

    import numpy as np
    import torch

    import repro_torch.configs as configs
    from repro_torch.data import synthetic
    from repro_torch.distributed import fault
    from repro_torch.train import train_step as train_mod

    cfg, batch, seq = configs.get("whisper-tiny+xnor"), 4, 32
    directory = ROOT / "experiments" / "chip_smoke_train"
    shutil.rmtree(directory, ignore_errors=True)
    pipe = synthetic.Pipeline(cfg, batch, seq, seed=SEED)
    kw = dict(peak_lr=3e-3, warmup=5, total=20)

    def run(state, start, stop, runner=None, times=None):
        losses = []
        for step in range(start, stop):
            state, m = train_mod.train_step(
                cfg, state, synthetic.to_device(pipe.get(step), "cuda"),
                step, **kw)
            losses.append(float(m["loss"]))
            if runner is not None:
                t0 = time.perf_counter()
                if runner.maybe_save(step + 1, state):
                    times.append(time.perf_counter() - t0)
        return state, losses

    straight, la = run(train_mod.init_state(cfg, SEED, device="cuda"), 0, 20)
    with LaunchHolds(per_key=10**9) as holds:
        kernels = [holds.orig[n] for n in ("parity_digest", "xor_cipher")]
        holds.active = True
        for f in kernels:
            f.launches = 0
        runner = fault.Runner(str(directory), save_every=5,
                              root_key=TRAIN_KEY, device="cuda")
        saves = []
        _, first = run(train_mod.init_state(cfg, SEED, device="cuda"), 0,
                       10, runner, saves)
        assert runner._steps() == [5, 10], runner._steps()
        npz = directory / "ckpt_00000010.npz"
        npz.write_bytes(npz.read_bytes()[: npz.stat().st_size // 2])
        t0 = time.perf_counter()
        state, start = runner.resume_or_init(train_mod.abstract_state(cfg),
                                             _no_checkpoint)
        restore_s = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in kernels}
    holds.check(gpu, "train")
    assert start == 5 and [s for s, _ in runner.fallbacks] == [10], \
        (start, runner.fallbacks)
    resumed, lb = run(state, 5, 20)
    want, got = _leaf_dict(straight.params), _leaf_dict(resumed.params)
    worst = 0.0
    for key, w in want.items():
        a, b = got[key].float().cpu().numpy(), w.float().cpu().numpy()
        np.testing.assert_allclose(a, b, **RESTART_TOL, err_msg=key)
        worst = max(worst, float(np.abs(a - b).max()))
    assert abs(la[-1] - lb[-1]) < RESTART_LOSS, (la[-1], lb[-1])
    nbytes = sum(f.stat().st_size for f in directory.glob("ckpt_*.npz"))
    print(f"[train] 9c {cfg.name} ({cfg.n_layers} dec + {cfg.encoder_layers} "
          f"enc layers, batch {batch} x {seq}, ctx {cfg.n_ctx_tokens} "
          f"frames): encrypted saves {saves} s; checkpoint 10 truncated, "
          f"resumed at step {start} (fell back past {runner.fallbacks[0][0]})"
          f" in {restore_s} s; {nbytes} bytes on disk; main-path launches "
          f"{launches}; straight vs resumed: last loss {la[-1]} vs {lb[-1]},"
          f" max |param diff| {worst}; steps 0-9 losses equal: "
          f"{first == la[:10]}  [{gpu}]")
    shutil.rmtree(directory, ignore_errors=True)
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"
    return launches


def transcription(gpu: str) -> dict:
    """9d: ``TranscriptionService`` on whisper-tiny+xnor at full width
    and depth, bf16, temperature 0.8, 3 streams x 2 windows of 1,500
    frames: 1 slot and 4 slots give the same transcripts (a slot's bits
    do not depend on the batch, H2), every launch of pack, the fused
    linear and paged decode held against its plain version; an unheld
    timed run at 4 slots with the same transcripts prints tok/s.  -> the
    three kernels' launch counts (the held 4-slot run)."""
    import torch

    import repro_torch.configs as configs
    from repro_torch.models import lm
    from repro_torch.serve import TranscriptionService, synthetic_audio_trace

    cfg = configs.get("whisper-tiny+xnor")
    params = lm.init_params(cfg, SEED, device="cuda")
    streams = synthetic_audio_trace(3, 2, n_ctx_tokens=cfg.n_ctx_tokens,
                                    d_model=cfg.d_model, seed=SEED)

    def transcribe(slots):
        return TranscriptionService(cfg, params, slots=slots, seed=SEED,
                                    temperature=0.8,
                                    device="cuda").transcribe(streams)
    with LaunchHolds() as holds:
        kernels = [holds.orig[n] for n in ("pack", "xnor_linear_fused",
                                           "paged_decode_attention")]
        holds.active = True
        for f in kernels:
            f.launches = 0
        four = transcribe(4)
        launches = {f.__name__: f.launches for f in kernels}
        one = transcribe(1)
        with holds.off():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed = transcribe(4)
            dt = time.perf_counter() - t0
    holds.check(gpu, "transcribe")
    n_tok = sum(len(t) for t in four.values())
    print(f"[transcribe] {cfg.name}: {n_tok} transcript tokens; 1 slot = 4 "
          f"slots: {one == four}; unheld 4-slot run {n_tok / dt} tok/s "
          f"({dt} s), transcripts as the held run's: {timed == four}; "
          f"main-path launches {launches}; stream 0 {four[0]}  [{gpu}]")
    assert sorted(four) == [0, 1, 2] and all(len(t) == 2 * 4
                                             for t in four.values())
    assert one == four, "1 and 4 slots give different transcripts"
    assert timed == four, "the unheld run's transcripts differ"
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"
    return launches


def classification(gpu: str) -> dict:
    """9e: ``ClassifierService(pack=True)``: ``train_classifier`` for 150
    full-batch SGD steps on the card, then 32 held-out stripe images
    classified: train accuracy >= 0.95 and served accuracy >= 0.9 (the
    reference test's thresholds), the packed service's classes equal to
    the float-sign service's, every fused-linear and pack launch held.
    -> the two kernels' launch counts."""
    import numpy as np
    import torch

    from repro_torch.core import prng
    from repro_torch.models import bcnn
    from repro_torch.serve import ClassifierService

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with LaunchHolds() as holds:
        kernels = [holds.orig[n] for n in ("pack", "xnor_linear_fused")]
        holds.active = True
        for f in kernels:
            f.launches = 0
        svc = ClassifierService(slots=4, pack=True, seed=SEED,
                                train_steps=150, device="cuda")
        train_s = time.perf_counter() - t0
        imgs, y = bcnn.synthetic_images(prng.PRNGKey(SEED + 99,
                                                     device="cuda"), 32)
        pred = svc.classify(imgs)
        launches = {f.__name__: f.launches for f in kernels}
        plain = ClassifierService(params=svc.params, slots=4, pack=False,
                                  seed=SEED, device="cuda").classify(imgs)
    holds.check(gpu, "classify")
    acc = float(np.mean(pred == y.cpu().numpy()))
    print(f"[classify] xnor-cnn trained 150 steps in {train_s} s: train "
          f"accuracy {svc.train_acc}; served accuracy {acc} on 32 held-out "
          f"images; packed = float-sign classes: "
          f"{bool(np.array_equal(pred, plain))}; main-path launches "
          f"{launches}  [{gpu}]")
    assert svc.train_acc >= 0.95, svc.train_acc
    assert acc >= 0.9, acc
    assert np.array_equal(pred, plain), "packed and float-sign classes differ"
    for name, n in launches.items():
        assert n > 0, f"kernel {name} never launched on the main path"
    return launches


def training(gpu: str) -> dict:
    """Phase 9 (9a-9e), each sub-phase timed; -> the launch counts of the
    kernels its paths run."""
    launches = {}
    for sub in (train_main, train_card_vs_cpu, train_runner_drill,
                transcription, classification):
        t = time.perf_counter()
        out = sub(gpu)
        print(f"[time] {sub.__name__}: {time.perf_counter() - t} s")
        if sub in (train_runner_drill, transcription, classification):
            for name, n in out.items():
                launches[name] = max(launches.get(name, 0), n)
    return launches


# -- phase 10: the mesh ----------------------------------------------------

# 10b's depth, the deepest two ranks fit on the card after phases 1-9: on
# an H100 80GB HBM3 at 700 W, 9 layers fit with phase 10 alone (34.56 GiB
# peak a rank) but ran out of memory in AdamW after phases 1-9; 10 never
# fit
MESH_LAYERS = 8
MESH_ONEBIT_LAYERS = 2  # 10c's depth
# tests/test_torch_train.py's bf16 tolerances (10b)
TRAIN_BF16_GRAD_REL = 2 ** -5
TRAIN_BF16_SETTLED = 2 ** -4
TRAIN_BF16_PARAM_TOL = dict(rtol=2 ** -7, atol=1e-6)
# AdamW (optim/adamw.py's b1 and eps).  Its step from zero moments moves
# an element by lr g / (|g| + eps): saturated at lr where |g| >= 2^7 eps,
# else following |g|'s last bits, which two bf16 roundings of the summed
# shares move by a few per cent (the full-width binary layers' gradients
# lie at 1e-8 to 3e-7).  From nonzero moments the move lr m^ / (sqrt(v^)
# + eps) is nowhere saturated and follows the gradient's own difference
ADAMW_B1, ADAMW_EPS = 0.9, 1e-8
ADAMW_SATURATED = 2 ** 7 * ADAMW_EPS


def _engine_cases(ref, rng) -> list:
    """The reference's 20-case sweep and the edges, each with the
    single-device engine's outputs on the card: [(inputs, outputs)]."""
    import numpy as np
    import torch

    shapes = [(int(rng.integers(1, 200_000)),
               int(rng.choice([32, 96, 128, 256])),
               int(rng.integers(0, 2**32)), int(rng.integers(1, 400_000)))
              for _ in range(20)]
    shapes += [(1, 96, 5, 1000), (3 * 1024 + 5, 96, 2**32 - 1000, 1000),
               (0, 96, 0, 1000)]
    cases = []
    for n, width, ctr, chunk in shapes:
        a, b = (torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)
                                 .view(np.int32)).cuda() for _ in range(2))
        key = [int(k) for k in rng.integers(0, 2**32, 2)]
        want = (ref.xor(a, b), ref.xnor(a, b),
                ref.stream_cipher(a, key, ctr), a,
                ref.digest(a, width), ref.digest_chunks(a, chunk, width))
        cases.append(((n, width, ctr, chunk, a, b, key), want))
    return cases


def _engine_case(eng, case, want) -> None:
    """One sweep case through the sharded engine's global form, bitwise
    against the single-device engine's outputs (cut to this rank's
    chunk where the output is a word stream)."""
    import torch

    n, width, ctr, chunk, a, b, key = case
    s0, s1 = eng.local_range(n)
    enc = eng.stream_cipher(a, key, ctr)
    got = (eng.xor(a, b), eng.xnor(a, b), enc,
           eng.stream_cipher_local(enc, key, n, ctr), eng.digest(a, width),
           eng.digest_chunks(a, chunk, width))
    for i, (g, w) in enumerate(zip(got, want)):
        w = w[s0:s1] if i < 4 else w
        assert torch.equal(g, w), (i, n, width, ctr, chunk)


def mesh_engine_rank(rank: int, gpu: str, n_words: int) -> dict:
    """10a on one of 4 gloo ranks: ShardedCimEngine (axis ``bank``) held
    bitwise against the single-device CimEngine on the same card, over
    the reference's 20-case property sweep (global form), the edges, and
    a 4-rank buffer of ``n_words`` words, 1 GB a rank (local form: the
    rank keeps its chunk alone; the single-device engine's outputs over
    the whole buffer are cut to the same chunk).  Every launch of the
    three kernels held bitwise against its plain version
    (:class:`LaunchHolds`).  Then the local form once more unheld, timed
    with CUDA events after a barrier (all ranks share the card at
    once)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.engine import CimEngine, ShardedCimEngine
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_mod

    mesh = mesh_mod.make_engine_mesh(4)
    eng, ref = ShardedCimEngine(mesh), CimEngine()
    assert eng.geometry.devices == 4
    assert ref.cycles_for(1 << 30) == 4 * eng.cycles_for(1 << 30)
    key, ctr, width = [0x9E3779B9, 0x7F4A7C15], 2**32 - 12345, 128

    # the single-device engine over the whole buffer, cut to this chunk
    g = torch.Generator("cuda")
    g.manual_seed(SEED)
    a = torch.randint(-2**31, 2**31, (n_words,), dtype=torch.int32,
                      device="cuda", generator=g)
    b = torch.randint(-2**31, 2**31, (n_words,), dtype=torch.int32,
                      device="cuda", generator=g)
    s0, s1 = eng.local_range(n_words)
    want = {}
    for name, fn in (("xor", lambda: ref.xor(a, b)),
                     ("xnor", lambda: ref.xnor(a, b)),
                     ("cipher", lambda: ref.stream_cipher(a, key, ctr))):
        out = fn()
        want[name] = out[s0:s1].clone()
        del out
    want["digest"] = ref.digest(a, width)
    want["digest_b"] = ref.digest(b, 256)
    ca, cb = a[s0:s1].clone(), b[s0:s1].clone()
    del a, b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    cases = _engine_cases(ref, np.random.default_rng(SEED))
    names = ("bulk_xor", "parity_digest", "xor_cipher")
    with LaunchHolds(per_key=10**9) as holds:
        kernels = [holds.orig[n] for n in names]
        holds.active = True
        for f in kernels:
            f.launches = 0
        sharding.reset_counts()
        for case, want_case in cases:
            _engine_case(eng, case, want_case)
        got = {"xor": eng.xor_local(ca, cb, n_words),
               "xnor": eng.xnor_local(ca, cb, n_words),
               "cipher": eng.stream_cipher_local(ca, key, n_words, ctr),
               "digest": eng.digest_local(ca, n_words, width),
               "digest_b": eng.digest_local(cb, n_words, 256)}
        back = eng.stream_cipher_local(got["cipher"], key, n_words, ctr)
        torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in kernels}
    holds.check(gpu, f"mesh rank {rank}")
    held = {n: sum(v for k, v in holds.held.items() if k[0] == n)
            for n in names}
    assert held == launches and all(launches.values()), (held, launches)
    crossed = sharding.all_gather.bytes
    for name, w in want.items():
        assert torch.equal(got[name], w), f"10a: {name} at {n_words} words"
    assert torch.equal(back, ca), "10a: the cipher's round trip"
    del got, back, want

    # unheld and timed: the local form over this rank's 1 GB chunk
    dist.barrier()
    ms = {}
    for name, fn in (
            ("xor", lambda: eng.xor_local(ca, cb, n_words)),
            ("digest", lambda: eng.digest_local(ca, n_words, width)),
            ("cipher", lambda: eng.stream_cipher_local(ca, key, n_words,
                                                        ctr))):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / 5
        del out
    gb = ca.numel() * 4 / 1e9
    return {"launches": launches, "held": held, "crossed": crossed,
            "gb": gb, "gb_s": {k: gb / (v / 1e3) for k, v in ms.items()},
            "ms": ms, "peak": torch.cuda.max_memory_allocated()}


def mesh_engine(gpu: str) -> dict:
    """10a: 4 ranks, 4 GB -> the three kernels' launches (all ranks)."""
    from repro_torch.launch import mesh as mesh_mod
    n_words = 4 * 2**28
    ranks = mesh_mod.run_ranks(mesh_engine_rank, 4, gpu, n_words,
                               timeout_s=600)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    held = {k: sum(r["held"][k] for r in ranks) for k in ranks[0]["held"]}
    print(f"[mesh] 10a ShardedCimEngine, 4 gloo ranks on one card: the "
          f"reference's 20-case sweep, the edges and a {n_words} -word "
          f"buffer ({n_words * 4 / 1e9} GB, {ranks[0]['gb']} GB a rank) "
          f"bitwise equal to the single-device CimEngine; launches {launches}"
          f", every one held bitwise against its plain version ({held})  "
          f"[{gpu}]")
    for i, r in enumerate(ranks):
        print(f"[mesh] 10a rank {i}: GB/s of its 1 GB chunk per pass "
              f"(unheld, 4 ranks at once) {r['gb_s']}, ms {r['ms']}; bytes "
              f"that crossed ranks {r['crossed']} (digests only); peak "
              f"{r['peak'] / 2**30} GiB  [{gpu}]")
    total = {k: sum(r["gb_s"][k] for r in ranks) for k in ranks[0]["gb_s"]}
    print(f"[mesh] 10a the 4 ranks together: GB/s {total}  [{gpu}]")
    return launches


def _mesh_cfg(layers: int):
    import repro_torch.configs as configs
    return dataclasses.replace(configs.get("qwen2-7b+xnor"), n_layers=layers)


@contextlib.contextmanager
def timed_collectives():
    """Host seconds inside ``sharding``'s two collectives, each bracketed
    by CUDA synchronizes so that it is charged its own time and not that
    of the kernels queued before it -> {name: seconds}."""
    import torch

    from repro_torch.distributed import sharding
    orig = {n: getattr(sharding, n) for n in ("all_gather", "all_reduce")}
    took = dict.fromkeys(orig, 0.0)

    def wrap(name):
        fn = orig[name]

        @functools.wraps(fn, updated=())
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            took[name] += time.perf_counter() - t0
            return out
        timed.__dict__ = fn.__dict__         # one call and byte count
        return timed
    for n in orig:
        setattr(sharding, n, wrap(n))
    try:
        yield took
    finally:
        for n, f in orig.items():
            setattr(sharding, n, f)


def _data_dim(spec):
    """The dim a placement splits over ``data`` (10b's mesh splits no
    other), or None."""
    dims = [d for d, axes in enumerate(spec)
            if "data" in ((axes,) if isinstance(axes, str) else axes or ())]
    assert len(dims) <= 1, spec
    return dims[0] if dims else None


def _block_shape(shape, spec) -> list:
    d, out = _data_dim(spec), list(shape)
    if d is not None:
        out[d] = -(-out[d] // 2)
    return out


def _block(t, spec, r: int):
    """Rank ``r``'s block of a whole leaf on 10b's (data 2, model 1)
    mesh, in GSPMD's layout (ceiling division, the last block padded
    with zeros), written out apart from ``sharding.shard``."""
    import torch
    d = _data_dim(spec)
    if d is None:
        return t
    n, bs = t.shape[d], -(-t.shape[d] // 2)
    start = min(r * bs, n)
    b = t.narrow(d, start, min(start + bs, n) - start)
    if b.shape[d] < bs:
        pad = list(b.shape)
        pad[d] = bs - b.shape[d]
        b = torch.cat([b, b.new_zeros(pad)], d)
    return b.contiguous()


def _ref_block(rank: int, whole, spec, shape, dtype):
    """This rank's block, on the card, of a reference leaf that rank 0
    holds whole on its host: rank 0 cuts its own and broadcasts rank 1's."""
    import torch
    import torch.distributed as dist
    other = _block(whole, spec, 1) if rank == 0 else torch.empty(
        _block_shape(shape, spec), dtype=dtype)
    dist.broadcast(other.view(torch.uint8), 0)
    return (_block(whole, spec, 0) if rank == 0 else other).cuda()


def _single_step(cfg, make, batch, s: int, kw: dict, m_prev=None) -> dict:
    """Rank 0, alone on the card: the single-process train_step ``s`` from
    the whole state ``make()`` returns, then freed -> its metrics, ms and
    peak, the first moment after it on the host (and the parameters, at
    step 0), and per leaf the largest |m - b1 m_prev| ((1 - b1) times the
    clipped gradient; ``m_prev``: the first moment before the step on the
    host, None for zeros)."""
    import torch

    from repro_torch.train import train_step as train_mod
    state = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = train_mod.train_step(cfg, state, batch, s, **kw)
    metrics = [float(m[k]) for k in ("loss", "ce", "gnorm")]
    ms = (time.perf_counter() - t0) * 1e3
    out = {"metrics": metrics, "ms": ms,
           "peak": torch.cuda.max_memory_allocated(),
           "params": [t.to("cpu", copy=True)
                      for t in train_mod._leaves(state.params)] if s == 0
           else None, "m": [], "gmax": []}
    for i, t in enumerate(train_mod._leaves(state.opt.m)):
        out["m"].append(t.to("cpu", copy=True))
        out["gmax"].append(_gmax(t, None if m_prev is None else m_prev[i]))
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _gmax(m, prev, piece: int = 1 << 25) -> float:
    m, top = m.reshape(-1), 0.0
    for s0 in range(0, m.numel(), piece):
        d = m[s0:s0 + piece]
        if prev is not None:
            d = d - ADAMW_B1 * prev.reshape(-1)[s0:s0 + piece].cuda()
        top = max(top, float(d.abs().max()))
    return top


def _single_step_from_blocks(rank: int, cfg, blocks: list, count, specs,
                             like, batch, s: int, kw: dict) -> dict:
    """The single-process step ``s`` from the sharded state (``blocks``:
    this rank's leaves of the parameters, m and v, three lists in leaf
    order; ``count``: AdamW's step).  Rank 1 moves its blocks to the
    host and broadcasts those of the split leaves; rank 0 builds the
    whole state beside its own blocks (new tensors: its blocks stay as
    they are) and runs :func:`_single_step` on it; then rank 1's blocks
    go back to the card.  ``blocks`` is updated in place -> the step's
    outputs on rank 0, {} on rank 1."""
    import torch
    import torch.distributed as dist
    if rank == 1:
        for leaves in blocks:
            for i in range(len(leaves)):
                leaves[i] = leaves[i].to("cpu")
        gc.collect()
        torch.cuda.empty_cache()
    whole, m_prev = [[], [], []], []
    for j, leaves in enumerate(blocks):
        for i, t in enumerate(leaves):
            (_, a), spec = like[i], specs[i]
            d = _data_dim(spec)
            if d is None:
                if rank == 0:
                    whole[j].append(t.clone())
                continue
            other = t if rank == 1 else torch.empty(
                _block_shape(a.shape, spec), dtype=t.dtype)
            dist.broadcast(other.view(torch.uint8), 1)
            if rank == 0:
                whole[j].append(torch.cat([t, other.cuda()], d).narrow(
                    d, 0, a.shape[d]).contiguous())
            del other
        if rank == 0 and j == 1:
            m_prev = [t.to("cpu", copy=True) for t in whole[1]]

    def make():
        state = _state_of(cfg, whole, count.clone())
        whole.clear()
        return state
    out = _single_step(cfg, make, batch, s, kw, m_prev) if rank == 0 else {}
    del m_prev
    dist.barrier()
    if rank == 1:
        for leaves in blocks:
            for i, t in enumerate(leaves):
                leaves[i] = t.cuda()
    return out


def _state_of(cfg, leaves: list, count):
    """A TrainState from three lists of leaves (parameters, m, v, in leaf
    order) and AdamW's step."""
    from repro_torch.core import verify
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as train_mod
    trees = []
    for part in leaves:
        it = iter(part)
        trees.append(verify.tree_map(lambda _: next(it),
                                     lm.abstract_params(cfg)))
    return train_mod.TrainState(trees[0], adamw.AdamWState(count, *trees[1:]))


def _hold_leaf(got, want, m, top: float, lr: float, worst: dict,
               piece: int = 1 << 25) -> tuple[bool, int]:
    """One leaf's parameter block against the reference's after a first
    step from one state -> (whether it holds, its settled elements).
    Held at the CPU tests' bf16 tolerance where the step is settled:
    |m| = (1 - b1) |g| at least ``TRAIN_BF16_SETTLED`` of the leaf's
    largest (``top``) and |g| at least ``ADAMW_SATURATED``.  Elsewhere
    two runs' moves part by up to 2 lr whatever their gradients, so
    nothing is held there; the largest distance in lr is printed.
    Compared in ``piece``-element slices, so the check adds little to
    the step's peak."""
    import torch
    ok, n = True, 0
    got, want, m = (x.reshape(-1) for x in (got, want, m))
    for s0 in range(0, got.numel(), piece):
        g, w = got[s0:s0 + piece].float(), want[s0:s0 + piece].float()
        mo = m[s0:s0 + piece].abs()
        firm = (mo >= TRAIN_BF16_SETTLED * top) \
            & (mo >= (1 - ADAMW_B1) * ADAMW_SATURATED)
        d = (g - w).abs()
        room = TRAIN_BF16_PARAM_TOL["atol"] \
            + TRAIN_BF16_PARAM_TOL["rtol"] * w.abs()
        n += int(firm.sum())
        worst["param"] = max(worst.get("param", 0.0), float(torch.where(
            firm, d / room, torch.zeros_like(d)).max()))
        worst["param / lr"] = max(worst.get("param / lr", 0.0),
                                  float(d.max()) / lr)
        ok &= not bool((firm & (d > room)).any())
    return ok, n


def _grad_err(m, want, gmax: float, piece: int = 1 << 25) -> float:
    """max |m - want| / ``gmax``: from one state m - want is (1 - b1)
    times the clipped gradients' difference, and ``gmax`` the leaf's
    largest (1 - b1) |g|, so this is the gradient's distance over the
    leaf's largest |g|."""
    m, want = m.reshape(-1), want.reshape(-1)
    return max(float((m[s0:s0 + piece] - want[s0:s0 + piece]).abs().max())
               for s0 in range(0, m.numel(), piece)) / max(gmax, 1e-30)


def mesh_train_rank(rank: int, gpu: str) -> dict:
    """10b on one of 2 gloo ranks (mesh data 2 x model 1): two sharded
    train_steps of qwen2-7b+xnor (bf16, full width, ``MESH_LAYERS``
    layers, batch 4 x 256, lr 1e-3 from step 0), each held against the
    single-process step from the same state on the card (rank 0 alone,
    then freed): step 0 from the seed, step 1 from the sharded state
    after step 0, made whole on rank 0 (:func:`_single_step_from_blocks`).

    Each step is the CPU tests' claim, one step from one state, held at
    their bf16 tolerances: loss and ce at ``TRAIN_METRIC_TOL``, gnorm and
    every rank's gradient blocks (through AdamW's first moment,
    :func:`_grad_err`; rank 0 sends rank 1 its blocks of the reference's)
    within ``TRAIN_BF16_GRAD_REL`` of each leaf's largest.  Step 0's
    parameter blocks are held where the step is settled
    (:func:`_hold_leaf`); step 1's are not: from nonzero moments AdamW's
    move follows each element's gradient difference, which the gradient
    tolerance allows, past the bf16 tolerance on small weights.  The host
    seconds inside the collectives are timed apart
    (:func:`timed_collectives`)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import verify
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import lm
    from repro_torch.models import params as pdefs
    from repro_torch.train import train_step as train_mod

    cfg, steps = _mesh_cfg(MESH_LAYERS), 2
    kw = dict(peak_lr=1e-3, warmup=0, total=10)
    pipe = synthetic.Pipeline(cfg, 4, 256, seed=SEED)
    batches = [synthetic.to_device(pipe.get(s), "cuda") for s in range(steps)]
    mesh = mesh_mod.make_mesh((2, 1), ("data", "model"))
    like = [(verify.leaf_key(p), t) for p, t in verify.tree_flatten_with_path(
        lm.abstract_params(cfg))]
    specs = pdefs.leaves(lm.param_pspecs(cfg, sharding.DEFAULT_RULES))
    ref = {}
    if rank == 0:
        ref = _single_step(cfg, lambda: train_mod.init_state(
            cfg, SEED, device="cuda"), batches[0], 0, kw)
    dist.barrier()

    state = train_mod.init_state(cfg, SEED, device="cuda", mesh=mesh)
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in verify.tree_flatten_with_path(state))
    out = {"state_bytes": state_bytes, "ms": [], "ref_ms": [], "peak": [],
           "ref_peak": [], "traffic": [], "collective_s": [], "metrics": [],
           "ref_metrics": [], "settled": {}, "worst": {}, "fails": []}
    worst, fails = out["worst"], out["fails"]
    for s, b in enumerate(batches):
        if s > 0:
            blocks = [train_mod._leaves(t) for t in (
                state.params, state.opt.m, state.opt.v)]
            count, state = state.opt.step, None
            ref = _single_step_from_blocks(rank, cfg, blocks, count, specs,
                                           like, b, s, kw)
            state = _state_of(cfg, blocks, count)
            del blocks
        head = torch.zeros(3 + len(like), dtype=torch.float64)
        if rank == 0:
            head[:3] = torch.tensor(ref["metrics"])
            head[3:] = torch.tensor(ref["gmax"])
            out["ref_ms"].append(ref["ms"])
            out["ref_peak"].append(ref["peak"])
        dist.broadcast(head, 0)
        sharding.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with timed_collectives() as took:
            t0 = time.perf_counter()
            state, m = train_mod.train_step(cfg, state, b, s, **kw,
                                            mesh=mesh)
            mets = [float(m[k]) for k in ("loss", "ce", "gnorm")]
            out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["collective_s"].append(took)
        out["traffic"].append({f.__name__: f.bytes for f in (
            sharding.all_gather, sharding.all_reduce)})
        out["peak"].append(torch.cuda.max_memory_allocated())
        out["metrics"].append(mets)
        out["ref_metrics"].append(head[:3].tolist())
        del m
        mine, moms = (train_mod._leaves(t) for t in (state.params,
                                                      state.opt.m))
        tops = torch.tensor([float(t.abs().max()) for t in moms],
                            dtype=torch.float64)
        dist.all_reduce(tops, op=dist.ReduceOp.MAX)   # the leaves' largest
        torch.cuda.empty_cache()
        for i, (key, t) in enumerate(like):
            if s == 0:
                want = _ref_block(rank, ref["params"][i] if rank == 0
                                  else None, specs[i], t.shape, t.dtype)
                ok, out["settled"][key] = _hold_leaf(
                    mine[i], want, moms[i], float(tops[i]), kw["peak_lr"],
                    worst)
                if not ok:
                    fails.append((s, key))
                del want
            want = _ref_block(rank, ref["m"][i] if rank == 0 else None,
                              specs[i], t.shape, torch.float32)
            err = _grad_err(moms[i], want, float(head[3 + i]))
            worst[f"step {s} grad / leaf max"] = max(
                worst.get(f"step {s} grad / leaf max", 0.0), err)
            if err > TRAIN_BF16_GRAD_REL:
                fails.append((s, "grad " + key, err))
            del want
            if rank == 0:
                ref["m"][i] = None
                if s == 0:
                    ref["params"][i] = None
        del mine, moms, tops
        ref = {}
        for j, name in enumerate(("loss", "ce", "gnorm")):
            a, w = mets[j], float(head[j])
            worst[f"step {s} {name} rel"] = abs(a - w) / abs(w)
            ok = abs(a - w) <= w * TRAIN_BF16_GRAD_REL if name == "gnorm" \
                else abs(a - w) <= TRAIN_METRIC_TOL["atol"] \
                + TRAIN_METRIC_TOL["rtol"] * abs(w)
            if not ok:
                fails.append((s, name, a, w))
    out["n_fails"] = len(fails)
    out["fails"] = fails[:20]
    return out


def mesh_train(gpu: str) -> None:
    """10b: the sharded step, 2 ranks on ``data``."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import lm
    cfg = _mesh_cfg(MESH_LAYERS)
    ranks = mesh_mod.run_ranks(mesh_train_rank, 2, gpu, timeout_s=900)
    r0 = ranks[0]
    settled = {k: sum(r["settled"][k] for r in ranks) for k in r0["settled"]}
    print(f"[mesh] 10b sharded train_step, {cfg.name} bf16 at full width and "
          f"{MESH_LAYERS} of 28 layers ({lm.param_count(cfg)} params), batch "
          f"4 x 256, 2 gloo ranks on data (ZeRO-3 blocks of the parameters "
          f"and both moments), 2 steps, each against the single-process "
          f"step from the same state: metrics {r0['metrics']} against "
          f"{r0['ref_metrics']}; worst {[r['worst'] for r in ranks]}; "
          f"settled elements at step 0 (both ranks) {settled}; failures "
          f"{[r['fails'] for r in ranks]}  [{gpu}]")
    for i, r in enumerate(ranks):
        print(f"[mesh] 10b rank {i}: state bytes {r['state_bytes']} "
              f"({r['state_bytes'] / 2**30} GiB), peak memory "
              f"{[p / 2**30 for p in r['peak']]} GiB, step ms {r['ms']}, "
              f"host s inside the collectives {r['collective_s']}, "
              f"collective bytes in {r['traffic']}  [{gpu}]")
    print(f"[mesh] 10b the single-process step (rank 0, alone on the card): "
          f"{r0['ref_ms']} ms, peak {[p / 2**30 for p in r0['ref_peak']]} "
          f"GiB  [{gpu}]")
    assert all(r["n_fails"] == 0 for r in ranks), \
        [r["fails"] for r in ranks]


def mesh_onebit_rank(rank: int, gpu: str) -> dict:
    """10c on one of 2 gloo ranks (mesh pod 2 x data 1 x model 1): one
    ``grad_compress="onebit_pod"`` step of qwen2-7b+xnor (bf16, full
    width, ``MESH_ONEBIT_LAYERS`` layers) over a batch of 4 x 256, 2 rows
    a pod.
    Rank 0 first composes the step plainly: each pod's unsharded
    gradients (``_grads`` on its half of the batch), the vote written out
    with ``where`` and ``sign``, AdamW on a copy of the parameters; after
    the step its parameters must equal that bit for bit, and rank 1's
    must equal rank 0's (digests compared)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import verify
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as train_mod

    cfg = _mesh_cfg(MESH_ONEBIT_LAYERS)
    kw = dict(peak_lr=1e-3, warmup=0, total=10)
    batch = synthetic.to_device(synthetic.Pipeline(
        cfg, 4, 256, seed=SEED + 1).get(0), "cuda")
    mesh = mesh_mod.make_mesh((2, 1, 1), ("pod", "data", "model"))
    state = train_mod.init_state(cfg, SEED, device="cuda", mesh=mesh)
    want = None
    if rank == 0:
        leaves = train_mod._leaves(state.params)
        votes = [torch.zeros(t.shape, dtype=torch.int8, device="cuda")
                 for t in leaves]
        scales = [[] for _ in leaves]
        for p in (0, 1):
            _, _, g = train_mod._grads(cfg, state.params, {
                k: v[2 * p:2 * p + 2] for k, v in batch.items()})
            for i, t in enumerate(train_mod._leaves(g)):
                votes[i] += torch.where(t >= 0, 1, -1).to(torch.int8)
                scales[i].append(t.float().abs().mean())
            del g
        voted = [(torch.stack(s).mean() * torch.sign(v.float() + 0.5))
                 .to(t.dtype) for s, v, t in zip(scales, votes, leaves)]
        del votes
        copy = verify.tree_map(lambda t: t.clone(), state.params)
        it = iter(voted)
        grads = verify.tree_map(lambda _: next(it), copy)
        sched = train_mod.schedule.warmup_cosine(0, **kw).cuda()
        want, opt, want_gn = adamw.update(copy, grads, adamw.init(copy),
                                          sched)
        del voted, grads, opt
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    sharding.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = train_mod.train_step(cfg, state, batch, 0, **kw, mesh=mesh,
                                    grad_compress="onebit_pod")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    crossed = sharding.all_gather.bytes
    leaves = train_mod._leaves(state.params)
    planes = sum(4 * -(-t.numel() // 32) for t in leaves)
    mine = torch.stack([ops.digest(t) for t in leaves])
    both = sharding.all_gather(mine, mesh.get_group("pod"))
    assert torch.equal(both[0], both[1]), "10c: the pods' parameters differ"
    out = {"ms": ms, "crossed": crossed, "planes": planes,
           "leaves": len(leaves), "loss": float(m["loss"]),
           "gnorm": float(m["gnorm"]),
           "peak": torch.cuda.max_memory_allocated()}
    if rank == 0:
        bad = [k for (k, t), w in zip(
            verify.tree_flatten_with_path(state.params),
            train_mod._leaves(want)) if not torch.equal(t, w)]
        out["differ"] = [verify.leaf_key(k) for k in bad]
        out["want_gnorm"] = float(want_gn)
    return out


def mesh_onebit(gpu: str) -> None:
    """10c: the one-bit vote across 2 pods."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import lm
    cfg = _mesh_cfg(MESH_ONEBIT_LAYERS)
    r0, r1 = mesh_mod.run_ranks(mesh_onebit_rank, 2, gpu, timeout_s=600)
    print(f"[mesh] 10c onebit_pod, {cfg.name} bf16 at full width and "
          f"{MESH_ONEBIT_LAYERS} layers ({lm.param_count(cfg)} params), 2 "
          f"gloo ranks on "
          f"pod, one step: loss {r0['loss']}, gnorm {r0['gnorm']} (plain "
          f"composition {r0['want_gnorm']}); leaves that differ from the "
          f"plain composition {r0['differ']}; bytes that crossed the pod "
          f"axis into each rank {r0['crossed']} (sign planes {r0['planes']} "
          f"+ {r0['leaves']} scales of 4 bytes; the bf16 gradients would be "
          f"{16 * r0['planes']}); step {r0['ms']} ms, {r1['ms']} ms; peak "
          f"{r0['peak'] / 2**30}, {r1['peak'] / 2**30} GiB  [{gpu}]")
    assert r0["crossed"] == r1["crossed"] == r0["planes"] + 4 * r0["leaves"]
    assert not r0["differ"], r0["differ"]
    assert r0["gnorm"] == r0["want_gnorm"] and r0["loss"] == r1["loss"]


def mesh_phase(gpu: str) -> dict:
    """Phase 10 (10a-10c), each sub-phase timed -> the launches of the
    kernels its paths run (10a's, summed over its ranks)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[mesh] the card before the ranks start: {free / 2**30} of "
          f"{total / 2**30} GiB free; this process holds "
          f"{torch.cuda.memory_allocated() / 2**30} GiB  [{gpu}]")
    t = time.perf_counter()
    launches = mesh_engine(gpu)
    print(f"[time] mesh_engine: {time.perf_counter() - t} s")
    for sub in (mesh_train, mesh_onebit):
        t = time.perf_counter()
        sub(gpu)
        print(f"[time] {sub.__name__}: {time.perf_counter() - t} s")
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
    from repro_torch.roofline.analysis import HBM_BW
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
          f"{HBM_BW / 1e9} GB/s of HBM  [{gpu}]")
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
    b_ms, b_by = bound(*kflash.cost(h, s, dh, True))
    flops = kflash.flops(h, s, dh, True)
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
        flops = kflash.flops(h, s, dh, causal)
        b_ms, b_by = bound(*kflash.cost(h, s, dh, causal))
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
    the bf16 qwen2-7b tree (full width, 4 of its 28 layers) through one
    CimEngine on the card."""
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

    # the tree at full width, its depth cut from 28 layers to 4 (4.1 GB;
    # 8 and 5.9 GB until phase 3f joined) to keep the script near 600 s;
    # phase 4 still streams the full 15.2 GB tree
    cfg = dataclasses.replace(configs.get("qwen2-7b+xnor"), n_layers=4)
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
    big_gb = big.numel() * 2 / 1e9
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
          f"(pageable, one {big_gb} GB leaf), i.e. {gb / d2h} s and "
          f"{gb / h2d} s "
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
KIND_LINEARS = {"attn": LINEARS, "local": LINEARS, "moe": LINEARS[:4],
                "rglru": ("w_gate", "w_x", "w_r", "w_i", "w_out", "w1", "w3",
                          "w2"),
                # a prefill chunk projects ctx_kv (wk, wv over the context's
                # rows) before the queries; decode reads ctx_kv as state
                "cross": ("wk", "wv", "wq", "wo", "w1", "w3", "w2"),
                "dec": ("wq", "wk", "wv", "wo", "x_wk", "x_wv", "x_wq",
                        "x_wo", "w1", "w3", "w2")}
DECODE_LINEARS = {"cross": ("wq", "wo", "w1", "w3", "w2"),
                  "dec": ("wq", "wk", "wv", "wo", "x_wq", "x_wo", "w1", "w3",
                          "w2")}
ATTN_KINDS = ("attn", "local", "moe", "dec")     # kinds that run paged decode


def launch_names(cfg, step: str = "prefill_chunk") -> list:
    """(layer, linear) of each fused-linear launch of one step, in order:
    a prefill chunk's or a decode step's (``step == "decode_step"``)."""
    table = KIND_LINEARS
    if step == "decode_step":
        table = KIND_LINEARS | DECODE_LINEARS
    return [(i, lin) for i, kind in enumerate(cfg.layer_kinds())
            for lin in table[kind]]


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
# the same three limits for recurrentgemma-2b+xnor, from its own
# ``--path-readings recurrentgemma-2b+xnor`` (PERF.md §6: over 12
# prompts the kernel path read logits 0 where no sign bit differs, drift
# at most 1.8e-5 and |z| at most 1.42 at 5 differing elements; the
# one-ulp-up controls drift 5.9e-3 and 4.5e-3 and read z 284 and 201)
BF16_LIMITS = {"qwen2-7b+xnor": (BF16_PATH_LOGITS, BF16_TRACK, BF16_ATTN_Z),
               "recurrentgemma-2b+xnor": (1e-3, 5e-4, 4.0),
               "moonshot-v1-16b-a3b+xnor": (7e-3, 2e-3, 4.0),
               "llama-3.2-vision-11b+xnor": (1e-3, 5e-4, 4.0)}
# moonshot-v1-16b-a3b+xnor's, from ``--path-readings
# moonshot-v1-16b-a3b+xnor`` (PERF.md §6: over 12 prompts the kernel path
# read logits 0 on 11 and 3.5e-3 on one, where no sign bit or expert
# choice differs, drift at most 1.1e-3 and |z| at most 1.67; the one-ulp-up
# controls drift 4.0e-3-5.8e-3 and read z 440-623); llama-3.2-vision-11b
# +xnor's, from ``--path-readings llama-3.2-vision-11b+xnor`` (PERF.md §6:
# over 12 prompts, each with its own 1,600-row context, logits 0 on every
# step, no sign bit differing, drift at most 2.8e-5 and |z| at most 1.60;
# the controls drift 4.1e-3-5.8e-3 and read z 510-720)


class Inputs(list):
    """One run's fused-linear inputs in launch order, and ``routes``: each
    routed layer's (layer, expert choices) in order."""

    def __init__(self):
        super().__init__()
        self.routes = []


def first_flip(xs_a, xs_b, names):
    """Walk two runs' fused-linear inputs launch by launch: the largest
    relative L2 gap up to and including the first launch whose sign bits
    differ, and where that first difference is (None if none does);
    ``names`` gives each launch's (layer, linear).  A routed layer whose
    expert choices differ is a difference too, a discrete one like a sign
    bit: the walk ends before the next layer's launches."""
    import torch

    stop = next((la for (la, a), (_, b) in zip(getattr(xs_a, "routes", []),
                                               getattr(xs_b, "routes", []))
                 if not torch.equal(a, b)), None)
    drift = 0.0
    for i, (a, b) in enumerate(zip(xs_a, xs_b)):
        if stop is not None and names[i][0] > stop:
            return drift, dict(launch=i, routed_layer=stop,
                               expert_choices="differ")
        drift = max(drift, ((a - b).norm() / b.norm()).item())
        diff = (a >= 0) != (b >= 0)
        if diff.any():
            r, c = (int(v) for v in diff.nonzero()[0])
            return drift, dict(
                launch=i, layer=names[i][0], linear=names[i][1], row=r, col=c,
                x_a=a[r, c].item(), x_b=b[r, c].item(),
                row_mean_abs=b[r].abs().mean().item(),
                bits=int(diff.sum()))
    if stop is not None:
        return drift, dict(routed_layer=stop, expert_choices="differ")
    return drift, None


def check_paths(cfg, params, toks, nxt: int, gpu: str, seed: int = SEED,
                ctx=None):
    """One prefill chunk and one decode step, kernel path against plain
    path; ``ctx`` (1, T_ctx, d) is the prompt's context for a vlm arch (the
    cross layers' ctx_kv projections are launches of the chunk).

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
    from repro_torch.models import blocks, lm
    from repro_torch.models import moe as moe_mod

    f32 = cfg.dtype == torch.float32
    tol_lin = 2e-5 if f32 else 2 ** -8
    rtol_attn, atol_attn = FLASH_TOL["float32" if f32 else "bfloat16"]
    bf16_logits, bf16_track, bf16_z = BF16_LIMITS[cfg.name]
    track_tol = 1e-4 if f32 else bf16_track
    logit_tol = 1e-3 if f32 else bf16_logits
    ref_linear, fused = ref.xnor_linear_fused, ops.xnor_linear_fused
    name = f"{cfg.name} {str(cfg.dtype)[6:]} seed {seed}"
    step_names = {step: launch_names(cfg, step)
                  for step in ("prefill_chunk", "decode_step")}
    n_attn = sum(k in ATTN_KINDS for k in cfg.layer_kinds())
    moe_layers = [i for i, k in enumerate(cfg.layer_kinds()) if k == "moe"]
    route = moe_mod.route

    bs = cfg.block_size
    (cls, w), = lm.paged_table_widths(cfg, 128, bs, cfg.prefill_chunk).items()
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
        """-> (logits (1, 1, V) f32, state after, fused-linear inputs and
        expert choices)."""
        xs = Inputs()
        names = step_names[step]

        def routed(*args, **kw):
            r = route(*args, **kw)
            xs.routes.append((moe_layers[len(xs.routes)], r.idx.clone()))
            return r

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
                blocks.state_map(torch.clone, st)
                for st in state.seg_states])
        patches = [mock.patch.object(ops, "xnor_linear_fused", lin),
                   mock.patch.object(ref, "xnor_linear_fused", plain),
                   mock.patch.object(moe_mod, "route", routed)]
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
                    {cls: table[:1]}, fresh=True,
                    ctx=None if ctx is None else ctx.cuda())
            else:
                logits, state = lm.paged_decode_step(
                    cfg, params, tok, state, {cls: dtable}, active=active)
        assert len(xs) == len(names), len(xs)
        assert len(xs.routes) == len(moe_layers), len(xs.routes)
        logits = logits[:1].float()
        assert torch.isfinite(logits).all()
        assert logits.shape == (1, 1, cfg.padded_vocab), logits.shape
        return logits, state, xs

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def walk(step, lk, xk, other, xo, what):
        drift, flip = first_flip(xk, xo, step_names[step])
        r = rel(lk, other)
        print(f"[slice] {name} {step}, kernel path vs {what}, run apart: "
              f"logits relative L2 {r}; inputs tracked within {drift} up to "
              f"the first differing sign bit or expert choice {flip}  "
              f"[{gpu}]")
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
            names = step_names[step]
            lr, _, xr = run(step, start, kernel=False, plain=ref_linear)
            drift, flip = first_flip(xk, xr, names)
            print(f"[slice] {name} {step}, kernel path vs plain path with "
                  f"the reference's alpha (reported): logits relative L2 "
                  f"{rel(lk, lr)}; inputs tracked within {drift} up to the "
                  f"first differing sign bit {flip}  [{gpu}]")
            lu, _, xu = run(step, start, kernel=False, plain=ref_linear,
                            scale=1.0 + 2 ** -23)
            drift, flip = first_flip(xu, xr, names)
            print(f"[slice] {name} {step}, plain path vs itself with every "
                  f"fused linear's output scaled by 1 + 2^-23 (reported): "
                  f"logits relative L2 {rel(lu, lr)}; inputs tracked within "
                  f"{drift} up to the first differing sign bit {flip}  "
                  f"[{gpu}]")
        start = after
    assert held == {"xnor_linear_fused": sum(map(len, step_names.values())),
                    "paged_decode_attention": n_attn}, held
    print(f"[slice] {name}: {held} launches of one prefill chunk + one "
          f"decode step each held against the plain version on the same "
          f"inputs (the fused linear also bitwise against the plain version "
          f"summed in the kernel's order); max abs err {worst}  [{gpu}]")
    z = (2 * ups[0] - ups[1]) / max(ups[1], 1) ** 0.5
    print(f"[slice] {name}: paged decode differs from its plain version at "
          f"{ups[1]} of {ups[2]} elements, {ups[0]} of them above it (z "
          f"{z} against no rounding direction)  [{gpu}]")
    if not f32 and abs(z) > bf16_z:
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


def path_readings(gpu: str, arch: str = "qwen2-7b+xnor",
                  n_prompts: int = 12) -> None:
    """The readings behind :func:`check_paths`' bf16 limits: the check on
    the full ``arch`` in bf16 over the smoke's first prompt and
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

    cfg = configs.get(arch)
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
    ctxs = [None] * len(prompts)
    if cfg.n_ctx_tokens:            # the first prompt's is phase 3e's
        ctxs = [torch.from_numpy(ctx_trace(cfg.vocab, cfg.n_ctx_tokens,
                                           cfg.d_model)[0].ctx[None])]
        crng = np.random.default_rng([SEED, 0xC7F])
        ctxs += [torch.from_numpy((crng.standard_normal(
            (1, cfg.n_ctx_tokens, cfg.d_model)) * 0.1).astype(np.float32))
            for _ in prompts[1:]]
    for label, every in (("kernel", 0), ("one ulp up, every element", 1),
                         ("one ulp up, every other element", 2)):
        for i, p in enumerate(prompts):
            toks = torch.from_numpy(p[None, :cfg.prefill_chunk].copy())
            t0 = time.perf_counter()
            try:
                with (attention_rounding_up(every) if every else
                      contextlib.nullcontext()):
                    check_paths(cfg, params, toks,
                                int(p[cfg.prefill_chunk]), gpu,
                                ctx=ctxs[i])
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
    cuda.build()
    for name in cuda.ENTRY_POINTS:
        cuda.fn(name)
    print(f"kernels built and loaded in {time.perf_counter() - t0} s "
          f"(nvcc {cuda.build_seconds()} s)")
    for line in cuda.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    for source in ("flash_attn", "paged_attn", "xnor_linear", "xnor_gemm"):
        for row in ptxas_summary(cuda.build_log(), source):
            print(f"[ptxas] {source}.cu {row}")
    print(f"[sass] flash_attn: {sass_counts(cuda.build()['flash_attn'])}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 products
    torch.backends.cudnn.allow_tf32 = False         # stay f32 on the card
    if sys.argv[1:2] == ["--path-readings"]:
        path_readings(gpu, *sys.argv[2:3])
        return 0
    if sys.argv[1:] == ["--paged-plans"]:
        paged_plans(gpu)
        return 0
    if sys.argv[1:] == ["--slot-bits"]:
        slot_bits(gpu)
        return 0
    if sys.argv[1:] == ["--vlm"]:
        t = time.perf_counter()
        vlm_arch_kernels(gpu)
        print(f"[vlm] phase 3e launches: whisper {whisper_serving(gpu)}, "
              f"llama-3.2-vision {vlm_serving(gpu)} "
              f"({time.perf_counter() - t} s)")
        return 0
    if sys.argv[1:] == ["--xlstm"]:
        xlstm_arch_kernels(gpu)
        t = time.perf_counter()
        print(f"[xlstm] phase 3f launches: xlstm-350m {xlstm_serving(gpu)}, "
              f"xnor-cnn {xnor_cnn_serving(gpu)} "
              f"({time.perf_counter() - t} s)")
        return 0
    if sys.argv[1:] == ["--train"]:
        t = time.perf_counter()
        print(f"[train] phase 9 launches {training(gpu)} "
              f"({time.perf_counter() - t} s)")
        return 0
    if sys.argv[1:] == ["--mesh"]:
        t = time.perf_counter()
        print(f"[mesh] phase 10 launches {mesh_phase(gpu)} "
              f"({time.perf_counter() - t} s)")
        return 0
    if sys.argv[1:] == ["--roofline"]:
        t = time.perf_counter()
        roofline_phase(gpu, phase3_engine())
        print(f"[roofline] phase 11 {time.perf_counter() - t} s")
        return 0
    if sys.argv[1:] == ["--moe"]:
        moe_arch_kernels(gpu)
        t = time.perf_counter()
        print(f"[moe] phase 3d launches {moe_serving(gpu)}; llama4 "
              f"{llama4_serving(gpu)} ({time.perf_counter() - t} s)")
        return 0

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        print(f"[time] {phase.__name__}: {time.perf_counter() - t} s")
        return out

    rec = timed(kernel_checks, gpu)
    timed(paged_long, gpu)
    timed(other_arch_kernels, gpu)
    timed(moe_arch_kernels, gpu)
    timed(vlm_arch_kernels, gpu)
    timed(xlstm_arch_kernels, gpu)
    rec.update(timed(integer_kernel_checks, gpu, LINEAR_SHAPES))
    rec.update(timed(flash_checks, gpu))
    launches, eng = timed(serve_slice, gpu)
    tier = timed(serving_tier, gpu)            # launches of its five kernels
    timed(roofline_phase, gpu, eng)            # phase 11
    del eng
    torch.cuda.empty_cache()
    recurrent = timed(recurrent_serving, gpu)  # and of its three
    moe = timed(moe_serving, gpu)              # and of the same three
    timed(llama4_serving, gpu)
    whisper = timed(whisper_serving, gpu)      # phase 3e
    vlm = timed(vlm_serving, gpu)
    xlstm = timed(xlstm_serving, gpu)          # phase 3f
    cnn = timed(xnor_cnn_serving, gpu)
    launches.update(timed(integer_chain, gpu))
    launches["xnor_gemm"] = timed(binary_layers, gpu,
                                  LINEAR_SHAPES)["xnor_gemm"]
    launches.update(timed(long_context, gpu))
    # each kernel's launches: the path that runs it most
    for path in (tier, recurrent, moe, whisper, vlm, xlstm, cnn):
        for name, n in path.items():
            launches[name] = max(launches[name], n)
    timed(checkpoint_layer, gpu)
    timed(monte_carlo, gpu)
    for name, n in timed(training, gpu).items():     # phase 9
        launches[name] = max(launches[name], n)
    for name, n in timed(mesh_phase, gpu).items():   # phase 10
        launches[name] = max(launches[name], n)
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
