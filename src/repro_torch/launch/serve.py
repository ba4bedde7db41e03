"""Serving entry point of the port: the continuous-batching engine over a
seeded synthetic mixed-length trace.

Runs on CUDA unless ``--device cpu``; ``--smoke`` takes the reduced
same-family config.  Parameters are random, drawn from ``--seed``.
``--dense`` keeps the slot-dense KV layout instead of the block-paged
one; ``--static`` runs the static-batch ``generate_static`` loop instead
of the engine; ``--replicas N`` (N > 1) serves through the replicated
Router, with the kill drill at router step ``--kill-at``, migration
checkpoints under ``--ckpt-dir`` and the integrity scrubber every
``--epoch-steps`` router steps.

``--workload`` picks what to serve: ``lm`` (default) the chat trace
above; ``transcribe`` streams ``--streams`` x ``--windows`` synthetic
audio windows through :class:`TranscriptionService` on an enc-dec arch;
``classify`` trains the XNOR-CNN classifier in-process and classifies
``--requests`` stripe images through :class:`ClassifierService`.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b+xnor \\
      --slots 4 --requests 16 --new-tokens 16 --prefix-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b+xnor \\
      --replicas 2 --kill-at 6 --temperature 0.8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b+xnor \\
      --smoke --device cpu --dense
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny+xnor \\
      --smoke --device cpu --workload transcribe --streams 3 --windows 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xnor-cnn \\
      --device cpu --workload classify --requests 32
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.core import prng
from repro_torch.models import bcnn, lm
from repro_torch.serve import (ClassifierService, Router, ServeEngine,
                               TranscriptionService, synthetic_audio_trace,
                               synthetic_trace)
from repro_torch.train import serve_step


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _run_transcribe(cfg, params, args) -> int:
    """Streaming transcription over synthetic audio windows."""
    svc = TranscriptionService(
        cfg, params, slots=args.slots, s_max=args.s_max or 32,
        tokens_per_window=max(2, args.new_tokens),
        temperature=args.temperature, seed=args.seed,
        pack=not args.no_pack, device=args.device)
    streams = synthetic_audio_trace(
        args.streams, args.windows, n_ctx_tokens=cfg.n_ctx_tokens,
        d_model=cfg.d_model, seed=args.seed)
    _sync(args.device)
    t0 = time.perf_counter()
    transcripts = svc.transcribe(streams)
    dt = time.perf_counter() - t0
    total = sum(len(t) for t in transcripts.values())
    print(f"arch={cfg.name} device={args.device} workload=transcribe "
          f"streams={args.streams} windows={args.windows} "
          f"slots={args.slots}")
    print(f"  {total} transcript tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s; "
          f"{svc.stats.prefills} window sessions, "
          f"{svc.stats.decode_steps} decode steps)")
    for sid in sorted(transcripts):
        print(f"  stream {sid}: {transcripts[sid][:12]}"
              f"{'...' if len(transcripts[sid]) > 12 else ''}")
    return 0


def _run_classify(cfg, args) -> int:
    """Batched XNOR-CNN classification (the paper's Fig. 6 workload),
    trained in-process."""
    svc = ClassifierService(cfg=cfg, slots=args.slots,
                            pack=not args.no_pack, seed=args.seed,
                            device=args.device)
    n = max(args.requests, 1)
    imgs, y = bcnn.synthetic_images(
        prng.PRNGKey(args.seed + 1, device=args.device), n)
    _sync(args.device)
    t0 = time.perf_counter()
    pred = svc.classify(imgs)
    dt = time.perf_counter() - t0
    acc = float(np.mean(pred == y.cpu().numpy()))
    print(f"arch={cfg.name} device={args.device} workload=classify "
          f"images={n} slots={args.slots} packed={not args.no_pack}")
    print(f"  train acc {svc.train_acc:.2f}; serve acc {acc:.2f}; "
          f"{n / max(dt, 1e-9):.1f} images/s "
          f"({svc.stats.prefills} one-shot sessions, "
          f"{svc.stats.decode_steps} decode steps)")
    return 0


def _run_static(cfg, params, args, pl: int, nt: int) -> int:
    """The static-batch loop: one batch of ``--slots`` uniform prompts of
    ``--prompt-len`` tokens, ``--new-tokens`` tokens each; a ctx arch's
    contexts (0.1 x standard normal) come from a stream of their own, so
    the prompts and the sampling key do not depend on them."""
    rng = np.random.default_rng(args.seed + 1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (args.slots, pl))
                              .astype(np.int32)).to(args.device)
    key = (prng.PRNGKey(args.seed + 2, device=args.device)
           if args.temperature > 0 else None)
    ctx = None
    if cfg.n_ctx_tokens:
        gen = torch.Generator(device=args.device)
        gen.manual_seed(args.seed + 3)
        ctx = torch.randn((args.slots, cfg.n_ctx_tokens, cfg.d_model),
                          generator=gen, device=args.device) * 0.1
    _sync(args.device)
    t0 = time.perf_counter()
    out = serve_step.generate_static(cfg, params, prompt, nt, ctx=ctx,
                                     temperature=args.temperature, key=key,
                                     device=args.device)
    out = out.cpu()
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={args.device} static generate "
          f"{tuple(out.shape)} in {dt:.2f}s ({args.slots * nt / dt:.1f} "
          f"tok/s)")
    return 0


def _run_replicated(cfg, params, trace, s_max: int, args) -> int:
    """N engine replicas behind the least-loaded Router, the kill drill
    mid-run, encrypted migration checkpoints, integrity scrubbing."""
    if args.dense:
        raise SystemExit("--replicas > 1 needs the paged layout "
                         "(drop --dense): migration extracts state "
                         "through per-slot block tables")
    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="serve_mig_"))
        router = Router(cfg, params, args.replicas, slots=args.slots,
                        s_max=s_max, ckpt_dir=ckpt_dir,
                        epoch_steps=args.epoch_steps, eos_id=args.eos_id,
                        temperature=args.temperature, seed=args.seed,
                        pack=not args.no_pack, block_size=args.block_size,
                        prefill_chunk=args.prefill_chunk,
                        n_blocks=args.n_blocks,
                        prefix_cache=not args.no_prefix_cache,
                        device=args.device)
        for r in trace:
            router.submit(r)
        rep = router.run(kill_at=args.kill_at or None)
    sr = rep.serve_report()
    lat = sr.latency_quantiles((0.5, 0.95))
    ttft = sr.ttft_quantiles((0.5, 0.95))
    print(f"arch={cfg.name} device={args.device} replicas={args.replicas} "
          f"slots={args.slots}/replica requests={len(trace)} "
          f"kill_at={args.kill_at or '-'}")
    print(f"  generated {rep.generated} tokens in {rep.wall:.2f}s "
          f"-> {rep.tok_per_s:.1f} tok/s across replicas")
    print(f"  latency p50={lat[0.5]*1e3:.0f}ms p95={lat[0.95]*1e3:.0f}ms; "
          f"ttft p50={ttft[0.5]*1e3:.0f}ms p95={ttft[0.95]*1e3:.0f}ms")
    print(f"  migrations: {len(rep.migrations)} "
          f"(killed {rep.killed or 'none'}); "
          f"stragglers observed: {len(rep.straggler_events)}")
    print(f"  scrubber: {rep.scrub_passes} passes, "
          f"{sr.stats.scrub_weight_leaves} weight leaves + "
          f"{sr.stats.scrub_idle_blocks} idle blocks verified, "
          f"{rep.scrub_corruptions} corruptions")
    done = sum(1 for s in rep.sessions.values() if s.done)
    print(f"  completed {done}/{len(trace)}")
    return 0 if done == len(trace) and rep.scrub_corruptions == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--workload", choices=("lm", "transcribe", "classify"),
                    default="lm",
                    help="what to serve: chat trace, streaming "
                         "transcription, or image classification")
    ap.add_argument("--streams", type=int, default=3,
                    help="audio streams (--workload transcribe)")
    ap.add_argument("--windows", type=int, default=2,
                    help="windows per stream (--workload transcribe)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length in the trace")
    ap.add_argument("--new-tokens", type=int, default=16,
                    help="max per-request token budget in the trace")
    ap.add_argument("--s-max", type=int, default=0,
                    help="resident cache capacity (0: prompt+new)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0: greedy; > 0: Gumbel sampling")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--no-pack", action="store_true",
                    help="serve quant archs from float weights (A/B)")
    ap.add_argument("--static", action="store_true",
                    help="the static-batch generate_static loop instead")
    ap.add_argument("--dense", action="store_true",
                    help="slot-dense KV layout instead of block-paged (A/B)")
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged-KV tokens per block (0: cfg.block_size)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill piece size (0: cfg.prefill_chunk)")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="shared block-pool size (0: slots x full tables)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable content-addressed prefix caching (A/B)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared leading tokens in the trace (0: none)")
    ap.add_argument("--prefix-frac", type=float, default=0.9,
                    help="fraction of requests opening with the shared "
                         "prefix (with --prefix-len)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve replicas (>1: the Router with least-loaded "
                         "routing and live migration)")
    ap.add_argument("--kill-at", type=int, default=0,
                    help="router step of the kill-a-replica drill "
                         "(0: no drill; needs --replicas > 1)")
    ap.add_argument("--epoch-steps", type=int, default=8,
                    help="integrity-scrubber cadence in router steps "
                         "(0: off; --replicas > 1)")
    ap.add_argument("--ckpt-dir", default="",
                    help="migration checkpoint directory (default: a temp "
                         "dir; --replicas > 1)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.workload == "classify":
        return _run_classify(cfg, args)
    params = lm.init_params(cfg, args.seed, device=args.device)
    if args.workload == "transcribe":
        return _run_transcribe(cfg, params, args)
    pl = max(4, args.prompt_len)
    nt = max(2, args.new_tokens)
    trace = synthetic_trace(
        args.requests, cfg.vocab, seed=args.seed,
        prompt_lens=tuple(sorted({max(2, pl // 4), max(3, pl // 2), pl})),
        new_tokens=tuple(sorted({max(2, nt // 2), nt})),
        n_ctx_tokens=cfg.n_ctx_tokens, d_model=cfg.d_model,
        prefix_frac=args.prefix_frac, prefix_len=args.prefix_len)
    s_max = args.s_max or (args.prefix_len + pl + nt)
    if args.static:
        return _run_static(cfg, params, args, pl, nt)
    if args.replicas > 1:
        return _run_replicated(cfg, params, trace, s_max, args)

    eng = ServeEngine(cfg, params, slots=args.slots, s_max=s_max,
                      eos_id=args.eos_id, temperature=args.temperature,
                      seed=args.seed, pack=not args.no_pack,
                      paged=not args.dense, block_size=args.block_size,
                      prefill_chunk=args.prefill_chunk,
                      n_blocks=args.n_blocks,
                      prefix_cache=not args.no_prefix_cache,
                      device=args.device)
    del params                      # the engine holds the packed form
    for r in trace:
        eng.submit(r)
    report = eng.run()
    lat = report.latency_quantiles((0.5, 0.95))
    ttft = report.ttft_quantiles((0.5, 0.95))
    qwait = report.queue_wait_quantiles((0.5, 0.95))
    packed = (not args.no_pack) and cfg.quant == "xnor"
    print(f"arch={cfg.name} device={eng.device} slots={args.slots} "
          f"requests={len(trace)} packed={packed} "
          f"layout={'dense' if args.dense else 'paged'}")
    print(f"  generated {report.generated} tokens in {report.wall:.2f}s "
          f"-> {report.tok_per_s:.1f} tok/s "
          f"({report.prefills} prefills, {report.decode_steps} decode steps)")
    print(f"  latency p50={lat[0.5]*1e3:.0f}ms p95={lat[0.95]*1e3:.0f}ms")
    print(f"  ttft    p50={ttft[0.5]*1e3:.0f}ms p95={ttft[0.95]*1e3:.0f}ms "
          f"(queue-wait p50={qwait[0.5]*1e3:.0f}ms "
          f"p95={qwait[0.95]*1e3:.0f}ms)")
    st = report.stats
    if st.blocks_total:
        print(f"  blocks: peak {st.blocks_peak}/{st.blocks_total} "
              f"mean {st.blocks_mean:.1f} "
              f"(util {st.block_utilization:.0%}); "
              f"{st.prefill_chunks} prefill chunks")
        print(f"  prefix cache: "
              f"{'on' if eng.prefix_caching else 'off'}; "
              f"hit rate {st.prefix_hit_rate:.0%} "
              f"({st.prefix_hits}/{st.prefills} prompts, "
              f"{st.prefix_tokens}/{st.prompt_tokens} tokens), "
              f"{st.blocks_per_request:.2f} fresh blocks/request, "
              f"{st.cow_copies} cow, {st.prefix_evictions} evictions")
    done = sum(1 for s in report.sessions.values() if s.done)
    first = trace[0]
    print(f"  completed {done}/{len(trace)}; first request tokens: "
          f"{np.asarray(report.tokens(first.rid))[:8].tolist()}...")
    return 0 if done == len(trace) else 1


if __name__ == "__main__":
    raise SystemExit(main())
