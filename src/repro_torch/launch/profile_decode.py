"""Where a decode step's time goes: wall time per engine step against the
device time of the kernels it launches.

Builds the serving engine for an arch (full size unless ``--smoke``),
admits ``--slots`` requests (each with a seeded context, 0.1 x standard
normal, where the arch takes one), runs until every slot is decoding,
then times ``--steps`` decode steps without a profiler (wall, host clock
around work that ends in a synchronize) and ``--steps`` more under
``torch.profiler`` (device time by kernel).  Prints the median step wall time, the device
busy time per step, their ratio (the device's busy share; the rest is
idle, waiting for the host), the kernel launches per step, and the
kernels by device time.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
      --arch qwen2-7b+xnor
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b+xnor")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    eng = ServeEngine(cfg, lm.init_params(cfg, args.seed, device=args.device),
                      slots=args.slots, s_max=args.prompt_len + 3 * args.steps
                      + 8, device=args.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.slots):
        prompt = rng.integers(0, cfg.vocab, size=args.prompt_len)
        ctx = None
        if cfg.n_ctx_tokens:
            ctx = (rng.standard_normal((cfg.n_ctx_tokens, cfg.d_model))
                   .astype(np.float32) * 0.1)
        eng.submit(Request(rid, prompt, max_new_tokens=3 * args.steps + 8,
                           ctx=ctx))
    while eng._prefilling or not eng.pool.active:
        eng.step()
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    walls = []
    for _ in range(args.steps):
        sync()
        t0 = time.perf_counter()
        eng.step()
        sync()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)

    acts = [torch.profiler.ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            eng.step()
        sync()
    # device-side events only: CPU ops also carry the device time of the
    # kernels they launched, and counting both would count it twice
    dev = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    dev.sort(key=lambda t: -t[1])
    busy_ms = sum(t[1] for t in dev) / 1e3 / args.steps
    where = (torch.cuda.get_device_name(0) if eng.device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} slots={args.slots} device={where}")
    print(f"  decode step wall: median {wall * 1e3} ms over {args.steps} "
          f"steps (min {min(walls) * 1e3}, max {max(walls) * 1e3})")
    if dev:
        print(f"  device busy per step (profiled): {busy_ms} ms -> busy "
              f"share {busy_ms / (wall * 1e3)}")
        print(f"  device launches per step (profiled): "
              f"{sum(t[2] for t in dev) / args.steps}")
        for key, us, n in dev[:12]:
            print(f"    {us / 1e3 / args.steps:10.4f} ms/step "
                  f"{n // args.steps:6d} launches/step  {key[:90]}")
    else:
        print("  device busy per step: not measured (no device time in "
              "the profile)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
