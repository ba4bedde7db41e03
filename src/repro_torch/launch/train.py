"""Training entry point of the port: the training loop at whatever scale
the device holds (``--smoke`` for the reduced same-family config).

Runs on CUDA unless ``--device cpu``.  Parameters are drawn from
``--seed``; batches come from the step-addressed synthetic pipeline.
With ``--ckpt-dir`` the loop is fault tolerant through
``distributed.fault.Runner``: it resumes from the latest checkpoint that
restores, saves every ``--save-every`` steps with XOR-parity digests
(ciphered under ``--encrypt-key``) and watermarks straggling steps.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b+xnor \\
      --smoke --device cpu --steps 60 --batch 8 --seq 64 --ckpt-dir /tmp/run1
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.data import synthetic
from repro_torch.distributed import fault
from repro_torch.models import lm
from repro_torch.train import train_step as train_mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--quant", default=None, choices=[None, "xnor"],
                    help="binary (XNOR-Net) projections: the paper's mode")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--encrypt-key", default=None)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.quant:
        cfg = dataclasses.replace(cfg, quant=args.quant)
    print(f"arch={cfg.name} device={dev} params="
          f"{lm.param_count(cfg) / 1e6:.2f}M "
          f"active={lm.active_param_count(cfg) / 1e6:.2f}M quant={cfg.quant}")

    pipe = synthetic.Pipeline(cfg, args.batch, args.seq, seed=args.seed)

    def fresh():
        return train_mod.init_state(cfg, args.seed, device=dev)

    runner, start = None, 0
    if args.ckpt_dir:
        runner = fault.Runner(args.ckpt_dir, save_every=args.save_every,
                              root_key=args.encrypt_key, device=str(dev))
        state, start = runner.resume_or_init(train_mod.abstract_state(cfg),
                                             fresh)
        if start:
            print(f"resumed from checkpoint @ step {start}")
    else:
        state = fresh()

    losses = []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = synthetic.to_device(pipe.get(step), dev)
        state, metrics = train_mod.train_step(
            cfg, state, batch, step, peak_lr=args.lr, warmup=args.warmup,
            total=args.steps, microbatch=args.microbatch)
        loss = float(metrics["loss"])          # waits for the step
        losses.append(loss)
        dt = time.perf_counter() - t0
        if runner:
            verdict = runner.observe_step(step, dt)
            if verdict != "ok":
                print(f"[fault] step {step}: {verdict}")
            runner.maybe_save(step + 1, state)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['gnorm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms")

    if not losses:
        print(f"nothing to run: resumed at step {start} of {args.steps}")
        return 0
    first = np.mean(losses[:5]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-5:])
    print(f"loss: first~{first:.4f} last~{last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
