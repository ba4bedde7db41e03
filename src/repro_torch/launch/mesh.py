"""Device meshes over ``torch.distributed``, the ranks that run on them,
and replica placement for the serve router.

Topology of the reference's production meshes:
  single pod  (16, 16)      axes (data, model)       256 ranks
  multi pod   (2, 16, 16)   axes (pod, data, model)  512 ranks
``model`` is the innermost axis; ``pod`` is the slow axis the one-bit
gradient exchange targets.  Every builder lays ranks out row-major over
its axes and needs a process group of exactly its size; the card's
machine has one H100, so its ranks run over gloo (NCCL refuses two ranks
on one GPU), which takes CUDA tensors for the three collectives of
:mod:`repro_torch.distributed.sharding`.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue
import socket
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device


def make_mesh(shape: tuple, axes: tuple, device="cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the current process group
    (world size = the shape's product), on ``device``'s type."""
    n = math.prod(shape)
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_engine_mesh(n_devices: int | None = None, device="cuda"):
    """1-D mesh, axis ``bank``: the sharded CiM engine's outer bank
    dimension (every rank carries one bank stack).  ``n_devices``
    defaults to the world size."""
    n = n_devices or dist.get_world_size()
    return make_mesh((n,), ("bank",), device)


def make_smoke_mesh(n_devices: int | None = None, device="cuda"):
    """Tiny mesh for small distributed runs (8 ranks: 2 x 2 x 2)."""
    n = n_devices or dist.get_world_size()
    if n >= 8:
        shape, axes = (2, 2, n // 4), ("pod", "data", "model")
    elif n >= 4:
        shape, axes = (2, n // 2), ("data", "model")
    else:
        shape, axes = (1, n), ("data", "model")
    return make_mesh(shape, axes, device)


# -- ranks -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, fn, args, results, timeout_s):
    """One rank: join the gloo group, run ``fn(rank, *args)``, report its
    result or its traceback, leave the group."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:                    # the ranks share the host's cores
            torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
    except Exception:            # reported, then the rank exits non-zero
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def run_ranks(fn, world: int, *args, device="cuda",
              timeout_s: int = 600) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined in one
    gloo group (``tcp://127.0.0.1``) -> each rank's return value, in rank
    order.  ``fn`` and its arguments must pickle (a module-level function).
    On ``device="cuda"`` rank r uses card r mod the card count (all on one
    card here); a CPU rank runs torch on one thread.  A rank that
    raises, dies or outlives ``timeout_s`` fails the run: the others are
    killed and a ``RuntimeError`` carries the first traceback."""
    dev = resolve_device(device).type
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, port, dev, fn, args, results, timeout_s), daemon=True)
        for r in range(world)]
    for p in procs:
        p.start()
    out, failure = {}, None
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=timeout_s)
    try:
        while len(out) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    failure = f"rank {procs.index(dead[0])} died with " \
                        f"exit code {dead[0].exitcode}"
                elif datetime.datetime.now() > deadline:
                    failure = f"ranks outlived {timeout_s} s"
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        if failure is not None:
            for p in procs:
                p.kill()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]


def replica_devices(n_replicas: int, device="cuda") -> list[torch.device]:
    """``n_replicas`` devices dealt round-robin over the host's CUDA
    devices (``device="cuda"``, the default; with fewer cards than
    replicas, replicas share a card), or all on the CPU for
    ``device="cpu"``."""
    if n_replicas < 1:
        raise ValueError(f"need at least one replica, got {n_replicas}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n_replicas
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(n_replicas)]
