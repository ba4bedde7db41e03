"""Replica placement for the serve router: one device per replica, the
port's stand-in for ``repro/launch/mesh.py::make_replica_meshes``."""

from __future__ import annotations

import torch

from repro_torch import resolve_device


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
