"""PyTorch / CUDA port of the XNOR serving path and the integer chain
(bit packing, the banked CiM engine, copy verification, encryption,
incremental digests); ``repro`` is the JAX reference it is held against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the hand-written Hopper kernels (``kernels/csrc``) launch on CUDA tensors
and their plain PyTorch versions run on CPU tensors.
"""

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Asking for CUDA on a machine without it raises — an entry point never
    carries on quietly on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
