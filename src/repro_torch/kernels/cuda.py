"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  The build runs at first use,
one ``nvcc`` per source, all started together, into ``kernels/build/``
(git-ignored).  A library's file name carries a digest of its sources and
flags, so an edited source is always rebuilt.

Dispatch follows the tensor's device: :func:`use_kernel` is False for CPU
tensors (the wrappers then run the plain PyTorch version) and True for
CUDA tensors, which get the kernel or an exception — never a fallback.
The one exception is :func:`plain_reference`, a scoped mode in which the
wrappers run their plain versions on CUDA tensors too; it exists so a
check can hold the kernel path against the plain path on the card.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
SOURCES = ("pack", "xnor_linear", "paged_attn", "xnor_gemm", "bulk", "parity",
           "cipher", "flash_attn")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _U = ctypes.c_longlong, ctypes.c_uint
# C entry points: name -> (library, argtypes); every one returns cudaError_t
ENTRY_POINTS = {
    "xnor_pack": ("pack", [_P, _I, _P, _P, _I, _I, _I, _P]),
    "xnor_linear_fused": ("xnor_linear", [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _I, _P]),
    "paged_decode": ("paged_attn", [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                                    _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                    _F, _F, _P]),
    "xnor_gemm": ("xnor_gemm", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "bulk_xor": ("bulk", [_P, _P, _P, _L, _I, _P]),
    "parity_digest": ("parity", [_P, _L, _L, _I, _P, _P]),
    "xor_cipher": ("cipher", [_P, _P, _L, _U, _U, _U, _P]),
    "flash_attention": ("flash_attn", [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                       _P]),
}

_plain = contextvars.ContextVar("plain_reference", default=False)


class _Build:
    """Process-wide record of the loaded libraries and their build."""

    libs: dict[str, ctypes.CDLL] = {}
    fns: dict[str, ctypes._CFuncPtr] = {}
    seconds: float = 0.0
    log: str = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns the library paths; raises with the compiler's output if a
    build fails.  The ptxas report (registers, shared memory, spills) of
    the builds that ran is kept in ``build_log()``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = [], []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs.append(f"== {name}.cu ==\n{text}")
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    _Build.seconds += time.perf_counter() - t0
    _Build.log += "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{_Build.log}")
    return targets


def build_seconds() -> float:
    return _Build.seconds


def build_log() -> str:
    return _Build.log


def fn(name: str):
    """The C entry point ``name``, building and loading its library on
    first use."""
    f = _Build.fns.get(name)
    if f is None:
        lib_name, argtypes = ENTRY_POINTS[name]
        lib = _Build.libs.get(lib_name)
        if lib is None:
            lib = ctypes.CDLL(str(build()[lib_name]))
            _Build.libs[lib_name] = lib
        f = getattr(lib, name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _Build.fns[name] = f
    return f


def launch(name: str, *args) -> None:
    """Call a C entry point and raise if the launch failed."""
    err = fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the wrapper must launch its kernel on these tensors.

    All tensors must share one device.  CPU tensors take the plain path;
    CUDA tensors take the kernel (outside :func:`plain_reference`); any
    other device raises."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return not _plain.get()


@contextlib.contextmanager
def plain_reference():
    """Run the wrappers' plain PyTorch versions even on CUDA tensors, for
    holding the kernel path against the plain path on the card.  Launch
    counts do not move inside it."""
    token = _plain.set(True)
    try:
        yield
    finally:
        _plain.reset(token)


def check(cond: bool, msg: str) -> None:
    """Argument check that survives ``python -O``."""
    if not cond:
        raise ValueError(msg)
