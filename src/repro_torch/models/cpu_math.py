"""The CPU path's float products and f32 transcendentals, in the jitted
reference's order rather than the host libraries' (fault F7).

PyTorch's CPU matmul hands an f32 product to MKL and a bf16 one to
oneDNN, and its f32 ``exp``, ``log``, ``tanh`` and ``sqrt`` (above a few
elements) to MKL's vector math.  Each picks its kernel by the host's
instruction set: MKL runs its AVX-512 code on Intel hosts and its AVX2
code on AMD hosts, oneDNN takes AMX where the host has it and AVX-512
BF16 where it does not.  The kernels sum K in other orders and round the
transcendentals differently, so the same code gave other bits on other
hosts, and tests that hold greedy tokens and f32 gradients against the
reference passed on one host and failed on another.

XLA's CPU backend rounds a bf16 dot's operands to f32, runs an f32 dot
in YNNPACK and rounds the result once.  YNNPACK picks its f32 dot kernel
by the host's instruction set: jaxlib's kernel table names each for its
ISA (``dot_fp32_<tile>_avx512f``, ``_avx2``, ``_fma3``, ``_sse2``) and
for no vendor.  On an AVX-512F host (Intel, or AMD from Zen 4) each
output is one fused multiply-add chain over k, or, for narrow outputs,
4 lanes of chains added by pairs (the ``*x4x4_1x4x4`` kernels; AVX2's
narrow kernels take 2 lanes, ``*x4x2_1x4x2``), and K is cut into blocks
by a panel budget compiled into the library (128 KiB), the blocks' sums
added in order.  The port sums in the AVX-512F kernels' order on the
CPU: ``cpu_dot.c``, built with the host's C compiler at first use (a
missing compiler or a failed build raises with the compiler's output).
On a host without AVX-512F the reference's narrow products take 2 lanes
and the port's bits may part from them (ROADMAP, F7).  The f32
transcendentals go through f64 and round once: correctly rounded on
every host (``sqrt`` then equals XLA's; ``exp``, ``log`` and ``tanh``
are XLA's own approximations, which differ from any correctly rounded
result in the last bit on some inputs, as PyTorch's did).  On the card
PyTorch's products and functions, as the single-process step has them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import cuda

F32 = torch.float32

# YNNPACK's budget for the right operand's (K, N) panel, in f32
# elements (128 KiB): a wider panel of a product of fewer than 64 rows is
# cut into K blocks of the power of two at or above half of K
PANEL = 32768
SPLIT_ROWS = 64
BLOCK_MAX = 512       # no K block is longer
NARROW = 16           # outputs at most this wide sum in 4 lanes


def lanes_dot(a: torch.Tensor, b: torch.Tensor, lanes: int = 1,
              fma: bool = True) -> torch.Tensor:
    """sum(a * b) over the last axis (a and b broadcast), f32: ``lanes``
    partial sums over k = j mod lanes, each accumulated in k order with
    one rounding a step (a fused multiply-add; ``fma=False``: the product
    rounded first), then added by adjacent pairs."""
    a64, b64 = a.double(), b.double()
    k = a.shape[-1]
    parts = []
    for j in range(min(lanes, k)):
        acc = None
        for i in range(j, k, lanes):
            p = a64[..., i] * b64[..., i]
            if not fma:
                p = p.float().double()
            acc = p.float() if acc is None else (acc.double() + p).float()
        parts.append(acc)
    while len(parts) > 1:
        pairs = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        parts = pairs + parts[len(pairs) * 2:]
    return parts[0]


def block(m: int, n: int, k: int) -> int:
    """The K block of an (m, k) x (k, n) f32 dot (a vector-matrix product
    is not cut)."""
    if m == 1:
        return k
    if m < SPLIT_ROWS and n * k > PANEL:
        return min(BLOCK_MAX, 1 << (-(-k // 2) - 1).bit_length())
    return min(BLOCK_MAX, k)


_SRC = Path(__file__).with_name("cpu_dot.c")
_BUILD = Path(__file__).parents[1] / "kernels" / "build"
_FLAGS = ["-O3", "-fPIC", "-shared", "-ffp-contract=off", "-fno-fast-math"]
_LIB: list = []


@functools.cache
def host_fma() -> bool:
    """Whether the host's CPU flags list ``fma``: XLA's CPU emitters fuse
    a multiply and an add only where they do."""
    try:
        return " fma " in Path("/proc/cpuinfo").read_text().replace("\n", " ")
    except OSError:
        return False


def _flags() -> list[str]:
    """The compiler's flags: fused multiply-adds inline (``-mfma``) where
    the host has them, a libm call otherwise."""
    return _FLAGS + (["-mfma"] if host_fma() else [])


def _native():
    """``cpu_dot.c``'s entry point, compiled once into the git-ignored
    build directory (a file a source and flags); raises with the
    compiler's output where there is no C compiler or the build fails."""
    if _LIB:
        return _LIB[0]
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("cpu_dot.c: no C compiler (cc or gcc) on PATH; "
                           "the CPU path's float products need one")
    flags = _flags()
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(flags)
                            .encode()).hexdigest()[:16]
    lib = _BUILD / f"libcpu_dot-{digest}.so"
    if not lib.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        done = subprocess.run([cc, *flags, "-o", str(tmp), str(_SRC), "-lm"],
                              capture_output=True, text=True)
        if done.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cc} failed for cpu_dot.c:\n{done.stderr}")
        os.replace(tmp, lib)
    fn = ctypes.CDLL(str(lib)).cpu_dot
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6
    _LIB.append(fn)
    return fn


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, M, K) x (G, K, N) -> (G, M, N) f32 in YNNPACK's order, each of
    the G products as one dot.  A ``meta`` tensor (a dry run of the CPU
    path) takes the same allocations as a CPU one."""
    g, m, k = a.shape
    n = b.shape[2]
    if k == 0:
        return torch.zeros((g, m, n), dtype=F32, device=a.device)
    out = torch.empty((g, m, n), dtype=F32, device=a.device)
    if a.device.type == "meta":
        return out
    lanes = 4 if m > 1 and n <= NARROW and m * n > 4 else 1
    a, b = a.contiguous(), b.contiguous()
    if _native()(a.data_ptr(), b.data_ptr(), out.data_ptr(), g, m, k, n,
                 lanes, block(m, n, k)):
        raise MemoryError("cpu_dot: no memory for its partial sums")
    return out


class _Matmul(torch.autograd.Function):
    """The products and their two backward products, each in the order
    above (XLA's backward is two dots as well)."""

    @staticmethod
    def forward(a, b):
        return _mm(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _mm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        gb = _mm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N) f32, summed as the reference's
    CPU dot sums it: the operands in f32, the leading axes one row axis."""
    lead = x.shape[:-1]
    y = _Matmul.apply(x.reshape(1, math.prod(lead), x.shape[-1]).float(),
                      w.float()[None])
    return y.reshape(*lead, w.shape[-1])


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (G, M, K) @ b (G, K, N) -> (G, M, N) f32, each of the G products
    summed as the reference's CPU dot sums it (the operands in f32)."""
    return _Matmul.apply(a.float(), b.float())


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of one contracted index -> f32, as the
    reference's dot_general sums it: the axes both operands and the
    output hold are the batch, ``a``'s other output axes the rows, ``b``'s
    the columns (the two swapped where ``a`` holds its row axes in
    another order than the output, which decides the lanes)."""
    ins, out = eq.split("->")
    ia, ib = ins.split(",")
    (c,) = [x for x in ia if x in ib and x not in out]
    bat = [x for x in out if x in ia and x in ib]
    rows = [x for x in out if x in ia and x not in ib]
    cols = [x for x in out if x in ib and x not in ia]
    size = dict(zip(ia, a.shape)) | dict(zip(ib, b.shape))

    def n(axes):
        return math.prod(size[x] for x in axes)
    a3 = a.permute(*[ia.index(x) for x in bat + rows + [c]]).reshape(
        n(bat), n(rows), size[c])
    b3 = b.permute(*[ib.index(x) for x in bat + [c] + cols]).reshape(
        n(bat), size[c], n(cols))
    if [x for x in ia if x in rows] == rows:
        y = _Matmul.apply(a3.float(), b3.float())
    else:
        # a's row axes need a transpose: XLA takes b's as the rows
        y = _Matmul.apply(b3.float().transpose(1, 2),
                          a3.float().transpose(1, 2)).transpose(1, 2)
    y = y.reshape(*[size[x] for x in bat + rows + cols])
    return y.permute(*[(bat + rows + cols).index(x) for x in out])


def _through_f64(fn, x: torch.Tensor) -> torch.Tensor:
    if x.dtype != F32 or cuda.on_card(x):
        return fn(x)
    return fn(x.double()).float()


def exp(x: torch.Tensor) -> torch.Tensor:
    """``torch.exp``; an f32 tensor on the CPU correctly rounded."""
    return _through_f64(torch.exp, x)


def log(x: torch.Tensor) -> torch.Tensor:
    """``torch.log``; an f32 tensor on the CPU correctly rounded."""
    return _through_f64(torch.log, x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``torch.tanh``; an f32 tensor on the CPU correctly rounded."""
    return _through_f64(torch.tanh, x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """``torch.sqrt``; an f32 tensor on the CPU correctly rounded."""
    return _through_f64(torch.sqrt, x)


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last axis, its backward's exp through
    :func:`exp` (PyTorch's backward takes MKL's)."""

    @staticmethod
    def forward(x):
        return torch.logsumexp(x, dim=-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * exp(x - out[..., None])


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis (the forward is PyTorch's, whose exp
    does not depend on the host)."""
    return _LogSumExp.apply(x)
