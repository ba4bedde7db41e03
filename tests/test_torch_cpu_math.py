"""The CPU path's products and f32 transcendentals (``models/cpu_math.py``,
fault F7) against the jitted reference's, and their bits across the
instruction sets the host libraries may take.

- ``cpu_math.matmul`` equals a jitted ``x @ y`` bit for bit at the
  shapes the models reach (the smoke configs' linears and heads, f32
  and bf16 operands), and ``cpu_math.einsum`` a jitted ``jnp.einsum`` at
  attention's contractions (the GQA forms too), ``cpu_math.bmm`` the
  experts' einsum, and ``ssm.conv1d_step`` the reference's (XLA's
  vector-matrix emitter's order, with and without FMA);
- the compiled chain (``cpu_dot.c``) equals the same order in PyTorch
  ops (``cpu_math.lanes_dot``) bit for bit, K blocks and lanes included;
- the backward products are the same chain (``torch.autograd``);
- the products and ``exp`` / ``log`` / ``tanh`` / ``sqrt`` give the same
  bits in a process whose MKL and oneDNN are held to AVX2 / AVX-512
  BF16 (what an AMD host takes) as in one left to the host.
"""

import hashlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import cpu_math

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("m, k, n", [
    (4, 64, 128), (32, 64, 256), (24, 128, 64), (128, 64, 256),
    (1, 64, 256), (8, 64, 8), (4, 256, 512), (48, 256, 256),
    (64, 256, 256), (8, 64, 1024)])
def test_matmul_is_the_jitted_dot(m, k, n, dtype):
    rng = np.random.default_rng(m * 1000 + k + n)
    a = jnp.asarray(rng.standard_normal((m, k)), dtype)
    b = jnp.asarray(rng.standard_normal((k, n)), dtype)
    want = np.asarray(jax.jit(lambda x, y: x @ y)(a, b).astype(jnp.float32))
    ta = torch.from_numpy(np.array(a.astype(jnp.float32)))
    tb = torch.from_numpy(np.array(b.astype(jnp.float32)))
    got = cpu_math.matmul(ta, tb)
    if dtype == jnp.bfloat16:
        got = got.bfloat16().float()
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("eq, sa, sb", [
    ("bqhd,bshd->bhqs", (2, 24, 4, 16), (2, 24, 4, 16)),
    ("bhqs,bshd->bqhd", (2, 4, 24, 24), (2, 24, 4, 16)),
    ("bqkgd,bskd->bkgqs", (2, 24, 1, 4, 16), (2, 24, 1, 16)),
    ("bkgqs,bskd->bqkgd", (2, 1, 4, 24, 24), (2, 24, 1, 16)),
    ("bqkgd,bksd->bkgqs", (2, 1, 1, 4, 16), (2, 1, 40, 16)),
    ("bkgqs,bksd->bqkgd", (2, 1, 4, 1, 40), (2, 1, 40, 16))])
def test_einsum_is_the_jitted_einsum(eq, sa, sb):
    rng = np.random.default_rng(len(eq) + sum(sa))
    a = rng.standard_normal(sa).astype(np.float32)
    b = rng.standard_normal(sb).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y: jnp.einsum(eq, x, y))(a, b))
    got = cpu_math.einsum(eq, torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("e, g, c, d, f", [
    (4, 2, 3, 64, 96), (4, 2, 20, 64, 96), (2, 1, 40, 96, 64),
    (4, 8, 2, 128, 48)])
def test_bmm_is_the_jitted_expert_product(e, g, c, d, f, dtype):
    """``cpu_math.bmm`` over (expert, group * place) rows, rounded to the
    operands' dtype, equals the reference's expert einsum."""
    rng = np.random.default_rng(e * g * c + d + f)
    a = jnp.asarray(rng.standard_normal((e, g, c, d)), dtype)
    b = jnp.asarray(rng.standard_normal((e, d, f)), dtype)
    want = np.asarray(jax.jit(lambda x, y: jnp.einsum("egcd,edf->egcf", x, y))(
        a, b).astype(jnp.float32))
    ta = torch.from_numpy(np.array(a.astype(jnp.float32)))
    tb = torch.from_numpy(np.array(b.astype(jnp.float32)))
    got = cpu_math.bmm(ta.reshape(e, g * c, d), tb)
    if dtype == jnp.bfloat16:
        got = got.bfloat16().float()
    assert np.array_equal(got.reshape(e, g, c, f).numpy(), want)


@pytest.mark.parametrize("g, m, k, n", [
    (1, 24, 64, 256), (3, 5, 200, 8), (2, 48, 600, 300), (1, 70, 40, 24)])
def test_compiled_chain_is_the_torch_chain(g, m, k, n):
    gen = torch.Generator().manual_seed(g * m + k + n)
    a = torch.randn((g, m, k), generator=gen)
    b = torch.randn((g, k, n), generator=gen)
    got = cpu_math._mm(a, b)
    lanes = 4 if m > 1 and n <= cpu_math.NARROW and m * n > 4 else 1
    kc = cpu_math.block(m, n, k)
    want = None
    for s in range(0, k, kc):
        part = cpu_math.lanes_dot(a[:, :, None, s:s + kc],
                                  b.transpose(1, 2)[:, None, :, s:s + kc],
                                  lanes)
        want = part if want is None else want + part
    assert torch.equal(got, want)


def test_backward_products_are_the_chain():
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((6, 32), generator=gen, requires_grad=True)
    w = torch.randn((32, 40), generator=gen, requires_grad=True)
    g = torch.randn((6, 40), generator=gen)
    cpu_math.matmul(x, w).backward(g)
    assert torch.equal(x.grad, cpu_math.matmul(g, w.detach().t()))
    assert torch.equal(w.grad, cpu_math.matmul(x.detach().t(), g))


def _conv_step_case(b: int, dtype):
    from repro.models import ssm as jssm
    from repro_torch.models import ssm
    rng = np.random.default_rng(b)
    buf, x, k = (jnp.asarray(rng.standard_normal(shape), dtype)
                 for shape in ((b, 3, 96), (b, 1, 96), (4, 96)))
    want, _ = jax.jit(jssm.conv1d_step)(buf, x, k)
    tt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    got, _ = ssm.conv1d_step(*(torch.from_numpy(np.array(
        t.astype(jnp.float32))).to(tt) for t in (buf, x, k)))
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 3, 8, 9, 17])
def test_conv_step_is_the_jitted_reference(b, dtype):
    """``ssm.conv1d_step`` equals the jitted reference's decode step of
    the causal conv bit for bit (its taps' order: fused chains, the lone
    tile columns' products rounded first)."""
    got, want = _conv_step_case(b, dtype)
    assert np.array_equal(got, want)


_NO_FMA = """
import jax.numpy as jnp, numpy as np
import test_torch_cpu_math as t
from repro_torch.models import cpu_math
cpu_math.host_fma = lambda: False
print(all(np.array_equal(*t._conv_step_case(b, jnp.float32))
          for b in (1, 2, 8, 9)))
"""


def test_conv_step_without_fma_is_the_reference_without_fma():
    """Where the host has no FMA (XLA held to SSE4.2 here) the reference
    rounds every product of the taps' sum first, and so does the port
    told that the host has none."""
    run = subprocess.run(
        [sys.executable, "-c", _NO_FMA], check=True, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_cpu_max_isa=SSE4_2",
             "PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "src"),
                                            os.path.join(ROOT, "tests")])})
    assert run.stdout.strip().splitlines()[-1] == "True"


_PROBE = """
import hashlib, torch
from repro_torch.models import cpu_math
torch.set_num_threads(1)
g = torch.Generator().manual_seed(0)
x = torch.randn((64, 256), generator=g)
w = torch.randn((256, 512), generator=g)
outs = [cpu_math.matmul(x, w), cpu_math.matmul(x.bfloat16(), w.bfloat16()),
        cpu_math.einsum("bqhd,bshd->bhqs", torch.randn((2, 24, 4, 16),
                        generator=g), torch.randn((2, 24, 4, 16),
                                                  generator=g))]
v = torch.randn((1 << 16,), generator=g) * 4
outs += [cpu_math.exp(v), cpu_math.log(v.abs() + 1e-3), cpu_math.tanh(v),
         cpu_math.sqrt(v.abs())]
print(hashlib.sha256(b"".join(t.float().numpy().tobytes()
                              for t in outs)).hexdigest())
"""


def _probe(env: dict) -> str:
    run = subprocess.run([sys.executable, "-c", _PROBE], check=True,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.join(
                             ROOT, "src"), **env})
    return run.stdout.strip()


def test_bits_do_not_follow_the_host_libraries_isa():
    """MKL's AVX2 path and oneDNN without AMX (an AMD host's) sum and
    round otherwise; the port's CPU products and transcendentals do
    not go through them."""
    host = _probe({})
    capped = _probe({"MKL_ENABLE_INSTRUCTIONS": "AVX2",
                     "ONEDNN_MAX_CPU_ISA": "AVX512_CORE_BF16"})
    assert host == capped
    assert len(host) == len(hashlib.sha256().hexdigest())
