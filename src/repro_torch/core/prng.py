"""A twin of the reference's counter-based PRNG: threefry2x32 as
``jax.random`` draws it with ``jax_threefry_partitionable=True`` (the
default of the JAX release the reference is held on).

The engine's temperature sampling folds a (request, step) seed into its
key and adds Gumbel noise to the logits; reproducing the reference's
tokens needs its exact random bits, so this module follows
``jax._src.prng`` and ``jax._src.random`` step by step:

* a key is two uint32 words, ``PRNGKey(seed) = [seed >> 32, seed & M]``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under the key;
* ``bits(key, shape)``: element ``i`` (row-major) hashes the counter pair
  ``(i >> 32, i & M)`` and returns the XOR of the two output words;
* ``uniform`` ORs the top 23 bits into the mantissa of 1.0, subtracts 1,
  scales to ``[minval, maxval)`` and takes ``max`` with ``minval``;
* ``gumbel`` is ``-log(-log(uniform(tiny, 1)))`` (the "low" mode);
* ``bernoulli`` is ``uniform < p`` (the "low" mode);
* ``normal`` is ``sqrt(2) erfinv(uniform(nextafter(-1, 0), 1))``, with
  XLA's f32 ``erf_inv`` (M. Giles' polynomials) written out.

uint32 arithmetic runs in int64 tensors masked to 32 bits, on whatever
device the key lies on (CUDA has few uint32 ops): plain tensor ops, no
kernel.  A key is an int64 tensor of shape ``(..., 2)`` holding the two
words; leading axes batch independent keys (the engine's per-row keys).
``gumbel``'s ``log`` and ``normal``'s ``log1p`` are torch's, which may
differ from XLA's in the last bit; the bits, uniforms and Bernoulli draws
are exact.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """The raw key of an integer seed: ``(2,)`` words ``[hi, lo]``.  The
    reference converts the seed to int32 first, so the high word is 0."""
    lo = int(seed) & MASK
    return torch.tensor([0, lo], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 hash of counter words (x0, x1) under key
    words (k0, k1); every argument an int64 tensor of uint32 values, all
    broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` and a 32-bit datum.
    ``data`` may be an int or a tensor broadcasting against the key's
    leading axes."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    h0, h1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([h0, h1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one key -> ``(num, 2)`` keys."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    h0, h1 = threefry2x32(key[..., 0, None], key[..., 1, None], i >> 32,
                          i & MASK)
    return torch.stack([h0, h1], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): ``key.shape[:-1] + shape`` uint32
    values as int64.  Element ``i`` of the flattened ``shape`` hashes the
    counter ``(i >> 32, i & M)``; the two output words are XORed."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(lead + (1,))
    k1 = key[..., 1].reshape(lead + (1,))
    h0, h1 = threefry2x32(k0, k1, i >> 32, i & MASK)
    return (h0 ^ h1).reshape(lead + shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32, bit for bit."""
    b = bits(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 ("low" mode)."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def randint(key: torch.Tensor, minval: int, maxval: int) -> int:
    """``int(jax.random.randint(key, (), minval, maxval))`` for int32
    bounds with ``minval < maxval``: two 32-bit draws reduced modulo the
    span in wrapping uint32 arithmetic, as the reference does."""
    k = split(key)
    hi, lo = (int(bits(k[j], ())) for j in (0, 1))
    span = (maxval - minval) & MASK
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    off = (((hi % span) * mult & MASK) + lo % span) & MASK
    return minval + off % span


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` (f32 ``p``, "low" mode): bool draws."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


# XLA's f32 erf_inv: M. Giles, "Approximating the erfinv function" (2010),
# the polynomial in w = -log(1 - x^2) for w < 5 and in sqrt(w) - 3 past it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``, step for step: Horner in f32, +-inf at
    +-1."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.tensor(2 ** 0.5, dtype=torch.float32) * erf_inv(u)
