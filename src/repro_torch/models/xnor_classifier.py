"""The XNOR-Net binary classifier of paper Fig. 1(c) / §VI, forward only.

The network of ``examples/xnor_cnn_classifier.py``: a full-precision first
layer (256 -> 512, tanh), one binary layer (512 -> 512, XNOR-Net sign
weights and activations with alpha/beta scales, ReLU) and a full-precision
last layer (512 -> 2), on a 16x16 two-class stripe task.  With
``packed=True`` the binary layer runs in the bit domain — both operands
packed, then the XNOR-popcount product (the ``xnor_gemm`` kernel on CUDA),
the compute the paper's CiM array does in memory; otherwise the
float-domain sign product.  The two agree to float rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import xnor_layers
from repro_torch.models import cpu_math, layers

D_IN, D_H, N_CLS = 256, 512, 2


def make_data(rng: np.random.Generator, n: int):
    """n images of vertical (class 1) or horizontal (class 0) stripes plus
    0.8 Gaussian noise -> ((n, 256) f32, (n,) int32), drawn with numpy."""
    y = rng.integers(0, 2, size=n).astype(np.int32)
    base = stripes(y, 16)
    x = base + 0.8 * rng.standard_normal((n, 16, 16))
    return x.reshape(n, D_IN).astype(np.float32), y


def stripes(y: np.ndarray, side: int) -> np.ndarray:
    """The noiseless images of labels ``y``: (n, side, side) f32, +-1
    vertical stripes sign(sin(8 x)) over x in [-1, 1] for class 1, their
    transpose for class 0."""
    xs = np.linspace(-1, 1, side, dtype=np.float32)
    vert = np.repeat(np.sign(np.sin(8 * xs))[None, :], side, axis=0)
    return np.where(np.asarray(y)[:, None, None] == 1, vert[None],
                    vert.T[None])


def init(generator: torch.Generator, device) -> dict:
    """Weights ~ N(0, 1/fan_in), the example's scale."""
    def s(shape):
        w = torch.randn(shape, generator=generator, device=device)
        return w / np.sqrt(shape[-1])
    return {"w_in": s((D_H, D_IN)), "w_mid": s((D_H, D_H)),
            "w_out": s((N_CLS, D_H))}


def forward(params: dict, x: torch.Tensor, packed: bool = False):
    """(n, 256) images -> (n, 2) logits."""
    h = cpu_math.tanh(layers.matmul(x, params["w_in"].T))  # fp first layer
    h = xnor_layers.xnor_linear(h, params["w_mid"], packed=packed)
    h = torch.relu(h)
    return layers.matmul(h, params["w_out"].T)         # fp last layer
