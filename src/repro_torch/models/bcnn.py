"""Binary-dense classifier blocks: the paper's XNOR-CNN as a registered
block kind (Fig. 1(c) / §VI, Fig. 6 workload).

``bindense`` registers from this module, outside ``blocks.py``, as the
reference registers it.  It is an XNOR-Net residual MLP block conditioned
on an image context:

  g  = W_ctx . mean(ctx)          full precision (XNOR-Net keeps the
                                  layer the image enters by at full
                                  precision)
  u  = XNOR(W_up . (norm(x) + g)) binary weights and activations: the
  y  = XNOR(W_down . relu(u))     popcount GEMM the paper's array runs
  x' = x + y

Its decode state is derived from the context: ``g`` (B, 1, d), a pure
function of the request's context, kept per slot so decode never needs
the image.  There is no sequential state, so the kind is chunk-exact and
its decode only reads the state.

The module also carries the classifier-as-generation plumbing: the
stripe images of :mod:`models.xnor_classifier` drawn with the reference's
random bits (:func:`synthetic_images`), images -> context rows
(:func:`image_ctx`) and full-batch SGD on the stripe task
(:func:`train_classifier`).  A class id is a vocab id; a request is one
``QUERY_TOKEN`` prompt whose greedy next token is the class.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import prng, verify
from repro_torch.distributed import ctx as dctx
from repro_torch.models import layers, xnor_classifier
from repro_torch.models.blocks import PagedLayout, _row_out, _whole
from repro_torch.models.params import ParamDef
from repro_torch.models.registry import BlockContract, register

# the classifier head's vocab: class ids are token ids, and the one-token
# prompt is a reserved query token (never a class)
N_CLASSES = 2
QUERY_TOKEN = N_CLASSES
VOCAB = N_CLASSES + 2  # classes + query + one spare


@register
class BinDenseBlock(PagedLayout):
    """A binary MLP block gated by the pooled image context; its state,
    the gate ``g`` (B, 1, d) in cfg.dtype, is written by prefill and only
    read by decode.  Under tensor parallelism a rank computes its column
    blocks of ``w_ctx`` (the gate, and the state, its block of d, as the
    reference places it, gathered whole at its use) and of ``w_up``;
    ``w_down`` is row parallel."""
    contract = BlockContract("bindense", per_slot_state=True,
                             prefix_shareable=True, decode_writes_slot=False)
    tensor_parallel = True

    @classmethod
    def defs(cls, cfg, n):
        d, ff = cfg.d_model, cfg.d_ff
        return {
            "ln1": ParamDef((n, d), (None, None), torch.float32,
                            init="ones"),
            "w_ctx": ParamDef((n, d, d), (None, "fsdp", "tp"),
                              cfg.dtype),  # full precision
            "w_up": ParamDef((n, d, ff), (None, "fsdp", "tp"),
                             cfg.dtype, binarize=True),
            "w_down": ParamDef((n, ff, d), (None, "tp", "fsdp"),
                               cfg.dtype, binarize=True),
        }

    @classmethod
    def _gate(cls, cfg, p, ctx, batch: int):
        """(B, 1, d): the context's mean row through ``w_ctx``; zeros
        without a context."""
        if ctx is None:
            return torch.zeros((batch, 1, dctx.extent(cfg.d_model)[0]),
                               dtype=cfg.dtype, device=p["w_ctx"].device)
        pooled = ctx.float().mean(dim=1, keepdim=True)
        return layers.linear(pooled.to(cfg.dtype), p["w_ctx"]).to(cfg.dtype)

    @classmethod
    def _mlp(cls, cfg, p, x, g):
        (g,) = _whole((g, cfg.d_model))
        h = layers.rms_norm(x, p["ln1"])
        u = layers.linear(dctx.enter(h + g), p["w_up"], cfg.quant)
        return x + _row_out(cfg, p["w_down"], torch.relu(u), cfg.d_ff)

    @classmethod
    def fwd(cls, cfg, p, x, opts, ctx=None):
        g = cls._gate(cfg, p, ctx, x.shape[0])
        return cls._mlp(cfg, p, x, g), (g if opts.want_state else None)

    @classmethod
    def decode(cls, cfg, p, x, state, pos, table, valid=None, ctx=None):
        return cls._mlp(cfg, p, x, state)

    @classmethod
    def chunk(cls, cfg, p, x, state, pos0, valid, n_valid, table, ctx=None):
        # no flow between tokens: padding rows are never read, and the
        # gate does not depend on the position
        g = cls._gate(cfg, p, ctx, x.shape[0])
        state.copy_(g)
        return cls._mlp(cfg, p, x, g)

    @classmethod
    def state_spec(cls, cfg, n, batch, s_max, device):
        return torch.zeros((n, batch, 1, cfg.d_model), dtype=cfg.dtype,
                           device=device)

    @classmethod
    def state_pspec(cls, cfg, ba, kv_shard: str = "heads",
                    tp_size: int = 16):
        return (ba, None, "model")


# ---------------------------------------------------------------------------
# classifier-as-generation plumbing
# ---------------------------------------------------------------------------

def synthetic_images(key: torch.Tensor, n: int, side: int = 16):
    """The two-class stripe task (vertical stripes class 1, horizontal
    class 0, plus 0.8 N(0, 1) noise) with the reference's random bits:
    ``key`` a :mod:`core.prng` key -> ((n, side, side) f32, (n,) int32),
    on the key's device."""
    k1, k2 = prng.split(key)
    y = prng.bernoulli(k1, 0.5, (n,)).to(torch.int32)
    base = torch.from_numpy(xnor_classifier.stripes(y.cpu().numpy(), side))
    noise = prng.normal(k2, (n, side, side))
    x = base.to(noise.device) + torch.tensor(0.8).to(noise.device) * noise
    return x, y


def image_ctx(cfg, images) -> np.ndarray:
    """(N, H, W) images -> (N, n_ctx_tokens, d_model) context rows:
    contiguous pixel bands, no learned patchifier (each block's
    full-precision ``w_ctx`` is the learned part)."""
    if isinstance(images, torch.Tensor):
        images = images.cpu().numpy()
    flat = np.asarray(images, np.float32).reshape(len(images), -1)
    want = cfg.n_ctx_tokens * cfg.d_model
    if flat.shape[1] != want:
        raise ValueError(
            f"image has {flat.shape[1]} pixels; arch {cfg.name} expects "
            f"n_ctx_tokens*d_model = {cfg.n_ctx_tokens}*{cfg.d_model} = "
            f"{want}")
    return flat.reshape(len(images), cfg.n_ctx_tokens, cfg.d_model)


def train_classifier(cfg, *, steps: int = 150, lr: float = 0.1,
                     n_train: int = 512, seed: int = 0, init=None,
                     device="cuda"):
    """Train the LM-shaped classifier end to end (the straight-through
    estimator through the binary layers) on the stripe task by full-batch
    SGD -> (params, train accuracy).

    The model is queried as it is served: one ``QUERY_TOKEN`` prompt, the
    image as context, the class the argmax over the whole vocab at the
    last position, so training also pushes the non-class ids down and
    greedy sampling emits a class id.  Parameters start from ``init``
    (a copy of it; a tree converted from the JAX package's, say) or from
    ``lm.init_params(cfg, seed)``; the images come from the :mod:`core.
    prng` key ``seed + 1``, as the reference draws them.  Runs on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    from repro_torch.models import lm  # lm imports the block registry

    dev = resolve_device(device)
    if init is None:
        init = lm.init_params(cfg, seed, device=dev)
    params = verify.tree_map(lambda p: p.detach().to(dev, copy=True), init)
    imgs, y = synthetic_images(prng.PRNGKey(seed + 1, device=dev), n_train)
    ctx = torch.from_numpy(image_ctx(cfg, imgs)).to(dev)
    tokens = torch.full((n_train, 1), QUERY_TOKEN, dtype=torch.int32,
                        device=dev)
    y = y.to(dev, torch.int64)
    leaves = [p for _, p in verify.tree_flatten_with_path(params)]

    def loss_fn():
        logits, _ = lm.forward(cfg, params, tokens, ctx)
        logp = torch.log_softmax(logits[:, -1, :cfg.vocab].float(), dim=-1)
        return -logp.gather(1, y[:, None]).mean()

    for leaf in leaves:
        leaf.requires_grad_(True)
    for _ in range(steps):
        grads = torch.autograd.grad(loss_fn(), leaves)
        with torch.no_grad():
            for w, g in zip(leaves, grads):
                w.sub_(lr * g)
    for leaf in leaves:
        leaf.requires_grad_(False)
    with torch.no_grad():
        logits, _ = lm.forward(cfg, params, tokens, ctx)
        acc = float((logits[:, -1, :cfg.vocab].argmax(-1) == y)
                    .float().mean())
    return params, acc
