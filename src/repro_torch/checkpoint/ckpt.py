"""Checkpoints with the paper's two memory-side applications in the I/O
path:

* every leaf is saved with an **XOR-parity digest** (copy verification,
  paper Fig. 1(a)): digests are taken before the write, stored in the
  manifest, and checked again after the write (write-verify) and on
  restore, so any single-bit corruption in a member is found;
* optional **XOR stream encryption** (paper Fig. 1(b)): each leaf is
  ciphered with a counter-mode pad keyed by (root key, write step, leaf
  path) — :func:`repro_torch.core.encrypt.pad_path` — so no pad is reused
  across leaves or steps, full or delta.

Format, byte for byte the reference's (``repro/checkpoint/ckpt.py``): one
``ckpt_%08d.npz`` per step (member ``a__b__0.npy`` per leaf ``a/b/0``, in
tree order; bf16 members carry numpy's ``'<V2'`` header, as ml_dtypes'
bfloat16 writes it; encrypted members are uint8) and a
``manifest_%08d.msgpack`` (shape, numpy dtype name, digest and
``stored_in`` step per leaf).  The npz container itself differs: zip
entries carry the time of writing.  Either package restores the other's
checkpoints.

**Delta checkpoints** (:func:`save_delta`): a delta step's npz holds only
the leaves whose digest moved against the base manifest; every manifest
entry names the step whose npz holds its bytes (``stored_in``), so
``check`` and ``restore`` resolve a chain in one hop per leaf.

Writes go through a **one-leaf double buffer** (:func:`_write_payload`):
leaf k's bytes are brought to the host, leaf k+1's digest and cipher are
dispatched, and then leaf k is written — so with ``engine=`` the card
computes leaf k+1 while the host writes leaf k.  Leaves reach the host one
at a time; a bf16 leaf travels as its 16-bit words.

Digests and the cipher run on the card: through ``engine=`` (a
:class:`repro_torch.core.engine.CimEngine`) where the caller passes one,
else through an engine on ``device`` (``"cuda"`` unless the caller asks
for ``"cpu"``, which runs them on the host in numpy, as the reference's
``engine=None`` does).  A leaf on the engine's device is digested and
ciphered where it lies, and a member read from disk crosses to the device
once.  Both paths give the same bytes.

Trees are nested dicts, lists and tuples of tensors or numpy arrays
(:func:`repro_torch.core.verify.tree_flatten_with_path`); restores return
tensors.  Word buffers are int32 tensors in the port, so a tree of packed
planes would be written as ``int32`` where the reference writes
``uint32``.
"""

from __future__ import annotations

import contextlib
import os
import re
import zipfile
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import _msgpack
from repro_torch.core import bitpack, encrypt, verify
from repro_torch.core.engine import CimEngine

_BF16 = "bfloat16"
_BF16_HOST = np.dtype("V2")        # bf16 bits on the host, as npz reads them


# -- dtypes: numpy's names; a bf16 leaf is held as 2-byte voids on the host -


def _dtype_name(dtype) -> str:
    if dtype == torch.bfloat16:
        return _BF16
    if isinstance(dtype, torch.dtype):
        return str(torch.empty((), dtype=dtype).numpy().dtype)
    return str(np.dtype(dtype))


def _torch_dtype(name: str) -> torch.dtype:
    if name == _BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def _host_dtype(name: str) -> np.dtype:
    return _BF16_HOST if name == _BF16 else np.dtype(name)


def _leaf_meta(leaf) -> tuple[list, str]:
    """(shape, dtype name) without moving the leaf."""
    if isinstance(leaf, torch.Tensor):
        return list(leaf.shape), _dtype_name(leaf.dtype)
    arr = np.asarray(leaf)
    return list(arr.shape), str(arr.dtype)


def _host(leaf) -> np.ndarray:
    """One leaf's bytes as a C-contiguous host array (bf16: 2-byte voids)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return np.ascontiguousarray(
                t.view(torch.int16).cpu().numpy()).view(_BF16_HOST)
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)


def _coerce(raw: np.ndarray, name: str) -> np.ndarray:
    """A member as read back, viewed as the manifest's dtype."""
    want = _host_dtype(name)
    if raw.dtype != want and raw.dtype.itemsize == want.itemsize:
        return raw.view(want)
    return raw


def _flatten(tree) -> dict:
    return {verify.leaf_key(p): leaf
            for p, leaf in verify.tree_flatten_with_path(tree)}


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def _member(key: str) -> str:
    return key.replace("/", "__") + ".npy"


# -- digests and the cipher: the engine's device, or the host -----------------


def _engine(engine, device, cache=None):
    """The engine digests and the cipher go through: ``engine``, else the
    cache's, else a new one on ``device``; ``None`` (the host path) only
    when the caller asks for the CPU."""
    if engine is not None:
        return engine
    if cache is not None:
        return cache.engine
    dev = resolve_device(device)
    return None if dev.type == "cpu" else CimEngine(device=dev)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def _digest(leaf, engine) -> np.ndarray:
    if engine is None:
        return verify.np_digest(_host(leaf))
    return bitpack.to_numpy_u32(engine.digest(engine.words(leaf),
                                              verify.DIGEST_WIDTH))


def _stage_leaf(leaf, pad_path: str, root_key, engine, dig=None):
    """Dispatch one leaf's digest and cipher -> ``(digest, payload_fn)``.

    ``digest`` is a host array or an in-flight device tensor;
    ``payload_fn()`` brings the bytes to write to the host, which is the
    only wait.  ``dig`` skips the digest when the caller holds it."""
    if engine is None:
        arr = _host(leaf)
        if dig is None:
            dig = verify.np_digest(arr)
        buf = (arr if root_key is None
               else encrypt.encrypt_np(arr, root_key, pad_path))
        return dig, (lambda: buf)
    if dig is None or root_key is not None:
        words = engine.words(leaf)          # one host-to-device copy at most
    if dig is None:
        dig = engine.digest(words, verify.DIGEST_WIDTH)
    if root_key is None:
        return dig, (lambda: _host(leaf))
    nbytes = _nbytes(leaf)
    enc = encrypt.encrypt_device(words, root_key, pad_path, engine=engine)
    return dig, (lambda: enc.cpu().numpy().view(np.uint8)[:nbytes])


def _write_member(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    """``np.lib.format.write_array``'s bytes, streamed into the zip; a bf16
    member gets the ``'<V2'`` descr numpy writes for ml_dtypes' bfloat16."""
    header = np.lib.format.header_data_from_array_1_0(arr)
    if arr.dtype == _BF16_HOST:
        header["descr"] = "<V2"
    with zf.open(_member(key), "w", force_zip64=True) as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(arr.reshape(-1).view(np.uint8).data)


def _write_payload(path: str, flat: dict, stage: Callable) -> dict:
    """npz writer with a one-leaf double buffer: leaf k's bytes come to the
    host, leaf k+1's work is dispatched, then leaf k is written.  Returns
    the per-leaf digests as host arrays."""
    digs: dict[str, np.ndarray] = {}
    items = iter(flat.items())

    def dispatch():
        nxt = next(items, None)
        return None if nxt is None else (nxt[0], *stage(*nxt))

    with open(path, "wb") as f, \
            zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                            allowZip64=True) as zf:
        pending = dispatch()
        while pending is not None:
            key, dig, payload_fn = pending
            arr = np.asarray(payload_fn())      # waits for leaf k only
            pending = dispatch()                # leaf k+1 runs on the card...
            _write_member(zf, key, arr)         # ...while leaf k is written
            digs[key] = (bitpack.to_numpy_u32(dig)
                         if isinstance(dig, torch.Tensor) else np.asarray(dig))
    return digs


# -- save: full and delta -----------------------------------------------------


def save(directory: str, step: int, tree, *, root_key: str | None = None,
         verify_write: bool = True, engine=None, device="cuda") -> dict:
    """Write a full checkpoint; returns the manifest (also written to disk).

    Digests and the cipher go through ``engine`` or a new engine on
    ``device`` (cycle-accounted, and overlapped with the host write by the
    double buffer); ``device="cpu"`` runs them in numpy on the host, with
    the same bytes."""
    engine = _engine(engine, device)
    os.makedirs(directory, exist_ok=True)
    _refuse_clobbering_chained_base(directory, step)
    flat = _flatten(tree)
    path = _ckpt_path(directory, step)
    tmp = path + ".tmp"                 # write + rename: atomic publish
    digs = _write_payload(
        tmp, flat,
        lambda key, leaf: _stage_leaf(leaf, encrypt.pad_path(step, key),
                                      root_key, engine))
    os.replace(tmp, path)
    metas = {key: _leaf_meta(leaf) for key, leaf in flat.items()}
    manifest: dict[str, Any] = {
        "step": step, "base_step": None, "encrypted": root_key is not None,
        "leaves": {key: {"shape": metas[key][0], "dtype": metas[key][1],
                         "digest": digs[key].tobytes().hex(),
                         "stored_in": step}
                   for key in flat}}
    if verify_write:  # read back and parity-check the copy (paper Fig. 1(a))
        _verify_or_unpublish(directory, step, manifest, root_key, engine,
                             None, path)
    _write_manifest(directory, step, manifest)
    return manifest


def save_delta(directory: str, step: int, tree, *,
               base_step: int | None = None, root_key: str | None = None,
               verify_write: bool = True, engine=None, cache=None,
               device="cuda") -> dict:
    """Write a delta checkpoint: only the leaves whose digest moved against
    the base.

    ``base_step`` defaults to the latest published step (itself possibly a
    delta).  Write-verify re-checks only the leaves this step wrote.
    ``cache`` (a :class:`repro_torch.core.incremental.DigestCache`) makes
    the dirty scan incremental and exact: a leaf its word compare saw
    change is stored even when its parity digest collides with the base's,
    and a leaf it meets for the first time is stored (an unprimed cache
    degrades to a full save).  Prime it at or before the base save.
    Without a cache every leaf is digested, one at a time.  ``engine`` and
    ``device`` are :func:`save`'s; with a cache the work goes through
    ``cache.engine``."""
    if cache is not None and engine is not None and engine is not cache.engine:
        raise ValueError("save_delta: cache= and engine= conflict — the "
                         "dirty scan digests through cache.engine; pass "
                         "the same engine (or build the cache from it)")
    engine = _engine(engine, device, cache)
    os.makedirs(directory, exist_ok=True)
    if base_step is None:
        base_step = latest_step(directory)
    if base_step is None:
        raise FileNotFoundError(
            f"no base checkpoint under {directory} to delta against; "
            "write a full save() first")
    if step <= base_step:
        raise ValueError(
            f"delta step {step} must be greater than its base {base_step}")
    _refuse_clobbering_chained_base(directory, step)
    base = _load_manifest(directory, base_step)
    if base["encrypted"] != (root_key is not None):
        raise ValueError(
            f"delta step {step} and base step {base_step} disagree on "
            "encryption; a chain must be uniformly "
            + ("encrypted" if base["encrypted"] else "plain"))

    leaves = _flatten(tree)             # nothing moves off its device here
    metas = {k: _leaf_meta(leaf) for k, leaf in leaves.items()}
    if cache is not None:
        if cache.digest_width != verify.DIGEST_WIDTH:
            raise ValueError(
                f"save_delta: cache digest_width={cache.digest_width} must "
                f"be the manifest width {verify.DIGEST_WIDTH}")
        digs = {k: np.asarray(d) for k, d in _flatten(cache.digests(tree))
                .items()}
        observed = cache.observed_since_save
        unproven = cache.last_leaf_new
    else:
        digs = {k: _digest(leaf, engine) for k, leaf in leaves.items()}
        observed, unproven = {}, set()
    base_leaves = base["leaves"]
    # digests cover bytes only: a dtype or shape change with identical bytes
    # is stored again
    dirty = [key for key in leaves
             if key not in base_leaves
             or observed.get(key, 0) > 0
             or key in unproven
             or digs[key].tobytes().hex() != base_leaves[key]["digest"]
             or metas[key][0] != list(base_leaves[key]["shape"])
             or metas[key][1] != base_leaves[key]["dtype"]]

    path = _ckpt_path(directory, step)
    tmp = path + ".tmp"
    _write_payload(
        tmp, {k: leaves[k] for k in dirty},
        lambda key, leaf: _stage_leaf(leaf, encrypt.pad_path(step, key),
                                      root_key, engine, dig=digs[key]))
    os.replace(tmp, path)

    dirty_set = set(dirty)
    manifest: dict[str, Any] = {
        "step": step, "base_step": base_step,
        "encrypted": root_key is not None,
        "leaves": {key: {
            "shape": metas[key][0], "dtype": metas[key][1],
            "digest": digs[key].tobytes().hex(),
            "stored_in": (step if key in dirty_set else
                          int(base_leaves[key].get("stored_in", base_step))),
        } for key in leaves}}
    if verify_write:
        _verify_or_unpublish(directory, step, manifest, root_key, engine,
                             dirty, path)
    _write_manifest(directory, step, manifest)
    if cache is not None:
        cache.mark_saved()
    return manifest


def _verify_or_unpublish(directory: str, step: int, manifest: dict,
                         root_key, engine, leaves, npz_path: str) -> None:
    """Write-verify against the in-memory manifest before it is published;
    on failure remove the npz (a published bad step would become the next
    delta's base with digests that read as clean) and raise."""
    ok, bad = _check_manifest(directory, step, manifest, root_key=root_key,
                              engine=engine, leaves=leaves)
    if not ok:
        os.remove(npz_path)
        raise IOError(f"checkpoint write verification failed at step {step}, "
                      f"step unpublished: {bad}")


def _write_manifest(directory: str, step: int, manifest: dict) -> None:
    """The manifest is the step's publish record: write, then rename."""
    path = os.path.join(directory, f"manifest_{step:08d}.msgpack")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_msgpack.packb(manifest))
    os.replace(tmp, path)


def _refuse_clobbering_chained_base(directory: str, step: int) -> None:
    """Refuse to overwrite a step that a newer manifest's chain still reads
    (its ``stored_in`` entries name this step as the only copy)."""
    if not os.path.isdir(directory):
        return
    for f in os.listdir(directory):
        m = re.match(r"manifest_(\d+)\.msgpack$", f)
        if not m or (other_step := int(m.group(1))) <= step:
            continue
        try:
            other = _load_manifest(directory, other_step)
        except (ValueError, KeyError, FileNotFoundError):
            continue        # torn (crashed write) or vanished: not a chain
        if any(int(meta.get("stored_in", other_step)) == step
               for meta in other["leaves"].values()):
            raise ValueError(
                f"step {step} holds the only copy of leaves that step "
                f"{other_step}'s delta chain references; overwriting it "
                "would orphan that chain — save to a new step instead")


# -- read side: chain-resolving check and restore ---------------------------


@contextlib.contextmanager
def _payloads(directory: str, metas: dict, default_step: int):
    """Open every npz that a set of manifest entries stores bytes in."""
    steps = {int(m.get("stored_in", default_step)) for m in metas.values()}
    with contextlib.ExitStack() as stack:
        out = {}
        for s in sorted(steps):
            p = _ckpt_path(directory, s)
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"step {default_step} references leaves stored in step "
                    f"{s}, but {p} is missing (delta base pruned?)")
            out[s] = stack.enter_context(np.load(p))
        yield out


def _read_leaf(payloads: dict, key: str, meta: dict, encrypted: bool,
               root_key, engine, default_step: int):
    """A leaf's plaintext: a host array of its dtype and shape, or (with
    ``engine``) its word stream on the engine's device."""
    stored_in = int(meta.get("stored_in", default_step))
    raw = payloads[stored_in][_member(key)]
    if encrypted and root_key is None:
        raise ValueError("checkpoint is encrypted; pass root_key= to "
                         "decrypt it")
    leaf_path = encrypt.pad_path(stored_in, key)
    if engine is None:
        if encrypted:
            return encrypt.decrypt_np(raw, root_key, leaf_path,
                                      _host_dtype(meta["dtype"]),
                                      tuple(meta["shape"]))
        return _coerce(raw, meta["dtype"])
    words = engine.words(raw)                    # one host-to-device copy
    if encrypted:
        words = encrypt.encrypt_device(words, root_key, leaf_path,
                                       engine=engine)
        words.view(torch.uint8)[raw.nbytes:] = 0  # the pad of a ragged tail
    return words


def _plain_digest(plain, engine) -> str:
    if engine is None:
        dig = verify.np_digest(plain)
    else:
        dig = bitpack.to_numpy_u32(engine.digest(plain, verify.DIGEST_WIDTH))
    return dig.tobytes().hex()


def _leaf_tensor(plain, meta: dict, device) -> torch.Tensor:
    """A plaintext from :func:`_read_leaf` as a tensor of the manifest's
    dtype and shape on ``device``."""
    dtype = _torch_dtype(meta["dtype"])
    if isinstance(plain, torch.Tensor):
        nbytes = int(np.prod(meta["shape"])) * dtype.itemsize
        t = plain.view(torch.uint8)[:nbytes].view(dtype)
    else:
        arr = np.ascontiguousarray(plain)
        if meta["dtype"] == _BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(dtype)
        else:
            t = torch.from_numpy(arr)
    return t.reshape(meta["shape"]).to(device)


def check(directory: str, step: int, *, root_key: str | None = None,
          engine=None, leaves: list[str] | None = None, device="cuda"):
    """Parity-verify a checkpoint on disk against its manifest ->
    ``(ok, bad leaf keys)``.  Follows delta chains; ``leaves=`` restricts
    the check to a subset; ``engine`` and ``device`` are :func:`save`'s."""
    engine = _engine(engine, device)
    return _check_manifest(directory, step, _load_manifest(directory, step),
                           root_key=root_key, engine=engine, leaves=leaves)


def _check_manifest(directory: str, step: int, manifest: dict, *,
                    root_key=None, engine=None, leaves=None):
    metas = manifest["leaves"]
    if leaves is not None:
        metas = {k: metas[k] for k in leaves}
    bad = []
    with _payloads(directory, metas, step) as payloads:
        for key, meta in metas.items():
            plain = _read_leaf(payloads, key, meta, manifest["encrypted"],
                               root_key, engine, step)
            if _plain_digest(plain, engine) != meta["digest"]:
                bad.append(key)
    return (not bad), bad


def _like_dtype(leaf) -> torch.dtype | None:
    dtype = getattr(leaf, "dtype", None)
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _torch_dtype(_dtype_name(dtype))


def restore(directory: str, step: int | None, like, *,
            root_key: str | None = None, verify_read: bool = True,
            engine=None, transform: Callable | None = None, device="cuda"):
    """Load into the structure of ``like`` -> ``(tree, step)``; leaves are
    tensors on ``device`` (CUDA unless the caller asks for the CPU), cast
    to the dtype of ``like``'s leaf where it has one.  Digests and the
    cipher go through ``engine``, else an engine on ``device`` (numpy on
    the host for ``device="cpu"``).

    ``like`` may hold tensors on the ``meta`` device, so nothing is
    allocated before a leaf streams in.  ``transform(key, tensor)`` maps
    each leaf, after its parity check and cast, to its in-memory form as
    it streams in (what :func:`restore_packed` packs with).  Delta chains
    resolve transparently."""
    dev = resolve_device(device)
    engine = _engine(engine, dev)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    manifest = _load_manifest(directory, step)
    out, bad = [], []
    with _payloads(directory, manifest["leaves"], step) as payloads:
        for path, leaf in verify.tree_flatten_with_path(like):
            key = verify.leaf_key(path)
            meta = manifest["leaves"][key]
            plain = _read_leaf(payloads, key, meta, manifest["encrypted"],
                               root_key, engine, step)
            if verify_read and _plain_digest(plain, engine) != meta["digest"]:
                bad.append(key)
            t = _leaf_tensor(plain, meta, dev)
            del plain
            dtype = _like_dtype(leaf)
            if dtype is not None:
                t = t.to(dtype)
            out.append(transform(key, t) if transform is not None else t)
    if bad:
        raise IOError(f"checkpoint corruption detected in leaves: {bad}")
    it = iter(out)
    return verify.tree_map(lambda _: next(it), like), step


def _binarizable(defs, prefix: str = "") -> set[str]:
    """Leaf keys of the ``binarize``-marked linears of a ParamDef tree."""
    keys = set()
    for name, d in defs.items():
        if isinstance(d, dict):
            keys |= _binarizable(d, f"{prefix}{name}/")
        elif d.binarize:
            keys.add(f"{prefix}{name}")
    return keys


def restore_packed(directory: str, step: int | None, cfg, *,
                   root_key: str | None = None, verify_read: bool = True,
                   engine=None, device="cuda"):
    """Restore a float parameter checkpoint straight into serve-resident
    form: binarizable linears of a ``quant="xnor"`` arch are packed to
    :class:`repro_torch.core.xnor_layers.PackedLinear` as each leaf streams
    in, so the float copy of a linear lives for one leaf.  Equals
    ``lm.pack_params(cfg, restore(...)[0])`` leaf for leaf; other archs
    restore unchanged."""
    from repro_torch.core import xnor_layers
    from repro_torch.models import lm

    like = lm.abstract_params(cfg)
    if cfg.quant != "xnor":
        return restore(directory, step, like, root_key=root_key,
                       verify_read=verify_read, engine=engine, device=device)
    binarizable = _binarizable(lm.param_defs(cfg))

    def transform(key: str, t: torch.Tensor):
        return xnor_layers.pack_linear(t) if key in binarizable else t
    return restore(directory, step, like, root_key=root_key,
                   verify_read=verify_read, engine=engine,
                   transform=transform, device=device)


def latest_step(directory: str) -> int | None:
    """Latest published step: both its manifest (the publish record) and
    its npz exist."""
    if not os.path.isdir(directory):
        return None
    steps = [s for f in os.listdir(directory)
             if (m := re.match(r"manifest_(\d+)\.msgpack$", f))
             and os.path.exists(_ckpt_path(directory, s := int(m.group(1))))]
    return max(steps) if steps else None


def _load_manifest(directory: str, step: int) -> dict:
    with open(os.path.join(directory, f"manifest_{step:08d}.msgpack"),
              "rb") as f:
        return _msgpack.unpackb(f.read())
