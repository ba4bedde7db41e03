"""Block-contract registry: each block kind declares its serving contract
as data, and consumers (``lm.py``'s builders, the serve engine's gates)
read the declarations instead of switching on kind strings.

``paged_kv``          the kind's decode state is a shared paged KV pool
                      (implies ``table_class``)
``per_slot_state``    dense per-slot leaves ride the batch axis
``table_class``       name of the block-table class the pool reads
``window``            the table is a sliding-window ring (never shareable)
``prefix_shareable``  cached blocks fully encode the kind's sequential
                      state; fail-closed (default False)
``decodes``           the kind runs in the decode path (False for the
                      encoder's kind, which runs inside ``lm.encode`` only)
``routed_experts``    the kind's FFN routes each token to ``cfg.top_k``
                      of ``cfg.n_experts`` experts
``decode_writes_slot``
                      decode writes the kind's per-slot state (False for
                      a context's keys and values, which decode only
                      reads: the decode step then copies nothing to keep
                      inactive slots' rows)
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator


@dataclasses.dataclass(frozen=True)
class BlockContract:
    kind: str
    paged_kv: bool = False
    per_slot_state: bool = False
    table_class: str | None = None
    window: bool = False
    prefix_shareable: bool = False
    decodes: bool = True
    routed_experts: bool = False
    decode_writes_slot: bool = True

    def __post_init__(self):
        if not self.kind:
            raise ValueError("contract needs a non-empty kind name")
        if self.paged_kv and self.table_class is None:
            raise ValueError(f"kind {self.kind!r}: a paged-pool state needs "
                             "a table_class to address the pool through")
        if self.window and self.table_class is None:
            raise ValueError(f"kind {self.kind!r}: window ring semantics "
                             "describe a block table; declare its table_class")
        if self.window and self.prefix_shareable:
            raise ValueError(f"kind {self.kind!r}: a window ring recycles "
                             "blocks in place and cannot be prefix-shared")


_KINDS: dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator: register a block under its contract's kind name."""
    contract = getattr(cls, "contract", None)
    if not isinstance(contract, BlockContract):
        raise TypeError(
            f"{cls.__name__} must declare a BlockContract as `contract`")
    if contract.kind in _KINDS:
        raise ValueError(f"block kind {contract.kind!r} already registered "
                         f"by {_KINDS[contract.kind].__name__}")
    _KINDS[contract.kind] = cls
    return cls


def unregister(kind: str) -> None:
    _KINDS.pop(kind, None)


@contextlib.contextmanager
def temporary(cls: type) -> Iterator[type]:
    """Register ``cls`` for the duration of a with-block (tests)."""
    register(cls)
    try:
        yield cls
    finally:
        unregister(cls.contract.kind)


def get(kind: str) -> type:
    try:
        return _KINDS[kind]
    except KeyError:
        raise KeyError(f"unknown block kind {kind!r} — registered: "
                       f"{sorted(_KINDS)}") from None


def contract(kind: str) -> BlockContract:
    return get(kind).contract


def kinds() -> list[str]:
    """Registered kind names, sorted."""
    return sorted(_KINDS)


def items() -> list[tuple[str, Any]]:
    return sorted(_KINDS.items())


def view() -> dict[str, Any]:
    """The live kind -> class table (change it through register /
    unregister only)."""
    return _KINDS
