"""Tagged variable handles.

The port's own copy of the JAX package's `relations/variable.py`.

Mirrors the reference's packed-u64 `Variable` (relations/src/utils/variable.rs:
2-22): 3-bit tag in the top bits, 61-bit payload, with the load-bearing
property that plain integer ordering sorts first by kind then by index
(variable.rs Ord derives from the raw u64). We encode variables as plain
Python ints with the same bit layout so they order identically, hash fast,
and pack directly into uint64 NumPy arrays for the columnar LC store.

Kinds: Zero=0, One=1, Instance=2, Witness=3, SymbolicLc=4 (variable.rs:177-183).
"""

from __future__ import annotations

TAG_SHIFT = 61
PAYLOAD_MASK = (1 << TAG_SHIFT) - 1

KIND_ZERO = 0
KIND_ONE = 1
KIND_INSTANCE = 2
KIND_WITNESS = 3
KIND_SYMBOLIC_LC = 4

ZERO = 0
ONE = KIND_ONE << TAG_SHIFT


def instance(i: int) -> int:
    """Instance (public input) variable with index i."""
    return (KIND_INSTANCE << TAG_SHIFT) | i


def witness(i: int) -> int:
    """Witness (private input) variable with index i."""
    return (KIND_WITNESS << TAG_SHIFT) | i


def symbolic_lc(i: int) -> int:
    """Symbolic linear-combination variable with index i."""
    return (KIND_SYMBOLIC_LC << TAG_SHIFT) | i


def kind(v: int) -> int:
    return v >> TAG_SHIFT


def payload(v: int) -> int:
    return v & PAYLOAD_MASK


def is_zero(v: int) -> bool:
    return v == ZERO


def is_one(v: int) -> bool:
    return v == ONE


def is_instance(v: int) -> bool:
    return (v >> TAG_SHIFT) == KIND_INSTANCE


def is_witness(v: int) -> bool:
    return (v >> TAG_SHIFT) == KIND_WITNESS


def is_lc(v: int) -> bool:
    return (v >> TAG_SHIFT) == KIND_SYMBOLIC_LC


def index(v: int) -> int | None:
    """Index for instance/witness/LC variables; None for Zero/One."""
    k = v >> TAG_SHIFT
    if k in (KIND_ZERO, KIND_ONE):
        return None
    return v & PAYLOAD_MASK


def lc_index(v: int) -> int | None:
    return (v & PAYLOAD_MASK) if (v >> TAG_SHIFT) == KIND_SYMBOLIC_LC else None


def variable_index(v: int, witness_offset: int) -> int | None:
    """Global matrix-column index: One->0, Instance->i, Witness->i+offset.

    Defines the column order [1, x_1..x_{k-1}, w_0..] of constraint matrices
    (variable.rs:105-113).
    """
    k = v >> TAG_SHIFT
    if k == KIND_ONE:
        return 0
    if k == KIND_INSTANCE:
        return v & PAYLOAD_MASK
    if k == KIND_WITNESS:
        return (v & PAYLOAD_MASK) + witness_offset
    return None


def describe(v: int) -> str:
    k = v >> TAG_SHIFT
    names = {
        KIND_ZERO: "Zero",
        KIND_ONE: "One",
        KIND_INSTANCE: "Instance",
        KIND_WITNESS: "Witness",
        KIND_SYMBOLIC_LC: "SymbolicLc",
    }
    if k in (KIND_ZERO, KIND_ONE):
        return names[k]
    return f"{names.get(k, '?')}({v & PAYLOAD_MASK})"
