"""Shared constraint-system handle + the circuit abstraction.

The port's own copy of the JAX package's `relations/constraint_system_ref.py`.

The reference wraps `ConstraintSystem` in `Rc<RefCell<..>>` with an enum
`{None, CS(..)}` (relations/src/gr1cs/constraint_system_ref.rs:26-34); the
`None` variant is the constant-only context used by gadgets. Python objects
are already shared references, so `ConstraintSystemRef` here is a thin
delegating wrapper whose only real jobs are (a) the `None` context and (b)
the trace pretty-printers (`constraint_names`, ref :528-577). The Rust
double-borrow workaround (:345-383) is unnecessary: witness closures may
freely re-enter the CS.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from ..fields.host import Fp
from .constraint_system import ConstraintSystem
from .error import MissingCS


class ConstraintSystemRef:
    """Shared handle; `ConstraintSystemRef.none()` is the constant context."""

    __slots__ = ("inner",)

    _NONE = None  # class-level singleton

    def __init__(self, inner: ConstraintSystem | None):
        self.inner = inner

    @classmethod
    def new(cls, cs: ConstraintSystem) -> "ConstraintSystemRef":
        return cls(cs)

    @classmethod
    def none(cls) -> "ConstraintSystemRef":
        if cls._NONE is None:
            cls._NONE = cls(None)
        return cls._NONE

    def is_none(self) -> bool:
        return self.inner is None

    def is_in_setup_mode(self) -> bool:
        return self.inner is not None and self.inner.is_in_setup_mode()

    def cs(self) -> "ConstraintSystemRef":
        return self

    def into_inner(self) -> ConstraintSystem | None:
        return self.inner

    def _require(self) -> ConstraintSystem:
        if self.inner is None:
            raise MissingCS("operation requires a constraint system")
        return self.inner

    def __getattr__(self, name):
        # Delegate the full ConstraintSystem API through the handle.
        inner = object.__getattribute__(self, "inner")
        if inner is None:
            raise MissingCS(f"`{name}` requires a constraint system")
        return getattr(inner, name)

    # `and` / combination semantics of the reference (set_mode etc.) are
    # delegated; equality is identity of the underlying CS.
    def __eq__(self, other):
        return isinstance(other, ConstraintSystemRef) and self.inner is other.inner

    def __hash__(self):
        return id(self.inner)

    # --- pretty-printers (constraint_system_ref.rs:528-577) -----------
    def constraint_names(self) -> list[str] | None:
        cs = self._require()
        names = []
        for label in sorted(cs.predicate_traces):
            for i, trace in enumerate(cs.predicate_traces[label]):
                if trace is None:
                    names.append(f"{label} - {i}")
                else:
                    names.append(" / ".join(s.name for s in trace.path))
        return names


def new_ref(field: Fp) -> ConstraintSystemRef:
    """`ConstraintSystem::new_ref()` equivalent (constraint_system.rs:142-144),
    parameterized by the field descriptor."""
    return ConstraintSystemRef.new(ConstraintSystem(field))


@runtime_checkable
class ConstraintSynthesizer(Protocol):
    """The circuit abstraction (relations/src/gr1cs/mod.rs:54-61): one method
    consumed for both key generation and proving."""

    def generate_constraints(self, cs: ConstraintSystemRef) -> None: ...
