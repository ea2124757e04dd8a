"""Constraint provenance tracing.

The port's own copy of the JAX package's `relations/trace.py`.

The equivalent of the reference's tracing-span machinery
(relations/src/gr1cs/trace.rs + namespace.rs): a contextvar-held namespace
stack; `ConstraintTrace.capture()` snapshots it at every `enforce_*` call so
`which_is_unsatisfied` can render a backtrace-style report (trace.rs:292-329).

The reference gates capture on an installed `ConstraintLayer` subscriber with
a `TracingMode`; here `ConstraintLayer` is a context manager that enables
capture, with the same three modes.
"""

from __future__ import annotations

import contextvars
import enum
import inspect
import os
from dataclasses import dataclass


class TracingMode(enum.Enum):
    """Which spans to record (trace.rs:22-47)."""

    OnlyConstraints = "only_constraints"
    NoConstraints = "no_constraints"
    All = "all"


@dataclass(frozen=True)
class TraceStep:
    """One frame of a constraint trace (trace.rs:263-289)."""

    name: str
    module_path: str | None = None
    file: str | None = None
    line: int | None = None

    def __str__(self):
        loc = ""
        if self.file is not None:
            loc = f" at {self.file}:{self.line}"
        return f"{self.name}{loc}"


_STACK: contextvars.ContextVar[tuple[TraceStep, ...]] = contextvars.ContextVar(
    "snark_tpu_torch_ns_stack", default=()
)
_ENABLED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "snark_tpu_torch_trace_enabled", default=False
)


class ConstraintLayer:
    """Enable constraint tracing inside a `with` block (trace.rs:50-126)."""

    def __init__(self, mode: TracingMode = TracingMode.OnlyConstraints):
        self.mode = mode
        self._token = None

    def __enter__(self):
        self._token = _ENABLED.set(self.mode != TracingMode.NoConstraints)
        return self

    def __exit__(self, *exc):
        _ENABLED.reset(self._token)
        return False

    # `install()` mirrors setting a global default subscriber
    def install(self):
        _ENABLED.set(self.mode != TracingMode.NoConstraints)
        return self


def tracing_enabled() -> bool:
    return _ENABLED.get()


class Namespace:
    """Scoped name for constraint provenance — the `ns!` macro equivalent
    (namespace.rs:90-103). Usable as a context manager or leaked like the
    reference macro (which leaks the span guard for the enclosing scope)."""

    def __init__(self, cs, name: str):
        self._cs = cs
        frame = inspect.currentframe()
        caller = frame.f_back if frame is not None else None
        file = line = None
        module = None
        if caller is not None:
            file = os.path.basename(caller.f_code.co_filename)
            line = caller.f_lineno
            module = caller.f_globals.get("__name__")
        step = TraceStep(name=name, module_path=module, file=file, line=line)
        self._token = _STACK.set(_STACK.get() + (step,))

    def cs(self):
        return self._cs

    def close(self):
        if self._token is not None:
            _STACK.reset(self._token)
            self._token = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def ns(cs, name: str) -> Namespace:
    """Open a namespace span: `with ns(cs, "gadget"): ...` or leaked."""
    return Namespace(cs, name)


@dataclass(frozen=True)
class ConstraintTrace:
    """A captured namespace path (trace.rs:228-289)."""

    path: tuple[TraceStep, ...]

    @staticmethod
    def capture() -> "ConstraintTrace | None":
        if not _ENABLED.get():
            return None
        stack = _STACK.get()
        if not stack:
            return None
        return ConstraintTrace(path=stack)

    def __str__(self):
        # rendered like a panic backtrace (trace.rs:292-329)
        lines = ["Error originated in constraint:"]
        for i, step in enumerate(reversed(self.path)):
            lines.append(f"  {i}: {step}")
        return "\n".join(lines)
