"""The GR1CS constraint system: synthesis engine.

The port's own copy of the JAX package's `relations/constraint_system.py`.
Mirrors the reference `ConstraintSystem` (relations/src/gr1cs/
constraint_system.rs:44-864): variable allocation, LC registration with 3-way
canonicalization (:472-499), constraint enforcement, finalize = LC inlining +
optional instance outlining (:691-758, :826-863), satisfiability checking
(:652-687), and matrix extraction (:768-804).

Departures from the reference: columnar LcMap + FieldInterner storage, plus
*batch* synthesis APIs (`new_witness_variables`, `enforce_constraints_batch_*`)
that fill the columnar stores via NumPy without per-constraint Python
dispatch, in place of the reference's rayon-parallel synthesis path; and
`to_coo_arrays`, the matrices as the arrays the setup's QAP reads.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from ..fields.host import Fp
from . import variable as V
from .assignment import Assignments
from .error import (
    ArityMismatch,
    AssignmentMissing,
    PredicateNotFound,
    SynthesisError,
)
from .field_interner import ONE_ID, FieldInterner
from .lc_map import LcMap
from .linear_combination import LinearCombination
from .predicate import (
    R1CS_PREDICATE_LABEL,
    SR1CS_PREDICATE_LABEL,
    PredicateConstraintSystem,
)
from .trace import ConstraintTrace


@dataclass(frozen=True)
class SynthesisMode:
    """Setup vs Prove{construct_matrices, generate_lc_assignments}
    (gr1cs/mod.rs:75-90)."""

    is_setup: bool
    construct_matrices: bool = True
    generate_lc_assignments: bool = False

    @staticmethod
    def setup() -> "SynthesisMode":
        return SynthesisMode(True, True, False)

    @staticmethod
    def prove(
        construct_matrices: bool = True, generate_lc_assignments: bool = True
    ) -> "SynthesisMode":
        return SynthesisMode(False, construct_matrices, generate_lc_assignments)


class OptimizationGoal(enum.Enum):
    """gr1cs/mod.rs:96-106."""

    Nothing = "none"
    Constraints = "constraints"
    Weight = "weight"  # deprecated in the reference


class ConstraintSystem:
    """The mutable synthesis engine. One per circuit instantiation."""

    def __init__(self, field: Fp):
        self.field = field
        self.mode = SynthesisMode.prove(True, True)
        self.num_instance_variables = 1  # index 0 = ONE (constraint_system.rs:110)
        self.num_witness_variables = 0
        self.num_linear_combinations = 1  # LC 0 = zero LC (:117)
        self.optimization_goal = OptimizationGoal.Nothing
        self.instance_outliner = None
        self.finalize_ms: dict[str, float] = {}  # finalize's stage times
        self.assignments = Assignments(field)
        self.cache_map: dict = {}  # gadget memoization (cache_map, :81)
        self.lc_map = LcMap()
        self.lc_map.push(LinearCombination.zero(field), FieldInterner(field))
        self.field_interner = FieldInterner(field)
        self.predicate_constraint_systems: dict[str, PredicateConstraintSystem] = {}
        self.predicate_traces: dict[str, list[ConstraintTrace | None]] = {}
        self.register_predicate(
            R1CS_PREDICATE_LABEL, PredicateConstraintSystem.new_r1cs(field)
        )

    # ------------------------------------------------------------------
    # mode / goal
    # ------------------------------------------------------------------
    def set_mode(self, mode: SynthesisMode) -> None:
        self.mode = mode

    def is_in_setup_mode(self) -> bool:
        return self.mode.is_setup

    def should_construct_matrices(self) -> bool:
        return self.mode.is_setup or self.mode.construct_matrices

    def should_generate_lc_assignments(self) -> bool:
        return (not self.mode.is_setup) and self.mode.generate_lc_assignments

    def is_new(self) -> bool:
        return (
            self.num_instance_variables == 1
            and self.num_witness_variables == 0
            and self.num_constraints() == 0
            and self.num_linear_combinations == 1
        )

    def set_optimization_goal(self, goal: OptimizationGoal) -> None:
        assert self.is_new(), "optimization goal must be set on a fresh CS"
        self.optimization_goal = goal

    # ------------------------------------------------------------------
    # counters / accessors (the metrics API, constraint_system.rs:146-235)
    # ------------------------------------------------------------------
    def num_constraints(self) -> int:
        return sum(
            p.num_constraints for p in self.predicate_constraint_systems.values()
        )

    def num_variables(self) -> int:
        return self.num_instance_variables + self.num_witness_variables

    def num_predicates(self) -> int:
        return len(self.predicate_constraint_systems)

    def get_all_predicates_num_constraints(self) -> dict[str, int]:
        return {
            label: p.num_constraints
            for label, p in sorted(self.predicate_constraint_systems.items())
        }

    def get_predicate_num_constraints(self, label: str) -> int | None:
        p = self.predicate_constraint_systems.get(label)
        return p.num_constraints if p else None

    def get_all_predicate_arities(self) -> dict[str, int]:
        return {
            label: p.get_arity()
            for label, p in sorted(self.predicate_constraint_systems.items())
        }

    def get_predicate_arity(self, label: str) -> int | None:
        p = self.predicate_constraint_systems.get(label)
        return p.get_arity() if p else None

    def get_all_predicate_types(self) -> dict[str, object]:
        return {
            label: p.get_predicate()
            for label, p in sorted(self.predicate_constraint_systems.items())
        }

    def get_predicate_type(self, label: str):
        p = self.predicate_constraint_systems.get(label)
        return p.get_predicate() if p else None

    def instance_assignment(self) -> list[int]:
        if self.is_in_setup_mode():
            raise AssignmentMissing("no assignments in setup mode")
        return self.assignments.instance_assignment

    def witness_assignment(self) -> list[int]:
        if self.is_in_setup_mode():
            raise AssignmentMissing("no assignments in setup mode")
        return self.assignments.witness_assignment

    # ------------------------------------------------------------------
    # variable allocation (constraint_system.rs:591-617)
    # ------------------------------------------------------------------
    def new_input_variable(self, value_fn) -> int:
        index = self.num_instance_variables
        self.num_instance_variables += 1
        if not self.is_in_setup_mode():
            v = value_fn() if callable(value_fn) else value_fn
            self.assignments.instance_assignment.append(int(v) % self.field.p)
        return V.instance(index)

    def new_witness_variable(self, value_fn) -> int:
        index = self.num_witness_variables
        self.num_witness_variables += 1
        if not self.is_in_setup_mode():
            v = value_fn() if callable(value_fn) else value_fn
            self.assignments.witness_assignment.append(int(v) % self.field.p)
        return V.witness(index)

    def new_witness_variables(self, values, count: int | None = None) -> np.ndarray:
        """Batch witness allocation; values is a sequence of canonical ints
        (ignored in setup mode, where `count` sizes the batch)."""
        n = count if count is not None else len(values)
        start = self.num_witness_variables
        self.num_witness_variables += n
        if not self.is_in_setup_mode():
            wa = self.assignments.witness_assignment
            wa.extend(int(v) for v in values)
        base = np.uint64(V.KIND_WITNESS << V.TAG_SHIFT)
        return base + np.arange(start, start + n, dtype=np.uint64)

    def new_input_variables(self, values, count: int | None = None) -> np.ndarray:
        n = count if count is not None else len(values)
        start = self.num_instance_variables
        self.num_instance_variables += n
        if not self.is_in_setup_mode():
            ia = self.assignments.instance_assignment
            ia.extend(int(v) for v in values)
        base = np.uint64(V.KIND_INSTANCE << V.TAG_SHIFT)
        return base + np.arange(start, start + n, dtype=np.uint64)

    # ------------------------------------------------------------------
    # LC registration (constraint_system.rs:452-532)
    # ------------------------------------------------------------------
    def _new_lc_add(self, lc: LinearCombination) -> int:
        """3-way canonicalization (new_lc_add_helper, :472-499):
        empty -> LC0; singleton coeff-1 -> passthrough var; else intern."""
        terms = lc.terms
        if not terms or (len(terms) == 1 and terms[0][0] == V.ZERO):
            return V.symbolic_lc(0)
        if len(terms) == 1 and terms[0][1] == 1:
            return terms[0][0]
        index = self.num_linear_combinations
        self.lc_map.push(lc, self.field_interner)
        self.num_linear_combinations += 1
        if self.should_generate_lc_assignments():
            value = self.assignments.eval_lc(index, self.lc_map, self.field_interner)
            if value is None:
                raise AssignmentMissing("LC references unassigned variable")
            self.assignments.lc_assignment.append(value)
        return V.symbolic_lc(index)

    def _new_lc_without_adding(self) -> int:
        index = self.num_linear_combinations
        self.num_linear_combinations += 1
        return V.symbolic_lc(index)

    def new_lc(self, lc_fn) -> int:
        should_push = (
            self.should_construct_matrices() or self.should_generate_lc_assignments()
        )
        if should_push:
            lc = lc_fn() if callable(lc_fn) else lc_fn
            return self._new_lc_add(lc)
        return self._new_lc_without_adding()

    # --- lc! macro ergonomics ----------------------------------------
    def lc(self, *variables) -> LinearCombination:
        """lc![v1, v2, ...] — sum of variables (or empty)."""
        if not variables:
            return LinearCombination.zero(self.field)
        return LinearCombination.sum_vars(self.field, variables)

    def lc_terms(self, *coeff_vars) -> LinearCombination:
        """lc![(c1, v1), ...]."""
        return LinearCombination.from_terms(self.field, coeff_vars)

    def lc_diff(self, a: int, b: int) -> LinearCombination:
        return LinearCombination.diff_vars(self.field, a, b)

    # ------------------------------------------------------------------
    # predicate registry (constraint_system.rs:620-642)
    # ------------------------------------------------------------------
    def register_predicate(self, label: str, pcs: PredicateConstraintSystem) -> None:
        self.predicate_constraint_systems[label] = pcs
        self.predicate_traces[label] = []

    def remove_predicate(self, label: str) -> None:
        self.predicate_constraint_systems.pop(label, None)

    def has_predicate(self, label: str) -> bool:
        return label in self.predicate_constraint_systems

    # ------------------------------------------------------------------
    # constraint enforcement (constraint_system.rs:241-450)
    # ------------------------------------------------------------------
    def enforce_constraint(self, predicate_label: str, lcs) -> None:
        """Generic arity: `lcs` is an iterable of LCs or 0-arg callables."""
        if not self.has_predicate(predicate_label):
            raise PredicateNotFound(predicate_label)
        if self.should_construct_matrices():
            lc_vars = [
                self._new_lc_add(lc() if callable(lc) else lc) for lc in lcs
            ]
            self.predicate_constraint_systems[predicate_label].enforce_constraint(
                lc_vars
            )
        traces = self.predicate_traces.get(predicate_label)
        if traces is not None:
            traces.append(ConstraintTrace.capture())

    def enforce_r1cs_constraint(self, a, b, c) -> None:
        self.enforce_constraint(R1CS_PREDICATE_LABEL, (a, b, c))

    def enforce_sr1cs_constraint(self, a, b) -> None:
        self.enforce_constraint(SR1CS_PREDICATE_LABEL, (a, b))

    # arity-N sugar for parity with the reference fast paths (:292-425)
    def enforce_constraint_arity_2(self, label, a, b):
        self.enforce_constraint(label, (a, b))

    def enforce_constraint_arity_3(self, label, a, b, c):
        self.enforce_constraint(label, (a, b, c))

    def enforce_constraint_arity_4(self, label, a, b, c, d):
        self.enforce_constraint(label, (a, b, c, d))

    def enforce_constraint_arity_5(self, label, a, b, c, d, e):
        self.enforce_constraint(label, (a, b, c, d, e))

    # --- batch paths -------------------------------------------------
    def enforce_constraints_batch_vars(self, predicate_label: str, columns) -> None:
        """Batch enforce where every argument LC is a bare variable.

        `columns` is a list (len = arity) of equal-length variable arrays.
        No LcMap traffic: bare variables are exactly the passthrough case of
        LC canonicalization.
        """
        if not self.has_predicate(predicate_label):
            raise PredicateNotFound(predicate_label)
        if self.should_construct_matrices():
            cols = [
                c.tolist() if isinstance(c, np.ndarray) else list(c) for c in columns
            ]
            self.predicate_constraint_systems[
                predicate_label
            ].enforce_constraints_batch(cols)
        else:
            # Pinned semantics (mirrors the per-constraint enforce_constraint
            # path and the reference's Prove{construct_matrices: false} mode,
            # constraint_system.rs:241-289): when matrices are not
            # constructed, predicate storage is untouched and num_constraints
            # does NOT advance. Counting callers must synthesize in a
            # matrix-constructing mode. Tested by
            # test_relations_units.test_batch_enforce_no_matrices_counting.
            pass
        traces = self.predicate_traces.get(predicate_label)
        if traces is not None:
            n = len(columns[0])
            tr = ConstraintTrace.capture()
            traces.extend([tr] * n)

    def enforce_r1cs_constraints_batch_vars(self, a_vars, b_vars, c_vars) -> None:
        self.enforce_constraints_batch_vars(
            R1CS_PREDICATE_LABEL, [a_vars, b_vars, c_vars]
        )

    def enforce_constraints_batch_csr(
        self, predicate_label: str, columns_csr
    ) -> None:
        """Batch enforce with general LCs in CSR form.

        Each element of `columns_csr` is `(indptr, vars, coeff_ids)`:
        `indptr` (n+1,) int64, `vars` uint64 variable handles, `coeff_ids`
        int32 ids from `self.intern_coeffs`. Canonicalization (empty -> LC0,
        singleton coeff-1 -> passthrough) is applied vectorized.
        """
        if not self.has_predicate(predicate_label):
            raise PredicateNotFound(predicate_label)
        if not self.should_construct_matrices():
            return
        arg_var_cols = []
        for indptr, vars_, coeff_ids in columns_csr:
            arg_var_cols.append(self._push_lcs_csr(indptr, vars_, coeff_ids))
        self.predicate_constraint_systems[predicate_label].enforce_constraints_batch(
            [col.tolist() for col in arg_var_cols]
        )
        traces = self.predicate_traces.get(predicate_label)
        if traces is not None:
            n = len(arg_var_cols[0])
            tr = ConstraintTrace.capture()
            traces.extend([tr] * n)

    def _push_lcs_csr(self, indptr, vars_, coeff_ids) -> np.ndarray:
        """Vectorized LC canonicalization + columnar append. Returns the
        resulting argument variable per row (LC handle or passthrough)."""
        indptr = np.asarray(indptr, dtype=np.int64)
        vars_ = np.asarray(vars_, dtype=np.uint64)
        coeff_ids = np.asarray(coeff_ids, dtype=np.int32)
        n = len(indptr) - 1
        lens = np.diff(indptr)
        first = np.where(lens > 0, indptr[: n], 0)
        first_var = np.where(lens > 0, vars_[np.minimum(first, max(len(vars_) - 1, 0))], 0)
        first_cid = np.where(lens > 0, coeff_ids[np.minimum(first, max(len(coeff_ids) - 1, 0))], 0)
        is_empty = (lens == 0) | (
            (lens == 1) & (first_var == np.uint64(V.ZERO))
        )
        is_passthrough = (lens == 1) & (first_cid == ONE_ID) & ~is_empty
        needs_push = ~(is_empty | is_passthrough)

        out = np.empty(n, dtype=np.uint64)
        out[is_empty] = np.uint64(V.symbolic_lc(0))
        out[is_passthrough] = first_var[is_passthrough]

        push_rows = np.nonzero(needs_push)[0]
        if len(push_rows):
            start_idx = self.num_linear_combinations
            out[push_rows] = np.uint64(V.KIND_SYMBOLIC_LC << V.TAG_SHIFT) + np.arange(
                start_idx, start_idx + len(push_rows), dtype=np.uint64
            )
            # columnar append (vectorized): gather the pushed rows' terms
            # range-mask via +1/-1 boundary markers + prefix sum (no
            # per-row Python loop — measurable at 2^23 rows)
            marks = np.zeros(len(vars_) + 1, dtype=np.int64)
            np.add.at(marks, indptr[push_rows], 1)
            np.add.at(marks, indptr[push_rows + 1], -1)
            sel = np.cumsum(marks[:-1]) > 0
            self.lc_map.vars.extend(int(x) for x in vars_[sel])
            self.lc_map.coeff_ids.extend(int(x) for x in coeff_ids[sel])
            base = self.lc_map.offsets[-1]
            new_offsets = base + np.cumsum(lens[push_rows])
            self.lc_map.offsets.extend(int(x) for x in new_offsets)
            self.num_linear_combinations += len(push_rows)
            if self.should_generate_lc_assignments():
                for i in range(start_idx, self.num_linear_combinations):
                    value = self.assignments.eval_lc(
                        i, self.lc_map, self.field_interner
                    )
                    if value is None:
                        raise AssignmentMissing("LC references unassigned variable")
                    self.assignments.lc_assignment.append(value)
        return out

    def intern_coeffs(self, values) -> np.ndarray:
        """Intern a sequence of canonical coefficient ints -> int32 id array."""
        intern = self.field_interner.get_or_intern
        return np.fromiter(
            (intern(int(v)) for v in values), dtype=np.int32, count=len(values)
        )

    # ------------------------------------------------------------------
    # values / satisfiability (constraint_system.rs:644-687)
    # ------------------------------------------------------------------
    def assigned_value(self, v: int) -> int | None:
        return self.assignments.assigned_value(v)

    def eval_lc_of_variable(self, v: int) -> int:
        """Fallback evaluation of an un-cached symbolic LC (predicate/mod.rs:
        192-197); raises if a referenced variable is unassigned."""
        lc = self.get_lc(v)
        p = self.field.p
        acc = 0
        for coeff, var in lc:
            av = self.assignments.assigned_value(var)
            if av is None:
                raise AssignmentMissing(
                    f"Variable {V.describe(var)} is not assigned; "
                    "did you run cs.finalize()?"
                )
            acc += coeff * av
        return acc % p

    def is_satisfied(self) -> bool:
        return self.which_is_unsatisfied() is None

    def which_is_unsatisfied(self) -> str | None:
        if self.is_in_setup_mode():
            raise AssignmentMissing("cannot check satisfaction in setup mode")
        for label in sorted(self.predicate_constraint_systems):  # BTreeMap order
            pcs = self.predicate_constraint_systems[label]
            idx = pcs.which_constraint_is_unsatisfied(self)
            if idx is not None:
                traces = self.predicate_traces.get(label, [])
                trace = traces[idx] if idx < len(traces) else None
                if trace is not None:
                    return str(trace)
                return f"{label} - {idx}"
        return None

    # ------------------------------------------------------------------
    # finalize: inline + outline (constraint_system.rs:691-758, 826-863)
    # ------------------------------------------------------------------
    def finalize(self) -> None:
        """Inline the symbolic LCs, then outline the instance; the wall time
        of each, in milliseconds, is kept in `finalize_ms`."""
        from ..utils.timing import timed

        with timed("Inline LCs") as t_inline:
            self.inline_all_lcs()
        with timed("Instance Outlining") as t_outline:
            outliner = self.instance_outliner
            if outliner is not None:
                self.instance_outliner = None
                if self.has_predicate(outliner.pred_label):
                    self.perform_instance_outlining(outliner)
        self.finalize_ms = {"inline": t_inline.elapsed * 1e3,
                            "outline": t_outline.elapsed * 1e3}

    def set_instance_outliner(self, outliner) -> None:
        self.instance_outliner = outliner

    def should_outline_instances(self) -> bool:
        return self.instance_outliner is not None

    def any_lcs_used(self) -> bool:
        """Does any LC row reference a symbolic LC? Vectorized scan."""
        if not self.lc_map.vars:
            return False
        arr = self.lc_map.vars_array()
        return bool(
            ((arr >> np.uint64(V.TAG_SHIFT)) == V.KIND_SYMBOLIC_LC).any()
        )

    def inline_all_lcs(self) -> None:
        """Single ordered pass substituting symbolic-LC refs with their
        already-inlined rows (constraint_system.rs:717-758).

        Systems of 4096 or more LC terms over a field of at most 256 bits
        run the native C++ engine (relations/native.py, the counterpart of
        the rayon-parallel Rust pass); a failed build of the engine raises.
        Smaller systems run the Python pass, `inline_all_lcs_python`.
        """
        if not self.should_construct_matrices():
            return
        if not self.any_lcs_used():
            return
        if self.lc_map.total_lc_size() >= 4096 and self.field.p.bit_length() <= 256:
            self._inline_all_lcs_native()
            return
        self.inline_all_lcs_python()

    def inline_all_lcs_python(self) -> None:
        """The inline pass in Python: the plain version of the native
        engine's, which it must equal."""
        old = self.lc_map
        interner = self.field_interner
        values = interner.values
        new_map = LcMap()
        mulmod = self.field.mul

        lc_tag = V.KIND_SYMBOLIC_LC
        shift = V.TAG_SHIFT
        for vars_, cids in old.iter_lcs():
            out: list[tuple[int, int]] = []  # (var, coeff value)
            for var, cid in zip(vars_, cids):
                if (var >> shift) == lc_tag:
                    idx = var & V.PAYLOAD_MASK
                    ivars, icids = new_map.get(idx)
                    coeff = values[cid]
                    if coeff == 1:
                        out.extend((iv, values[ic]) for iv, ic in zip(ivars, icids))
                    else:
                        out.extend(
                            (iv, mulmod(coeff, values[ic]))
                            for iv, ic in zip(ivars, icids)
                            if iv != V.ZERO and values[ic] != 0
                        )
                else:
                    out.append((var, values[cid]))
            lc = LinearCombination(self.field, out)
            lc.compactify()
            new_map.push(lc, interner)
        self.lc_map = new_map

    def _inline_all_lcs_native(self) -> None:
        """The native engine's inline pass (it raises if the engine cannot
        be built)."""
        from .native import get_inliner

        inliner = get_inliner(self.field.p)
        lm = self.lc_map
        out_off, out_vars, out_values = inliner.inline(
            lm.offsets_array(),
            lm.vars_array(),
            lm.coeff_ids_array(),
            self.field_interner.values,
        )
        new_map = LcMap()
        intern = self.field_interner.get_or_intern
        new_map.vars = [int(v) for v in out_vars]
        new_map.coeff_ids = [intern(v) for v in out_values]
        new_map.offsets = [int(o) for o in out_off]
        self.lc_map = new_map

    def perform_instance_outlining(self, outliner) -> None:
        """Replace instance vars with fresh witnesses everywhere, then let the
        outliner add binding constraints (constraint_system.rs:826-863)."""
        instance_to_witness: list[int] = []
        one_witness = self.new_witness_variable(lambda: 1)
        instance_to_witness.append(one_witness)
        inst_assign = list(self.assignments.instance_assignment)
        for i in range(1, self.num_instance_variables):
            if self.is_in_setup_mode():
                w = self.new_witness_variable(None)
            else:
                if i >= len(inst_assign):
                    raise AssignmentMissing(f"instance {i} unassigned")
                w = self.new_witness_variable(inst_assign[i])
            instance_to_witness.append(w)

        # vectorized rewrite of every variable in the LC store
        arr = self.lc_map.vars_array()
        kinds = arr >> np.uint64(V.TAG_SHIFT)
        payloads = arr & np.uint64(V.PAYLOAD_MASK)
        lut = np.array(instance_to_witness, dtype=np.uint64)
        is_inst = kinds == V.KIND_INSTANCE
        is_one = kinds == V.KIND_ONE
        arr = np.where(is_inst, lut[np.where(is_inst, payloads, 0)], arr)
        arr = np.where(is_one, np.uint64(one_witness), arr)
        self.lc_map.set_vars_from_array(arr)

        outliner.func(self, instance_to_witness)

    # ------------------------------------------------------------------
    # matrix extraction (constraint_system.rs:768-804)
    # ------------------------------------------------------------------
    def get_lc(self, var: int) -> LinearCombination:
        if var == V.ZERO:
            return LinearCombination.zero(self.field)
        if (var >> V.TAG_SHIFT) == V.KIND_SYMBOLIC_LC:
            idx = var & V.PAYLOAD_MASK
            vars_, cids = self.lc_map.get(idx)
            values = self.field_interner.values
            return LinearCombination(
                self.field, [(v, values[c]) for v, c in zip(vars_, cids)]
            )
        return LinearCombination(self.field, [(var, 1)])

    def make_row(self, lc: LinearCombination) -> list[tuple[int, int]]:
        num_input = self.num_instance_variables
        row = []
        for var, coeff in lc.terms:
            if coeff == 0 or var == V.ZERO:
                continue
            col = V.variable_index(var, num_input)
            row.append((coeff, col))
        return row

    def to_matrices(self) -> dict[str, list]:
        return {
            label: pcs.to_matrices(self)
            for label, pcs in sorted(self.predicate_constraint_systems.items())
        }

    # --- device handoff ------------------------------------------------
    def to_coo_arrays(self, predicate_label: str) -> list:
        """Vectorized CSR extraction for one predicate: one
        (indptr, col_idx, coeff_id) triple per predicate argument,
        straight from the LcMap's columnar arrays — no per-entry Python
        (the 2^24 setup path; to_matrices costs ~µs/entry).

        Semantics match to_matrices()/make_row (same rows, same entry
        order, same column mapping variable_index) EXCEPT that
        zero-variable entries are kept with coefficient id
        ``len(field_interner)`` (a literal zero the consumer appends to
        its value table) instead of being dropped — harmless for every
        matrix consumer (0-valued terms)."""
        pcs = self.predicate_constraint_systems[predicate_label]
        lcm = self.lc_map
        vars_a = lcm.vars_array().astype(np.uint64)
        ids_a = lcm.coeff_ids_array().astype(np.int64)
        offs = lcm.offsets_array()
        ni = self.num_instance_variables
        zid = len(self.field_interner.values)
        mask_payload = np.uint64(V.PAYLOAD_MASK)
        out = []
        for col_list in pcs.argument_lcs:
            av = np.asarray(col_list, dtype=np.uint64)
            tag = (av >> np.uint64(V.TAG_SHIFT)).astype(np.int64)
            pay = (av & mask_payload).astype(np.int64)
            is_lc = tag == V.KIND_SYMBOLIC_LC
            lc_idx = np.where(is_lc, pay, 0)
            lens = np.where(
                is_lc,
                offs[lc_idx + 1] - offs[lc_idx],
                np.where(tag == V.KIND_ZERO, 0, 1),
            )
            indptr = np.zeros(len(av) + 1, np.int64)
            np.cumsum(lens, out=indptr[1:])
            nnz = int(indptr[-1])
            row_of = np.repeat(np.arange(len(av)), lens)
            inner = np.arange(nnz, dtype=np.int64) - np.repeat(
                indptr[:-1], lens
            )
            starts = np.where(is_lc, offs[lc_idx], 0)
            if len(vars_a):
                src = np.minimum(starts[row_of] + inner, len(vars_a) - 1)
                packed = np.where(is_lc[row_of], vars_a[src], av[row_of])
                cid = np.where(is_lc[row_of], ids_a[src], 0)
            else:
                packed = av[row_of]
                cid = np.zeros(nnz, np.int64)
            t2 = (packed >> np.uint64(V.TAG_SHIFT)).astype(np.int64)
            p2 = (packed & mask_payload).astype(np.int64)
            col = np.where(
                t2 == V.KIND_ONE,
                0,
                np.where(t2 == V.KIND_INSTANCE, p2, p2 + ni),
            )
            cid = np.where(t2 == V.KIND_ZERO, zid, cid)
            col = np.where(t2 == V.KIND_ZERO, 0, col)
            out.append(
                (indptr, col.astype(np.int32), cid.astype(np.int32))
            )
        return out

    def to_csr_matrices(self) -> dict[str, list]:
        """CSR (row_ptr/col_idx/coeff_id) matrices per predicate argument,
        sharing this CS's interner — the device-ready form."""
        from .matrix import CsrMatrix

        out = {}
        ncols = self.num_variables()
        for label, pcs in sorted(self.predicate_constraint_systems.items()):
            mats = []
            for rows in pcs.to_matrices(self):
                mats.append(
                    CsrMatrix.from_rows(rows, ncols, self.field, self.field_interner)
                )
            out[label] = mats
        return out

    def full_assignment(self) -> list[int]:
        """z = [instance ‖ witness] (the global column order)."""
        return (
            list(self.assignments.instance_assignment)
            + list(self.assignments.witness_assignment)
        )
