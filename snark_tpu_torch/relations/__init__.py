"""GR1CS constraint-system infrastructure (the ark-relations surface).

The port's own copy of the JAX package's `relations/__init__.py`.

Layer L4-L2 of SURVEY.md §1: circuit-authoring API (`ConstraintSynthesizer`,
`ConstraintSystemRef`, namespaces), the synthesis engine (`ConstraintSystem`,
`SynthesisMode`, `OptimizationGoal`, predicates, instance outlining, the
SR1CS adapter) and the columnar data-structure layer (`LcMap`,
`FieldInterner`, `LinearCombination`, variables, sparse matrices).
"""

from . import variable
from .assignment import Assignments
from .constraint_system import (
    ConstraintSystem,
    OptimizationGoal,
    SynthesisMode,
)
from .constraint_system_ref import (
    ConstraintSynthesizer,
    ConstraintSystemRef,
    new_ref,
)
from .error import (
    ArityMismatch,
    AssignmentMissing,
    DivisionByZero,
    MissingCS,
    PolynomialDegreeTooLarge,
    PredicateNotFound,
    SynthesisError,
    Unsatisfiable,
)
from .field_interner import FieldInterner
from .gadgets import FpVar
from .instance_outliner import (
    InstanceOutliner,
    outline_r1cs,
    outline_sr1cs,
    r1cs_outliner,
    sr1cs_outliner,
)
from .lc_map import LcMap
from .linear_combination import LinearCombination
from .matrix import CsrMatrix, Matrix, mat_vec_mul, transpose
from .predicate import (
    R1CS_PREDICATE_LABEL,
    SR1CS_PREDICATE_LABEL,
    PolynomialPredicate,
    Predicate,
    PredicateConstraintSystem,
    new_r1cs_predicate,
    new_sr1cs_predicate,
)
from .sr1cs import Sr1csAdapter, evaluate_constraint
from .trace import (
    ConstraintLayer,
    ConstraintTrace,
    Namespace,
    TraceStep,
    TracingMode,
    ns,
)

__all__ = [
    "Assignments",
    "ArityMismatch",
    "AssignmentMissing",
    "ConstraintLayer",
    "ConstraintSynthesizer",
    "ConstraintSystem",
    "ConstraintSystemRef",
    "ConstraintTrace",
    "CsrMatrix",
    "DivisionByZero",
    "FieldInterner",
    "FpVar",
    "InstanceOutliner",
    "LcMap",
    "LinearCombination",
    "Matrix",
    "MissingCS",
    "Namespace",
    "OptimizationGoal",
    "PolynomialDegreeTooLarge",
    "PolynomialPredicate",
    "Predicate",
    "PredicateConstraintSystem",
    "PredicateNotFound",
    "R1CS_PREDICATE_LABEL",
    "SR1CS_PREDICATE_LABEL",
    "Sr1csAdapter",
    "SynthesisError",
    "SynthesisMode",
    "TraceStep",
    "TracingMode",
    "Unsatisfiable",
    "evaluate_constraint",
    "mat_vec_mul",
    "new_r1cs_predicate",
    "new_ref",
    "new_sr1cs_predicate",
    "ns",
    "outline_r1cs",
    "outline_sr1cs",
    "r1cs_outliner",
    "sr1cs_outliner",
    "transpose",
    "variable",
]
