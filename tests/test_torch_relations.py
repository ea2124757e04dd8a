"""The port's relations layer and circuits against the JAX package's.

Each circuit of `models/circuits.py` (Circuit1 satisfied and not,
Circuit2, DummyCircuit, MulChain on both synthesis paths, RandomLc) and a
gadget circuit (`FpVar`) is synthesized by both packages, on both scalar
fields, in setup mode, in prove mode and in prove mode without matrices,
under each `OptimizationGoal`. What each package's constraint system then
holds must be equal: the counts, the LC store and interner, the matrices
(`to_matrices`), the COO arrays (`to_coo_arrays`, dtypes included), the
assignments, `is_satisfied` and `which_is_unsatisfied`, before and after
`finalize`. The cases are those of `tests/test_relations_golden.py`,
`test_relations_units.py`, `test_gadgets.py`, `test_trace_names.py` and
`test_config1.py`. Trace reports are compared without their `file:line`
locations, which name each package's own circuit file.
"""

import random
import re

import numpy as np
import pytest

import snark_tpu.fields.host as jax_host
import snark_tpu.fields.params as jax_params
import snark_tpu.models as jax_models
import snark_tpu.relations as jax_rel
import snark_tpu_torch.fields.host as port_host
import snark_tpu_torch.fields.params as port_params
import snark_tpu_torch.models as port_models
import snark_tpu_torch.relations as port_rel

PACKAGES = {
    "jax": (jax_host, jax_params, jax_models, jax_rel),
    "port": (port_host, port_params, port_models, port_rel),
}
CURVES = ("BN254", "BLS12_381")


def field(pkg, curve):
    host, params, _, _ = PACKAGES[pkg]
    return host.Fp(getattr(params, curve).fr)


def circuit1_sat(M):
    return M.Circuit1(x1=1, x2=2, x3=3, x4=0, x5=1255254,
                      w1=4, w2=2, w3=5, w4=29, w5=28, w6=10, w7=57, w8=22022)


def circuit1_unsat(M):
    c = circuit1_sat(M)
    c.x1 = 4
    return c


def gadget_circuit(R):
    """The gadgets of `tests/test_gadgets.py` in one circuit: add, mul,
    square, inverse, bool, select, is_zero, to_bits, enforce_equal and
    constants, with inputs and witnesses."""

    class Gadgets:
        def generate_constraints(self, cs):
            setup = cs.is_in_setup_mode()

            def val(v):
                return None if setup else v

            a = R.FpVar.new_witness(cs, val(3))
            b = R.FpVar.new_input(cs, val(15))
            (a + b).square()
            a.inverse()
            (a * a).enforce_equal(R.FpVar.constant(cs, 9))
            one = R.FpVar.new_witness(cs, val(1))
            zero = R.FpVar.new_witness(cs, val(0))
            one.enforce_bool()
            zero.enforce_bool()
            a.select(one, b)
            b.select(zero, a)
            zero.is_zero()
            a.is_zero()
            R.FpVar.new_witness(cs, val(0b101101)).to_bits(8)

    return Gadgets()


CIRCUITS = {
    "circuit1_sat": lambda M, R: circuit1_sat(M),
    "circuit1_unsat": lambda M, R: circuit1_unsat(M),
    "circuit2": lambda M, R: M.Circuit2(a=1, b=1, c=2),
    "dummy": lambda M, R: M.DummyCircuit(a=3, b=5, num_variables=16, num_constraints=12),
    "mulchain_batch": lambda M, R: M.MulChainCircuit(seed=7, n=64, batch=True),
    "mulchain_loop": lambda M, R: M.MulChainCircuit(seed=7, n=64, batch=False),
    "random_lc": lambda M, R: M.RandomLcCircuit(n=40, terms_per_lc=6, seed=2),
    "gadgets": lambda M, R: gadget_circuit(R),
}
MODES = {
    "setup": lambda R: R.SynthesisMode.setup(),
    "prove": lambda R: R.SynthesisMode.prove(),
    "prove_no_matrices": lambda R: R.SynthesisMode.prove(
        construct_matrices=False, generate_lc_assignments=False),
}
GOALS = ("Nothing", "Constraints", "Weight")
LOCATION = re.compile(r" at [^\s:]+:\d+")


def arrays(items):
    """numpy arrays -> comparable (dtype, values) pairs."""
    return [(a.dtype.str, a.tolist()) for a in items]


def state(cs):
    """Everything a constraint system holds that the setup, the prover or
    a user reads."""
    inner = cs.inner
    lm = inner.lc_map
    out = {
        "counts": (inner.num_instance_variables, inner.num_witness_variables,
                   inner.num_constraints(), inner.num_linear_combinations,
                   inner.get_all_predicates_num_constraints(),
                   inner.get_all_predicate_arities()),
        "predicates": {label: (p.arity, p.terms)
                       for label, p in inner.get_all_predicate_types().items()},
        "lc_map": (list(lm.offsets), list(lm.vars), list(lm.coeff_ids)),
        "values": list(inner.field_interner.values),
        "assignments": (list(inner.assignments.instance_assignment),
                        list(inner.assignments.witness_assignment),
                        list(inner.assignments.lc_assignment)),
    }
    if inner.should_construct_matrices():
        out["matrices"] = inner.to_matrices()
        out["coo"] = {label: [arrays(m) for m in inner.to_coo_arrays(label)]
                      for label in inner.predicate_constraint_systems}
    if not inner.is_in_setup_mode():
        out["full_assignment"] = inner.full_assignment()
        out["satisfied"] = inner.is_satisfied()
        which = inner.which_is_unsatisfied()
        out["which"] = which and LOCATION.sub("", which)
    return out


def synthesize(pkg, curve, name, mode, goal):
    """-> the state before and after finalize of one synthesis."""
    _, _, M, R = PACKAGES[pkg]
    cs = R.new_ref(field(pkg, curve))
    cs.set_optimization_goal(getattr(R.OptimizationGoal, goal))
    cs.set_mode(MODES[mode](R))
    CIRCUITS[name](M, R).generate_constraints(cs)
    before = state(cs)
    cs.finalize()
    return before, state(cs)


@pytest.mark.parametrize("mode", list(MODES))
def test_circuits_equal_jax(mode):
    """Every circuit, on both fields, under every goal: the port's
    synthesis holds what the JAX synthesis holds, before and after
    finalize. MulChain's two paths give the same system, as in the JAX
    package."""
    for curve in CURVES:
        for name in CIRCUITS:
            for goal in GOALS:
                want = synthesize("jax", curve, name, mode, goal)
                got = synthesize("port", curve, name, mode, goal)
                assert got == want, (curve, name, goal)
        batch = synthesize("port", curve, "mulchain_batch", mode, "Nothing")
        loop = synthesize("port", curve, "mulchain_loop", mode, "Nothing")
        assert batch[1].get("matrices") == loop[1].get("matrices")
        assert batch[1].get("full_assignment") == loop[1].get("full_assignment")
    if mode == "prove":
        assert not synthesize("port", "BLS12_381", "circuit1_unsat", mode, "Nothing")[1]["satisfied"]
        assert synthesize("port", "BN254", "gadgets", mode, "Nothing")[1]["satisfied"]


def traced(pkg, layer: bool):
    """The unsatisfied reports and constraint names of corrupted systems,
    with and without a ConstraintLayer: Circuit1 with x1 = 4, MulChain at
    2^10 with one corrupted witness (`tests/test_config1.py`), a gadget
    bool violation and an 8-bit decomposition of 300, and the nested
    namespaces of `tests/test_trace_names.py`."""
    _, _, M, R = PACKAGES[pkg]
    fr = field(pkg, "BN254")
    out = []

    def run():
        cs = R.new_ref(field(pkg, "BLS12_381"))
        circuit1_unsat(M).generate_constraints(cs)
        out.append((cs.which_is_unsatisfied(), cs.constraint_names()))

        cs = R.new_ref(fr)
        M.MulChainCircuit(seed=7, n=1 << 10, batch=True).generate_constraints(cs)
        cs.finalize()
        out.append(cs.is_satisfied())
        cs.into_inner().assignments.witness_assignment[1 << 9] += 1
        out.append(cs.which_is_unsatisfied())

        cs = R.new_ref(fr)
        R.FpVar.new_witness(cs, 2).enforce_bool()
        R.FpVar.new_witness(cs, 300).to_bits(8)
        out.append(cs.which_is_unsatisfied())

        cs = R.new_ref(fr)
        a = cs.new_witness_variable(2)
        b = cs.new_witness_variable(4)
        with R.ns(cs, "first-gadget"):
            cs.enforce_r1cs_constraint(cs.lc(a), cs.lc(a), cs.lc(b))
        with R.ns(cs, "outer"):
            with R.ns(cs, "inner"):
                cs.enforce_r1cs_constraint(cs.lc(a), cs.lc(a), cs.lc(b))
                cs.enforce_r1cs_constraint(cs.lc(a), cs.lc(b), cs.lc(b))
        out.append((cs.which_is_unsatisfied(), cs.constraint_names()))

    if layer:
        with R.ConstraintLayer():
            run()
    else:
        run()
    return strip_locations(out)


def strip_locations(x):
    if isinstance(x, str):
        return LOCATION.sub("", x)
    if isinstance(x, (list, tuple)):
        return type(x)(strip_locations(i) for i in x)
    return x


def test_unsatisfied_reports_and_names_equal_jax():
    """which_is_unsatisfied and constraint_names of corrupted systems
    equal the JAX package's, with tracing on and off."""
    for layer in (False, True):
        got = traced("port", layer)
        assert got == traced("jax", layer)
    assert "Predicate A constraints" in got[0][0]
    assert got[-1][1][:2] == ["first-gadget", "outer / inner"]
    assert traced("port", False)[-1][1] == ["R1CS - 0", "R1CS - 1", "R1CS - 2"]


def lc_ops(pkg, seed):
    """A random run of the LC algebra (compactify, from_terms, +, −, add_scaled,
    negation, scaling, add_term, diff_vars) -> every result's terms."""
    _, _, _, R = PACKAGES[pkg]
    V = R.variable
    fr = field(pkg, "BLS12_381")
    rng = random.Random(seed)
    pool = [V.ONE, *(V.instance(i) for i in range(1, 4)), *(V.witness(i) for i in range(6))]

    def rand_lc():
        return R.LinearCombination.from_terms(
            fr, [(rng.randrange(fr.p), rng.choice(pool)) for _ in range(rng.randrange(0, 7))])

    out = []
    for _ in range(40):
        x, y = rand_lc(), rand_lc()
        k = rng.randrange(fr.p)
        out += [(x + y).terms, (x - y).terms, x.add_scaled(k, y).terms, (-x).terms,
                (x * k).terms, (x + rng.choice(pool)).terms,
                (x + (k, rng.choice(pool))).terms,
                x.copy().add_term(k, rng.choice(pool)).terms,
                R.LinearCombination.diff_vars(fr, rng.choice(pool), rng.choice(pool)).terms]
    out.append([(V.kind(v), V.payload(v), V.index(v), V.lc_index(v), V.variable_index(v, 9),
                 V.describe(v)) for v in pool + [V.ZERO, V.symbolic_lc(5)]])
    return out


def adapted(pkg):
    """The SR1CS adapter (with and without the assignment), instance
    outlining (R1CS on Circuit1 and MulChain, SR1CS on an adapted system),
    the batch CSR enforce and the CSR handoff -> their states."""
    _, _, M, R = PACKAGES[pkg]
    fr = field(pkg, "BN254")
    out = []
    for circuit in (M.DummyCircuit(a=3, b=5, num_variables=24, num_constraints=24),
                    M.Circuit2(a=1, b=1, c=2), M.MulChainCircuit(seed=3, n=16)):
        cs = R.new_ref(fr)
        circuit.generate_constraints(cs)
        cs.finalize()
        out.append(state(R.Sr1csAdapter.r1cs_to_sr1cs_with_assignment(cs.into_inner())))
    cs = R.new_ref(fr)
    cs.set_mode(R.SynthesisMode.setup())
    M.DummyCircuit(a=None, b=None, num_variables=16, num_constraints=8).generate_constraints(cs)
    sr = R.Sr1csAdapter.r1cs_to_sr1cs(cs)
    sr.set_instance_outliner(R.sr1cs_outliner())
    sr.finalize()
    out.append(state(sr))
    for circuit in (circuit1_sat(M), M.MulChainCircuit(seed=3, n=16)):
        cs = R.new_ref(field(pkg, "BLS12_381"))
        circuit.generate_constraints(cs)
        cs.set_instance_outliner(R.r1cs_outliner())
        cs.finalize()
        out.append(state(cs))
    cs = R.ConstraintSystem(fr)
    w = cs.new_witness_variables([2, 3, 4])
    x = cs.new_input_variable(3)
    cs.enforce_constraints_batch_csr("R1CS", [
        (np.array([0, 2, 3]), np.array([w[0], w[1], x], dtype=np.uint64), cs.intern_coeffs([1, 2, 5])),
        (np.array([0, 1, 1]), np.array([w[2]], dtype=np.uint64), cs.intern_coeffs([1])),
        (np.array([0, 1, 3]), np.array([w[2], w[0], x], dtype=np.uint64),
         cs.intern_coeffs([8, 7, fr.p - 1])),
    ])
    cs.finalize()
    out.append(state(R.ConstraintSystemRef.new(cs)))
    z = cs.full_assignment()
    for mats in cs.to_csr_matrices().values():
        out.append([(arrays((m.row_ptr, m.col_idx, m.coeff_ids)), m.num_rows, m.num_cols,
                     m.mat_vec_mul_ints(None, z)) for m in mats])
    out.append(R.mat_vec_mul(R.transpose(cs.to_matrices()["R1CS"][0], cs.num_variables()),
                             [1, 2, 3], fr.p))
    return out


def test_sr1cs_outlining_and_lc_algebra_equal_jax():
    """The SR1CS adapter, instance outlining, the batch CSR paths, the
    matrix helpers, the variable tags and the LC algebra equal the JAX
    package's, value for value."""
    assert lc_ops("port", 11) == lc_ops("jax", 11)
    got = adapted("port")
    assert got == adapted("jax")
    assert all(s["satisfied"] for s in got[:3])
