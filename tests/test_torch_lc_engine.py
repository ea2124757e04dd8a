"""The port's native LC engine (`snark_tpu_torch/csrc/lc_engine.cpp`) against
its Python pass and the JAX package's engine.

The engine is host C++ built with g++ at first use into
`snark_tpu_torch/_build/lc_engine-<hash>/`. Its inline pass must equal the
port's Python pass (`ConstraintSystem.inline_all_lcs_python`) and the JAX
package's native pass on the nested systems and the symbolic-LC chain of
`tests/test_native_inline.py`. That chain's 1200 LCs hold 2,402 terms,
below the engine's 4096-term threshold, so its finalize runs the Python
pass; here the chain has 2100 LCs (4,202 terms) and `finalize` takes the
engine. A failed build raises with the compiler's output instead of
falling back to the Python pass.
"""

import os
import random

import pytest

import snark_tpu.fields.host as jax_host
import snark_tpu.fields.params as jax_params
import snark_tpu.relations as jax_rel
import snark_tpu.relations.native as jax_native
import snark_tpu_torch.fields.host as port_host
import snark_tpu_torch.fields.params as port_params
import snark_tpu_torch.relations as port_rel
import snark_tpu_torch.relations.constraint_system as port_csmod
import snark_tpu_torch.relations.native as port_native

PACKAGES = {"jax": (jax_host, jax_params, jax_rel), "port": (port_host, port_params, port_rel)}
CURVES = ("BN254", "BLS12_381")


def field(pkg, curve):
    host, params, _ = PACKAGES[pkg]
    return host.Fp(getattr(params, curve).fr)


def nested_system(pkg, curve, seed=9, n_lcs=60):
    """Later LCs reference earlier symbolic LCs (the inlining workload),
    with constraints on some of them (`tests/test_native_inline.py`)."""
    R = PACKAGES[pkg][2]
    fr = field(pkg, curve)
    rng = random.Random(seed)
    cs = R.ConstraintSystem(fr)
    w = [cs.new_witness_variable(rng.randrange(fr.p)) for _ in range(16)]
    handles = []
    for _ in range(n_lcs):
        terms = [(rng.randrange(1, fr.p), w[rng.randrange(16)]) for _ in range(rng.randrange(1, 5))]
        if handles and rng.random() < 0.6:
            for _ in range(rng.randrange(1, 3)):
                terms.append((rng.randrange(1, fr.p), handles[rng.randrange(len(handles))]))
        h = cs.new_lc(cs.lc_terms(*terms))
        handles.append(h)
        if rng.random() < 0.5:
            cs.enforce_r1cs_constraint(cs.lc(h), cs.lc(w[0]), cs.lc(w[1]))
    return cs


def chain(pkg, curve, n=2100):
    """The symbolic-LC chain of `test_native_through_finalize`, longer: each
    LC is 2·(the previous) + (i + 1)·b, and 1·last = last."""
    R = PACKAGES[pkg][2]
    cs = R.new_ref(field(pkg, curve))
    a = cs.new_input_variable(2)
    b = cs.new_witness_variable(3)
    prev = cs.new_lc(cs.lc(a, b))
    for i in range(n):
        prev = cs.new_lc(cs.lc_terms((2, prev), (i + 1, b)))
    cs.enforce_r1cs_constraint(cs.lc(R.variable.ONE), cs.lc(prev), cs.lc(prev))
    return cs


def lc_store(cs):
    inner = getattr(cs, "inner", cs)
    lm, values = inner.lc_map, inner.field_interner.values
    return list(lm.offsets), list(lm.vars), [values[c] for c in lm.coeff_ids]


def coo(cs):
    return [(a.dtype.str, a.tolist()) for m in cs.inner.to_coo_arrays("R1CS") for a in m]


@pytest.mark.parametrize("curve", CURVES)
def test_native_equals_python_and_jax(curve, monkeypatch):
    """Nested systems: the engine's pass, called directly, equals the
    Python pass and the JAX engine. The chain: finalize runs the engine
    (above the threshold) and gives the Python pass's and the JAX
    finalize's LC store, matrices and COO arrays."""
    for seed in (9, 10, 11):
        py = nested_system("port", curve, seed)
        lm = py.lc_map
        args = (lm.offsets_array(), lm.vars_array(), lm.coeff_ids_array(),
                list(py.field_interner.values))
        py.inline_all_lcs_python()
        out_off, out_vars, out_vals = port_native.get_inliner(py.field.p).inline(*args)
        got = (list(out_off), [int(v) for v in out_vars], out_vals)
        assert got == lc_store(py)
        want = jax_native.get_inliner(py.field.p).inline(*args)
        assert got == (list(want[0]), [int(v) for v in want[1]], want[2])

    ran = []
    native = port_csmod.ConstraintSystem._inline_all_lcs_native
    monkeypatch.setattr(port_csmod.ConstraintSystem, "_inline_all_lcs_native",
                        lambda self: ran.append(1) or native(self))
    cs_native, cs_python, cs_jax = chain("port", curve), chain("port", curve), chain("jax", curve)
    assert cs_native.inner.lc_map.total_lc_size() >= 4096
    cs_native.finalize()
    assert ran == [1]
    assert set(cs_native.inner.finalize_ms) == {"inline", "outline"}
    cs_python.inner.inline_all_lcs_python()
    cs_jax.finalize()
    for cs in (cs_python, cs_jax):
        assert lc_store(cs_native) == lc_store(cs)
        assert cs_native.to_matrices() == cs.to_matrices()
        assert coo(cs_native) == coo(cs)
    assert cs_native.is_satisfied()


def test_engine_builds_into_build_dir():
    """The engine is built into `_build/lc_engine-<hash>/` of the package,
    and a second build reuses the library."""
    first = port_native.build()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(port_native.__file__)))
    assert first.path == os.path.join(pkg, "_build", f"lc_engine-{port_native.source_hash()}",
                                      "lc_engine.so")
    assert os.path.isfile(first.path)
    again = port_native.build()
    assert again.path == first.path and not again.built and again.seconds == 0.0


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that is missing, or a build that fails, raises with what
    went wrong, from the engine and from a finalize above the threshold:
    nothing falls back to the Python pass."""
    monkeypatch.setattr(port_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(port_native, "_LIB", None)
    monkeypatch.setattr(port_native, "_INLINERS", {})
    monkeypatch.setattr(port_native, "CXX", str(tmp_path / "no-such-compiler"))
    p = field("port", "BN254").p
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        port_native.get_inliner(p)
    cs = chain("port", "BN254")
    with pytest.raises(RuntimeError, match="did not run"):
        cs.finalize()
    monkeypatch.setattr(port_native, "CXX", "g++")
    monkeypatch.setattr(port_native, "CXX_FLAGS",
                        [*port_native.CXX_FLAGS, "-include", str(tmp_path / "missing.h")])
    with pytest.raises(RuntimeError, match="build failed") as failed:
        port_native.get_inliner(p)
    assert "missing.h: No such file" in str(failed.value)
    assert not os.listdir(tmp_path / f"lc_engine-{port_native.source_hash()}")
