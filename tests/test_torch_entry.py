"""The port's single-device entry point (`snark_tpu_torch/entry.py`) against
the reference's `__graft_entry__.entry`.

The reference's `fn(*args)` is its jitted batched core of five plane MSMs
on JAX-CPU, and even its key, `_small_pk()`, is a JAX setup that compiles
for about a minute with an empty JAX cache. So the oracle here is the
reference's key itself, derived on the host from its seed: the JAX
package's setup-mode synthesis of MulChain(seed=5, n=8, batch=False), the
toxic waste α, β, γ, δ, τ drawn from `random.Random(0)` in the order its
`circuit_specific_setup` draws them, u, v, w at τ by its host QAP
(`snark_tpu/groth16/qap.py` `evaluate_variable_polys_at_tau`), and the
witness from its prove-mode synthesis. Each query point is a multiple of
a generator, so each of the five sums is one too: A = (Σ z_i·u_i(τ))·G1,
B = (Σ z_i·v_i(τ))·G2, B1 = (Σ z_i·v_i(τ))·G1, L = (Σ_{i ≥ ni}
z_i·(β·u_i + α·v_i + w_i)(τ)/δ)·G1 and H = h(τ)·Z(τ)/δ·G1 =
(a(τ)·b(τ) − c(τ))/δ·G1, by the reference's host curve. The port's core
runs on the CPU (the kernels' plain versions); its sums are compared as
affine points. Exact.
"""

import random

import pytest
import torch

from snark_tpu.fields.host import Fp as RefFp
from snark_tpu.fields.params import BN254 as REF_BN254
from snark_tpu.groth16.qap import evaluate_variable_polys_at_tau
from snark_tpu.models import MulChainCircuit as RefMulChain
from snark_tpu.ops.curve_host import host_g1, host_g2
from snark_tpu.relations import OptimizationGoal, SynthesisMode, new_ref
from snark_tpu.relations.predicate import R1CS_PREDICATE_LABEL
from snark_tpu_torch.entry import entry, sums


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads: the suite runs files side by side on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def reference_sums() -> tuple[dict, list[int]]:
    """The five sums of the reference's `_small_pk()` key and witness, on
    the host; and the witness."""
    fr = RefFp(REF_BN254.fr)
    p = fr.p
    circuit = RefMulChain(seed=5, n=8, batch=False)
    cs = new_ref(fr)
    cs.set_optimization_goal(OptimizationGoal.Constraints)
    cs.set_mode(SynthesisMode.setup())
    circuit.generate_constraints(cs)
    cs.finalize()
    nc, ni = cs.num_constraints(), cs.num_instance_variables
    m = ni + cs.num_witness_variables
    rng = random.Random(0)
    alpha, beta, gamma, delta, tau = (fr.rand(rng) for _ in range(5))
    u, v, w, _ = evaluate_variable_polys_at_tau(
        REF_BN254.fr, cs.to_matrices()[R1CS_PREDICATE_LABEL], nc, ni, m, tau)
    wcs = new_ref(fr)
    wcs.set_mode(SynthesisMode.prove(construct_matrices=False, generate_lc_assignments=False))
    circuit.generate_constraints(wcs)
    z = wcs.full_assignment()
    dot = lambda xs, lo=0: sum(zi * x for zi, x in zip(z[lo:], xs[lo:])) % p  # noqa: E731
    a, b, c = dot(u), dot(v), dot(w)
    d_inv = pow(delta, -1, p)
    lw = [(beta * ui + alpha * vi + wi) * d_inv % p for ui, vi, wi in zip(u, v, w)]
    g1, g2 = host_g1(REF_BN254), host_g2(REF_BN254)
    scalars = {"A": a, "B1": b, "L": dot(lw, ni), "H": (a * b - c) * d_inv % p}
    out = {k: g1.scalar_mul(g1.generator, s) for k, s in scalars.items()}
    out["B"] = g2.scalar_mul(g2.generator, b)
    return out, z


def test_entry_core_equals_reference_key_sums():
    """entry("cpu"): fn is the prover's device core, args a batch of the
    reference's witness; its five sums equal the reference key's."""
    want, z = reference_sums()
    fn, args = entry("cpu")
    assert fn.__name__ == "core" and len(args) == 1 and args[0] == [z]
    g1, g2 = fn(*args)
    assert g1.shape == (1, 4, 3, 1, 8) and g2.shape == (1, 3, 2, 8)
    assert g1.device.type == "cpu" and g1.dtype == torch.int32
    got = sums(g1, g2)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name


def test_entry_defaults_to_the_card():
    """Without a device the entry takes the card, and without a card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: tests/test_torch_gpu.py runs the entry there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
