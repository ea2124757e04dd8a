"""The reference's small-circuit prove (`snark_tpu/groth16/groth16.py`
`_prove_from_assignment` below SNARK_TPU_PLANE_MSM_MIN = 2048 variables,
`:777-779`, `:820-834`) composed from the port's legacy API: h from
`WitnessMapPlan`, the five MSMs by `msm_host_combine` over the key's
legacy query arrays; on the CPU, the plain versions of K2, K3 and K4. The
port's `Groth16.prove` takes the plane path at every size; the legacy
composition must give the same five sums, the same h and so the same
proof.

Oracles: the committed vectors, written by the JAX package
(`tests/vectors/proof_bn254.json`, MulChain(11, 8), m = 18; the BLS12-381
MulChain(7, 12) key and proof, m = 26), bit for bit, and the plane
prove's `ProveRun` of the same key, witness and (r, s). Tolerance: none.
"""

import dataclasses
import json
import os
import random
import subprocess
import sys

import pytest
import torch

from snark_tpu_torch.fields.device import limbs16_encode
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.groth16 import Groth16, ProvingKey, WitnessMapPlan, assemble_proof
from snark_tpu_torch.groth16.groth16 import synthesize_witness
from snark_tpu_torch.models import MulChainCircuit
from snark_tpu_torch.ops import get_g1_ops, get_g2_ops, pick_window, scalars_to_digits
from snark_tpu_torch.ops.msm_u32 import msm_host_combine
from snark_tpu_torch.ops.ntt import bit_reverse_indices, from_mont
from snark_tpu_torch.snark import serialize as ser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(ROOT, "tests", "vectors")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def legacy_sums(g16: Groth16, pk: ProvingKey, z: list[int]):
    """The reference's small-circuit prove on the legacy API -> (the five
    MSM sums as host affine points, h in canonical standard form,
    bit-reversed, in the kernels' words: `ProveRun.sums` and `h_std`).
    z in Montgomery form in the active layout; the three matvecs and h from
    `WitnessMapPlan`; unsigned digits of z at c = pick_window(m) and of h
    at the largest power of two at most pick_window(max(4, n − 1)); then
    `msm_host_combine` of A, B (G2), B1 and L over the key's query arrays
    and of H over its h query. `chip_smoke.py` runs it on the card."""
    curve, dev = g16.curve, g16.device
    fr = curve.fr
    n, ni, nc = pk.domain_size, pk.num_instance, pk.num_constraints
    plan = WitnessMapPlan(fr, n, dev)
    df = plan.df
    z_mont = df.array(z)
    rows = [plan.matvec(mat, z_mont) for mat in (pk.mat_a, pk.mat_b, pk.mat_c)]
    zeros = torch.zeros((n - nc, z_mont.shape[1]), dtype=z_mont.dtype, device=dev)
    a = torch.cat([rows[0], z_mont[:ni], zeros[ni:]])
    b, c = (torch.cat([r, zeros]) for r in rows[1:])
    h_words = from_mont(df.to_words(plan.h_from_evals(a, b, c)).contiguous(), g16.fr)
    c_z = pick_window(len(z))
    z_digits = scalars_to_digits(limbs16_encode([v % fr.modulus for v in z], fr), c_z,
                                 fr.num_bits)
    c_h = 1 << (pick_window(max(4, n - 1)).bit_length() - 1)
    h_digits = df.window_digits(df.from_words(h_words[: n - 1]), c_h, fr.num_bits)
    g1, g2 = get_g1_ops(curve, dev), get_g2_ops(curve, dev)
    terms = [("A", g1, "a_query", z_digits, c_z), ("B", g2, "b_g2_query", z_digits, c_z),
             ("B1", g1, "b_g1_query", z_digits, c_z), ("L", g1, "l_query", z_digits[ni:], c_z),
             ("H", g1, "h_query", h_digits, c_h)]
    sums = {name: msm_host_combine(ops, g16.hg2 if ops is g2 else g16.hg1, pk.query(query),
                                   digits, cw)
            for name, ops, query, digits, cw in terms}
    rev = torch.as_tensor(bit_reverse_indices(n), device=dev)
    return sums, h_words[rev]


def check_legacy_proof(g16: Groth16, pk: ProvingKey, circuit, want: dict, curve):
    """The legacy composition's sums and h equal the plane prove's; the
    proof assembled from them is `want`'s bytes and equals the plane
    prove's proof, which it returns."""
    r, s = int(want["r"]), int(want["s"])
    sums, h = legacy_sums(g16, pk, synthesize_witness(circuit, curve))
    proof = assemble_proof(g16, pk, sums["A"], sums["B"], sums["B1"], sums["L"], sums["H"], r, s)
    assert ser.serialize_proof(proof, curve).hex() == want["proof_bytes_hex"]
    assert g16.prove(pk, circuit, r=r, s=s) == proof
    assert g16.last_run.sums == sums and torch.equal(g16.last_run.h_std, h)
    return proof


@pytest.fixture(scope="module")
def vector_key():
    """The port's setup of the vector's circuit from its seed (the key the
    vector's proof was made with; `tests/test_torch_synthesis.py` holds its
    vk bytes)."""
    with open(os.path.join(VECTORS, "proof_bn254.json")) as f:
        vector = json.load(f)
    g16 = Groth16(BN254, device="cpu")
    pk, vk = g16.circuit_specific_setup(MulChainCircuit(seed=11, n=8, batch=False),
                                        random.Random(int(vector["setup_seed"])))
    return g16, pk, vk, vector


def test_vector_proof_from_legacy_api(vector_key):
    """The vector's circuit (m = 18): the legacy composition gives the
    vector's bytes, the plane prove's sums and h; the proof verifies."""
    g16, pk, vk, vector = vector_key
    proof = check_legacy_proof(g16, pk, MulChainCircuit(seed=11, n=8), vector, BN254)
    assert g16.verify(vk, [11], proof)


def test_key_without_query_arrays_raises(vector_key):
    """The legacy MSMs read the key's legacy query arrays: on a key made
    without them (want_query=False, or the reference's
    SNARK_TPU_SETUP_QUERY=0) they raise, as `ProvingKey.query` does; the
    plane prove reads only the row tables and proves the same proof."""
    g16, pk, _, _ = vector_key
    bare = dataclasses.replace(pk, queries={}, file_queries=frozenset())
    z = synthesize_witness(MulChainCircuit(seed=11, n=8), BN254)
    with pytest.raises(ValueError, match="query arrays"):
        legacy_sums(g16, bare, z)
    circuit = MulChainCircuit(seed=11, n=8)
    assert g16.prove(bare, circuit, r=1, s=2) == g16.prove(pk, circuit, r=1, s=2)


def test_bls12_381_fixture_from_legacy_api():
    """The committed BLS12-381 key (m = 26, its query arrays written by the
    JAX package): the legacy composition gives the committed JAX proof and
    the plane prove's sums and h; the proof verifies."""
    with open(os.path.join(VECTORS, "torch_proof_bls12_381_mulchain12.json")) as f:
        want = json.load(f)
    pk = ProvingKey.load(os.path.join(VECTORS, "torch_pk_bls12_381_mulchain12.npz"), "cpu")
    g16 = Groth16(BLS12_381, device="cpu")
    proof = check_legacy_proof(g16, pk, MulChainCircuit(seed=7, n=12), want, BLS12_381)
    assert g16.verify(pk.vk, want["public_input"], proof)


F32_SCRIPT = r"""
import json, os, random, sys
import torch
sys.path.insert(0, "tests")
torch.set_num_threads(2)
from snark_tpu_torch.fields import field_impl
from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.groth16 import Groth16
from snark_tpu_torch.models import MulChainCircuit
from test_torch_prove_small import check_legacy_proof

assert field_impl() == "f32"
with open(os.path.join("tests", "vectors", "proof_bn254.json")) as f:
    vector = json.load(f)
g16 = Groth16(BN254, device="cpu")
pk, vk = g16.circuit_specific_setup(MulChainCircuit(seed=11, n=8, batch=False),
                                    random.Random(int(vector["setup_seed"])))
check_legacy_proof(g16, pk, MulChainCircuit(seed=11, n=8), vector, BN254)
print("F32-PROVE-OK")
"""


def test_small_prove_under_f32():
    """Under SNARK_TPU_FIELD_IMPL=f32 (in a subprocess, as
    `tests/test_f32_integration.py` runs the reference): the prove of the
    vector's circuit gives the vector's bytes, and the legacy composition,
    whose curve ops then take the f32 digit layout and split the key's
    uint32 query arrays into digits at the boundary, the same sums, h and
    proof."""
    env = dict(os.environ, SNARK_TPU_FIELD_IMPL="f32", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", F32_SCRIPT], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert "F32-PROVE-OK" in out.stdout, out.stdout + out.stderr
