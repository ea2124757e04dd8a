"""Proving-key persistence of the port against the JAX package: the npz
file (`ProvingKey.save`, `ProvingKey.load`) and the arkworks key bytes
(`Groth16.pk_to_bytes`, `pk_from_bytes`), on the committed 12-constraint
fixture keys of both curves (MulChain(7, 12), all five query arrays).
"""

import os
import random

import numpy as np
import pytest
import torch

from snark_tpu.fields.params import BLS12_381 as J_BLS, BN254 as J_BN254
from snark_tpu.groth16 import Groth16 as JaxGroth16
from snark_tpu.groth16.groth16 import ProvingKey as JaxProvingKey
from snark_tpu.models import MulChainCircuit as JaxMulChain
from snark_tpu.snark import serialize as jser
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.groth16 import Groth16, ProvingKey
from snark_tpu_torch.groth16.groth16 import QUERY_NAMES, VECTORS as KEY_VECTORS
from snark_tpu_torch.models import MulChainCircuit

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
CURVES = {"bn254": (J_BN254, BN254), "bls12_381": (J_BLS, BLS12_381)}
SEED, N = 7, 12
MATS = ("mat_a", "mat_b", "mat_c")
TABLE_NAMES = tuple(f"{stem}_tbl" for stem, _ in KEY_VECTORS)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def fixture(name: str) -> str:
    return os.path.join(VECTORS, f"torch_pk_{name}_mulchain{N}.npz")


def jax_arrays(pk) -> dict:
    """Every array of a JAX-loaded key, and its vk and points as bytes."""
    curve = pk.vk.curve
    out = {name: np.asarray(getattr(pk, name)) for name in QUERY_NAMES}
    out.update({name: np.asarray(getattr(pk, name)) for name in TABLE_NAMES})
    for m in MATS:
        out[m + "_cols"] = np.asarray(getattr(pk, m).cols)
        out[m + "_coeffs"] = np.asarray(getattr(pk, m).coeffs)
    out["vk"] = np.frombuffer(jser.serialize_vk(pk.vk), np.uint8)
    out["points"] = np.frombuffer(jser.serialize_g1(curve, pk.beta_g1)
                                  + jser.serialize_g1(curve, pk.delta_g1), np.uint8)
    out["sizes"] = np.asarray([pk.num_instance, pk.num_witness, pk.num_constraints,
                               pk.domain_size])
    return out


@pytest.mark.parametrize("name", list(CURVES))
def test_saved_key_reads_in_jax_and_back(name, tmp_path):
    """The port's own key, saved, is read by the JAX `ProvingKey.load` as
    the fixture key; the port reads it back and saves the same file."""
    _, curve = CURVES[name]
    pk, _ = Groth16(curve, device="cpu").circuit_specific_setup(
        MulChainCircuit(seed=SEED, n=N), random.Random(0))
    path = str(tmp_path / "pk.npz")
    pk.save(path)
    want, got = jax_arrays(JaxProvingKey.load(fixture(name))), jax_arrays(JaxProvingKey.load(path))
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    again = str(tmp_path / "again.npz")
    ProvingKey.load(path, device="cpu").save(again)
    with np.load(path) as a, np.load(again) as b:
        assert a.files == b.files
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


@pytest.mark.parametrize("name", list(CURVES))
def test_pk_to_bytes_equals_jax(name):
    """The arkworks key bytes from the query arrays, and from the u8 rows
    (h un-permuted) for a key without them, equal the JAX
    `serialize_pk_points` of the fixture key's points."""
    jax_curve, curve = CURVES[name]
    want = JaxGroth16(jax_curve).pk_to_bytes(JaxProvingKey.load(fixture(name)))
    g16 = Groth16(curve, device="cpu")
    pk = ProvingKey.load(fixture(name), device="cpu")
    assert g16.pk_to_bytes(pk) == want
    pk.file_queries = frozenset()  # no query arrays: the points come from the rows
    assert pk.query_names() == []
    assert g16.pk_to_bytes(pk) == want


def test_pk_from_bytes_round_trip():
    """pk_from_bytes rebuilds the key's tables, matrices and sizes and the
    JAX `pk_from_bytes`'s (affine) query arrays, and gives the same bytes
    again, compressed and not."""
    g16 = Groth16(BN254, device="cpu")
    pk = ProvingKey.load(fixture("bn254"), device="cpu")
    circuit = MulChainCircuit(seed=SEED, n=N)
    jax_g16 = JaxGroth16(J_BN254)
    for compress in (True, False):
        data = g16.pk_to_bytes(pk, compress)
        back = g16.pk_from_bytes(data, circuit, compress)
        assert g16.pk_to_bytes(back, compress) == data
        for name in TABLE_NAMES:
            assert torch.equal(getattr(back, name), getattr(pk, name)), name
        for m in MATS:
            assert torch.equal(getattr(back, m).cols, getattr(pk, m).cols)
            assert torch.equal(getattr(back, m).coeffs, getattr(pk, m).coeffs)
        assert (back.num_instance, back.num_witness, back.num_constraints, back.domain_size) == (
            pk.num_instance, pk.num_witness, pk.num_constraints, pk.domain_size)
    jax_back = jax_g16.pk_from_bytes(data, JaxMulChain(seed=SEED, n=N), compress=False)
    for name in QUERY_NAMES:
        assert np.array_equal(back.query(name), np.asarray(getattr(jax_back, name))), name
