"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; without a card every test skips. This file imports neither
jax nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(`--noconftest`: the suite's conftest configures JAX.)
"""

import json
import os
import random

import pytest
import torch

from snark_tpu_torch.fields.limbs import FR
from snark_tpu_torch.fields.params import BN254
from snark_tpu_torch.groth16 import Groth16, ProvingKey
from snark_tpu_torch.models import MulChainCircuit
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops import ntt as N
from snark_tpu_torch.ops.curve_host import host_g1, host_g2
from snark_tpu_torch.ops.msm import signed_digits
from snark_tpu_torch.ops.msm_plane import PlaneMsm
from snark_tpu_torch.snark import serialize as ser

pytestmark = pytest.mark.gpu

VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
HOSTS = {"g1": host_g1(BN254), "g2": host_g2(BN254)}
R = BN254.fr.modulus


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def rand(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(R) for _ in range(n)]


def test_field_ew_matches_plain(cuda):
    a, b, c = (FR.tensor(rand(4096, s), cuda) for s in (1, 2, 3))
    d = FR.const(12345, cuda)
    for mode in ("mul", "add", "hadamard"):
        assert torch.equal(N.field_ew(mode, a, b, c, d), N.field_ew_plain(mode, a, b, c, d))
    assert torch.equal(N.field_ew("mul", a, b[7]), N.field_ew_plain("mul", a, b[7]))


def test_ntt_matches_plain(cuda):
    n = 1 << 12
    av, bv, cv = rand(n, 4), rand(n, 5), rand(n, 6)
    gpu, cpu = N.NttPlan(n, cuda), N.NttPlan(n, "cpu")
    got = gpu.h_from_evals(*(FR.tensor(v, cuda) for v in (av, bv, cv)))
    want = cpu.h_from_evals(*(FR.tensor(v, "cpu") for v in (av, bv, cv)))
    assert torch.equal(got.cpu(), want)
    x = FR.tensor(av, cuda)
    for s in (0, 5, 11):
        for dif in (False, True):
            assert torch.equal(
                N.ntt_stage(x, gpu.fwd_tw, s, n >> (s + 1), dif),
                N.ntt_stage_plain(x, gpu.fwd_tw, s, n >> (s + 1), dif),
            )


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_curve_kernels_match_plain(cuda, group):
    hc = HOSTS[group]
    rng = random.Random(7)
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(15)] + [None]
    P = [pool[i % 16] for i in range(256)]
    Q = [pool[(5 * i + 3) % 16] for i in range(256)]
    Q[:3] = [P[0], hc.neg(P[1]), None]  # doubling, inverse, identity
    p, q = C.points_to_limbs(P, group, cuda), C.points_to_limbs(Q, group, cuda)
    mask = torch.rand(256, device=cuda) < 0.7
    got = C.masked_add(p, q, mask, group)
    assert torch.equal(got, C.masked_add_plain(p, q, mask, group))
    assert C.limbs_to_points(got, group) == [
        hc.add(a, b) if m else a for a, b, m in zip(P, Q, mask.tolist())
    ]
    table = torch.as_tensor(C.pack_rows_u8(Q, group), device=cuda)
    perm = torch.randint(0, 256, (2560,), device=cuda, dtype=torch.int32)
    perm = torch.where(torch.rand(2560, device=cuda) < 0.4, perm | (-(1 << 31)), perm)
    base = torch.zeros(256, dtype=torch.int32, device=cuda)
    start = torch.arange(256, dtype=torch.int32, device=cuda) * 10
    length = torch.randint(0, 11, (256,), dtype=torch.int32, device=cuda)
    args = (p, table, perm.to(torch.int32), base, start, length, 0, 10, group)
    assert torch.equal(C.bucket_madd_rows(*args), C.bucket_madd_rows_plain(*args))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_matches_host(cuda, group):
    """A clustered witness-like scalar set (the spill path runs)."""
    hc = HOSTS[group]
    rng = random.Random(31)
    c, n = 11, 1 << 14
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(16)]
    pts = pool * (n // 16)
    scalars = [rng.randrange(1 << 44) if i % 2 else rng.randrange(R) for i in range(n)]
    agg = [0] * 16
    for i, s in enumerate(scalars):
        agg[i % 16] = (agg[i % 16] + s) % R
    table = torch.as_tensor(C.pack_rows_u8(pts, group), device=cuda)
    digits = signed_digits(FR.tensor(scalars, cuda, mont=False), c, BN254.fr.num_bits)
    assert PlaneMsm(c, group=group).msm(table, digits, hc) == hc.msm(pool, agg)


def test_prove_fixture(cuda):
    with open(os.path.join(VECTORS, "torch_proof_bn254_mulchain1023.json")) as f:
        want = json.load(f)
    pk = ProvingKey.load(os.path.join(VECTORS, "torch_pk_bn254_mulchain1023.npz"), device=cuda)
    g16 = Groth16(device=cuda)
    z = MulChainCircuit(seed=4, n=1023).assignment(R)
    proof = g16.prove_from_assignment(pk, z, int(want["r"]), int(want["s"]))
    assert ser.serialize_proof(proof, BN254).hex() == want["proof_bytes_hex"]
    assert g16.verify(pk.vk, want["public_input"], proof)
