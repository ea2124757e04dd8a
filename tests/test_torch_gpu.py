"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; without a card every test skips. This file imports neither
jax nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(`--noconftest`: the suite's conftest configures JAX.)
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from snark_tpu_torch import _native, bench_bisect_mul, bench_field, bench_reduce_parts, bench_vpu_peak
from snark_tpu_torch import bench as B
from snark_tpu_torch.fields.limbs import BLS_FR, FR, fields_of, u32_tensor
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.groth16 import Groth16, ProvingKey
from snark_tpu_torch.models import MulChainCircuit
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops import madd_parts as KP
from snark_tpu_torch.ops import ntt as N
from snark_tpu_torch.ops.curve_host import host_g1, host_g2
from snark_tpu_torch.ops import mont16 as M16
from snark_tpu_torch.ops import msm_affine as A
from snark_tpu_torch.ops import mul_parts as MP
from snark_tpu_torch.ops import vpu_peak as VP
from snark_tpu_torch.ops.msm import signed_digits, unsigned_digits
from snark_tpu_torch.ops.msm_plane import PlaneMsm
from snark_tpu_torch.parallel import BatchProver
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


def rand_elems(field, n, seed, device):
    """(n, L) elements below p from a seed: random words under a top word
    below p's, led by the edges 0, 1 and p − 1."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, (n, field.limbs), dtype=np.uint64)
    words[:, -1] %= field.p >> (32 * (field.limbs - 1))
    words[:3] = field.encode([0, 1, field.p - 1], mont=False)
    return u32_tensor(words.astype(np.uint32), device)


@pytest.mark.parametrize("field,log_n", [(FR, 18), (BLS_FR, 20)], ids=["bn254_fr", "bls12_381_fr"])
def test_ntt_pass_matches_plain(cuda, field, log_n):
    """K3's passes at the proves' domains, bit for bit against the plain
    passes: each pass the plan splits a transform into, DIT and DIF, with
    and without the Hadamard prologue and the scale epilogue; then the fused
    h against the unfused plain pipeline, in 7 launches a transform's
    passes."""
    plan = N.NttPlan(1 << log_n, cuda, field)
    x, b, c, scale = (rand_elems(field, 1 << log_n, seed, cuda) for seed in range(4))
    d = plan.z_coset_inv
    for s0, k in plan.passes:
        for dif, tw in ((False, plan.fwd_tw), (True, plan.inv_tw)):
            for had, sc in ((None, None), ((b, c, d), None), (None, scale), ((b, c, d), scale)):
                got = N.ntt_pass(x, tw, s0, k, dif, hadamard=had, scale=sc, field=field)
                want = N.ntt_pass_plain(x, tw, s0, k, dif, hadamard=had, scale=sc, field=field)
                assert torch.equal(got, want), (s0, k, dif, had is None, sc is None)
    curve = "bn254" if field is FR else "bls12_381"
    _native.reset_launches()
    h = plan.h_std(x, b, c)
    assert _native.LAUNCHES[_native.counter_name("ntt_pass", curve)] == 7 * len(plan.passes)
    assert _native.LAUNCHES[_native.counter_name("field_ew", curve)] == 0
    assert torch.equal(h, plan.h_plain(x, b, c))
    assert torch.equal(N.from_mont(plan.h_from_evals(x, b, c), field), h)


@pytest.mark.parametrize("log_n,m", [(18, 512), (17, 512), (9, 32)])
def test_ntt_rows_matches_plain(cuda, log_n, m):
    """K3 as the six-step NTT's batched row transforms (`ntt_rows`, tw_log =
    log m − 1) at a rank's shard of the distributed 2^18 prove on one rank
    and on two and of the 2^10 dry run, forward and inverse with its 1/m
    scale, bit for bit against the plain passes."""
    x = rand_elems(FR, 1 << log_n, 7, cuda)
    plan = N.NttPlan(m, cuda)
    inv_m = FR.const(pow(m, -1, R), cuda)
    for tw, scale in ((plan.fwd_tw, None), (plan.inv_tw, inv_m)):
        _native.reset_launches()
        got = N.ntt_rows(x, m, tw, scale)
        assert _native.LAUNCHES[_native.counter_name("ntt_pass", "bn254")] == len(plan.passes)
        assert torch.equal(got, N.ntt_rows_plain(x, m, tw, scale))


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
    assert PlaneMsm(c, group=group).msm_host(table, digits, hc) == hc.msm(pool, agg)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_combine_kernels_match_plain(cuda, group):
    """K5 and K2 without a mask, identity and chained doublings included."""
    hc = HOSTS[group]
    rng = random.Random(8)
    P = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(63)] + [None]
    Q = [P[5], hc.neg(P[6]), None] + [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(61)]
    p, q = C.points_to_limbs(P, group, cuda), C.points_to_limbs(Q, group, cuda)
    d = p
    for _ in range(3):
        d2 = C.point_double(d, group)
        assert torch.equal(d2, C.point_double_plain(d, group))
        d = d2
    assert C.limbs_to_points(d, group) == [hc.double(hc.double(hc.double(x))) for x in P]
    s = C.point_add(p, q, group)
    assert torch.equal(s, C.point_add_plain(p, q, group))
    assert C.limbs_to_points(s, group) == [hc.add(a, b) for a, b in zip(P, Q)]


def test_horner_combine_matches_plain(cuda):
    """K18 against its plain version, limb for limb, on both curves and
    groups at the bench's W = 20, c = 13: random totals and the edge totals
    (identity, equal, negated, doubling, inverse, one window, c = 1, edge
    limbs). `PlaneMsm.combine` launches K18 once and nothing else."""
    for curve in (BN254, BLS12_381):
        for group in ("g1", "g2"):
            plan = PlaneMsm(13, curve.fr.num_bits, group, signed=True, curve=curve)
            assert plan.W == 20
            hc = B.host_curve(group, curve)
            rng = random.Random(9)
            pts = [hc.scalar_mul(hc.generator, rng.randrange(1, curve.fr.modulus))
                   for _ in range(plan.W)]
            cases = [("random", C.points_to_limbs(pts, group, cuda, curve), plan.c)]
            cases += C.horner_cases(plan.W, plan.c, group, cuda, curve, seed=4)
            for name, sums, c in cases:
                got = C.horner_combine(sums, c, group, curve)
                want = C.horner_combine_plain(sums, c, group, curve)
                assert torch.equal(got, want), (curve.name, group, name)
            _native.reset_launches()
            plan.combine(cases[0][1])
            launched = {k: v for k, v in _native.LAUNCHES.items() if v}
            assert launched == {_native.counter_name("horner_combine", curve.name, group): 1}


def affine_level0(group, n, c, seed, cuda, curve=BN254):
    """Level-0 blocks of a signed affine MSM over a pool with inverse
    pairs and identity rows: (rows, sign bytes)."""
    hc = host_g1(curve) if group == "g1" else host_g2(curve)
    r = curve.fr.modulus
    rng = random.Random(seed)
    base = [hc.scalar_mul(hc.generator, rng.randrange(1, r)) for _ in range(7)]
    pool = base + [hc.neg(pt) for pt in base] + [None, None]
    pts = [pool[i % 16] for i in range(n)]
    scalars = [rng.randrange(r) for _ in range(n)]
    table = torch.as_tensor(C.pack_rows_u8(pts, group, curve), device=cuda)
    plan = PlaneMsm(c, curve.fr.num_bits, group, affine=True, curve=curve)
    fr = fields_of(curve)[0]
    digits = signed_digits(fr.tensor(scalars, cuda, mont=False), c, curve.fr.num_bits)
    perm, start, length = plan._buckets(digits.t().contiguous())
    rows, sgn, _, _, _ = A.AffineAccum(plan).blocks(table, perm, start, length, n, n // plan.nb)
    return rows, sgn


@pytest.mark.parametrize("curve", [BN254, BLS12_381], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_affine_kernels_match_plain(cuda, group, curve):
    """K6, K7 (both modes, and the batch inverse) and K8 at level 0 and K6
    at level 1, against the plain versions, on both curves."""
    rows, sgn = affine_level0(group, 1 << 12, 9, 9, cuda, curve)
    den, cls = A.affine_phase1(rows, sgn, group, curve)
    pden, pcls = A.affine_phase1_plain(rows, sgn, group, curve)
    assert torch.equal(den, pden) and torch.equal(cls, pcls)
    assert set(torch.unique(cls).tolist()) >= {A.ADD, A.DEAD, A.COPY_L, A.COPY_R}
    h = den.shape[0] // 2
    assert torch.equal(A.affine_tree_mul(den[:h], den[h:], group, curve=curve),
                       A.affine_tree_mul_plain(den[:h], den[h:], group, curve))
    assert torch.equal(A.affine_inverse(den[:5], group, curve),
                       A.affine_inverse_plain(den[:5], group, curve))
    dinv = A.batch_inverse(den, group, curve)
    one = torch.zeros_like(den[0])
    one[0] = fields_of(curve)[1].const(1, cuda)
    assert torch.equal(A.affine_tree_mul(den, dinv, group, curve=curve), one.expand_as(den))
    out = A.affine_phase3(rows, sgn, dinv, cls, group, curve)
    assert torch.equal(out, A.affine_phase3_plain(rows, sgn, dinv, cls, group, curve))
    nxt, _ = A.affine_phase1(out, None, group, curve)
    assert torch.equal(nxt, A.affine_phase1_plain(out, None, group, curve)[0])


@pytest.mark.parametrize("curve", [BN254, BLS12_381], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_affine_batch_inverse_matches_plain(cuda, group, curve):
    """K19 against its plain version (on the card) at the edges of its
    indexing with the instance's T and C: M = 1, 2, 3, C − 1, C, C + 1,
    T·C − 1, T·C + 1, 3·T·C + 5 and G = kTop + 3 block products (more than
    the top block's threads); three launches a call and no K7 launch; and
    at 100,003 elements equal to the former K7 tree, with den·dinv = 1."""
    T, Cc, top = A.INVERSE_SIZES[(curve.name, group)]
    fq = fields_of(curve)[1]
    K = C.GROUPS[group]
    g = torch.Generator().manual_seed(19)
    one = torch.zeros((1, K, fq.limbs), dtype=torch.int32, device=cuda)
    one[0, 0] = fq.const(1, cuda)
    for m in (1, 2, 3, Cc - 1, Cc, Cc + 1, T * Cc - 1, T * Cc + 1, 3 * T * Cc + 5,
              (top + 3) * T * Cc - 11, 100_003):
        vals = [int(v) % (fq.p - 1) + 1 for v in
                torch.randint(0, 1 << 62, (m * K,), generator=g, dtype=torch.int64).tolist()]
        den = fq.tensor(vals, cuda).view(m, K, fq.limbs)
        _native.reset_launches()
        dinv = A.batch_inverse(den, group, curve)
        launched = {k: v for k, v in _native.LAUNCHES.items() if v}
        assert launched == {_native.counter_name("affine_batch_inverse", curve.name, group): 3}
        if m == 100_003:
            assert torch.equal(dinv, A.tree_inverse(
                den, lambda a, b: A.affine_tree_mul(a, b, group, curve=curve),
                lambda r: A.affine_inverse(r, group, curve), one))
            assert torch.equal(A.affine_tree_mul(den, dinv, group, curve=curve),
                               one.expand_as(den))
        else:
            assert torch.equal(dinv, A.affine_batch_inverse_plain(den, group, curve)), m


@pytest.mark.parametrize("curve", [BN254, BLS12_381], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_affine_tiles_match_plain(cuda, group, curve):
    """K6 and K8 at their tiles' edges (T = 128 pairs a block) against the
    plain versions: M = 1, T − 1, T, T + 1 and an odd M above 10^5; the
    rows a view two rows into their tensor (not 16-byte aligned), the sign
    bytes a view three bytes in, dinv four bytes off 16; with sign bytes
    and without; the first tile holds all five classes."""
    T, big_m = 128, 100_003
    hc = host_g1(curve) if group == "g1" else host_g2(curve)
    rng = random.Random(5)
    base = [hc.scalar_mul(hc.generator, rng.randrange(1, curve.fr.modulus)) for _ in range(7)]
    pool = torch.as_tensor(
        C.pack_rows_u8(base + [hc.neg(p) for p in base] + [None, None], group, curve), device=cuda)
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, 16, (2 * big_m + 2,), generator=g)
    # pairs 0-5 of the first tile: add, double, P + (−P), copy left, copy
    # right, two identities
    idx[2 : 2 + 12] = torch.tensor([0, 1, 2, 2, 3, 10, 4, 14, 15, 5, 14, 15])
    table = pool[idx.to(cuda)]
    signs = torch.randint(0, 2, (2 * big_m + 3,), generator=g).to(torch.uint8).to(cuda)
    for m in (1, T - 1, T, T + 1, big_m):
        rows = table[2 : 2 + 2 * m]
        assert rows.data_ptr() % 16
        for sgn in (signs[3 : 3 + 2 * m], None):
            den, cls = A.affine_phase1(rows, sgn, group, curve)
            pden, pcls = A.affine_phase1_plain(rows, sgn, group, curve)
            assert torch.equal(den, pden) and torch.equal(cls, pcls), (m, sgn is None)
            if m >= T and sgn is None:
                assert set(cls[:T].tolist()) == {A.ADD, A.DOUBLE, A.DEAD, A.COPY_L, A.COPY_R}
            dinv = A.batch_inverse(den, group, curve)
            buf = torch.empty(dinv.numel() + 1, dtype=torch.int32, device=cuda)
            dinv_off = buf[1:].view(dinv.shape)
            dinv_off.copy_(dinv)
            assert dinv_off.data_ptr() % 16
            out = A.affine_phase3(rows, sgn, dinv_off, cls, group, curve)
            want = A.affine_phase3_plain(rows, sgn, dinv, cls, group, curve)
            assert torch.equal(out, want), (m, sgn is None)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("affine", [False, True])
def test_device_msm_matches_host(cuda, group, affine):
    """2^14 points, the device combine, the scan or the affine tree."""
    hc = HOSTS[group]
    rng = random.Random(41)
    c, n = 9, 1 << 14
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, R)) for _ in range(16)]
    pts = pool * (n // 16)
    scalars = [rng.randrange(1 << 44) if i % 2 else rng.randrange(R) for i in range(n)]
    agg = [0] * 16
    for i, s in enumerate(scalars):
        agg[i % 16] = (agg[i % 16] + s) % R
    want = hc.msm(pool, agg)
    table = torch.as_tensor(C.pack_rows_u8(pts, group), device=cuda)
    std = FR.tensor(scalars, cuda, mont=False)
    for signed in (True, False):
        digits = (signed_digits if signed else unsigned_digits)(std, c, BN254.fr.num_bits)
        plan = PlaneMsm(c, group=group, signed=signed, affine=affine)
        assert plan.uses_affine(n) == affine
        got = plan.msm(table, digits)
        assert C.limbs_to_points(got[None], group)[0] == want


def test_prove_fixture(cuda):
    with open(os.path.join(VECTORS, "torch_proof_bn254_mulchain1023.json")) as f:
        want = json.load(f)
    pk = ProvingKey.load(os.path.join(VECTORS, "torch_pk_bn254_mulchain1023.npz"), device=cuda)
    g16 = Groth16(device=cuda)
    proof = g16.prove(pk, MulChainCircuit(seed=4, n=1023), r=int(want["r"]), s=int(want["s"]))
    assert ser.serialize_proof(proof, BN254).hex() == want["proof_bytes_hex"]
    assert g16.verify(pk.vk, want["public_input"], proof)


def test_prove_synthesized_equals_cpu(cuda):
    """`prove(pk, circuit, rng)` of the synthesized fixture circuit on the
    card gives the CPU port's proof from the same rng, and it verifies."""
    path = os.path.join(VECTORS, "torch_pk_bn254_mulchain1023.npz")
    circuit = MulChainCircuit(seed=4, n=1023)
    proofs = []
    for dev in (cuda, "cpu"):
        g16 = Groth16(device=dev)
        proofs.append(g16.prove(ProvingKey.load(path, device=dev), circuit, random.Random(5)))
        assert "synthesize" in g16.last_run.stage_ms
    assert proofs[0] == proofs[1]
    assert g16.verify(ProvingKey.load(path, device="cpu").vk, [4], proofs[0])


@pytest.mark.parametrize("fixture", ["mulchain8", "mulchain1023"])
def test_batch_prover_equals_cpu(cuda, fixture):
    """`BatchProver` on the card gives the CPU port's proofs at the same
    (r, s), the JAX-written proof first: MulChain(11, 8) set up from
    random.Random(42405) (`proof_bn254.json`), seeds 11, 12, 13; the
    m = 2048 fixture key, seeds 4, 5, 6. Each MSM's combine is one K18
    launch: 5 a proof, 4 in G1 and 1 in G2."""
    if fixture == "mulchain8":
        with open(os.path.join(VECTORS, "proof_bn254.json")) as f:
            want = json.load(f)
        seeds, n = (11, 12, 13), 8
        keys = [Groth16(device=dev).circuit_specific_setup(
            MulChainCircuit(seed=11, n=8, batch=False), random.Random(int(want["setup_seed"])))[0]
            for dev in (cuda, "cpu")]
    else:
        with open(os.path.join(VECTORS, "torch_proof_bn254_mulchain1023.json")) as f:
            want = json.load(f)
        seeds, n = (4, 5, 6), 1023
        path = os.path.join(VECTORS, "torch_pk_bn254_mulchain1023.npz")
        keys = [ProvingKey.load(path, device=dev) for dev in (cuda, "cpu")]
    circuits = [MulChainCircuit(seed=s, n=n) for s in seeds]
    rs = [(int(want["r"]), int(want["s"])), (1, 2), (3 << 200, 5 << 100)]
    g16 = Groth16(device=cuda)
    _native.reset_launches()
    proofs = BatchProver(g16, keys[0]).prove_batch(circuits, rs=rs)
    assert _native.LAUNCHES["horner_combine_g1"] == 4 * len(seeds)
    assert _native.LAUNCHES["horner_combine_g2"] == len(seeds)
    assert ser.serialize_proof(proofs[0], BN254).hex() == want["proof_bytes_hex"]
    cpu = Groth16(device="cpu")
    pvk = cpu.process_vk(keys[1].vk)
    for seed, circuit, (r, s), proof in zip(seeds, circuits, rs, proofs):
        assert proof == cpu.prove(keys[1], circuit, r=r, s=s)
        assert cpu.verify_with_processed_vk(pvk, [seed], proof)


# ---------------------------------------------------------------------------
# BLS12-381 instances (K1, K2 over 12-limb Fq and Fq2; K3, K4 over its Fr)
# ---------------------------------------------------------------------------

BLS_HOSTS = {"g1": host_g1(BLS12_381), "g2": host_g2(BLS12_381)}
BLS_R = BLS12_381.fr.modulus


def test_bls_scalar_kernels_match_plain(cuda):
    rng = random.Random(12)
    n = 1 << 12
    av, bv, cv = ([rng.randrange(BLS_R) for _ in range(n)] for _ in range(3))
    a, b, c = (BLS_FR.tensor(v, cuda) for v in (av, bv, cv))
    d = BLS_FR.const(12345, cuda)
    for mode in ("mul", "add", "hadamard"):
        assert torch.equal(N.field_ew(mode, a, b, c, d, BLS_FR),
                           N.field_ew_plain(mode, a, b, c, d, BLS_FR))
    gpu, cpu = N.NttPlan(n, cuda, BLS_FR), N.NttPlan(n, "cpu", BLS_FR)
    got = gpu.h_from_evals(a, b, c)
    assert torch.equal(got.cpu(), cpu.h_from_evals(a.cpu(), b.cpu(), c.cpu()))
    for s in (0, 5, 11):
        for dif in (False, True):
            assert torch.equal(
                N.ntt_stage(a, gpu.fwd_tw, s, n >> (s + 1), dif, BLS_FR),
                N.ntt_stage_plain(a, gpu.fwd_tw, s, n >> (s + 1), dif, BLS_FR),
            )


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bls_curve_kernels_match_plain(cuda, group):
    hc = BLS_HOSTS[group]
    rng = random.Random(7)
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, BLS_R)) for _ in range(15)] + [None]
    P = [pool[i % 16] for i in range(256)]
    Q = [pool[(5 * i + 3) % 16] for i in range(256)]
    Q[:3] = [P[0], hc.neg(P[1]), None]  # doubling, inverse, identity
    p = C.points_to_limbs(P, group, cuda, BLS12_381)
    q = C.points_to_limbs(Q, group, cuda, BLS12_381)
    mask = torch.rand(256, device=cuda) < 0.7
    got = C.masked_add(p, q, mask, group, BLS12_381)
    assert torch.equal(got, C.masked_add_plain(p, q, mask, group, BLS12_381))
    assert C.limbs_to_points(got, group, BLS12_381) == [
        hc.add(a, b) if m else a for a, b, m in zip(P, Q, mask.tolist())
    ]
    table = torch.as_tensor(C.pack_rows_u8(Q, group, BLS12_381), device=cuda)
    perm = torch.randint(0, 256, (2560,), device=cuda, dtype=torch.int32)
    perm = torch.where(torch.rand(2560, device=cuda) < 0.4, perm | (-(1 << 31)), perm)
    base = torch.zeros(256, dtype=torch.int32, device=cuda)
    start = torch.arange(256, dtype=torch.int32, device=cuda) * 10
    length = torch.randint(0, 11, (256,), dtype=torch.int32, device=cuda)
    args = (p, table, perm.to(torch.int32), base, start, length, 0, 10, group, BLS12_381)
    assert torch.equal(C.bucket_madd_rows(*args), C.bucket_madd_rows_plain(*args))
    # K5 and K2 without a mask (the device combine), doublings chained
    d = p
    for _ in range(3):
        d2 = C.point_double(d, group, BLS12_381)
        assert torch.equal(d2, C.point_double_plain(d, group, BLS12_381))
        d = d2
    assert C.limbs_to_points(d, group, BLS12_381) == [hc.double(hc.double(hc.double(x))) for x in P]
    s = C.point_add(p, q, group, BLS12_381)
    assert torch.equal(s, C.point_add_plain(p, q, group, BLS12_381))


def test_bls_msm_matches_host(cuda):
    """G1 and G2, a clustered witness-like scalar set (the spill path runs)."""
    rng = random.Random(31)
    c, n = 11, 1 << 14
    scalars = [rng.randrange(1 << 44) if i % 2 else rng.randrange(BLS_R) for i in range(n)]
    digits = signed_digits(BLS_FR.tensor(scalars, cuda, mont=False), c, BLS12_381.fr.num_bits)
    agg = [0] * 16
    for i, s in enumerate(scalars):
        agg[i % 16] = (agg[i % 16] + s) % BLS_R
    for group, hc in BLS_HOSTS.items():
        pool = [hc.scalar_mul(hc.generator, rng.randrange(1, BLS_R)) for _ in range(16)]
        table = torch.as_tensor(C.pack_rows_u8(pool * (n // 16), group, BLS12_381), device=cuda)
        plan = PlaneMsm(c, BLS12_381.fr.num_bits, group, curve=BLS12_381)
        assert plan.msm_host(table, digits, hc) == hc.msm(pool, agg)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("affine", [False, True])
def test_bls_device_msm_matches_host(cuda, group, affine):
    """BLS12-381, 2^14 points, the device combine (K5, K2 unmasked), the
    scan or the affine tree (K6-K8)."""
    hc = BLS_HOSTS[group]
    rng = random.Random(42)
    c, n = 9, 1 << 14
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, BLS_R)) for _ in range(16)]
    scalars = [rng.randrange(1 << 44) if i % 2 else rng.randrange(BLS_R) for i in range(n)]
    agg = [0] * 16
    for i, s in enumerate(scalars):
        agg[i % 16] = (agg[i % 16] + s) % BLS_R
    table = torch.as_tensor(C.pack_rows_u8(pool * (n // 16), group, BLS12_381), device=cuda)
    digits = signed_digits(BLS_FR.tensor(scalars, cuda, mont=False), c, BLS12_381.fr.num_bits)
    plan = PlaneMsm(c, BLS12_381.fr.num_bits, group, affine=affine, curve=BLS12_381)
    assert plan.uses_affine(n) == affine
    got = plan.msm(table, digits)
    assert C.limbs_to_points(got[None], group, BLS12_381)[0] == hc.msm(pool, agg)


def test_bls_prove_small_fixture(cuda):
    """The 12-constraint BLS12-381 fixture on the card: the JAX package's
    proof, bit for bit, and it verifies; every BLS12-381 kernel launched."""
    with open(os.path.join(VECTORS, "torch_proof_bls12_381_mulchain12.json")) as f:
        want = json.load(f)
    pk = ProvingKey.load(os.path.join(VECTORS, "torch_pk_bls12_381_mulchain12.npz"), device=cuda)
    g16 = Groth16(BLS12_381, device=cuda)
    _native.reset_launches()
    proof = g16.prove(pk, MulChainCircuit(seed=7, n=12), r=int(want["r"]), s=int(want["s"]))
    assert ser.serialize_proof(proof, BLS12_381).hex() == want["proof_bytes_hex"]
    assert g16.verify(pk.vk, want["public_input"], proof)
    for k in ("bucket_madd_rows_bls12_381_g1", "bucket_madd_rows_bls12_381_g2",
              "masked_add_bls12_381_g1", "masked_add_bls12_381_g2",
              "ntt_pass_bls12_381", "field_ew_bls12_381"):
        assert _native.LAUNCHES[k] > 0, k


@pytest.mark.parametrize("field", [FR, BLS_FR], ids=["bn254_fr", "bls12_381_fr"])
def test_mont16_kernels_match_plain(cuda, field):
    """K9 and K10 against their plain version, with the edges 0, 1, p − 1
    and all-0xFFFF limbs below p, at block sizes that leave ragged ends."""
    rng = random.Random(21)
    p = field.p
    vals = [0, 1, p - 1, (1 << 240) - 1] + [rng.randrange(p) for _ in range(5000)]
    a = M16.unpack_words(field.tensor(vals, cuda).to(torch.int64) & 0xFFFFFFFF)
    b = M16.unpack_words(field.tensor(vals[::-1], cuda).to(torch.int64) & 0xFFFFFFFF)
    want = M16.mont_mul16_plain(a, b, field)
    for threads in (64, 256, 1024):
        assert torch.equal(M16.mont_mul16(a, b, field, threads), want)
        assert torch.equal(M16.mont_mul16_limb_major(a, b, field, threads), want)
    got = field.decode(M16.pack_words(want).to(torch.int32))
    assert got == [x * y % p for x, y in zip(vals, vals[::-1])]


@pytest.mark.parametrize("curve", [BN254, BLS12_381], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_masked_mixed_add_matches_plain(cuda, group, curve):
    """K11 against its plain version and the host curve: doubling, inverse
    and identity P among random pairs, the mask clear where Q is absent."""
    hc = (host_g1 if group == "g1" else host_g2)(curve)
    r = curve.fr.modulus
    rng = random.Random(9)
    pool = [hc.scalar_mul(hc.generator, rng.randrange(1, r)) for _ in range(15)]
    P = [pool[i % 15] for i in range(300)]
    Q = [pool[(7 * i + 2) % 15] for i in range(300)]
    P[3] = None
    Q[:2] = [P[0], hc.neg(P[1])]
    p = C.points_to_limbs(P, group, cuda, curve)
    q = C.points_to_limbs(Q, group, cuda, curve)
    mask = torch.rand(300, device=cuda) < 0.7
    mask[:4] = True
    x2, y2 = q[:, 0].contiguous(), q[:, 1].contiguous()
    got = C.masked_mixed_add(p, x2, y2, mask, group, curve)
    assert torch.equal(got, C.masked_mixed_add_plain(p, x2, y2, mask, group, curve))
    assert C.limbs_to_points(got, group, curve) == [
        hc.add(a, b) if m else a for a, b, m in zip(P, Q, mask.tolist())
    ]


@pytest.mark.parametrize("curve", [BN254, BLS12_381], ids=["bn254", "bls12_381"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_curve_kernels_on_edge_operands(cuda, group, curve):
    """K1, K2, K11 and K5 on accumulators and affine operands made of edge
    limb patterns (0, 1, p − 1, all-ones limbs; rows whose components run
    up to R − 1), not curve points: the formulas hold for any field
    elements, and the carry chains meet their extremes. Equal to the plain
    versions exactly."""
    n, k = 512, 8
    acc, table, perm, lane_base, start, length = C.edge_scan(n, k, group, cuda, curve, seed=1)
    assert torch.equal(
        C.bucket_madd_rows(acc, table, perm, lane_base, start, length, 0, k, group, curve),
        C.bucket_madd_rows_plain(acc, table, perm, lane_base, start, length, 0, k, group, curve),
    )
    p, q = (C.edge_points(n, group, cuda, curve, seed=s) for s in (2, 3))
    mask = torch.as_tensor(np.random.default_rng(4).random(n) > 0.25, device=cuda)
    assert torch.equal(C.masked_add(p, q, mask, group, curve),
                       C.masked_add_plain(p, q, mask, group, curve))
    x2, y2 = q[:, 0].contiguous(), q[:, 1].contiguous()
    assert torch.equal(C.masked_mixed_add(p, x2, y2, mask, group, curve),
                       C.masked_mixed_add_plain(p, x2, y2, mask, group, curve))
    assert torch.equal(C.point_double(p, group, curve), C.point_double_plain(p, group, curve))


@pytest.mark.parametrize("field", [BN254.fr, BLS12_381.fr], ids=["bn254_fr", "bls12_381_fr"])
def test_bench_field_lines_exact(cuda, field):
    """All five bench_field lines at 2^12 equal the host oracle."""
    res = bench_field.run(12, field=field, device=cuda, iters=1)
    assert res["correct"], [(rec["impl"], rec["threads"]) for rec in res["lines"] if not rec["correct"]]
    assert len(res["lines"]) == 3 + 2 * len(bench_field.THREADS)


def test_vpu_peak_kernels_match_plain(cuda):
    """K12-K15 against their plain versions at a lane count that leaves
    ragged blocks (and K12 a ragged float4 end), at two block sizes: K13
    and K15 exact, K12 within rtol 1e-4 (one rounding a step against two),
    K14 within rtol 1e-5 at depth 4 and within rtol 1e-4 plus 8·2^-149 at
    depth 8 (all subnormal there, and kept so on the card). K15 runs lazy inputs (digits up to 510) and must
    also equal a·b^32 on the host."""
    lanes = 999
    a_np, b_np = bench_vpu_peak.float_inputs(lanes, 1)
    a, b = (torch.from_numpy(x).to(cuda) for x in (a_np, b_np))
    pf = VP.plane_field()
    q = BN254.fq.modulus
    rng = random.Random(3)
    va, vb = ([rng.randrange(q) for _ in range(lanes)] for _ in range(2))
    am = torch.from_numpy(pf.pack_np(va) + pf.P2_COL).to(cuda).contiguous()
    bm = torch.from_numpy(pf.pack_np(vb)).to(cuda).contiguous()
    _native.reset_launches()
    for threads in (64, 256):
        assert torch.allclose(VP.fma_chain(a, b, 256, threads), VP.fma_chain_plain(a, b, 256),
                              rtol=1e-4, atol=0)
        assert torch.equal(VP.sweep_chain(a, 64, threads), VP.sweep_chain_plain(a, 64))
        assert torch.allclose(VP.conv_chain(a, b, 4, threads), VP.conv_chain_plain(a, b, 4),
                              rtol=1e-5, atol=0)
        deep = VP.conv_chain_plain(a, b, 8)
        assert 2.0**-140 < float(deep.abs().max()) < 2.0**-126
        assert torch.allclose(VP.conv_chain(a, b, 8, threads), deep,
                              rtol=bench_vpu_peak.CONV_RTOL_DEEP,
                              atol=bench_vpu_peak.CONV_ATOL_DEEP)
        got = VP.mont_mul_chain(am, bm, 32, threads=threads)
        assert torch.equal(got, VP.mont_mul_chain_plain(am, bm, 32))
    assert pf.unpack_np(got) == [x * pow(y, 32, q) % q for x, y in zip(va, vb)]
    for k in ("fma_chain", "sweep_chain", "conv_chain", "mont_mul_chain"):
        assert _native.LAUNCHES[k] == 2 * (2 if k == "conv_chain" else 1), k
    x = torch.zeros(34 * 998 + 1, device=cuda)[1:].view(34, 998)  # 4 bytes off alignment
    with pytest.raises(ValueError):
        VP.fma_chain(x, x, 1)


def test_bench_vpu_peak_lines_correct(cuda):
    """All five bench_vpu_peak lines at a small size, checked against the
    plain versions on the card and the host references."""
    res = bench_vpu_peak.run(lanes=4096, device=cuda, iters=1)
    assert res["correct"], [rec["line"] for rec in res["lines"] if not rec["correct"]]
    assert all(rec["ms"] > 0 for rec in res["lines"])


def test_mul_parts_kernels_match_plain(cuda):
    """K16 (A, B, C at both block widths) and K17 (all six kinds) against
    their plain versions bit for bit, at depths 2 and 8, on lazy inputs
    (A's digits up to 510); K16 A equals C and a·b^reps on the host."""
    lanes = 4096
    pf = VP.plane_field()
    q = BN254.fq.modulus
    rng = random.Random(5)
    va, vb = ([rng.randrange(q) for _ in range(lanes)] for _ in range(2))
    am = torch.from_numpy(pf.pack_np(va) + pf.P2_COL).to(cuda).contiguous()
    bm = torch.from_numpy(pf.pack_np(vb)).to(cuda).contiguous()
    _native.reset_launches()
    for reps in (2, 8):
        outs = {}
        for kind in MP.PARTS_KINDS:
            for T in MP.PARTS_T:
                got = MP.reduce_parts_chain(am, bm, kind, T, reps)
                assert torch.equal(got, MP.reduce_parts_chain_plain(am, bm, kind, T, reps)), (kind, T)
                outs[kind, T] = got
        assert torch.equal(outs["A", 512], outs["C", 512]) and torch.equal(outs["A", 2048], outs["C", 512])
        assert pf.unpack_np(outs["A", 512]) == [x * pow(y, reps, q) % q for x, y in zip(va, vb)]
        for kind in MP.BISECT_KINDS:
            assert torch.equal(MP.bisect_chain(am, bm, kind, reps),
                               MP.bisect_chain_plain(am, bm, kind, reps)), kind
    for kind in MP.PARTS_KINDS:
        for T in MP.PARTS_T:
            assert _native.LAUNCHES[f"reduce_parts_chain_{kind}_{T}"] == 2
    for kind in MP.BISECT_KINDS:
        assert _native.LAUNCHES[f"bisect_chain_{kind}"] == 2


def test_bench_mul_parts_lines_correct(cuda):
    """All lines of bench_reduce_parts and bench_bisect_mul at a small size,
    checked against the plain versions on the card and the host."""
    for bench in (bench_reduce_parts, bench_bisect_mul):
        res = bench.run(lanes=4096, device=cuda, iters=1)
        assert res["correct"], [rec["line"] for rec in res["lines"] if not rec["correct"]]
        assert all(rec["ms"] > 0 for rec in res["lines"])


def test_madd_parts_match_plain(cuda):
    """K1's parts (nosub, halfmul, nodecode) against their plain versions
    on the card over the first 4 scan steps of a 2^12-point MSM's buckets,
    exactly, one launch a part; and each part's window sums against the
    whole plain pipeline on the CPU, exactly."""
    inp = B.make_inputs(12, signed=True, c=8, device=cuda)
    plan = PlaneMsm(8, 254, "g1")
    perm, start, length = plan._buckets(inp.digits.t().contiguous())
    lane_base = (torch.arange(plan.lanes, device=cuda) // plan.nb * inp.n).to(torch.int32)
    start, length = start.to(torch.int32), length.to(torch.int32)
    acc0 = C.identity(plan.lanes, "g1", cuda)
    _native.reset_launches()
    for part in _native.MADD_PARTS:
        got = KP.bucket_madd_rows_part(part, acc0, inp.table, perm, lane_base, start, length, 0, 4)
        assert torch.equal(got, KP.bucket_madd_rows_part_plain(
            part, acc0, inp.table, perm, lane_base, start, length, 0, 4)), part
        assert _native.LAUNCHES[f"bucket_madd_rows_part_{part}"] == 1
        sums = PlaneMsm(8, 254, "g1", part=part).window_sums(inp.table, inp.digits)
        plain = PlaneMsm(8, 254, "g1", part=part).window_sums(inp.table.cpu(), inp.digits.cpu())
        assert torch.equal(sums.cpu(), plain), part


def test_fixed_base_walk_and_codec_match_plain(cuda):
    """The setup's fixed-base walk (one K1 launch, unsigned payloads,
    identity rows skipped) and affine codec (K7's batch inverse and
    products) on the card against their plain versions on the CPU, in G1
    and G2 on both curves, at 4096 scalars with 0, 1 and r − 1 among them,
    and the legacy chain (K2 without a mask) at 64."""
    from snark_tpu_torch.ops import affine_codec as AC
    from snark_tpu_torch.ops.fixed_base import FixedBase

    for curve in (BN254, BLS12_381):
        fr = fields_of(curve)[0]
        rng = random.Random(9)
        vals = [0, 1, fr.p - 1] + [rng.randrange(fr.p) for _ in range(4093)]
        std = fr.tensor(vals, cuda, mont=False)
        for group in ("g1", "g2"):
            fb, plain = FixedBase(curve, group, cuda), FixedBase(curve, group, "cpu")
            _native.reset_launches()
            P = fb.walk(std)
            assert _native.LAUNCHES[_native.counter_name("bucket_madd_rows", curve.name, group)] == 1
            P_cpu = plain.walk(std.cpu())
            assert torch.equal(P.cpu(), P_cpu), (curve.name, group)
            rows, query = AC.convert(P, group, curve)
            rows_cpu, query_cpu = AC.convert(P_cpu, group, curve)
            assert torch.equal(rows.cpu(), rows_cpu) and np.array_equal(query, query_cpu)
            assert torch.equal(fb.walk_legacy(std[:64]).cpu(), plain.walk_legacy(std[:64].cpu()))


def test_setup_on_card_equals_jax_keys(cuda, tmp_path):
    """The setup on the card of each committed fixture circuit from
    random.Random(0) gives every array of the JAX-written key."""
    fixtures = (("torch_pk_bn254_mulchain1023.npz", BN254, 4, 1023),
                ("torch_pk_bn254_mulchain12.npz", BN254, 7, 12),
                ("torch_pk_bls12_381_mulchain12.npz", BLS12_381, 7, 12))
    for name, curve, seed, n in fixtures:
        pk, _ = Groth16(curve, device=cuda).circuit_specific_setup(
            MulChainCircuit(seed=seed, n=n), random.Random(0))
        path = str(tmp_path / name)
        pk.save(path)
        with np.load(os.path.join(VECTORS, name)) as want, np.load(path) as got:
            for k in want.files:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (name, k)


# ---------------------------------------------------------------------------
# distributed proving: worlds of ranks on the card (`run_ranks`)
# ---------------------------------------------------------------------------

DIST_FIXTURES = {  # vector, key (None: set up from the vector's seed), circuit, curve
    "mulchain8": ("proof_bn254.json", None, MulChainCircuit(seed=11, n=8, batch=False), BN254),
    "mulchain1023": ("torch_proof_bn254_mulchain1023.json", "torch_pk_bn254_mulchain1023.npz",
                     MulChainCircuit(seed=4, n=1023), BN254),
    "bls": ("torch_proof_bls12_381_mulchain12.json", "torch_pk_bls12_381_mulchain12.npz",
            MulChainCircuit(seed=7, n=12), BLS12_381),
}


@pytest.mark.parametrize("fixture, ranks", [("mulchain8", 1), ("mulchain8", 2),
                                            ("mulchain1023", 2), ("bls", 2)])
def test_dist_prove_fixture(cuda, fixture, ranks, tmp_path):
    """`DistPlaneProver` in a world of `ranks` ranks on the card (NCCL at
    one rank, gloo at two on one card) proves each committed fixture's
    proof bytes on every rank: MulChain(11, 8) from random.Random(42405)
    (domain 16, the MSM's block path), the m = 2048 key (W = 29 at c = 9,
    the totals path) and the 12-constraint BLS12-381 key; K1-K4 launched."""
    from snark_tpu_torch.parallel.launch import run_ranks
    from snark_tpu_torch.parallel.plane_dist import prove_from_file

    vec_name, key_name, circuit, curve = DIST_FIXTURES[fixture]
    with open(os.path.join(VECTORS, vec_name)) as f:
        want = json.load(f)
    if key_name is None:
        path = str(tmp_path / "pk.npz")
        Groth16(curve, device=cuda).circuit_specific_setup(
            circuit, random.Random(int(want["setup_seed"])))[0].save(path)
    else:
        path = os.path.join(VECTORS, key_name)
    results = run_ranks(prove_from_file, ranks, "cuda", path, circuit, "cuda", "tp", None,
                        int(want["r"]), int(want["s"]), timeout_s=300)
    suffix = "" if curve is BN254 else "_bls12_381"
    for out in results:
        assert out["backend"] == ("nccl" if ranks == 1 else "gloo")
        assert ser.serialize_proof(out["proof"], curve).hex() == want["proof_bytes_hex"]
        for k in ("bucket_madd_rows", "masked_add"):
            for g in ("g1", "g2"):
                assert out["launches"][f"{k}{suffix}_{g}"] > 0, (k, g)
        assert out["launches"][f"ntt_pass{suffix}"] > 0 and out["launches"][f"field_ew{suffix}"] > 0


# ---------------------------------------------------------------------------
# the legacy device API (ops/curve_u32.py, msm_u32.py, ntt_u32.py,
# groth16/qap.py WitnessMapPlan, parallel/dist_msm.py, dist_ntt.py) and the
# reference's small-circuit prove composed from it
# ---------------------------------------------------------------------------

LEGACY_GROUPS = [(BN254, "g1"), (BN254, "g2"), (BLS12_381, "g1"), (BLS12_381, "g2")]


def _legacy_ops(curve, group, device):
    from snark_tpu_torch.ops.curve_u32 import get_g1_ops, get_g2_ops

    return (get_g1_ops if group == "g1" else get_g2_ops)(curve, device)


@pytest.mark.parametrize("curve,group", LEGACY_GROUPS,
                         ids=[f"{c.name}_{g}" for c, g in LEGACY_GROUPS])
def test_legacy_curve_ops_and_msm_match_cpu(cuda, curve, group):
    """`CurveOps`/`G2CurveOps` add (K2 `point_add`), double (K5),
    scalar_mul_const, and the legacy `msm`, `MsmPlan.window_sums` (K2
    `masked_add`, K18) and `FixedBasePlan` (G1) on the card equal the CPU
    plain versions limb for limb and the host; each kernel launched."""
    from snark_tpu_torch.fields.device import limbs16_encode
    from snark_tpu_torch.ops import msm_u32 as MU
    from snark_tpu_torch.ops.msm import scalars_to_digits

    hc = host_g1(curve) if group == "g1" else host_g2(curve)
    gpu, cpu = _legacy_ops(curve, group, cuda), _legacy_ops(curve, group, "cpu")
    rng = random.Random(9)
    pts = [hc.scalar_mul(hc.generator, rng.randrange(1, 2**40)) for _ in range(62)]
    pts += [None, hc.neg(pts[0])]
    p_cpu = cpu.pack_affine_host(pts)
    p_gpu = p_cpu.to(cuda)
    q_cpu = torch.roll(p_cpu, 3, 0)
    _native.reset_launches()
    for name, args in (("add", (p_gpu, q_cpu.to(cuda))), ("double", (p_gpu,))):
        got = getattr(gpu, name)(*args).cpu()
        assert torch.equal(got, getattr(cpu, name)(*(a.cpu() for a in args))), name
    assert torch.equal(gpu.scalar_mul_const(p_gpu, 2**70 + 3).cpu(),
                       cpu.scalar_mul_const(p_cpu, 2**70 + 3))
    r = curve.fr.modulus
    scalars = [rng.randrange(r) for _ in range(len(pts))]
    limbs = limbs16_encode(scalars, curve.fr)
    got = MU.msm(gpu, p_gpu, limbs, curve.fr.num_bits, c=5).cpu()
    assert torch.equal(got, MU.msm(cpu, p_cpu, limbs, curve.fr.num_bits, c=5))
    assert gpu.to_affine_host(got[None]) == [hc.msm(pts, scalars)]
    digits = scalars_to_digits(limbs, 6, curve.fr.num_bits)
    assert torch.equal(MU.MsmPlan(gpu, 6).window_sums(p_gpu, digits).cpu(),
                       MU.MsmPlan(cpu, 6).window_sums(p_cpu, digits))
    sfx = "" if curve is BN254 else f"_{curve.name}"
    want = {f"point_add{sfx}_{group}", f"point_double{sfx}_{group}", f"masked_add{sfx}_{group}",
            f"horner_combine{sfx}_{group}"}
    if group == "g1":
        plan = MU.FixedBasePlan(gpu, 4)
        table = plan.make_table(hc.generator, hc, curve.fr.num_bits, cpu.pack_affine_host)
        d = scalars_to_digits(limbs[:8], 4, curve.fr.num_bits)
        got = plan(table.to(cuda), d).cpu()
        assert torch.equal(got, MU.FixedBasePlan(cpu, 4)(table, d))
        assert gpu.to_affine_host(got) == [hc.scalar_mul(hc.generator, s) for s in scalars[:8]]
    assert all(_native.LAUNCHES[k] > 0 for k in want), _native.LAUNCHES


@pytest.mark.parametrize("curve", [BN254, BLS12_381], ids=["bn254", "bls12_381"])
def test_legacy_ntt_and_witness_map_on_k3(cuda, curve):
    """The legacy `NttPlan` at every n from 8 to 2^10 (one row, and a batch
    of three rows) runs on K3 and K4 and equals the CPU plain versions limb for limb
    in all four transforms; the legacy `WitnessMapPlan.h_from_evals` too."""
    from snark_tpu_torch.groth16 import WitnessMapPlan
    from snark_tpu_torch.ops.ntt_u32 import get_ntt_plan

    rng = random.Random(10)
    sfx = "" if curve is BN254 else f"_{curve.name}"
    for log_n in range(3, 11):
        n = 1 << log_n
        gpu, cpu = get_ntt_plan(curve.fr, n, device=cuda), get_ntt_plan(curve.fr, n, device="cpu")
        x = cpu.df.array([rng.randrange(curve.fr.modulus) for _ in range(3 * n)]).reshape(3, n, -1)
        _native.reset_launches()
        for name in ("fft", "ifft", "coset_fft", "coset_ifft"):
            assert torch.equal(getattr(gpu, name)(x.to(cuda)).cpu(), getattr(cpu, name)(x)), (n, name)
            assert torch.equal(getattr(gpu, name)(x[0].to(cuda)).cpu(), getattr(cpu, name)(x[0]))
        assert _native.LAUNCHES[f"ntt_pass{sfx}"] >= 4 and _native.LAUNCHES[f"field_ew{sfx}"] >= 3
    evals = [cpu.df.array([rng.randrange(curve.fr.modulus) for _ in range(64)]) for _ in range(3)]
    got = WitnessMapPlan(curve.fr, 64, cuda).h_from_evals(*(e.to(cuda) for e in evals))
    assert torch.equal(got.cpu(), WitnessMapPlan(curve.fr, 64, "cpu").h_from_evals(*evals))


@pytest.mark.parametrize("ranks", [1, 2])
def test_legacy_dist_msm_and_ntt(cuda, ranks):
    """`sharded_msm` and `DistNttPlan` in a world of `ranks` on the card
    (NCCL at one, gloo at two): every rank's total is the host MSM, the
    transforms' shards equal the one-device legacy plan's."""
    from snark_tpu_torch.parallel import dist_msm as DM
    from snark_tpu_torch.parallel import dist_ntt as DN
    from snark_tpu_torch.parallel.launch import run_each, run_ranks
    from snark_tpu_torch.fields.device import limbs16_encode
    from snark_tpu_torch.ops.msm import scalars_to_digits
    from snark_tpu_torch.ops.ntt_u32 import get_ntt_plan

    hc, ops = host_g1(BN254), _legacy_ops(BN254, "g1", "cpu")
    rng = random.Random(11)
    pts = [hc.scalar_mul(hc.generator, rng.randrange(1, 2**30)) for _ in range(256)]
    scalars = [rng.randrange(R) for _ in range(256)]
    digits = scalars_to_digits(limbs16_encode(scalars, BN254.fr), 6, 254)
    plan = get_ntt_plan(BN254.fr, 1 << 10, device="cpu")
    x = plan.df.array(rand(1 << 10, 12))
    res = run_ranks(run_each, ranks, "cuda",
                    (DM.dist_sharded_msm, (ops.to_numpy(ops.pack_affine_host(pts)), digits, 6,
                                           "g1", "bn254", "cuda")),
                    (DN.dist_legacy_transforms, (x.numpy(), 32, 32, "bn254", "cuda")),
                    timeout_s=300)
    want = hc.msm(pts, scalars)
    for total, _ in res:
        assert ops.to_affine_host(total[None]) == [want]
    shards = {k: torch.as_tensor(np.concatenate([r[1][k] for r in res])) for k in res[0][1]}
    assert torch.equal(shards["fft"], plan.fft(x))
    assert torch.equal(shards["coset_fft"], plan.coset_fft(x))
    assert torch.equal(shards["ifft"], x) and torch.equal(shards["coset_ifft"], x)


def test_prove_small_legacy_api_on_card(cuda):
    """The reference's small-circuit prove composed from the legacy API on
    the card (`tests/test_torch_prove_small.py` `check_legacy_proof`): the
    vector's circuit gives the vector's bytes, the BLS12-381 m = 26
    fixture its committed proof, each with the plane prove's sums and h."""
    from test_torch_prove_small import check_legacy_proof

    with open(os.path.join(VECTORS, "proof_bn254.json")) as f:
        vector = json.load(f)
    g16 = Groth16(BN254, device=cuda)
    pk, _ = g16.circuit_specific_setup(MulChainCircuit(seed=11, n=8, batch=False),
                                       random.Random(int(vector["setup_seed"])))
    check_legacy_proof(g16, pk, MulChainCircuit(seed=11, n=8), vector, BN254)
    with open(os.path.join(VECTORS, "torch_proof_bls12_381_mulchain12.json")) as f:
        want_bls = json.load(f)
    check_legacy_proof(Groth16(BLS12_381, device=cuda),
                       ProvingKey.load(os.path.join(VECTORS, "torch_pk_bls12_381_mulchain12.npz"),
                                       cuda),
                       MulChainCircuit(seed=7, n=12), want_bls, BLS12_381)


def test_entry_on_card_equals_cpu(cuda):
    """The single-device entry (`snark_tpu_torch/entry.py`): its core on the
    card gives the five sums of its core on the CPU (the plain versions), as
    affine points; its outputs stay on the card."""
    from snark_tpu_torch.entry import entry, sums

    fn, args = entry()
    g1, g2 = fn(*args)
    assert g1.device.type == "cuda" and g2.device.type == "cuda"
    fn_cpu, args_cpu = entry("cpu")
    assert args == args_cpu
    assert sums(g1, g2) == sums(*fn_cpu(*args_cpu))
