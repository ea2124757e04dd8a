"""K1's parts (`snark_tpu_torch/ops/madd_parts.py`) against the JAX rows
kernel `make_masked_mixed_add_rows` (interpret mode) built with the bodies
that `scripts/bench_madd_parts.py` swaps in, and the port's
`bench_madd_parts` on the CPU.

The parts compute field formulas, most of them no group law, so points are
compared as their projective (X, Y, Z) values mod q, not after
normalisation: those values do not depend on the representation (the
JAX digit planes against the port's limbs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops import pallas_curve
from snark_tpu.ops.curve_host import host_g1 as j_host_g1
from snark_tpu.ops.pallas_curve import (
    get_plane_curve,
    make_masked_mixed_add_rows,
    pack_points_host,
    pack_rows_u8_host,
    rows_pad_width,
)

from snark_tpu_torch import bench as B
from snark_tpu_torch import bench_madd_parts as BM
from snark_tpu_torch.fields.limbs import fields_of
from snark_tpu_torch.ops import curve as C
from snark_tpu_torch.ops import madd_parts as MP
from test_torch_curve import complete_cases

HC = j_host_g1(J_BN254)
LANES = 128
STEPS = 2
REAL_BODY = pallas_curve._madd_mixed_body


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# the script's variant bodies, copied from scripts/bench_madd_parts.py:73-100


def body_nosub(F, P, Q):
    X1, Y1, Z1 = P
    X2, Y2 = Q
    a = F.mul(X1, X2)
    b = F.mul(Y1, Y2)
    d = F.mul(Y2, Z1)
    e = F.mul(X2, Z1)
    m4 = F.mul(F.add(X1, Y1), F.add(X2, Y2))
    i = F.cmul_b3(Z1)
    j = F.cmul_b3(F.norm(F.add(e, X1)))
    x3 = F.mul_pair(a, b, d, j, sign2=-1.0)
    y3 = F.mul_pair(b, i, j, a)
    z3 = F.mul_pair(i, d, a, m4)
    return x3, y3, z3


def body_halfmul(F, P, Q):
    X1, Y1, Z1 = P
    X2, Y2 = Q
    a = F.mul(X1, X2)
    b = F.mul(Y1, Y2)
    m4 = F.mul(F.add(X1, Y1), F.add(X2, Y2))
    i = F.cmul_b3(Z1)
    x3 = F.mul_pair(a, b, m4, i, sign2=-1.0)
    return x3, F.norm(F.add(b, i)), F.norm(F.add(a, i))


def body_nodecode(F, P, Q):
    X1, Y1, Z1 = P
    return REAL_BODY(F, P, (F.norm(Z1), F.norm(Y1)))


BODIES = {"full": REAL_BODY, "nosub": body_nosub, "halfmul": body_halfmul,
          "nodecode": body_nodecode}


def scan_case():
    """128 lanes, two chained steps: the complete cases of
    tests/test_torch_curve.py as accumulators and first rows (identity
    accumulators and rows, P + (−P), P + P), random second rows with
    identities among them, random signs, and runs of 0, 1 or 2 rows."""
    P, Q = complete_cases(HC, LANES, 5)
    rng = np.random.RandomState(6)
    pool = [HC.scalar_mul(HC.generator, int(k) + 2) for k in rng.randint(1, 1 << 30, 8)]
    Q2 = [None if rng.rand() < 0.1 else pool[rng.randint(8)] for _ in range(LANES)]
    sign = rng.rand(STEPS, LANES) < 0.5
    sign[0, :10] = False
    length = rng.randint(0, STEPS + 1, LANES)
    length[:10] = STEPS
    return P, [Q, Q2], sign, length


def jax_values(part, batched, monkeypatch, P, Qs, sign, length):
    """The JAX rows kernel, STEPS deep, with the script's body for `part`
    under SNARK_TPU_MSM_BATCHED -> [X, Y, Z] value lists."""
    monkeypatch.setenv("SNARK_TPU_MSM_BATCHED", "1" if batched else "0")
    monkeypatch.setattr(pallas_curve, "_madd_mixed_body", BODIES[part])
    pc = get_plane_curve(J_BN254)
    w = rows_pad_width(J_BN254, "g1")
    rows = [pack_rows_u8_host(pc, Q, "g1") for Q in Qs]
    rows = [np.pad(r, ((0, 0), (0, w - r.shape[1]))) for r in rows]
    active = np.stack([length > k for k in range(STEPS)])
    planes = np.concatenate([active, sign]).astype(np.float32)
    kern = make_masked_mixed_add_rows(J_BN254, tile=LANES, interpret=True, group="g1",
                                      k_steps=STEPS)
    out = kern(*pack_points_host(pc, P, "g1"), jnp.asarray(np.concatenate(rows, axis=1)),
               jnp.asarray(planes))
    return [pc.pf.unpack_np(np.asarray(o)) for o in out]


def port_values(part, P, Qs, sign, length):
    """The port's plain part over the same runs -> [X, Y, Z] value lists."""
    table = torch.as_tensor(np.concatenate([C.pack_rows_u8(Q, "g1") for Q in Qs]))
    idx = np.arange(STEPS)[:, None] * LANES + np.arange(LANES)[None, :]  # row of (step, lane)
    perm = torch.as_tensor((idx | (sign.astype(np.int64) << 31)).T.reshape(-1)).to(torch.int32)
    out = MP.bucket_madd_rows_part(
        part, C.points_to_limbs(P, "g1", "cpu"), table, perm, torch.zeros(LANES, dtype=torch.int32),
        torch.arange(LANES, dtype=torch.int32) * STEPS, torch.as_tensor(length, dtype=torch.int32),
        0, STEPS,
    )
    vals = fields_of(C.BN254)[1].decode(out.reshape(-1, C.limbs_of()))
    return [vals[k::3] for k in range(3)]


@pytest.mark.parametrize("part", MP.PARTS)
def test_part_matches_jax_rows_kernel(part, monkeypatch):
    """Each plain part equals the JAX rows kernel with the script's body,
    value for value, under SNARK_TPU_MSM_BATCHED=0 (the script's bodies run
    only there). nosub also pins the reference's fault: under the default
    SNARK_TPU_MSM_BATCHED=1 the G1 rows kernel never calls the swapped
    body, and its nosub build gives the shipped sums."""
    case = scan_case()
    got = port_values(part, *case)
    assert got == jax_values(part, False, monkeypatch, *case)
    if part == "full":  # and the values are the group law's
        P, Qs, sign, length = case
        want = []
        for l, p in enumerate(P):
            for k in range(length[l]):
                q = Qs[k][l]
                p = HC.add(p, HC.neg(q) if sign[k, l] else q)
            want.append(p)
        q = fields_of(C.BN254)[1].p
        aff = [None if z == 0 else (x * pow(z, -1, q) % q, y * pow(z, -1, q) % q)
               for x, y, z in zip(*got)]
        assert aff == want
    if part == "nosub":
        assert jax_values(part, True, monkeypatch, *case) == port_values("full", *case)


def test_bench_runs_on_the_cpu():
    """The bench's seven lines through the plain versions: the three
    without a counterpart say why, `full` equals the pool oracle. c = 8
    (4,096 lanes) keeps the plain folds to seconds."""
    res = BM.run(inputs=B.make_inputs(10, signed=True, c=8, device="cpu"))
    lines = {rec["line"]: rec for rec in res["lines"]}
    assert tuple(lines) == BM.LINES
    assert res["correct"] and lines["full"]["correct"] is True
    for line in ("sweep2", "sweep1", "vpu"):
        assert lines[line]["counterpart"] is None and lines[line]["reason"]
    for line in ("nosub", "halfmul", "nodecode"):
        rec = lines[line]
        assert rec["counterpart"] == f"bucket_madd_rows_part_{line}"
        assert rec["correct"] is None and rec["note"] == "wrong math by design"
        assert rec["scan_adds"] == lines["full"]["scan_adds"] > 0
    assert lines["halfmul"]["bound_ms"] < lines["nosub"]["bound_ms"] == lines["full"]["bound_ms"]
