"""The port's reduce-parts slice against the JAX package: the band-product
backend of `PlaneFieldV3.reduce` and `mont_mul`
(`snark_tpu_torch/ops/plane_field_v3.py`) against
`snark_tpu/ops/pallas_field_v3.py`, the plain version of K16
(`snark_tpu_torch/ops/mul_parts.py`, which the wrapper runs on CPU
tensors) against the kernels of `scripts/bench_reduce_parts.py`,
recomposed here from the script's `main()` (where they are closures) and
run through `pl.pallas_call(..., interpret=True)`, K16 A's tensor-core
fragments against the band matrices, and `bench_reduce_parts.run` on the
CPU.

The script's variant A passes `plus_p` twice
(`scripts/bench_reduce_parts.py:84-86`) and raises a TypeError; it is
recomposed here as the call it means, `pf.mont_mul(A, B, t_ref, carry,
plus_p=p2, m_np=mnp_ref[...], m_p=mp_ref[...])`, with bf16 band refs.

Inputs come from numpy seeds and go to both packages; 2048 lanes, so that
T = 2048 is one grid step. Every comparison is exact: every term is an
integer below 2^24 and every band-product factor a bf16-exact digit.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops import pallas_field_v3 as J

from snark_tpu_torch import _native
from snark_tpu_torch import bench_reduce_parts as BR
from snark_tpu_torch.ops import mul_parts as MP
from snark_tpu_torch.ops import plane_field_v3 as T
from snark_tpu_torch.ops import vpu_peak as V

F32 = jnp.float32
LANES = 2048


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads: the suite runs files in parallel processes, and
    the plain versions' many small ops stall when every process spins up a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class Ref:
    """A scratch ref for the JAX plane ops outside a kernel: loads copy."""

    def __init__(self, shape):
        self.a = np.zeros(shape, np.float32)
        self.shape = shape

    def __getitem__(self, k):
        return jnp.array(self.a[k])

    def __setitem__(self, k, v):
        self.a[k] = np.asarray(v)


def port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def field_values(n: int, seed: int) -> list[int]:
    p = J_BN254.fq.modulus
    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]


def lazy_inputs(n: int, seed: int):
    """Montgomery digit planes of seeded values: a lazy (digits up to 510,
    value a + 2p), b canonical."""
    pf = V.plane_field()
    va, vb = field_values(n, seed), field_values(n, seed + 1)
    return va, vb, pf.pack_np(va) + pf.P2_COL, pf.pack_np(vb)


def script_run(kind: str, tile: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """`make_run(kind, T).run` of scripts/bench_reduce_parts.py, its kernel
    and pallas_call as there, in interpret mode (variant A as the keyword
    call; the script's 8-deep Python loop rolled into a `fori_loop`, which
    computes the same steps and compiles its body once)."""
    pf = J.get_plane_field_v3(J_BN254.fq, 2)
    R8 = pf.R8
    np_digits = [float((pf.n_prime_eff >> (8 * i)) & 0xFF) for i in range(R8)]
    p_digits = [float((pf.params.modulus >> (8 * i)) & 0xFF) for i in range(R8)]

    def reduce_vpu(t, carry, p2):
        tlo = J.sweep3(t[:R8])
        m = np_digits[0] * tlo
        for i in range(1, R8):
            m = m.at[i:, :].add(np_digits[i] * tlo[: R8 - i, :])
        m = J.sweep3(m)
        mp_full = jnp.zeros_like(t)
        for i in range(R8):
            mp_full = mp_full.at[i : i + R8, :].add(p_digits[i] * m)
        s = t + mp_full
        c = jnp.round(jnp.sum(s[:R8] * carry, axis=0, keepdims=True))
        hi = s[R8:]
        out = jnp.concatenate([hi[:1] + c, hi[1:]], axis=0)
        return J.sweep3(out + p2)

    def kernel(mnp_ref, mp_ref, cols_ref, a_ref, b_ref, o_ref, t_ref):
        B = b_ref[...]
        carry = cols_ref[0, :][:, None]
        p2 = cols_ref[1, :][:, None]

        def step(_, A):
            if kind == "A":
                A = pf.mont_mul(A, B, t_ref, carry, plus_p=p2, m_np=mnp_ref[...], m_p=mp_ref[...])
            elif kind == "B":
                pf.mul_acc(A, B, t_ref)
                t = t_ref[...]
                x = J.sweep3(t[:R8])
                x = J.sweep3(x)
                A = J.sweep3(x + p2)
            elif kind == "C":
                pf.mul_acc(A, B, t_ref)
                A = reduce_vpu(t_ref[...], carry, p2)
            return A

        o_ref[...] = jax.lax.fori_loop(0, MP.REPS, step, a_ref[...])

    mnp_c = jnp.asarray(pf.M_NP).astype(J.BF16)
    mp_c = jnp.asarray(pf.M_P).astype(J.BF16)
    cols = jnp.asarray(np.concatenate([pf.CARRY_SCALE, pf.P2_COL], axis=1).T)
    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((R8, LANES), F32),
        grid=(LANES // tile,),
        in_specs=[
            pl.BlockSpec((R8, R8), lambda i: (0, 0)),
            pl.BlockSpec((2 * R8, R8), lambda i: (0, 0)),
            pl.BlockSpec((2, R8), lambda i: (0, 0)),
            pl.BlockSpec((R8, tile), lambda i: (0, i)),
            pl.BlockSpec((R8, tile), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((R8, tile), lambda i: (0, i)),
        scratch_shapes=[pltpu.VMEM((2 * R8, tile), F32)],
        interpret=True,
    )(mnp_c, mp_c, cols, jnp.asarray(a), jnp.asarray(b)))


def test_band_backend_matches_jax():
    """`reduce` and `mont_mul` with the band matrices against the JAX band
    backend (bf16 refs), digit for digit, equal to the scalar backend and
    to the host field; the band product refuses a digit that bf16 would
    round."""
    jpf, pf = J.get_plane_field_v3(J_BN254.fq, 2), V.plane_field()
    R8, n, p = pf.R8, 96, J_BN254.fq.modulus
    va, vb, a, b = lazy_inputs(n, 7)
    mnp, mp = jnp.asarray(jpf.M_NP).astype(J.BF16), jnp.asarray(jpf.M_P).astype(J.BF16)
    carry, p2 = jnp.asarray(jpf.CARRY_SCALE), jnp.asarray(jpf.P2_COL)
    ref = Ref((2 * R8, n))
    jpf.mul_acc(jnp.asarray(a), jnp.asarray(b), ref)
    t = pf.mul_acc(port(a), port(b))
    assert np.array_equal(t.numpy(), ref.a)
    # a copy: the band backend does not write the scratch ref, but the
    # product is still read while the ref is live
    jred = np.asarray(jpf.reduce(jnp.array(ref.a), ref, carry, p2, mnp, mp))
    red = pf.reduce(t, pf.CARRY_SCALE, pf.P2_COL, pf.M_NP, pf.M_P)
    assert np.array_equal(red.numpy(), jred)
    assert torch.equal(red, pf.reduce(t, pf.CARRY_SCALE, pf.P2_COL))
    jmm = np.asarray(jpf.mont_mul(jnp.asarray(a), jnp.asarray(b), ref, carry, plus_p=p2,
                                  m_np=mnp, m_p=mp))
    mm = pf.mont_mul(port(a), port(b), pf.CARRY_SCALE, plus_p=pf.P2_COL, m_np=pf.M_NP,
                     m_p=pf.M_P)
    assert np.array_equal(mm.numpy(), jmm)
    assert pf.unpack_np(mm) == [x * y % p for x, y in zip(va, vb)]
    assert float(mm.min()) >= 0 and float(mm.max()) <= 256
    with pytest.raises(AssertionError):
        T.band_mm(pf.M_NP, torch.full((R8, 4), 257.0))


def test_band_fragments_hold_the_band_matrices():
    """K16 A's A fragments, read back by the m16n8k16 layout of the PTX ISA
    (lane 4g + q; register j holds row g + 8(j & 1), columns 2q + 8(j >> 1)
    and + 1, the lower in the low half), are M_NP padded to (48, 48) and
    M_P padded to (80, 48), every entry once; the tiles the kernel runs
    are those that hold a digit on the rows it reads: 6 of M_NP's 9, 8 of
    M_P's 15 (rows 22 and up), 4 mma each."""
    pf = V.plane_field()
    frags = MP.band_fragments()
    assert frags.shape == (24, 32, 4) and frags.dtype == np.uint32

    def bf16(bits):
        return np.array([bits << 16], np.uint32).view(np.float32)[0]

    tile = iter(frags)
    live = []
    for M, rows in ((pf.M_NP, MP.NP_ROWS_PAD), (pf.M_P, MP.P_ROWS_PAD)):
        got = np.full((rows, MP.K_PAD), np.nan, np.float32)
        for mt, kt in itertools.product(range(rows // 16), range(MP.K_PAD // 16)):
            f = next(tile)
            for lane, j in itertools.product(range(32), range(4)):
                g, q = divmod(lane, 4)
                r, c = 16 * mt + g + 8 * (j & 1), 16 * kt + 2 * q + 8 * (j >> 1)
                assert np.isnan(got[r, c : c + 2]).all()
                got[r, c], got[r, c + 1] = bf16(f[lane, j] & 0xFFFF), bf16(f[lane, j] >> 16)
        want = np.zeros_like(got)
        want[: M.shape[0], : M.shape[1]] = M
        assert np.array_equal(got, want)
        low = 0 if rows == MP.NP_ROWS_PAD else pf.R8 - T._CARRY_ROWS
        live.append(sum(bool(want[max(16 * mt, low) : 16 * mt + 16, 16 * kt : 16 * kt + 16].any())
                        for mt, kt in itertools.product(range(rows // 16), range(3))))
    assert live == [6, 8]


def test_variants_match_the_script_kernels():
    """K16's plain version, A, B and C at T = 512 and 2048 and the script's
    depth 8, against the script's kernel digit for digit, on lazy seeded
    inputs."""
    _, _, a, b = lazy_inputs(LANES // 8, 11)
    a, b = np.tile(a, (1, 8)), np.tile(b, (1, 8))
    for kind, tile in BR.LINES + (("B", 2048),):
        got = MP.reduce_parts_chain(port(a), port(b), kind, tile)
        assert np.array_equal(got.numpy(), script_run(kind, tile, a, b)), (kind, tile)


def test_a_equals_c_equals_k15_and_the_host():
    """The script's own check, C == A, extended: at depth 8, A and C equal
    K15's plain chain and a·b^8 on the host; B's values mod R = 256^R8 equal
    the recurrence v <- v·b + 2p."""
    pf = V.plane_field()
    p = J_BN254.fq.modulus
    va, vb, a, b = lazy_inputs(512, 13)
    a, b = port(a), port(b)
    A = MP.reduce_parts_chain(a, b, "A", 512)
    assert torch.equal(A, MP.reduce_parts_chain(a, b, "C", 512))
    assert torch.equal(A, V.mont_mul_chain_plain(a, b, MP.REPS))
    assert pf.unpack_np(A) == [x * pow(y, MP.REPS, p) % p for x, y in zip(va, vb)]
    B = MP.reduce_parts_chain(a, b, "B", 512)
    assert BR.values_mod_r(B) == BR.skeleton_oracle(a, b, MP.REPS)


def test_bench_runs_on_the_cpu():
    """All five lines correct through the plain versions, no kernel
    launched, nothing timed; the work counts; the wrapper refuses what the
    kernel does not take, and the entry point refuses to run without a
    card."""
    _native.reset_launches()
    res = BR.run(lanes=LANES, device="cpu")
    assert res["correct"] and res["device"] == "cpu"
    assert [(rec["kind"], rec["T"]) for rec in res["lines"]] == list(BR.LINES)
    for rec in res["lines"]:
        assert rec["correct"] and rec["ms"] is None and rec["bound_ms"] > 0, rec
    assert not any(_native.LAUNCHES.values())
    assert {f"reduce_parts_chain_{k}_{t}" for k in MP.PARTS_KINDS for t in MP.PARTS_T} <= set(
        _native.LAUNCHES)
    assert [MP.parts_ops(k) for k in "ABC"] == [2463, 1842, V.mont_mul_ops()]
    assert MP.parts_mma_macs("A") == 3468 and MP.parts_mma_macs("C") == 0
    z = torch.zeros((V.ROWS, 1024))
    with pytest.raises(ValueError):
        MP.reduce_parts_chain(z, z, "D", 512)
    with pytest.raises(ValueError):
        MP.reduce_parts_chain(z, z, "A", 1024)
    with pytest.raises(ValueError):
        MP.reduce_parts_chain(z, z, "A", 2048)  # lanes not a multiple of T
    with pytest.raises(ValueError):
        BR.run(lanes=1024, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            BR.main(["2048"])
