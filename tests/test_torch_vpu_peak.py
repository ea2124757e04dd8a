"""The port's roofline slice against the JAX package: `PlaneFieldV3`
(`snark_tpu_torch/ops/plane_field_v3.py`) against
`snark_tpu/ops/pallas_field_v3.py`, the plain versions of K12-K15
(`snark_tpu_torch/ops/vpu_peak.py`, which the wrappers run on CPU tensors)
against the kernels of `scripts/bench_vpu_peak.py`, recomposed here from
the script's `main()` (where they are closures) and run through
`pl.pallas_call(..., interpret=True)`, and `bench_vpu_peak.run` on the CPU.

Inputs come from numpy seeds and go to both packages.

Tolerances:
- exact for every integer-digit function (sweeps, products, reductions,
  the sweep chain, the mont_mul chain): every term is an integer below
  2^24, so no step rounds;
- the FMA chain within rtol 1e-4: the port's plain version rounds the
  product and the sum (K12 fuses them on the card), XLA may fuse or not,
  and values grow to about 257 over 256 steps;
- the conv chain within rtol 1e-5 at depths 1 and 4, where every value is
  normal (summation order and FMA fusion), and within atol 2^-126 at the
  script's depth 8: there every value has fallen below 2^-126, JAX on the
  CPU flushes such values to zero, and the port keeps them subnormal. So
  at depth 8 the port is also held, within rtol 1e-4 plus 8·2^-149, to a
  numpy float32 recurrence that keeps subnormals, the tolerance the card
  holds K14 to.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from snark_tpu.fields import BLS12_381 as J_BLS12_381
from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops import pallas_field_v3 as J

from snark_tpu_torch import _native
from snark_tpu_torch import bench_vpu_peak as BV
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.ops import plane_field_v3 as T
from snark_tpu_torch.ops import vpu_peak as V

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = jnp.float32
LANES = 1024
TILE = 512  # the script's BENCH_TILE
JAX_FLUSH_ATOL = 2.0**-126  # JAX on the CPU flushes values below it to zero


class Ref:
    """A scratch ref for the JAX plane ops outside a kernel: loads copy."""

    def __init__(self, shape):
        self.a = np.zeros(shape, np.float32)
        self.shape = shape

    def __getitem__(self, k):
        return jnp.array(self.a[k])

    def __setitem__(self, k, v):
        self.a[k] = np.asarray(v)


def pallas(kernel, out_rows, *args, scratch=False):
    """The script's pallas_call: (rows, TILE) blocks on a grid over lanes,
    an optional (2R8, TILE) VMEM scratch, in interpret mode. A leading
    (R8, 2) constant block is passed whole."""
    R8 = args[-1].shape[0]
    specs = [pl.BlockSpec((a.shape[0], TILE), lambda i: (0, i)) if a.shape[1] == LANES
             else pl.BlockSpec(a.shape, lambda i: (0, 0)) for a in args]
    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((out_rows, LANES), F32),
        grid=(LANES // TILE,),
        in_specs=specs,
        out_specs=pl.BlockSpec((out_rows, TILE), lambda i: (0, i)),
        scratch_shapes=[pltpu.VMEM((2 * R8, TILE), F32)] if scratch else [],
        interpret=True,
    )(*(jnp.asarray(a) for a in args)))


def port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def cuda_digits(name: str) -> list[float]:
    """A digit table of `Bn254Fq34` in csrc/plane_v3.cuh (K15-K17's)."""
    with open(os.path.join(ROOT, "snark_tpu_torch", "csrc", "plane_v3.cuh")) as f:
        src = f.read()
    block = src[src.index(f"static constexpr float {name}(int i)"):]
    body = re.search(r"\{([^}]*)\}", block[block.index("d[34] = ") :]).group(1)
    return [float(x) for x in body.replace("\n", " ").split(",")]


def test_plane_field_matches_jax():
    """Constants of both base fields with extra = 2; on BN254 Fq (the
    slice's field) sweep3, mul_acc, reduce, mont_mul and the codecs, digit
    for digit; the kernel's compiled-in digits equal the port's."""
    for jparams, params in ((J_BN254.fq, BN254.fq), (J_BLS12_381.fq, BLS12_381.fq)):
        jpf, tpf = J.get_plane_field_v3(jparams, 2), T.get_plane_field_v3(params, 2)
        assert tpf.R8 == jpf.R8 == 2 * params.num_limbs + 2
        for k in ("r_eff", "n_prime_eff", "NP_DIGITS", "P_DIGITS"):
            assert getattr(tpf, k) == getattr(jpf, k), k
        for k in ("P_COL", "P2_COL", "M_NP", "M_P", "CARRY_SCALE"):
            assert np.array_equal(getattr(tpf, k), getattr(jpf, k)), k

    jpf, tpf = J.get_plane_field_v3(J_BN254.fq, 2), V.plane_field()
    R8, n, p = tpf.R8, 96, BN254.fq.modulus
    rng = np.random.RandomState(3)
    z = rng.randint(-(1 << 22), 1 << 22, (R8, n)).astype(np.float32)
    assert np.array_equal(T.sweep3(port(z)).numpy(), np.asarray(J.sweep3(jnp.asarray(z))))
    va = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
    vb = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
    a = tpf.pack_np(va) + tpf.P2_COL  # lazy: digits up to 510, value a + 2p
    b = tpf.pack_np(vb)
    assert np.array_equal(a - tpf.P2_COL, jpf.pack_np(va))
    assert tpf.unpack_np(a) == va and tpf.unpack_np(port(b)) == vb
    ref = Ref((2 * R8, n))
    jpf.mul_acc(jnp.asarray(a), jnp.asarray(b), ref)
    t = tpf.mul_acc(port(a), port(b))
    assert np.array_equal(t.numpy(), ref.a)
    # a copy: the scratch ref is written while the product is still read
    jred = jpf.reduce(jnp.array(ref.a), ref, jnp.asarray(jpf.CARRY_SCALE), jnp.asarray(jpf.P_COL))
    assert np.array_equal(tpf.reduce(t, tpf.CARRY_SCALE, tpf.P_COL).numpy(), np.asarray(jred))
    jmm = np.asarray(jpf.mont_mul(jnp.asarray(a), jnp.asarray(b), ref, jnp.asarray(jpf.CARRY_SCALE)))
    mm = tpf.mont_mul(port(a), port(b), tpf.CARRY_SCALE)
    assert np.array_equal(mm.numpy(), jmm)
    assert tpf.unpack_np(mm) == [x * y % p for x, y in zip(va, vb)]
    assert tpf.unpack_np(mm, mont=False) == [x * y * tpf.r_eff % p for x, y in zip(va, vb)]
    assert cuda_digits("np") == list(tpf.NP_DIGITS)
    assert cuda_digits("p") == list(tpf.P_DIGITS)
    assert cuda_digits("p2") == [float(x) for x in tpf.P2_COL[:, 0]]


def test_fma_and_sweep_chains_match_the_script_kernels():
    """K12's and K13's plain versions against the script's fma_kernel and
    sweep_kernel at its depths (256, 64)."""
    a, b = BV.float_inputs(LANES, 11)
    reps_fma, reps_sw = BV.REPS["fma"], BV.REPS["sweep"]

    def fma_kernel(a_ref, b_ref, o_ref):
        a = a_ref[...]
        b = b_ref[...]
        acc = a
        for _ in range(reps_fma):
            acc = acc * b + a
        o_ref[...] = acc

    def sweep_kernel(a_ref, o_ref):
        z = a_ref[...]
        for _ in range(reps_sw):
            z = J._sweep(z) + 1.0
        o_ref[...] = z

    got = V.fma_chain(port(a), port(b), reps_fma).numpy()
    want = pallas(fma_kernel, V.ROWS, a, b)
    np.testing.assert_allclose(got, want, rtol=BV.FMA_RTOL, atol=0)
    assert float(want.max()) > 200  # the chain ran its depth
    got = V.sweep_chain(port(a), reps_sw).numpy()
    assert np.array_equal(got, pallas(sweep_kernel, V.ROWS, a))
    assert np.array_equal(got, BV.host_sweep(a, reps_sw))


def test_conv_chain_matches_the_script_kernel():
    """K14's plain version against the script's conv_kernel at depths 1, 4
    and the script's 8, and at 8 against a float32 recurrence that keeps
    subnormals."""
    a, b = BV.float_inputs(LANES, 12)
    pf = J.get_plane_field_v3(J_BN254.fq, 2)
    R8 = pf.R8
    for reps in (1, 4, BV.REPS["conv"]):

        def conv_kernel(a_ref, b_ref, o_ref, t_ref, reps=reps):
            A = a_ref[...]
            B = b_ref[...]
            for _ in range(reps):
                pf.mul_acc(A, B, t_ref)
                A = t_ref[0:R8, :] * 1e-7
            o_ref[...] = t_ref[...]

        want = pallas(conv_kernel, 2 * R8, a, b, scratch=True)
        got = V.conv_chain(port(a), port(b), reps).numpy()
        if reps <= 5:
            assert float(np.abs(want).min(where=want != 0, initial=1.0)) >= 2.0**-126
            np.testing.assert_allclose(got, want, rtol=BV.CONV_RTOL, atol=0)
        else:
            assert 2.0**-140 < float(np.abs(got).max()) < 2.0**-126  # all subnormal, kept
            np.testing.assert_allclose(got, want, rtol=0, atol=JAX_FLUSH_ATOL)
            np.testing.assert_allclose(got, BV.host_conv(a, b, reps, np.float32),
                                       rtol=BV.CONV_RTOL_DEEP, atol=BV.CONV_ATOL_DEEP)


def test_mont_mul_chain_matches_the_script_kernel():
    """K15's plain version against the script's mm_kernel at 3 reps (the
    card runs 32), digit for digit, and against the host field."""
    reps = 3
    jpf = J.get_plane_field_v3(J_BN254.fq, 2)
    pf = V.plane_field()
    va, vb = BV.mont_values()
    am, bm = (np.tile(pf.pack_np(v), (1, LANES // BV.PAIRS)) for v in (va, vb))
    cols = np.concatenate([jpf.CARRY_SCALE, jpf.P2_COL], axis=1)

    def mm_kernel(cols_ref, a_ref, b_ref, o_ref, t_ref):
        A = a_ref[...]
        B = b_ref[...]
        carry = cols_ref[:, 0:1]
        p2 = cols_ref[:, 1:2]
        for _ in range(reps):
            A = jpf.mont_mul(A, B, t_ref, carry, plus_p=p2)
        o_ref[...] = A

    want = pallas(mm_kernel, pf.R8, cols, am, bm, scratch=True)
    got = V.mont_mul_chain(port(am), port(bm), reps)
    assert np.array_equal(got.numpy(), want)
    assert pf.unpack_np(got[:, : BV.PAIRS]) == BV.mont_oracle(reps)
    assert float(got.max()) <= 256 and float(got.min()) >= 0


def test_bench_runs_on_the_cpu():
    """All five lines correct through the plain versions, no kernel
    launched, nothing timed; the wrappers refuse what the kernels do not
    take, and the entry point refuses to run without a card."""
    _native.reset_launches()
    res = BV.run(lanes=512, device="cpu")
    assert res["correct"] and res["device"] == "cpu"
    assert [rec["line"] for rec in res["lines"]] == ["fma", "sweep", "conv", "mont_mul", "madd"]
    for rec in res["lines"]:
        assert rec["correct"] and rec["ms"] is None and rec["bound_ms"] > 0, rec
    assert not any(_native.LAUNCHES.values())
    assert V.mont_mul_ops() == 3847
    z = torch.zeros((V.ROWS, 64))
    with pytest.raises(ValueError):
        V.sweep_chain(z.double(), 1)
    with pytest.raises(ValueError):
        V.fma_chain(z, torch.zeros((V.ROWS, 32)), 1)
    with pytest.raises(ValueError):
        V.conv_chain(z, z, 1, threads=512)
    with pytest.raises(ValueError):
        V.conv_chain(z, z, 0)
    with pytest.raises(ValueError):
        V.mont_mul_chain(torch.zeros((50, 64)), torch.zeros((50, 64)), 1)
    with pytest.raises(ValueError):
        BV.run(lanes=300, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            BV.main(["256"])
