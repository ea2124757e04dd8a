"""The port's bisect slice against the JAX package: the plain version of
K17 (`snark_tpu_torch/ops/mul_parts.py`, which the wrapper runs on CPU
tensors) against the kernels of `scripts/bench_bisect_mul.py`, recomposed
here from the script's `main()` (where they are closures) and run through
`pl.pallas_call(..., interpret=True)`, and `bench_bisect_mul.run` on the
CPU. Inputs come from numpy seeds (Montgomery digit planes of BN254 Fq,
R8 = 34) and go to both packages; 1024 lanes, T = 512.

Tolerances:
- exact for conv3, conv9, sweep9 and convreg at the script's depth 8:
  every value is an integer below 2^24, so no step rounds; convreg equals
  conv3;
- conv1 exact at depth 2, where every sum is still below 2^24; at depth 8
  its values exceed 2^24 and round, and it equals a numpy float32
  recurrence in the same order (each product and sum rounded) bit for bit.
  It does not equal JAX's kernel there: XLA on the CPU rounds the sums
  beyond 2^24 otherwise (fused or reordered), so it is not compared;
- conv0 at depth 8 within rtol 1e-5 of JAX's kernel, plus atol 2^-126: its
  smallest values fall below 2^-126 by then, which JAX on the CPU flushes
  to zero and the port keeps; it equals the numpy float32
  recurrence, subnormals kept, bit for bit.
"""

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
from snark_tpu_torch import bench_bisect_mul as BB
from snark_tpu_torch.bench_reduce_parts import values_mod_r
from snark_tpu_torch.ops import mul_parts as MP
from snark_tpu_torch.ops import vpu_peak as V

F32 = jnp.float32
LANES = 1024
TILE = MP.BISECT_T
JAX_FLUSH_ATOL = 2.0**-126  # JAX on the CPU flushes values below it to zero
CONV0_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two torch threads: the suite runs files in parallel processes, and
    the plain versions' many small ops stall when every process spins up a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def mont_inputs(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Montgomery digit planes of seeded BN254 Fq values, 128 pairs tiled."""
    pf = V.plane_field()
    p = J_BN254.fq.modulus
    rng = np.random.RandomState(seed)
    vals = [[int.from_bytes(rng.bytes(40), "little") % p for _ in range(128)] for _ in range(2)]
    return tuple(np.tile(pf.pack_np(v), (1, LANES // 128)) for v in vals)


def script_run(kind: str, a: np.ndarray, b: np.ndarray, reps: int = MP.REPS) -> np.ndarray:
    """`make_run(kind).run` of scripts/bench_bisect_mul.py, its kernel and
    pallas_call as there, `reps` deep, in interpret mode."""
    pf = J.get_plane_field_v3(J_BN254.fq, 2)
    R8 = pf.R8

    def conv_values(A, B):
        acc = jnp.zeros((2 * R8, B.shape[1]), F32)
        for i in range(R8):
            acc = acc + jnp.pad(A[i, :][None, :] * B, ((i, R8 - i), (0, 0)))
        return acc

    def kernel(a_ref, b_ref, o_ref, t_ref):
        A = a_ref[...]
        B = b_ref[...]
        for _ in range(reps):
            if kind == "conv0":
                pf.mul_acc(A, B, t_ref)
                A = t_ref[0:R8, :] * 1e-7
            elif kind == "conv1":
                pf.mul_acc(A, B, t_ref)
                A = J._sweep(t_ref[0:R8, :])
            elif kind == "conv3":
                pf.mul_acc(A, B, t_ref)
                A = J.sweep3(t_ref[0:R8, :])
            elif kind == "conv9":
                pf.mul_acc(A, B, t_ref)
                A = J.sweep3(J.sweep3(J.sweep3(t_ref[0:R8, :])))
            elif kind == "sweep9":
                for _ in range(9):
                    A = J._sweep(A)
                A = A + 1.0
            elif kind == "convreg":
                t = conv_values(A, B)
                A = J.sweep3(t[:R8])
        o_ref[...] = A

    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((R8, LANES), F32),
        grid=(LANES // TILE,),
        in_specs=[pl.BlockSpec((R8, TILE), lambda i: (0, i))] * 2,
        out_specs=pl.BlockSpec((R8, TILE), lambda i: (0, i)),
        scratch_shapes=[pltpu.VMEM((2 * R8, TILE), F32)],
        interpret=True,
    )(jnp.asarray(a), jnp.asarray(b)))


def test_integer_variants_match_the_script_kernels():
    """conv3, conv9, sweep9 and convreg at depth 8 against the script's
    kernels digit for digit; convreg equals conv3; the values mod
    R = 256^R8 are a·b^8 (sweep9: a + 8 in every digit's place)."""
    a, b = mont_inputs(21)
    got = {}
    for kind in ("conv3", "conv9", "sweep9", "convreg"):
        got[kind] = MP.bisect_chain(port(a), port(b), kind)
        assert np.array_equal(got[kind].numpy(), script_run(kind, a, b)), kind
        assert values_mod_r(got[kind][:, :128]) == BB.host_values(port(a[:, :128]),
                                                                  port(b[:, :128]), kind, MP.REPS)
    assert torch.equal(got["convreg"], got["conv3"])


def test_float_variants_match_the_script_kernels():
    """conv1 exact at depth 2 and equal, at depth 8, to the numpy float32
    recurrence; conv0 at depth 8 within rtol 1e-5 plus 2^-126 of JAX and
    equal to the numpy recurrence, with subnormal values kept."""
    a, b = mont_inputs(22)
    pf = V.plane_field()
    once = MP.bisect_chain(port(a), port(b), "conv1", 1)
    assert float(pf.mul_acc(once, port(b))[: pf.R8].abs().max()) < 2**24
    got = MP.bisect_chain(port(a), port(b), "conv1", 2).numpy()
    assert np.array_equal(got, script_run("conv1", a, b, 2))
    got = MP.bisect_chain(port(a), port(b), "conv1").numpy()
    assert float(np.abs(got).max()) > 2**24  # the chain left the exact range
    assert np.array_equal(got, BB.host_float_chain(a, b, "conv1", MP.REPS))
    got = MP.bisect_chain(port(a), port(b), "conv0").numpy()
    assert np.array_equal(got, BB.host_float_chain(a, b, "conv0", MP.REPS))
    tiny = np.abs(got)[(got != 0) & (np.abs(got) < 2.0**-126)]
    assert tiny.size > 0  # subnormal values, kept
    np.testing.assert_allclose(got, script_run("conv0", a, b), rtol=CONV0_RTOL,
                               atol=JAX_FLUSH_ATOL)


def test_bench_runs_on_the_cpu():
    """All six lines correct through the plain versions, no kernel
    launched, nothing timed; the work counts; the wrapper refuses what the
    kernel does not take, and the entry point refuses to run without a
    card."""
    _native.reset_launches()
    res = BB.run(lanes=TILE, device="cpu")
    assert res["correct"] and res["device"] == "cpu"
    assert [rec["line"] for rec in res["lines"]] == list(MP.BISECT_KINDS)
    for rec in res["lines"]:
        assert rec["correct"] and rec["ms"] is None and rec["bound_ms"] > 0, rec
    assert not any(_native.LAUNCHES.values())
    assert {f"bisect_chain_{k}" for k in MP.BISECT_KINDS} <= set(_native.LAUNCHES)
    assert [MP.bisect_ops(k) for k in MP.BISECT_KINDS] == [1224, 1325, 1000, 1810, 1249, 1000]
    z = torch.zeros((V.ROWS, TILE))
    with pytest.raises(ValueError):
        MP.bisect_chain(z, z, "conv2")
    with pytest.raises(ValueError):
        MP.bisect_chain(z[:, :256], z[:, :256], "conv3")
    with pytest.raises(ValueError):
        BB.run(lanes=768, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            BB.main(["512"])
