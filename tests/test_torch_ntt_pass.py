"""K3 as a multi-stage pass (`snark_tpu_torch/ops/ntt.py` `ntt_pass`) and
the fused h pipeline on the CPU: the kernel's block schedule
(`ntt_pass_emulate`, plain butterflies over the kernel's own index maps)
against the stage-by-stage plain transform, the fused h against the JAX
package's plane NTT (interpret mode), and the launcher's refusals. Values
are compared exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BLS12_381 as J_BLS
from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops.ntt_plane import get_plane_ntt

from snark_tpu_torch.fields.limbs import BLS_FR, FR
from snark_tpu_torch.ops import ntt as N

FIELDS = {"bn254_fr": (FR, J_BN254), "bls12_381_fr": (BLS_FR, J_BLS)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def rand(f, n, seed):
    """n values from a seed, led by the edges 0, 1 and p − 1."""
    rng = np.random.RandomState(seed)
    vals = [0, 1, f.p - 1] + [int.from_bytes(rng.bytes(48), "little") % f.p for _ in range(n)]
    return vals[:n]


def plain_transform(x, tw, log_n, dif, f):
    stages = range(log_n - 1, -1, -1) if dif else range(log_n)
    for s in stages:
        x = N.ntt_stage_plain(x, tw, s, 1 << (log_n - 1 - s), dif, f)
    return x


def passes_of(split, dif):
    out, s0 = [], 0
    for k in split:
        out.append((s0, k))
        s0 += k
    return out[::-1] if dif else out


@pytest.mark.parametrize("name", FIELDS)
def test_block_schedule_equals_stages(name):
    """A transform as passes through the kernel's block schedule equals the
    stage-by-stage plain transform, DIT and DIF, n = 2^4..2^8, for splits
    whose k divides log n, does not, a single pass and the plan's own; each
    at the kernel's tile (one block; sub-transforms side by side where
    k < log n) and at a tile of 2^(k + 1) (many blocks of 2 sub-transforms,
    each pass strided). With the prologue on its first pass and the
    epilogue on its last, it equals the plain passes."""
    f = FIELDS[name][0]
    for log_n in range(4, 9):
        n = 1 << log_n
        plan = N.NttPlan(n, "cpu", f)
        x, b, c, scale = (f.tensor(rand(f, n, 10 * log_n + i), "cpu") for i in range(4))
        d = f.const(rand(f, 4, log_n)[3], "cpu")
        splits = [[log_n], [2] * (log_n // 2) + [log_n % 2] * (log_n % 2), [3] * (log_n // 3)
                  + [log_n % 3] * (log_n % 3 > 0), N.pass_split(log_n)]
        for split in splits:
            for dif, tw in ((False, plan.fwd_tw), (True, plan.inv_tw)):
                want = plain_transform(x, tw, log_n, dif, f)
                passes = passes_of(split, dif)
                for log_tile in (N.LOG_TILE, max(split) + 1):
                    y = x
                    for s0, k in passes:
                        y = N.ntt_pass_emulate(y, tw, N.pass_geometry(n, s0, k, log_tile=log_tile),
                                               dif, field=f)
                    assert torch.equal(y, want), (log_n, split, dif, log_tile)
                y, want = x, x
                for i, (s0, k) in enumerate(passes):
                    had = (b, c, d) if i == 0 else None
                    sc = scale if i == len(passes) - 1 else None
                    y = N.ntt_pass_emulate(y, tw, N.pass_geometry(n, s0, k, log_tile=k + 1),
                                           dif, had, sc, f)
                    want = N.ntt_pass_plain(want, tw, s0, k, dif, hadamard=had, scale=sc, field=f)
                assert torch.equal(y, want), (log_n, split, dif, "fused")


@pytest.mark.parametrize("name", FIELDS)
def test_fused_h_matches_jax(name, monkeypatch):
    """h in canonical standard form (`h_std`: the scale, Hadamard and
    unscale inside the passes) equals the JAX plane NTT's `h_from_evals`
    followed by `to_std_canonical`, equals `from_mont(h_from_evals)` and
    the unfused plain pipeline, and equals itself with every pass run
    through the kernel's block schedule, as the plan splits n = 64 (one
    pass) and as three passes of two stages in tiles of 2^3."""
    f, jf = FIELDS[name]
    n = 64
    av, bv, cv = (rand(f, n, s) for s in (1, 2, 3))
    pn = get_plane_ntt(jf.fr, n, interpret=True)
    pf = pn.pf
    h_planes = pn.h_from_evals(*(jnp.asarray(pf.pack_np(v)) for v in (av, bv, cv)))
    want = pf.unpack_np(np.asarray(pn.to_std_canonical(h_planes)), mont=False)
    plan = N.NttPlan(n, "cpu", f)
    evals = [f.tensor(v, "cpu") for v in (av, bv, cv)]
    h = plan.h_std(*evals)
    assert f.decode(h, mont=False) == want
    assert torch.equal(N.from_mont(plan.h_from_evals(*evals), f), h)
    assert torch.equal(plan.h_plain(*evals), h)

    log_tile = {"tile": N.LOG_TILE}

    def scheduled(x, tw, s0, k, dif, tw_log=None, hadamard=None, scale=None, field=f, **_):
        g = N.pass_geometry(x.shape[0], s0, k, tw_log, log_tile=log_tile["tile"])
        return N.ntt_pass_emulate(x, tw, g, dif, hadamard, scale, field)

    monkeypatch.setattr(N, "ntt_pass", scheduled)
    assert torch.equal(plan.h_std(*evals), h)
    plan.passes, log_tile["tile"] = [(0, 2), (2, 2), (4, 2)], 3
    assert torch.equal(plan.h_std(*evals), h)


def test_pass_launcher_refuses_bad_arguments():
    """The launcher's contract: n a power of two, stages inside the
    transform, at most 2^11 elements (64 KB of shared memory) a tile, a
    twiddle table the stages can index, 16-byte aligned operands."""
    n = 1 << 12
    x = FR.tensor(rand(FR, n, 7), "cpu")
    tw = N.NttPlan(n, "cpu").fwd_tw
    with pytest.raises(ValueError, match="shared memory"):
        N.ntt_pass(x, tw, 0, 12, dif=False)
    with pytest.raises(ValueError, match="power of two"):
        N.ntt_pass(x[:48], tw, 0, 1, dif=False)
    with pytest.raises(ValueError, match="power of two"):
        N.ntt_stage(x, tw, 3, 6, dif=True)
    with pytest.raises(ValueError, match="not inside"):
        N.ntt_pass(x, tw, 8, 5, dif=True)
    with pytest.raises(ValueError, match="too short"):
        N.ntt_pass(x, tw[: n // 4], 0, 12 - 1, dif=False, tw_log=11)
    flat = torch.zeros(n * 8 + 4, dtype=torch.int32)
    misaligned = flat[1 : 1 + n * 8].view(n, 8)
    assert misaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        N.ntt_pass(misaligned, tw, 0, 3, dif=False)
    with pytest.raises(ValueError, match="aligned"):
        N.ntt_pass(x, tw, 0, 3, dif=True, scale=misaligned)
    # what the launcher takes runs: 11 stages, then the last one
    y = N.ntt_pass(N.ntt_pass(x, tw, 0, 11, dif=False), tw, 11, 1, dif=False)
    assert torch.equal(y, plain_transform(x, tw, 12, False, FR))
