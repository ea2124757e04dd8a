"""The port's six-step distributed NTT (`parallel/plane_dist.py`
`DistPlaneNtt`) against the JAX package, and the batched local transform
it runs (`ops/ntt.py` `ntt_rows`) against the one-device plan, on the CPU.

Each world of ranks is spawned by `parallel/launch.py` `run_ranks` on
gloo, every rank running the plain versions of K3 and K4 on its shard; the
JAX plane NTT (interpret mode) runs in this process. n1 = 16, n2 = 32 on
two and four ranks, as the reference's `tests/test_plane_dist.py`.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops.ntt_plane import _bit_reverse_indices, get_plane_ntt
from snark_tpu_torch.fields.limbs import FR
from snark_tpu_torch.ops import ntt as N
from snark_tpu_torch.parallel import plane_dist as PD
from snark_tpu_torch.parallel.launch import run_ranks

R = J_BN254.fr.modulus
N1, N2 = 16, 32


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def values():
    rng = random.Random(9)
    return [[rng.randrange(R) for _ in range(N1 * N2)] for _ in range(3)]


@pytest.fixture(scope="module")
def jax_ntt(values):
    """The JAX plane NTT of the first vector (natural order) and its plane
    h of the three, bit-reversed as it comes."""
    pn = get_plane_ntt(J_BN254.fr, N1 * N2, interpret=True)
    pf = pn.pf
    planes = [jnp.asarray(pf.pack_np(v)) for v in values]
    return (pf.unpack_np(np.asarray(pn.fft(planes[0]))),
            pf.unpack_np(np.asarray(pn.h_from_evals(*planes))))


@pytest.mark.parametrize("ranks", [2, 4])
def test_dist_ntt_matches_jax(ranks, values, jax_ntt):
    """fft equals the JAX NTT's natural-order evaluations, ifft gives the
    input back, h_from_evals equals the JAX plane h taken out of
    bit-reversed order, and h_std is h in canonical standard form."""
    results = run_ranks(PD.dist_transforms, ranks, "cpu", values, N1, N2, "bn254", "cpu",
                        timeout_s=240)
    shards = {k: torch.cat([res[k] for res in results]) for k in results[0]}
    evals, h_br = jax_ntt
    assert FR.decode(shards["fft"]) == evals
    assert FR.decode(shards["ifft"]) == values[0]
    rev = _bit_reverse_indices(N1 * N2)
    assert FR.decode(shards["h"]) == [h_br[r] for r in rev]
    assert FR.decode(shards["h_std"], mont=False) == FR.decode(shards["h"])


def test_ntt_rows_equal_separate_transforms():
    """B rows of m through one `ntt_rows` (and its plain version) equal B
    transforms of the plan, forward and (with the 1/m scale) inverse; a row length that does not
    divide the vector is refused."""
    rng = random.Random(5)
    for m, B in ((32, 4), (8, 64)):
        x = FR.tensor([rng.randrange(R) for _ in range(B * m)], "cpu")
        plan = N.NttPlan(m, "cpu")
        fwd = N.ntt_rows(x, m, plan.fwd_tw)
        inv = N.ntt_rows(x, m, plan.inv_tw, FR.const(pow(m, -1, R), "cpu"))
        assert torch.equal(fwd, N.ntt_rows_plain(x, m, plan.fwd_tw))
        assert torch.equal(inv, N.ntt_rows_plain(x, m, plan.inv_tw,
                                                 FR.const(pow(m, -1, R), "cpu")))
        for b in range(B):
            row = x[b * m : (b + 1) * m]
            assert torch.equal(fwd[b * m : (b + 1) * m], plan.fft(row))
            assert torch.equal(inv[b * m : (b + 1) * m], plan.ifft(row))
    with pytest.raises(ValueError):
        N.ntt_rows(x[:12], 8, plan.fwd_tw)
