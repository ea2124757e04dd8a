"""The port's h pipeline over BLS12-381 Fr (`ops/ntt.py` `NttPlan` with the
BLS12-381 `Field`: K3 stages and K4) against the JAX package's plane NTT
(interpret mode) and the field's own constants (2-adicity 32, coset
generator 7).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BLS12_381 as J_BLS
from snark_tpu.ops.ntt_plane import get_plane_ntt

from snark_tpu_torch.fields.limbs import BLS_FR
from snark_tpu_torch.ops import ntt as N

P = J_BLS.fr.modulus
VECTORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def rand(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def test_bls_h_pipeline_matches_plane_ntt():
    """h = (A·B − C)/Z_H from domain evaluations: the port's bit-reversed,
    canonical h over BLS12-381 Fr equals the JAX plane NTT's
    `h_from_evals` followed by `to_std_canonical`, and satisfies
    h(x)·Z_H(x) = a(x)·b(x) − c(x) at a point off the domain (c = a·b on
    the domain, as a satisfied R1CS gives)."""
    n = 64
    av, bv = rand(n, 1), rand(n, 2)
    cv = [a * b % P for a, b in zip(av, bv)]
    pn = get_plane_ntt(J_BLS.fr, n, interpret=True)
    pf = pn.pf
    h_planes = pn.h_from_evals(*(jnp.asarray(pf.pack_np(v)) for v in (av, bv, cv)))
    jax_bitrev = pf.unpack_np(np.asarray(pn.to_std_canonical(h_planes)), mont=False)
    plan = N.NttPlan(n, "cpu", BLS_FR)
    h = plan.h_from_evals(*(BLS_FR.tensor(v, "cpu") for v in (av, bv, cv)))
    got = BLS_FR.decode(N.from_mont(h, BLS_FR), mont=False)
    assert got == jax_bitrev
    # the identity, on the host: interpolate a, b, c; evaluate h at x
    omega = J_BLS.fr.root_of_unity(n)
    x = 1234567
    lag = []
    zx = (pow(x, n, P) - 1) % P
    for i in range(n):
        wi = pow(omega, i, P)
        lag.append(zx * pow(n, -1, P) * wi * pow(x - wi, -1, P) % P)
    ax, bx, cx = (sum(e * l for e, l in zip(ev, lag)) % P for ev in (av, bv, cv))
    rev = N.bit_reverse_indices(n)
    coeffs = [0] * n
    for k, v in enumerate(got):
        coeffs[rev[k]] = v
    hx = 0
    for v in reversed(coeffs):
        hx = (hx * x + v) % P
    assert hx * zx % P == (ax * bx - cx) % P


@pytest.mark.parametrize("dif", [False, True], ids=["dit", "dif"])
def test_bls_ntt_stage_matches_jax(dif):
    """One K3 stage of each kind against the JAX stage kernels."""
    n, s = 256, 3
    half = 1 << s
    xv, twv = rand(n, 4), rand(n // 2, 5)
    pn = get_plane_ntt(J_BLS.fr, n, interpret=True)
    pf = pn.pf
    lo, hi = pn._stage_split(jnp.asarray(pf.pack_np(xv)), half)
    stride = n >> (s + 1)
    tw_stage = [twv[j * stride] for j in range(half)]
    tw = jnp.tile(jnp.asarray(pf.pack_np(tw_stage)), (1, n // (2 * half)))
    o0, o1 = (pn.k.dif if dif else pn.k.dit)(lo, hi, tw)
    want = pf.unpack_np(np.asarray(pn._stage_join(o0, o1, half)))
    got = N.ntt_stage(BLS_FR.tensor(xv, "cpu"), BLS_FR.tensor(twv, "cpu"), s, stride, dif, BLS_FR)
    assert BLS_FR.decode(got) == want


def test_bls_fft_against_vector_and_dft():
    """The plan's constants come from BLS12-381 Fr: the committed 256th
    root of unity, generator 7; the natural-order transform equals a DFT
    on the host and `ifft` inverts it; K4 converts in and out of Montgomery
    form."""
    with open(os.path.join(VECTORS, "fields_bls12_381_fr.json")) as f:
        v = json.load(f)
    assert J_BLS.fr.two_adicity == 32 and J_BLS.fr.generator == 7
    n = 256
    plan = N.NttPlan(n, "cpu", BLS_FR)
    assert BLS_FR.decode(plan.fwd_tw[1:2]) == [int(v["root_of_unity_256"])]
    coeffs = rand(n, 6)
    evals = BLS_FR.decode(plan.fft(BLS_FR.tensor(coeffs, "cpu")))
    w = int(v["root_of_unity_256"])
    for k in (0, 1, 77, 255):
        assert evals[k] == sum(c * pow(w, i * k, P) for i, c in enumerate(coeffs)) % P
    assert BLS_FR.decode(plan.ifft(BLS_FR.tensor(evals, "cpu"))) == coeffs
    std = BLS_FR.tensor(coeffs, "cpu", mont=False)
    assert torch.equal(N.from_mont(N.to_mont(std, BLS_FR), BLS_FR), std)
