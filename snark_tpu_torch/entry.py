"""The single-device entry point: the Groth16 prover's device core on a
small key, with its example arguments.

    fn, args = entry()          # on the card
    fn, args = entry("cpu")     # the plain versions of the kernels
    g1, g2 = fn(*args)

The counterpart of the repository's `__graft_entry__.py` `entry`. The key
is MulChain(seed=5, n=8), set up by the port from `random.Random(0)`, as
`_small_pk` sets it up. `fn` is `BatchProver.core` on that key and
`args` is `([z],)`, a batch of one full assignment (ONE, instance,
witness) synthesized in prove mode. The reference's core takes z in
Montgomery form and its window digits; the port's core uploads z and
derives the digits itself. Its outputs are the A, B1, L and H sums in G1,
(1, 4, 3, 1, L) int32 projective, and the B sum in G2, (1, 3, 2, L), on
the device: the five MSMs of one proof, each ending in a K18 combine
(`parallel/batch.py` `BatchProver._one_proof`). `sums(g1, g2)` makes them
affine host points by name.
"""

from __future__ import annotations

import random

from .fields.params import BN254
from .groth16.groth16 import Groth16, synthesize_witness
from .models import MulChainCircuit
from .ops.curve import limbs_to_points
from .parallel.batch import BatchProver

G1_NAMES = ("A", "B1", "L", "H")


def small_pk(device="cuda"):
    """-> (g16, pk, vk, circuit): MulChain(seed=5, n=8, batch=False) set up
    from `random.Random(0)`."""
    g16 = Groth16(BN254, device=device)
    circuit = MulChainCircuit(seed=5, n=8, batch=False)
    pk, vk = g16.circuit_specific_setup(circuit, random.Random(0))
    return g16, pk, vk, circuit


def entry(device="cuda"):
    """-> (fn, example_args): the prover's device core and a batch of one
    assignment."""
    g16, pk, _, circuit = small_pk(device)
    bp = BatchProver(g16, pk)
    z = synthesize_witness(circuit, g16.curve)
    return bp.core, ([z],)


def sums(g1, g2, curve=BN254) -> dict:
    """The core's outputs for a batch of one -> {"A", "B1", "L", "H", "B"}
    affine host points (None for the identity)."""
    out = dict(zip(G1_NAMES, limbs_to_points(g1[0].cpu(), "g1", curve)))
    out["B"] = limbs_to_points(g2.cpu(), "g2", curve)[0]
    return out
