"""Regenerate the repository's regression vectors from the port.

    python -m snark_tpu_torch.gen_vectors [OUT_DIR] [--device cuda|cpu]

The counterpart of the repository's `scripts/gen_vectors.py`, which wrote
`tests/vectors/*.json` from the JAX package's host code under fixed seeds.
This module writes the same seven files from the port's own host copies
(`fields/host.py`, `fields/params.py`, `ops/curve_host.py`,
`groth16/pairing.py`, `snark/serialize.py`): field and NTT vectors of both
scalar fields, curve scalar multiplications and an MSM on both curves, the
BN254 pairing of the generators; and the proof vector from the port's
`Groth16` on the given device (MulChain(11, 8) set up from
`random.Random(0xA5A5)`, proved at fixed (r, s), verified). The files must
come out equal, byte for byte, to the committed ones.

It writes into OUT_DIR, a new temporary directory when none is given, and
refuses `tests/vectors/` itself or any directory inside it: the committed
vectors are the oracle and are never rewritten. Prints a line a file and
one JSON line (the directory, the files, the card's name and power limit).
"""

from __future__ import annotations

import json
import os
import random
import sys
import tempfile

from . import toolkit as T
from .fields.host import Fp
from .fields.params import BLS12_381, BLS12_381_FR, BN254, BN254_FR
from .ops.curve_host import host_g1, host_g2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "tests", "vectors")


def field_vectors(params, name, count=8):
    f = Fp(params)
    rng = random.Random(0xF00D)
    xs = [f.rand(rng) for _ in range(count)]
    ys = [f.rand(rng) for _ in range(count)]
    return {
        "field": name,
        "modulus": str(params.modulus),
        "two_adic_root_of_unity": str(params.two_adic_root_of_unity),
        "x": [str(v) for v in xs],
        "y": [str(v) for v in ys],
        "add": [str(f.add(a, b)) for a, b in zip(xs, ys)],
        "mul": [str(f.mul(a, b)) for a, b in zip(xs, ys)],
        "inv_x": [str(f.inv(a)) if a else "0" for a in xs],
        "root_of_unity_256": str(params.root_of_unity(256)),
    }


def ntt_vectors(params, name, n=16):
    f = Fp(params)
    rng = random.Random(0xBEEF)
    coeffs = [f.rand(rng) for _ in range(n)]
    g = params.root_of_unity(n)
    p = params.modulus

    def ev(x):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % p
        return acc

    return {
        "field": name,
        "n": n,
        "omega": str(g),
        "coeffs": [str(c) for c in coeffs],
        "evals_natural_order": [str(ev(pow(g, i, p))) for i in range(n)],
    }


def curve_vectors(curve, name):
    g1, g2 = host_g1(curve), host_g2(curve)
    ks = [1, 2, 7, 12345, curve.fr.modulus - 1]
    g1_pts = [g1.scalar_mul(g1.generator, k) for k in ks]
    g2_pts = [g2.scalar_mul(g2.generator, k) for k in ks]
    rng = random.Random(0xC0DE)
    msm_scalars = [rng.randrange(curve.fr.modulus) for _ in range(6)]
    msm_bases = [g1.scalar_mul(g1.generator, i + 1) for i in range(6)]
    msm_out = g1.msm(msm_bases, msm_scalars)
    return {
        "curve": name,
        "g1_scalar_muls": {str(k): [str(pt[0]), str(pt[1])] for k, pt in zip(ks, g1_pts)},
        "g2_scalar_muls": {
            str(k): [[str(pt[0][0]), str(pt[0][1])], [str(pt[1][0]), str(pt[1][1])]]
            for k, pt in zip(ks, g2_pts)
        },
        "msm_scalars": [str(s) for s in msm_scalars],
        "msm_result": [str(msm_out[0]), str(msm_out[1])],
    }


def pairing_vectors(curve, name):
    from .groth16.pairing import get_pairing

    e = get_pairing(curve).pairing(host_g1(curve).generator, host_g2(curve).generator)
    flat = [str(c) for c6 in e for c2 in c6 for c in (c2[0], c2[1])]
    return {"curve": name, "e_g1_g2_fq12": flat}


def proof_vectors(device):
    from .groth16 import Groth16
    from .models import MulChainCircuit
    from .snark import serialize as ser

    g16 = Groth16(BN254, device=device)
    circuit = MulChainCircuit(seed=11, n=8, batch=False)
    pk, vk = g16.circuit_specific_setup(circuit, random.Random(0xA5A5))
    proof = g16.prove(pk, circuit, r=123456789, s=987654321)
    if not g16.verify(vk, [11], proof):
        raise RuntimeError("the vector's proof does not verify")
    return {
        "curve": "bn254",
        "circuit": "mulchain seed=11 n=8",
        "setup_seed": str(0xA5A5),
        "r": "123456789",
        "s": "987654321",
        "proof_bytes_hex": ser.serialize_proof(proof, BN254).hex(),
        "vk_bytes_hex": ser.serialize_vk(vk).hex(),
    }


def vectors(device) -> dict:
    return {
        "fields_bn254_fr.json": field_vectors(BN254_FR, "bn254_fr"),
        "fields_bls12_381_fr.json": field_vectors(BLS12_381_FR, "bls12_381_fr"),
        "ntt_bn254_fr.json": ntt_vectors(BN254_FR, "bn254_fr"),
        "curve_bn254.json": curve_vectors(BN254, "bn254"),
        "curve_bls12_381.json": curve_vectors(BLS12_381, "bls12_381"),
        "pairing_bn254.json": pairing_vectors(BN254, "bn254"),
        "proof_bn254.json": proof_vectors(device),
    }


def check_out_dir(out: str) -> str:
    """The directory, made absolute; raises if it is the committed vectors'
    directory or inside it."""
    real = os.path.realpath(out)
    committed = os.path.realpath(COMMITTED)
    if os.path.commonpath([real, committed]) == committed:
        raise ValueError(f"{out} is the committed vectors' directory: write elsewhere")
    return real


def main(argv=None) -> int:
    ap = T.parser(__doc__)
    ap.add_argument("out_dir", nargs="?", default=None)
    a = ap.parse_args(argv)
    out = check_out_dir(a.out_dir or tempfile.mkdtemp(prefix="gen_vectors_"))
    dev = T.resolve(a.device)
    data = vectors(dev)
    os.makedirs(out, exist_ok=True)
    for fname, payload in data.items():
        with open(os.path.join(out, fname), "w") as fh:
            json.dump(payload, fh, indent=1)
        print("wrote", fname, flush=True)
    T.emit({"tool": "gen_vectors", "out_dir": out, "files": sorted(data), **T.card(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
