"""K19 `affine_batch_inverse`'s plain version (`snark_tpu_torch/ops/msm_affine.py`
`affine_batch_inverse_plain`): Montgomery's trick over chunks with the
kernel's index map (element b·T·C + t + i·T), its heaps, its top block and
its windowed root.

At a small chunk C and block T it must equal the former product tree
(`tree_inverse` on K7's plain products, its root inverted on the host) at
every edge of the kernel's indexing, for G1 and G2 on both curves: M = 1,
2, 3, C − 1, C, C + 1, T·C − 1, T·C + 1, 3·T·C + 5, and a count whose G
block products exceed the top block's threads. The root's 4-bit windowed
Fermat inverse must equal pow(x, q − 2, q), and the whole inverse the JAX
package's `batch_inverse_planes` at an odd M above one JAX tile (run as
`tests/test_torch_affine.py` runs it, JAX on the CPU). Inputs come from
numpy generators with fixed seeds.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.ops.msm_affine import _get_kernels, batch_inverse_planes
from snark_tpu.ops.pallas_curve import get_plane_curve

from snark_tpu_torch.fields.limbs import fields_of, from_words
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.ops import msm_affine as A

CURVES = {"bn254": BN254, "bls12_381": BLS12_381}
T, C, TOP = 4, 5, 2  # threads a block, elements a chunk, top threads (small)
EDGE_M = [1, 2, 3, C - 1, C, C + 1, T * C - 1, T * C + 1, 3 * T * C + 5]
MANY_BLOCKS = 5 * T * C + 7  # G = 6 block products, above TOP = 2 threads
JAX_TILE = 256
SOURCE = "snark_tpu_torch/csrc/affine_kernels.cuh"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def random_elems(curve, group: str, m: int, seed: int) -> tuple[torch.Tensor, list[int]]:
    """m nonzero elements of Fq (G1) or Fq2 (G2) -> ((m, K, L) Montgomery
    limbs, their K·m component values)."""
    fq = fields_of(curve)[1]
    K = 1 if group == "g1" else 2
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(m * K, 2 * fq.limbs), dtype=np.uint64)
    vals = [int.from_bytes(w.astype("<u4").tobytes(), "little") % (fq.p - 1) + 1 for w in words]
    return fq.tensor(vals, "cpu").view(m, K, fq.limbs), vals


def host_root(curve, group: str):
    """The tree's root inverse on the host (Fq2 by its norm), so that the
    reference shares nothing with the windowed root."""
    fq = fields_of(curve)[1]
    q = fq.p

    def inv(r: torch.Tensor) -> torch.Tensor:
        v = fq.decode(r)
        if group == "g1":
            out = [pow(v[0], -1, q)]
        else:
            n = pow(v[0] * v[0] + v[1] * v[1], -1, q)
            out = [v[0] * n % q, -v[1] * n % q]
        return fq.tensor(out, "cpu").view(r.shape)

    return inv


@pytest.mark.parametrize("m", EDGE_M + [MANY_BLOCKS])
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_plain_equals_tree(curve, group, m):
    """The chunked trick equals the former product tree exactly."""
    cv = CURVES[curve]
    den, vals = random_elems(cv, group, m, seed=m)
    got = A.affine_batch_inverse_plain(den, group, cv, chunk=C, threads=T, top_threads=TOP)
    one = from_words(A._field_one(den.shape[1], fields_of(cv)[1], "cpu"))
    want = A.tree_inverse(den, lambda a, b: A.affine_tree_mul_plain(a, b, group, cv),
                          host_root(cv, group), one)
    assert torch.equal(got, want)
    # den · dinv = 1
    prod = A.affine_tree_mul_plain(den, got, group, cv)
    assert torch.equal(prod, one.expand_as(den))


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
def test_windowed_root(curve):
    """The root's 4-bit windowed Fermat inverse equals pow(x, q − 2, q) on
    random values and on edge limb patterns (Montgomery words 0, 1, q − 1,
    q − 2, all-ones limbs below the top one, alternating limbs, 2^k); the
    Fq2 inverse through the norm equals the host's."""
    cv = CURVES[curve]
    fq = fields_of(cv)[1]
    q, L = fq.p, fq.limbs
    full = (1 << (32 * (L - 1))) - 1
    alt = int("00000000ffffffff" * (L // 2), 16) % q
    raw = [0, 1, q - 1, q - 2, full, alt, 1 << 31, 1 << (32 * (L - 1))]
    raw += [v % q for v in np.random.default_rng(7).integers(1, 1 << 62, size=8).tolist()]
    raw += [(v * 0x9E3779B97F4A7C15 << 200) % q for v in range(1, 9)]
    words = torch.tensor([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(L)] for v in raw],
                         dtype=torch.int64)
    got = fq.decode(from_words(A._fermat_inv_words(words, fq)))
    vals = fq.decode(from_words(words))
    assert got == [pow(v, q - 2, q) for v in vals]
    assert sum(1 for d in A.fermat_windows(q)[1:] if d) + 4 * (len(A.fermat_windows(q)) - 1) + 14 \
        == {"bn254": 325, "bls12_381": 485}[curve]
    den, v2 = random_elems(cv, "g2", 6, seed=11)
    inv = fq.decode(A.affine_inverse_plain(den, "g2", cv))
    for j in range(6):
        a, b = v2[2 * j], v2[2 * j + 1]
        n = pow(a * a + b * b, -1, q)
        assert inv[2 * j : 2 * j + 2] == [a * n % q, -b * n % q]


def test_plain_equals_jax():
    """BN254 G1 at an odd M above one JAX tile: the JAX package's
    `batch_inverse_planes` (its value-level tree, JAX on the CPU) equals the
    plain K19 at the instance's sizes (one block) and at small ones (many
    blocks, several top chunks), and `batch_inverse` on the CPU."""
    m = JAX_TILE + 1
    den, vals = random_elems(BN254, "g1", m, seed=3)
    q = J_BN254.fq.modulus
    R8 = 34  # base-256 digits of x·2^272 mod q
    wide = [v * (1 << 272) % q for v in vals]
    planes = np.array([[(w >> (8 * i)) & 0xFF for w in wide] for i in range(R8)], np.float32)
    _, _, tree = _get_kernels(J_BN254, JAX_TILE, None, "g1", True)
    out = jax.jit(lambda d: batch_inverse_planes(get_plane_curve(J_BN254), "g1", d, tree,
                                                 JAX_TILE))(planes)
    d = np.asarray(out).astype(np.int64)
    r_inv = pow(1 << 272, -1, q)
    want = [sum(int(x) << (8 * i) for i, x in enumerate(d[:, j])) * r_inv % q for j in range(m)]
    assert want == [pow(v, -1, q) for v in vals]
    fq = fields_of(BN254)[1]
    assert fq.decode(A.batch_inverse(den, "g1")) == want
    small = A.affine_batch_inverse_plain(den, "g1", BN254, chunk=C, threads=T, top_threads=TOP)
    assert fq.decode(small) == want


def test_sizes_match_source_and_wrapper_checks():
    """`INVERSE_SIZES` are the CUDA source's `InverseSizes` (T, C, kTop),
    each T and kTop a power of two; the wrapper refuses elements of the
    wrong type or width, and gives an empty result for M = 0."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(root, SOURCE)).read()
    found = {}
    for fp, params, t, c, top in re.findall(
            r"struct InverseSizes<(Fp2?)<(\w+)>> \{\s*static constexpr int T = (\d+), "
            r"C = (\d+), kTop = (\d+);", src):
        key = ("bls12_381" if params.startswith("Bls") else "bn254", "g2" if fp == "Fp2" else "g1")
        found[key] = (int(t), int(c), int(top))
    assert found == A.INVERSE_SIZES
    for t, _, top in found.values():
        assert t & (t - 1) == 0 and top & (top - 1) == 0
    den, _ = random_elems(BN254, "g1", 4, seed=1)
    with pytest.raises(ValueError):
        A.affine_batch_inverse(den.to(torch.int64), "g1")
    with pytest.raises(ValueError):
        A.affine_batch_inverse(den, "g2")
    assert A.affine_batch_inverse(den[:0], "g1").shape == (0, 1, 8)
