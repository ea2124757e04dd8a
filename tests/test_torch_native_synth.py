"""The port's LC engine against the JAX package's: the seeded random-LC
synthesizer, the batched row evaluator and the raw inline pass
(`snark_tpu_torch/relations/native.py` on `csrc/lc_engine.cpp` against
`snark_tpu/relations/native.py` on `native/lc_engine.cpp`), on both scalar
fields. Both are host C++ built by g++ at first use; the comparisons are
exact, element for element. Oracle for the evaluator besides the
reference: Python integer dot products.
"""

import numpy as np
import pytest

from snark_tpu.relations import native as ref_native
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.relations import native

FIELDS = {"bn254": BN254.fr.modulus, "bls12_381": BLS12_381.fr.modulus}
# (n constraints, terms, seed, num_vars, lc_base, id_base)
SYNTH_CASES = ((1, 1, 0, 1, 1, 2), (300, 10, 7, 64, 1, 2), (200, 3, 2**63 + 5, 1000, 9, 40))
LC_TAG = 4 << 61


def _pair(p: int):
    return native.NativeSynthesizer(p), ref_native.NativeSynthesizer(p)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_synthesizer_equals_reference(field):
    """Every array of `synthesize` equals the JAX package's, for the same
    (n, terms, seed, num_vars, lc_base, id_base), dtypes included."""
    ours, ref = _pair(FIELDS[field])
    for case in SYNTH_CASES:
        got, want = ours.synthesize(*case), ref.synthesize(*case)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        offsets, vars_, cids, values, arg_vars = got
        assert offsets[-1] == len(vars_) == len(cids) and len(arg_vars) == 3 * case[0]
        assert ((vars_ >> np.uint64(61)) == 3).all()


def _with_lc_refs(offsets, vars_, seed: int):
    """The synthesized rows behind an empty row 0 (LC0), with about a
    quarter of the entries turned into references to earlier rows, so
    that the inline pass substitutes and scales."""
    rng = np.random.default_rng(seed)
    off = np.concatenate([[0], offsets]).astype(np.int64)
    v = vars_.copy()
    for row in range(2, len(off) - 1):
        for k in range(off[row], off[row + 1]):
            if rng.random() < 0.25:
                v[k] = np.uint64(LC_TAG | int(rng.integers(0, row)))
    return off, v


def test_inline_raw_equals_reference():
    """`NativeInliner.inline_raw` (and `inline`, through Python ints) on
    rows that reference earlier rows gives the JAX package's offsets,
    variables and coefficients, on both fields; the interner's first two
    slots hold 1 and −1, as a constraint system's."""
    for p in FIELDS.values():
        offsets, vars_, cids, values, _ = native.NativeSynthesizer(p).synthesize(150, 6, 11, 40)
        off, v = _with_lc_refs(offsets, vars_, seed=p % 1000)
        pre = native._to_u64x4([1, p - 1])
        table = np.concatenate([pre, values])
        got = native.get_inliner(p).inline_raw(off, v, cids, table)
        want = ref_native.get_inliner(p).inline_raw(off, v, cids, table)
        assert got[0][-1] > 0 and (got[1] >> np.uint64(61) != 4).all()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        vals = native._from_u64x4(table)
        o2, v2, c2 = native.get_inliner(p).inline(off, v, cids, vals)
        np.testing.assert_array_equal(o2, want[0])
        np.testing.assert_array_equal(v2, want[1])
        assert c2 == native._from_u64x4(want[2])
    # arrays that would send the engine outside a buffer raise instead
    inl = native.get_inliner(p)
    with pytest.raises(ValueError, match="coefficient id"):
        inl.inline_raw(off, v, cids, values)  # the table without its two slots
    forward = v.copy()
    forward[off[1]] = np.uint64(LC_TAG | 5)  # row 1 refers to row 5
    with pytest.raises(ValueError, match="earlier one"):
        inl.inline_raw(off, forward, cids, table)
    with pytest.raises(ValueError, match="offsets"):
        inl.inline_raw(off[::-1], v, cids, table)


def test_eval_rows_equals_reference():
    """`NativeEvaluator.eval_rows` over random rows (Zero entries
    included, above and below the engine's 4096-row threading threshold)
    equals the JAX package's and the Python dot products."""
    rng = np.random.default_rng(5)
    for p in FIELDS.values():
        for n in (37, 4500):
            offsets, vars_, cids, values, _ = native.NativeSynthesizer(p).synthesize(
                n // 3 + 1, 4, n, 50)
            num_cols = 50
            assignment = [int(x) % p for x in rng.integers(0, 2**62, num_cols)]
            assignment[:3] = [0, 1, p - 1]
            var_to_col = (vars_ & np.uint64((1 << 61) - 1)).astype(np.int64)
            var_to_col[rng.random(len(var_to_col)) < 0.1] = -1
            asg = native._to_u64x4(assignment)
            table = np.concatenate([native._to_u64x4([1, p - 1]), values])
            args = (offsets, vars_, cids, table, asg, var_to_col)
            got = native.get_evaluator(p).eval_rows(*args)
            np.testing.assert_array_equal(got, ref_native.get_evaluator(p).eval_rows(*args))
            with pytest.raises(ValueError, match="coefficient id"):
                native.get_evaluator(p).eval_rows(offsets, vars_, cids, values, asg, var_to_col)
            with pytest.raises(ValueError, match="var_to_col"):
                native.get_evaluator(p).eval_rows(offsets, vars_, cids, table, asg[:10],
                                                  var_to_col)
            vals = native._from_u64x4(table)
            got_int = native._from_u64x4(got)
            for row in range(0, len(offsets) - 1, max(1, (len(offsets) - 1) // 40)):
                want = sum(vals[cids[k]] * assignment[var_to_col[k]]
                           for k in range(offsets[row], offsets[row + 1])
                           if var_to_col[k] >= 0) % p
                assert got_int[row] == want
