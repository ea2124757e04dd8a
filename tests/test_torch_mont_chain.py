"""The field core's carry chains (`snark_tpu_torch/csrc/chain.cuh`,
`field.cuh`, the row decode of `curve.cuh`) on a word-level model.

`Chain` models each PTX instruction of chain.cuh on Python integers, the
carry flag included, and refuses a lost carry: a chain that starts while
the flag holds an unconsumed 1, or a chain end whose sum does not fit its
word (but where the source says the carry cancels a borrow, and then it
must). The functions below repeat field.cuh's sequences instruction for
instruction: the CIOS product with its even and odd chains, add, sub,
the small multiples of 3b, and the 16-bit decode step. They run on edge
operands (0, 1, p − 1, 2p − 1 where lazy, all-ones limbs, R mod p) and
random ones, for BN254 Fr and Fq and BLS12-381 Fr and Fq, against the
integers and the port's plain versions (`fields/limbs.py`).
"""

import random

import pytest
import torch

from snark_tpu_torch.fields.limbs import div_r16_words, fields_of, mont_mul_plain
from snark_tpu_torch.fields.params import BLS12_381, BN254
from snark_tpu_torch.ops.curve import edge_values, edge_words

M32 = 0xFFFFFFFF
# (curve, 0 for Fr or 1 for Fq, lazy): the base fields keep values below
# 2p, the scalar fields stay canonical (field.cuh, kLazy)
FIELDS = {
    "bn254_fr": (BN254, 0, False),
    "bn254_fq": (BN254, 1, True),
    "bls12_381_fr": (BLS12_381, 0, False),
    "bls12_381_fq": (BLS12_381, 1, True),
}


class Chain:
    """The carry flag and chain.cuh's instructions on u32 words; counts
    the multiplies and all instructions."""

    def __init__(self):
        self.cf, self.pending = 0, False
        self.muls = self.instructions = 0

    def _op(self, *words, mul=False):
        assert all(0 <= w <= M32 for w in words)
        self.instructions += 1
        self.muls += mul

    def _start(self):  # a .cc instruction with no carry in
        assert not (self.pending and self.cf), "carry lost"

    def _take(self):
        c, self.cf, self.pending = self.cf, 0, False
        return c

    def _put(self, s):
        self.cf, self.pending = s >> 32, True
        return s & M32

    def _end(self, s, cancels):
        assert s >> 32 == (cancels or 0), "carry lost" if cancels is None else "no cancel"
        return s & M32

    def mul_lo(self, a, b):
        self._op(a, b, mul=True)
        return a * b & M32

    def mul_hi(self, a, b):
        self._op(a, b, mul=True)
        return a * b >> 32

    def add_cc(self, a, b):
        self._op(a, b)
        self._start()
        return self._put(a + b)

    def addc_cc(self, a, b):
        self._op(a, b)
        return self._put(a + b + self._take())

    def addc(self, a, b, cancels=None):
        self._op(a, b)
        return self._end(a + b + self._take(), cancels)

    def sub_cc(self, a, b):
        self._op(a, b)
        self._start()
        self.cf, self.pending = int(a < b), True
        return (a - b) & M32

    def subc_cc(self, a, b):
        self._op(a, b)
        t = b + self._take()
        self.cf, self.pending = int(a < t), True
        return (a - t) & M32

    def borrow_mask(self):
        self._op()
        return -self._take() & M32

    def mad_lo_cc(self, a, b, c):
        self._op(a, b, c, mul=True)
        self._start()
        return self._put((a * b & M32) + c)

    def mad_hi_cc(self, a, b, c):
        self._op(a, b, c, mul=True)
        self._start()
        return self._put((a * b >> 32) + c)

    def madc_lo_cc(self, a, b, c):
        self._op(a, b, c, mul=True)
        return self._put((a * b & M32) + c + self._take())

    def madc_hi_cc(self, a, b, c):
        self._op(a, b, c, mul=True)
        return self._put((a * b >> 32) + c + self._take())

    def madc_hi(self, a, b, c):
        self._op(a, b, c, mul=True)
        return self._end((a * b >> 32) + c + self._take(), None)


def words(x, n):
    return [(x >> (32 * i)) & M32 for i in range(n)]


def value(w):
    return sum(v << (32 * i) for i, v in enumerate(w))


class Core:
    """field.cuh for one field: limbs N, p, n0, bound modulus M."""

    def __init__(self, curve, which, lazy):
        f = fields_of(curve)[which]
        self.f, self.lazy, self.N = f, lazy, f.limbs
        self.p = words(f.p, self.N)
        self.m = words(2 * f.p if lazy else f.p, self.N)
        self.n0 = f.n0

    # ---- sub_if_ge, reduce_once, add, sub, times
    def sub_if_ge(self, ch, t, m):
        d = [ch.sub_cc(t[0], m[0])] + [ch.subc_cc(t[j], m[j]) for j in range(1, self.N)]
        keep = ch.borrow_mask()
        return [t[j] if keep else d[j] for j in range(self.N)]

    def canon(self, ch, a):
        return self.sub_if_ge(ch, a, self.p) if self.lazy else a

    def add(self, ch, a, b):
        N = self.N
        t = [ch.add_cc(a[0], b[0])] + [ch.addc_cc(a[j], b[j]) for j in range(1, N - 1)]
        t.append(ch.addc(a[N - 1], b[N - 1]))
        return self.sub_if_ge(ch, t, self.m)

    def sub(self, ch, a, b):
        N = self.N
        d = [ch.sub_cc(a[0], b[0])] + [ch.subc_cc(a[j], b[j]) for j in range(1, N)]
        wrap = ch.borrow_mask()
        r = [ch.add_cc(d[0], self.m[0] & wrap)]
        r += [ch.addc_cc(d[j], self.m[j] & wrap) for j in range(1, N - 1)]
        r.append(ch.addc(d[N - 1], self.m[N - 1] & wrap, cancels=int(wrap != 0)))
        return r

    def times(self, ch, a, k):
        a2 = self.add(ch, a, a)
        a4 = self.add(ch, a2, a2)
        a8 = self.add(ch, a4, a4)
        return self.add(ch, a8, a if k == 9 else a4)

    # ---- the product: mul_n, cmad_n, madc_n_rshift, cios_step, mont_mul
    def mul_n(self, ch, acc, a, off, b):
        for j in range(0, self.N, 2):
            acc[j] = ch.mul_lo(a[j + off], b)
            acc[j + 1] = ch.mul_hi(a[j + off], b)

    def cmad_n(self, ch, acc, a, off, b):
        acc[0] = ch.mad_lo_cc(a[off], b, acc[0])
        acc[1] = ch.madc_hi_cc(a[off], b, acc[1])
        for j in range(2, self.N, 2):
            acc[j] = ch.madc_lo_cc(a[j + off], b, acc[j])
            acc[j + 1] = ch.madc_hi_cc(a[j + off], b, acc[j + 1])

    def madc_n_rshift(self, ch, odd, a, b):
        N = self.N
        for j in range(0, N - 2, 2):
            odd[j] = ch.madc_lo_cc(a[j + 1], b, odd[j + 2])
            odd[j + 1] = ch.madc_hi_cc(a[j + 1], b, odd[j + 3])
        odd[N - 2] = ch.madc_lo_cc(a[N - 1], b, 0)
        odd[N - 1] = ch.madc_hi(a[N - 1], b, 0)

    def cios_step(self, ch, even, odd, a, b, first):
        N = self.N
        if first:
            self.mul_n(ch, odd, a, 1, b)
            self.mul_n(ch, even, a, 0, b)
        else:
            even[0] = ch.add_cc(even[0], odd[1])
            self.madc_n_rshift(ch, odd, a, b)
            self.cmad_n(ch, even, a, 0, b)
            odd[N - 1] = ch.addc(odd[N - 1], 0)
        m = ch.mul_lo(even[0], self.n0)
        self.cmad_n(ch, odd, self.p, 1, m)
        self.cmad_n(ch, even, self.p, 0, m)
        odd[N - 1] = ch.addc(odd[N - 1], 0)
        assert even[0] == 0

    def mont_mul(self, ch, a, b):
        N = self.N
        even, odd = [0] * N, [0] * N
        for i in range(0, N, 2):
            self.cios_step(ch, even, odd, a, b[i], i == 0)
            self.cios_step(ch, odd, even, a, b[i + 1], False)
        t = [ch.add_cc(even[0], odd[1])] + [ch.addc_cc(even[k], odd[k + 1]) for k in range(1, N - 1)]
        t.append(ch.addc(even[N - 1], 0))
        return t if self.lazy else self.sub_if_ge(ch, t, self.p)

    # ---- curve.cuh decode_component, on the words of one row component
    def decode(self, ch, w):
        N = self.N
        w = list(w) + [0]
        m = ch.mul_lo(w[0], self.n0) & 0xFFFF
        w[0] = ch.mad_lo_cc(m, self.p[0], w[0])
        for j in range(1, N):
            w[j] = ch.madc_lo_cc(m, self.p[j], w[j])
        w[N] = ch.addc(0, 0)
        w[1] = ch.mad_hi_cc(m, self.p[0], w[1])
        for j in range(1, N - 1):
            w[j + 1] = ch.madc_hi_cc(m, self.p[j], w[j + 1])
        w[N] = ch.madc_hi(m, self.p[N - 1], w[N])
        assert w[0] & 0xFFFF == 0
        return [((w[j] | (w[j + 1] << 32)) >> 16) & M32 for j in range(N)]


def operands(core):
    """Edge values, and for a lazy field values in [p, 2p), then random."""
    p = core.f.p
    vals = edge_values(p, core.N)
    if core.lazy:
        vals += [p, p + 1, 2 * p - 1, 2 * p - 2, p + (p >> 1), (1 << (32 * (core.N - 1))) - 1 + p]
    rng = random.Random(core.N)
    return vals + [rng.randrange(2 * p if core.lazy else p) for _ in range(6)]


def test_bounds_the_design_relies_on():
    """p < R/4 for both base fields (lazy), BLS12-381 Fr only p < R/2
    (canonical); q > R/2^16, so a decoded row lies below 2q."""
    for spec in FIELDS.values():
        core = Core(*spec)
        p, r = core.f.p, 1 << (32 * core.N)
        assert 2 * p < r
        if core.lazy:
            assert 4 * p < r and p > r >> 16
    assert 4 * BLS12_381.fr.modulus > 1 << 256  # no room for a lazy Fr


@pytest.mark.parametrize("curve", [BN254, BLS12_381], ids=["bn254", "bls12_381"])
def test_mont_chain_matches_integers_and_plain(curve):
    """Every product of two operands, through the model, in Fr and Fq:
    equal to a·b·R^-1 mod p and within the field's bound, every carry
    kept, the multiplies exactly 4N² + N; on canonical operands equal to
    mont_mul_plain once reduced."""
    for spec in FIELDS.values():
        if spec[0] is curve:
            check_products(Core(*spec))


def check_products(core):
    f, N = core.f, core.N
    vals = operands(core)
    bound = 2 * f.p if core.lazy else f.p
    got = []
    for a in vals:
        for b in vals:
            ch = Chain()
            r = core.mont_mul(ch, words(a, N), words(b, N))
            assert not ch.pending
            assert ch.muls == 4 * N * N + N
            assert ch.instructions == 4 * N * N + 5 * N - 2 + (0 if core.lazy else N + 1)
            v = value(r)
            assert v < bound and v % f.p == a * b * f.r_inv % f.p
            got.append(value(core.canon(Chain(), r)))
    canon = [v for v in vals if v < f.p]
    pairs = [(a, b) for a in canon for b in canon]
    plain = mont_mul_plain(
        f.tensor([a for a, _ in pairs], "cpu", mont=False),
        f.tensor([b for _, b in pairs], "cpu", mont=False), f)
    idx = {v: i for i, v in enumerate(vals)}
    assert f.decode(plain, mont=False) == [got[idx[a] * len(vals) + idx[b]] for a, b in pairs]


def test_decode_step_matches_plain():
    """curve.cuh's 16-bit step on any row word w < R, on both curves: below
    2q, equal to w·2^-16 mod q, and to div_r16_words (the plain decode)
    once reduced."""
    for curve in (BN254, BLS12_381):
        check_decode(Core(curve, 1, True))


def check_decode(core):
    f, N = core.f, core.N
    rng = random.Random(5)
    ws = edge_words(f.p, N) + [rng.randrange(1 << (32 * N)) for _ in range(40)]
    got = []
    for w in ws:
        ch = Chain()
        r = core.decode(ch, words(w, N))
        assert not ch.pending and ch.muls == 2 * N + 1
        v = value(r)
        assert v < 2 * f.p and v % f.p == w * pow(1 << 16, -1, f.p) % f.p
        got.append(value(core.canon(Chain(), r)))
    plain = div_r16_words(torch.tensor([words(w, N) for w in ws], dtype=torch.int64), f)
    assert [value(row) for row in plain.tolist()] == got


def test_lazy_glue_stays_below_2p():
    """add, sub (its carry cancelling the borrow), neg and 3b by additions
    (9, 12 and 12 (1 + u)) on operands up to 2p − 1, on both curves:
    within [0, 2p) and equal mod p to the integers."""
    for curve in (BN254, BLS12_381):
        check_glue(curve, Core(curve, 1, True))


def check_glue(curve, core):
    f, N = core.f, core.N
    p = f.p
    vals = operands(core)
    k = 3 * curve.b
    assert k in (9, 12) and (curve is BN254 or list(curve.b2) == [curve.b, curve.b])
    zero = [0] * N
    for a in vals:
        for b in vals:
            ch = Chain()
            s, d = core.add(ch, words(a, N), words(b, N)), core.sub(ch, words(a, N), words(b, N))
            assert value(s) < 2 * p and value(s) % p == (a + b) % p
            assert value(d) < 2 * p and value(d) % p == (a - b) % p
            if curve is BLS12_381:  # 12 (1 + u) (a + b u) = 12 (a − b) + 12 (a + b) u
                c0, c1 = core.times(ch, d, 12), core.times(ch, s, 12)
                assert value(c0) % p == 12 * (a - b) % p and value(c1) % p == 12 * (a + b) % p
            assert not ch.pending
        ch = Chain()
        n, t = core.sub(ch, zero, words(a, N)), core.times(ch, words(a, N), k)
        assert value(n) < 2 * p and value(n) % p == -a % p
        assert value(t) < 2 * p and value(t) % p == k * a % p
