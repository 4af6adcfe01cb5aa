"""The 32-bit-word arithmetic of the mulcmp, chain, mul, mul_digits and
reduce_digits CUDA kernels (``bp::mulcmp_words``, ``bp::canon_words``,
``bp::mulmod_words``, ``bp::reduce_digit_words``, ``bp::addmod_words`` in
``csrc/field.cuh``), step for step in Python ints over the constant blocks
the kernels take (``field_consts.kernel_consts``), against a·b mod p and
against the plain versions. Every 64-bit intermediate is asserted to fit,
and every bound the CUDA comments rely on is asserted where it is used.
The kernels themselves run only on the card (``test_torch_cuda.py``)."""

import random

import numpy as np
import pytest
import torch

from bellpepper_tpu_torch.backend import field_kernels as fk
from bellpepper_tpu_torch.backend.field_consts import chain_mu, kernel_consts
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.fields import PALLAS_SCALAR, SCALAR, VESTA_SCALAR

FIELDS = [SCALAR, PALLAS_SCALAR, VESTA_SCALAR]
MASK = (1 << 32) - 1


def _words(v, n):
    return [(v >> (32 * i)) & MASK for i in range(n)]


def _int(ws):
    return sum(w << (32 * i) for i, w in enumerate(ws))


def _mac_row(r, off, x, y):
    carry = 0
    for j, yj in enumerate(y):
        t = x * yj + r[off + j] + carry
        assert t < 1 << 64
        r[off + j], carry = t & MASK, t >> 32
    return carry


def _mad_words(a, b, r):
    M = len(a)
    for i in range(M):
        assert r[i + M] == 0
        r[i + M] = _mac_row(r, i, a[i], b)


def _sub_words(x, y):
    d, borrow = [], 0
    for k in range(len(x)):
        t = x[k] - (y[k] if k < len(y) else 0) - borrow
        d.append(t & MASK)
        borrow = int(t < 0)
    return d, borrow


def _cond_sub_p(x, p8):
    d, borrow = _sub_words(x, p8)
    return x if borrow else d


def mulcmp_words(a, b, c, k):
    """bp::mulcmp_words on Python ints (a, b, c as integers)."""
    p2_11, p8, pinv = [int(v) for v in k[:9]], [int(v) for v in k[9:17]], int(k[17])
    negc, borrow = _sub_words(p2_11, _words(c, 9))
    assert borrow == 0
    r = negc + [0] * 9
    _mad_words(_words(a, 9), _words(b, 9), r)
    pend = 0
    for i in range(9):
        m = (r[i] * pinv) & MASK
        carry = _mac_row(r, i, m, p8)
        assert r[i] == 0
        t = r[i + 8] + carry + pend
        r[i + 8], pend = t & MASK, t >> 32
    assert r[17] + pend <= MASK
    r[17] += pend
    x, p = _int(r[9:]), _int(p8)
    assert x < 2 * p
    return int(x != 0 and x != p)


def canon_words(s, k):
    """bp::canon_words on Python ints: S < 2^291 in 10 words → (S mod p,
    q − q̂)."""
    p8 = [int(v) for v in k[:8]]
    mu = int(k[72]) | (int(k[73]) << 32)
    S, p = _int(s), _int(p8)
    assert S < 1 << 291 and s[9] < 8
    h = (s[9] << 61) | (s[8] << 29) | (s[7] >> 3)
    assert h == S >> 227 and h < 1 << 64
    q = (h * mu) >> 64
    qp = [0] * 9
    qp[8] = _mac_row(qp, 0, q & MASK, p8)
    carry = _mac_row(qp, 1, q >> 32, p8)  # dropped: modulo 2^288
    x, _ = _sub_words(s[:9], qp)
    assert _int(x) == S - q * p < 3 * p
    x = _cond_sub_p(_cond_sub_p(x, p8), p8)
    return _int(x[:8]), S // p - q


def mulmod_words(a, b, k):
    """bp::mulmod_words on Python ints (a, b < 2^256); also returns q − q̂."""
    fold = [[int(v) for v in k[8 + 8 * i : 16 + 8 * i]] for i in range(8)]
    t = [0] * 16
    _mad_words(_words(a, 8), _words(b, 8), t)
    s = t[:8] + [0, 0]
    for i in range(8):
        carry = _mac_row(s, 0, t[8 + i], fold[i])
        u = s[8] + carry
        s[8] = u & MASK
        s[9] += u >> 32
    p = _int([int(v) for v in k[:8]])
    assert _int(s) % p == a * b % p
    return canon_words(s, k)


def reduce_digit_words(d, k):
    """bp::reduce_digit_words on Python ints: 32 digit sums d[j] < 2^32 →
    (Σ d[j]·2^(8j) mod p, q − q̂)."""
    s, carry = [], 0
    for i in range(8):
        w = carry + d[4 * i] + (d[4 * i + 1] << 8) + (d[4 * i + 2] << 16) + (d[4 * i + 3] << 24)
        assert w < 1 << 57
        s.append(w & MASK)
        carry = w >> 32
    assert carry < 1 << 25
    s += [carry, 0]
    assert _int(s) == sum(x << (8 * j) for j, x in enumerate(d)) < 1 << 281
    return canon_words(s, k)


def addmod_words(a, b, k):
    p8 = [int(v) for v in k[:8]]
    s = a + b
    return _int(_cond_sub_p(_words(s, 9), p8)[:8])


def _mulcmp_cases(field, n, seed):
    """(a, b, c) columns at the domain's edges: every limb at its maximum
    (2^266 − 1), c = 0 and c = p·2^11 (the largest c), representatives
    a + k·p of equal residues, a·b − c one off a multiple of p, then
    random ones."""
    p = field.p
    rnd = random.Random(seed)
    top, cmax = (1 << 266) - 1, p << 11
    cases = []
    for a in (0, 1, p - 1, p, top):
        for b in (0, 1, p - 1, top):
            prod = a * b % p
            for c in (0, cmax, prod, prod + p * ((cmax - prod) // p), (prod + 1) % p, (prod - 1) % p):
                cases.append((a, b, c))
    while len(cases) < n:
        a, b = rnd.randrange(1 << 266), rnd.randrange(1 << 266)
        kind = len(cases) % 4
        if kind == 0:
            c = rnd.randrange(cmax + 1)
        else:
            c = (a * b + (kind - 2)) % p + p * rnd.randrange((cmax - p) // p)
        cases.append((a, b, c))
    return cases[:n]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_mulcmp_words_matches_python_ints_and_plain(field):
    p = field.p
    cases = _mulcmp_cases(field, 300, 11)
    k = kernel_consts(field)["mulcmp"]
    want = [int((a * b - c) % p != 0) for a, b, c in cases]
    assert [mulcmp_words(a, b, c, k) for a, b, c in cases] == want
    ops = [from_numpy_u32(np.asarray([[(col[t] >> (16 * l)) & 0xFFFF for col in cases] for l in range(17)],
                                     np.uint32)) for t in range(3)]
    assert to_numpy_u32(fk.mulcmp_plain(*ops, field)).tolist() == want


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_mulmod_words_matches_python_ints(field):
    """Corner operands, random ones, and products whose fold lands next to
    a multiple of p; the quotient estimate is never more than 2 short."""
    p = field.p
    k = kernel_consts(field)["chain"]
    rnd = random.Random(12)
    corners = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (1 << 128) % p, (1 << 255) % p]
    pairs = [(a, b) for a in corners for b in corners] + [(rnd.randrange(p), rnd.randrange(p)) for _ in range(400)]
    worst = 0
    for a, b in pairs:
        got, short = mulmod_words(a, b, k)
        assert got == a * b % p, (a, b)
        assert 0 <= short <= 2
        worst = max(worst, short)
        assert addmod_words(a, b, k) == (a + b) % p
    assert worst >= 1  # the estimate does fall short, so the subtracts are needed


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_chain_quotient_estimate_bound(field):
    """q − 2 ≤ q̂ ≤ q over folded values S = q·p + r at the ends of every
    quotient range the fold can give (S < 2^291), r at 0 and p − 1."""
    p = field.p
    mu = chain_mu(p)
    assert mu < 1 << 64
    q_max = ((1 << 291) - 1) // p
    rnd = random.Random(13)
    qs = [0, 1, 2, q_max - 1, q_max] + [rnd.randrange(q_max) for _ in range(2000)]
    qs += [(1 << e) + d for e in range(39) for d in (-1, 0, 1) if (1 << e) + d <= q_max]
    for q in qs:
        for r in (0, 1, p - 1):
            S = q * p + r
            if S >= 1 << 291:
                continue
            qh = ((S >> 227) * mu) >> 64
            assert q - 2 <= qh <= q, (q, r)


def test_chain_plain_matches_word_model():
    """chain_plain (the TPU's 16-bit pipeline) and the word model give the
    same canonical outputs on config 1's pattern."""
    p = SCALAR.p
    k = kernel_consts(SCALAR)["chain"]
    rnd = random.Random(14)
    N = 6
    x0 = [0, 1, p - 1] + [rnd.randrange(p) for _ in range(N - 3)]
    ext = [[rnd.randrange(p) for _ in range(N)] for _ in range(2)]

    def lm(vals):
        return from_numpy_u32(np.asarray([[(v >> (16 * l)) & 0xFFFF for v in vals] for l in range(16)], np.uint32))

    descs = (("fmul", "prev", 0), ("fadd", "prev", 1), ("fmul", "prev", "prev"))
    out = to_numpy_u32(fk.chain_plain(lm(x0), torch.cat([lm(ext[0]), lm(ext[1])]), descs, 4, SCALAR))
    for i in range(N):
        x = x0[i]
        for step in range(12):
            op, _a, bsrc = descs[step % 3]
            if op == "fmul":
                x, _ = mulmod_words(x, x if bsrc == "prev" else ext[0][i], k)
            else:
                x = addmod_words(x, ext[1][i], k)
            got = sum(int(out[16 * step + l, i]) << (16 * l) for l in range(16))
            assert got == x, (i, step)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_mul_plain_matches_word_model(field):
    """The mul kernel's steps: each operand's 16 limb rows joined into 8
    words (limbs 2w and 2w + 1 into word w), bp::mulmod_words, the 8
    result words split back into 16 limbs; the same limbs as mul_plain
    (the TPU's 16-bit pipeline) at the corners, the canonical values whose
    limbs below the top one are all 0xFFFF, and random operands."""
    p = field.p
    k = kernel_consts(field)["chain"]
    rnd = random.Random(15)
    low = (1 << 240) - 1
    corners = [0, 1, p - 1, p - 2, low, (((p >> 240) - 1) << 240) | low]
    pairs = [(a, b) for a in corners for b in corners] + [(rnd.randrange(p), rnd.randrange(p)) for _ in range(28)]

    def lm(vals):
        return np.asarray([[(v >> (16 * l)) & 0xFFFF for v in vals] for l in range(16)], np.uint32)

    A, B = lm([a for a, _ in pairs]), lm([b for _, b in pairs])
    want = to_numpy_u32(fk.mul_plain(from_numpy_u32(A), from_numpy_u32(B), field))
    for i, (a, b) in enumerate(pairs):
        wa = [int(A[2 * w, i]) | int(A[2 * w + 1, i]) << 16 for w in range(8)]
        wb = [int(B[2 * w, i]) | int(B[2 * w + 1, i]) << 16 for w in range(8)]
        assert (_int(wa), _int(wb)) == (a, b)
        r, _ = mulmod_words(_int(wa), _int(wb), k)
        rw = _words(r, 8)
        got = [x for w in rw for x in (w & 0xFFFF, w >> 16)]
        assert got == want[:, i].tolist(), (a, b)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_reduce_digit_words_matches_python_ints_and_plain(field):
    """The reduce_digits kernel's steps (bp::reduce_digit_words, its 16
    canonical limbs split from the 8 words): every sum 0, 1, 2^24 − 1 (the
    callers' bound) and 2^32 − 1 (the helper's), sums whose value is a
    multiple of p or one below one, and random sums below 2^24; Python's
    Σ d_j·2^(8j) mod p, and reduce_digits_plain (the TPU's pipeline) below
    2^24. The estimate never falls more than 2 short."""
    p = field.p
    k = kernel_consts(field)["chain"]
    rnd = random.Random(16)
    cols = [[v] * 32 for v in (0, 1, (1 << 24) - 1, (1 << 32) - 1)]
    for target in (0, p - 1):
        d = [rnd.randrange(256, 1 << 24) for _ in range(32)]
        r = (sum(x << (8 * j) for j, x in enumerate(d)) - target) % p
        cols.append([x - ((r >> (8 * j)) & 0xFF) for j, x in enumerate(d)])
    cols += [[(p >> (8 * j)) & 0xFF for j in range(32)]]
    cols += [[rnd.randrange(1 << 24) for _ in range(32)] for _ in range(40)]
    small = [c for c in cols if max(c) < 1 << 24]
    want = to_numpy_u32(fk.reduce_digits_plain(from_numpy_u32(np.asarray(small, np.uint32).T.copy()), field))
    i_small = 0
    for d in cols:
        V = sum(x << (8 * j) for j, x in enumerate(d))
        got, short = reduce_digit_words(d, k)
        assert got == V % p and 0 <= short <= 2
        if max(d) < 1 << 24:
            assert [(got >> (16 * l)) & 0xFFFF for l in range(16)] == want[:, i_small].tolist()
            i_small += 1
    assert [sum(x << (8 * j) for j, x in enumerate(c)) % p for c in cols[4:6]] == [0, p - 1]


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_mul_digits_plain_matches_word_model(field):
    """The mul_digits kernel's steps: the words of a < 2^256 (raw values
    p, p + 1, 2^256 − 1 among them) and b canonical, bp::mulmod_words,
    digit 4w + h = byte h of word w; the same digits as mul_digits_plain."""
    p = field.p
    k = kernel_consts(field)["chain"]
    rnd = random.Random(17)
    pairs = [(a, b) for a in (0, 1, p - 1, p, p + 1, (1 << 256) - 1) for b in (0, 1, p - 1)]
    pairs += [(rnd.randrange(1 << 256), rnd.randrange(p)) for _ in range(12)]

    def lm(vals):
        return from_numpy_u32(np.asarray([[(v >> (16 * l)) & 0xFFFF for v in vals] for l in range(16)], np.uint32))

    want = to_numpy_u32(fk.mul_digits_plain(lm([a for a, _ in pairs]), lm([b for _, b in pairs]), field))
    for i, (a, b) in enumerate(pairs):
        r, _ = mulmod_words(a, b, k)
        got = [(w >> (8 * h)) & 0xFF for w in _words(r, 8) for h in range(4)]
        assert r == a * b % p and got == want[:, i].tolist(), (a, b)
