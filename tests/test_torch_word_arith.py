"""The 32-bit-word arithmetic of the mulcmp, chain, mul, mul_digits and
reduce_digits CUDA kernels (``bp::mulcmp_words``, ``bp::canon_words``,
``bp::mulmod_words``, ``bp::reduce_digit_words``, ``bp::addmod_words`` in
``csrc/field.cuh``), step for step in Python ints over the constant blocks
the kernels take (``field_consts.kernel_consts``), against a·b mod p and
against the plain versions. The word tail is one template on the field's
word count W = ceil(NUM_BITS/32); its model runs at the shipped 255-bit
fields and at Goldilocks (W 2), 2^127 − 1 (4), P-192's prime (6) and
Jubjub's scalar field (8, 252 bits). Every 64-bit intermediate is asserted
to fit, and every bound the CUDA comments rely on is asserted where it is
used. The kernels themselves run only on the card
(``test_torch_cuda.py``)."""

import random

import numpy as np
import pytest
import torch

from bellpepper_tpu_torch.backend import field_kernels as fk
from bellpepper_tpu_torch.backend.field_consts import chain_mu, chain_shift, kernel_consts, word_count
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.fields import PALLAS_SCALAR, SCALAR, VESTA_SCALAR
from torch_small_fields import GOLDILOCKS, JUBJUB_FR, SMALL_FIELDS

FIELDS = [SCALAR, PALLAS_SCALAR, VESTA_SCALAR] + SMALL_FIELDS  # the word tail's
SEMI_FIELDS = [SCALAR, PALLAS_SCALAR, VESTA_SCALAR, JUBJUB_FR]  # mulcmp's: 250..256 bits
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


def _chain_consts(k):
    """(p as W words, the W-word fold rows, mu, W, shift) of a chain block."""
    W, shift = int(k[74]), int(k[75])
    p = [int(v) for v in k[:W]]
    fold = [[int(v) for v in k[8 + 8 * i : 8 + 8 * i + W]] for i in range(8)]
    assert all(int(v) == 0 for i in range(8) for v in k[8 + 8 * i + W : 16 + 8 * i])
    return p, fold, int(k[72]) | (int(k[73]) << 32), W, shift


def canon_words(s, k):
    """bp::canon_words<W> on Python ints: S < 2^36·p in W + 2 words → (S
    mod p, q − q̂)."""
    pw, _fold, mu, W, shift = _chain_consts(k)
    S, p = _int(s), _int(pw)
    assert len(s) == W + 2 and S < p << 36
    b = max(0, W - 2)
    win = [s[i] if i < len(s) else 0 for i in range(b, b + 4)]
    lo, hi = win[0] | (win[1] << 32), win[2] | (win[3] << 32)
    h = ((lo >> shift) | (((hi << 1) & (2**64 - 1)) << (63 - shift))) & (2**64 - 1)
    assert 32 * b + shift == chain_shift(p) and h == S >> chain_shift(p) and h < 1 << 64
    q = (h * mu) >> 64
    qp = [0] * (W + 1)
    qp[W] = _mac_row(qp, 0, q & MASK, pw)
    _mac_row(qp, 1, q >> 32, pw)  # its carry dropped: modulo 2^(32·(W+1))
    x, _ = _sub_words(s[: W + 1], qp)
    assert _int(x) == S - q * p < 3 * p
    x = _cond_sub_p(_cond_sub_p(x, pw), pw)
    return _int(x[:W]), S // p - q


def _fold_word(s, v, row):
    W = len(row)
    carry = _mac_row(s, 0, v, row)
    u = s[W] + carry
    s[W] = u & MASK
    s[W + 1] += u >> 32
    assert s[W + 1] <= MASK


def mulmod_words(a, b, k, wa=8):
    """bp::mulmod_words<W, WA> on Python ints (a < 2^(32·WA), b
    canonical); also returns q − q̂."""
    pw, fold, _mu, W, _shift = _chain_consts(k)
    p = _int(pw)
    assert a < 1 << (32 * wa) and b < p
    t = [0] * (wa + W)
    for i, ai in enumerate(_words(a, wa)):
        assert t[i + W] == 0
        t[i + W] = _mac_row(t, i, ai, _words(b, W))
    s = t[:W] + [0, 0]
    for i in range(wa):
        _fold_word(s, t[W + i], fold[i])
    assert _int(s) % p == a * b % p and _int(s) < 9 * p << 32
    return canon_words(s, k)


def reduce_words9(v, k):
    """bp::reduce_words9<W>: a 9-word V < 2^288, words W..8 folded, then
    canon_words."""
    pw, fold, _mu, W, _shift = _chain_consts(k)
    s = v[:W] + [0, 0]
    for j in range(W, 9):
        _fold_word(s, v[j], fold[j - W])
    assert _int(s) % _int(pw) == _int(v) % _int(pw)
    return canon_words(s, k)


def fold_canonical_words(d, k):
    """bp::digit_limbs<W> (fold_matvec's canonical output): the TPU's
    first carry of 32 digit sums d[j] < 2^32 to 36 8-bit digits in uint32
    (it wraps where a sum near 2^32 meets a carry), the digits joined into
    9 words, then reduce_words9; the value and q − q̂."""
    carry, dig = 0, []
    for i in range(36):
        tot = ((d[i] if i < 32 else 0) + carry) & MASK
        dig.append(tot & 0xFF)
        carry = tot >> 8
    v = [dig[4 * i] | (dig[4 * i + 1] << 8) | (dig[4 * i + 2] << 16) | (dig[4 * i + 3] << 24) for i in range(9)]
    return reduce_words9(v, k)


def reduce_digit_words(d, k, fold8=True):
    """bp::reduce_digit_words<W, fold8> on Python ints: 32 digit sums d[j]
    < 2^32 → (Σ d[j]·2^(8j) mod p, q − q̂). fold8=False: the 8-word
    fields of at least 245 bits (shift ≥ 25), whose 9 words go to the tail
    unfolded."""
    v, carry = [], 0
    for i in range(8):
        w = carry + d[4 * i] + (d[4 * i + 1] << 8) + (d[4 * i + 2] << 16) + (d[4 * i + 3] << 24)
        assert w < 1 << 57
        v.append(w & MASK)
        carry = w >> 32
    assert carry < 1 << 25
    v.append(carry)
    assert _int(v) == sum(x << (8 * j) for j, x in enumerate(d)) < 1 << 281
    if not fold8:
        assert int(k[74]) == 8 and int(k[75]) >= 25
        return canon_words(v + [0], k)
    return reduce_words9(v, k)


def addmod_words(a, b, k):
    pw, _fold, _mu, W, _shift = _chain_consts(k)
    s = a + b
    return _int(_cond_sub_p(_words(s, W + 1), pw)[:W])


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


@pytest.mark.parametrize("field", SEMI_FIELDS, ids=lambda f: f.name)
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
        for wa in (8, word_count(p)):  # mul's raw-a form, chain's canonical one
            got, short = mulmod_words(a, b, k, wa)
            assert got == a * b % p, (a, b)
            assert 0 <= short <= 2
            worst = max(worst, short)
        assert addmod_words(a, b, k) == (a + b) % p
    assert worst >= 1  # the estimate does fall short, so the subtracts are needed


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_chain_quotient_estimate_bound(field):
    """q − 2 ≤ q̂ ≤ q over folded values S = q·p + r at the ends of every
    quotient range the fold can give (S < 2^(32W) + 8·2^32·p ≤ 9·2^32·p,
    a product's fold; a digit sum's is smaller), r at 0, 1 and p − 1, with
    h = S >> s < 2^64 for s = max(0, NUM_BITS − 28) (227 at 255 bits, 36
    at Goldilocks)."""
    p = field.p
    mu, s = chain_mu(p), chain_shift(p)
    assert mu < 1 << 64
    S_max = (1 << (32 * word_count(p))) + 8 * MASK * (p - 1)
    assert S_max < 9 * p << 32 and S_max >> s < 1 << 64
    q_max = S_max // p
    rnd = random.Random(13)
    qs = [0, 1, 2, q_max - 1, q_max] + [rnd.randrange(q_max) for _ in range(2000)]
    qs += [(1 << e) + d for e in range(q_max.bit_length()) for d in (-1, 0, 1) if (1 << e) + d <= q_max]
    for q in qs:
        for r in (0, 1, p - 1):
            S = q * p + r
            if S > S_max:
                continue
            qh = ((S >> s) * mu) >> 64
            assert q - 2 <= qh <= q, (q, r)


def _chain_case(field):
    """chain_plain and the chain kernel's steps (bp::mulmod_words<W, W>,
    bp::addmod_words<W>) on config 1's pattern."""
    p = field.p
    k = kernel_consts(field)["chain"]
    W = word_count(p)
    rnd = random.Random(14)
    N = 6
    x0 = [0, 1, p - 1] + [rnd.randrange(p) for _ in range(N - 3)]
    ext = [[rnd.randrange(p) for _ in range(N)] for _ in range(2)]

    def lm(vals):
        return from_numpy_u32(np.asarray([[(v >> (16 * l)) & 0xFFFF for v in vals] for l in range(16)], np.uint32))

    descs = (("fmul", "prev", 0), ("fadd", "prev", 1), ("fmul", "prev", "prev"))
    out = to_numpy_u32(fk.chain_plain(lm(x0), torch.cat([lm(ext[0]), lm(ext[1])]), descs, 4, field))
    for i in range(N):
        x = x0[i]
        for step in range(12):
            op, _a, bsrc = descs[step % 3]
            if op == "fmul":
                x, _ = mulmod_words(x, x if bsrc == "prev" else ext[0][i], k, W)
            else:
                x = addmod_words(x, ext[1][i], k)
            got = sum(int(out[16 * step + l, i]) << (16 * l) for l in range(16))
            assert got == x, (i, step)


def test_chain_plain_matches_word_model():
    """chain_plain (the TPU's 16-bit pipeline) and the word model give the
    same canonical outputs on config 1's pattern."""
    _chain_case(SCALAR)


@pytest.mark.parametrize("field", SMALL_FIELDS, ids=lambda f: f.name)
def test_chain_plain_matches_word_model_below_253_bits(field):
    """The same below 253 bits, where chain_plain's 16-bit pipeline ends in
    ``_canon_rows`` and the kernel works on the field's W words."""
    _chain_case(field)


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
    top = 16 * ((p.bit_length() - 1) // 16)  # the bit offset of p's top limb
    low = (1 << top) - 1
    corners = [0, 1, p - 1, p - 2, low, (((p >> top) - 1) << top) | low]
    pairs = [(a, b) for a in corners for b in corners] + [(rnd.randrange(p), rnd.randrange(p)) for _ in range(28)]

    def lm(vals):
        return np.asarray([[(v >> (16 * l)) & 0xFFFF for v in vals] for l in range(16)], np.uint32)

    A, B = lm([a for a, _ in pairs]), lm([b for _, b in pairs])
    want = to_numpy_u32(fk.mul_plain(from_numpy_u32(A), from_numpy_u32(B), field))
    for i, (a, b) in enumerate(pairs):
        wa = [int(A[2 * w, i]) | int(A[2 * w + 1, i]) << 16 for w in range(8)]
        wb = [int(B[2 * w, i]) | int(B[2 * w + 1, i]) << 16 for w in range(8)]
        assert (_int(wa), _int(wb)) == (a, b)
        assert _int(wb[word_count(p):]) == 0  # the kernel reads b's W low words
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
    unfolded = word_count(p) == 8 and chain_shift(p) >= 217  # the kernel's instantiation without the fold
    for d in cols:
        V = sum(x << (8 * j) for j, x in enumerate(d))
        got, short = reduce_digit_words(d, k, not unfolded)
        assert got == V % p and 0 <= short <= 2
        assert reduce_digit_words(d, k)[0] == got
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


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_fold_canonical_tail_matches_plain(field):
    """fold_matvec's canonical epilogue (bp::digit_limbs: the TPU's uint32
    carry, then the word tail) against limbs_matvec's plain reduction
    (_reduce_rows) on digit sums up to 2^32 − 1: every sum at its largest
    and just below (where the TPU's first carry wraps 32 bits), the
    K = 2,064 bound's sums, and random sums below 2^24 and 2^32; the
    estimate never falls more than 2 short."""
    p = field.p
    k = kernel_consts(field)["chain"]
    rnd = random.Random(18)
    top = 2064 * 32 * 255 * 255  # the fused limbs route's largest digit sum
    cols = [[MASK] * 32, [MASK - 5] * 32, [top] * 32, [top if j % 2 else 0 for j in range(32)], [0] * 32]
    cols += [[rnd.randrange(1 << rnd.choice((24, 32))) for _ in range(32)] for _ in range(60)]
    want = to_numpy_u32(fk.reduce_digits_plain(from_numpy_u32(np.asarray(cols, np.uint32).T.copy()), field))
    wraps = 0
    for i, d in enumerate(cols):
        got, short = fold_canonical_words(d, k)
        assert 0 <= short <= 2 and got < p
        assert [(got >> (16 * l)) & 0xFFFF for l in range(16)] == want[:, i].tolist(), i
        wraps += got != sum(x << (8 * j) for j, x in enumerate(d)) % p
    assert wraps >= 2  # the carry does wrap at the top sums, as the TPU's does
