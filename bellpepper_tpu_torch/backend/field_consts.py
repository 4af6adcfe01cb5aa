"""Host-side integer constants of one prime field, for the field kernels.

Copied from ``bellpepper_tpu/backend/field_pallas.py:39-114`` (``_digits``,
``_Consts``, ``_QE_ERR``) and ``:1050`` (``fold_digit_table``) as plain
Python ints, with the exhaustive check of the quotient-estimate bound kept
as it is. ``kernel_consts`` packs the
rows the CUDA kernels read into flat uint32 arrays (the layouts of the
constant structs in ``csrc/field.cuh``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..fields import PrimeField

L16 = 16
L8 = 32
SEMI = 17  # limbs of the semi-reduced form (< p·2^11 < 2^266)
_QE_ERR = 6  # cond-subtract coverage: x' < 7p < 8p → sub 4p, 2p, p
QE_BITS = 28  # the word tail's estimate keeps h = S >> (NUM_BITS − 28) below 2^64


def _digits(v: int, width: int, count: int) -> List[int]:
    mask = (1 << width) - 1
    return [(v >> (width * i)) & mask for i in range(count)]


class _Consts:
    """Host-side integer constants baked into kernels for one field."""

    def __init__(self, field: PrimeField):
        p = field.p
        self.p16 = _digits(p, 16, L16)
        # Fold rows: limbs8(2^(8*(32+i)) mod p), i = 0..33.
        self.fold = [_digits(pow(2, 8 * (L8 + i), p), 8, L8) for i in range(34)]
        # 16-bit-basis fold rows: limbs16(2^(16*(16+i)) mod p), i = 0..17
        # (18 rows: the 34-position product of two 17-limb semi-reduced
        # values folds positions 16..33).
        self.fold16 = [
            _digits(pow(2, 16 * (L16 + i), p), 16, L16) for i in range(18)
        ]
        # Split-multiplier companion rows limbs16(2^(16·(16+i)+8) mod p):
        # folding position 16+i with its multiplier split as m0 + 2^8·m1
        # keeps every product m·entry < 2^24.
        self.fold16_hi = [
            _digits(pow(2, 16 * (L16 + i) + 8, p), 16, L16) for i in range(18)
        ]
        # p·2^11 as 17 limbs: a multiple of p exceeding any 17-limb
        # semi-reduced value (< 2^266), for borrow-free negation.
        self.p2_17 = _digits(p << 11, 16, 17)
        # Final-fold rows at 8-bit multiplier granularity:
        # limbs16(2^(256 + 8i) mod p), i = 0..2.
        self.fold16b = [
            _digits(pow(2, 256 + 8 * i, p), 16, L16) for i in range(3)
        ]
        # Shift-subtract chain: p << k as 17 16-bit limbs, high k first.
        n_steps = 266 - field.NUM_BITS
        self.ps = [_digits(p << k, 16, 17) for k in range(n_steps - 1, -1, -1)]
        # p^{-1} mod 2^16 (p odd): the Montgomery zero-test constant.
        self.p0inv = pow(p, -1, 1 << 16) if p % 2 else None
        # Quotient-estimate canonicalization for 253..256-bit fields:
        # q̂ = floor(T·r / 2^28) with T = floor(x/2^240) and
        # r = floor(2^28 / ceil(p/2^240)) underestimates q = floor(x/p)
        # by at most _QE_ERR, verified exhaustively over multiples of p.
        self.qe = None
        if 253 <= field.NUM_BITS <= 256:
            D = -(-p // (1 << 240))
            r = (1 << 28) // D
            q_max = ((1 << 266) - 1) // p
            worst = 0
            for k in range(0, q_max + 1):
                for x in (k * p, k * p + p - 1, min((k + 1) * p - 1, (1 << 266) - 1)):
                    if x >= (1 << 266):
                        continue
                    t0 = (x >> 240) & 0xFFFF
                    t1 = x >> 256
                    qh = ((t0 * r) >> 28) + ((t1 * r) >> 12)
                    q = x // p
                    assert 0 <= q - qh, (k, x)
                    worst = max(worst, q - qh)
            assert worst <= _QE_ERR, f"quotient estimate error {worst}"
            self.qe = r


_CONSTS: Dict[int, _Consts] = {}


def consts_for(field: PrimeField) -> _Consts:
    """The (cached) constants of `field`."""
    c = _CONSTS.get(field.p)
    if c is None:
        c = _CONSTS[field.p] = _Consts(field)
    return c


def fold_digit_table(field: PrimeField, coeff_table) -> np.ndarray:
    """uint32[n_coeff, 32, 32]: entry [t, j, d] = digit d of
    (coeff_table[t] · 2^(8j) mod p), the per-coefficient fold matrices of
    the limbs matvec (``field_pallas.fold_digit_table``)."""
    p = field.p
    out = np.zeros((len(coeff_table), L8, L8), np.uint32)
    for t, c in enumerate(coeff_table):
        c = int(c) % p
        for j in range(L8):
            out[t, j] = _digits((c << (8 * j)) % p, 8, L8)
    return out


def word_count(p: int) -> int:
    """W = ceil(NUM_BITS / 32): the 32-bit words of a canonical element."""
    return -(-p.bit_length() // 32)


def chain_shift(p: int) -> int:
    """The word tail's estimate shift s = max(0, NUM_BITS − 28): a folded
    S < 2^36·p gives h = S >> s < 2^64, and 2^s/p < 2^-27 (or 1/p at s
    = 0) keeps q̂ within 2 of q (``bp::canon_words``)."""
    return max(0, p.bit_length() - QE_BITS)


def chain_mu(p: int) -> int:
    """The quotient-estimate constant of the word tail
    (``bp::canon_words``): floor(2^(64 + s)/p) for s = ``chain_shift(p)``,
    below 2^37 when s > 0 and below 2^63 when s = 0 (floor(2^291/p) for a
    255-bit p)."""
    return (1 << (64 + chain_shift(p))) // p


_KERNEL_CONSTS: Dict[int, Dict[str, np.ndarray]] = {}


def _chain_block(p: int) -> List[int]:
    W = word_count(p)
    return (
        _digits(p, 32, 8)
        + [v for i in range(8) for v in _digits(pow(2, 32 * (W + i), p), 32, 8)]
        + _digits(chain_mu(p), 32, 2)
        + [W, chain_shift(p) - 32 * max(0, W - 2)]
    )


def kernel_consts(field: PrimeField) -> Dict[str, np.ndarray]:
    """Flat uint32 constant blocks (cached per field) in the layouts the
    CUDA kernels take:

    * ``chain``      [8 + 8·8 + 2 + 2]: p as 8 words, the fold rows
      2^(32·(W+i)) mod p (i < 8) as 8 words each (W = ``word_count(p)``;
      words past W are 0), mu = ``chain_mu(p)`` as its low and high words,
      W, and the estimate's shift within its window, s − 32·max(0, W − 2),
      for chain, mul, mul_digits and reduce_digits (``bp::ChainConsts``:
      the word tail of every odd p < 2^256);
    * ``reduce``     [4·32 + the chain block]: fold rows 0..3 (8-bit
      digits) and the chain block, for the fold matvec (its semi output
      reads the fold rows, its canonical output the word tail;
      ``bp::ReduceConsts``);
    * ``mulcmp``     [9 + 8 + 1]: p·2^11 as 9 32-bit words, p as 8 words,
      and −p^-1 mod 2^32, for mulcmp (``bp::MulcmpConsts``)."""
    out = _KERNEL_CONSTS.get(field.p)
    if out is not None:
        return out
    c = consts_for(field)
    if c.p0inv is None:
        raise ValueError("the field kernels need an odd modulus")
    p = field.p
    if p >= 1 << 256:
        raise ValueError("the word kernels hold p in 8 32-bit words")
    mulcmp = _digits(p << 11, 32, 9) + _digits(p, 32, 8) + [(-pow(p, -1, 1 << 32)) % (1 << 32)]
    chain = _chain_block(p)
    out = _KERNEL_CONSTS[field.p] = {
        "reduce": np.asarray([v for row in c.fold[:4] for v in row] + chain, np.uint32),
        "mulcmp": np.asarray(mulcmp, np.uint32),
        "chain": np.asarray(chain, np.uint32),
    }
    return out
