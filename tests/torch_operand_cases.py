"""Product rows of every operand shape for ``operand_mulcmp`` and its
plain version, with their witness values and the exact mask from Python
integers. No JAX: the CPU tests and the card tests both use them.

An operand is a constant plus at most two ±1 terms (the row classifiers'
rule), each a field term (canonical limbs of one row of flimbs_p) or a
u32 term (one row of vals_p). Every operand shape occurs in A, B and C:
constant only; one or two field terms; one or two u32 terms; a field and
a u32 term; each term positive or negated; the constant 0, 1, p − 1 or
random. Half the rows are solved (their C holds a field row of its own,
set so that a·b ≡ c in every instance) and carry planted faults; the
others read random values, so nearly all of their columns are bad. A
third of the values are 0, 1 or p − 1 (u32: 0, 1 or 2^32 − 1)."""

from __future__ import annotations

import numpy as np

from bellpepper_tpu_torch.backend.layout import FIELD_SRC, U32_SRC
from bellpepper_tpu_torch.backend.words import from_numpy_u32

F_, U_ = FIELD_SRC, U32_SRC
# term lists (source, negated) of the operand shapes
SHAPES = [
    [], [(F_, 0)], [(F_, 1)], [(F_, 0), (F_, 0)], [(F_, 0), (F_, 1)], [(F_, 1), (F_, 1)],
    [(U_, 0)], [(U_, 1)], [(U_, 0), (U_, 1)], [(U_, 1), (U_, 1)],
    [(F_, 0), (U_, 0)], [(F_, 1), (U_, 0)], [(U_, 1), (F_, 0)], [(F_, 1), (U_, 1)],
]


def operand_rows(field, n_rows: int, B: int, seed: int, *, u32: bool = True, n_faults: int = 16,
                 n_pool: int = 24):
    """(rows_specs, flimbs int32[F, 16, B], vals int32[S, B] or None,
    want bool[n_rows, B]). rows_specs is the classifiers' list of (row,
    spec_a, spec_b, spec_c), spec = (const, [(src, idx, neg)]). Without
    `u32` no term reads vals (the limbs checks' call)."""
    p = field.p
    rng = np.random.default_rng(seed)
    shapes = SHAPES if u32 else [s for s in SHAPES if all(src == F_ for src, _ in s)]

    def draw(corners, top):
        if rng.random() < 1 / 3:
            return corners[int(rng.integers(3))]
        return int.from_bytes(rng.bytes(32), "little") % top

    field_vals = [[draw((0, 1, p - 1), p) for _ in range(B)] for _ in range(n_pool)]
    u32_vals = [[draw((0, 1, (1 << 32) - 1), 1 << 32) for _ in range(B)] for _ in range(n_pool)]
    specs = []
    for r in range(n_rows):
        sides = []
        for oi in range(3):
            shape = shapes[(r // 2 + 5 * oi + r * oi) % len(shapes)]
            terms = [(src, int(rng.integers(n_pool)), neg) for src, neg in shape]
            if oi == 2 and r % 2 == 0:  # solved: C's first term is a field row of its own
                terms = [(F_, len(field_vals), int(rng.integers(2)))] + terms[:1]
                field_vals.append(None)
            sides.append((draw((0, 1, p - 1), p), terms))
        specs.append((r, *sides))

    def value(spec, b):
        const, terms = spec
        v = const
        for src, idx, neg in terms:
            x = field_vals[idx][b] if src == F_ else u32_vals[idx][b]
            v += p - x if neg else x
        return v % p

    for r, sa, sb, sc in specs[::2]:
        _src, d, neg = sc[1][0]
        rest = (sc[0], sc[1][1:])
        field_vals[d] = [(-1 if neg else 1) * (value(sa, b) * value(sb, b) - value(rest, b)) % p
                         for b in range(B)]
    for _ in range(n_faults):
        d = specs[2 * int(rng.integers((n_rows + 1) // 2))][3][1][0][1]
        b = int(rng.integers(B))
        field_vals[d][b] = (field_vals[d][b] + 1 + int(rng.integers(1 << 62)) % (p - 1)) % p
    want = np.array([[value(sa, b) * value(sb, b) % p != value(sc, b) for b in range(B)]
                     for _r, sa, sb, sc in specs], bool).reshape(n_rows, B)
    limbs = np.array([[[(v >> (16 * l)) & 0xFFFF for v in col] for l in range(16)] for col in field_vals],
                     np.uint32)
    vals = from_numpy_u32(np.asarray(u32_vals, np.uint32)) if u32 else None
    return specs, from_numpy_u32(limbs), vals, want


def shift_field_rows(specs, k: int):
    """The same rows with every field term's limb row moved up by k."""
    return [(r, *((c, [(src, idx + k if src == F_ else idx, ng) for src, idx, ng in t]) for c, t in sides))
            for r, *sides in specs]


def decode_table(table):
    """The packed descriptors of an ``OperandTable`` read back in Python
    integers: per row, for A, B and C, (const, sorted [(src, idx, neg)])."""
    desc = table.desc.cpu().numpy().astype(np.int64)
    words = table.consts.cpu().numpy().view(np.uint32)
    consts = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]
    rows = []
    for d in desc:
        ops = []
        for o in range(3):
            flags, cid, *idx = (int(v) for v in d[6 * o: 6 * o + 6])
            terms = [(F_ if t < 2 else U_, idx[t], (flags >> (4 + t)) & 1) for t in range(4) if flags >> t & 1]
            ops.append((consts[cid], sorted(terms)))
        rows.append(ops)
    return rows

