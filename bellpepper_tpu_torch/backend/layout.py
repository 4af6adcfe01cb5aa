"""Host-side (numpy) row classifiers and layout builders of the check.

Copies of functions in ``bellpepper_tpu/backend/matvec.py``, whose module
imports JAX; the outputs are identical array for array (the parity tests
hold each one against the reference):

  * ``MAX_ROW_NNZ``, ``_assert_row_density``       matvec.py:765, :768
  * ``EllMatrix``                                  matvec.py:782
  * ``_build_shared_ell``                          matvec.py:1080
  * ``_classify_small_rows``                       matvec.py:1189
  * ``_sub_rows_r1cs``                             matvec.py:1243
  * ``_used_slot_template``                        matvec.py:2033-2061
  * ``_classify_trivial_limb_rows``                matvec.py:1290
  * ``MAX_FUSED_LIMBS_K``                          field_pallas.py:972
  * ``_classify_bit_row_families``                 matvec.py:2119
  * ``_classify_pow2_eq_rows``                     matvec.py:2284
  * ``_classify_mixed_rows``                       matvec.py:1537

``_classify_mixed_rows`` adds one guard the reference lacks: a pow2 row
whose worst-case side values break the bounds that the mixed check's
borrow-free offset subtraction and 3-limb Montgomery quotient rely on
raises ``ValueError`` (the reference would check it unsoundly).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, NamedTuple

import numpy as np

from ..r1cs import COOMatrix, R1CS

# Source kinds of the mixed check's row terms.
U32_SRC = 0
FIELD_SRC = 1

# The mixed check's pow2 rows compute d = A + (p·2^POW2_OFF_BITS − C) and
# test p | d through a POW2_M_LIMBS-limb Montgomery quotient.
POW2_OFF_BITS = 34
POW2_M_LIMBS = 3

# The 8-bit digit row sums accumulate in uint32 lanes; they are exact only
# while 255·nnz plus the running carry fits 32 bits.
MAX_ROW_NNZ = (1 << 24) // 255

# The widest ELL row of the fused limbs route: its uint32 digit sums hold
# Σ over 32K digit pairs of products < 255².
MAX_FUSED_LIMBS_K = ((1 << 32) // (255 * 255)) // 32  # = 2064


def _assert_row_density(rows: np.ndarray, num_rows: int, what: str) -> None:
    if len(rows) == 0:
        return
    max_nnz = int(np.bincount(rows, minlength=num_rows).max())
    if max_nnz > MAX_ROW_NNZ:
        raise ValueError(
            f"{what}: a row has {max_nnz} entries; the digit accumulation "
            f"is exact only up to {MAX_ROW_NNZ} entries per row"
        )


class EllMatrix(NamedTuple):
    """Bucketed sparse layout: rows are permuted into buckets of uniform
    padded width K (next power of two of the row's nnz); entries are
    stored bucket-major so each bucket's row sums are a dense
    ``reshape([Rk, K, ...]).sum(1)``."""

    cols: np.ndarray  # int32[total_slots] (bucket-major, padded)
    coeff_ids: np.ndarray  # int32[total_slots]
    buckets: tuple  # ((K, start_slot, n_rows), ...) static
    inv_pos: np.ndarray  # int32[R]: global row -> position in bucket order


def _build_shared_ell(template: R1CS, zero_id: int):
    """ELL layouts for A, B, C with ONE shared row permutation (rows sorted
    by the (K_a, K_b, K_c) bucket-width triple), every segment padded to a
    multiple of 8 rows. All three matvecs produce rows in the same padded
    bucket order.

    Returns (layouts, pos_of_row, padded_rows): pos_of_row[r] is the
    padded-bucket-order position of original row r."""
    R = template.num_constraints
    if R == 0:
        empty = EllMatrix(
            cols=np.zeros(0, np.int32),
            coeff_ids=np.zeros(0, np.int32),
            buckets=(),
            inv_pos=np.empty(0, np.int32),
        )
        return ({n: empty for n in ("a", "b", "c")}, np.empty(0, np.int32), 0)
    Ks = {}
    per = {}
    for name in ("a", "b", "c"):
        m = getattr(template, name)
        _assert_row_density(m.rows, R, f"matrix {name}")
        order = np.argsort(m.rows, kind="stable")
        nnz = np.bincount(m.rows, minlength=R).astype(np.int64)
        ptr = np.zeros(R + 1, np.int64)
        np.cumsum(nnz, out=ptr[1:])
        K = np.maximum(1, 2 ** np.ceil(np.log2(np.maximum(nnz, 1))).astype(np.int64))
        Ks[name] = K
        per[name] = (m.cols[order], m.coeff_ids[order], nnz, ptr)

    perm = np.lexsort((np.arange(R), Ks["c"], Ks["b"], Ks["a"]))
    key = np.stack([Ks[n][perm] for n in ("a", "b", "c")], axis=1)
    change = np.any(key[1:] != key[:-1], axis=1)
    seg_starts = np.concatenate([[0], np.nonzero(change)[0] + 1])
    seg_ends = np.concatenate([seg_starts[1:], [R]])
    seg_counts = seg_ends - seg_starts
    seg_padded = -(-seg_counts // 8) * 8
    seg_base = np.zeros(len(seg_starts) + 1, np.int64)
    np.cumsum(seg_padded, out=seg_base[1:])
    padded_rows = int(seg_base[-1])

    # Padded position of each original row.
    seg_of = np.repeat(np.arange(len(seg_starts)), seg_counts)
    off_in_seg = np.arange(R) - seg_starts[seg_of]
    pos_perm = seg_base[seg_of] + off_in_seg  # position of perm[j]
    pos_of_row = np.empty(R, np.int64)
    pos_of_row[perm] = pos_perm

    layouts = {}
    for name in ("a", "b", "c"):
        cols_s, cids_s, nnz, ptr = per[name]
        Kp = Ks[name][perm]
        nnz_p = nnz[perm]
        seg_K = Kp[seg_starts]
        # Slot base per segment (padded rows included).
        seg_slots = seg_padded * seg_K
        slot_base = np.zeros(len(seg_starts) + 1, np.int64)
        np.cumsum(seg_slots, out=slot_base[1:])
        total = int(slot_base[-1])
        cols_arr = np.zeros(total, np.int32)
        cids_arr = np.full(total, zero_id, np.int32)
        # Per original (permuted) row: its slot range.
        row_slot0 = slot_base[seg_of] + off_in_seg * seg_K[seg_of]
        if len(cols_s):
            e_rows = np.repeat(np.arange(R), nnz_p)  # perm-order row per entry
            within = np.arange(len(cols_s)) - np.repeat(
                np.cumsum(np.concatenate([[0], nnz_p[:-1]])), nnz_p
            )
            src = ptr[perm[e_rows]] + within
            target = row_slot0[e_rows] + within
            cols_arr[target] = cols_s[src]
            cids_arr[target] = cids_s[src]
        buckets = []
        for si in range(len(seg_starts)):
            k = int(seg_K[si])
            n_rows = int(seg_padded[si])
            if buckets and buckets[-1][0] == k:
                pk, poff, pn = buckets[-1]
                buckets[-1] = (pk, poff, pn + n_rows)
            else:
                buckets.append((k, int(slot_base[si]), n_rows))
        layouts[name] = EllMatrix(
            cols=cols_arr,
            coeff_ids=cids_arr,
            buckets=tuple(buckets),
            inv_pos=np.empty(0, np.int32),  # unused (shared perm)
        )
    return layouts, pos_of_row.astype(np.int32), padded_rows


# Small-row fast path for bit-valued witnesses: a row whose SIGNED
# coefficient magnitudes satisfy (Σ|a_i|)·(Σ|b_i|) < 2^31 and Σ|c_i| < 2^31
# can be checked EXACTLY over the integers — no value can reach the
# modulus, so a·b = c over ℤ iff over 𝔽_p.
_SMALL_ROW_BOUND = 1 << 31


def _classify_small_rows(template: R1CS):
    """(small_idx, big_idx, layouts) for the bits-form row partition, or
    None when fewer than half the rows qualify.
    layouts[name] = (cols [n_small, K], signed_coeffs [n_small, K])."""
    p = template.field.p
    R = template.num_constraints
    sv = []
    for c in template.coeff_table:
        v = int(c) % p
        sv.append(v if v <= p // 2 else v - p)
    # |sv| clipped to 2^40 — only the < 2^31 comparison matters, and the
    # clip keeps int64 row sums overflow-free for any row density.
    absw = np.asarray([min(abs(s), 1 << 40) for s in sv], np.int64)
    bound = {}
    for name in ("a", "b", "c"):
        m = getattr(template, name)
        b = np.zeros(R, np.int64)
        np.add.at(b, np.asarray(m.rows), absw[np.asarray(m.coeff_ids)])
        bound[name] = b
    small = (
        bound["a"].astype(np.float64) * bound["b"].astype(np.float64)
        < _SMALL_ROW_BOUND
    ) & (bound["c"] < _SMALL_ROW_BOUND)
    n_small = int(small.sum())
    if n_small <= R // 2:
        return None
    small_idx = np.nonzero(small)[0].astype(np.int32)
    big_idx = np.nonzero(~small)[0].astype(np.int32)
    small_pos = np.full(R, -1, np.int64)
    small_pos[small_idx] = np.arange(n_small)
    sv32 = np.asarray([int(s) if abs(s) < (1 << 31) else 0 for s in sv],
                      np.int32)
    layouts = {}
    for name in ("a", "b", "c"):
        m = getattr(template, name)
        rows = np.asarray(m.rows)
        sel = small[rows]
        r_s = small_pos[rows[sel]]
        c_s = np.asarray(m.cols)[sel]
        s_s = sv32[np.asarray(m.coeff_ids)[sel]]
        deg = np.bincount(r_s, minlength=n_small)
        K = max(int(deg.max()) if n_small else 0, 1)
        order = np.lexsort((np.arange(len(r_s)), r_s))
        slot = np.arange(len(r_s)) - np.repeat(
            np.concatenate(([0], np.cumsum(deg)[:-1])), deg
        )
        colp = np.zeros((n_small, K), np.int32)
        scop = np.zeros((n_small, K), np.int32)
        colp[r_s[order], slot] = c_s[order]
        scop[r_s[order], slot] = s_s[order]
        layouts[name] = (colp, scop)
    return small_idx, big_idx, layouts


def _sub_rows_r1cs(template: R1CS, keep_idx: np.ndarray) -> R1CS:
    """The sub-system containing only rows `keep_idx` (renumbered)."""
    R = template.num_constraints
    pos = np.full(R, -1, np.int64)
    pos[keep_idx] = np.arange(len(keep_idx))

    def f(m):
        rows = np.asarray(m.rows)
        sel = pos[rows] >= 0
        return COOMatrix(
            rows=pos[rows[sel]].astype(np.int64),
            cols=np.asarray(m.cols)[sel],
            coeff_ids=np.asarray(m.coeff_ids)[sel],
        )

    return R1CS(
        field=template.field,
        num_inputs=template.num_inputs,
        num_aux=template.num_aux,
        num_constraints=len(keep_idx),
        a=f(template.a),
        b=f(template.b),
        c=f(template.c),
        coeff_table=list(template.coeff_table),
        names=None,
    )


def _used_slot_template(template: R1CS, keep_idx: np.ndarray):
    """(sub, used): the sub-system of rows `keep_idx` over only the slots
    those rows reference, renumbered (ONE stays slot 0, the only input), and
    used, the original slot of each new slot (the remap of the reference's
    packed big rows, matvec.py:2913-2941, and mixed rest rows, :2033-2061)."""
    sub = _sub_rows_r1cs(template, keep_idx)
    used = np.unique(
        np.concatenate([np.asarray(getattr(sub, n).cols) for n in ("a", "b", "c")] + [np.zeros(1, np.int64)])
    )
    lut = np.zeros(template.num_inputs + template.num_aux, np.int64)
    lut[used] = np.arange(len(used))

    def remap(m):
        return COOMatrix(
            rows=np.asarray(m.rows),
            cols=lut[np.asarray(m.cols)].astype(np.int32),
            coeff_ids=np.asarray(m.coeff_ids),
        )

    return R1CS(
        field=sub.field,
        num_inputs=1,
        num_aux=len(used) - 1,
        num_constraints=sub.num_constraints,
        a=remap(sub.a),
        b=remap(sub.b),
        c=remap(sub.c),
        coeff_table=list(sub.coeff_table),
        names=None,
    ), used


# Trivial-row fast path of the LIMBS witness form. Contract: each z limb
# vector encodes a canonical value (< p) and slot 0 holds ONE. Then a
# booleanity row (1-x)·x = 0 holds iff z[x] ∈ {0, 1} (a limb compare), and a
# row whose three LCs each carry ≤ 2 variable terms with coefficients in
# {1, p−1} (plus any constant, through ONE) assembles its operands by row
# gathers for the mul-compare, with no fold matvec.
def _classify_trivial_limb_rows(template: R1CS):
    """(bit_rows, triv_rows, fold_idx) or None when more than half the rows
    need the fold matvec. bit_rows: [(row, col)]; triv_rows: [(row, spec_a,
    spec_b, spec_c)] with spec = (const, [(col, neg)] of ≤ 2 terms);
    fold_idx: int32 rows of neither kind."""
    p = template.field.p
    R = template.num_constraints
    table = [int(c) % p for c in template.coeff_table]
    terms = {}
    for name in ("a", "b", "c"):
        m = getattr(template, name)
        rows = np.asarray(m.rows)
        cols = np.asarray(m.cols)
        cids = np.asarray(m.coeff_ids)
        lst = [[] for _ in range(R)]
        for e in np.argsort(rows, kind="stable"):
            lst[rows[e]].append((table[cids[e]], int(cols[e])))
        terms[name] = lst

    def triv(ts):
        const = 0
        vars_ = []
        for coeff, col in ts:
            if col == 0:
                const = (const + coeff) % p
            elif coeff == 1:
                vars_.append((col, 0))
            elif coeff == p - 1:
                vars_.append((col, 1))
            else:
                return None
        if len(vars_) > 2:
            return None
        return (const, vars_)

    bit_rows = []
    triv_rows = []
    fold_rows = []
    for r in range(R):
        sa = triv(terms["a"][r])
        sb = triv(terms["b"][r]) if sa is not None else None
        sc = triv(terms["c"][r]) if sb is not None else None
        if sc is None:
            fold_rows.append(r)
            continue
        if (
            sa[0] == 1
            and len(sa[1]) == 1
            and sa[1][0][1] == 1
            and sb == (0, [(sa[1][0][0], 0)])
            and sc == (0, [])
        ):
            bit_rows.append((r, sa[1][0][0]))
            continue
        triv_rows.append((r, sa, sb, sc))
    if len(fold_rows) > R // 2:
        return None
    return bit_rows, triv_rows, np.asarray(fold_rows, np.int32)


def _classify_bit_row_families(template: R1CS, small_idx: np.ndarray):
    """Match small rows against the gadget row shapes so the packed check
    evaluates them with 2-6 full-word boolean ops:

      booleanity  (1-x)·x = 0            → satisfied by the bit-sliced
                                            representation (words ARE bits)
      condalloc   (1-m-x)·x = 0          → bad = X∧M
      xor         (2x)·y = x+y-z         → bad = (X⊕Y)⊕Z
      and         x·y = z                → bad = (X∧Y)⊕Z
      and_not     x·(1-y) = z            → bad = (X∧¬Y)⊕Z
      nor         (1-x)·(1-y) = z        → bad = (¬X∧¬Y)⊕Z
      ch          (b-c)·a = ch-c         → bad = ((A∧B)∨(¬A∧C))⊕CH
      maj (row 2) (2bc-b-c)·a = bc-maj   → see backend.matvec._family_bad

    Every match is verified against the actual R1CS coefficients. Returns
    (families, leftover_pos): families = {kind: (int32[n_kind, n_operands]
    columns, int64 rows_orig)}, leftover_pos = positions (into small_idx
    order) of rows no family matched (checked generically)."""
    p_ = template.field.p
    M1 = p_ - 1
    tb = [int(c) % p_ for c in template.coeff_table]
    terms = {}
    for name in ("a", "b", "c"):
        m = getattr(template, name)
        rows = np.asarray(m.rows)
        cols = np.asarray(m.cols)
        cids = np.asarray(m.coeff_ids)
        lst = {int(r): {} for r in small_idx}
        for e in range(len(rows)):
            r = int(rows[e])
            if r not in lst:
                continue
            d = lst[r]
            col = int(cols[e])
            d[col] = (d.get(col, 0) + tb[cids[e]]) % p_
        terms[name] = {
            r: {c: v for c, v in d.items() if v != 0} for r, d in lst.items()
        }

    def match(r):
        A, B, C = terms["a"][r], terms["b"][r], terms["c"][r]
        if C == {} and len(B) == 1 and list(B.values())[0] == 1:
            x = next(iter(B))
            if A == {0: 1, x: M1}:
                return ("bool",)
            if len(A) == 3 and A.get(0) == 1 and A.get(x) == M1:
                others = [c for c in A if c not in (0, x)]
                if len(others) == 1 and A[others[0]] == M1:
                    return ("condalloc", x, others[0])
        if (
            len(A) == 1
            and list(A.values())[0] == 2
            and len(B) == 1
            and list(B.values())[0] == 1
            and len(C) == 3
        ):
            x = next(iter(A))
            y = next(iter(B))
            if C.get(x) == 1 and C.get(y) == 1:
                z = [c for c in C if c not in (x, y)]
                if len(z) == 1 and C[z[0]] == M1:
                    return ("xor", x, y, z[0])
        if (
            len(A) == 1
            and list(A.values())[0] == 1
            and len(B) == 1
            and list(B.values())[0] == 1
            and len(C) == 1
            and list(C.values())[0] == 1
        ):
            return ("and", next(iter(A)), next(iter(B)), next(iter(C)))
        if (
            len(A) == 1
            and list(A.values())[0] == 1
            and len(B) == 2
            and B.get(0) == 1
            and len(C) == 1
            and list(C.values())[0] == 1
        ):
            ys = [c for c in B if c != 0]
            if len(ys) == 1 and B[ys[0]] == M1:
                return ("and_not", next(iter(A)), ys[0], next(iter(C)))
        if (
            len(A) == 2
            and A.get(0) == 1
            and len(B) == 2
            and B.get(0) == 1
            and len(C) == 1
            and list(C.values())[0] == 1
        ):
            xs = [c for c in A if c != 0]
            ys = [c for c in B if c != 0]
            if len(xs) == 1 and A[xs[0]] == M1 and len(ys) == 1 and B[ys[0]] == M1:
                return ("nor", xs[0], ys[0], next(iter(C)))
        if len(B) == 1 and list(B.values())[0] == 1 and len(A) == 2 and len(C) == 2:
            a_ = next(iter(B))
            shared = [x for x in A if A[x] == M1 and C.get(x) == M1]
            if len(shared) == 1:
                c_ = shared[0]
                bs = [x for x in A if x != c_]
                chs = [x for x in C if x != c_]
                if len(bs) == 1 and A[bs[0]] == 1 and len(chs) == 1 and C[chs[0]] == 1:
                    return ("ch", a_, bs[0], c_, chs[0])
        if len(A) == 3 and len(B) == 1 and list(B.values())[0] == 1 and len(C) == 2:
            bcs = [x for x in A if A[x] == 2]
            if len(bcs) == 1 and C.get(bcs[0]) == 1:
                bc = bcs[0]
                rest = [x for x in A if x != bc]
                if len(rest) == 2 and all(A[x] == M1 for x in rest):
                    majs = [x for x in C if x != bc]
                    if len(majs) == 1 and C[majs[0]] == M1:
                        b_, c_ = rest
                        return ("maj2", next(iter(B)), b_, c_, bc, majs[0])
        return None

    fams: Dict[str, list] = {}
    fam_rows: Dict[str, list] = {}
    leftover_pos = []
    for pos, r in enumerate(small_idx):
        m = match(int(r))
        if m is None:
            leftover_pos.append(pos)
            continue
        kind = m[0]
        fams.setdefault(kind, []).append(m[1:])
        fam_rows.setdefault(kind, []).append(int(r))
    families = {
        kind: (
            np.asarray(ops, np.int32).reshape(len(ops), -1),
            np.asarray(fam_rows[kind], np.int64),
        )
        for kind, ops in fams.items()
    }
    return families, np.asarray(leftover_pos, np.int64)


def _classify_pow2_eq_rows(template: R1CS, big_idx: np.ndarray):
    """Match big rows of the MultiEq shape: B = ONE and both A and C are
    sums of power-of-two-scaled bit variables with each side's
    coefficient total < p. For bit-valued witnesses such a row holds iff
    the two sides are equal as INTEGERS, which the bit-plane equality
    check decides on packed words.

    Returns (spec, rest_pos): spec = per-side ELL arrays
    {cols int32[n, n_pos, M], mask uint32[n, n_pos, M]} + rows_orig,
    or None if no row qualifies; rest_pos = positions (into big_idx
    order) of non-matching rows (checked by the field-exact path)."""
    p_ = template.field.p
    tb = [int(c) % p_ for c in template.coeff_table]
    big_set = {int(r) for r in big_idx}
    terms = {}
    for name in ("a", "b", "c"):
        m = getattr(template, name)
        rows = np.asarray(m.rows)
        cols = np.asarray(m.cols)
        cids = np.asarray(m.coeff_ids)
        lst = {r: [] for r in big_set}
        for e in range(len(rows)):
            r = int(rows[e])
            if r in lst:
                lst[r].append((tb[cids[e]], int(cols[e])))
        terms[name] = lst

    def side(ts):
        """[(exponent, col)] with every coefficient decomposed into its
        set bits, or None when the coefficient total reaches p (the sum
        could then wrap mod p and integer equality would be unsound)."""
        out = []
        total = 0
        for cf, col in ts:
            total += cf
            e = 0
            while cf:
                if cf & 1:
                    out.append((e, col))
                cf >>= 1
                e += 1
        if total >= p_:
            return None
        return out

    matched = []
    rest_pos = []
    for pos, r in enumerate(big_idx):
        r = int(r)
        B_ = [(cf, col) for cf, col in terms["b"][r] if cf != 0]
        if B_ != [(1, 0)]:
            rest_pos.append(pos)
            continue
        sa = side(terms["a"][r])
        sc = side(terms["c"][r])
        if sa is None or sc is None:
            rest_pos.append(pos)
            continue
        matched.append((r, sa, sc))
    if not matched:
        return None, np.asarray(rest_pos, np.int64)

    n = len(matched)
    e_max = max((e for _r, sa, sc in matched for e, _c in sa + sc), default=0)
    # Per-side addend width (each side's ELL is sized independently).
    m_side = {}
    for key, idx in (("a", 1), ("c", 2)):
        m_ = 1
        for row in matched:
            cnt = defaultdict(int)
            for e, _c in row[idx]:
                cnt[e] += 1
            m_ = max(m_, max(cnt.values(), default=1))
        m_side[key] = m_
    m_max = max(m_side.values())
    # Positions padded so the final carry cannot overflow: each side's
    # value < p < 2^255, so 256 positions always suffice.
    n_pos = min(256, e_max + 1 + (m_max + 1).bit_length() + 1)
    spec = {"rows_orig": np.asarray([r for r, _a, _c in matched], np.int64),
            "n_pos": n_pos, "m": m_max}
    for key, idx in (("a", 1), ("c", 2)):
        cols = np.zeros((n, n_pos, m_side[key]), np.int32)
        mask = np.zeros((n, n_pos, m_side[key]), np.uint32)
        for i, row in enumerate(matched):
            cnt = defaultdict(int)
            for e, col in row[idx]:
                k = cnt[e]
                cnt[e] += 1
                cols[i, e, k] = col
                mask[i, e, k] = 0xFFFFFFFF
        spec[key + "_cols"] = cols
        spec[key + "_mask"] = mask
    return spec, np.asarray(rest_pos, np.int64)


def _pow2_side_max(side, p: int) -> int:
    """The largest value a pow2 side (const, [(col, exp)], [(fs_idx,
    neg)]) takes over the mixed domain: u32 slots below 2^32, canonical
    field terms (a negated one is p − x ≤ p)."""
    const, u32_terms, f_terms = side
    return const + sum(((1 << 32) - 1) << e for _col, e in u32_terms) + len(f_terms) * p


def _check_pow2_magnitude(row: int, pa, pc, p: int) -> None:
    """Raise unless the mixed check's pow2 arithmetic is exact for row
    `row` on every mixed-domain witness: C < p·2^34 (the offset
    subtraction never borrows), A + p·2^34 < 2^48·p (the quotient fits
    three 16-bit limbs), and no 16-bit window sum reaches 2^32 (each u32
    term adds below 2^16 to three windows, each field term to every
    window, the constant and the offset limb one each)."""
    off = p << POW2_OFF_BITS
    if _pow2_side_max(pc, p) >= off:
        raise ValueError(
            f"pow2 row {row}: its C side can reach p·2^{POW2_OFF_BITS}, so the "
            "borrow-free offset subtraction of the mixed check is unsound"
        )
    if _pow2_side_max(pa, p) + off >= p << (16 * POW2_M_LIMBS):
        raise ValueError(
            f"pow2 row {row}: its A side can push the quotient past "
            f"{POW2_M_LIMBS} limbs in the mixed check"
        )
    for side in (pa, pc):
        if (_max_window_count(side) + len(side[2]) + 2) * 0xFFFF >= 1 << 32:
            raise ValueError(f"pow2 row {row}: a window sum of the mixed check can wrap 32 bits")


def _max_window_count(side) -> int:
    """The most u32-term contributions any 16-bit window of a pow2 side
    receives (a term at exponent e adds to windows e//16 .. e//16 + 2)."""
    cnt = defaultdict(int)
    for _col, e in side[1]:
        for w in range(e // 16, e // 16 + 3):
            cnt[w] += 1
    return max(cnt.values(), default=0)


def _classify_mixed_rows(template: R1CS, field_slots):
    """Partition rows for the mixed check. Returns a dict:
      bool_u32: [(row, col)] booleanity rows on u32 slots
      lin:      [(row, spec_a, spec_c)] rows with B = ONE, both sides
                ≤2-term trivial — spec = (const, [(src, idx, neg)])
      mul:      [(row, spec_a, spec_b, spec_c)] trivial product rows
      pow2:     [(row, side_a, side_c)] — side = (const,
                [(col, exp)], [(fs_idx, neg)]) integer rows
      rest:     [row] fallback rows
    Raises ValueError for a pow2 row outside the bounds of
    _check_pow2_magnitude."""
    p = template.field.p
    R = template.num_constraints
    fs_row = {int(s): i for i, s in enumerate(field_slots)}
    table = [int(c) % p for c in template.coeff_table]
    terms = {}
    for name in ("a", "b", "c"):
        m = getattr(template, name)
        rows = np.asarray(m.rows)
        cols = np.asarray(m.cols)
        cids = np.asarray(m.coeff_ids)
        lst = [dict() for _ in range(R)]
        for e in np.argsort(rows, kind="stable"):
            r = int(rows[e])
            c = int(cols[e])
            v = (lst[r].get(c, 0) + table[cids[e]]) % p
            if v:
                lst[r][c] = v
            elif c in lst[r]:
                del lst[r][c]
        terms[name] = lst

    def triv(d):
        const = d.get(0, 0)
        vars_ = []
        for col, cf in d.items():
            if col == 0:
                continue
            if cf == 1:
                vars_.append((col, 0))
            elif cf == p - 1:
                vars_.append((col, 1))
            else:
                return None
        if len(vars_) > 2:
            return None
        src_vars = [
            (FIELD_SRC, fs_row[col], ng) if col in fs_row else (U32_SRC, col, ng)
            for col, ng in vars_
        ]
        return (const, src_vars)

    def pow2_side(d):
        """(const, u32_terms [(col, exp)], field_terms [(fs_idx, neg)])
        or None. u32 slots need positive power-of-two coefficients (the
        multipack/MultiEq shape); field slots coeff ±1."""
        const = 0
        u32_terms = []
        f_terms = []
        for col, cf in d.items():
            if col == 0:
                const = cf
            elif col in fs_row:
                if cf == 1:
                    f_terms.append((fs_row[col], 0))
                elif cf == p - 1:
                    f_terms.append((fs_row[col], 1))
                else:
                    return None
            else:
                if cf & (cf - 1):
                    return None  # not a power of two
                e = cf.bit_length() - 1
                if e > 256:
                    return None
                u32_terms.append((col, e))
        return (const, u32_terms, f_terms)

    out = {"bool_u32": [], "lin": [], "mul": [], "pow2": [], "rest": []}
    for r in range(R):
        A, B, C = terms["a"][r], terms["b"][r], terms["c"][r]
        sa, sb, sc = triv(A), triv(B), triv(C)
        if sa is not None and sb is not None and sc is not None:
            if (
                sc == (0, [])
                and sa[0] == 1
                and len(sa[1]) == 1
                and sa[1][0][2] == 1
                and sa[1][0][0] == U32_SRC
                and sb == (0, [(U32_SRC, sa[1][0][1], 0)])
            ):
                out["bool_u32"].append((r, sa[1][0][1]))
            elif sb == (1, []):
                out["lin"].append((r, sa, sc))
            else:
                out["mul"].append((r, sa, sb, sc))
            continue
        if B == {0: 1}:
            pa = pow2_side(A)
            pc = pow2_side(C)
            if pa is not None and pc is not None:
                # window-accumulation exactness: ≤ 64 overlapping
                # contributions per 16-bit window per side
                if max(_max_window_count(pa), _max_window_count(pc)) <= 64:
                    _check_pow2_magnitude(r, pa, pc, p)
                    out["pow2"].append((r, pa, pc))
                    continue
        out["rest"].append(r)
    return out
