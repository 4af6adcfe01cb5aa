"""The templated satisfiability checks: bits_packed, bits and mixed.

Counterpart of ``bellpepper_tpu/backend/matvec.py``:

  * ``build_templated_check(..., "bits_packed")`` → ``PackedBitsCheck``,
    the port of ``_build_packed_bits_check`` (reference ``:2760-3063``):
    ``__call__`` is ``violations_packed``, ``verdict`` is
    ``verdict_packed``, each part's violations folded into one running
    verdict on the device by ``verdict_fold``; without a small-row
    majority it runs every row through ``BitsSemiCheck``
    (``violations_packed_fb``, ``:2798-2811``);
  * ``build_templated_check(..., "bits_packed", field_slots=...)`` →
    ``PackedFieldCheck``, the port of ``_build_packed_field_check``
    (``:2515-2720``): the mixed packed layout's multipack rows as
    bit-sliced integer equality, the other rows through
    ``PackedBitsCheck``;
  * ``build_templated_check(..., "bits")`` → ``BitsCheck`` (``:3151-3200``,
    ``:3253-3320``, ``:3423-3470``): 0/1 values packed once into words,
    then ``PackedBitsCheck``;
  * ``_family_bad`` (``:2486``): structured gadget rows as 2-6 full-word
    boolean ops per 32 instances;
  * ``_pow2_eq_bad_words`` (``:2392``) and ``_pow2_side_sum_bits``
    (``:2722-2758``): the carry-save + Kogge-Stone form of the MultiEq
    power-of-two rows, kept as the independent oracle of
    ``_pow2_eq_bad_words_kernel`` (the plane layout of
    ``_pow2_eq_bad_words_pallas``, ``:2439-2481``, as a table of slots
    that ``bitplane_eq`` gathers through);
  * ``BitsSemiCheck``: the fused bits path of ``build_templated_check``
    (``:3252-3320``), for the rows that need field-exact arithmetic: per
    ELL bucket ``bits_matvec_semi`` on the packed words through the
    bucket's column table, then ``mulcmp``; below 250 bits its canonical
    form, ``bits_matvec_canonical``, then ``mul`` and a limb compare. It
    runs over the whole chunk in one call, where the reference maps over
    512-instance blocks;
  * ``build_templated_check(..., "mixed", field_slots=...)`` →
    ``MixedCheck``, the port of ``_build_mixed_check`` (``:1659-2113``)
    for witnesses in the evaluator's (u32 values, canonical field limbs)
    form: booleanity rows as a u32 compare, linear rows by a Montgomery
    zero-test, product rows through ``operand_mulcmp`` (or, below 250
    bits, canonical operands, ``mul`` and a compare), multipack/MultiEq rows as
    exact integer window sums, and the ``rest`` rows through the limbs
    form (``limbs.build_limbs_check``) on their used slots;
  * ``build_templated_check(..., "limbs")`` → ``limbs.build_limbs_check``;
  * ``build_packed_parts``: a witness program's packed evaluator and the
    check of its layout, the pieces of the packed production step and of
    its sharded form.

Witness words are int32 tensors (see ``words``); the check works
slot-major (``vals_p`` int32[S_t, Bw]) and the public entry points take
the witness program's batch-major ``[Bw, S_t]`` words, like the
reference. Violation indices are instance-major flat indices
``b·R + row`` computed in int64."""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..device import check_use_pallas, resolve
from ..r1cs import R1CS
from ..utils import profiling
from .field_consts import _digits
from .field_kernels import (
    _carry_limbs,
    _neg_const,
    bitplane_eq,
    bits_matvec_canonical,
    bits_matvec_semi,
    fold_operand,
    mul,
    mulcmp,
    padded_positions,
    verdict_acc,
    verdict_fold,
)
from .layout import (
    POW2_M_LIMBS,
    POW2_OFF_BITS,
    _build_shared_ell,
    _classify_bit_row_families,
    _classify_mixed_rows,
    _classify_pow2_eq_rows,
    _classify_small_rows,
    _sub_rows_r1cs,
    _used_slot_template,
)
from .check_common import NONE, SENTINEL, Products, _limb_rows, _Operand, _product_bad, semi_ok
from .limbs import build_limbs_check
from .words import U32, device_table as _t, from_numpy_u32, pack_rows, to_u32, unpack_rows

ROW_CLASSES = ("bool_u32", "lin", "mul", "pow2", "rest")  # MixedCheck's row classes, in its row order


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over dim 0."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])], dim=0)
        x = x[0::2] | x[1::2]
    return x[0]


# bad-word formulas per family kind: X = packed word rows in the order
# stored by _classify_bit_row_families. A set bit is a violation.
def _family_bad(kind, X):
    if kind == "condalloc":
        return X[0] & X[1]
    if kind == "xor":
        return (X[0] ^ X[1]) ^ X[2]
    if kind == "and":
        return (X[0] & X[1]) ^ X[2]
    if kind == "and_not":
        return (X[0] & ~X[1]) ^ X[2]
    if kind == "nor":
        return (~X[0] & ~X[1]) ^ X[2]
    if kind == "ch":
        a, b, c, ch = X
        return ((a & b) | (~a & c)) ^ ch
    if kind == "maj2":
        # Exact for ALL bit assignments including an inconsistent bc: with
        # a=1 the row reads maj == b + c - bc over ℤ, which can be -1
        # (bc=1, b=c=0) or 2 (b=c=1, bc=0), never a bit, and otherwise
        # equals (b∧c∧bc) ∨ ((b⊕c)∧¬bc).
        a, b, c, bc, maj = X
        over = b & c & ~bc
        under = ~b & ~c & bc
        s = (b & c & bc) | ((b ^ c) & ~bc)
        bad_a1 = over | under | (maj ^ s)
        return (a & bad_a1) | (~a & (maj ^ bc))
    raise AssertionError(kind)


def _pow2_side_sum_bits(vals_p: torch.Tensor, spec, key: str = "a") -> torch.Tensor:
    """Resolved bit planes int32[n_pos, n, Bw] of one side's Σ 2^e·bit
    (``key`` "a" or "c" names the side's ELL planes): a carry-save
    reduction of the addend planes, then a Kogge-Stone prefix add."""
    n_pos = spec["n_pos"]
    dev = vals_p.device

    def sh(x, d=1):  # shift toward the MSB along the position axis
        return torch.cat([torch.zeros_like(x[:d]), x[: n_pos - d]], dim=0)

    cols, mask = spec[key + "_cols"], spec[key + "_mask"]
    m = cols.shape[2]
    g = vals_p.index_select(0, _t(cols.reshape(-1), dev))
    g = g.reshape(cols.shape + (-1,)) & _t(mask.view(np.int32), dev, torch.int32)[..., None]
    g = g.permute(1, 0, 2, 3)  # [n_pos, n, M, Bw]
    addends = [g[:, :, k] for k in range(m)]
    while len(addends) > 2:
        nxt = []
        for i in range(0, len(addends) - 2, 3):
            a1, b1, c1 = addends[i : i + 3]
            nxt.append(a1 ^ b1 ^ c1)
            nxt.append(sh((a1 & b1) | (c1 & (a1 ^ b1))))
        rem = len(addends) % 3
        if rem:
            nxt.extend(addends[-rem:])
        addends = nxt
    if len(addends) == 1:
        return addends[0]
    a1, b1 = addends
    gk, pk, d = a1 & b1, a1 ^ b1, 1
    p_ = pk
    while d < n_pos:
        gk = gk | (pk & sh(gk, d))
        pk = pk & sh(pk, d)
        d *= 2
    return p_ ^ sh(gk)


def _pow2_eq_bad_words(vals_p: torch.Tensor, spec) -> torch.Tensor:
    """Packed bad words int32[n, Bw] of the pow2-equality rows: each
    side's binary value (``_pow2_side_sum_bits``), compared word for
    word."""
    return _or_rows(_pow2_side_sum_bits(vals_p, spec, "a") ^ _pow2_side_sum_bits(vals_p, spec, "c"))


def _pow2_plane_index(spec) -> np.ndarray:
    """The slot of every addend plane, ordered side (a, c), addend k,
    position e, row i (the plane table of ``bitplane_eq``), −1 for an
    empty ELL slot or a padded position."""
    n_pos = spec["n_pos"]
    n = spec["a_cols"].shape[0]
    P = padded_positions(n_pos)
    tabs = []
    for key in ("a", "c"):
        cols_t = spec[key + "_cols"].transpose(2, 1, 0)  # [m, n_pos, n]
        mask_t = spec[key + "_mask"].transpose(2, 1, 0)
        cols_p = np.full((cols_t.shape[0], P, n), -1, np.int64)
        cols_p[:, :n_pos] = np.where(mask_t != 0, cols_t, -1)
        tabs.append(cols_p.reshape(-1))
    return np.concatenate(tabs)


def _pow2_eq_bad_words_kernel(vals_p: torch.Tensor, spec, plane_idx=None) -> torch.Tensor:
    """Kernel form of _pow2_eq_bad_words: ``bitplane_eq`` over the plane
    table, which gathers the planes itself. Bit-identical to the adder
    form."""
    n = spec["a_cols"].shape[0]
    m_a, m_c = spec["a_cols"].shape[2], spec["c_cols"].shape[2]
    if plane_idx is None:
        plane_idx = _t(_pow2_plane_index(spec), vals_p.device, torch.int32)
    return bitplane_eq(vals_p, plane_idx, n, padded_positions(spec["n_pos"]), m_a, m_c)


class BitsSemiCheck:
    """Field-exact check of bit-valued witnesses through the fold matvec:
    packed slot-major words vals_p int32[S, Bw] → bool[R, 32·Bw] violation
    mask in the template's row order. `slots` maps the template's slots to
    rows of vals_p. Semi-reduced rows and ``mulcmp`` at 250 bits and more;
    below, as the reference's ``out_form="canonical"`` route
    (``:3258-3320``), canonical rows (``bits_matvec_canonical``), ``mul``
    of A·z by B·z and a limb compare with C·z."""

    def __init__(self, template: R1CS, slots: np.ndarray, device):
        field = template.field
        self.field = field
        self.semi = semi_ok(field)
        table = list(template.coeff_table)
        try:
            zero_id = table.index(0)
        except ValueError:
            zero_id = len(table)
            table.append(0)
        cd_all = np.asarray([_digits(int(v), 8, 32) for v in table], np.uint32)
        mats, pos_of_row, self.Rtp = _build_shared_ell(template, zero_id)
        self.pos = _t(pos_of_row, device)
        self.mats = {}
        for name, m in mats.items():
            buckets = []
            for k, start, n_rows in m.buckets:
                cd_b = cd_all[np.asarray(m.coeff_ids[start : start + n_rows * k])].reshape(n_rows, k, 32)
                cols = np.asarray(slots, np.int64)[m.cols[start : start + n_rows * k]]
                cols = np.where(cd_b.any(-1).reshape(-1), cols, -1).reshape(n_rows, k)
                buckets.append((_t(cols, device, torch.int32),
                                torch.from_numpy(fold_operand(cd_b.transpose(2, 0, 1))).to(device)))
            self.mats[name] = buckets

    def _matvec(self, name: str, vals_p: torch.Tensor) -> torch.Tensor:
        kern = bits_matvec_semi if self.semi else bits_matvec_canonical
        parts = [kern(vals_p, cols, F, self.field) for cols, F in self.mats[name]]
        return torch.cat(parts, dim=1).reshape(parts[0].shape[0], -1)  # [17 or 16, Rtp·B]

    def __call__(self, vals_p: torch.Tensor) -> torch.Tensor:
        B = 32 * vals_p.shape[1]
        az, bz, cz = (self._matvec(name, vals_p) for name in "abc")
        if self.semi:
            bad = mulcmp(az, bz, cz, self.field) != 0
        else:
            bad = (mul(az, bz, self.field) != cz).any(0)
        return bad.reshape(self.Rtp, B).index_select(0, self.pos)


class PackedBitsCheck:
    """bits_packed templated check of bit-sliced packed witnesses
    (WitnessProgram.build_packed's batch-major [batch/32, S_t] words).

    Booleanity rows are satisfied by the representation; structured
    gadget rows evaluate as full-word boolean formulas; leftover small
    rows through an exact integer compare of unpacked bits; MultiEq
    power-of-two rows through ``bitplane_eq``; the remaining big rows
    through ``BitsSemiCheck`` on their used slots only.

    A template with no small-row majority (the reference's
    ``violations_packed_fb``, ``:2798-2811``, which unpacks each
    512-instance block into the unpartitioned bits form) runs every row
    through ``BitsSemiCheck`` on the packed words, the whole chunk at
    once."""

    def __init__(self, template: R1CS, batch: int, device=None):
        device = resolve(device)
        Rt0 = self.Rt0 = template.num_constraints
        self.S_t = template.num_inputs + template.num_aux
        if batch % 32:
            raise ValueError("bits_packed batch must be a multiple of 32")
        self.batch = batch
        self.Bw = batch // 32
        self.fallback = None
        if not Rt0:
            return
        part = _classify_small_rows(template)
        if part is None:
            self.fallback = BitsSemiCheck(template, np.arange(self.S_t), device)
            self.all_rows = _t(np.arange(Rt0), device)
            return
        small_idx, big_idx, layouts = part

        families, leftover_pos = _classify_bit_row_families(template, small_idx)
        bool_rows = families.pop("bool", (None, np.zeros(0, np.int64)))[1]
        self.n_bool = len(bool_rows)
        self.fam = [
            (kind, _t(families[kind][0].T, device), _t(families[kind][1], device), "check.family." + kind)
            for kind in sorted(families)
        ]
        self.n_left = len(leftover_pos)
        self.left = {
            name: (_t(colp[leftover_pos].T, device), _t(scop[leftover_pos].T, device))
            for name, (colp, scop) in layouts.items()
        }
        self.rows_left = _t(small_idx[leftover_pos], device)

        self.pow2_spec, rest_big_pos = (
            _classify_pow2_eq_rows(template, big_idx)
            if len(big_idx)
            else (None, np.zeros(0, np.int64))
        )
        pow2_rows = (
            self.pow2_spec["rows_orig"] if self.pow2_spec is not None
            else np.zeros(0, np.int64)
        )
        self.pow2_rows = _t(pow2_rows, device)
        if self.pow2_spec is not None:
            self.plane_idx = _t(_pow2_plane_index(self.pow2_spec), device, torch.int32)
        rest_big_idx = big_idx[rest_big_pos].astype(np.int64)
        self.rest_big_idx = _t(rest_big_idx, device)
        self.big = None
        if len(rest_big_idx):
            # The remaining big rows' check is built over only the slots
            # they use (ONE stays slot 0), its column tables mapped back
            # to rows of the packed witness.
            sub_r, used = _used_slot_template(template, rest_big_idx)
            self.big = BitsSemiCheck(sub_r, used, device)

        order_rows = np.concatenate(
            [bool_rows.astype(np.int64)]
            + [families[k][1] for k in sorted(families)]
            + [small_idx[leftover_pos].astype(np.int64), pow2_rows.astype(np.int64),
               rest_big_idx]
        )
        inv = np.empty(Rt0, np.int64)
        inv[order_rows] = np.arange(Rt0)
        self.inv = _t(inv, device)

    # -- per-class bad sets -------------------------------------------------
    def _fam_bad_words(self, vals_p):
        """[(bad_words int32[n_f, Bw], rows_orig)] per structured family."""
        out = []
        with profiling.span("check.families"):
            for kind, opcols, rows, span_name in self.fam:
                with profiling.span(span_name):
                    X = [vals_p.index_select(0, opcols[i]) for i in range(opcols.shape[0])]
                    out.append((_family_bad(kind, X), rows))
        return out

    def _left_bad(self, vals_p):
        """Leftover small rows: bool[n_left, batch], exact over ℤ."""
        with profiling.span("check.leftover"):
            evs = []
            for name in ("a", "b", "c"):
                colp, scop = self.left[name]  # [K, n_left] each
                ev = None
                for k in range(colp.shape[0]):
                    term = unpack_rows(vals_p.index_select(0, colp[k])).to(
                        torch.int64
                    ) * scop[k][:, None]
                    ev = term if ev is None else ev + term
                evs.append(ev)
            return (evs[0] * evs[1]) != evs[2]

    def _pow2_bad_words(self, vals_p):
        with profiling.span("check.pow2"):
            return _pow2_eq_bad_words_kernel(vals_p, self.pow2_spec, self.plane_idx)

    def _big_bad(self, vals_p):
        """Remaining big rows: bool[n_rest_big, batch]."""
        with profiling.span("check.big"):
            return self.big(vals_p)

    def _slot_major(self, vals_bm):
        if tuple(vals_bm.shape) != (self.Bw, self.S_t) or vals_bm.dtype != torch.int32:
            raise ValueError(
                f"bits_packed z must be int32[batch/32={self.Bw}, S_t={self.S_t}], "
                f"got {vals_bm.dtype}{tuple(vals_bm.shape)}"
            )
        return vals_bm.t().contiguous()

    # -- entry points -------------------------------------------------------
    def __call__(self, vals_bm: torch.Tensor) -> torch.Tensor:
        """violations_packed: bool[batch·R] in instance-major original row
        order."""
        if not self.Rt0:
            return torch.zeros(0, dtype=torch.bool, device=vals_bm.device)
        return self.mask_slot_major(self._slot_major(vals_bm)).t().reshape(-1)

    def mask_slot_major(self, vals_p: torch.Tensor) -> torch.Tensor:
        """Slot-major words int32[S_t, Bw] → bool[R, batch] in the
        template's row order."""
        if self.fallback is not None:
            return self.fallback(vals_p)
        B = self.batch
        parts = []
        if self.n_bool:
            parts.append(torch.zeros((self.n_bool, B), dtype=torch.bool, device=vals_p.device))
        for words, _rows in self._fam_bad_words(vals_p):
            parts.append(unpack_rows(words) != 0)
        if self.n_left:
            parts.append(self._left_bad(vals_p))
        if self.pow2_spec is not None:
            parts.append(unpack_rows(self._pow2_bad_words(vals_p)) != 0)
        if self.big is not None:
            parts.append(self._big_bad(vals_p))
        return torch.cat(parts, dim=0).index_select(0, self.inv)  # grouped → template row order

    def verdict(self, vals_bm: torch.Tensor, flimbs=None):
        """verdict_packed: (n_bad, first) as int64 0-d tensors; first is the
        least instance-major flat index b·R + row of a violation, or
        0xFFFFFFFF when there is none. `flimbs` must be None: it takes a
        packed evaluator's (vals, None) pair as PackedFieldCheck takes
        (vals, flimbs)."""
        if flimbs is not None:
            raise ValueError("a pure-bit packed check takes no field sidecar")
        return self.verdict_slot_major(self._slot_major(vals_bm))

    def verdict_slot_major(self, vals_p: torch.Tensor, flimbs_p=None, n_inst=None):
        """verdict on slot-major words int32[S_t, Bw]; no host sync.
        `flimbs_p` must be None, as in `verdict`. With `n_inst`, only
        instances below it count (the others are padding)."""
        if flimbs_p is not None:
            raise ValueError("a pure-bit packed check takes no field sidecar")
        with profiling.span("check"):
            return self._verdict(vals_p, n_inst)

    def _verdict(self, vals_p, n_inst):
        dev = vals_p.device
        R = self.Rt0
        if not R:
            return (torch.zeros((), dtype=torch.int64, device=dev),
                    torch.full((), SENTINEL, dtype=torch.int64, device=dev))
        acc = verdict_acc(dev)

        def fold(bad, rows):  # bad: int32 words [n, Bw] or bool [n, batch]
            with profiling.span("check.fold"):
                verdict_fold(acc, bad, rows, R, n_inst)

        if self.fallback is not None:
            with profiling.span("check.fallback"):
                bad = self.fallback(vals_p)
            fold(bad, self.all_rows)
        else:
            for words, rows in self._fam_bad_words(vals_p):
                fold(words, rows)
            if self.n_left:
                fold(self._left_bad(vals_p), self.rows_left)
            if self.pow2_spec is not None:
                fold(self._pow2_bad_words(vals_p), self.pow2_rows)
            if self.big is not None:
                fold(self._big_bad(vals_p), self.rest_big_idx)
        nb, first = acc
        return nb, torch.where(first == NONE, SENTINEL, first)


class BitsCheck:
    """The generic bits form: z int32[B, S_t] with every value 0 or 1, the
    port of ``build_templated_check(..., "bits")`` (the small-row split,
    reference ``:3151-3200``, the fused route, ``:3253-3320``, and the
    non-fused route, ``:3423-3470``).

    Under the form's domain contract (``:3096-3110``: every slot 0 or 1)
    bit 0 of a value is all of it, so the check packs z once into
    slot-major words [S_t, ceil(B/32)] and runs ``PackedBitsCheck`` on
    them (its no-majority fallback included). The reference's two routes
    differed by a TPU tile condition (B % 128 == 0); the port has one: the
    kernels on the card, their plain versions on the CPU.

    The instances that pad B to a multiple of 32 are all zero, ONE
    included, and the family rows assume ONE = 1 (a ``nor`` row's
    c == ~a & ~b flags an all-zero instance), so the mask is cut back to B
    and the verdict counts and locates only the real instances."""

    def __init__(self, template: R1CS, batch: int, device=None):
        self.R = template.num_constraints
        self.S_t = template.num_inputs + template.num_aux
        self.batch = batch
        self.Bw = -(-batch // 32)
        self.packed = PackedBitsCheck(template, 32 * self.Bw, device)

    def _words(self, z_T: torch.Tensor) -> torch.Tensor:
        if tuple(z_T.shape) != (self.S_t, self.batch) or z_T.dtype != torch.int32:
            raise ValueError(
                f"bits z must be int32[batch={self.batch}, S_t={self.S_t}] (slot-major: the transpose), "
                f"got {z_T.dtype}{tuple(z_T.shape)}"
            )
        return pack_rows(z_T, self.Bw)

    def mask_slot_major(self, z_T: torch.Tensor) -> torch.Tensor:
        """z_T int32[S_t, B] → bool[R, B] in the template's row order."""
        words = self._words(z_T)
        if not self.R:
            return torch.zeros((0, self.batch), dtype=torch.bool, device=z_T.device)
        return self.packed.mask_slot_major(words)[:, : self.batch]

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        """violations: bool[B·R] in instance-major original row order."""
        return self.mask_slot_major(z.t()).t().reshape(-1)

    def verdict(self, z: torch.Tensor):
        """(n_bad, first) as int64 0-d tensors; first is the least
        instance-major flat index b·R + row of a violation, or 0xFFFFFFFF
        when there is none."""
        return self.verdict_slot_major(z.t())

    def verdict_slot_major(self, z_T: torch.Tensor):
        """verdict on z_T int32[S_t, B] (the pipelines' form); no host
        sync."""
        return self.packed.verdict_slot_major(self._words(z_T), n_inst=self.batch)


class PackedFieldCheck:
    """bits_packed check with a field-limb sidecar (the mixed packed
    layout; reference ``_build_packed_field_check``, ``:2515-2720``):
    vals_bm int32[Bw, S_t] packed bit slots and flimbs int32[32·Bw, F, 16]
    canonical limbs, flimbs row i holding slot field_slots[i]
    (``WitnessProgram.build_packed_mixed``'s pair).

    A row that binds a field slot must be a multipack row
    Σ 2^i·b_i · ONE = field_out; it is checked as bit-sliced integer
    equality between the bit side's carry-save + Kogge-Stone sum
    (``_pow2_side_sum_bits``) and the field value's bit planes. Every other
    row goes through ``PackedBitsCheck`` on the sub-template of the
    remaining rows. The verdict remaps the inner one's first index in
    int64, where the reference's uint32 remap (``:2686``) wraps."""

    def __init__(self, template: R1CS, batch: int, field_slots, device=None):
        device = resolve(device)
        p = template.field.p
        R = self.R = template.num_constraints
        self.S_t = template.num_inputs + template.num_aux
        self.batch = batch
        self.n_fs = len(field_slots)
        fs_row = {int(s): i for i, s in enumerate(field_slots)}
        tb = [int(c) % p for c in template.coeff_table]
        terms = {}
        for name in "abc":
            m = getattr(template, name)
            lst = [[] for _ in range(R)]
            for r, c, cid in zip(np.asarray(m.rows).tolist(), np.asarray(m.cols).tolist(),
                                 np.asarray(m.coeff_ids).tolist()):
                lst[r].append((tb[cid], c))
            terms[name] = lst

        def bit_side(ts):
            """[(e, col)] of Σ cf·bit with every cf split into its powers of
            two, or None when a term is a field slot or zero, or the side
            can reach p."""
            out, total = [], 0
            for cf, col in ts:
                if col in fs_row or cf == 0:
                    return None
                total += cf
                for e in range(cf.bit_length()):
                    if (cf >> e) & 1:
                        out.append((e, col))
            return out if total < p else None

        packfield, remaining = [], []  # (row, [(e, col)], flimbs row)
        for r in range(R):
            if not any(col in fs_row for nm in "abc" for _cf, col in terms[nm][r]):
                remaining.append(r)
                continue
            b_ = [(cf, col) for cf, col in terms["b"][r] if cf != 0]
            c_ = [(cf, col) for cf, col in terms["c"][r] if cf != 0]
            sa = bit_side(terms["a"][r])
            if b_ == [(1, 0)] and len(c_) == 1 and c_[0][0] == 1 and c_[0][1] in fs_row and sa is not None:
                packfield.append((r, sa, fs_row[c_[0][1]]))
                continue
            raise NotImplementedError(
                f"packed field sidecar: row {r} binds a field slot but is not of the multipack "
                "shape; use the mixed or limbs form"
            )
        remaining = np.asarray(remaining, np.int64)
        self.Rt_sub = len(remaining)
        self.inner = PackedBitsCheck(_sub_rows_r1cs(template, remaining), batch, device)
        self.remaining = _t(remaining, device)
        self.Bw = self.inner.Bw

        # the bit sides as single-side pow2 ELL planes [n_pf, n_pos, m_a]
        n_pf = self.n_pf = len(packfield)
        cnts = [max(Counter(e for e, _c in sa).values(), default=1) for _r, sa, _f in packfield]
        m_a = max(cnts, default=1)
        # the compare covers all 256 bits of the field value's limbs: the
        # bit side's sum is below p < 2^255, and a limb word with bit 255 set
        # names another residue (the reference stops at NUM_BITS and misses
        # it); the sum fits, as the bit side is below p
        n_pos = 256
        a_cols = np.zeros((n_pf, n_pos, m_a), np.int32)
        a_mask = np.zeros((n_pf, n_pos, m_a), np.uint32)
        for i, (_r, sa, _f) in enumerate(packfield):
            cnt = Counter()
            for e, col in sa:
                a_cols[i, e, cnt[e]] = col
                a_mask[i, e, cnt[e]] = 0xFFFFFFFF
                cnt[e] += 1
        self.spec_a = {"n_pos": n_pos, "a_cols": a_cols, "a_mask": a_mask}
        pf_rows = np.asarray([r for r, _sa, _f in packfield], np.int64)
        self.pf_rows = _t(pf_rows, device)
        self.pf_fidx = _t([f for _r, _sa, f in packfield], device)
        inv = np.empty(R, np.int64)
        inv[np.concatenate([remaining, pf_rows])] = np.arange(R)
        self.inv = _t(inv, device)

    def _field_bit_planes(self, flimbs_p: torch.Tensor) -> torch.Tensor:
        """int32[n_pos, n_pf, Bw]: bit e of each instance's field value,
        32 instances a word (the reference's ``_field_bit_planes``,
        ``:2626-2643``, position-major)."""
        n_pos = self.spec_a["n_pos"]
        fl = flimbs_p.index_select(0, self.pf_fidx)  # [n_pf, 16, B]
        sh16 = torch.arange(16, dtype=torch.int32, device=fl.device)[:, None]
        bits = ((fl[:, :, None, :] >> sh16) & 1).reshape(self.n_pf, 256, -1)[:, :n_pos]
        return pack_rows(bits.reshape(self.n_pf * n_pos, -1), self.Bw).reshape(
            self.n_pf, n_pos, self.Bw).transpose(0, 1)

    def _pf_bad_words(self, vals_p, flimbs_p):
        """int32[n_pf, Bw] bad words: the bit side's integer sum differs
        from the field value's bits."""
        lhs = _pow2_side_sum_bits(vals_p, self.spec_a)
        return _or_rows(lhs ^ self._field_bit_planes(flimbs_p))

    def _args(self, vals_bm, flimbs):
        ok = (vals_bm.dtype == flimbs.dtype == torch.int32
              and tuple(vals_bm.shape) == (self.Bw, self.S_t)
              and flimbs.dim() == 3 and flimbs.shape[0] == self.batch and flimbs.shape[2] == 16
              and flimbs.shape[1] >= self.n_fs)
        if not ok:
            raise ValueError(
                f"packed field z must be int32 vals[{self.Bw}, {self.S_t}] and flimbs[{self.batch}, "
                f">= {self.n_fs}, 16], got {vals_bm.dtype}{tuple(vals_bm.shape)} and "
                f"{flimbs.dtype}{tuple(flimbs.shape)}"
            )
        return vals_bm.t().contiguous(), flimbs.permute(1, 2, 0).contiguous()

    def __call__(self, vals_bm: torch.Tensor, flimbs: torch.Tensor) -> torch.Tensor:
        """violations: bool[batch·R] in instance-major original row order."""
        vals_p, flimbs_p = self._args(vals_bm, flimbs)
        parts = [self.inner.mask_slot_major(vals_p)] if self.Rt_sub else []
        if self.n_pf:
            parts.append(unpack_rows(self._pf_bad_words(vals_p, flimbs_p)) != 0)
        if not parts:
            return torch.zeros(0, dtype=torch.bool, device=vals_bm.device)
        return torch.cat(parts).index_select(0, self.inv).t().reshape(-1)

    def verdict(self, vals_bm: torch.Tensor, flimbs: torch.Tensor):
        """(n_bad, first) as int64 0-d tensors; first is the least
        instance-major flat index b·R + row of a violation, or 0xFFFFFFFF
        when there is none."""
        return self.verdict_slot_major(*self._args(vals_bm, flimbs))

    def verdict_slot_major(self, vals_p: torch.Tensor, flimbs_p: torch.Tensor):
        """verdict on vals int32[S_t, Bw] and flimbs int32[F, 16, 32·Bw];
        no host sync."""
        dev = vals_p.device
        nb = torch.zeros((), dtype=torch.int64, device=dev)
        first = torch.full((), NONE, dtype=torch.int64, device=dev)
        if self.Rt_sub:
            nb, sub = self.inner.verdict_slot_major(vals_p)
            # the sub-template's row back to the template's: `remaining` is
            # ascending, so the least (instance, row) stays the least
            row = self.remaining[(sub % self.Rt_sub).clamp(max=self.Rt_sub - 1)]
            first = torch.where(nb > 0, sub // self.Rt_sub * self.R + row, NONE)
        if self.n_pf:
            nb, first = verdict_fold(torch.stack([nb, first]), self._pf_bad_words(vals_p, flimbs_p), self.pf_rows,
                                     self.R)
        return nb, torch.where(first == NONE, SENTINEL, first)


# ---------------------------------------------------------------------------
# The mixed check
# ---------------------------------------------------------------------------
def _mont_zero_test(d: torch.Tensor, p: int, m_limbs: int, pinv_limbs) -> torch.Tensor:
    """d int64[n, L, B] (16-bit limbs; a multiple of p iff the row holds,
    quotient < 2^(16·m_limbs)) → bool[n, B] bad mask: m̂ = d·p^-1 mod
    2^(16·m_limbs), then d == m̂·p limb for limb (the reference's
    _mont_zero_test, in uint32)."""
    L = d.shape[1]
    mh = []
    for i in range(m_limbs):
        acc = None
        for j in range(i + 1):
            t = d[:, j] * pinv_limbs[i - j]
            acc = t if acc is None else (acc + t) & U32
        mh.append(acc & U32)
    m16 = []
    carry = None
    for i in range(m_limbs):
        tot = mh[i] if carry is None else (mh[i] + carry) & U32
        m16.append(tot & 0xFFFF)
        carry = tot >> 16
    pl16 = _digits(p, 16, L)
    acc = [None] * (L + 1)
    for j in range(m_limbs):
        for i in range(L - j):
            if pl16[i] == 0:
                continue
            t = m16[j] * pl16[i]
            lo, hi = t & 0xFFFF, t >> 16
            acc[i + j] = lo if acc[i + j] is None else acc[i + j] + lo
            acc[i + j + 1] = hi if acc[i + j + 1] is None else acc[i + j + 1] + hi
    bad = None
    carry = None
    for i in range(L):
        tot = acc[i]
        if carry is not None:
            tot = carry if tot is None else tot + carry
        if tot is None:
            limb, carry = torch.zeros_like(d[:, 0]), None
        else:
            limb, carry = tot & 0xFFFF, tot >> 16
        diff = limb != d[:, i]
        bad = diff if bad is None else bad | diff
    return bad


class MixedCheck:
    """Mixed-form templated check (the reference's _build_mixed_check):
    witnesses as (vals int32[B, S_t] u32 values, flimbs int32[B, F, 16]
    canonical field limbs), flimbs row i holding slot field_slots[i].

    Rows route by class: booleanity of u32 slots (a compare), linear rows
    (a + 8p − c, a one-limb Montgomery zero-test), product rows
    (``operand_mulcmp``: operands assembled and compared in one kernel;
    below 250 bits the operands made canonical, ``mul`` and a compare),
    multipack/MultiEq rows (exact integer
    window sums, d = A + p·2^34 − C, a three-limb Montgomery zero-test),
    and the rows of no class (``rest``) through the limbs form on the
    sub-template of the slots they use, field slots read from flimbs and
    u32 slots lifted to limbs."""

    def __init__(self, template: R1CS, batch: int, field_slots, device=None):
        device = resolve(device)
        field = template.field
        p = self.p = field.p
        if field.NUM_BITS <= 32:
            # a u32 slot can hold a value ≥ p: the operand bounds (< 4p) and
            # the borrow-free negations of the row classes do not hold
            raise NotImplementedError("the mixed check needs p > 2^32 (every u32 value below p)")
        self.field = field
        self.R = template.num_constraints
        self.S_t = template.num_inputs + template.num_aux
        self.batch = batch
        self.n_fs = len(field_slots)
        cls = _classify_mixed_rows(template, field_slots)
        self.counts = tuple(len(cls[k]) for k in ROW_CLASSES)
        self.n_bool, self.n_lin, self.n_mul, self.n_pow2, n_rest = self.counts
        self.p17 = _limb_rows(_digits(p, 16, 17), device)
        self.off_lin = _limb_rows(_digits(p << 3, 16, 17), device)
        self.p0inv = pow(p, -1, 1 << 16)
        self.bool_cols = _t([c for _r, c in cls["bool_u32"]], device)
        self.lin = [_Operand(cls["lin"], oi, device) for oi in range(2)]
        self.mul = Products(cls["mul"], field, device)
        if self.n_pow2:
            self._pow2_tables(cls["pow2"], device)
        if n_rest:
            sub_r, used = _used_slot_template(template, np.asarray(cls["rest"], np.int64))
            self.rest = build_limbs_check(sub_r, batch, device)
            fs_row = np.full(self.S_t, -1, np.int64)
            fs_row[np.asarray(field_slots, np.int64)] = np.arange(self.n_fs)
            used_fs = fs_row[used]
            self.rest_used = _t(used, device)
            self.rest_fidx = _t(np.maximum(used_fs, 0), device)
            self.rest_isf = _t(used_fs >= 0, device, torch.bool)[:, None, None]
        rows = [np.asarray([e[0] for e in cls[k]], np.int64) for k in ROW_CLASSES[:-1]]
        rows.append(np.asarray(cls["rest"], np.int64))
        self.rows = [_t(r, device) for r in rows]
        order = np.concatenate(rows)
        inv = np.empty(self.R, np.int64)
        inv[order] = np.arange(self.R)
        self.inv = _t(inv, device)

    def _pow2_tables(self, pow2, device):
        p = self.p
        e_max = max((e for _r, pa, pc in pow2 for _c, e in pa[1] + pc[1]), default=0)
        n_win = min(20, (e_max + 32 + 16) // 16 + 2)
        L = self.L = max(n_win, 17 + (POW2_OFF_BITS + 15) // 16) + 1
        self.off_limbs = _limb_rows(_digits(p << POW2_OFF_BITS, 16, L), device)
        self.pinv_limbs = _digits(pow(p, -1, 1 << (16 * POW2_M_LIMBS)), 16, POW2_M_LIMBS)
        self.sides = []
        for which in (1, 2):
            const = np.zeros((len(pow2), L), np.int64)
            u_cols, u_shift, u_tgt, f_idx, f_neg, f_row = [], [], [], [], [], []
            for w, row in enumerate(pow2):
                cv, u32_terms, f_terms = row[which]
                const[w] = _digits(cv, 16, L)
                for col, e in u32_terms:
                    u_cols.append(col)
                    u_shift.append(e % 16)
                    u_tgt.append([w * L + e // 16 + k for k in range(3)])
                for fi, ng in f_terms:
                    f_idx.append(fi)
                    f_neg.append(ng)
                    f_row.append(w)
            self.sides.append({
                "const": _t(const, device)[:, :, None],
                "u_cols": _t(u_cols, device),
                "u_shift": _t(u_shift, device)[:, None],
                "u_tgt": _t(np.asarray(u_tgt, np.int64).T.reshape(-1), device),
                "f_idx": _t(f_idx, device),
                "f_neg": _t(np.asarray(f_neg, bool), device, torch.bool)[:, None, None],
                "f_row": _t(f_row, device),
            })

    # -- per-class bad masks, bool[n, B] ------------------------------------
    def _lin_bad(self, vals_p, flimbs_p):
        a = self.lin[0].assemble(vals_p, flimbs_p, self.p17)  # < 4p
        c = self.lin[1].assemble(vals_p, flimbs_p, self.p17)
        d = _carry_limbs(a + _neg_const(c, self.off_lin))  # a + 8p − c < 12p
        return _mont_zero_test(d, self.p, 1, [self.p0inv])

    def _mul_bad(self, vals_p, flimbs_p):
        return _product_bad(self.mul, vals_p, flimbs_p, self.p17, self.field)

    def _side_sum(self, tab, vals_p, flimbs_p):
        """Exact integer Σ const + Σ 2^e·u32 + Σ ±field of one side as
        int64[n_pow2, L, B] unnormalized 16-bit window sums."""
        L, B = self.L, vals_p.shape[1]
        acc = tab["const"].expand(-1, -1, B).reshape(-1, B).clone()
        if tab["u_cols"].numel():
            v = to_u32(vals_p.index_select(0, tab["u_cols"]))  # [T, B]
            sh = tab["u_shift"]
            pieces = torch.cat([
                (v << sh) & 0xFFFF,
                torch.where(sh > 0, v >> (16 - sh), v >> 16) & 0xFFFF,
                torch.where(sh > 0, v >> (32 - sh), 0),
            ])
            acc.index_add_(0, tab["u_tgt"], pieces)
        acc = acc.reshape(self.n_pow2, L, B)
        if tab["f_idx"].numel():
            x = torch.nn.functional.pad(to_u32(flimbs_p.index_select(0, tab["f_idx"])), (0, 0, 0, 1))
            x = torch.where(tab["f_neg"], _neg_const(x, self.p17), x)
            acc.index_add_(0, tab["f_row"], torch.nn.functional.pad(x, (0, 0, 0, L - 17)))
        return acc & U32

    def _pow2_bad(self, vals_p, flimbs_p):
        pos = self._side_sum(self.sides[0], vals_p, flimbs_p)
        neg = _carry_limbs(self._side_sum(self.sides[1], vals_p, flimbs_p))
        d = _carry_limbs(pos + _neg_const(neg, self.off_limbs))  # A + (p·2^34 − C)
        return _mont_zero_test(d, self.p, POW2_M_LIMBS, self.pinv_limbs)

    def rest_z(self, vals_p, flimbs_p):
        """The z int32[n_used, 16, B] of the rest rows' limbs check, on
        their used slots: field slots from flimbs, u32 slots as limbs
        (value mod 2^16, value >> 16)."""
        v = vals_p.index_select(0, self.rest_used)
        lift = torch.zeros((v.shape[0], 16, v.shape[1]), dtype=v.dtype, device=v.device)
        lift[:, 0] = v & 0xFFFF
        lift[:, 1] = (v >> 16) & 0xFFFF
        if not self.n_fs:  # no field slots: every used slot is a u32 slot
            return lift
        fl = flimbs_p.index_select(0, self.rest_fidx)  # [n_used, 16, B]
        return torch.where(self.rest_isf, fl, lift)

    def _rest_bad(self, vals_p, flimbs_p):
        return self.rest.mask_slot_major(self.rest_z(vals_p, flimbs_p))

    def class_bad(self, name: str, vals_p: torch.Tensor, flimbs_p: torch.Tensor) -> torch.Tensor:
        """bool[n, B]: the bad mask of one row class (one of ROW_CLASSES),
        its rows in the class's order, on slot-major vals and flimbs."""
        if name == "bool_u32":
            return (vals_p.index_select(0, self.bool_cols) & -2) != 0  # u32 > 1
        fn = {"lin": self._lin_bad, "mul": self._mul_bad, "pow2": self._pow2_bad, "rest": self._rest_bad}
        return fn[name](vals_p, flimbs_p)

    def _class_bads(self, vals_p, flimbs_p):
        return [self.class_bad(c, vals_p, flimbs_p) for c, n in zip(ROW_CLASSES, self.counts) if n]

    # -- entry points -------------------------------------------------------
    def _check_args(self, vals, flimbs, slot_major: bool):
        if slot_major:
            want_v, want_f = (self.S_t, self.batch), (self.n_fs, 16, self.batch)
            got_f = (flimbs.shape[0], flimbs.shape[1], flimbs.shape[2]) if flimbs.dim() == 3 else None
            form = f"vals[{self.S_t}, {self.batch}] and flimbs[>= {self.n_fs}, 16, {self.batch}]"
        else:
            want_v, want_f = (self.batch, self.S_t), (self.batch, self.n_fs, 16)
            got_f = tuple(flimbs.shape) if flimbs.dim() == 3 else None
            form = f"vals[{self.batch}, {self.S_t}] and flimbs[{self.batch}, >= {self.n_fs}, 16]"
        F_pos = 0 if slot_major else 1
        ok = (
            vals.dtype == flimbs.dtype == torch.int32
            and tuple(vals.shape) == want_v
            and got_f is not None
            and all(g == w for i, (g, w) in enumerate(zip(got_f, want_f)) if i != F_pos)
            and got_f[F_pos] >= want_f[F_pos]
        )
        if not ok:
            raise ValueError(
                f"mixed z must be int32 {form}, got {vals.dtype}{tuple(vals.shape)} and "
                f"{flimbs.dtype}{tuple(flimbs.shape)}"
            )

    def mask_slot_major(self, vals_p: torch.Tensor, flimbs_p: torch.Tensor) -> torch.Tensor:
        """vals int32[S_t, B], flimbs int32[F, 16, B] → bool[R, B] in the
        template's row order."""
        self._check_args(vals_p, flimbs_p, True)
        if not self.R:
            return torch.zeros((0, vals_p.shape[1]), dtype=torch.bool, device=vals_p.device)
        return torch.cat(self._class_bads(vals_p, flimbs_p)).index_select(0, self.inv)

    def __call__(self, vals: torch.Tensor, flimbs: torch.Tensor) -> torch.Tensor:
        """violations: bool[B·R] in instance-major original row order."""
        self._check_args(vals, flimbs, False)
        return self.mask_slot_major(vals.t().contiguous(), flimbs.permute(1, 2, 0).contiguous()).t().reshape(-1)

    def verdict(self, vals: torch.Tensor, flimbs: torch.Tensor):
        """(n_bad, first) as int64 0-d tensors; first is the least
        instance-major flat index b·R + row of a violation, or 0xFFFFFFFF
        when there is none."""
        self._check_args(vals, flimbs, False)
        return self.verdict_slot_major(vals.t().contiguous(), flimbs.permute(1, 2, 0).contiguous())

    def verdict_slot_major(self, vals_p: torch.Tensor, flimbs_p: torch.Tensor):
        """verdict on vals int32[S_t, B], flimbs int32[F, 16, B]; no host
        sync."""
        self._check_args(vals_p, flimbs_p, True)
        with profiling.span("check"):
            bads = []
            for name, n in zip(ROW_CLASSES, self.counts):
                if n:
                    with profiling.span("check." + name):
                        bads.append(self.class_bad(name, vals_p, flimbs_p))
            with profiling.span("check.verdict"):
                dev = vals_p.device
                nb = torch.zeros((), dtype=torch.int64, device=dev)
                first = torch.full((), NONE, dtype=torch.int64, device=dev)
                binst = torch.arange(vals_p.shape[1], dtype=torch.int64, device=dev) * self.R
                for bad, rows in zip(bads, [r for r in self.rows if r.numel()]):
                    nb = nb + bad.sum()
                    first = torch.minimum(first, torch.where(bad, binst[None, :] + rows[:, None], NONE).min())
                return nb, torch.where(first == NONE, SENTINEL, first)


def build_templated_check(template: R1CS, batch: int, use_pallas: bool, witness_form: str = "limbs",
                          field_slots=None, *, device=None):
    """The templated satisfiability check on `device` (the CUDA card by
    default), with the reference's parameters and default form
    (``"limbs"``). Ported forms: ``limbs`` (canonical limbs int32[B, S_t,
    16] of any template, ``limbs.build_limbs_check``), ``bits_packed``
    (bit-sliced packed witnesses of pure-bit templates,
    ``PackedBitsCheck``; with `field_slots`, the mixed packed pair of
    ``build_packed_mixed``, ``PackedFieldCheck``), ``bits`` (0/1 values
    int32[B, S_t], ``BitsCheck``) and ``mixed`` (the witness program's
    (vals, flimbs) pair, ``MixedCheck``; needs `field_slots`, the slot of
    each flimbs row). The reference's private ``_partition`` and
    ``_slot_major`` switches are not ported.

    `use_pallas` (None, True or False) swaps the reference's jnp code for
    its Pallas kernels; every form here has one implementation on the
    port's kernels, so it is checked and the same kernels run."""
    check_use_pallas(use_pallas)
    if not (template.num_inputs == 1 or batch == 1):
        raise ValueError("multi-instance templates must be input-free")
    if witness_form == "mixed":
        if field_slots is None:
            raise ValueError("witness_form='mixed' needs field_slots (flimbs row → slot)")
        return MixedCheck(template, batch, field_slots, device)
    if witness_form == "bits_packed":
        if field_slots:
            return PackedFieldCheck(template, batch, field_slots, device)
        return PackedBitsCheck(template, batch, device)
    if witness_form == "bits" and not field_slots:
        return BitsCheck(template, batch, device)
    if witness_form == "limbs" and not field_slots:
        return build_limbs_check(template, batch, device)
    raise NotImplementedError(
        f"witness_form {witness_form!r}{' with field_slots' if field_slots else ''} is not ported yet"
    )


def build_packed_parts(prog, template: R1CS, batch: int, device: torch.device):
    """The packed step's evaluator and check at `batch` instances for the
    witness program `prog`: ``check.verdict_slot_major(*evaluator.slot_
    major(free_packed))`` is a chunk's verdict. A program whose field
    values are only ``pack`` outputs takes the mixed packed layout
    (``build_packed_mixed``'s limb sidecar, checked by ``PackedFieldCheck``
    with the field rows in row order as `field_slots`)."""
    mixed = not prog.is_packable and prog.is_packable_mixed
    field_slots = sorted(prog.field_rows, key=prog.field_rows.get) if mixed else None
    check = build_templated_check(template, batch, None, "bits_packed", field_slots=field_slots, device=device)
    evaluator = prog.build_packed_mixed(device=device) if mixed else prog.build_packed(device=device)
    return evaluator, check


def assemble_z(be: FieldBackend, inputs, aux, *, device=None) -> torch.Tensor:
    """Host witness → z = inputs ++ aux as canonical limbs int32[N, 16] on
    `device` (the CUDA card by default; reference ``:756``)."""
    return from_numpy_u32(be.to_limbs(list(inputs) + list(aux)), resolve(device))


# The reference module's other public names, from the port modules that
# hold them, so that ``from bellpepper_tpu_torch.backend.matvec import X``
# works for every X the reference exports. Imported last: satisfier and
# row_sharded import this module's checks.
from .field_backend import FieldBackend, get_backend  # noqa: E402
from .layout import FIELD_SRC, MAX_ROW_NNZ, U32_SRC, EllMatrix  # noqa: E402
from .row_chunked import (  # noqa: E402
    DeviceMatrix,
    DeviceR1CS,
    build_row_chunked_check,
    build_row_chunked_eval,
    build_row_chunked_product,
    r1cs_eval,
    sparse_matvec,
    violation_mask,
)
from .row_sharded import build_row_sharded_parts  # noqa: E402
from .satisfier import Satisfier, TemplatedSatisfier  # noqa: E402
