"""WitnessProgram — compile a witness tape into staged torch code.

Counterpart of ``bellpepper_tpu/compile/witness_program.py``:

  * ``WitnessProgram.__init__`` / ``_compile`` (reference ``:346-646``):
    the host stage compile, in numpy, of every opcode. Ops get a
    dependency level (free slots = level 0, Kahn order), and ops of one
    (level, opcode[, arity]) become a *stage* whose operand and output
    slots are static arrays. Field-op outputs get rows of a limb buffer
    (``field_rows``); free slots read as field operands become free field
    inputs (``free_field_slots``).
  * ``WitnessProgram.build`` (reference ``:647-1047``): the evaluator of
    every opcode, one instance per column: u32 values and canonical
    16-bit field limbs. Maximal runs of ``SCAN_OPS`` stages that
    ``_detect_linear_chain`` accepts go to the fused ``chain`` kernel;
    every other field stage runs on its own, ``fmul`` on the ``mul``
    kernel. The reference's ``lax.scan`` folding of the other runs
    (``_find_period``, ``_build_scan_tables``) only bounded XLA's compile
    time and is not ported: eager torch has no such cost, and the results
    are the same.
  * ``WitnessProgram.build_packed`` (reference ``_build_packed_impl`` with
    ``mixed=False``, ``:1116-1362``): the packed evaluator of pure-bit
    programs, 32 instances per word, as torch ops on int32 words. An
    addmany stage is one launch of ``field_kernels.addmany``, a bit-serial
    adder over bit planes (its plain version, on the CPU: a carry-save
    adder tree plus a Kogge-Stone prefix add). Stage outputs are written
    straight to their slots; the reference's scatter-free slot permutation
    only worked around an XLA:TPU miscompile.
  * ``WitnessProgram.build_packed_mixed`` (``_build_packed_impl`` with
    ``mixed=True``, the ``pack`` stage at ``:1311``): the packed evaluator
    with a limb sidecar of the ``pack`` outputs, for the programs that
    ``is_packable_mixed`` (``:1058-1076``) accepts.

Both evaluators work slot-major (``[S, B]`` values, ``[F, 16, B]`` limbs),
so every gather and stage write moves whole contiguous rows and the
kernels read limb-major operands without a transpose; ``__call__``
returns the reference's batch-major layout."""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, List

import numpy as np
import torch

from ..backend import field_kernels as fk
from ..backend.field_kernels import MAX_PATTERN  # longest chain pattern _detect_linear_chain accepts
from ..backend.field_backend import FieldBackend, get_backend
from ..backend.words import FULL, U32, as_words, device_table as _dev, to_i32, to_u32, unpack_rows
from ..backend.words import pack_bits, unpack_bits  # noqa: F401  (the reference module's names)
from ..device import check_use_pallas, resolve
from ..fields import PrimeField  # noqa: F401  (the reference module's name)
from ..utils import profiling
from .tape import V_CONST, V_VAR, Op, TapeCS  # noqa: F401  (TapeCS: the reference module's name)

BIT_OUT_OPS = {"xor", "and", "and_not", "nor", "ch", "maj", "addmany",
               "num_iszero", "fbits_le"}
FIELD_OUT_OPS = {"fadd", "fmul", "finv", "copy", "pack", "num_inv_or_one",
                 "select", "lookup"}
# Opcodes the bit-sliced evaluator supports: each is a pure boolean
# function per bit, so packing 32 instances per word turns it into
# full-word ops (negation = ^0xFFFFFFFF); addmany becomes an adder over
# bit planes (field_kernels.addmany).
PACKED_OPS = {"xor", "and", "and_not", "nor", "ch", "maj", "addmany",
              "num_iszero"}
# Opcodes the mixed packed evaluator adds: a field-valued `pack` output
# goes to an unpacked limb sidecar (see build_packed_mixed).
PACKED_MIXED_OPS = PACKED_OPS | {"pack"}

# field-operand source kinds
SRC_ROW = 0  # limb-buffer row (a field op's output)
SRC_LIFT = 1  # a u32 value of the value buffer, as limbs
SRC_FREE = 2  # a caller-provided free field input

# Field stages that group into runs (reference: the lax.scan folding);
# a run of at least MIN_SCAN_RUN stages is offered to _detect_linear_chain.
SCAN_OPS = {"fadd": 0, "fmul": 1, "finv": 2, "copy": 3, "select": 4}
MIN_SCAN_RUN = 4


class _Stage:
    __slots__ = ("opcode", "outs", "arrs", "meta")

    def __init__(self, opcode, outs, arrs, meta=None):
        self.opcode = opcode
        self.outs = np.asarray(outs)
        self.arrs = {k: np.asarray(v) for k, v in arrs.items()}
        self.meta = meta


def _operand_slots(op: Op) -> List[int]:
    oc = op.opcode
    if oc in ("xor", "and", "and_not", "nor", "fadd", "fmul", "finv", "copy",
              "fbits_le"):
        return list(op.args)
    if oc in ("ch", "maj", "pack"):
        return [s for (k, s, _n) in op.args if k == V_VAR]
    if oc == "addmany":
        return [s for word in op.args for (k, s, _n) in word if k == V_VAR]
    if oc == "select":
        (ck, cs_, _cn), x, y = op.args
        return [x, y] + ([cs_] if ck == V_VAR else [])
    if oc in ("num_iszero", "num_inv_or_one"):
        return [s for (_c, s) in op.args]
    if oc == "lookup":
        return [s for (k, s, _n) in op.args[0] if k == V_VAR]
    raise NotImplementedError(f"witness opcode {oc!r}")


def _views_to_arrays(view_lists):
    """[W][...] of (kind, slot/const, neg) → dict of arrays."""
    arr = np.asarray(view_lists, dtype=np.int64)  # [..., 3]
    kind, sv, neg = arr[..., 0], arr[..., 1], arr[..., 2]
    return {
        "idx": np.where(kind == V_VAR, sv, 0).astype(np.int32),
        "neg": np.where(kind == V_VAR, neg, 0).astype(np.uint32),
        "isc": (kind == V_CONST).astype(np.uint32),
        "cv": np.where(kind == V_CONST, sv, 0).astype(np.uint32),
    }


def _detect_linear_chain(run):
    """If a run of field stages is a *linear periodic field chain* — every
    stage has width 1, opcode in {fmul, fadd}, and SRC_ROW operands that
    are either the IMMEDIATELY preceding stage's output row or
    rep-invariant external rows — return a spec for
    ``field_kernels.chain``, else None. A copy of the reference's
    ``_detect_linear_chain`` (``witness_program.py:76``)."""
    n = len(run)
    if n < 2 * MIN_SCAN_RUN:
        return None
    raw = []
    out_rows = []
    out_slots = []
    prev_out = None
    for st in run:
        if st.opcode not in ("fmul", "fadd"):
            return None
        slots = np.asarray(st.arrs["out_slots"])
        if slots.shape != (1,):
            return None
        cls = []
        for pfx in ("a", "b"):
            if int(np.asarray(st.arrs[pfx + "_kind"])[0]) != SRC_ROW:
                return None
            idx = int(np.asarray(st.arrs[pfx + "_idx"])[0])
            cls.append(
                "prev" if prev_out is not None and idx == prev_out else ("row", idx)
            )
        prev_out = int(np.asarray(st.outs)[0])
        out_rows.append(prev_out)
        out_slots.append(int(slots[0]))
        raw.append((st.opcode, cls[0], cls[1]))

    produced = set(out_rows)
    for d in range(1, MAX_PATTERN + 1):
        if n % d or n // d < 2:
            continue
        # Canonical per-position descs come from rep 1 (rep 0's first
        # stage reads the chain INIT as an external row where later reps
        # read 'prev' — the only allowed anomaly).
        descs = raw[d : 2 * d]
        init_row = None
        ok = True
        for i, got in enumerate(raw):
            exp = descs[i % d]
            if got == exp:
                continue
            if i == 0 and got[0] == exp[0]:
                rows0 = set()
                anomaly = False
                for slot in (1, 2):
                    if got[slot] == exp[slot]:
                        continue
                    if exp[slot] == "prev" and isinstance(got[slot], tuple):
                        rows0.add(got[slot][1])
                        anomaly = True
                    else:
                        anomaly = False
                        break
                if anomaly and len(rows0) == 1:
                    init_row = rows0.pop()
                    continue
            ok = False
            break
        if not ok:
            continue
        if any(c == "prev" for c in (descs[0][1], descs[0][2])):
            if init_row is None:
                continue  # no usable chain entry
        else:
            continue  # reps don't actually chain
        ext_rows = []
        seen = {}
        final = []
        for op, a, b in descs:
            enc = []
            for c in (a, b):
                if c == "prev":
                    enc.append("prev")
                else:
                    row = c[1]
                    if row in produced:
                        enc = None
                        break
                    if row not in seen:
                        seen[row] = len(ext_rows)
                        ext_rows.append(row)
                    enc.append(seen[row])
            if enc is None:
                break
            final.append((op, enc[0], enc[1]))
        if len(final) != d or init_row in produced:
            continue
        return {
            "descs": tuple(final),
            "init_row": init_row,
            "ext_rows": tuple(ext_rows),
            "n_reps": n // d,
            "out_rows": np.asarray(out_rows, np.int32),
            "out_slots": np.asarray(out_slots, np.int32),
        }
    return None


class WitnessProgram:
    """A compiled witness tape: any object with ``.field`` and
    ``.snapshot()`` → (num_inputs, num_aux, ops, free_slots), such as a
    ``tape.TapeCS`` that recorded a circuit of the port's gadgets, or the
    native builder's tape.

    A free slot is a free field input when a field op reads it, else a u32
    slot. `field_inputs` names free slots that hold field values though only
    rows read them, such as a step circuit's z_in (Nova's MinRoot reads x_0
    and y_0 in its first rows alone): they become free field inputs too."""

    def __init__(self, tape, *, field_inputs=()):
        self.field = tape.field
        self.num_inputs, self.num_aux, ops, self.free_slots = tape.snapshot()
        self.num_slots = self.num_inputs + self.num_aux
        self._evals = {}  # run()'s evaluators, one a device, built at their first call
        self._compile(ops, field_inputs)

    def _compile(self, op_list: List[Op], field_inputs=()) -> None:
        free_set = set(self.free_slots)
        not_free = sorted(set(field_inputs) - free_set)
        if not_free:
            raise ValueError(f"field_inputs must be free slots; {not_free[:8]} are not")
        field_out = {o for op in op_list if op.opcode in FIELD_OUT_OPS for o in op.outs}
        self._field_out = field_out
        self.field_rows: Dict[int, int] = {s: i for i, s in enumerate(sorted(field_out))}
        field_rows = self.field_rows
        field_consumed = set(field_inputs)

        # Levels: free slots (and ONE) are level 0; resolved
        # topologically (Kahn), since recording order may put a
        # producer after its consumers.
        produced = {o for op in op_list for o in op.outs}
        level = {s: 0 for s in range(self.num_slots) if s not in produced}
        op_operands = [_operand_slots(op) for op in op_list]
        unresolved = [0] * len(op_list)
        consumers: Dict[int, List[int]] = defaultdict(list)
        for i, opnds in enumerate(op_operands):
            for s in opnds:
                if s not in level:
                    unresolved[i] += 1
                    consumers[s].append(i)
        ready = deque(i for i, n in enumerate(unresolved) if n == 0)
        n_processed = 0
        while ready:
            i = ready.popleft()
            op = op_list[i]
            n_processed += 1
            lv = 1 + max((level[s] for s in op_operands[i]), default=0)
            for o in op.outs:
                level[o] = lv
                for j in consumers.pop(o, ()):
                    unresolved[j] -= 1
                    if unresolved[j] == 0:
                        ready.append(j)
            if op.opcode in ("fadd", "fmul", "finv", "copy", "select", "fbits_le"):
                srcs = op.args if op.opcode != "select" else [op.args[1], op.args[2]]
                field_consumed.update(s for s in srcs if isinstance(s, int) and s in free_set)
        if n_processed != len(op_list):
            raise ValueError("witness tape has an unresolvable dependency cycle")

        self.free_field_slots = sorted(field_consumed)
        free_field_idx = {s: i for i, s in enumerate(self.free_field_slots)}

        def fop_arrays(slots, prefix):
            srcs = [
                (SRC_ROW, field_rows[s]) if s in field_rows
                else (SRC_FREE, free_field_idx[s]) if s in free_field_idx
                else (SRC_LIFT, s)  # ONE, bit-domain outputs, free bits
                for s in slots
            ]
            return {
                prefix + "_kind": np.asarray([k for k, _ in srcs], np.int32),
                prefix + "_idx": np.asarray([i for _, i in srcs], np.int32),
            }

        def out_arrays(batch):
            return {"out_slots": np.asarray([op.outs[0] for op in batch], np.int32)}

        def row_outs(batch):
            return np.asarray([field_rows[op.outs[0]] for op in batch], np.int32)

        groups = defaultdict(list)
        for op in op_list:
            lv = level[op.outs[0]]
            oc = op.opcode
            if oc == "addmany":
                key = (lv, oc, len(op.args), len(op.outs))
            elif oc == "fbits_le":
                key = (lv, oc, len(op.outs))
            elif oc in ("pack", "num_iszero", "num_inv_or_one"):
                key = (lv, oc, len(op.args))
            elif oc == "lookup":
                key = (lv, oc, len(op.args[0]))
            else:
                key = (lv, oc)
            groups[key].append(op)

        stages: List[_Stage] = []
        for key in sorted(groups.keys(), key=lambda k: (k[0], str(k[1:]))):
            batch = groups[key]
            oc = batch[0].opcode
            if oc in ("xor", "and", "and_not", "nor"):
                arrs = {
                    "a": np.asarray([op.args[0] for op in batch], np.int32),
                    "b": np.asarray([op.args[1] for op in batch], np.int32),
                }
                stages.append(_Stage(oc, np.asarray([op.outs[0] for op in batch], np.int32), arrs))
            elif oc in ("ch", "maj"):
                arrs = {}
                for nm, i in (("a", 0), ("b", 1), ("c", 2)):
                    sub = _views_to_arrays([op.args[i] for op in batch])
                    arrs.update({nm + "_" + k: v for k, v in sub.items()})
                stages.append(_Stage(oc, np.asarray([op.outs[0] for op in batch], np.int32), arrs))
            elif oc == "addmany":
                n_words, n_out = len(batch[0].args), len(batch[0].outs)
                stages.append(
                    _Stage(
                        oc,
                        np.asarray([op.outs for op in batch], np.int32),
                        _views_to_arrays([op.args for op in batch]),
                        meta=(n_words, n_out),
                    )
                )
            elif oc in ("fadd", "fmul"):
                arrs = fop_arrays([op.args[0] for op in batch], "a")
                arrs.update(fop_arrays([op.args[1] for op in batch], "b"))
                arrs.update(out_arrays(batch))
                stages.append(_Stage(oc, row_outs(batch), arrs))
            elif oc in ("finv", "copy"):
                arrs = fop_arrays([op.args[0] for op in batch], "a")
                arrs.update(out_arrays(batch))
                stages.append(_Stage(oc, row_outs(batch), arrs))
            elif oc == "select":
                arrs = _views_to_arrays([[op.args[0]] for op in batch])
                arrs = {"c_" + k: v[:, 0] for k, v in arrs.items()}
                arrs.update(fop_arrays([op.args[1] for op in batch], "x"))
                arrs.update(fop_arrays([op.args[2] for op in batch], "y"))
                arrs.update(out_arrays(batch))
                stages.append(_Stage(oc, row_outs(batch), arrs))
            elif oc == "pack":
                arrs = _views_to_arrays([op.args for op in batch])
                arrs.update(out_arrays(batch))
                stages.append(_Stage(oc, row_outs(batch), arrs, meta=len(batch[0].args)))
            elif oc == "fbits_le":
                arrs = fop_arrays([op.args[0] for op in batch], "a")
                stages.append(
                    _Stage(oc, np.asarray([op.outs for op in batch], np.int32), arrs,
                           meta=len(batch[0].outs))
                )
            elif oc == "lookup":
                # views [W, nb] of index bits + per-op constant tables
                # [W, 2^nb, 16], limb-decomposed on the host
                arrs = _views_to_arrays([op.args[0] for op in batch])
                arrs["table"] = np.stack([FieldBackend.to_limbs(list(op.args[1])) for op in batch])
                arrs.update(out_arrays(batch))
                stages.append(_Stage(oc, row_outs(batch), arrs, meta=len(batch[0].args[0])))
            else:  # num_iszero, num_inv_or_one
                n_terms = len(batch[0].args)
                idx = np.zeros((len(batch), n_terms), np.int32)
                cf = np.zeros((len(batch), n_terms), np.uint32)
                for w, op in enumerate(batch):
                    for i, (coeff, s) in enumerate(op.args):
                        if coeff >= (1 << 20):
                            raise ValueError("num_iszero supports small-coefficient LCs")
                        idx[w, i] = s
                        cf[w, i] = coeff
                arrs = {"idx": idx, "cf": cf}
                if oc == "num_iszero":
                    outs = np.asarray([op.outs[0] for op in batch], np.int32)
                else:
                    arrs.update(out_arrays(batch))
                    outs = row_outs(batch)
                stages.append(_Stage(oc, outs, arrs))
        self.stages = stages
        self.n_field_rows = len(field_rows)

    @property
    def field_slots(self) -> List[int]:
        """The slot of each flimbs row the check reads: the field rows in
        row order, then the free field inputs (the mixed check's
        ``field_slots``)."""
        return sorted(self.field_rows, key=self.field_rows.get) + list(self.free_field_slots)

    @property
    def is_pure_bits(self) -> bool:
        """True when every witness slot holds a 0/1 value (no field rows,
        no free field inputs)."""
        return self.n_field_rows == 0 and not self.free_field_slots

    @property
    def is_packable(self) -> bool:
        """True when the bit-sliced evaluator can run the program."""
        return self.is_pure_bits and all(st.opcode in PACKED_OPS for st in self.stages)

    @property
    def is_packable_mixed(self) -> bool:
        """True when the mixed packed evaluator (``build_packed_mixed``)
        can run the program: every opcode in PACKED_MIXED_OPS, no free
        field inputs, and no stage reading a field-valued slot as a bit
        operand (a packed word cannot hold a field value)."""
        if self.free_field_slots:
            return False
        if not all(st.opcode in PACKED_MIXED_OPS for st in self.stages):
            return False
        field_out = list(self._field_out)
        for st in self.stages:
            for k, v in st.arrs.items():
                if k in ("a", "b", "a_idx", "b_idx", "c_idx", "idx"):
                    if np.isin(np.asarray(v).reshape(-1), field_out).any():
                        return False
        return True

    def z_template_limbs(self, vals, flimbs, free_field=None) -> torch.Tensor:
        """Per-instance witness limbs int32[B, num_slots, 16] (the limbs
        form's z): u32-domain slots from vals int32[B, S] (limbs 0-1), field
        rows from flimbs int32[B, F, 16], free field inputs from free_field
        int32[B, nf, 16] when given."""
        free_T = None if free_field is None else free_field.permute(1, 2, 0)
        zt = self.z_template_limbs_slot_major(vals.t(), flimbs.permute(1, 2, 0), free_T)
        return zt.permute(2, 0, 1).contiguous()

    def z_template_limbs_slot_major(self, vals_p, flimbs_p, free_T=None) -> torch.Tensor:
        """z_template_limbs on the evaluator's slot-major buffers: vals
        int32[S, B], flimbs int32[F, 16, B], free_T int32[nf, 16, B] or None
        → int32[S, 16, B]."""
        dev = vals_p.device
        zt = _lift(vals_p)
        if self.n_field_rows:
            rows_slots = _dev(sorted(self.field_rows, key=self.field_rows.get), dev)
            zt.index_copy_(0, rows_slots, flimbs_p[: self.n_field_rows])
        if free_T is not None and self.free_field_slots:
            zt.index_copy_(0, _dev(self.free_field_slots, dev), free_T[: len(self.free_field_slots)])
        return zt

    def build(self, use_pallas: bool | None = None, *, device=None) -> "Evaluator":
        """The evaluator on `device` (the CUDA card by default):
        (free_bits int32[B, n_free], free_field int32[B, nf, 16] or None)
        → (vals int32[B, S], flimbs int32[B, F, 16]), F = max(n_field_rows,
        1), words holding uint32 values and canonical limbs. The reference's
        `use_pallas` swaps its jnp field ops for Pallas kernels; here it is
        checked and the same kernels (``chain``, ``mul``) run."""
        check_use_pallas(use_pallas)
        return Evaluator(self, resolve(device))

    def run(self, free_bits, free_field=None, *, device=None):
        """Evaluate B instances with ``build()``'s evaluator on `device` (the
        CUDA card by default), built at the first call on that device and
        kept. free_bits: uint32 numpy or int32 words [B, n_free], the free
        slots' values in allocation order; free_field: [B, n_free_field,
        16] limbs of the free slots in ``free_field_slots``, zeros when
        None. Returns (vals int32[B, S], flimbs int32[B, F, 16]) on the
        evaluator's device."""
        dev = resolve(device)
        ev = self._evals.get(dev)
        if ev is None:
            ev = self._evals[dev] = self.build(device=dev)
        free_bits = as_words(free_bits, dev)
        if free_field is None:
            free_field = torch.zeros((free_bits.shape[0], max(len(self.free_field_slots), 1), 16),
                                     dtype=torch.int32, device=dev)
        return ev(free_bits, as_words(free_field, dev))

    def build_packed(self, *, device=None) -> "PackedEvaluator":
        """Bit-sliced evaluator on `device` (the CUDA card by default):
        free_packed int32[Bw, n_free] (bit j of word w = instance 32·w + j,
        free slots in allocation order) → vals int32[Bw, S] in the same
        packing."""
        if not self.is_packable:
            bad = sorted({st.opcode for st in self.stages} - PACKED_OPS)
            raise NotImplementedError(
                f"the packed evaluator runs pure-bit programs of {sorted(PACKED_OPS)}; "
                f"this one has {bad or 'field rows'}: use build()"
            )
        return PackedEvaluator(self, resolve(device))

    def build_packed_mixed(self, *, device=None) -> "PackedEvaluator":
        """Bit-sliced evaluator with a field-limb sidecar, on `device` (the
        CUDA card by default): bit slots 32 instances a word, as
        ``build_packed``, and the field-valued ``pack`` outputs as
        canonical limbs. free_packed int32[Bw, n_free] → (vals int32[Bw,
        S], field-out slots holding 0; flimbs int32[Bw·32, F, 16],
        instance-major, F = n_field_rows)."""
        if not self.is_packable_mixed:
            bad = sorted({st.opcode for st in self.stages} - PACKED_MIXED_OPS)
            raise NotImplementedError(
                f"the mixed packed evaluator runs programs of {sorted(PACKED_MIXED_OPS)} whose "
                f"field values are only pack outputs; this one has "
                f"{bad or 'free field inputs or a field value read as a bit'}: use build()"
            )
        return PackedEvaluator(self, resolve(device), mixed=True)


def _lift(v: torch.Tensor) -> torch.Tensor:
    """u32 words int32[W, B] → limbs int32[W, 16, B]."""
    out = torch.zeros((v.shape[0], 16) + tuple(v.shape[1:]), dtype=torch.int32, device=v.device)
    out[:, 0] = v & 0xFFFF
    out[:, 1] = (v >> 16) & 0xFFFF
    return out


def _low32(r: torch.Tensor) -> torch.Tensor:
    """limbs int32[W, 16, B] → the u32 word limb0 | limb1 << 16."""
    return to_i32(r[:, 0].to(torch.int64) | (r[:, 1].to(torch.int64) << 16))


class _FieldOperand:
    """One field operand of a stage: per-position source kinds resolved
    into one gather per kind present."""

    def __init__(self, kinds, idx, device):
        kinds, idx = np.asarray(kinds), np.asarray(idx)
        self.W = len(kinds)
        self.parts = []
        for k in (SRC_ROW, SRC_FREE, SRC_LIFT):
            pos = np.nonzero(kinds == k)[0]
            if len(pos):
                self.parts.append((k, _dev(pos, device), _dev(idx[pos], device)))

    def __call__(self, vals, flimbs, free_T):
        got = []
        for k, pos, idx in self.parts:
            if k == SRC_ROW:
                got.append(flimbs.index_select(0, idx))
            elif k == SRC_FREE:
                got.append(free_T.index_select(0, idx))
            else:
                got.append(_lift(vals.index_select(0, idx)))
        if len(got) == 1:
            return got[0]
        out = torch.empty((self.W,) + tuple(got[0].shape[1:]), dtype=torch.int32,
                          device=vals.device)
        for (_k, pos, _i), g in zip(self.parts, got):
            out.index_copy_(0, pos, g)
        return out


class Evaluator:
    """The evaluator of one WitnessProgram (``build``), with its stage
    tables resident on one device."""

    def __init__(self, prog: WitnessProgram, device: torch.device):
        self.device = device
        self.field = prog.field
        self.num_slots = prog.num_slots
        self.F = max(prog.n_field_rows, 1)
        self.n_free = len(prog.free_slots)
        self.n_free_field = len(prog.free_field_slots)
        self.n_field_rows = prog.n_field_rows
        self.free_slots = _dev(prog.free_slots, device)
        field_lcs = any(st.opcode in ("num_iszero", "num_inv_or_one") for st in prog.stages)
        self.be = get_backend(self.field) if prog.n_field_rows or prog.free_field_slots or field_lcs else None
        self._field_rows = prog.field_rows
        self._free_field_idx = {s: i for i, s in enumerate(prog.free_field_slots)}
        self.plan = []
        run: List[_Stage] = []

        def flush():
            spec = _detect_linear_chain(run) if len(run) >= MIN_SCAN_RUN else None
            if spec is not None:
                self.plan.append(("chain", spec, self._chain_tables(spec)))
            else:
                self.plan.extend((st.opcode, st.meta, self._tables(st)) for st in run)
            run.clear()

        for st in prog.stages:
            if st.opcode in SCAN_OPS:
                run.append(st)
            else:
                flush()
                self.plan.append((st.opcode, st.meta, self._tables(st)))
        flush()

    # -- host tables -------------------------------------------------------
    def _views(self, a, prefix, shape):
        """(idx, neg, const flag, const value) of Boolean views."""
        d = self.device
        return (
            _dev(a[prefix + "idx"].reshape(-1), d),
            _dev(a[prefix + "neg"], d, torch.int32).reshape(shape),
            _dev(a[prefix + "isc"], d, torch.bool).reshape(shape),
            _dev(a[prefix + "cv"], d, torch.int32).reshape(shape),
        )

    def _tables(self, st: _Stage) -> dict:
        d, a, oc = self.device, st.arrs, st.opcode
        t = {"outs": _dev(st.outs.reshape(-1), d)}
        if "out_slots" in a:
            t["out_slots"] = _dev(a["out_slots"], d)
        if oc in ("xor", "and", "and_not", "nor"):
            t["a"], t["b"] = _dev(a["a"], d), _dev(a["b"], d)
        elif oc in ("ch", "maj"):
            for p in ("a", "b", "c"):
                t[p] = self._views(a, p + "_", (-1, 1))
        elif oc in ("addmany", "pack", "lookup"):
            t["v"] = self._views(a, "", a["idx"].shape + (1,))
            if oc == "lookup":
                t["table"] = _dev(a["table"].astype(np.int64), d).reshape(-1, 16)
        elif oc == "select":
            t["c"] = self._views(a, "c_", (-1, 1))
            t["x"] = _FieldOperand(a["x_kind"], a["x_idx"], d)
            t["y"] = _FieldOperand(a["y_kind"], a["y_idx"], d)
        elif oc in ("num_iszero", "num_inv_or_one"):
            t["lc"] = self._field_lc_tables(a["idx"], a["cf"])
        if "a_kind" in a:
            t["fa"] = _FieldOperand(a["a_kind"], a["a_idx"], d)
        if "b_kind" in a:
            t["fb"] = _FieldOperand(a["b_kind"], a["b_idx"], d)
        return t

    def _field_lc_tables(self, idx, cf):
        """The tables of a small LC, summed in the field: the terms as one
        field operand (a field row, a free field input or a lifted u32
        slot) and the coefficients as limbs (None when every one is 1)."""
        slots = idx.reshape(-1).tolist()
        kinds = [SRC_ROW if s in self._field_rows else SRC_FREE if s in self._free_field_idx else SRC_LIFT
                 for s in slots]
        where = [self._field_rows[s] if k == SRC_ROW else self._free_field_idx[s] if k == SRC_FREE else s
                 for k, s in zip(kinds, slots)]
        cf = cf.reshape(-1)
        # mul takes a canonical multiplier (its low ceil(NUM_BITS/32) words)
        p = self.field.p
        cfl = None if (cf == 1).all() else _dev(FieldBackend.to_limbs([int(c) % p for c in cf]), self.device,
                                                torch.int32)
        return _FieldOperand(kinds, where, self.device), cfl, idx.shape

    def _lc_field(self, t, vals, flimbs, free_T):
        """Σ cf·value of each LC in the field: canonical limbs int32[W, 16, B]."""
        operand, cfl, (W, T) = t["lc"]
        x = operand(vals, flimbs, free_T)  # [W·T, 16, B]
        if cfl is not None:
            x = self._fmul(x, cfl[:, :, None].expand_as(x))
        x = x.reshape(W, T, 16, -1)
        s = x[:, 0]
        for j in range(1, T):
            s = self.be.add(s, x[:, j], dim=1)
        return s

    def _chain_tables(self, spec) -> dict:
        d = self.device
        return {
            "init": int(spec["init_row"]),
            "ext": _dev(spec["ext_rows"], d) if spec["ext_rows"] else None,
            "outs": _dev(spec["out_rows"], d),
            "out_slots": _dev(spec["out_slots"], d),
        }

    # -- evaluation --------------------------------------------------------
    @staticmethod
    def _bviews(vals, tabs):
        idx, neg, isc, cv = tabs
        v = vals.index_select(0, idx).reshape(isc.shape[:-1] + (-1,))
        return torch.where(isc, cv, v ^ neg)

    def _fmul(self, a, b):
        """[W, 16, B] × [W, 16, B] through the mul kernel ([16, W·B])."""
        W, _, B = a.shape
        if W == 1:
            return fk.mul(a[0], b[0], self.field).unsqueeze(0)
        lm = lambda x: x.transpose(0, 1).reshape(16, W * B)  # noqa: E731
        return fk.mul(lm(a), lm(b), self.field).reshape(16, W, B).transpose(0, 1)

    def slot_major(self, free_bits: torch.Tensor, free_field=None, *, free_rows: bool = False):
        """free_bits int32[B, n_free], free_field int32[B, nf, 16] or None
        → (vals int32[S, B], flimbs int32[F, 16, B]). With `free_rows`,
        flimbs holds the field rows and then the free field inputs, n_field_rows
        + nf rows in the mixed check's ``field_slots`` order, the inputs
        written there once instead of copied beside the rows."""
        if free_bits.dim() != 2 or free_bits.dtype != torch.int32 or free_bits.shape[1] != self.n_free:
            raise ValueError(
                f"free_bits must be int32[B, {self.n_free}], got "
                f"{free_bits.dtype}{tuple(free_bits.shape)}"
            )
        if self.n_free_field and (free_field is None or tuple(free_field.shape) != (free_bits.shape[0],
                                                                                     self.n_free_field, 16)):
            raise ValueError(f"free_field must be int32[B, {self.n_free_field}, 16]")
        with profiling.span("witness"):
            with profiling.span("witness.init"):
                vals, flimbs, free_T = self._init(free_bits, free_field, free_rows)
            if profiling.is_tracing():
                for oc, meta, t in self.plan:
                    with profiling.span("witness." + oc):
                        self._stage(vals, flimbs, free_T, oc, meta, t)
            else:
                for oc, meta, t in self.plan:
                    self._stage(vals, flimbs, free_T, oc, meta, t)
        return vals, flimbs

    def _init(self, free_bits, free_field, free_rows: bool):
        """The value buffer with ONE and the free slots, the limb buffer,
        and the free field inputs slot-major (a view of the limb buffer's
        tail with `free_rows`)."""
        B = free_bits.shape[0]
        dev = free_bits.device
        vals = torch.zeros((self.num_slots, B), dtype=torch.int32, device=dev)
        vals[0] = 1  # ONE
        if self.n_free:
            vals.index_copy_(0, self.free_slots, free_bits.t())
        n_fr, n_ff = self.n_field_rows, self.n_free_field
        flimbs = torch.zeros((n_fr + n_ff if free_rows else self.F, 16, B), dtype=torch.int32, device=dev)
        free_T = None
        if n_ff:
            free_T = flimbs[n_fr:] if free_rows else torch.empty((n_ff, 16, B), dtype=torch.int32, device=dev)
            free_T.copy_(free_field.permute(1, 2, 0))
        return vals, flimbs, free_T

    def _stage(self, vals, flimbs, free_T, oc, meta, t):
        """Run one stage of the plan: its outputs into `vals` and, for a
        field op, into `flimbs`."""
        B = vals.shape[1]
        dev = vals.device

        def write_field(t, r):
            flimbs.index_copy_(0, t["outs"], r)
            vals.index_copy_(0, t["out_slots"], _low32(r))

        if oc == "chain":
            x0 = flimbs[t["init"]]
            ext = (flimbs.index_select(0, t["ext"]).reshape(-1, B) if t["ext"] is not None
                   else torch.zeros_like(x0))
            out = fk.chain(x0, ext, meta["descs"], meta["n_reps"], self.field)
            write_field(t, out.reshape(-1, 16, B))
        elif oc in ("xor", "and", "and_not", "nor"):
            a = vals.index_select(0, t["a"])
            b = vals.index_select(0, t["b"])
            r = (a ^ b if oc == "xor" else a & b if oc == "and"
                 else a & (b ^ 1) if oc == "and_not" else (a ^ 1) & (b ^ 1))
            vals.index_copy_(0, t["outs"], r)
        elif oc in ("ch", "maj"):
            a, b, c = (self._bviews(vals, t[p]) for p in ("a", "b", "c"))
            r = (a & b) ^ ((a ^ 1) & c) if oc == "ch" else (a & b) ^ (a & c) ^ (b & c)
            vals.index_copy_(0, t["outs"], r)
        elif oc == "addmany":
            r = _addmany_u32(self._bviews(vals, t["v"]), meta[1])
            vals.index_copy_(0, t["outs"], r.reshape(-1, B))
        elif oc in ("fadd", "fmul"):
            a = t["fa"](vals, flimbs, free_T)
            b = t["fb"](vals, flimbs, free_T)
            write_field(t, self.be.add(a, b, dim=1) if oc == "fadd" else self._fmul(a, b))
        elif oc == "finv":
            write_field(t, self.be.inv(t["fa"](vals, flimbs, free_T), dim=1))
        elif oc == "copy":
            write_field(t, t["fa"](vals, flimbs, free_T))
        elif oc == "select":
            cond = self._bviews(vals, t["c"])  # [W, B]
            x = t["x"](vals, flimbs, free_T)
            y = t["y"](vals, flimbs, free_T)
            write_field(t, torch.where((cond == 1)[:, None, :], x, y))
        elif oc == "pack":
            write_field(t, _pack_limbs(self._bviews(vals, t["v"]), meta))
        elif oc == "lookup":
            bv = to_u32(self._bviews(vals, t["v"]))  # [W, nb, B]
            w = 1 << torch.arange(meta, dtype=torch.int64, device=dev)
            sel = ((bv * w[None, :, None]).sum(1) & U32).clamp(max=(1 << meta) - 1)
            base = torch.arange(bv.shape[0], device=dev)[:, None] << meta
            r = t["table"].index_select(0, (base + sel).reshape(-1))
            write_field(t, to_i32(r.reshape(bv.shape[0], B, 16).transpose(1, 2)))
        elif oc == "fbits_le":
            a = t["fa"](vals, flimbs, free_T)
            bits = [(a[:, k // 16] >> (k % 16)) & 1 for k in range(meta)]
            vals.index_copy_(0, t["outs"], torch.stack(bits, dim=1).reshape(-1, B))
        elif oc in ("num_iszero", "num_inv_or_one"):
            # the sum in the field (the reference sums the slots' low 32
            # bits in uint32, which gives a witness its rows reject once
            # a term is field-valued or the sum wraps)
            s = self._lc_field(t, vals, flimbs, free_T)
            zero = (s == 0).all(dim=1)  # [W, B]
            if oc == "num_iszero":
                vals.index_copy_(0, t["outs"], zero.to(torch.int32))
            else:
                inv = self.be.inv(s, dim=1)
                inv[:, 0] |= zero.to(torch.int32)  # the inverse of 0 is 0: one instead
                write_field(t, inv)
        else:  # pragma: no cover
            raise AssertionError(oc)

    def __call__(self, free_bits: torch.Tensor, free_field=None):
        """The reference's batch-major layout: (vals int32[B, S], flimbs
        int32[B, F, 16])."""
        vals, flimbs = self.slot_major(free_bits, free_field)
        return vals.t().contiguous(), flimbs.permute(2, 0, 1).contiguous()


def _addmany_u32(bv: torch.Tensor, n_out: int) -> torch.Tensor:
    """bv int32[W, n_words, 32, B] addend bits → int32[W, n_out, B] sum
    bits: the reference's two uint32 16-bit-half sums and their carry,
    read out as the bits of lo | hi << 16 in one broadcast shift."""
    sh = torch.arange(32, dtype=torch.int64, device=bv.device)
    w = torch.where(sh < 16, 1 << sh, 1 << (sh - 16))[None, None, :, None]
    v = to_u32(bv) * w
    lo = v[:, :, :16].sum(dim=(1, 2)) & U32
    hi = (v[:, :, 16:].sum(dim=(1, 2)) + (lo >> 16)) & U32
    word = (lo & 0xFFFF) | (hi << 16)
    k = torch.arange(n_out, dtype=torch.int64, device=bv.device)
    return ((word[:, None, :] >> k[:, None]) & 1).to(torch.int32)


def _pack_limbs(bv: torch.Tensor, n_bits: int) -> torch.Tensor:
    """bv int32[W, n_bits, B] bits (LSB first) → limbs int32[W, 16, B]:
    limb j = Σ_i bit[16j + i]·2^i, in uint32."""
    v = to_u32(bv)
    limbs = []
    for j in range(16):
        lo = 16 * j
        if lo >= n_bits:
            limbs.append(torch.zeros_like(v[:, 0]))
            continue
        width = min(16, n_bits - lo)
        w = (1 << torch.arange(width, dtype=torch.int64, device=bv.device))[None, :, None]
        limbs.append((v[:, lo : lo + width] * w).sum(dim=1) & U32)
    return to_i32(torch.stack(limbs, dim=1))


class PackedEvaluator:
    """The packed evaluator of one WitnessProgram, with its stage tables
    resident on one device; `mixed` adds the limb sidecar of the ``pack``
    outputs (``build_packed_mixed``), canonical 16-bit limbs kept
    slot-major [F, 16, B] inside."""

    def __init__(self, prog: WitnessProgram, device: torch.device, mixed: bool = False):
        self.device = device
        self.mixed = mixed
        self.F = max(prog.n_field_rows, 1)
        self.num_slots = prog.num_slots
        self.n_free = len(prog.free_slots)
        self.free_slots = _dev(prog.free_slots, device)
        self._stages = []
        for st in prog.stages:
            a = st.arrs
            if st.opcode == "addmany":  # one kernel launch: its own tables, outputs included
                self._stages.append((st.opcode, st.meta, fk.addmany_tables(a, st.outs, device)))
                continue
            t = {"outs": _dev(st.outs.reshape(-1), device)}
            if st.opcode in ("xor", "and", "and_not", "nor"):
                t["a"] = _dev(a["a"], device)
                t["b"] = _dev(a["b"], device)
            elif st.opcode in ("ch", "maj"):
                for p in ("a", "b", "c"):
                    t[p] = self._view_tables(a, p + "_", (-1, 1))
            elif st.opcode == "pack":
                t["v"] = self._view_tables(a, "", a["idx"].shape + (1,))
            else:  # num_iszero
                t["idx"] = _dev(a["idx"], device)
                t["cf"] = _dev(a["cf"], device)[:, :, None, None]
            self._stages.append((st.opcode, st.meta, t))

    def _view_tables(self, a, prefix, shape):
        """(idx, neg mask, const flag, const word) for Boolean views."""
        d = self.device
        neg = _dev(a[prefix + "neg"], d, torch.int32).reshape(shape)
        return (
            _dev(a[prefix + "idx"].reshape(-1), d),
            -neg,  # 0 or all-ones
            _dev(a[prefix + "isc"], d, torch.bool).reshape(shape),
            -_dev(a[prefix + "cv"], d, torch.int32).reshape(shape),
        )

    @staticmethod
    def _views(vals, tabs):
        idx, negm, isc, cvw = tabs
        v = vals.index_select(0, idx).reshape(isc.shape[:-1] + (-1,))
        return torch.where(isc, cvw, v ^ negm)

    def slot_major(self, free_packed: torch.Tensor):
        """free_packed int32[Bw, n_free] → (vals int32[S, Bw], flimbs
        int32[F, 16, 32·Bw] with `mixed`, else None)."""
        if free_packed.dtype != torch.int32 or free_packed.shape[1] != self.n_free:
            raise ValueError(
                f"free_packed must be int32[Bw, {self.n_free}], got "
                f"{free_packed.dtype}{tuple(free_packed.shape)}"
            )
        Bw = free_packed.shape[0]
        with profiling.span("witness"):
            with profiling.span("witness.init"):
                vals = torch.zeros((self.num_slots, Bw), dtype=torch.int32, device=free_packed.device)
                vals[0] = FULL  # ONE
                if self.n_free:
                    vals.index_copy_(0, self.free_slots, free_packed.t())
                flimbs = None
                if self.mixed:
                    flimbs = torch.zeros((self.F, 16, 32 * Bw), dtype=torch.int32, device=vals.device)
            if profiling.is_tracing():
                for oc, meta, t in self._stages:
                    with profiling.span("witness." + oc):
                        self._stage(vals, flimbs, oc, meta, t)
            else:
                for oc, meta, t in self._stages:
                    self._stage(vals, flimbs, oc, meta, t)
        return vals, flimbs

    def _stage(self, vals, flimbs, oc, meta, t):
        """Run one stage: its outputs into `vals`, a ``pack`` stage's into
        the sidecar `flimbs`."""
        Bw = vals.shape[1]
        if oc == "addmany":  # the sum planes straight into their slots
            fk.addmany(vals, t, *meta)
            return
        if oc == "pack":  # field-valued: to the sidecar; its vals slots stay 0
            bv = self._views(vals, t["v"])  # [W, n_bits, Bw] packed bit planes
            bits = unpack_rows(bv.reshape(-1, Bw)).reshape(bv.shape[0], meta, -1)
            flimbs.index_copy_(0, t["outs"], _pack_limbs(bits, meta))
            return
        if oc in ("xor", "and", "and_not", "nor"):
            a = vals.index_select(0, t["a"])
            b = vals.index_select(0, t["b"])
            if oc == "xor":
                r = a ^ b
            elif oc == "and":
                r = a & b
            elif oc == "and_not":
                r = a & ~b
            else:
                r = ~a & ~b
        elif oc in ("ch", "maj"):
            a = self._views(vals, t["a"])
            b = self._views(vals, t["b"])
            c = self._views(vals, t["c"])
            r = (a & b) ^ (~a & c) if oc == "ch" else (a & b) ^ (a & c) ^ (b & c)
        else:  # num_iszero
            r = _num_iszero(vals, t["idx"], t["cf"])
        vals.index_copy_(0, t["outs"], r.reshape(-1, Bw))

    def __call__(self, free_packed: torch.Tensor):
        """free_packed int32[Bw, n_free] → vals int32[Bw, S]; with `mixed`
        (vals, flimbs int32[Bw·32, F, 16])."""
        vals, flimbs = self.slot_major(free_packed)
        if self.mixed:
            return vals.t().contiguous(), flimbs.permute(2, 0, 1).contiguous()
        return vals.t().contiguous()


def _num_iszero(vals, idx, cf):
    """Bit-sliced is-zero of small-coefficient LCs: idx [W, T] slots,
    cf int64[W, T, 1, 1] → int32[W, Bw] words (bit set iff Σ cf·bit ≡ 0
    mod 2^32, the reference's uint32 sum)."""
    W, T = idx.shape
    v = vals.index_select(0, idx.reshape(-1)).reshape(W, T, -1)
    sh = torch.arange(32, dtype=torch.int64, device=vals.device)
    b32 = (v.to(torch.int64)[..., None] >> sh) & 1  # [W, T, Bw, 32]
    s = (b32 * cf).sum(dim=1) & U32
    return to_i32(((s == 0).to(torch.int64) << sh).sum(dim=-1))
