"""The production steps: witness generation and check over chunks.

Counterpart of ``bellpepper_tpu/compile/pipeline.py``:
``build_chunked_check`` (``:72-97``), ``build_production_step``
(``:100-170``, the bits, mixed and limbs forms),
``build_packed_production_step`` (``:173-232``, the mixed packed layout
included),
``build_packed_chunked_witness`` (``:235``), ``build_chunked_witness``
(``:253``) and ``_aggregate`` (``:62-69``). The reference's single jitted
``lax.scan`` over chunks becomes a Python loop that enqueues every
chunk's work on the current stream and reads nothing back: the host first
waits when the caller reads the verdict. Index arithmetic is int64, so a
global violation index past 2^32 (a fifth chunk of 32768 sha256
instances) does not wrap. Every builder runs on the CUDA card unless it
is given another device."""

from __future__ import annotations

import torch

from ..backend.check_common import NONE, SENTINEL
from ..backend.matvec import build_templated_check
from ..device import resolve
from ..r1cs import R1CS


def _aggregate(nbs: torch.Tensor, firsts: torch.Tensor, chunk_span: int):
    """Combine per-chunk (n_bad, local_first) into a global verdict
    (total, first); first is 0xFFFFFFFF when nothing is violated."""
    total = nbs.sum()
    offsets = torch.arange(firsts.shape[0], dtype=torch.int64, device=firsts.device)
    glob = torch.where(nbs > 0, firsts + offsets * chunk_span, NONE).min()
    return total, torch.where(glob == NONE, SENTINEL, glob)


def build_production_step(prog, template: R1CS, batch: int, device=None, witness_form=None):
    """The field path's production step: free inputs for n_chunks × batch
    instances → witness generation (``WitnessProgram.build``) → templated
    check → (total_bad, first_violation), both int64 0-d tensors on
    `device`; a clean run gives (0, 0xFFFFFFFF).

    witness_form: None picks ``"bits"`` for a pure-bit program and
    ``"mixed"`` for any other, as the reference does. ``"bits"``: the
    evaluator's 0/1 values as they are (``BitsCheck``). ``"mixed"``: the
    evaluator's (vals, flimbs) buffers as they are; pure-bit programs are
    refused in it. ``"limbs"``: every slot as canonical limbs,
    ``z_template_limbs``; the form that checks a non-bit field value in a
    bit slot. free_bits: int32[n_chunks, batch, n_free]; free_field (when
    the program has free field inputs): int32[n_chunks, batch,
    n_free_field, 16]."""
    if witness_form is None:
        witness_form = "bits" if prog.is_pure_bits else "mixed"
    if witness_form not in ("bits", "mixed", "limbs"):
        raise ValueError(f"witness_form must be 'bits', 'mixed', 'limbs' or None, got {witness_form!r}")
    if witness_form == "mixed" and prog.is_pure_bits:
        raise NotImplementedError(
            "a pure-bit program has no field slots for the mixed form: use witness_form='bits' "
            "(the default) or 'limbs'"
        )
    if witness_form == "bits" and not prog.is_pure_bits:
        raise ValueError("the bits form takes pure-bit programs only")
    device = resolve(device)
    if witness_form == "mixed":
        check = build_templated_check(template, batch, "mixed", field_slots=prog.field_slots, device=device)
    else:
        check = build_templated_check(template, batch, witness_form, device=device)
    evaluator = prog.build(device)
    span = batch * template.num_constraints
    n_fr, n_ff = prog.n_field_rows, len(prog.free_field_slots)

    def chunk_verdict(fb, ff):
        vals, flimbs = evaluator.slot_major(fb, ff)
        free_T = ff.permute(1, 2, 0) if n_ff else None
        if witness_form == "bits":
            return check.verdict_slot_major(vals)
        if witness_form == "limbs":
            return check.verdict_slot_major(prog.z_template_limbs_slot_major(vals, flimbs, free_T))
        if n_ff:
            flimbs = torch.cat([flimbs[:n_fr], free_T])
        return check.verdict_slot_major(vals, flimbs)

    def step(free_bits: torch.Tensor, free_field=None):
        if free_bits.dim() != 3 or free_bits.shape[1] != batch:
            raise ValueError(
                f"free_bits must be [n_chunks, {batch}, n_free], got {tuple(free_bits.shape)}"
            )
        nbs, firsts = [], []
        for k, fb in enumerate(free_bits):
            nb, first = chunk_verdict(fb, None if free_field is None else free_field[k])
            nbs.append(nb)
            firsts.append(torch.where(nb > 0, first, 0))
        return _aggregate(torch.stack(nbs), torch.stack(firsts), span)

    return step


def build_chunked_check(template: R1CS, batch: int, n_chunks: int, device=None,
                        witness_form: str = "limbs"):
    """Check pre-generated witnesses of n_chunks × batch instances: z4
    int32[n_chunks, batch, S_t, 16] canonical limbs (``"limbs"``) or
    int32[n_chunks, batch, S_t] 0/1 values (``"bits"``) → (total_bad,
    first_violation) as in ``build_production_step``."""
    if witness_form not in ("bits", "limbs"):
        raise ValueError(f"witness_form must be 'bits' or 'limbs', got {witness_form!r}")
    check = build_templated_check(template, batch, witness_form, device=resolve(device))
    span = batch * template.num_constraints

    def run(z4: torch.Tensor):
        if z4.shape[0] != n_chunks:
            raise ValueError(f"z4 must hold {n_chunks} chunks, got {z4.shape[0]}")
        nbs, firsts = [], []
        for z in z4:
            nb, first = check.verdict(z)
            nbs.append(nb)
            firsts.append(torch.where(nb > 0, first, 0))
        return _aggregate(torch.stack(nbs), torch.stack(firsts), span)

    return run


def build_chunked_witness(prog, device=None):
    """Witness generation only: free_bits int32[n_chunks, batch, n_free]
    (and free_field int32[n_chunks, batch, nf, 16] when the program has
    free field inputs) → vals int32[n_chunks, batch, S], the u32 value
    buffer of every instance."""
    evaluator = prog.build(device)

    def gen(free_bits: torch.Tensor, free_field=None) -> torch.Tensor:
        return torch.stack([
            evaluator(fb, None if free_field is None else free_field[k])[0]
            for k, fb in enumerate(free_bits)
        ])

    return gen


def build_packed_production_step(prog, template: R1CS, batch: int, device=None):
    """Bit-sliced production path: packed free bits for n_chunks × batch
    instances → packed witness generation (32 instances per word) →
    bits_packed check → (total_bad, first_violation), both int64 0-d
    tensors on `device`; a clean run gives (0, 0xFFFFFFFF).

    free_packed: int32[n_chunks, batch/32, n_free] words (uint32 bit
    patterns), bit j of word w = instance 32·w + j.

    A program whose field values are only ``pack`` outputs (config 3) takes
    the mixed packed layout: ``build_packed_mixed``'s limb sidecar, checked
    by ``PackedFieldCheck`` with the field rows in row order as
    `field_slots`."""
    device = resolve(device)
    mixed = not prog.is_packable and prog.is_packable_mixed
    field_slots = sorted(prog.field_rows, key=prog.field_rows.get) if mixed else None
    check = build_templated_check(template, batch, "bits_packed", field_slots=field_slots, device=device)
    evaluator = prog.build_packed_mixed(device) if mixed else prog.build_packed(device)
    span = batch * template.num_constraints

    def step(free_packed: torch.Tensor):
        if free_packed.dim() != 3 or free_packed.shape[1] != batch // 32:
            raise ValueError(
                f"free_packed must be [n_chunks, {batch // 32}, n_free], "
                f"got {tuple(free_packed.shape)}"
            )
        nbs, firsts = [], []
        for fp in free_packed:
            nb, first = check.verdict_slot_major(*evaluator.slot_major(fp))
            nbs.append(nb)
            firsts.append(torch.where(nb > 0, first, 0))
        return _aggregate(torch.stack(nbs), torch.stack(firsts), span)

    return step


def build_packed_chunked_witness(prog, device=None):
    """Packed witness generation only: free_packed int32[n_chunks, batch/32,
    n_free] → vals int32[n_chunks, batch/32, S] (batch-major words)."""
    evaluator = prog.build_packed(device)

    def gen(free_packed: torch.Tensor) -> torch.Tensor:
        return torch.stack([evaluator(fp) for fp in free_packed])

    return gen
