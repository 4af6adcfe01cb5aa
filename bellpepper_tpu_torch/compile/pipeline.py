"""The production steps: witness generation and check over chunks.

Counterpart of ``bellpepper_tpu/compile/pipeline.py``:
``build_chunked_check`` (``:72-97``), ``build_production_step``
(``:100-170``, the bits, mixed and limbs forms),
``build_packed_production_step`` (``:173-232``, the mixed packed layout
included),
``build_packed_chunked_witness`` (``:235``), ``build_chunked_witness``
(``:253``), ``_aggregate`` (``:62-69``), the chained and tree pipelines
(``_carry_extractor`` ``:278``, ``build_chained_witness`` ``:297``,
``build_chained_production_step`` ``:340``, ``_STATE_TO_MSG_PERM``
``:382``, ``build_merkle_tree_step`` ``:387``), ``PipelinedSatisfier``
(``:441``) and ``which_from_flat`` (``:487``, in ``backend/satisfier.py``
beside the checkers that name rows). Every builder takes the reference's
parameters in its order, and ``device`` after them, keyword-only. The
reference's ``use_pallas`` swaps its jnp code for Pallas kernels; the
port has one implementation of each step, so the argument is checked
(None, True or False) and the same kernels run.
The reference's single jitted ``lax.scan`` over chunks becomes a Python
loop that enqueues every chunk's work on the current stream and reads
nothing back: the host first waits when the caller reads the verdict. The
chain's scan over dependent blocks becomes one CUDA graph of a block,
captured once for each batch and replayed once a block. Index arithmetic is int64, so a
global violation index past 2^32 (a fifth chunk of 32768 sha256
instances) does not wrap. Every builder runs on the CUDA card unless it
is given another device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..backend.check_common import NONE, SENTINEL
from ..backend.matvec import build_packed_parts, build_templated_check
from ..backend.satisfier import which_from_flat
from ..backend.words import device_table
from ..device import check_use_pallas, resolve
from ..r1cs import R1CS
from ..utils import profiling
from .tape import V_CONST, V_VAR


def _aggregate(nbs: torch.Tensor, firsts: torch.Tensor, chunk_span: int):
    """Combine per-chunk (n_bad, local_first) into a global verdict
    (total, first); first is 0xFFFFFFFF when nothing is violated."""
    total = nbs.sum()
    offsets = torch.arange(firsts.shape[0], dtype=torch.int64, device=firsts.device)
    glob = torch.where(nbs > 0, firsts + offsets * chunk_span, NONE).min()
    return total, torch.where(glob == NONE, SENTINEL, glob)


def build_production_step(prog, template: R1CS, batch: int, use_pallas: Optional[bool] = None,
                          witness_form: Optional[str] = None, *, device=None):
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
        check = build_templated_check(template, batch, use_pallas, "mixed", field_slots=prog.field_slots,
                                      device=device)
    else:
        check = build_templated_check(template, batch, use_pallas, witness_form, device=device)
    evaluator = prog.build(use_pallas, device=device)
    span = batch * template.num_constraints
    n_ff = len(prog.free_field_slots)

    def chunk_verdict(fb, ff):
        if witness_form == "mixed":  # flimbs in field_slots order: the rows, then the free inputs
            return check.verdict_slot_major(*evaluator.slot_major(fb, ff, free_rows=True))
        vals, flimbs = evaluator.slot_major(fb, ff)
        if witness_form == "bits":
            return check.verdict_slot_major(vals)
        free_T = ff.permute(1, 2, 0) if n_ff else None
        return check.verdict_slot_major(prog.z_template_limbs_slot_major(vals, flimbs, free_T))

    def step(free_bits: torch.Tensor, free_field=None):
        if free_bits.dim() != 3 or free_bits.shape[1] != batch:
            raise ValueError(
                f"free_bits must be [n_chunks, {batch}, n_free], got {tuple(free_bits.shape)}"
            )
        with profiling.span("step"):
            nbs, firsts = [], []
            for k, fb in enumerate(free_bits):
                nb, first = chunk_verdict(fb, None if free_field is None else free_field[k])
                nbs.append(nb)
                firsts.append(torch.where(nb > 0, first, 0))
            with profiling.span("step.aggregate"):
                return _aggregate(torch.stack(nbs), torch.stack(firsts), span)

    return step


def build_chunked_check(template: R1CS, batch: int, n_chunks: int, use_pallas: Optional[bool] = None,
                        witness_form: str = "limbs", *, device=None):
    """Check pre-generated witnesses of n_chunks × batch instances: z4
    int32[n_chunks, batch, S_t, 16] canonical limbs (``"limbs"``) or
    int32[n_chunks, batch, S_t] 0/1 values (``"bits"``) → (total_bad,
    first_violation) as in ``build_production_step``."""
    if witness_form not in ("bits", "limbs"):
        raise ValueError(f"witness_form must be 'bits' or 'limbs', got {witness_form!r}")
    check = build_templated_check(template, batch, use_pallas, witness_form, device=resolve(device))
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


def build_chunked_witness(prog, use_pallas: Optional[bool] = None, *, device=None):
    """Witness generation only: free_bits int32[n_chunks, batch, n_free]
    (and free_field int32[n_chunks, batch, nf, 16] when the program has
    free field inputs) → vals int32[n_chunks, batch, S], the u32 value
    buffer of every instance."""
    evaluator = prog.build(use_pallas, device=device)

    def gen(free_bits: torch.Tensor, free_field=None) -> torch.Tensor:
        return torch.stack([
            evaluator(fb, None if free_field is None else free_field[k])[0]
            for k, fb in enumerate(free_bits)
        ])

    return gen


def build_packed_production_step(prog, template: R1CS, batch: int, use_pallas: Optional[bool] = None, *,
                                 device=None):
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
    check_use_pallas(use_pallas)
    evaluator, check = build_packed_parts(prog, template, batch, resolve(device))
    span = batch * template.num_constraints

    def step(free_packed: torch.Tensor):
        if free_packed.dim() != 3 or free_packed.shape[1] != batch // 32:
            raise ValueError(
                f"free_packed must be [n_chunks, {batch // 32}, n_free], "
                f"got {tuple(free_packed.shape)}"
            )
        with profiling.span("step"):
            nbs, firsts = [], []
            for fp in free_packed:
                nb, first = check.verdict_slot_major(*evaluator.slot_major(fp))
                nbs.append(nb)
                firsts.append(torch.where(nb > 0, first, 0))
            with profiling.span("step.aggregate"):
                return _aggregate(torch.stack(nbs), torch.stack(firsts), span)

    return step


def build_packed_chunked_witness(prog, *, device=None):
    """Packed witness generation only: free_packed int32[n_chunks, batch/32,
    n_free] → vals int32[n_chunks, batch/32, S] (batch-major words)."""
    evaluator = prog.build_packed(device=device)

    def gen(free_packed: torch.Tensor) -> torch.Tensor:
        return torch.stack([evaluator(fp) for fp in free_packed])

    return gen


def _carry_extractor(carry_views, device=None):
    """Compile tape views (kind, slot|const, neg), such as the digest of
    ``NativeBuilder.sha256_compression`` decoded by ``NativeBuilder.view``,
    into extract(vals, slot_major=False): batch-major vals int32[B, S] →
    int32[B, n_carry], or slot-major int32[S, B] → int32[n_carry, B]. A
    constant view reads its value, a variable one its slot XOR its
    negation."""
    device = resolve(device)
    arr = np.asarray(carry_views, np.int64).reshape(-1, 3)
    kind, raw, neg = arr.T
    isvar = kind == V_VAR
    slots = device_table(np.where(isvar, raw, 0), device)
    negs = device_table(np.where(isvar, neg, 0), device, torch.int32)
    cvals = device_table(np.where(kind == V_CONST, raw, 0), device, torch.int32)
    mask = device_table(isvar, device, torch.bool)

    def extract(vals: torch.Tensor, slot_major: bool = False) -> torch.Tensor:
        if slot_major:
            return torch.where(mask[:, None], vals.index_select(0, slots) ^ negs[:, None], cvals[:, None])
        return torch.where(mask, vals.index_select(1, slots) ^ negs, cvals)

    return extract


class _BlockGraph:
    """One chain block at batch B captured as a CUDA graph: the evaluator
    on the static free-input buffer ``free`` int32[B, n_free] and the carry
    extraction into its first n_carry columns; ``vals`` int32[S, B] is the
    graph's output, overwritten by every replay."""

    def __init__(self, block, B: int, n_free: int, device: torch.device):
        self.free = torch.zeros((B, n_free), dtype=torch.int32, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # the warm-up PyTorch asks before a capture
            block(self.free)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.vals = block(self.free)


class ChainedWitness:
    """``build_chained_witness``'s generator: gen(init_state, msgs) →
    (vals, final_state). ``evaluator`` and ``extract`` are its block's
    parts; ``graphs`` holds the captured block of each batch on the card."""

    def __init__(self, prog, carry_views, use_pallas, device):
        if not prog.is_pure_bits:
            raise ValueError("chained pipelines take pure-bit programs")
        self.device = device
        self.evaluator = prog.build(use_pallas, device=device)
        self.extract = _carry_extractor(carry_views, device)
        self.n_carry = len(carry_views)
        self.n_free = len(prog.free_slots)
        self.num_slots = prog.num_slots
        self.graphs = {}

    def block(self, free: torch.Tensor) -> torch.Tensor:
        """One block: free int32[B, n_free] → vals int32[S, B], the carry
        out written into free's first n_carry columns."""
        vals, _ = self.evaluator.slot_major(free)
        free[:, : self.n_carry] = self.extract(vals, slot_major=True).t()
        return vals

    def __call__(self, init_state: torch.Tensor, msgs: torch.Tensor):
        n_msg = self.n_free - self.n_carry
        if (init_state.dim() != 2 or init_state.shape[1] != self.n_carry or msgs.dim() != 3
                or msgs.shape[1:] != (init_state.shape[0], n_msg)
                or init_state.dtype != torch.int32 or msgs.dtype != torch.int32):
            raise ValueError(
                f"init_state must be int32[B, {self.n_carry}] and msgs int32[T, B, {n_msg}], got "
                f"{init_state.dtype}{tuple(init_state.shape)} and {msgs.dtype}{tuple(msgs.shape)}"
            )
        init_state, msgs = init_state.to(self.device), msgs.to(self.device)
        T, B = msgs.shape[:2]
        out = torch.empty((T, B, self.num_slots), dtype=torch.int32, device=self.device)
        if self.device.type == "cuda":
            g = self.graphs.get(B)
            if g is None:
                g = self.graphs[B] = _BlockGraph(self.block, B, self.n_free, self.device)
            free, run = g.free, g.graph.replay
        else:
            free = torch.empty((B, self.n_free), dtype=torch.int32, device=self.device)
            run = None
        free[:, : self.n_carry] = init_state
        for t in range(T):
            free[:, self.n_carry :] = msgs[t]
            if run is None:
                vals = self.block(free)
            else:
                run()
                vals = g.vals
            out[t] = vals.t()
        return out, free[:, : self.n_carry].clone()


def build_chained_witness(prog, carry_views, use_pallas: Optional[bool] = None, *, device=None) -> ChainedWitness:
    """Chained witness generation: instance t+1's first n_carry free
    inputs are computed from instance t's witness (a hash chain: the digest
    of block t is the IV of block t+1).

    Template contract, as the reference's: the first len(carry_views) free
    slots of the pure-bit `prog` are the carry-in bits, and carry_views
    (tape-view triples) say where each carry-out bit lives in a block's
    witness. gen(init_state int32[B, n_carry], msgs int32[T, B, n_msg]) →
    (vals int32[T, B, S], final_state int32[B, n_carry]): B independent
    chains of T blocks.

    On the CPU each block runs the evaluator eagerly. On a CUDA device each
    block is one replay of a CUDA graph of the evaluator and the carry
    extraction, captured at the first call of each batch B (after one
    warm-up on a side stream) and cached; a failed capture raises. The
    loop copies msgs[t] into the graph's input, replays and copies the
    graph's vals out, all on the current stream, with no host sync."""
    return ChainedWitness(prog, carry_views, use_pallas, resolve(device))


class ChainedProductionStep:
    """``build_chained_production_step``'s step: ``gen`` (the chained
    witness) then ``verdict`` (the chunked bits check of its vals)."""

    def __init__(self, prog, template: R1CS, carry_views, check_batch: int, use_pallas, device: torch.device):
        self.gen = build_chained_witness(prog, carry_views, use_pallas, device=device)
        self.check = build_templated_check(template, check_batch, use_pallas, "bits", device=device)
        self.check_batch = check_batch
        self.span = check_batch * template.num_constraints

    def _refuse_ragged(self, n_inst: int) -> None:
        if n_inst % self.check_batch:
            raise ValueError(f"T·B = {n_inst} instances is not a multiple of check_batch {self.check_batch}")

    def verdict(self, vals_all: torch.Tensor):
        """vals int32[T, B, S] → (total_bad, first_flat) over its T·B
        instances in (t, b) order, in chunks of check_batch."""
        T, B, S = vals_all.shape
        self._refuse_ragged(T * B)
        nbs, firsts = [], []
        for z in vals_all.reshape(T * B // self.check_batch, self.check_batch, S):
            nb, first = self.check.verdict(z)
            nbs.append(nb)
            firsts.append(torch.where(nb > 0, first, 0))
        return _aggregate(torch.stack(nbs), torch.stack(firsts), self.span)

    def __call__(self, init_state: torch.Tensor, msgs: torch.Tensor):
        self._refuse_ragged(msgs.shape[0] * msgs.shape[1])
        vals_all, final = self.gen(init_state, msgs)
        total, first = self.verdict(vals_all)
        return total, first, final


def build_chained_production_step(prog, template: R1CS, carry_views, check_batch: int = 128,
                                  use_pallas: Optional[bool] = None, *, device=None) -> ChainedProductionStep:
    """Chained witness generation, then the bits check of all T·B
    instances in chunks of check_batch: step(init_state int32[B, n_carry],
    msgs int32[T, B, n_msg]) → (total_bad, first_flat, final_state).
    first_flat indexes instances in (t, b) order × num_constraints, as
    ``which_from_flat`` reads it (0xFFFFFFFF when clean); T·B must be a
    multiple of check_batch, or the step raises ValueError before any
    block runs."""
    return ChainedProductionStep(prog, template, carry_views, check_batch, use_pallas, resolve(device))


# digest state bits (8 words × 32, LSB first) → message bits (big-endian
# within each word, the sha256 gadget's order)
_STATE_TO_MSG_PERM = np.asarray([w * 32 + (31 - t) for w in range(8) for t in range(32)], np.int32)


def build_merkle_tree_step(prog, template: R1CS, digest_views, n_leaves: int, use_pallas: Optional[bool] = None,
                           *, device=None):
    """Merkle tree reduction: each level hashes sibling pairs with one
    batched evaluation and one bits check (the batch halves a level), and
    the digests become the next level's message bits through
    ``_STATE_TO_MSG_PERM`` on the device, with no host round trip.

    Template contract, as the reference's: one compression whose 512 free
    slots are the message bits (constant IV); digest_views (decoded by
    ``NativeBuilder.view``) say where the digest bits live.
    step(leaf_digests int32[n_leaves, 256]) → (root int32[256], total_bad
    int64), total_bad counting the violated rows of every internal node."""
    if n_leaves < 2 or n_leaves & (n_leaves - 1):
        raise ValueError(f"n_leaves must be a power of two >= 2, got {n_leaves}")
    if not prog.is_pure_bits:
        raise ValueError("the Merkle pipeline takes a pure-bit program")
    device = resolve(device)
    evaluator = prog.build(use_pallas, device=device)
    extract = _carry_extractor(digest_views, device)
    perm = device_table(_STATE_TO_MSG_PERM, device)
    checks = {}
    b = n_leaves // 2
    while b >= 1:
        checks[b] = build_templated_check(template, b, use_pallas, "bits", device=device)
        b //= 2

    def step(leaf_digests: torch.Tensor):
        if tuple(leaf_digests.shape) != (n_leaves, 256):
            raise ValueError(f"leaf_digests must be [{n_leaves}, 256], got {tuple(leaf_digests.shape)}")
        d = leaf_digests
        total = torch.zeros((), dtype=torch.int64, device=device)
        while d.shape[0] > 1:
            msg = torch.cat([d[0::2].index_select(1, perm), d[1::2].index_select(1, perm)], dim=1)
            vals, _ = evaluator.slot_major(msg)
            total = total + checks[msg.shape[0]].verdict_slot_major(vals)[0]
            d = extract(vals, slot_major=True).t()
        return d[0], total

    return step


class PipelinedSatisfier:
    """The TemplatedSatisfier API over chunked witness buffers
    [n_chunks, batch, ...] (``build_chunked_check``'s z4), one verdict a
    call. A `config` gives `use_pallas` where it is None, and
    `witness_form` only where it is falsy: the reference reads
    ``witness_form or config.witness_form``, so its default ``"limbs"``
    stands against a ``Config(witness_form="bits")``."""

    def __init__(self, template: R1CS, batch: int, n_chunks: int, use_pallas: Optional[bool] = None,
                 witness_form: str = "limbs", config=None, *, device=None):
        if config is not None:
            if use_pallas is None:
                use_pallas = config.use_pallas
            witness_form = witness_form or config.witness_form
        self.use_pallas = check_use_pallas(use_pallas)
        self.r1cs = template
        self.batch = batch
        self.n_chunks = n_chunks
        self.witness_form = witness_form
        self._check = build_chunked_check(template, batch, n_chunks, use_pallas, witness_form, device=device)
        self.num_constraints_total = n_chunks * batch * template.num_constraints

    def is_satisfied(self, z4: torch.Tensor) -> bool:
        total, _ = self._check(z4)
        return int(total) == 0

    def which_is_unsatisfied(self, z4: torch.Tensor) -> Optional[str]:
        total, first = self._check(z4)
        if int(total) == 0:
            return None
        chunk, rest = divmod(int(first), self.batch * self.r1cs.num_constraints)
        return f"chunk {chunk}: {which_from_flat(self.r1cs, rest)}"
