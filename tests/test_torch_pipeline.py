"""The port's packed production step against the JAX package's
build_packed_production_step(..., use_pallas=False) at B = 512 with two
chunks, clean and with a corrupted witness program (one op of the tape
computes the wrong function, so the template flags its rows), on the
tests/test_packed.py fixtures; the same on the sha256 template against
the port's chunk-by-chunk verdicts; and the int64 verdict aggregation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.compile.pipeline import build_packed_production_step as ref_step
from bellpepper_tpu.compile.tape import Op
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu_torch import (
    NativeBuilder,
    WitnessProgram,
    build_packed_chunked_witness,
    build_packed_production_step,
    build_templated_check,
)
from bellpepper_tpu_torch.compile.pipeline import _aggregate
from bellpepper_tpu_torch.backend.words import from_numpy_u32
from bellpepper_tpu_torch.compile.tape import SnapshotTape
import test_packed

RNG = np.random.default_rng(0x5EED_0005)
B, N_CHUNKS = 512, 2
SENT = 0xFFFFFFFF


def _corrupted(tape, opcode="xor", into="and"):
    """The tape with its last `opcode` op computing `into` instead."""
    ni, na, ops, free = tape.snapshot()
    i = max(k for k, op in enumerate(ops) if op.opcode == opcode)
    ops = list(ops)
    ops[i] = Op(into, ops[i].outs, ops[i].args)
    return SnapshotTape(tape.field, (ni, na, ops, free))


def _free(prog):
    return RNG.integers(
        0, 1 << 32, size=(N_CHUNKS, B // 32, len(prog.free_slots)), dtype=np.uint64
    ).astype(np.uint32)


@pytest.mark.parametrize("name", ["addmany", "families"])
@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupted"])
def test_step_matches_reference_fixtures(name, corrupt, monkeypatch):
    monkeypatch.setattr(test_packed, "WitnessProgram", lambda tape: tape)
    template, tape = getattr(test_packed, f"_{name}_setup")()
    if corrupt:
        tape = _corrupted(tape)
    ref = RefProgram(tape)
    prog = WitnessProgram(tape)
    free = _free(prog)
    want = tuple(int(v) for v in ref_step(ref, template, B, use_pallas=False)(jnp.asarray(free)))
    got = tuple(int(v) for v in build_packed_production_step(prog, template, B, device="cpu")(from_numpy_u32(free)))
    assert got == want
    if corrupt:
        assert got[0] > 0 and got[1] < N_CHUNKS * B * template.num_constraints
    else:
        assert got == (0, SENT)


@pytest.fixture(scope="module")
def sha256():
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    return nb.finish()


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupted"])
def test_step_matches_chunk_verdicts_sha256(sha256, corrupt):
    template, tape = sha256
    prog = WitnessProgram(_corrupted(tape, "maj", "ch") if corrupt else tape)
    free = from_numpy_u32(_free(prog))
    total, first = build_packed_production_step(prog, template, B, device="cpu")(free)
    assert total.dtype == first.dtype == torch.int64
    words = build_packed_chunked_witness(prog, device="cpu")(free)
    assert words.shape == (N_CHUNKS, B // 32, prog.num_slots)
    check = build_templated_check(template, B, None, "bits_packed", device="cpu")
    span = B * template.num_constraints
    nbs, firsts = zip(*(tuple(int(v) for v in check.verdict(w)) for w in words))
    want_first = min((f + k * span for k, (n, f) in enumerate(zip(nbs, firsts)) if n), default=SENT)
    assert (int(total), int(first)) == (sum(nbs), want_first)
    assert (int(total) > 0) == corrupt


def test_aggregate_indexes_past_2_32():
    """A violation in the last instance of a fifth chunk of 32768 sha256
    instances lies past 2^32; the int64 aggregate keeps it exact (the
    reference's uint32 one wraps)."""
    span = 32768 * 26352
    local = 32767 * 26352 + 5
    nbs = torch.tensor([0, 0, 0, 0, 3])
    firsts = torch.tensor([0, 0, 0, 0, local])
    total, first = _aggregate(nbs, firsts, span)
    assert int(total) == 3 and int(first) == 4 * span + local > 1 << 32
    total, first = _aggregate(torch.zeros(5, dtype=torch.int64), torch.zeros(5, dtype=torch.int64), span)
    assert (int(total), int(first)) == (0, SENT)
    total, first = _aggregate(torch.tensor([0, 2, 1]), torch.tensor([0, 7, 1]), span)
    assert (int(total), int(first)) == (3, span + 7)


def test_step_rejects_wrong_batch(sha256):
    template, tape = sha256
    step = build_packed_production_step(WitnessProgram(tape), template, B, device="cpu")
    with pytest.raises(ValueError):
        step(torch.zeros((1, B // 64, 512), dtype=torch.int32))
