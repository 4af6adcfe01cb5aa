"""The port's chained pipeline against the JAX package's, on the CPU: the
carry extractor on random values, build_chained_witness at T = 3, B = 2
(vals and final state), the hashlib digest of a two-block message, the
chained production step's verdict clean and with one witness bit flipped
(against the JAX chunked bits check on the same z4), its refusal of a
T·B that check_batch does not divide, and which_from_flat and
PipelinedSatisfier. Every comparison is exact (tolerance 0): the values
are bits and the verdicts integers."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.compile import pipeline as ref
from bellpepper_tpu.compile.tape import TapeCS
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.gadgets.multieq import MultiEq
from bellpepper_tpu.gadgets.uint32 import UInt32
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu.r1cs import ShapeCS
from bellpepper_tpu_torch import NativeBuilder, WitnessProgram
from bellpepper_tpu_torch.compile.pipeline import (
    PipelinedSatisfier,
    _carry_extractor,
    build_chained_production_step,
    build_chained_witness,
    build_chunked_check,
    build_chunked_witness,
    which_from_flat,
)

RNG = np.random.default_rng(0x5EED_0008)
T, B = 3, 2
SENT = 0xFFFFFFFF


def _chain_template(builder_cls):
    """One sha256 compression whose IV is 256 free bits allocated before
    the 512 message bits: (template, tape, carry views)."""
    nb = builder_cls()
    state = [nb.alloc_bit() for _ in range(256)]
    msg = [nb.alloc_bit() for _ in range(512)]
    out = nb.sha256_compression(msg, state)
    template, tape = nb.finish()
    return template, tape, [nb.view(v) for v in out]


def _iv_bits():
    nb = NativeBuilder()
    return np.asarray([v for (_k, v, _n) in (nb.view(x) for x in nb.sha256_iv())], np.int32)


def _small_bits():
    """tests/test_pipeline.py's named bits circuit (a xor, an addmany):
    its ShapeCS template and its TapeCS tape."""
    def circuit(cs):
        a = UInt32.alloc(cs.namespace("a"), None)
        b = UInt32.alloc(cs.namespace("b"), None)
        x = a.xor(cs.namespace("x"), b.rotr(7))
        with MultiEq(cs) as mcs:
            UInt32.addmany(mcs.namespace("s"), [x, a.shr(3)])

    shape, tape = ShapeCS(), TapeCS()
    circuit(shape)
    circuit(tape)
    return shape.finish(), tape


@pytest.fixture(scope="module")
def chain():
    template, tape, views = _chain_template(NativeBuilder)
    return template, WitnessProgram(tape), views


@pytest.fixture(scope="module")
def inputs():
    msgs = RNG.integers(0, 2, size=(T, B, 512)).astype(np.int32)
    return np.tile(_iv_bits(), (B, 1)), msgs


@pytest.fixture(scope="module")
def ref_chain(inputs):
    """The JAX package's chained witness of `inputs` (one jit, shared)."""
    template, tape, views = _chain_template(RefBuilder)
    iv, msgs = inputs
    gen = ref.build_chained_witness(RefProgram(tape), views, use_pallas=False)
    vals, final = gen(jnp.asarray(iv.astype(np.uint32)), jnp.asarray(msgs.astype(np.uint32)))
    return template, np.asarray(vals), np.asarray(final)


@pytest.fixture(scope="module")
def port_chain(chain, inputs):
    _template, prog, views = chain
    iv, msgs = inputs
    vals, final = build_chained_witness(prog, views, device="cpu")(torch.from_numpy(iv), torch.from_numpy(msgs))
    return vals.numpy(), final.numpy()


def test_carry_extractor_matches_reference(chain):
    """Batch-major and slot-major extraction of the digest views, with a
    constant and a negated view among them, on random words."""
    _template, prog, views = chain
    views = list(views) + [(0, 1, 0), (0, 0, 0), (1, 7, 1), (1, 9, 0)]
    vals = RNG.integers(0, 2, size=(5, prog.num_slots)).astype(np.int32)
    want = np.asarray(ref._carry_extractor(views)(jnp.asarray(vals.astype(np.uint32))))
    extract = _carry_extractor(views, device="cpu")
    got = extract(torch.from_numpy(vals)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got.view(np.uint32), want)
    got_sm = extract(torch.from_numpy(vals.T.copy()), slot_major=True).numpy()
    assert np.array_equal(got_sm.T, got)


def test_chained_witness_matches_reference(chain, ref_chain, port_chain):
    _template, prog, views = chain
    _ref_template, want_vals, want_final = ref_chain
    vals, final = port_chain
    assert vals.shape == (T, B, prog.num_slots) and final.shape == (B, 256)
    assert np.array_equal(vals.view(np.uint32), want_vals)
    assert np.array_equal(final.view(np.uint32), want_final)
    # block t + 1 starts from block t's digest
    digest = _carry_extractor(views, device="cpu")(torch.from_numpy(vals[0])).numpy()
    assert np.array_equal(vals[1][:, prog.free_slots[:256]], digest)


def test_chained_digest_matches_hashlib(chain):
    """sha256 of a 64-byte message is two chained compressions (the
    message block, then the padding block)."""
    template, prog, views = chain
    m = bytes(range(64))
    padded = m + b"\x80" + b"\x00" * 61 + (512).to_bytes(2, "big")
    bits = [[[(byte >> (7 - i)) & 1 for byte in padded[k : k + 64] for i in range(8)]] for k in (0, 64)]
    step = build_chained_production_step(prog, template, views, check_batch=2, device="cpu")
    total, first, final = step(torch.from_numpy(_iv_bits()[None]), torch.tensor(bits, dtype=torch.int32))
    assert (int(total), int(first)) == (0, SENT)
    fb = final[0].tolist()
    words = [sum(fb[32 * w + i] << i for i in range(32)) for w in range(8)]
    assert b"".join(w.to_bytes(4, "big") for w in words) == hashlib.sha256(m).digest()


def test_production_step_clean_and_flipped(chain, inputs, ref_chain, port_chain):
    """The step's clean verdict and final state; then one flipped witness
    bit through the port's and the JAX package's chunked bits checks on
    the same z4 (check_batch 2: three chunks)."""
    template, prog, views = chain
    iv, msgs = inputs
    cb = 2
    step = build_chained_production_step(prog, template, views, check_batch=cb, device="cpu")
    total, first, final = step(torch.from_numpy(iv), torch.from_numpy(msgs))
    assert (int(total), int(first)) == (0, SENT)
    assert np.array_equal(final.numpy(), port_chain[1])

    vals, _ = port_chain
    z4 = vals.reshape(T * B // cb, cb, prog.num_slots).copy()
    z4[1, 1, prog.num_slots - 5] ^= 1
    check = ref.build_chunked_check(ref_chain[0], cb, T * B // cb, use_pallas=False, witness_form="bits")
    want = tuple(int(v) for v in check(jnp.asarray(z4.astype(np.uint32))))
    got = build_chunked_check(template, cb, T * B // cb, device="cpu", witness_form="bits")(torch.from_numpy(z4))
    assert tuple(int(v) for v in got) == want
    span = cb * template.num_constraints
    assert want[0] > 0 and span + template.num_constraints <= want[1] < 2 * span  # chunk 1, instance 1


def test_production_step_refuses_ragged_chunks(chain, inputs):
    template, prog, views = chain
    iv, msgs = inputs
    step = build_chained_production_step(prog, template, views, check_batch=4, device="cpu")
    with pytest.raises(ValueError):
        step(torch.from_numpy(iv), torch.from_numpy(msgs))  # T·B = 6
    gen = build_chained_witness(prog, views, device="cpu")
    with pytest.raises(ValueError):
        gen(torch.from_numpy(iv[:, :255]), torch.from_numpy(msgs))


def test_chained_refuses_field_programs():
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(4)]
    nb.pack_bits(bits)
    _template, tape = nb.finish()
    with pytest.raises(ValueError):
        build_chained_witness(WitnessProgram(tape), [nb.view(b) for b in bits], device="cpu")


@pytest.mark.parametrize("flat", [0, 5, 93, 4 * 10 + 3])
def test_which_from_flat_matches_reference(flat):
    template, _tape = _small_bits()
    assert which_from_flat(template, flat) == ref.which_from_flat(template, flat)
    nb = NativeBuilder()
    a, b = nb.alloc_bit(), nb.alloc_bit()
    nb.xor(a, b)
    unnamed, _ = nb.finish()
    assert which_from_flat(unnamed, flat) == ref.which_from_flat(unnamed, flat)


def test_pipelined_satisfier_matches_reference():
    """is_satisfied and which_is_unsatisfied of both packages on the same
    bits witness, clean and with one bit of chunk 1, instance 3 flipped."""
    template, tape = _small_bits()
    prog = WitnessProgram(tape)
    n_chunks, batch = 2, 4
    free = RNG.integers(0, 2, size=(n_chunks, batch, len(prog.free_slots))).astype(np.int32)
    vals = build_chunked_witness(prog, device="cpu")(torch.from_numpy(free))
    ref_vals = ref.build_chunked_witness(RefProgram(tape), use_pallas=False)(jnp.asarray(free.astype(np.uint32)))
    assert np.array_equal(vals.numpy().view(np.uint32), np.asarray(ref_vals))
    sat = PipelinedSatisfier(template, batch, n_chunks, device="cpu", witness_form="bits")
    ref_sat = ref.PipelinedSatisfier(template, batch, n_chunks, use_pallas=False, witness_form="bits")
    bad = vals.clone()
    bad[1, 3, prog.num_slots - 2] ^= 1
    for z in (vals, bad):
        zj = jnp.asarray(z.numpy().astype(np.uint32))
        assert sat.is_satisfied(z) == ref_sat.is_satisfied(zj)
        assert sat.which_is_unsatisfied(z) == ref_sat.which_is_unsatisfied(zj)
    assert sat.which_is_unsatisfied(bad).startswith("chunk 1: instance 3:")
    assert sat.num_constraints_total == ref_sat.num_constraints_total
