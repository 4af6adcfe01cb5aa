"""The port's mixed packed layout (config 3) against the JAX package: the
mixed program test, build_packed_mixed's (vals, flimbs) pair, the packed
field check's mask and verdict against build_templated_check(t, 512,
False, "bits_packed", field_slots=...) clean and with a flipped pack bit,
addend bit or limb, and the packed production step against the JAX step.
All comparisons are exact.

Config 3 (benchmarks/configs_1_2_3.py:209-258): four allocated UInt32s,
three addmany under one MultiEq, then multipack of the sum's 32 bits into
one field element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.backend import matvec as ref_mv
from bellpepper_tpu.compile.pipeline import build_packed_production_step as ref_step
from bellpepper_tpu.compile.tape import Op as RefOp
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu_torch import NativeBuilder, WitnessProgram, build_packed_production_step
from bellpepper_tpu_torch.backend import matvec as mv
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32

RNG = np.random.default_rng(0x5EED_000A)
B = 512
SENT = 0xFFFFFFFF


def config3(builder_cls):
    nb = builder_cls()
    words = [nb.alloc_u32() for _ in range(4)]
    nb.multieq_begin()
    acc = words[0]
    for w in words[1:]:
        acc = nb.addmany([acc, w])
    nb.multieq_end()
    nb.pack_bits(acc)
    return nb.finish()


def config1_like(builder_cls):
    """A field program the mixed packed evaluator refuses (fmul)."""
    nb = builder_cls()
    bits = [nb.alloc_bit() for _ in range(8)]
    a = nb.pack_bits(bits)
    nb.num_mul(a, a)
    return nb.finish()


@pytest.fixture(scope="module")
def built():
    t, tape = config3(NativeBuilder)
    return t, WitnessProgram(tape), RefProgram(tape)


def _free(prog, n_words, lead=()):
    return RNG.integers(0, 1 << 32, size=lead + (n_words, len(prog.free_slots)),
                        dtype=np.uint64).astype(np.uint32)


def _field_slots(prog):
    return sorted(prog.field_rows, key=prog.field_rows.get)


def test_mixed_program_test_matches_reference(built):
    _t, prog, ref = built
    assert (prog.is_packable, prog.is_packable_mixed) == (ref.is_packable, ref.is_packable_mixed) == (False, True)
    assert [st.opcode for st in prog.stages] == ["addmany"] * 3 + ["pack"]
    _t1, tape1 = config1_like(NativeBuilder)
    p1, r1 = WitnessProgram(tape1), RefProgram(tape1)
    assert (p1.is_packable, p1.is_packable_mixed) == (r1.is_packable, r1.is_packable_mixed) == (False, False)


@pytest.mark.parametrize("n_words", [1, 16])
def test_packed_mixed_witness_matches_reference(built, n_words):
    _t, prog, ref = built
    free = _free(prog, n_words)
    v_r, f_r = ref.build_packed_mixed()(jnp.asarray(free))
    v, f = prog.build_packed_mixed(device="cpu")(from_numpy_u32(free))
    assert v.shape == (n_words, prog.num_slots) and f.shape == (32 * n_words, 1, 16)
    assert (to_numpy_u32(v) == np.asarray(v_r)).all()
    assert (to_numpy_u32(f) == np.asarray(f_r)).all()
    # the pack slot reads 0 in vals; its value is the sum's low 32 bits
    slot = _field_slots(prog)[0]
    assert not to_numpy_u32(v)[:, slot].any()


def test_packed_mixed_refuses_field_ops():
    _t, tape = config1_like(NativeBuilder)
    prog = WitnessProgram(tape)
    with pytest.raises(NotImplementedError):
        prog.build_packed_mixed(device="cpu")


class _Pair:
    """The port's and the reference's packed field checks at B."""

    def __init__(self, template, field_slots):
        self.ref = ref_mv.build_templated_check(template, B, False, "bits_packed", field_slots=field_slots)
        self.mask_ref = jax.jit(self.ref)
        self.verdict_ref = jax.jit(self.ref.verdict)
        self.port = mv.build_templated_check(template, B, None, "bits_packed", field_slots=field_slots, device="cpu")
        assert isinstance(self.port, mv.PackedFieldCheck)

    def check(self, vals, flimbs):
        """The port's (mask, verdict) equal the reference's; returns the
        verdict."""
        m_r = np.asarray(self.mask_ref(jnp.asarray(vals), jnp.asarray(flimbs)))
        v_r = tuple(int(x) for x in self.verdict_ref(jnp.asarray(vals), jnp.asarray(flimbs)))
        pv, pf = from_numpy_u32(vals), from_numpy_u32(flimbs)
        m = self.port(pv, pf).numpy()
        got = tuple(int(x) for x in self.port.verdict(pv, pf))
        assert (m == m_r).all()
        assert got == v_r
        assert got[0] == int(m_r.sum())
        return got


def test_packed_field_check_matches_reference(built):
    template, prog, ref = built
    fs = _field_slots(prog)
    pair = _Pair(template, fs)
    assert (pair.port.n_pf, pair.port.Rt_sub) == (1, 228)
    vals, flimbs = (np.asarray(x) for x in ref.build_packed_mixed()(jnp.asarray(_free(prog, B // 32))))
    R = template.num_constraints
    assert pair.check(vals, flimbs) == (0, SENT)
    pack_op = next(st for st in prog.stages if st.opcode == "pack")
    sum_bit = int(pack_op.arrs["idx"][0, 5])  # bit 5 of the packed sum
    addend = prog.free_slots[40]  # bit 8 of the second word
    cases = []
    v = vals.copy()
    v[7, sum_bit] ^= np.uint32(1 << 3)  # a pack bit of instance 227
    cases.append((v, flimbs, 7 * 32 + 3))
    v = vals.copy()
    v[2, addend] ^= np.uint32(1 << 30)  # an addend bit of instance 94
    cases.append((v, flimbs, 2 * 32 + 30))
    f = flimbs.copy()
    f[300, 0, 1] ^= np.uint32(1 << 4)  # bit 20 of the pack output
    cases.append((vals, f, 300))
    f = flimbs.copy()
    f[11, 0, 15] ^= np.uint32(1 << 14)  # bit 254, above every bit the pack can set
    cases.append((vals, f, 11))
    for v, f, inst in cases:
        nb, first = pair.check(v, f)
        assert nb > 0 and first // R == inst, (nb, first, inst)
    rand = RNG.integers(0, 1 << 32, size=vals.shape, dtype=np.uint64).astype(np.uint32)
    rand[:, 0] = SENT
    pair.check(rand, flimbs)
    # bit 255 (limb 15, bit 15) makes the limbs name another residue; the
    # reference compares bits below NUM_BITS = 255 only, the port all 256
    f = flimbs.copy()
    f[40, 0, 15] ^= np.uint32(1 << 15)
    pv, pf = from_numpy_u32(vals), from_numpy_u32(f)
    row = int(pair.port.pf_rows[0])
    mask = pair.port(pv, pf).numpy()
    assert mask.sum() == 1 and mask[40 * R + row]
    assert tuple(int(x) for x in pair.port.verdict(pv, pf)) == (1, 40 * R + row)


def test_packed_field_check_refuses_other_field_rows():
    """A row that reads the pack output as anything but the multipack C
    side is not of the sidecar's shape."""
    nb = NativeBuilder()
    bits = nb.alloc_u32()
    x = nb.pack_bits(bits)
    nb.num_square(x)
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    with pytest.raises(NotImplementedError):
        mv.build_templated_check(template, B, None, "bits_packed", field_slots=prog.field_slots, device="cpu")


def _corrupted(tape):
    """The tape with the pack op's first two bits swapped: its field value
    no longer equals Σ 2^i·b_i."""
    ni, na, ops, free = tape.snapshot()
    ops = list(ops)
    i = next(k for k, op in enumerate(ops) if op.opcode == "pack")
    args = list(ops[i].args)
    args[0], args[1] = args[1], args[0]
    ops[i] = RefOp("pack", ops[i].outs, args)

    class _Tape:
        field = tape.field

        def snapshot(self):
            return ni, na, ops, free

    return _Tape()


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupted"])
def test_packed_mixed_step_matches_reference(built, corrupt):
    template, _prog, _ref = built
    _t, tape = config3(RefBuilder)
    if corrupt:
        tape = _corrupted(tape)
    prog, ref = WitnessProgram(tape), RefProgram(tape)
    free = _free(prog, B // 32, (2,))
    want = tuple(int(v) for v in ref_step(ref, template, B, use_pallas=False)(jnp.asarray(free)))
    got = tuple(int(v) for v in build_packed_production_step(prog, template, B, device="cpu")(from_numpy_u32(free)))
    assert got == want
    assert (got[0] > 0) == corrupt
    if not corrupt:
        assert got == (0, SENT)
    with pytest.raises(ValueError):
        build_packed_production_step(prog, template, B, device="cpu")(torch.zeros((1, 8, 128), dtype=torch.int32))


def test_field_check_remaps_first_in_int64(built, monkeypatch):
    """The inner check's first index maps back to the template's rows in
    int64: an instance past 2^32 / R (where the reference's uint32 remap,
    matvec.py:2686, wraps) keeps its exact index."""
    template, prog, _ref = built
    check = mv.build_templated_check(template, B, None, "bits_packed", field_slots=_field_slots(prog), device="cpu")
    R, Rs = template.num_constraints, check.Rt_sub
    inst, sub_row = 40_000_000, 5
    assert inst * R > 1 << 32
    big = torch.tensor(inst * Rs + sub_row)
    monkeypatch.setattr(check.inner, "verdict_slot_major", lambda vals_p: (torch.tensor(3), big))
    vals, flimbs = prog.build_packed_mixed(device="cpu")(from_numpy_u32(_free(prog, B // 32)))
    nb, first = check.verdict(vals, flimbs)
    assert int(nb) == 3 and int(first) == inst * R + int(check.remaining[sub_row])
