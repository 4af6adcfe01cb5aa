"""The port's native builder, stage compile and packed evaluator against
the JAX package: the sha256 template's R1CS arrays and decoded tape, the
compiled stages, and the packed witness words (bit-exact) on the sha256
template and on the tests/test_packed.py fixtures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.compile.tape import V_VAR, Op as RefOp
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu_torch import NativeBuilder, WitnessProgram
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.compile.tape import SnapshotTape
import test_packed

RNG = np.random.default_rng(0x5EED_0002)
FIXTURES = ["addmany", "families", "adversarial_pow2", "lookalike"]


def _sha256(builder_cls):
    nb = builder_cls()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    return nb.finish()


@pytest.fixture(scope="module")
def sha_ref():
    return _sha256(RefBuilder)


@pytest.fixture(scope="module")
def sha_port():
    return _sha256(NativeBuilder)


def fixture_tape(name, monkeypatch):
    """(template, TapeCS tape) of a tests/test_packed.py fixture circuit."""
    monkeypatch.setattr(test_packed, "WitnessProgram", lambda tape: tape)
    return getattr(test_packed, f"_{name}_setup")()


def test_native_template_matches_reference(sha_ref, sha_port):
    (t_ref, tape_ref), (t, tape) = sha_ref, sha_port
    assert t.num_constraints == t_ref.num_constraints == 26352
    assert t.num_inputs + t.num_aux == 26327
    assert (t.num_inputs, t.num_aux) == (t_ref.num_inputs, t_ref.num_aux)
    assert t.coeff_table == t_ref.coeff_table
    for name in "abc":
        m, m_ref = getattr(t, name), getattr(t_ref, name)
        for f in ("rows", "cols", "coeff_ids"):
            assert (np.asarray(getattr(m, f)) == np.asarray(getattr(m_ref, f))).all()
    ni, na, ops, free = tape.snapshot()
    ni_r, na_r, ops_r, free_r = tape_ref.snapshot()
    assert (ni, na, free) == (ni_r, na_r, free_r)
    assert len(ops) == len(ops_r)
    for op, op_r in zip(ops, ops_r):
        assert (op.opcode, op.outs, op.args) == (op_r.opcode, op_r.outs, op_r.args)


# --- NativeBuilder's bit gadgets: configs 2 and 3, blake2s -------------------
def _config2(nb):
    """benchmarks/configs_1_2_3.py:162-206 through the builder: rotr is an
    index rotation, shr a shift with constant(False) fill."""
    ops = [nb.alloc_u32() for _ in range(8)]
    nb.multieq_begin()
    x = ops[0]
    for i in range(1, 8):
        rot = [ops[i][(k + 5 * i) % 32] for k in range(32)]
        x = [nb.xor(a, b) for a, b in zip(x, rot)]
        x = nb.addmany([x, ops[i - 1][3:] + [nb.constant(False)] * 3])
    nb.multieq_end()


def _config3(nb):
    """benchmarks/configs_1_2_3.py:209-258 through the builder."""
    words = [nb.alloc_u32() for _ in range(4)]
    nb.multieq_begin()
    acc = words[0]
    for w in words[1:]:
        acc = nb.addmany([acc, w])
    nb.multieq_end()
    nb.pack_bits(acc)


def _blake2s(nb):
    """One blake2s compression of free h and m bits, t = 64, f = True."""
    h = [nb.alloc_bit() for _ in range(256)]
    m = [nb.alloc_bit() for _ in range(512)]
    nb.blake2s_compression(h, m, 64, True)


def _config2_py(cs):
    from bellpepper_tpu.gadgets.multieq import MultiEq
    from bellpepper_tpu.gadgets.uint32 import UInt32

    ops = [UInt32.alloc(cs.namespace(f"op {i}"), None) for i in range(8)]
    with MultiEq(cs) as mcs:
        x = ops[0]
        for i in range(1, 8):
            x = x.xor(mcs.namespace(f"x{i}"), ops[i].rotr(5 * i))
            x = UInt32.addmany(mcs.namespace(f"s{i}"), [x, ops[i - 1].shr(3)])


def _config3_py(cs):
    from bellpepper_tpu.gadgets.multieq import MultiEq
    from bellpepper_tpu.gadgets.multipack import pack_bits
    from bellpepper_tpu.gadgets.uint32 import UInt32

    words = [UInt32.alloc(cs.namespace(f"w{i}"), None) for i in range(4)]
    with MultiEq(cs) as mcs:
        acc = words[0]
        for i in range(1, 4):
            acc = UInt32.addmany(mcs.namespace(f"add {i}"), [acc, words[i]])
    pack_bits(cs.namespace("pack"), acc.into_bits())


BIT_GADGETS = {"config2": (_config2, (712, 712)), "config3": (_config3, (229, 229)),
               "blake2s": (_blake2s, (22158, 22113))}


def _finish(builder_cls, name):
    nb = builder_cls()
    BIT_GADGETS[name][0](nb)
    return nb.finish()


def _tuples(x):
    """Nested lists as tuples (the native decoder gives lists where TapeCS
    records tuples)."""
    return tuple(_tuples(v) for v in x) if isinstance(x, (list, tuple)) else x


def _assert_same_template(t, t_ref, by_value=False):
    """Equal R1CS arrays; coefficient ids equal, or (by_value) their
    values, as tests/test_native_synthesis.py compares."""
    assert (t.num_inputs, t.num_aux, t.num_constraints) == (t_ref.num_inputs, t_ref.num_aux, t_ref.num_constraints)
    if not by_value:
        assert t.coeff_table == t_ref.coeff_table
    for name in "abc":
        m, m_ref = getattr(t, name), getattr(t_ref, name)
        for f in ("rows", "cols") + (() if by_value else ("coeff_ids",)):
            assert (np.asarray(getattr(m, f)) == np.asarray(getattr(m_ref, f))).all(), (name, f)
        if by_value:
            got = [t.coeff_table[i] for i in np.asarray(m.coeff_ids)]
            assert got == [t_ref.coeff_table[i] for i in np.asarray(m_ref.coeff_ids)], name


def _assert_same_tape(tape, tape_ref):
    ni, na, ops, free = tape.snapshot()
    ni_r, na_r, ops_r, free_r = tape_ref.snapshot()
    assert (ni, na, list(free)) == (ni_r, na_r, list(free_r))
    assert len(ops) == len(ops_r)
    for op, op_r in zip(ops, ops_r):
        assert (op.opcode, list(op.outs), _tuples(op.args)) == (op_r.opcode, list(op_r.outs), _tuples(op_r.args))


@pytest.mark.parametrize("name", list(BIT_GADGETS))
def test_bit_gadget_templates_match_reference(name):
    (t, tape), (t_ref, tape_ref) = _finish(NativeBuilder, name), _finish(RefBuilder, name)
    assert (t.num_constraints, t.num_inputs + t.num_aux) == BIT_GADGETS[name][1]
    _assert_same_template(t, t_ref)
    _assert_same_tape(tape, tape_ref)


@pytest.mark.parametrize("name", ["config2", "config3"])
def test_bit_gadget_templates_match_python_circuits(name):
    """The reference's ShapeCS / TapeCS of the Python circuits in
    benchmarks/configs_1_2_3.py."""
    from bellpepper_tpu.compile.tape import TapeCS
    from bellpepper_tpu.r1cs import ShapeCS

    circuit = _config2_py if name == "config2" else _config3_py
    t, tape = _finish(NativeBuilder, name)
    shape, tape_py = ShapeCS(), TapeCS()
    circuit(shape)
    circuit(tape_py)
    _assert_same_template(t, shape.finish(), by_value=True)
    _assert_same_tape(tape, tape_py)


def test_view_decodes_like_reference():
    nb, rb = NativeBuilder(), RefBuilder()
    for b in (nb, rb):
        b.alloc_bit()
        x = b.alloc_bit()
        b.xor(x, b.not_(x))
    views = [nb.constant(False), nb.constant(True), 5, nb.not_(5), 9]
    assert [nb.view(v) for v in views] == [rb.view(v) for v in views]
    assert nb.view(nb.constant(True)) == (0, 1, 0) and nb.view(nb.not_(5))[0] == V_VAR


@pytest.mark.parametrize("name", ["config2", "blake2s"])
def test_stages_and_words_match_reference_bit_gadgets(name):
    t, tape = _finish(NativeBuilder, name)
    prog, ref = WitnessProgram(tape), RefProgram(tape)
    _assert_same_stages(prog, ref)
    assert prog.is_packable and len(prog.free_slots) == {"config2": 256, "blake2s": 768}[name]
    free = RNG.integers(0, 1 << 32, size=(2, len(prog.free_slots)), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(ref.build_packed()(jnp.asarray(free)))
    got = to_numpy_u32(prog.build_packed(device="cpu")(from_numpy_u32(free)))
    assert (got == want).all()


def _assert_same_stages(prog, ref):
    assert prog.num_slots == ref.num_slots
    assert list(prog.free_slots) == list(ref.free_slots)
    assert len(prog.stages) == len(ref.stages)
    for st, st_r in zip(prog.stages, ref.stages):
        assert st.opcode == st_r.opcode and st.meta == st_r.meta
        assert (st.outs == np.asarray(st_r.outs)).all()
        assert st.arrs.keys() == st_r.arrs.keys()
        for k, v in st.arrs.items():
            assert v.dtype == st_r.arrs[k].dtype, k
            assert (v == st_r.arrs[k]).all(), k


def test_stages_match_reference_sha256(sha_ref, sha_port):
    prog = WitnessProgram(sha_port[1])
    ref = RefProgram(sha_ref[1])
    _assert_same_stages(prog, ref)
    counts = {}
    for st in prog.stages:
        counts[st.opcode] = counts.get(st.opcode, 0) + 1
    assert counts == {"addmany": 155, "xor": 150, "and": 61, "ch": 61,
                      "maj": 61, "and_not": 1, "nor": 1}


@pytest.mark.parametrize("name", FIXTURES)
def test_stages_and_words_match_reference_fixtures(name, monkeypatch):
    _template, tape = fixture_tape(name, monkeypatch)
    ref = RefProgram(tape)
    prog = WitnessProgram(tape)  # the port compiles the reference's TapeCS tape
    _assert_same_stages(prog, ref)
    for B in (32, 512):
        free = RNG.integers(
            0, 1 << 32, size=(B // 32, len(prog.free_slots)), dtype=np.uint64
        ).astype(np.uint32)
        want = np.asarray(ref.build_packed()(jnp.asarray(free)))
        got = to_numpy_u32(prog.build_packed(device="cpu")(from_numpy_u32(free)))
        assert (got == want).all()


def test_packed_words_match_reference_sha256(sha_ref, sha_port):
    """B = 512 (16 words of 32 instances), random free bits; on CPU
    tensors the 155 addmany stages take the plain version, no launch."""
    from bellpepper_tpu_torch.backend import field_kernels as fk

    prog = WitnessProgram(sha_port[1])
    ref = RefProgram(sha_ref[1])
    free = RNG.integers(
        0, 1 << 32, size=(16, len(prog.free_slots)), dtype=np.uint64
    ).astype(np.uint32)
    want = np.asarray(ref.build_packed()(jnp.asarray(free)))
    fk.reset_launch_counts()
    got = to_numpy_u32(prog.build_packed(device="cpu")(from_numpy_u32(free)))
    assert got.shape == (16, 26327)
    assert (got == want).all()
    assert fk.launch_counts() == {k: 0 for k in fk.KERNELS}


def _python_sums(vals, arrs, n_out):
    """The sum planes of one addmany stage in numpy integers: each
    instance's addend words decoded from the stage's view arrays, added
    in uint64, bit k of the sum mod 2^n_out packed back into words ([W,
    n_out, Bw] uint32)."""
    k = np.arange(32, dtype=np.uint64)
    words = vals[arrs["idx"]].astype(np.uint64)  # [W, n, 32 positions, Bw]
    words ^= np.asarray(arrs["neg"], np.uint64)[..., None] * 0xFFFFFFFF
    words = np.where(arrs["isc"][..., None] != 0, np.asarray(arrs["cv"], np.uint64)[..., None] * 0xFFFFFFFF, words)
    lanes = (words[..., None] >> k) & 1  # [W, n, 32 positions, Bw, 32 instances]
    total = (lanes << k[None, None, :, None, None]).sum(axis=(1, 2)) % (1 << n_out)  # [W, Bw, 32]
    bits = (total[:, None] >> np.arange(n_out, dtype=np.uint64)[None, :, None, None]) & 1
    return (bits << k).sum(axis=-1).astype(np.uint32)


def _varied_views(arrs, rng):
    """A copy of a stage's view arrays with about a quarter of the
    variable views negated and a sixth made constant (0 or 1)."""
    a = {k: np.array(v) for k, v in arrs.items()}
    shape = a["idx"].shape
    a["neg"] = (a["neg"] ^ (rng.random(shape) < 0.25)).astype(np.uint32)
    to_const = rng.random(shape) < 1 / 6
    a["isc"] = (a["isc"] | to_const).astype(np.uint32)
    a["cv"] = np.where(to_const, rng.integers(0, 2, shape), a["cv"]).astype(np.uint32)
    a["neg"] = np.where(a["isc"] != 0, 0, a["neg"]).astype(np.uint32)
    return a


@pytest.mark.parametrize("name", ["sha256", "blake2s", "config2", "config3", "addmany", "families"])
def test_addmany_plain_matches_python_ints_and_the_eager_route(name, sha_port, monkeypatch):
    """One addmany stage of each (n_words, n_out) the template compiles
    to: ``field_kernels.addmany`` on CPU tensors (its plain version, no
    launch) writes every sum plane as Python-style integer sums give it,
    and equals the evaluator's route before the kernel (``_addmany`` over
    ``PackedEvaluator._views``, then a copy into the slots), on the
    stage's own views and on a copy with negated and constant views, for
    random words and for all-ones words (the longest carry chains)."""
    from bellpepper_tpu_torch.backend import field_kernels as fk

    tape = (sha_port if name == "sha256" else _finish(NativeBuilder, name) if name in BIT_GADGETS
            else fixture_tape(name, monkeypatch))[1]
    prog = WitnessProgram(tape)
    ev = (prog.build_packed if prog.is_packable else prog.build_packed_mixed)(device="cpu")
    rng = np.random.default_rng(0x5EED_0023)
    stages = {st.meta: st for st in prog.stages if st.opcode == "addmany"}
    assert stages
    before = fk.addmany.launches
    for (n_words, n_out), st in sorted(stages.items()):
        for arrs in (st.arrs, _varied_views(st.arrs, rng)):
            for fill in ("random", "ones"):
                vals = (rng.integers(0, 1 << 32, size=(prog.num_slots, 3), dtype=np.uint64).astype(np.uint32)
                        if fill == "random" else np.full((prog.num_slots, 3), 0xFFFFFFFF, np.uint32))
                want = vals.copy()
                want[st.outs] = _python_sums(vals, arrs, n_out)
                got = from_numpy_u32(vals)
                assert fk.addmany(got, fk.addmany_tables(arrs, st.outs, "cpu"), n_words, n_out) is got
                assert (to_numpy_u32(got) == want).all(), (n_words, n_out, fill)
                eager = from_numpy_u32(vals)
                bv = ev._views(eager, ev._view_tables(arrs, "", arrs["idx"].shape + (1,)))
                eager.index_copy_(0, torch.from_numpy(st.outs.reshape(-1).astype(np.int64)),
                                  fk._addmany(bv, n_out).reshape(-1, 3))
                assert torch.equal(eager, got), (n_words, n_out, fill)
    assert fk.addmany.launches == before


def test_num_iszero_words_match_reference():
    """num_iszero (a PACKED_OPS opcode no gadget emits without a field
    companion) on a hand-built tape: small-coefficient LCs over bit slots
    and over earlier is-zero outputs."""
    from bellpepper_tpu.fields import SCALAR

    n_free = 12
    free = list(range(1, 1 + n_free))
    ops = [
        RefOp("num_iszero", [13], [(1, 1), (1, 2)]),
        RefOp("num_iszero", [14], [(3, 3), (5, 4), (1, 5)]),
        RefOp("num_iszero", [15], [(7, 6), (9, 7)]),
        RefOp("xor", [16], [13, 8]),
        RefOp("num_iszero", [17], [(2, 16), (1, 9), (4, 10)]),
        RefOp("ch", [18], [(V_VAR, 17, 0), (V_VAR, 11, 1), (0, 1, 0)]),
    ]
    snap = (1, 18, ops, free)
    ref = RefProgram(SnapshotTape(SCALAR, snap))
    prog = WitnessProgram(SnapshotTape(SCALAR, snap))
    _assert_same_stages(prog, ref)
    words = RNG.integers(0, 1 << 32, size=(4, n_free), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(ref.build_packed()(jnp.asarray(words)))
    got = to_numpy_u32(prog.build_packed(device="cpu")(from_numpy_u32(words)))
    assert (got == want).all()


def test_field_opcodes_are_refused():
    """The packed evaluators refuse a program with field stages (they
    compile, and build() evaluates them); a `pack` stage is the one field
    opcode the mixed packed evaluator takes, and its words and limbs equal
    the reference's."""
    from bellpepper_tpu.fields import SCALAR

    snap = (1, 3, [RefOp("fmul", [3], [1, 2])], [1, 2])
    prog = WitnessProgram(SnapshotTape(SCALAR, snap))
    assert [st.opcode for st in prog.stages] == ["fmul"] and not prog.is_packable
    assert not prog.is_packable_mixed
    with pytest.raises(NotImplementedError):
        prog.build_packed(device="cpu")
    with pytest.raises(NotImplementedError):
        prog.build_packed_mixed(device="cpu")
    views = [(V_VAR, 1 + k, k % 3 == 0) for k in range(20)] + [(0, 1, 0), (V_VAR, 21, 0)]
    snap = (1, 22, [RefOp("xor", [21], [1, 2]), RefOp("pack", [22], views)], list(range(1, 21)))
    prog, ref = WitnessProgram(SnapshotTape(SCALAR, snap)), RefProgram(SnapshotTape(SCALAR, snap))
    assert (prog.is_packable, prog.is_packable_mixed) == (ref.is_packable, ref.is_packable_mixed) == (False, True)
    words = RNG.integers(0, 1 << 32, size=(3, 20), dtype=np.uint64).astype(np.uint32)
    want = ref.build_packed_mixed()(jnp.asarray(words))
    got = prog.build_packed_mixed(device="cpu")(from_numpy_u32(words))
    for g, w in zip(got, want):
        assert (to_numpy_u32(g) == np.asarray(w)).all()


def test_evaluator_rejects_wrong_input(sha_port):
    ev = WitnessProgram(sha_port[1]).build_packed(device="cpu")
    with pytest.raises(ValueError):
        ev(torch.zeros((2, 511), dtype=torch.int32))
    with pytest.raises(ValueError):
        ev(torch.zeros((2, 512), dtype=torch.int64))
