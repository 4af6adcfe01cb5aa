"""The port's field path (config 1, AllocatedNum mul/add) against the JAX
package: the native builder's field gadgets (templates and tapes), the
stage compile, _detect_linear_chain and _classify_mixed_rows, the
evaluator's (vals, flimbs) against WitnessProgram.build(False), the mixed
check's mask and verdict against _build_mixed_check(..., use_pallas=False)
clean and corrupted in every row class, and the production step's verdict
against the JAX step. Config 1 is pack → (mul, add, square) × 30; the
variant adds num_assert_nonzero at the end. All comparisons are exact.

The guard fixtures hold the port's pow2 magnitude check: rows the
reference routes elsewhere classify the same and get its verdicts through
the limbs form, and a row whose C side can pass p·2^34 (where the
reference's borrow-free subtraction wraps) raises."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu.backend import matvec as ref_mv
from bellpepper_tpu.compile.pipeline import build_production_step as ref_step
from bellpepper_tpu.compile.tape import Op as RefOp, TapeCS
from bellpepper_tpu.compile.witness_program import SCAN_OPS
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.compile.witness_program import _detect_linear_chain as ref_detect
from bellpepper_tpu.constraint_system import ConstraintSystem
from bellpepper_tpu.fields import SCALAR
from bellpepper_tpu.gadgets.boolean import AllocatedBit, Boolean
from bellpepper_tpu.gadgets.boolean_utils import alloc_num_is_zero
from bellpepper_tpu.gadgets.lookup import lookup3_xy
from bellpepper_tpu.gadgets.multieq import MultiEq
from bellpepper_tpu.gadgets.multipack import pack_bits
from bellpepper_tpu.gadgets.num import AllocatedNum, Num
from bellpepper_tpu.gadgets.uint32 import UInt32
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu_torch import (
    COOMatrix,
    NativeBuilder,
    R1CS,
    WitnessProgram,
    build_chunked_witness,
    build_production_step,
    build_templated_check,
)
from bellpepper_tpu_torch.backend import layout
from bellpepper_tpu_torch.backend.matvec import ROW_CLASSES
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.compile.witness_program import _detect_linear_chain

RNG = np.random.default_rng(0x5EED_0008)
P = SCALAR.p
B = 128
VARIANTS = ["config1", "nonzero"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs these files beside other
    workers, and torch's default of a thread a core oversubscribes the CPU
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config1(builder_cls, nonzero=False):
    nb = builder_cls()
    bits = [nb.alloc_bit() for _ in range(128)]
    a = nb.pack_bits(bits[:64])
    b = nb.pack_bits(bits[64:])
    x = a
    for _ in range(30):
        x = nb.num_mul(x, b)
        x = nb.num_add(x, a)
        x = nb.num_square(x)
    if nonzero:
        nb.num_assert_nonzero(x)
    return nb.finish()


@functools.lru_cache(maxsize=None)
def _built(name):
    nz = name == "nonzero"
    t, tape = _config1(NativeBuilder, nz)
    tr, tape_r = _config1(RefBuilder, nz)
    prog, ref = WitnessProgram(tape), RefProgram(tape_r)
    fs = prog.field_slots
    assert fs == sorted(ref.field_rows, key=ref.field_rows.get) + list(ref.free_field_slots)
    return name, (t, tape, prog), (tr, tape_r, ref), fs


@pytest.fixture(params=VARIANTS)
def built(request):
    return _built(request.param)


def _free(n_free, *lead):
    return RNG.integers(0, 2, size=lead + (n_free,)).astype(np.uint32)


def _i32(a):
    return from_numpy_u32(a)


def test_native_field_templates_match_reference(built):
    name, (t, tape, prog), (tr, tape_r, _ref), _fs = built
    assert (t.num_constraints, prog.num_slots) == ((220, 221) if name == "config1" else (221, 222))
    assert (t.num_inputs, t.num_aux) == (tr.num_inputs, tr.num_aux)
    assert t.coeff_table == tr.coeff_table
    for m in "abc":
        for f in ("rows", "cols", "coeff_ids"):
            assert (getattr(getattr(t, m), f) == getattr(getattr(tr, m), f)).all()
    ni, na, ops, free = tape.snapshot()
    assert (ni, na, free) == tape_r.snapshot()[:2] + (tape_r.snapshot()[3],)
    assert [(o.opcode, o.outs, o.args) for o in ops] == [
        (o.opcode, o.outs, o.args) for o in tape_r.snapshot()[2]
    ]


def test_stages_chain_and_classes_match_reference(built):
    name, (t, _tape, prog), (tr, _tr, ref), fs = built
    assert prog.field_rows == ref.field_rows and prog.free_field_slots == ref.free_field_slots
    assert prog.n_field_rows == ref.n_field_rows and not prog.is_pure_bits
    assert len(prog.stages) == len(ref.stages)
    for st, sr in zip(prog.stages, ref.stages):
        assert st.opcode == sr.opcode and st.meta == sr.meta and (st.outs == sr.outs).all()
        assert st.arrs.keys() == sr.arrs.keys()
        for k, v in st.arrs.items():
            assert v.dtype == sr.arrs[k].dtype and (v == sr.arrs[k]).all(), k
    run = [st for st in prog.stages if st.opcode in SCAN_OPS]
    spec, rspec = _detect_linear_chain(run), ref_detect([st for st in ref.stages if st.opcode in SCAN_OPS])
    if name == "config1":
        assert [st.opcode for st in prog.stages[:1]] == ["pack"] and len(run) == 90
        assert spec["descs"] == rspec["descs"] == (("fmul", "prev", 0), ("fadd", "prev", 1),
                                                    ("fmul", "prev", "prev"))
        for k in ("init_row", "ext_rows", "n_reps"):
            assert spec[k] == rspec[k]
        assert (spec["out_rows"] == rspec["out_rows"]).all()
        assert (spec["out_slots"] == rspec["out_slots"]).all()
        assert spec["n_reps"] == 30 and len(spec["ext_rows"]) == 2
    else:
        assert len(run) == 91 and spec is None and rspec is None
    cls = layout._classify_mixed_rows(t, fs)
    assert cls == ref_mv._classify_mixed_rows(tr, fs)
    want = (128, 30, 60 if name == "config1" else 61, 2, 0)
    assert tuple(len(cls[k]) for k in ("bool_u32", "lin", "mul", "pow2", "rest")) == want


def test_evaluator_matches_reference(built):
    _name, (_t, _tape, prog), (_tr, _tape_r, ref), _fs = built
    free = _free(len(prog.free_slots), B)
    vals, flimbs = prog.build(device="cpu")(_i32(free))
    rv, rf = ref.build(False)(jnp.asarray(free), jnp.zeros((B, 1, 16), jnp.uint32))
    assert vals.shape == (B, prog.num_slots) and flimbs.shape == (B, prog.n_field_rows, 16)
    assert (to_numpy_u32(vals) == np.asarray(rv)).all()
    assert (to_numpy_u32(flimbs) == np.asarray(rf)).all()
    if _name == "config1":
        gen = build_chunked_witness(prog, device="cpu")
        free2 = np.stack([free, _free(len(prog.free_slots), B)])
        assert torch.equal(gen(_i32(free2))[0], vals)


COORDS = [(random.Random(9).randrange(P), random.Random(10 + i).randrange(P)) for i in range(8)]


def _all_ops_circuit(cs):
    """Every opcode the evaluator runs: select, lookup, fbits_le,
    num_iszero, num_inv_or_one, copy, finv, fmul/fadd on a free field
    input, and the unpacked bit ops xor, and, and_not, nor, ch, maj,
    addmany."""
    bs = [Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"b{i}"), None)) for i in range(40)]
    a = pack_bits(cs.namespace("pa"), bs[:16])
    b = pack_bits(cs.namespace("pb"), bs[16:32])
    c, d = AllocatedNum.conditionally_reverse(cs.namespace("rev"), a, b, bs[32])
    free = AllocatedNum.alloc(cs.namespace("free"), None)
    e = c.mul(cs.namespace("m"), free).add(cs.namespace("ad"), d)
    e.assert_nonzero(cs.namespace("nz"))
    e.to_bits_le(cs.namespace("bits"))
    lookup3_xy(cs.namespace("lk"), bs[33:36], COORDS)
    one = ConstraintSystem.one()
    num = Num.zero(SCALAR).add_bool_with_coeff(one, bs[36], 1).add_bool_with_coeff(one, bs[37], 2)
    alloc_num_is_zero(cs.namespace("iz"), num)
    x = Boolean.xor(cs.namespace("x"), bs[0], bs[1])
    y = Boolean.and_(cs.namespace("y"), x, bs[2].not_())
    z = Boolean.and_(cs.namespace("z"), bs[3].not_(), bs[4].not_())
    Boolean.sha256_ch(cs.namespace("ch"), x, y, z)
    Boolean.sha256_maj(cs.namespace("maj"), bs[5], y, z)
    with MultiEq(cs) as mcs:
        UInt32.addmany(mcs.namespace("add"), [UInt32.from_bits(bs[:32]), UInt32.from_bits(bs[8:40])])
    d.inputize(cs.namespace("in"))


def test_evaluator_all_opcodes_match_reference():
    tape = TapeCS()
    _all_ops_circuit(tape)
    prog, ref = WitnessProgram(tape), RefProgram(tape)
    ops = {st.opcode for st in prog.stages}
    assert ops >= {"select", "lookup", "fbits_le", "num_iszero", "num_inv_or_one", "copy",
                   "finv", "fmul", "fadd", "pack", "xor", "and", "and_not", "nor", "ch", "maj",
                   "addmany"}, ops
    assert len(prog.free_field_slots) == 1
    n = 64
    free = _free(len(prog.free_slots), n)
    ff = np.zeros((n, 1, 16), np.uint32)
    ff[:, 0] = [[(v >> (16 * l)) & 0xFFFF for l in range(16)]
                for v in [random.Random(k).randrange(P) for k in range(n)]]
    vals, flimbs = prog.build(device="cpu")(_i32(free), _i32(ff))
    rv, rf = ref.build(False)(jnp.asarray(free), jnp.asarray(ff))
    assert (to_numpy_u32(vals) == np.asarray(rv)).all()
    assert (to_numpy_u32(flimbs) == np.asarray(rf)).all()
    with pytest.raises(ValueError):  # the free field input is required
        prog.build(device="cpu")(_i32(free))


def _corruptions(prog, t, fs, vals, flimbs):
    """One corrupted (vals, flimbs) per row class: a bit slot set to 2
    (booleanity and pow2), a bit flipped (pow2 only), an fadd output (lin),
    an fmul output (mul), a pack output (pow2), each at a random instance;
    field values stay canonical and their u32 words consistent."""
    stage = {st.opcode: st for st in reversed(prog.stages)}
    out = []

    def field_row(row, value):
        v, f = vals.copy(), flimbs.copy()
        b = int(RNG.integers(0, B))
        f[b, row] = [(value >> (16 * l)) & 0xFFFF for l in range(16)]
        v[b, fs[row]] = f[b, row, 0] | (f[b, row, 1] << 16)
        return v, f

    for big in (2, 0xFFFFFFFF):
        v = vals.copy()
        v[int(RNG.integers(0, B)), prog.free_slots[3]] = big
        out.append((v, flimbs))
    v = vals.copy()
    v[5, prog.free_slots[70]] ^= 1
    out.append((v, flimbs))
    for oc in ("fadd", "fmul", "pack"):
        out.append(field_row(int(stage[oc].outs[0]), random.Random(oc).randrange(P)))
    return out


def test_mixed_check_matches_reference(built):
    _name, (t, _tape, prog), (tr, _tr, _ref), fs = built
    free = _free(len(prog.free_slots), B)
    vals, flimbs = (to_numpy_u32(x) for x in prog.build(device="cpu")(_i32(free)))
    port = build_templated_check(t, B, None, "mixed", field_slots=fs, device="cpu")
    ref = jax.jit(ref_mv.build_templated_check(tr, B, False, "mixed", field_slots=fs))
    R = t.num_constraints
    for k, (v, f) in enumerate([(vals, flimbs)] + _corruptions(prog, t, fs, vals, flimbs)):
        mask = port(_i32(v), _i32(f)).numpy()
        want = np.asarray(ref(jnp.asarray(v), jnp.asarray(f)))
        assert (mask == want).all(), k
        vp, fp = _i32(v).t().contiguous(), _i32(f).permute(1, 2, 0).contiguous()
        for c, rows in zip(ROW_CLASSES, port.rows):  # the per-class hook, row by row
            if rows.numel():
                assert (port.class_bad(c, vp, fp).t().numpy() == mask.reshape(B, R)[:, rows.numpy()]).all()
        nb, first = (int(x) for x in port.verdict(_i32(v), _i32(f)))
        assert nb == int(want.sum()) and (nb > 0) == (k > 0)
        assert first == (int(np.argmax(want)) if nb else 0xFFFFFFFF)
        if nb:
            assert first // R < B
    with pytest.raises(ValueError):
        port(_i32(vals[:, :-1].copy()), _i32(flimbs))


def _corrupted(tape):
    """The tape with its last fadd computing a product instead."""
    ni, na, ops, free = tape.snapshot()
    i = max(k for k, op in enumerate(ops) if op.opcode == "fadd")
    ops = list(ops)
    ops[i] = RefOp("fmul", ops[i].outs, ops[i].args)

    class _Tape:
        field = tape.field

        def snapshot(self):
            return ni, na, ops, free

    return _Tape()


@pytest.mark.parametrize(
    "name,corrupt", [("config1", False), ("config1", True), ("nonzero", False)],
    ids=["config1-clean", "config1-corrupted", "nonzero-clean"],
)
def test_production_step_matches_reference(name, corrupt):
    _name, (t, tape, _prog), (tr, tape_r, _ref), _fs = _built(name)
    if corrupt:
        tape, tape_r = _corrupted(tape), _corrupted(tape_r)
    prog, ref = WitnessProgram(tape), RefProgram(tape_r)
    free = _free(len(prog.free_slots), 2, B)
    got = tuple(int(v) for v in build_production_step(prog, t, B, device="cpu")(_i32(free)))
    want = tuple(int(v) for v in ref_step(ref, tr, B, use_pallas=False)(jnp.asarray(free)))
    assert got == want
    assert (got[0] > 0) == corrupt
    if not corrupt:
        assert got == (0, 0xFFFFFFFF)


def test_production_step_refuses_pure_bit_programs_and_bad_shapes(built):
    """A pure-bit program is refused in an explicit mixed form; by default
    it takes the bits form, whose verdict equals the reference's."""
    _name, (t, _tape, prog), _ref, _fs = built
    nb = RefBuilder()
    words = [nb.alloc_u32() for _ in range(3)]
    nb.multieq_begin()
    x = nb.addmany(words)
    nb.multieq_end()
    [nb.xor(a, b) for a, b in zip(x, words[0])]
    st, stape = nb.finish()
    sprog = WitnessProgram(stape)
    with pytest.raises(NotImplementedError):
        build_production_step(sprog, st, 64, device="cpu", witness_form="mixed")
    free = _free(len(sprog.free_slots), 1, 64)
    got = tuple(int(v) for v in build_production_step(sprog, st, 64, device="cpu")(_i32(free)))
    want = tuple(int(v) for v in ref_step(RefProgram(stape), st, 64, use_pallas=False)(jnp.asarray(free)))
    assert got == want == (0, 0xFFFFFFFF)
    step = build_production_step(prog, t, 64, device="cpu")
    with pytest.raises(ValueError):
        step(torch.zeros((1, 32, 128), dtype=torch.int32))


# --- the pow2 guard ------------------------------------------------------------
def _template(rows):
    """A one-ONE-input template from rows of {matrix: [(col, coeff)]};
    slots 1..n_u are u32 slots, the last slot is the field slot."""
    n_slots = 1 + max(c for row in rows for m in row.values() for c, _ in m)
    table, mats = [], {m: ([], [], []) for m in "abc"}
    for r, row in enumerate(rows):
        for m, terms in row.items():
            for col, cf in terms:
                if cf % P not in table:
                    table.append(cf % P)
                mats[m][0].append(r)
                mats[m][1].append(col)
                mats[m][2].append(table.index(cf % P))
    coo = {m: COOMatrix(*(np.asarray(x, np.int32) for x in mats[m])) for m in "abc"}
    return R1CS(SCALAR, 1, n_slots - 1, len(rows), coo["a"], coo["b"], coo["c"], table), n_slots - 1


def _guard_case(kind):
    if kind == "sound":  # A = Σ_{i<40} 2^i·u_i + 2^200·u_40, C = f
        a = [(1 + i, 1 << i) for i in range(40)] + [(41, 1 << 200)]
        c = [(42, 1)]
    elif kind == "window_count":  # 65 u32 terms at exponent 0: one window
        a = [(1 + i, 1) for i in range(65)]
        c = [(66, 1)]
    elif kind == "field_coefficient":  # C = 2·f
        a = [(1 + i, 1 << i) for i in range(8)]
        c = [(9, 2)]
    else:  # "magnitude": C = Σ_{k<8} 2^254·u_k can pass p·2^34
        a = [(9, 1)]
        c = [(1 + k, 1 << 254) for k in range(8)]
    return _template([{"a": a, "b": [(0, 1)], "c": c}])


@pytest.mark.parametrize("kind", ["window_count", "field_coefficient"])
def test_pow2_guard_rows_the_reference_routes_elsewhere(kind):
    """Both classifiers send the row to `rest`; the port checks it through
    the limbs form and gives the reference's mask and verdict on large u32
    values, satisfying at even instances and violating at odd ones."""
    t, f = _guard_case(kind)
    cls = layout._classify_mixed_rows(t, [f])
    assert cls == ref_mv._classify_mixed_rows(t, [f]) and cls["rest"] == [0]
    n = 8
    vals = RNG.integers(0, 1 << 32, size=(n, f + 1), dtype=np.uint64).astype(np.uint32)
    vals[:, 0] = 1
    (c_cid,) = t.c.coeff_ids
    c_inv = pow(t.coeff_table[c_cid], -1, P)
    fvals = []
    for b in range(n):
        a = sum(t.coeff_table[cid] * int(vals[b, col]) for col, cid in zip(t.a.cols, t.a.coeff_ids))
        fvals.append((a * c_inv + b % 2) % P)  # C·z = A·z, plus one at odd instances
    fl = np.asarray([[(v >> (16 * l)) & 0xFFFF for l in range(16)] for v in fvals], np.uint32)[:, None, :]
    vals[:, f] = fl[:, 0, 0] | (fl[:, 0, 1] << 16)
    port = build_templated_check(t, n, None, "mixed", field_slots=[f], device="cpu")
    ref = jax.jit(ref_mv.build_templated_check(t, n, False, "mixed", field_slots=[f]))
    mask = port(_i32(vals), _i32(fl)).numpy()
    want = np.asarray(ref(jnp.asarray(vals), jnp.asarray(fl)))
    assert (mask == want).all() and mask.tolist() == [b % 2 == 1 for b in range(n)]
    assert tuple(int(v) for v in port.verdict(_i32(vals), _i32(fl))) == (n // 2, 1)


def test_rest_rows_without_field_slots():
    """A rest row over u32 slots only (no field slots at all): the port
    lifts every used slot to limbs and gives the mask of the reference's
    limbs check on those limbs, true at odd instances (the reference's
    mixed check cannot gather from an empty flimbs)."""
    t, f = _guard_case("window_count")
    assert layout._classify_mixed_rows(t, []) == ref_mv._classify_mixed_rows(t, [])
    assert layout._classify_mixed_rows(t, [])["rest"] == [0]
    n = 8
    vals = RNG.integers(0, 1 << 24, size=(n, f + 1), dtype=np.uint64).astype(np.uint32)
    vals[:, 0] = 1
    vals[:, f] = vals[:, 1:f].sum(axis=1, dtype=np.uint64) + np.arange(n) % 2
    fl = np.zeros((n, 0, 16), np.uint32)
    port = build_templated_check(t, n, None, "mixed", field_slots=[], device="cpu")
    ref = jax.jit(ref_mv.build_templated_check(t, n, False, "limbs"))
    z3 = np.zeros((n, f + 1, 16), np.uint32)
    z3[:, :, 0], z3[:, :, 1] = vals & 0xFFFF, vals >> 16
    mask = port(_i32(vals), _i32(fl)).numpy()
    want = np.asarray(ref(jnp.asarray(z3)))
    assert (mask == want).all() and mask.tolist() == [b % 2 == 1 for b in range(n)]


def test_pow2_guard_refuses_an_unsound_row():
    """The reference accepts the row as pow2, and on a witness that
    satisfies it (Σ 2^254·u_k ≡ f mod p, with every u_k = 2^32 − 1) its
    borrow-free subtraction wraps and the check reports a violation; the
    port refuses the row."""
    t, f = _guard_case("magnitude")
    cls = ref_mv._classify_mixed_rows(t, [f])
    assert [r for r, *_ in cls["pow2"]] == [0]
    with pytest.raises(ValueError):
        layout._classify_mixed_rows(t, [f])
    with pytest.raises(ValueError):
        build_templated_check(t, 4, None, "mixed", field_slots=[f], device="cpu")
    vals = np.zeros((4, t.num_inputs + t.num_aux), np.uint32)
    vals[:, 0] = 1
    vals[:, 1:9] = 0xFFFFFFFF
    fv = (8 * 0xFFFFFFFF << 254) % P
    fl = np.zeros((4, 1, 16), np.uint32)
    fl[:, 0] = [(fv >> (16 * l)) & 0xFFFF for l in range(16)]
    vals[:, f] = fl[:, 0, 0] | (fl[:, 0, 1] << 16)
    ref = jax.jit(ref_mv.build_templated_check(t, 4, False, "mixed", field_slots=[f]))
    assert np.asarray(ref(jnp.asarray(vals), jnp.asarray(fl))).all()


def test_pow2_guard_keeps_sound_rows_exact():
    """A pow2 row inside the bounds, with large u32 values: the port's
    mask equals the reference's and the host's integer verdict."""
    t, f = _guard_case("sound")
    cls = layout._classify_mixed_rows(t, [f])
    assert cls == ref_mv._classify_mixed_rows(t, [f]) and len(cls["pow2"]) == 1
    n = 64
    vals = RNG.integers(0, 1 << 32, size=(n, f + 1), dtype=np.uint64).astype(np.uint32)
    vals[:, 0] = 1
    sums = [sum(int(vals[b, 1 + i]) << i for i in range(40)) + (int(vals[b, 41]) << 200)
            for b in range(n)]
    fvals = [s % P if b % 2 else random.Random(b).randrange(P) for b, s in enumerate(sums)]
    fl = np.asarray([[(v >> (16 * l)) & 0xFFFF for l in range(16)] for v in fvals],
                    np.uint32)[:, None, :]
    vals[:, f] = fl[:, 0, 0] | (fl[:, 0, 1] << 16)
    mask = build_templated_check(t, n, None, "mixed", field_slots=[f], device="cpu")(_i32(vals), _i32(fl))
    ref = jax.jit(ref_mv.build_templated_check(t, n, False, "mixed", field_slots=[f]))
    assert (mask.numpy() == np.asarray(ref(jnp.asarray(vals), jnp.asarray(fl)))).all()
    assert mask.tolist() == [(s - v) % P != 0 for s, v in zip(sums, fvals)]
