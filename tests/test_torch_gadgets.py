"""The port's gadgets against the JAX package's: each circuit is built once
a package from the same seeded values (``random.Random``) into that
package's ``TestConstraintSystem``, and the two systems are compared:
``num_constraints``, ``hash()``, ``is_satisfied``, the input and aux
assignments and names, and the circuit's output values, with the pinned
counts of the hash circuits (25,840, 44,874, 21,518) and their digests
against hashlib. The small circuits are also recorded without values into
each package's ``ShapeCS`` and ``TapeCS``, and their arrays and tapes
compared. The hash circuits are synthesized once a package a module, and
their cases share them."""

import functools
import hashlib
import importlib
import random
from types import SimpleNamespace

import pytest

REF, PORT = "bellpepper_tpu", "bellpepper_tpu_torch"
PERSON = b"12345678"
GADGETS = ("boolean", "boolean_utils", "num", "uint32", "multieq", "multipack", "lookup", "sha256", "blake2s")


@functools.lru_cache(maxsize=None)
def pkg(root: str) -> SimpleNamespace:
    mods = {g: importlib.import_module(f"{root}.gadgets.{g}") for g in GADGETS}
    return SimpleNamespace(top=importlib.import_module(root), r1cs=importlib.import_module(f"{root}.r1cs"),
                           tape=importlib.import_module(f"{root}.compile.tape"), **mods)


def bits_of(m, cs, values, label="bit"):
    B = m.boolean
    return [B.Boolean.from_bit(B.AllocatedBit.alloc(cs.namespace(f"{label} {i}"), v))
            for i, v in enumerate(values)]


def values_of(xs):
    return [None if x is None else (x.get_value() if hasattr(x, "get_value") else x.value) for x in xs]


# -- circuits: (m, cs, val) → output values; val(x) is x with values, else None

def boolean_ops(m, cs, val):
    rnd = random.Random(1)
    B, AB = m.boolean.Boolean, m.boolean.AllocatedBit
    raw = [rnd.random() < 0.5 for _ in range(8)]
    ab = [AB.alloc(cs.namespace(f"a{i}"), val(v)) for i, v in enumerate(raw)]
    outs = [AB.xor(cs.namespace("xor"), ab[0], ab[1]), AB.and_(cs.namespace("and"), ab[1], ab[2]),
            AB.and_not(cs.namespace("and_not"), ab[2], ab[3]), AB.nor(cs.namespace("nor"), ab[3], ab[4])]
    outs.append(AB.alloc_conditionally(cs.namespace("cond"), val(raw[5]), ab[6]))
    bs = [B.from_bit(b) for b in ab] + [B.constant(True), B.constant(False)]
    ops = [bs[0], bs[1].not_(), bs[8], bs[9].not_(), bs[2], bs[3]]
    k = 0
    for x in ops:
        for y in ops:
            outs += [B.xor(cs.namespace(f"bx{k}"), x, y), B.and_(cs.namespace(f"ba{k}"), x, y),
                     B.or_(cs.namespace(f"bo{k}"), x, y)]
            k += 1
    outs += [B.sha256_ch(cs.namespace("ch"), bs[0], bs[1].not_(), bs[2]),
             B.sha256_maj(cs.namespace("maj"), bs[3], bs[4], bs[8]),
             B.sha256_ch(cs.namespace("ch const"), bs[8], bs[5], bs[6]),
             B.sha256_maj(cs.namespace("maj const"), bs[9], bs[8].not_(), bs[7])]
    B.enforce_equal(cs.namespace("eq"), bs[0], bs[0].clone())
    outs += m.boolean.u64_into_boolean_vec_le(cs.namespace("u64"), val(rnd.getrandbits(64)))
    outs += m.boolean.field_into_boolean_vec_le(cs.namespace("field"), val(rnd.randrange(m.top.SCALAR.p)))
    return values_of(outs)


def u32_ops(m, cs, val):
    rnd = random.Random(2)
    U = m.uint32.UInt32
    ws = [U.alloc(cs.namespace(f"w{i}"), val(rnd.getrandbits(32))) for i in range(6)]
    outs = [ws[0].xor(cs.namespace("xor"), ws[1].rotr(7)), U.sha256_maj(cs.namespace("maj"), ws[2], ws[3], ws[4]),
            U.sha256_ch(cs.namespace("ch"), ws[3], ws[4], ws[5]), ws[5].shr(9), U.constant(0xDEADBEEF)]
    with m.multieq.MultiEq(cs.namespace("multieq")) as mcs:
        outs.append(U.addmany(mcs.namespace("add"), [ws[0], ws[1].rotr(3), ws[2], U.constant(12345)]))
        outs.append(U.addmany(mcs.namespace("add2"), [outs[-1], ws[4].shr(2)]))
    outs.append(U.from_bits_be(ws[0].into_bits_be()).xor(cs.namespace("xor2"), U.from_bits(ws[1].into_bits())))
    return values_of(outs)


def num_ops(m, cs, val):
    rnd = random.Random(3)
    p = m.top.SCALAR.p
    N, AN = m.num.Num, m.num.AllocatedNum
    xs = [AN.alloc(cs.namespace(f"x{i}"), val(rnd.randrange(p))) for i in range(3)]
    y = AN.alloc_input(cs.namespace("y"), val(rnd.randrange(p)))
    outs = [xs[0].add(cs.namespace("add"), xs[1]), xs[1].mul(cs.namespace("mul"), xs[2]),
            xs[2].square(cs.namespace("sq")), y.mul(cs.namespace("ymul"), xs[0])]
    xs[0].assert_nonzero(cs.namespace("nonzero"))
    outs[0].inputize(cs.namespace("inputize"))
    cond = bits_of(m, cs, [val(rnd.random() < 0.5)], "cond")[0]
    outs += list(AN.conditionally_reverse(cs.namespace("rev"), xs[0], xs[1], cond))
    bits = xs[1].to_bits_le_strict(cs.namespace("strict")) + xs[2].to_bits_le(cs.namespace("bits"))
    num = N.from_allocated_num(m.top.SCALAR, xs[0]).add(N.zero(m.top.SCALAR)).scale(5)
    num = num.add_bool_with_coeff(m.top.ConstraintSystem.one(), cond, 7)
    small = AN.alloc(cs.namespace("zero"), val(0))
    iz = [m.boolean_utils.alloc_num_is_zero(cs.namespace("is zero"), num),
          m.boolean_utils.alloc_num_is_zero(cs.namespace("is zero 0"), N.from_allocated_num(m.top.SCALAR, small))]
    return values_of(outs + bits + iz) + [num.get_value()]


def boolean_utils_ops(m, cs, val):
    rnd = random.Random(4)
    bu = m.boolean_utils
    bs = bits_of(m, cs, [val(rnd.random() < 0.5) for _ in range(12)])
    zeros = bits_of(m, cs, [val(False)] * 5, "zero")
    outs = [bu.or_v(cs.namespace("or_v"), bs[:6]), bu.or_v(cs.namespace("or_v 0"), zeros),
            bu.or_v_unchecked_for_optimization(cs.namespace("or_v_u"), bs[6:]),
            bu.and_v(cs.namespace("and_v"), bs[:5]), bu.and_v(cs.namespace("and_v 1"), bs[5:9] + [bs[5].not_()]),
            bu.or_(cs.namespace("or"), bs[0], bs[1], bs[2]), bu.and_(cs.namespace("and"), bs[3], bs[4], label="l")]
    return values_of(outs)


def multipack_ops(m, cs, val):
    rnd = random.Random(5)
    mp = m.multipack
    raw = [rnd.random() < 0.5 for _ in range(600)]
    bs = bits_of(m, cs, [val(v) for v in raw])
    mp.pack_into_inputs(cs.namespace("pack"), bs)
    packed = mp.pack_bits(cs.namespace("pack bits"), bs[:300])
    data = bytes(rnd.randrange(256) for _ in range(9))
    return [packed.get_value(), mp.compute_multipacking(m.top.SCALAR, raw), mp.bytes_to_bits(data),
            mp.bytes_to_bits_le(data)]


def lookup_ops(m, cs, val):
    rnd = random.Random(6)
    p = m.top.SCALAR.p
    lk = m.lookup
    coords = [(rnd.randrange(p), rnd.randrange(p)) for _ in range(8)]
    outs = []
    for k in range(4):
        bs = bits_of(m, cs, [val(rnd.random() < 0.5) for _ in range(3)], f"w{k}")
        x, y = lk.lookup3_xy(cs.namespace(f"xy{k}"), bs, coords)
        xn, yn = lk.lookup3_xy_with_conditional_negation(cs.namespace(f"neg{k}"), bs, coords[:4])
        outs += [x.get_value(), y.get_value(), xn.get_value(), yn.get_value()]
    assignment = [0] * 8
    lk.synth(m.top.SCALAR, 3, [c[0] for c in coords], assignment)
    return outs + [assignment]


SMALL = [boolean_ops, u32_ops, num_ops, boolean_utils_ops, multipack_ops, lookup_ops]


def sha256_compression(m, cs, val):
    rnd = random.Random(7)
    bs = bits_of(m, cs, [val(rnd.random() < 0.5) for _ in range(512)], "input bit")
    out = m.sha256.sha256_compression_function(cs.namespace("sha256"), bs, m.sha256.get_sha256_iv())
    return [w.value for w in out]


def sha256_full(m, cs, val):
    data = bytes(random.Random(8).randrange(256) for _ in range(64))
    bs = bits_of(m, cs, [val(bool((byte >> (7 - j)) & 1)) for byte in data for j in range(8)], "input bit")
    return values_of(m.sha256.sha256(cs.namespace("sha256"), bs)), hashlib.sha256(data).digest()


def blake2s_full(m, cs, val):
    data = bytes(random.Random(9).randrange(256) for _ in range(64))
    bs = bits_of(m, cs, [val(bool((byte >> j) & 1)) for byte in data for j in range(8)], "input bit")
    return values_of(m.blake2s.blake2s(cs.namespace("blake2s"), bs, PERSON)), \
        hashlib.blake2s(data, person=PERSON).digest()


# the hash circuits' pinned counts (tests/test_sha256.py, tests/test_blake2s.py)
PINNED = {sha256_compression: 512 + 25840, sha256_full: 512 + 44874, blake2s_full: 21518}


@functools.lru_cache(maxsize=None)
def synthesized(circuit, root):
    """(TestConstraintSystem, outputs) of one circuit in one package."""
    m = pkg(root)
    cs = m.top.TestConstraintSystem()
    return cs, circuit(m, cs, lambda x: x)


def observe(cs):
    return {"num_constraints": cs.num_constraints(), "hash": cs.hash(), "is_satisfied": cs.is_satisfied(),
            "inputs": cs.scalar_inputs(), "aux": cs.scalar_aux(), "input names": cs.inputs(),
            "aux names": cs.aux(), "unsatisfied": cs.which_is_unsatisfied()}


def bytes_be(bits):
    return bytes(sum(int(bits[8 * i + j]) << (7 - j) for j in range(8)) for i in range(len(bits) // 8))


def bytes_le(bits):
    return bytes(sum(int(bits[8 * i + j]) << j for j in range(8)) for i in range(len(bits) // 8))


@pytest.mark.parametrize("circuit", SMALL + list(PINNED), ids=lambda c: c.__name__)
def test_gadget_system_matches_reference(circuit):
    (cs_r, out_r), (cs_p, out_p) = synthesized(circuit, REF), synthesized(circuit, PORT)
    want, got = observe(cs_r), observe(cs_p)
    assert got == want
    assert got["is_satisfied"] and got["unsatisfied"] is None
    assert out_p == out_r
    if circuit in PINNED:
        assert got["num_constraints"] == PINNED[circuit]
    if circuit is sha256_full:
        assert bytes_be(out_p[0]) == out_p[1]
    if circuit is blake2s_full:
        assert bytes_le(out_p[0]) == out_p[1]


@pytest.mark.parametrize("circuit", SMALL, ids=lambda c: c.__name__)
def test_gadget_shape_and_tape_match_reference(circuit):
    """The circuit recorded without values: ShapeCS arrays and coefficient
    table, and the TapeCS snapshot op for op."""
    def record(root):
        m = pkg(root)
        shape, tape = m.r1cs.ShapeCS(), m.tape.TapeCS()
        circuit(m, shape, lambda x: None)
        circuit(m, tape, lambda x: None)
        r = shape.finish()
        ni, na, ops, free = tape.snapshot()
        return ((r.num_inputs, r.num_aux, r.num_constraints, r.coeff_table,
                 [(getattr(r, k).rows.tolist(), getattr(r, k).cols.tolist(), getattr(r, k).coeff_ids.tolist())
                  for k in "abc"]),
                (ni, na, [(op.opcode, op.outs, op.args) for op in ops], free))
    want, got = record(REF), record(PORT)
    assert got == want


@pytest.mark.parametrize("circuit,path", [
    (sha256_compression, "sha256/w extension 16/computation of w[i]/result bit 3/boolean"),
    (sha256_full, "sha256/block 0/compression round 43/ch/ch 17/ch"),
    (blake2s_full, "blake2s/final block/round 2/mixing invocation 3/mixing step 1/result bit 29/boolean"),
], ids=["sha256_compression", "sha256_full", "blake2s_full"])
def test_gadget_mutation_named_alike(circuit, path):
    """One named aux value corrupted with cs.set in both systems: both name
    the same unsatisfied constraint; the value is put back after."""
    names = []
    for root in (REF, PORT):
        cs, _ = synthesized(circuit, root)
        old = cs.get(path)
        cs.set(path, 1 - old)
        names.append(cs.which_is_unsatisfied())
        cs.set(path, old)
        assert cs.is_satisfied()
    assert names[0] is not None and names[1] == names[0]
