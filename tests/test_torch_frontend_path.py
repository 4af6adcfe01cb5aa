"""The frontend path as a whole: circuits written with the port's gadgets,
recorded into the port's ``ShapeCS`` and ``TapeCS``, go through the port's
steps and checkers. The templates of one sha256 compression and of
configs 1-3 (benchmarks/configs_1_2_3.py's circuits) equal the JAX
package's (arrays and coefficient table) and the port's ``NativeBuilder``'s
(arrays and coefficient values), and the tapes equal the JAX package's op
for op, with the native program's free slots; config 2's packed step runs
on the CPU from the port's own tape (a clean verdict, a flipped bit found
at its instance, the words equal to the native program's); and
``R1CS.from_test_cs`` of a ``TestConstraintSystem`` goes to
``Satisfier(device="cpu")``, whose ``which_is_unsatisfied`` names what
both packages' ``TestConstraintSystem`` name after ``cs.set``. Every
circuit is built once a package; no JAX function runs."""

import functools
import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest

from bellpepper_tpu_torch import R1CS, Satisfier, WitnessProgram, build_packed_production_step
from bellpepper_tpu_torch.backend.matvec import build_templated_check
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from torch_circuits import FRONTEND, assert_r1cs_equal  # NativeBuilder's builds of these circuits

REF, PORT = "bellpepper_tpu", "bellpepper_tpu_torch"
B = 64  # instances of config 2's packed step on the CPU


@functools.lru_cache(maxsize=None)
def pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(top=importlib.import_module(root), r1cs=mod("r1cs"),
                           tape=mod("compile.tape"), boolean=mod("gadgets.boolean"), multieq=mod("gadgets.multieq"),
                           uint32=mod("gadgets.uint32"), multipack=mod("gadgets.multipack"),
                           sha256=mod("gadgets.sha256"))


# -- the circuits, written as benchmarks/configs_1_2_3.py writes them ---------

def sha256_compression(m, cs, bits=None):
    """One sha256 compression of 512 allocated bits
    (tests/test_native_synthesis.py:75-91)."""
    B_, AB = m.boolean.Boolean, m.boolean.AllocatedBit
    vals = bits if bits is not None else [None] * 512
    inp = [B_.from_bit(AB.alloc(cs.namespace(f"input bit {i}"), v)) for i, v in enumerate(vals)]
    m.sha256.sha256_compression_function(cs.namespace("sha256"), inp, m.sha256.get_sha256_iv())


def config1(m, cs, bits=None):
    B_, AB = m.boolean.Boolean, m.boolean.AllocatedBit
    bs = [B_.from_bit(AB.alloc(cs.namespace(f"b{i}"), None if bits is None else bits[i])) for i in range(128)]
    a = m.multipack.pack_bits(cs.namespace("pa"), bs[:64])
    b = m.multipack.pack_bits(cs.namespace("pb"), bs[64:])
    x = a
    for i in range(30):
        x = x.mul(cs.namespace(f"m{i}"), b)
        x = x.add(cs.namespace(f"a{i}"), a)
        x = x.square(cs.namespace(f"s{i}"))


def config2(m, cs, words=None):
    U = m.uint32.UInt32
    ops = [U.alloc(cs.namespace(f"op {i}"), None if words is None else words[i]) for i in range(8)]
    with m.multieq.MultiEq(cs) as mcs:
        x = ops[0]
        for i in range(1, 8):
            x = x.xor(mcs.namespace(f"x{i}"), ops[i].rotr(5 * i))
            x = U.addmany(mcs.namespace(f"s{i}"), [x, ops[i - 1].shr(3)])


def config3(m, cs, words=None):
    U = m.uint32.UInt32
    ws = [U.alloc(cs.namespace(f"w{i}"), None if words is None else words[i]) for i in range(4)]
    with m.multieq.MultiEq(cs) as mcs:
        acc = ws[0]
        for i in range(1, 4):
            acc = U.addmany(mcs.namespace(f"add {i}"), [acc, ws[i]])
    m.multipack.pack_bits(cs.namespace("pack"), acc.into_bits())


# name → (the circuit above, its rows); NativeBuilder's build of the same
# circuit is tests/torch_circuits.py's (FRONTEND)
CIRCUITS = {"sha256_compression": (sha256_compression, 26352), "config1": (config1, 220),
            "config2": (config2, 712), "config3": (config3, 229)}
NATIVE = dict(zip(CIRCUITS, (native for _name, _circuit, native, _want in FRONTEND)))


@functools.lru_cache(maxsize=None)
def frontend(name, root):
    """(ShapeCS template, TapeCS) of a circuit in one package."""
    m = pkg(root)
    shape, tape = m.r1cs.ShapeCS(), m.tape.TapeCS()
    CIRCUITS[name][0](m, shape)
    CIRCUITS[name][0](m, tape)
    return shape.finish(), tape


@functools.lru_cache(maxsize=None)
def native(name):
    """(template, program) of NativeBuilder's build of a circuit."""
    return NATIVE[name]()


def arrays(r):
    return [(getattr(r, k).rows.tolist(), getattr(r, k).cols.tolist(), getattr(r, k).coeff_ids.tolist())
            for k in "abc"]


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_frontend_template_matches_reference_and_native(name):
    got, _ = frontend(name, PORT)
    want, _ = frontend(name, REF)
    assert type(got) is R1CS and got.num_constraints == CIRCUITS[name][1]
    assert (got.num_inputs, got.num_aux, got.num_constraints) == (want.num_inputs, want.num_aux, want.num_constraints)
    assert list(got.coeff_table) == list(want.coeff_table) and got.names is None
    assert arrays(got) == arrays(want)
    assert_r1cs_equal(native(name)[0], got)


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_frontend_tape_matches_reference_and_native(name):
    ni, na, ops, free = frontend(name, PORT)[1].snapshot()
    rni, rna, rops, rfree = frontend(name, REF)[1].snapshot()
    assert (ni, na, free) == (rni, rna, rfree)
    assert [(op.opcode, op.outs, op.args) for op in ops] == [(op.opcode, op.outs, op.args) for op in rops]
    prog, nprog = WitnessProgram(frontend(name, PORT)[1]), native(name)[1]
    assert prog.free_slots == nprog.free_slots and prog.num_slots == nprog.num_slots
    assert [st.opcode for st in prog.stages] == [st.opcode for st in nprog.stages]


def test_config2_packed_step_from_frontend_tape():
    """Config 2 on build_packed_production_step at 2 × 64 instances on the
    CPU from the port's own ShapeCS and TapeCS: a clean verdict, the words
    equal to the native program's on the same free words, and a flipped
    witness bit found at its instance."""
    template, tape = frontend("config2", PORT)
    prog = WitnessProgram(tape)
    assert prog.is_packable
    rng = np.random.default_rng(6)
    free_np = rng.integers(0, 1 << 32, size=(2, B // 32, len(prog.free_slots)), dtype=np.uint64).astype(np.uint32)
    free = from_numpy_u32(free_np)
    step = build_packed_production_step(prog, template, B, device="cpu")
    assert [int(v) for v in step(free)] == [0, 0xFFFFFFFF]
    vals = prog.build_packed(device="cpu")(free[0])
    assert (to_numpy_u32(vals) == to_numpy_u32(native("config2")[1].build_packed(device="cpu")(free[0]))).all()
    check = build_templated_check(template, B, None, "bits_packed", device="cpu")
    assert [int(v) for v in check.verdict(vals)] == [0, 0xFFFFFFFF]
    R, slot = template.num_constraints, prog.num_slots // 2
    bad = vals.clone()
    bad[1, slot] ^= 1 << 9
    nbad, first = (int(v) for v in check.verdict(bad))
    assert nbad > 0 and first // R == 32 + 9, (nbad, first)


def config2_with_values(root, words):
    m = pkg(root)
    cs = m.top.TestConstraintSystem()
    config2(m, cs, words)
    return cs


@pytest.mark.parametrize("path,value", [
    ("op 3/allocated bit 7/boolean", None),
    ("x4/xor of bit 11/xor result", None),
    ("s6/result bit 30/boolean", None),
    ("op 0/allocated bit 0/boolean", 5),
])
def test_satisfier_from_test_cs_names_what_test_cs_names(path, value):
    """Config 2 with values in TestConstraintSystem → R1CS.from_test_cs →
    Satisfier on the CPU: satisfied; after cs.set(path, v) (a flipped bit,
    or a non-bit value) its which_is_unsatisfied equals the port's and the
    JAX package's TestConstraintSystem's."""
    words = [random.Random(21).getrandbits(32) for _ in range(8)]
    cs, ref_cs = config2_with_values(PORT, words), config2_with_values(REF, words)
    r1cs = R1CS.from_test_cs(cs)
    assert r1cs.names == [c.name for c in cs.constraints()] and r1cs.num_constraints == 712
    sat = Satisfier(r1cs, device="cpu")
    assert cs.is_satisfied() and sat.is_satisfied(sat.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux()))
    v = 1 - cs.get(path) if value is None else value
    for c in (cs, ref_cs):
        c.set(path, v)
    z = sat.z_from_assignments(cs.scalar_inputs(), cs.scalar_aux())
    name = sat.which_is_unsatisfied(z)
    assert name is not None and name == cs.which_is_unsatisfied() == ref_cs.which_is_unsatisfied()
    assert r1cs.eval_host(cs.scalar_inputs(), cs.scalar_aux())[1] == r1cs.names.index(name)
    assert not sat.is_satisfied(z)
