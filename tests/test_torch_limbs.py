"""The port's limbs witness form against the JAX package, bit for bit:
_classify_trivial_limb_rows on config 1, its variant, one sha256
compression and random circuits; z_template_limbs; and the limbs checks'
masks and verdicts against build_templated_check(t, B, False, "limbs") on
both routes (B = 128 fused, B = 96 and 1 not), clean and with planted
non-bit values. Tolerance 0 throughout. The kernels' plain versions are
held against the Pallas kernels in test_torch_limbs_kernels.py."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellpepper_tpu import TestConstraintSystem
from bellpepper_tpu.backend import matvec as ref_mv
from bellpepper_tpu.backend.field_jnp import get_backend as ref_backend
from bellpepper_tpu.compile.tape import TapeCS
from bellpepper_tpu.compile.witness_program import WitnessProgram as RefProgram
from bellpepper_tpu.fields import SCALAR
from bellpepper_tpu.gadgets.boolean import AllocatedBit, Boolean
from bellpepper_tpu.gadgets.multipack import pack_bits
from bellpepper_tpu.gadgets.num import AllocatedNum
from bellpepper_tpu.native import NativeBuilder as RefBuilder
from bellpepper_tpu.r1cs import R1CS as RefR1CS
from bellpepper_tpu_torch import NativeBuilder, PrimeField, WitnessProgram, build_templated_check
from bellpepper_tpu_torch.backend import layout
from bellpepper_tpu_torch.backend.limbs import LimbsCheck, TrivialLimbsCheck
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.r1cs import R1CS, COOMatrix

import test_torch_mixed
from test_torch_mixed import _one_torch_thread  # noqa: F401  (autouse)

RNG = np.random.default_rng(0x5EED_0009)
P = SCALAR.p


def _limbs16(v):
    return [(v >> (16 * l)) & 0xFFFF for l in range(16)]


# --- the trivial-row partition ----------------------------------------------
def _config1(builder_cls, nonzero=False):
    return test_torch_mixed._config1(builder_cls, nonzero)


def _sha256():
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    return nb.finish()[0]


def _random_circuit(seed):
    """A random mul/add/square DAG over four allocated nums (the shape of
    tests/test_trivial_limbs_partition.py); x.add(x) folds to a coefficient
    2, which stays on the fold path."""
    rng = random.Random(seed)
    cs = TestConstraintSystem()
    nums = [AllocatedNum.alloc(cs.namespace(f"in {i}"), rng.randrange(P)) for i in range(4)]
    for step in range(16):
        op = rng.randrange(3)
        x, y = rng.choice(nums), rng.choice(nums)
        ns = cs.namespace(f"op {step}")
        nums.append(x.mul(ns, y) if op == 0 else x.add(ns, y) if op == 1 else x.square(ns))
    assert cs.is_satisfied()
    return cs


def _multipack_circuit(cs, seed):
    """Num chain rows (trivial), allocated bits (booleanity rows) and one
    multipack row (a fold row with 2^i coefficients)."""
    rng = random.Random(seed)
    a = AllocatedNum.alloc(cs.namespace("a"), rng.randrange(P))
    b = AllocatedNum.alloc(cs.namespace("b"), rng.randrange(P))
    c = a.mul(cs.namespace("ab"), b)
    d = c.add(cs.namespace("ab plus a"), a)
    e = d.square(cs.namespace("sq"))
    e.mul(cs.namespace("final"), b)
    bits = [Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"bit {i}"), rng.random() < 0.5))
            for i in range(12)]
    pack_bits(cs.namespace("pack"), bits)


@pytest.mark.parametrize("name", ["config1", "variant", "sha256", "random0", "random1"])
def test_classify_trivial_limb_rows_matches_reference(name):
    if name in ("config1", "variant"):
        t = _config1(NativeBuilder, name == "variant")[0]
    elif name == "sha256":
        t = _sha256()
    else:
        t = RefR1CS.from_test_cs(_random_circuit(int(name[-1])))
    got, want = layout._classify_trivial_limb_rows(t), ref_mv._classify_trivial_limb_rows(t)
    if name == "sha256":
        assert got is None and want is None
        return
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2].dtype == want[2].dtype and (got[2] == want[2]).all()
    if name == "config1":
        assert tuple(len(x) for x in got) == (128, 90, 2)


# --- z_template_limbs ------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _programs(name):
    if name == "config1":
        t, tape = _config1(NativeBuilder)
        tr, tape_r = _config1(RefBuilder)
    else:  # every evaluator opcode and a free field input
        tape = TapeCS()
        test_torch_mixed._all_ops_circuit(tape)
        t = tr = tape_r = None
    return t, WitnessProgram(tape), tr, RefProgram(tape_r or tape)


@pytest.mark.parametrize("name", ["config1", "all_ops"])
def test_z_template_limbs_matches_reference(name):
    _t, prog, _tr, ref = _programs(name)
    B = 64
    free = RNG.integers(0, 2, size=(B, len(prog.free_slots))).astype(np.uint32)
    ff = np.zeros((B, max(len(prog.free_field_slots), 1), 16), np.uint32)
    if prog.free_field_slots:
        ff[:, 0] = [_limbs16(random.Random(k).randrange(P)) for k in range(B)]
    vals, flimbs = prog.build(device="cpu")(from_numpy_u32(free), from_numpy_u32(ff) if prog.free_field_slots else None)
    rv, rf = ref.build(False)(jnp.asarray(free), jnp.asarray(ff))
    for fsrc in ((None, None), (from_numpy_u32(ff), jnp.asarray(ff))):
        got = prog.z_template_limbs(vals, flimbs, fsrc[0])
        want = np.asarray(ref.z_template_limbs(rv, rf, fsrc[1]))
        assert got.shape == (B, prog.num_slots, 16) and (to_numpy_u32(got) == want).all()


# --- the checks -------------------------------------------------------------------
def _config1_z(B):
    t, prog, tr, _ref = _programs("config1")
    free = RNG.integers(0, 2, size=(B, 128)).astype(np.uint32)
    vals, flimbs = prog.build(device="cpu")(from_numpy_u32(free))
    return t, tr, to_numpy_u32(prog.z_template_limbs(vals, flimbs)), prog


def _multipack_z(B):
    be = ref_backend(SCALAR)
    zs, t = [], None
    for i in range(B):
        cs = TestConstraintSystem()
        _multipack_circuit(cs, 1000 + i)
        assert cs.is_satisfied()
        t = t or RefR1CS.from_test_cs(cs)
        zs.append(be.to_limbs(cs.scalar_inputs() + cs.scalar_aux()))
    return t, np.stack(zs)


def _plants(z, bit_slot, field_slot):
    """Corrupted copies of z: a random canonical field element in a bit
    slot of instance B/2 (the limbs form's own mutation), one flipped limb
    of a field slot at the last instance, and 2 in the bit slot of
    instance 0."""
    B = z.shape[0]
    out = []
    for inst, slot, value in ((B // 2, bit_slot, random.Random(5).randrange(P)), (0, bit_slot, 2)):
        zb = z.copy()
        zb[inst, slot] = _limbs16(value)
        out.append(zb)
    zb = z.copy()
    zb[B - 1, field_slot, 3] ^= 1
    out.append(zb)
    return out


@pytest.mark.parametrize(
    "name,B,partition,want_type,fused",
    [
        ("config1", 128, True, TrivialLimbsCheck, True),
        ("config1", 96, True, TrivialLimbsCheck, False),
        ("config1", 1, True, TrivialLimbsCheck, False),
        ("config1", 128, False, LimbsCheck, True),
        ("multipack", 4, True, TrivialLimbsCheck, False),
        ("multipack", 4, False, LimbsCheck, False),
    ],
    ids=["config1-B128-fused", "config1-B96", "config1-B1", "config1-whole-B128-fused",
         "multipack-B4", "multipack-whole-B4"],
)
def test_limbs_check_matches_reference(name, B, partition, want_type, fused):
    if name == "config1":
        t, tr, z, prog = _config1_z(B)
        bit_slot = prog.free_slots[5]
        field_slot = sorted(prog.field_rows, key=prog.field_rows.get)[0]  # a pack output
    else:
        t, z = _multipack_z(B)
        tr = t
        bit_slot, field_slot = z.shape[1] - 2, z.shape[1] - 1  # a bit, the pack output
    if partition:
        check = build_templated_check(t, B, None, "limbs", device="cpu")
    else:
        check = LimbsCheck(t, B, torch.device("cpu"))
    assert type(check) is want_type
    assert (check.fold if partition else check).fused == fused
    ref = jax.jit(ref_mv.build_templated_check(tr, B, False, "limbs", _partition=partition))
    R = t.num_constraints
    for k, zz in enumerate([z] + _plants(z, bit_slot, field_slot)):
        mask = check(from_numpy_u32(zz)).numpy()
        want = np.asarray(ref(jnp.asarray(zz)))
        assert (mask == want).all(), k
        nb, first = (int(v) for v in check.verdict(from_numpy_u32(zz)))
        assert nb == int(want.sum()) and (nb > 0) == (k > 0)
        assert first == (int(np.argmax(want)) if nb else 0xFFFFFFFF)
        if k == 1:  # the non-bit value is found at its instance
            assert first // R == B // 2
    with pytest.raises(ValueError):
        check(from_numpy_u32(z[:, :-1].copy()))


def test_limbs_checks_refuse_a_field_below_250_bits():
    """z1·z1 = z2 over a 127-bit field, which both limbs checks refused
    until the canonical route was ported: the partitioned check (its
    trivial row canonicalized and multiplied by mul) and the fold check
    (the fused route's canonical limbs_matvec, then mul and a compare) give
    the reference's masks, clean and with z2 off by one."""
    from bellpepper_tpu.fields import PrimeField as RefPrimeField
    from bellpepper_tpu.r1cs import COOMatrix as RefCOO

    p = (1 << 127) - 1
    one = np.ones(1, np.int32)

    def m(col, coo=COOMatrix):
        return coo(rows=np.zeros(1, np.int32), cols=one * col, coeff_ids=np.zeros(1, np.int32))

    t = R1CS(field=PrimeField("m127", p), num_inputs=1, num_aux=2, num_constraints=1,
             a=m(1), b=m(1), c=m(2), coeff_table=[1])
    tr = RefR1CS(field=RefPrimeField("m127", p), num_inputs=1, num_aux=2, num_constraints=1,
                 a=m(1, RefCOO), b=m(1, RefCOO), c=m(2, RefCOO), coeff_table=[1])
    B = 128
    rnd = random.Random(7)
    x = [rnd.randrange(p) for _ in range(B)]
    vals = np.asarray([[1, v, v * v % p] for v in x], object)
    vals[B // 2, 2] = (vals[B // 2, 2] + 1) % p
    z = np.asarray([[[(int(v) >> (16 * l)) & 0xFFFF for l in range(16)] for v in row] for row in vals], np.uint32)
    for partition, check in ((True, build_templated_check(t, B, None, "limbs", device="cpu")),
                             (False, LimbsCheck(t, B, torch.device("cpu")))):
        want = np.asarray(jax.jit(ref_mv.build_templated_check(tr, B, False, "limbs", _partition=partition))(
            jnp.asarray(z)))
        got = check(from_numpy_u32(z)).numpy()
        assert (got == want).all() and np.nonzero(got)[0].tolist() == [B // 2]
