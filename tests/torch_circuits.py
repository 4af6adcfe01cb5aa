"""Circuits, oracles and corner values that the port's tests share (not
collected by pytest). This module imports no JAX and nothing of the JAX
package, so ``tests/test_torch_cuda.py`` can use it where JAX is absent.

* the sha256 compression oracle (FIPS 180-4) in Python ints, with the
  bit orders of the port's gadgets (``sha256_compress``, ``msg_words``,
  ``state_words``, ``oracle_chain``);
* ``digit_sum_corners``: reduce_digits' corner sums;
* ``eager_chain``: the chained witness as an eager loop of its own
  evaluator, the reference of its CUDA graphs;
* ``eager_product_bad``: the product rows' route before operand_mulcmp;
* configs 1-3 and one blake2s compression through ``NativeBuilder``, a
  sha256 tape with one xor of two free bits computing `and`
  (``corrupt_free_xor``), and the flagship and configs 1-3 written with
  the port's gadgets (``FRONTEND``, with ``assert_r1cs_equal``);
* Python-int evaluations of template rows (``chain_steps``,
  ``python_int_first_bad``, ``row_sums_int`` over ``z_ints``);
* ``counted``: a call and the kernel launches it made."""

import random

import numpy as np
import torch

from bellpepper_tpu_torch import SCALAR, NativeBuilder, WitnessProgram
from bellpepper_tpu_torch.backend import field_kernels as fk
from bellpepper_tpu_torch.backend.check_common import Products
from bellpepper_tpu_torch.backend.field_consts import SEMI
from bellpepper_tpu_torch.backend.words import to_i32, to_u32
from bellpepper_tpu_torch.compile.tape import corrupted
from bellpepper_tpu_torch.gadgets.boolean import AllocatedBit, Boolean
from bellpepper_tpu_torch.gadgets.multieq import MultiEq
from bellpepper_tpu_torch.gadgets.multipack import pack_bits as gpack_bits
from bellpepper_tpu_torch.gadgets.sha256 import get_sha256_iv, sha256_compression_function
from bellpepper_tpu_torch.gadgets.uint32 import UInt32
from bellpepper_tpu_torch.tools.dryrun_multichip import sha256_template


def limbs(v, n=17):
    return [(v >> (16 * l)) & 0xFFFF for l in range(n)]


def limb_int(row) -> int:
    return sum(int(x) << (16 * l) for l, x in enumerate(row))


def col_int(t: torch.Tensor, i: int) -> int:
    return limb_int(to_u32(t[:, i]).tolist())


# --- reduce_digits' corners ------------------------------------------------------
def digit_sum_corners(p: int, seed: int) -> np.ndarray:
    """uint32[N, 32] element-major digit sums at reduce_digits' corners:
    every sum 0, 1 or 2^24 − 1 (the callers' bound); each position at each
    of those among random sums; values p and p − 1; values ≡ 0 and ≡ −1
    (mod p) made of large sums (random sums of at least 256, less the
    bytes of the excess); then random sums below 2^24."""
    top = (1 << 24) - 1
    rnd = random.Random(seed)

    def value(col):
        return sum(x << (8 * j) for j, x in enumerate(col))

    cols = [[v] * 32 for v in (0, 1, top)]
    for j in range(32):
        for v in (0, 1, top):
            col = [rnd.randrange(top + 1) for _ in range(32)]
            col[j] = v
            cols.append(col)
    cols += [[(x >> (8 * j)) & 0xFF for j in range(32)] for x in (p, p - 1)]
    for _ in range(4):
        for target in (0, p - 1):
            col = [rnd.randrange(256, top + 1) for _ in range(32)]
            r = (value(col) - target) % p
            cols.append([x - ((r >> (8 * j)) & 0xFF) for j, x in enumerate(col)])
    cols += [[rnd.randrange(top + 1) for _ in range(32)] for _ in range(25)]
    return np.asarray(cols, np.uint32)


# --- the eager references of the chained witness and the product rows ---------
def eager_chain(gen, init_state, msgs):
    """The chain as an eager block-by-block loop of gen's own evaluator
    and carry extraction (no graph)."""
    free = torch.empty((msgs.shape[1], gen.n_free), dtype=torch.int32, device=msgs.device)
    free[:, : gen.n_carry] = init_state
    vals = []
    for m in msgs:
        free[:, gen.n_carry :] = m
        vals.append(gen.block(free).t().clone())
    return torch.stack(vals), free[:, : gen.n_carry].clone()


def eager_product_bad(prods: Products, vals_p, flimbs_p, field):
    """The product rows' route before operand_mulcmp: each operand
    assembled by _Operand.assemble in int64 [n, 17, B], copied limb-major,
    then mulcmp; bool[n, B]."""
    n, B = prods.n, flimbs_p.shape[-1]
    p17 = torch.tensor(limbs(field.p), dtype=torch.int64, device=flimbs_p.device).reshape(1, SEMI, 1)
    a, b, c = (to_i32(o.assemble(vals_p, flimbs_p, p17).transpose(0, 1).reshape(SEMI, n * B)).contiguous()
               for o in prods.ops)
    return (fk.mulcmp(a, b, c, field) != 0).reshape(n, B)


# --- the sha256 oracle -----------------------------------------------------------
_K256 = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
SHA256_IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def sha256_compress(h, w16):
    """The oracle: one sha256 compression (FIPS 180-4) of 16 message
    words into the 8-word state h, in Python ints."""
    rotr = lambda x, n: ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF  # noqa: E731
    w = list(w16)
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & 0xFFFFFFFF)
    a, b, c, d, e, f, g, hh = h
    for t in range(64):
        t1 = (hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + _K256[t] + w[t]) & 0xFFFFFFFF
        t2 = ((rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))) & 0xFFFFFFFF
        a, b, c, d, e, f, g, hh = (t1 + t2) & 0xFFFFFFFF, a, b, c, (d + t1) & 0xFFFFFFFF, e, f, g
    return [(x + y) & 0xFFFFFFFF for x, y in zip(h, (a, b, c, d, e, f, g, hh))]


def msg_words(bits):
    """512 message bits, big-endian within each word (the gadget's order)
    → 16 words."""
    return [sum(int(bits[32 * w + t]) << (31 - t) for t in range(32)) for w in range(16)]


def state_words(bits):
    """256 state bits, 8 words × 32 LSB first → 8 words."""
    return [sum(int(bits[32 * w + i]) << i for i in range(32)) for w in range(8)]


def oracle_chain(msgs_np, b):
    """Chain b of msgs int[T, B, 512] from the sha256 IV → its final
    state words."""
    h = SHA256_IV
    for t in range(msgs_np.shape[0]):
        h = sha256_compress(h, msg_words(msgs_np[t, b]))
    return h


# --- NativeBuilder's circuits ----------------------------------------------------
def corrupt_free_xor(tape):
    """The tape with its first xor of two free bits computing `and`, and
    the two bits' positions among the free inputs: that xor's row fails
    at every instance where either bit is 1, and holds where both are 0."""
    _ni, _na, ops, free = tape.snapshot()
    pos = {s: k for k, s in enumerate(free)}
    of_free = lambda op: all(a in pos for a in op.args)  # noqa: E731
    op = next(op for op in ops if op.opcode == "xor" and of_free(op))
    return corrupted(tape, "xor", "first", into="and", where=of_free), [pos[a] for a in op.args]


def config1_tape(nonzero: bool, field=SCALAR):
    """Config 1 (128 free bits, two packs, (mul, add, square) × 30), with
    num_assert_nonzero of the result if `nonzero`: (template, tape)."""
    nb = NativeBuilder(field)
    bits = [nb.alloc_bit() for _ in range(128)]
    a, b = nb.pack_bits(bits[:64]), nb.pack_bits(bits[64:])
    x = a
    for _ in range(30):
        x = nb.num_square(nb.num_add(nb.num_mul(x, b), a))
    if nonzero:
        nb.num_assert_nonzero(x)
    return nb.finish()


def config1(nonzero: bool, field=SCALAR):
    return native_prog(config1_tape(nonzero, field))


def chain_steps(bits, field=SCALAR):
    """Config 1's chain over Python ints for one instance's 128 free
    bits (a, then b; pack_bits keeps the field's CAPACITY of each 64):
    [m, s, x] of each of the 30 repetitions of x <- ((x·b + a) mod p)² mod
    p."""
    p, cap = field.p, min(64, field.CAPACITY)
    a = sum(int(bits[k]) << k for k in range(cap))
    b = sum(int(bits[64 + k]) << k for k in range(cap))
    x, out = a, []
    for _ in range(30):
        m = x * b % p
        s = (m + a) % p
        x = s * s % p
        out.append([m, s, x])
    return out


def config2_circuit():
    """Config 2 (benchmarks/configs_1_2_3.py:162-206) through NativeBuilder:
    8 allocated u32 words, then 7 × (xor with rotr(5i), addmany with
    shr(3)) under one MultiEq; rotr and shr are index shifts, shr filled
    with constant(False)."""
    nb = NativeBuilder()
    ops = [nb.alloc_u32() for _ in range(8)]
    nb.multieq_begin()
    x = ops[0]
    for i in range(1, 8):
        x = [nb.xor(a, ops[i][(k + 5 * i) % 32]) for k, a in enumerate(x)]
        x = nb.addmany([x, ops[i - 1][3:] + [nb.constant(False)] * 3])
    nb.multieq_end()
    return nb.finish()


def config3_circuit():
    """Config 3 (benchmarks/configs_1_2_3.py:209-258): 4 allocated u32
    words, 3 addmany under one MultiEq, then pack_bits of the sum's 32
    bits into one field element."""
    nb = NativeBuilder()
    words = [nb.alloc_u32() for _ in range(4)]
    nb.multieq_begin()
    acc = words[0]
    for w in words[1:]:
        acc = nb.addmany([acc, w])
    nb.multieq_end()
    nb.pack_bits(acc)
    return nb.finish()


def blake2s_circuit():
    """One blake2s compression of free h (256) and m (512) bits, t = 64,
    f = True (the JAX package's tests/test_native_synthesis.py:102-140)."""
    nb = NativeBuilder()
    h = [nb.alloc_bit() for _ in range(256)]
    nb.blake2s_compression(h, [nb.alloc_bit() for _ in range(512)], 64, True)
    return nb.finish()


# --- the Python circuit frontend -------------------------------------------------
# The flagship and configs 1-3 written with the port's gadgets, as
# tests/test_native_synthesis.py:75-91 and benchmarks/configs_1_2_3.py:88-113,
# 172-186, 222-236 write them, to be recorded into ShapeCS (the template)
# and TapeCS (the tape).
def fe_sha256(cs):
    """One sha256 compression over 512 allocated bits."""
    bits = [Boolean.from_bit(AllocatedBit.alloc(cs, None)) for _ in range(512)]
    sha256_compression_function(cs, bits, get_sha256_iv())


def fe_config1(cs):
    """Config 1: 128 allocated bits, two packs, (mul, add, square) × 30."""
    bs = [Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"b{i}"), None)) for i in range(128)]
    a = gpack_bits(cs.namespace("pa"), bs[:64])
    b = gpack_bits(cs.namespace("pb"), bs[64:])
    x = a
    for i in range(30):
        x = x.mul(cs.namespace(f"m{i}"), b)
        x = x.add(cs.namespace(f"a{i}"), a)
        x = x.square(cs.namespace(f"s{i}"))


def fe_config2(cs):
    """Config 2: 8 allocated u32 words, 7 × (xor with rotr(5i), addmany
    with shr(3)) under one MultiEq."""
    ops = [UInt32.alloc(cs.namespace(f"op {i}"), None) for i in range(8)]
    with MultiEq(cs) as mcs:
        x = ops[0]
        for i in range(1, 8):
            x = x.xor(mcs.namespace(f"x{i}"), ops[i].rotr(5 * i))
            x = UInt32.addmany(mcs.namespace(f"s{i}"), [x, ops[i - 1].shr(3)])


def fe_config3(cs):
    """Config 3: 4 allocated u32 words, 3 addmany under one MultiEq, the
    sum's bits packed into one field element."""
    words = [UInt32.alloc(cs.namespace(f"w{i}"), None) for i in range(4)]
    with MultiEq(cs) as mcs:
        acc = words[0]
        for i in range(1, 4):
            acc = UInt32.addmany(mcs.namespace(f"add {i}"), [acc, words[i]])
    gpack_bits(cs.namespace("pack"), acc.into_bits())


def native_sha256():
    return native_prog(sha256_template())


def native_prog(built):
    template, tape = built
    return template, WitnessProgram(tape)


# name, frontend circuit, NativeBuilder build of the same circuit, (rows, slots)
FRONTEND = (("sha256", fe_sha256, native_sha256, (26352, 26327)),
            ("config1", fe_config1, lambda: config1(False), (220, 221)),
            ("config2", fe_config2, lambda: native_prog(config2_circuit()), (712, 712)),
            ("config3", fe_config3, lambda: native_prog(config3_circuit()), (229, 229)))


def assert_r1cs_equal(got, want):
    """Rows, cols and coefficient values through each table
    (tests/test_native_synthesis.py:23-35)."""
    assert (got.num_inputs, got.num_aux, got.num_constraints) == \
        (want.num_inputs, want.num_aux, want.num_constraints)
    for m in "abc":
        x, y = getattr(got, m), getattr(want, m)
        assert np.array_equal(x.rows, y.rows) and np.array_equal(x.cols, y.cols), m
        assert [got.coeff_table[i] for i in x.coeff_ids] == [want.coeff_table[i] for i in y.coeff_ids], m


# --- template rows over the Python ints -------------------------------------------
def python_int_first_bad(template, z_limbs, slot):
    """The least row referencing `slot` that fails A·z · B·z = C·z over the
    Python ints (z_limbs: int64[S, 16] limbs), and how many rows reference
    it."""
    p = template.field.p
    rows = sorted({int(r) for m in "abc" for r in np.asarray(getattr(template, m).rows)[
        np.asarray(getattr(template, m).cols) == slot]})
    sums = {}
    for m in "abc":
        mat = getattr(template, m)
        sel = np.isin(np.asarray(mat.rows), rows)
        s = dict.fromkeys(rows, 0)
        for r, c, cid in zip(np.asarray(mat.rows)[sel], np.asarray(mat.cols)[sel], np.asarray(mat.coeff_ids)[sel]):
            s[int(r)] = (s[int(r)] + int(template.coeff_table[cid]) * limb_int(z_limbs[int(c)])) % p
        sums[m] = s
    bad = [r for r in rows if (sums["a"][r] * sums["b"][r] - sums["c"][r]) % p]
    return (bad[0] if bad else None), len(rows)


def row_sums_int(r1cs, zi: dict, rows) -> dict:
    """{matrix: its Python-int value at each of `rows`} over zi, {slot:
    int} for every slot those rows read."""
    p = r1cs.field.p
    mark = np.zeros(r1cs.num_constraints, bool)
    mark[rows] = True
    out = {}
    for name in "abc":
        m = getattr(r1cs, name)
        sel = mark[m.rows]
        s = {int(r): 0 for r in rows}
        for r, c, k in zip(m.rows[sel], m.cols[sel], m.coeff_ids[sel]):
            s[int(r)] = (s[int(r)] + r1cs.coeff_table[k] * zi[int(c)]) % p
        out[name] = [s[int(r)] for r in rows]
    return out


def z_ints(z: torch.Tensor, slots) -> dict:
    """{slot: the Python int of z's row}, the rows read back at once."""
    slots = sorted({int(s) for s in slots})
    rows = to_u32(z[torch.as_tensor(slots, device=z.device)]).cpu().numpy()
    return {s: limb_int(row) for s, row in zip(slots, rows)}


# --- launch counts ----------------------------------------------------------------
def counted(fn):
    """fn() and the kernel launches it made: (its result, {kernel: launches}
    for each kernel launched)."""
    fk.reset_launch_counts()
    out = fn()
    return out, {k: v for k, v in fk.launch_counts().items() if v}
