"""ctypes bindings for the native (C++) synthesis core, without JAX.

Counterpart of ``bellpepper_tpu/native/__init__.py:45-139`` and
``:165-453``. This package carries its own copy of the C++
source (``synthesis.cpp`` beside this file), which is compiled with g++
into the package's build directory, keyed by a content hash of the source.
Bound: the bit gadgets (``alloc_bit``, ``alloc_u32``, ``constant``,
``not_``, ``xor``, ``and_``, ``ch``, ``maj``, ``multieq_begin``,
``multieq_end``, ``addmany``, ``view``), the sha256 and blake2s
compressions (``sha256_iv``, ``sha256_compression``,
``blake2s_compression``) the AllocatedNum field gadgets (``alloc_num``, ``num_add``,
``num_mul``, ``num_square``, ``num_assert_nonzero``, ``pack_bits``) and
the num family (``num_to_bits_le_strict``, ``num_conditionally_reverse``,
``num_is_zero``, ``lookup3_xy``,
``lookup3_xy_with_conditional_negation``).

``finish`` returns the same ``(R1CS, tape)`` artifacts as the JAX
package's builder and decodes every opcode the C++ side emits; the tape
feeds ``compile.witness_program.WitnessProgram``."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np

from ..compile.tape import V_CONST, V_VAR, Op
from ..fields import SCALAR, PrimeField
from ..r1cs import COOMatrix, R1CS

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCE = os.path.join(_HERE, "synthesis.cpp")

_OPCODE_NAMES = [
    "xor", "and", "and_not", "nor", "ch", "maj", "addmany",
    "fadd", "fmul", "finv", "copy", "pack",
    "fbits_le", "select", "lookup", "num_iszero", "num_inv_or_one",
]
_U64 = 0xFFFFFFFFFFFFFFFF

_lib = None


def _build(src: str, out_dir: str) -> str:
    """Compile `src` into `out_dir/synthesis-<hash>.so` unless present.
    The library is written to a temp file and renamed into place, so
    concurrent builders (test workers) never load a half-written file."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(out_dir, f"synthesis-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src],
            check=True,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build(SOURCE, BUILD_DIR))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.bp_builder_new.restype = vp
    lib.bp_builder_new.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    lib.bp_builder_free.restype = None
    lib.bp_builder_free.argtypes = [vp]
    for name, args in [
        ("bp_alloc_bit", [vp]),
        ("bp_not", [i64]),
        ("bp_xor", [vp, i64, i64]),
        ("bp_and", [vp, i64, i64]),
        ("bp_ch", [vp, i64, i64, i64]),
        ("bp_maj", [vp, i64, i64, i64]),
        ("bp_alloc_num", [vp]),
        ("bp_num_add", [vp, i64, i64]),
        ("bp_num_mul", [vp, i64, i64]),
        ("bp_num_square", [vp, i64]),
        ("bp_num_is_zero", [vp, i64]),
        ("bp_num_inputs", [vp]),
        ("bp_num_aux", [vp]),
        ("bp_num_constraints", [vp]),
        ("bp_nnz", [vp, i32]),
        ("bp_coeff_count", [vp]),
        ("bp_tape_resolved_len", [vp]),
        ("bp_tape_op_count", [vp]),
    ]:
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = args
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.bp_pack_bits.restype = i64
    lib.bp_pack_bits.argtypes = [vp, i64p, i32]
    lib.bp_lookup3_xy_cn.restype = i64
    lib.bp_lookup3_xy_cn.argtypes = [vp, i64p, u64p]
    for name, args in [
        ("bp_multieq_begin", [vp]),
        ("bp_multieq_end", [vp]),
        ("bp_addmany", [vp, i64p, i32, i64p]),
        ("bp_blake2s_compression", [vp, i64p, i64p, ctypes.c_uint64, i32]),
        ("bp_num_assert_nonzero", [vp, i64]),
        ("bp_num_to_bits_strict", [vp, i64, i64p]),
        ("bp_num_cond_reverse", [vp, i64, i64, i64, i64p]),
        ("bp_lookup3_xy", [vp, i64p, u64p, i64p]),
        ("bp_sha256_compression", [vp, i64p, i64p, i64p]),
        ("bp_sha256_iv", [i64p]),
        ("bp_get_coo", [vp, i32, i32p, i32p, i32p]),
        ("bp_get_coeffs", [vp, u64p]),
        ("bp_get_tape_resolved", [vp, i64p, i64p]),
    ]:
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = args
    _lib = lib
    return lib


class _NativeTape:
    """Duck-typed tape handing the native op stream to WitnessProgram."""

    def __init__(self, field, num_inputs, num_aux, ops, free_slots):
        self.field = field
        self._snapshot = (num_inputs, num_aux, ops, free_slots)

    def snapshot(self):
        return self._snapshot


class NativeBuilder:
    """Native circuit builder. Bit views are opaque ints (Boolean
    encodings shared with the C++ side); num values are slotcodes. Slot
    numbering matches the Python gadget path."""

    def __init__(self, field: PrimeField = SCALAR):
        self.field = field
        lib = load_library()
        pw = (ctypes.c_uint64 * 4)(*[(field.p >> (64 * i)) & _U64 for i in range(4)])
        self._lib = lib
        self._b = lib.bp_builder_new(pw)
        self._free_order: List[int] = []  # slotcodes of free slots, in order

    def __del__(self):
        if getattr(self, "_b", None):
            self._lib.bp_builder_free(self._b)
            self._b = None

    # -- bit gadgets -----------------------------------------------------------
    def alloc_bit(self) -> int:
        v = self._lib.bp_alloc_bit(self._b)
        self._free_order.append(v >> 2)  # slotcode
        return v

    def alloc_u32(self, n_bits: int = 32) -> List[int]:
        """n_bits free bits, LSB first (an allocated UInt32)."""
        return [self.alloc_bit() for _ in range(n_bits)]

    @staticmethod
    def constant(b: bool) -> int:
        """The view of a constant bit."""
        return 2 if b else 0

    def not_(self, v: int) -> int:
        return self._lib.bp_not(v)

    def xor(self, a: int, b: int) -> int:
        return self._lib.bp_xor(self._b, a, b)

    def and_(self, a: int, b: int) -> int:
        return self._lib.bp_and(self._b, a, b)

    def ch(self, a: int, b: int, c: int) -> int:
        return self._lib.bp_ch(self._b, a, b, c)

    def maj(self, a: int, b: int, c: int) -> int:
        return self._lib.bp_maj(self._b, a, b, c)

    def multieq_begin(self) -> None:
        """Open a MultiEq batch: the equalities of the addmanys until
        ``multieq_end`` pack into shared power-of-two rows."""
        self._lib.bp_multieq_begin(self._b)

    def multieq_end(self) -> None:
        self._lib.bp_multieq_end(self._b)

    def addmany(self, words: Sequence[Sequence[int]]) -> List[int]:
        """The mod-2^32 sum of words of 32 views each (LSB first)."""
        flat = np.asarray([v for w in words for v in w], np.int64)
        if flat.shape[0] != 32 * len(words):
            raise ValueError("addmany takes words of 32 views")
        out = np.empty(32, np.int64)
        self._lib.bp_addmany(self._b, flat, len(words), out)
        return list(out)

    def sha256_iv(self) -> List[int]:
        out = np.empty(256, np.int64)
        self._lib.bp_sha256_iv(out)
        return list(out)

    def sha256_compression(
        self, in_bits: Sequence[int], state: Sequence[int]
    ) -> List[int]:
        """in_bits: 512 views (big-endian bit order, like the gadget);
        state: 256 views = 8 words × 32 LSB-first bits."""
        if len(in_bits) != 512 or len(state) != 256:
            raise ValueError("sha256_compression takes 512 input and 256 state views")
        out = np.empty(256, np.int64)
        self._lib.bp_sha256_compression(
            self._b,
            np.asarray(in_bits, np.int64),
            np.asarray(state, np.int64),
            out,
        )
        return list(out)

    def blake2s_compression(self, h: Sequence[int], m: Sequence[int], t: int, f: bool) -> List[int]:
        """h: 256 views (8 state words), m: 512 views (16 message words),
        words LSB first; t the byte offset, f the final-block flag →
        the new state's 256 views."""
        if len(h) != 256 or len(m) != 512:
            raise ValueError("blake2s_compression takes 256 state and 512 message views")
        hb = np.asarray(h, np.int64).copy()
        self._lib.bp_blake2s_compression(self._b, hb, np.asarray(m, np.int64), t, 1 if f else 0)
        return list(hb)

    # -- AllocatedNum field gadgets (num.rs) ----------------------------------
    def alloc_num(self) -> int:
        """Free field-valued slot; returns its SLOTCODE (not a view)."""
        sc = self._lib.bp_alloc_num(self._b)
        self._free_order.append(sc)
        return sc

    def num_add(self, sa: int, sb: int) -> int:
        return self._lib.bp_num_add(self._b, sa, sb)

    def num_mul(self, sa: int, sb: int) -> int:
        return self._lib.bp_num_mul(self._b, sa, sb)

    def num_square(self, sa: int) -> int:
        return self._lib.bp_num_square(self._b, sa)

    def num_assert_nonzero(self, sa: int) -> None:
        self._lib.bp_num_assert_nonzero(self._b, sa)

    def pack_bits(self, views: Sequence[int]) -> int:
        """Pack Boolean views (up to the field's CAPACITY) into one num
        slot (multipack.rs); returns its slotcode."""
        vs = np.asarray(list(views)[: self.field.CAPACITY], np.int64)
        return self._lib.bp_pack_bits(self._b, vs, len(vs))

    # -- the num family (num.rs, boolean_utils.rs, lookup.rs) -------------------
    def num_to_bits_le_strict(self, sa: int) -> List[int]:
        """Strict in-field LE decomposition of a num slot (num.rs:128-251):
        NUM_BITS Boolean views, LSB first."""
        out = np.empty(self.field.NUM_BITS, np.int64)
        self._lib.bp_num_to_bits_strict(self._b, sa, out)
        return [int(v) for v in out]

    def num_conditionally_reverse(self, sa: int, sb: int, cond: int):
        """(b, a) if the Boolean view cond is set, else (a, b)
        (num.rs:408-454): two num slotcodes."""
        out = np.empty(2, np.int64)
        self._lib.bp_num_cond_reverse(self._b, sa, sb, cond, out)
        return int(out[0]), int(out[1])

    def num_is_zero(self, sa: int) -> int:
        """The 3-constraint is-zero of a num slot (boolean_utils.rs:52-98):
        a Boolean view."""
        return self._lib.bp_num_is_zero(self._b, sa)

    def _coords_u64(self, values) -> np.ndarray:
        """Field elements as 4 little-endian u64 words each."""
        return np.asarray([(self.field.normalize(v) >> (64 * j)) & _U64
                           for v in values for j in range(4)], np.uint64)

    def lookup3_xy(self, bits: Sequence[int], coords):
        """3-bit window lookup (lookup.rs:32-118): bits = 3 Boolean views,
        LSB first; coords = 8 (x, y) pairs → (x, y) num slotcodes."""
        if len(bits) != 3 or len(coords) != 8:
            raise ValueError("lookup3_xy takes 3 bits and 8 coordinate pairs")
        flat = self._coords_u64([c[0] for c in coords] + [c[1] for c in coords])
        out = np.empty(2, np.int64)
        self._lib.bp_lookup3_xy(self._b, np.asarray(bits, np.int64), flat, out)
        return int(out[0]), int(out[1])

    def lookup3_xy_with_conditional_negation(self, bits: Sequence[int], coords) -> int:
        """2-bit lookup and a sign bit (lookup.rs:122-187): bits = 3 views,
        coords = 4 (x, y) pairs → the y slotcode (x is a constraint-free
        linear combination, as the gadget's Num)."""
        if len(bits) != 3 or len(coords) != 4:
            raise ValueError("lookup3_xy_with_conditional_negation takes 3 bits and 4 coordinate pairs")
        flat = self._coords_u64([c[1] for c in coords])
        return int(self._lib.bp_lookup3_xy_cn(self._b, np.asarray(bits, np.int64), flat))

    # -- extraction -------------------------------------------------------------
    def _slot(self, slotcode: int) -> int:
        """slotcode (idx<<1 | is_aux) → global slot (inputs first)."""
        idx = slotcode >> 1
        if slotcode & 1:
            return int(self._lib.bp_num_inputs(self._b)) + idx
        return idx

    def view(self, v: int):
        """An opaque Boolean view as a tape-view triple: (V_CONST, value, 0)
        or (V_VAR, slot, negated)."""
        if (v & 1) == 0:
            return (V_CONST, 1 if v & 2 else 0, 0)
        return (V_VAR, self._slot(v >> 2), 1 if v & 2 else 0)

    def finish(self):
        """Extract (R1CS, tape), identical to the JAX package's
        NativeBuilder.finish for the same circuit."""
        lib, b = self._lib, self._b
        num_inputs = int(lib.bp_num_inputs(b))
        num_aux = int(lib.bp_num_aux(b))
        num_constraints = int(lib.bp_num_constraints(b))

        mats = {}
        for mi, name in enumerate("abc"):
            nnz = int(lib.bp_nnz(b, mi))
            rows = np.empty(nnz, np.int32)
            cols = np.empty(nnz, np.int32)
            cids = np.empty(nnz, np.int32)
            if nnz:
                lib.bp_get_coo(b, mi, rows, cols, cids)
            mats[name] = COOMatrix(rows=rows, cols=cols, coeff_ids=cids)

        n_coeff = int(lib.bp_coeff_count(b))
        raw = np.empty(n_coeff * 4, np.uint64)
        lib.bp_get_coeffs(b, raw)
        coeff_table = [
            sum(int(raw[i * 4 + j]) << (64 * j) for j in range(4))
            for i in range(n_coeff)
        ]
        r1cs = R1CS(
            field=self.field,
            num_inputs=num_inputs,
            num_aux=num_aux,
            num_constraints=num_constraints,
            a=mats["a"],
            b=mats["b"],
            c=mats["c"],
            coeff_table=coeff_table,
            names=None,
        )

        # The C++ side exports the resolved operand stream plus an op
        # table of rows (opcode, n_outs, marker, outs_off, args_off); ops
        # of one (opcode, n_outs, marker) group share their operand width,
        # so each group decodes with one numpy fancy-index.
        tl = int(lib.bp_tape_resolved_len(b))
        n_ops = int(lib.bp_tape_op_count(b))
        flat = np.empty(max(tl, 1), np.int64)
        opt = np.empty(max(n_ops * 5, 1), np.int64)
        if n_ops:
            lib.bp_get_tape_resolved(b, flat, opt)
        opt = opt[: n_ops * 5].reshape(-1, 5)
        ops: List[Optional[Op]] = [None] * n_ops

        def take(off: np.ndarray, width: int) -> np.ndarray:
            if width == 0:
                return np.empty((len(off), 0), np.int64)
            return flat[off[:, None] + np.arange(width)]

        if n_ops:
            uniq, inv = np.unique(opt[:, :3], axis=0, return_inverse=True)
            inv = inv.reshape(-1)
        else:
            uniq, inv = np.empty((0, 3), np.int64), np.empty(0, np.int64)
        for g in range(len(uniq)):
            code, n_outs, marker = (int(v) for v in uniq[g])
            name = _OPCODE_NAMES[code]
            sel = np.nonzero(inv == g)[0]
            outs_m = take(opt[sel, 3], n_outs).tolist()
            aoff = opt[sel, 4]
            if name == "addmany":
                args = take(aoff, -marker * 96).reshape(-1, -marker, 32, 3).tolist()
            elif name in ("ch", "maj", "pack"):
                args = take(aoff, 3 * marker).reshape(-1, marker, 3).tolist()
            elif name == "select":
                args = [[tuple(r[:3]), r[3], r[4]] for r in take(aoff, 5).tolist()]
            elif name == "lookup":
                # marker index bits, then a table of 2^marker 256-bit words
                args = []
                for r in take(aoff, 3 * marker + (4 << marker)).tolist():
                    views = [tuple(r[3 * k : 3 * k + 3]) for k in range(marker)]
                    tw = r[3 * marker :]
                    table = tuple(
                        sum((tw[4 * e + j] & _U64) << (64 * j) for j in range(4))
                        for e in range(1 << marker)
                    )
                    args.append((views, table))
            elif name in ("num_iszero", "num_inv_or_one"):
                args = [
                    [tuple(t) for t in a]
                    for a in take(aoff, 2 * marker).reshape(-1, marker, 2).tolist()
                ]
            else:  # bit ops, field ops and fbits_le: plain slots
                args = take(aoff, marker).tolist()
            for oi, o_, a_ in zip(sel.tolist(), outs_m, args):
                ops[oi] = Op(name, o_, a_)

        produced = {o for op in ops for o in op.outs}
        free = [
            self._slot(sc)
            for sc in self._free_order
            if self._slot(sc) not in produced
        ]
        return r1cs, _NativeTape(self.field, num_inputs, num_aux, ops, free)
