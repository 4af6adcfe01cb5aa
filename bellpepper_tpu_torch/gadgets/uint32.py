"""UInt32 — 32 little-endian Booleans interpreted as an unsigned integer.

Re-design of reference crates/bellpepper/src/gadgets/uint32.rs. Free
operations (rotr/shr) are pure bit-index permutations costing zero
constraints (uint32.rs:163-199) — on the device side these become lane
permutations of bit-plane arrays. `addmany` performs mod-2^32 addition of
2..=10 operands with one batched MultiEq equality (uint32.rs:304-406)."""

from __future__ import annotations

from typing import List, Optional

from ..constraint_system import ConstraintSystem
from ..lc import LinearCombination
from .boolean import AllocatedBit, Boolean
from .multieq import MultiEq


class UInt32:
    __slots__ = ("bits", "value")

    def __init__(self, bits: List[Boolean], value: Optional[int]):
        assert len(bits) == 32
        self.bits = bits  # least significant first
        self.value = value

    # -- constructors ------------------------------------------------------------
    @staticmethod
    def constant(value: int) -> "UInt32":
        value &= 0xFFFFFFFF
        bits = [Boolean.constant(bool((value >> i) & 1)) for i in range(32)]
        return UInt32(bits, value)

    @staticmethod
    def alloc(cs: ConstraintSystem, value: Optional[int]) -> "UInt32":
        if value is not None:
            values = [bool((value >> i) & 1) for i in range(32)]
        else:
            values = [None] * 32
        bits = [
            Boolean.from_bit(AllocatedBit.alloc(cs.namespace(f"allocated bit {i}"), v))
            for i, v in enumerate(values)
        ]
        return UInt32(bits, value)

    # -- bit-order conversions ------------------------------------------------------
    def into_bits_be(self) -> List[Boolean]:
        return list(reversed(self.bits))

    @staticmethod
    def from_bits_be(bits: List[Boolean]) -> "UInt32":
        assert len(bits) == 32
        value: Optional[int] = 0
        for b in bits:
            if value is not None:
                value <<= 1
            v = b.get_value()
            if v is None:
                value = None
            elif v and value is not None:
                value |= 1
        return UInt32(list(reversed(bits)), value)

    def into_bits(self) -> List[Boolean]:
        return list(self.bits)

    @staticmethod
    def from_bits(bits: List[Boolean]) -> "UInt32":
        assert len(bits) == 32
        value: Optional[int] = 0
        for b in reversed(bits):
            if value is not None:
                value <<= 1
            v = b.get_value()
            if v is None:
                value = None
            elif v and value is not None:
                value |= 1
        return UInt32(list(bits), value)

    # -- free ops (0 constraints) -----------------------------------------------------
    def rotr(self, by: int) -> "UInt32":
        by %= 32
        new_bits = [self.bits[(i + by) % 32] for i in range(32)]
        value = (
            ((self.value >> by) | (self.value << (32 - by))) & 0xFFFFFFFF
            if self.value is not None and by
            else self.value
        )
        return UInt32(new_bits, value)

    def shr(self, by: int) -> "UInt32":
        by %= 32
        fill = Boolean.constant(False)
        new_bits = self.bits[by:] + [fill] * by
        value = (self.value >> by) if self.value is not None else None
        return UInt32(new_bits, value)

    # -- bitwise ops --------------------------------------------------------------------
    @staticmethod
    def _triop(cs, a, b, c, tri_fn, circuit_fn) -> "UInt32":
        new_value = (
            tri_fn(a.value, b.value, c.value)
            if a.value is not None and b.value is not None and c.value is not None
            else None
        )
        bits = [
            circuit_fn(cs, i, x, y, z)
            for i, (x, y, z) in enumerate(zip(a.bits, b.bits, c.bits))
        ]
        return UInt32(bits, new_value)

    @staticmethod
    def sha256_maj(cs, a: "UInt32", b: "UInt32", c: "UInt32") -> "UInt32":
        return UInt32._triop(
            cs,
            a,
            b,
            c,
            lambda x, y, z: (x & y) ^ (x & z) ^ (y & z),
            lambda cs_, i, x, y, z: Boolean.sha256_maj(cs_.namespace(f"maj {i}"), x, y, z),
        )

    @staticmethod
    def sha256_ch(cs, a: "UInt32", b: "UInt32", c: "UInt32") -> "UInt32":
        return UInt32._triop(
            cs,
            a,
            b,
            c,
            lambda x, y, z: (x & y) ^ ((x ^ 0xFFFFFFFF) & z),
            lambda cs_, i, x, y, z: Boolean.sha256_ch(cs_.namespace(f"ch {i}"), x, y, z),
        )

    def xor(self, cs: ConstraintSystem, other: "UInt32") -> "UInt32":
        new_value = (
            (self.value ^ other.value)
            if self.value is not None and other.value is not None
            else None
        )
        bits = [
            Boolean.xor(cs.namespace(f"xor of bit {i}"), a, b)
            for i, (a, b) in enumerate(zip(self.bits, other.bits))
        ]
        return UInt32(bits, new_value)

    # -- modular addition --------------------------------------------------------------------
    @staticmethod
    def addmany(cs: ConstraintSystem, operands: List["UInt32"]) -> "UInt32":
        """Mod-2^32 addition of 2..=10 operands (uint32.rs:304-406).

        Builds one LC of all operand bits with 2^i coefficients, allocates
        ⌈log2(max sum)⌉ result bits, and batches the equality into the
        enclosing MultiEq (reached via cs.get_root()). Carries beyond bit 31
        are discarded. All-constant operands short-circuit to a constant."""
        field = cs.field
        assert field.NUM_BITS >= 64
        assert 2 <= len(operands) <= 10

        root = cs.get_root()
        assert isinstance(root, MultiEq), "addmany requires a MultiEq root"

        max_value = len(operands) * 0xFFFFFFFF
        result_value: Optional[int] = 0
        lc = LinearCombination.zero(field)
        all_constants = True
        one = ConstraintSystem.one()

        for op in operands:
            if op.value is not None:
                if result_value is not None:
                    result_value += op.value
            else:
                result_value = None

            coeff = field.ONE
            for bit in op.bits:
                lc.iadd_lc(bit.lc(one, coeff, field))
                all_constants &= bit.is_constant()
                coeff = field.double(coeff)

        modular_value = (result_value & 0xFFFFFFFF) if result_value is not None else None

        if all_constants and modular_value is not None:
            return UInt32.constant(modular_value)

        result_bits: List[Boolean] = []
        result_lc = LinearCombination.zero(field)
        coeff = field.ONE
        i = 0
        while max_value != 0:
            b = AllocatedBit.alloc(
                cs.namespace(f"result bit {i}"),
                (bool((result_value >> i) & 1) if result_value is not None else None),
            )
            result_lc.iadd_term(b.get_variable(), coeff)
            result_bits.append(Boolean.from_bit(b))
            max_value >>= 1
            i += 1
            coeff = field.double(coeff)

        root.enforce_equal(i, lc, result_lc)

        cs.record_witness_op(
            "addmany",
            [b.bit.get_variable() for b in result_bits],
            [op.bits for op in operands],
        )

        del result_bits[32:]
        return UInt32(result_bits, modular_value)

    def __repr__(self) -> str:  # pragma: no cover
        return f"UInt32({self.value:#010x})" if self.value is not None else "UInt32(?)"
