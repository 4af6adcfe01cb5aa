"""MultiEq — batches many small-width equalities into one field-capacity-wide
constraint.

Re-design of reference crates/bellpepper/src/gadgets/multieq.rs: each
`enforce_equal(num_bits, lhs, rhs)` shifts the operands by 2^bits_used and
accumulates; when the next equality would overflow Scalar::CAPACITY the
accumulated constraint is flushed as `lhs * 1 = rhs` named ``multieq {ops}``
(multieq.rs:25-58). The reference flushes the residue in `Drop`
(multieq.rs:61-67); Python has no deterministic drop, so MultiEq is a
context manager — use ``with MultiEq(cs) as mcs: ...`` or call
``finalize()``.

This packing is the reference's answer to "scale the constraint axis": it is
what produces the pinned counts 25,840 / 44,874 / 21,518 for sha256/blake2s
at CAPACITY = 254."""

from __future__ import annotations

from typing import Tuple

from ..constraint_system import ConstraintSystem
from ..lc import LinearCombination, Variable


class MultiEq(ConstraintSystem):
    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.ops = 0
        self.bits_used = 0
        self.lhs = LinearCombination.zero(cs.field)
        self.rhs = LinearCombination.zero(cs.field)
        self._base_prefix = cs.effective_prefix()
        self._finalized = False

    @property
    def field(self):
        return self.cs.field

    # -- batching ---------------------------------------------------------------
    def _accumulate(self) -> None:
        ops = self.ops
        lhs, rhs = self.lhs, self.rhs
        self.cs.enforce(
            f"multieq {ops}",
            lambda _lc: lhs,
            lambda lc: lc + ConstraintSystem.one(),
            lambda _lc: rhs,
        )
        self.lhs = LinearCombination.zero(self.field)
        self.rhs = LinearCombination.zero(self.field)
        self.bits_used = 0
        self.ops += 1

    def enforce_equal(
        self, num_bits: int, lhs: LinearCombination, rhs: LinearCombination
    ) -> None:
        if self.field.CAPACITY <= self.bits_used + num_bits:
            self._accumulate()
        assert self.field.CAPACITY > self.bits_used + num_bits

        coeff = pow(2, self.bits_used, self.field.p)
        self.lhs.iadd_lc(lhs, coeff)
        self.rhs.iadd_lc(rhs, coeff)
        self.bits_used += num_bits

    def finalize(self) -> None:
        """Flush the residual batched constraint (the reference's Drop)."""
        if not self._finalized:
            if self.bits_used > 0:
                self._accumulate()
            self._finalized = True

    def __enter__(self) -> "MultiEq":
        return self

    def __exit__(self, *exc) -> None:
        self.finalize()

    # -- ConstraintSystem passthrough (multieq.rs:69-122) --------------------------
    def effective_prefix(self) -> Tuple[str, ...]:
        return self._base_prefix

    def alloc_within(self, prefix, annotation, f) -> Variable:
        return self.cs.get_root().alloc_within(prefix, annotation, f)

    def alloc_input_within(self, prefix, annotation, f) -> Variable:
        return self.cs.get_root().alloc_input_within(prefix, annotation, f)

    def enforce_within(self, prefix, annotation, a, b, c) -> None:
        self.cs.get_root().enforce_within(prefix, annotation, a, b, c)

    def register_namespace(self, prefix) -> None:
        self.cs.get_root().register_namespace(prefix)

    def record_witness_op(self, opcode, out_vars, operands) -> None:
        self.cs.get_root().record_witness_op(opcode, out_vars, operands)

    def get_root(self) -> "MultiEq":
        # addmany reaches enforce_equal through get_root() (uint32.rs:397).
        return self
