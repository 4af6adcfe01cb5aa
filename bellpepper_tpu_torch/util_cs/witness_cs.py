"""WitnessCS — the production witness generator, plus SizedWitness.

Re-design of reference crates/bellpepper/src/util_cs/witness_cs.rs:
stores only the input/aux assignment vectors; `enforce` and namespaces
are no-ops (witness_cs.rs:125-146). Implements the extensibility seam
(`extend`, witness_cs.rs:154-163 — the parallel-synthesis merge hook)
and the full witness-generator protocol (witness_cs.rs:167-202).

In the port this backend is the host-side reference path; the
device path generates witnesses as limb tensors via the compiled witness
program (bellpepper_tpu_torch.compile.witness_program) and can be loaded into
a WitnessCS via `from_assignments` for bit-exact comparison."""

from __future__ import annotations

from typing import List, Tuple

from ..constraint_system import ConstraintSystem, resolve_value
from ..fields import SCALAR, PrimeField
from ..lc import Index, Variable


class _SliceView:
    """Mutable window into a list, emulating the `&mut [Scalar]` slices the
    reference hands to SizedWitness writers (witness_cs.rs:179-193)."""

    __slots__ = ("_store", "_start", "_len")

    def __init__(self, store: list, start: int, length: int):
        self._store = store
        self._start = start
        self._len = length

    def __len__(self) -> int:
        return self._len

    def _abs(self, i: int) -> int:
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError(i)
        return self._start + i

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._store[self._abs(j)] for j in range(*i.indices(self._len))]
        return self._store[self._abs(i)]

    def __setitem__(self, i, v) -> None:
        if isinstance(i, slice):
            idxs = range(*i.indices(self._len))
            vs = list(v)
            assert len(idxs) == len(vs)
            for j, val in zip(idxs, vs):
                self._store[self._abs(j)] = val
        else:
            self._store[self._abs(i)] = v


class SizedWitness:
    """Circuits that know their (constraints, inputs, aux) counts a priori
    and write witnesses straight into preallocated storage
    (witness_cs.rs:7-41) — bypassing per-variable closure dispatch.

    This is the natural host API for device-generated witnesses: a
    subclass may fill the slices from a device computation's output."""

    def num_constraints(self) -> int:
        raise NotImplementedError

    def num_inputs(self) -> int:
        raise NotImplementedError

    def num_aux(self) -> int:
        raise NotImplementedError

    def generate_witness_into(self, aux, inputs) -> int:
        """Fill aux/inputs storage; returns the circuit result scalar."""
        raise NotImplementedError

    def generate_witness(self, field: PrimeField = SCALAR) -> Tuple[List[int], List[int], int]:
        aux = [field.ZERO] * self.num_aux()
        inputs = [field.ZERO] * self.num_inputs()
        result = self.generate_witness_into(aux, inputs)
        return aux, inputs, result

    def generate_witness_into_cs(self, cs: ConstraintSystem) -> int:
        assert cs.is_witness_generator()
        aux, inputs = cs.allocate_empty(self.num_aux(), self.num_inputs())
        assert len(aux) == self.num_aux()
        assert len(inputs) == self.num_inputs()
        return self.generate_witness_into(aux, inputs)


class WitnessCS(ConstraintSystem):
    """Witness-only backend: `alloc` evaluates and appends; `enforce` is a
    no-op (witness_cs.rs:88-146)."""

    def __init__(self, field: PrimeField = SCALAR):
        self.field = field
        self.input_assignment: List[int] = [field.ONE]
        self.aux_assignment: List[int] = []

    @classmethod
    def with_capacity(cls, input_size: int, aux_size: int, field: PrimeField = SCALAR):
        # Python lists grow automatically; kept for API parity.
        return cls(field)

    @classmethod
    def from_assignments(
        cls, input_assignment: List[int], aux_assignment: List[int], field: PrimeField = SCALAR
    ) -> "WitnessCS":
        cs = cls(field)
        cs.input_assignment = list(input_assignment)
        cs.aux_assignment = list(aux_assignment)
        return cs

    def to_assignments(self) -> Tuple[List[int], List[int]]:
        return self.input_assignment, self.aux_assignment

    # -- ConstraintSystem ----------------------------------------------------
    def alloc_within(self, _prefix, _annotation, f) -> Variable:
        self.aux_assignment.append(resolve_value(f) % self.field.p)
        return Variable(Index.aux(len(self.aux_assignment) - 1))

    def alloc_input_within(self, _prefix, _annotation, f) -> Variable:
        self.input_assignment.append(resolve_value(f) % self.field.p)
        return Variable(Index.input(len(self.input_assignment) - 1))

    def enforce_within(self, _prefix, _annotation, _a, _b, _c) -> None:
        pass  # witness generators don't assemble constraints

    def register_namespace(self, prefix) -> None:
        pass

    # -- extensibility (the parallel-synthesis merge seam) ---------------------
    @staticmethod
    def is_extensible() -> bool:
        return True

    def extend(self, other: "WitnessCS") -> None:
        """Concatenate another CS's assignments, skipping its first input
        (the temporarily-allocated ONE, witness_cs.rs:158-163). Sharded
        synthesis merges deterministically through this, matching the
        sequential order."""
        self.input_assignment.extend(other.input_assignment[1:])
        self.aux_assignment.extend(other.aux_assignment)

    # -- witness-generator protocol ------------------------------------------
    def is_witness_generator(self) -> bool:
        return True

    def extend_inputs(self, new_inputs) -> None:
        self.input_assignment.extend(int(v) % self.field.p for v in new_inputs)

    def extend_aux(self, new_aux) -> None:
        self.aux_assignment.extend(int(v) % self.field.p for v in new_aux)

    def allocate_empty(self, aux_n: int, inputs_n: int):
        ai = len(self.aux_assignment)
        self.aux_assignment.extend([self.field.ZERO] * aux_n)
        ii = len(self.input_assignment)
        self.input_assignment.extend([self.field.ZERO] * inputs_n)
        return (
            _SliceView(self.aux_assignment, ai, aux_n),
            _SliceView(self.input_assignment, ii, inputs_n),
        )

    def allocate_empty_inputs(self, n: int):
        i = len(self.input_assignment)
        self.input_assignment.extend([self.field.ZERO] * n)
        return _SliceView(self.input_assignment, i, n)

    def allocate_empty_aux(self, n: int):
        i = len(self.aux_assignment)
        self.aux_assignment.extend([self.field.ZERO] * n)
        return _SliceView(self.aux_assignment, i, n)

    def inputs_slice(self) -> List[int]:
        return self.input_assignment

    def aux_slice(self) -> List[int]:
        return self.aux_assignment

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, WitnessCS)
            and self.input_assignment == other.input_assignment
            and self.aux_assignment == other.aux_assignment
        )
