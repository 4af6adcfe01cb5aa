"""BenchCS — pure counters, maximum-speed synthesis-overhead measurement.

Re-design of reference crates/bellpepper/src/util_cs/bench_cs.rs: never
evaluates value or annotation closures, never builds LCs."""

from __future__ import annotations

from ..constraint_system import ConstraintSystem
from ..fields import SCALAR, PrimeField
from ..lc import Index, Variable


class BenchCS(ConstraintSystem):
    def __init__(self, field: PrimeField = SCALAR):
        self.field = field
        self._inputs = 1
        self._aux = 0
        self._a = 0
        self._b = 0
        self._c = 0

    def alloc_within(self, _prefix, _annotation, _f) -> Variable:
        self._aux += 1
        return Variable(Index.aux(self._aux - 1))

    def alloc_input_within(self, _prefix, _annotation, _f) -> Variable:
        self._inputs += 1
        return Variable(Index.input(self._inputs - 1))

    def enforce_within(self, _prefix, _annotation, _a, _b, _c) -> None:
        self._a += 1
        self._b += 1
        self._c += 1

    def register_namespace(self, prefix) -> None:
        pass

    def num_constraints(self) -> int:
        return self._a

    def num_inputs(self) -> int:
        return self._inputs

    def num_aux(self) -> int:
        return self._aux
