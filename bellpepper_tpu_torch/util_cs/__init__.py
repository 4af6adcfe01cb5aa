"""Constraint-system backends and CS-comparison utilities.

Mirrors reference crates/bellpepper-core/src/util_cs/mod.rs and
crates/bellpepper/src/util_cs/*."""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

from ..lc import LinearCombination


class Constraint(NamedTuple):
    """(A, B, C, name) — one R1CS row (util_cs/mod.rs:6-11)."""

    a: LinearCombination
    b: LinearCombination
    c: LinearCombination
    name: str


class Delta:
    """Result of comparing two constraint systems (util_cs/mod.rs:79-87)."""

    __slots__ = ("kind", "info")

    EQUAL = "Equal"
    DIFFERENT = "Different"
    INPUT_COUNT_MISMATCH = "InputCountMismatch"
    CONSTRAINT_COUNT_MISMATCH = "ConstraintCountMismatch"
    CONSTRAINT_MISMATCH = "ConstraintMismatch"

    def __init__(self, kind: str, info: tuple = ()):
        self.kind = kind
        self.info = info

    def __eq__(self, other) -> bool:
        if isinstance(other, str):
            return self.kind == other
        return isinstance(other, Delta) and self.kind == other.kind and self.info == other.info

    def __repr__(self) -> str:
        return f"Delta.{self.kind}{self.info if self.info else ''}"

    def is_equal(self) -> bool:
        return self.kind == Delta.EQUAL


Delta.Equal = Delta(Delta.EQUAL)
Delta.Different = Delta(Delta.DIFFERENT)


class Comparable:
    """CS-equivalence debugging mixin (util_cs/mod.rs:13-77).

    Subclasses provide num_inputs/num_constraints/inputs/aux/constraints;
    `delta` diffs two systems, useful when a CS is satisfied but the
    downstream proof does not verify."""

    def num_inputs(self) -> int:
        raise NotImplementedError

    def num_constraints(self) -> int:
        raise NotImplementedError

    def inputs(self) -> List[str]:
        raise NotImplementedError

    def aux(self) -> List[str]:
        raise NotImplementedError

    def constraints(self) -> Sequence[Constraint]:
        raise NotImplementedError

    def delta(self, other: "Comparable", ignore_counts: bool) -> Delta:
        input_count_matches = self.num_inputs() == other.num_inputs()
        constraint_count_matches = self.num_constraints() == other.num_constraints()
        inputs_match = self.inputs() == other.inputs()
        constraints_match = list(self.constraints()) == list(other.constraints())

        equal = (
            input_count_matches
            and constraint_count_matches
            and inputs_match
            and constraints_match
        )

        if not ignore_counts and not input_count_matches:
            return Delta(
                Delta.INPUT_COUNT_MISMATCH, (self.num_inputs(), other.num_inputs())
            )
        if not ignore_counts and not constraint_count_matches:
            return Delta(
                Delta.CONSTRAINT_COUNT_MISMATCH,
                (self.num_constraints(), other.num_constraints()),
            )
        if not constraints_match:
            for i, (mine, theirs) in enumerate(zip(self.constraints(), other.constraints())):
                if mine != theirs:
                    return Delta(Delta.CONSTRAINT_MISMATCH, (i, mine, theirs))
            raise AssertionError("constraint mismatch not found despite inequality")
        if equal:
            return Delta.Equal
        return Delta.Different


from .test_cs import TestConstraintSystem  # noqa: E402
from .metric_cs import MetricCS  # noqa: E402
from .bench_cs import BenchCS  # noqa: E402
from .witness_cs import SizedWitness, WitnessCS  # noqa: E402

__all__ = [
    "Constraint",
    "Delta",
    "Comparable",
    "TestConstraintSystem",
    "MetricCS",
    "BenchCS",
    "WitnessCS",
    "SizedWitness",
]
