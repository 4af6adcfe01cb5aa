"""MetricCS — records the constraint *shape* + names, never values.

Re-design of reference crates/bellpepper/src/util_cs/metric_cs.rs: the
"blank twin" used with Comparable.delta to diff a valued CS against a
shape-only CS. Value closures are never invoked (metric_cs.rs:225-247)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..constraint_system import (
    ConstraintSystem,
    build_lc,
    compute_path,
    resolve_annotation,
)
from ..fields import SCALAR, PrimeField
from ..lc import AUX, INPUT, Index, LinearCombination, Variable
from . import Comparable, Constraint

_NS = "namespace"


class MetricCS(ConstraintSystem, Comparable):
    def __init__(self, field: PrimeField = SCALAR):
        self.field = field
        self.named_objects: Dict[str, object] = {"ONE": ConstraintSystem.one()}
        self._current_namespace: List[str] = []
        self._constraints: List[Constraint] = []
        self._inputs: List[str] = ["ONE"]
        self._aux: List[str] = []

    def _set_named_obj(self, path: str, obj) -> None:
        if path in self.named_objects:
            raise AssertionError(f"tried to create object at existing path: {path}")
        self.named_objects[path] = obj

    def register_namespace(self, prefix: Tuple[str, ...]) -> None:
        path = compute_path(prefix[:-1], prefix[-1])
        self._set_named_obj(path, _NS)

    def alloc_within(self, prefix, annotation, _f) -> Variable:
        path = compute_path(prefix, resolve_annotation(annotation))
        self._aux.append(path)
        return Variable(Index.aux(len(self._aux) - 1))

    def alloc_input_within(self, prefix, annotation, _f) -> Variable:
        path = compute_path(prefix, resolve_annotation(annotation))
        self._inputs.append(path)
        return Variable(Index.input(len(self._inputs) - 1))

    def enforce_within(self, prefix, annotation, a, b, c) -> None:
        path = compute_path(prefix, resolve_annotation(annotation))
        self._set_named_obj(path, len(self._constraints))
        self._constraints.append(
            Constraint(
                build_lc(a, self.field),
                build_lc(b, self.field),
                build_lc(c, self.field),
                path,
            )
        )

    # -- introspection ------------------------------------------------------
    def num_constraints(self) -> int:
        return len(self._constraints)

    def num_inputs(self) -> int:
        return len(self._inputs)

    def num_aux(self) -> int:
        return len(self._aux)

    def inputs(self) -> List[str]:
        return list(self._inputs)

    def aux(self) -> List[str]:
        return list(self._aux)

    def constraints(self) -> List[Constraint]:
        return self._constraints

    def pretty_print_list(self) -> List[str]:
        out = [f"INPUT {name}" for name in self._inputs]
        out += [f"AUX {name}" for name in self._aux]
        out += [c.name for c in self._constraints]
        return out

    def pretty_print(self) -> str:
        """Render every constraint as (A) * (B) = (C), with power-of-two
        coefficient detection (metric_cs.rs:130-195)."""
        from .test_cs import proc_lc

        field = self.field
        negone = field.p - 1
        pow2 = {pow(2, i, field.p): i for i in range(field.NUM_BITS)}

        lines = [f"INPUT {name}" for name in self._inputs]

        def pp(lc: LinearCombination) -> str:
            s = "("
            is_first = True
            for (tag, idx), coeff in proc_lc(lc):
                if coeff == negone:
                    s += " - "
                elif not is_first:
                    s += " + "
                is_first = False
                if coeff != 1 and coeff != negone:
                    if coeff in pow2:
                        s += f"2^{pow2[coeff]} . "
                    s += f"{coeff:#x} . "
                name = self._inputs[idx] if tag == INPUT else self._aux[idx]
                s += f"`I{name}`" if tag == INPUT else f"`A{name}`"
            if is_first:
                s += "0"
            return s + ")"

        body = []
        for a, b, c, name in self._constraints:
            body.append(f"{name}: {pp(a)} * {pp(b)} = {pp(c)}")
        return "\n".join(lines) + "\n" + "\n".join(body) + "\n"
