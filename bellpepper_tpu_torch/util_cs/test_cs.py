"""TestConstraintSystem — the named, eager oracle backend.

Re-design of reference crates/bellpepper-core/src/util_cs/test_cs.rs.
Everything user-visible is preserved: path registry semantics, the
satisfiability check, mutation probing (set/get/verify), pretty printing,
and — bit-for-bit — the Blake2s circuit-shape fingerprint (test_cs.rs:64-115,
214-237), which downstream systems use to pin circuit shapes.

The per-constraint evaluation here is the host *oracle*; the production
satisfiability path is the device check (bellpepper_tpu_torch.backend)."""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Optional, Tuple

from ..constraint_system import (
    ConstraintSystem,
    build_lc,
    compute_path,
    resolve_annotation,
    resolve_value,
)
from ..fields import SCALAR, PrimeField
from ..lc import AUX, INPUT, Index, LinearCombination, Variable
from . import Comparable, Constraint

_NS = "namespace"


def proc_lc(lc: LinearCombination) -> List[Tuple[Tuple[int, int], int]]:
    """Normalize an LC: merge duplicate variables, drop zero coefficients,
    sort inputs-before-aux then by index (test_cs.rs:64-87).

    Our Indexers are already sorted and merged, so this only filters zeros
    and concatenates in OrderedVariable order."""
    out = []
    for k, v in lc.inputs.iter():
        if v != 0:
            out.append(((INPUT, k), v))
    for k, v in lc.aux.iter():
        if v != 0:
            out.append(((AUX, k), v))
    return out


def hash_lc(lc: LinearCombination, h, field: PrimeField) -> None:
    """Feed one normalized LC into the Blake2s state (test_cs.rs:89-115).

    Layout: u64-BE term count, then per term: b'I'/b'A' tag, u64-BE index,
    32 big-endian coefficient bytes."""
    terms = proc_lc(lc)
    h.update(struct.pack(">Q", len(terms)))
    for (tag, idx), coeff in terms:
        buf = (b"I" if tag == INPUT else b"A") + struct.pack(">Q", idx) + field.to_be_bytes(coeff)
        h.update(buf)


class TestConstraintSystem(ConstraintSystem, Comparable):
    """Oracle CS: stores values + names for every variable and constraint."""

    __test__ = False  # not a pytest class, despite the name

    def __init__(self, field: PrimeField = SCALAR):
        self.field = field
        self.named_objects: Dict[str, object] = {"ONE": ConstraintSystem.one()}
        self._current_namespace: List[str] = []
        self._constraints: List[Constraint] = []
        # (value, path) per variable, like test_cs.rs:31-32.
        self._inputs: List[Tuple[int, str]] = [(field.ONE, "ONE")]
        self._aux: List[Tuple[int, str]] = []

    # -- recording ----------------------------------------------------------
    def _set_named_obj(self, path: str, obj) -> None:
        if path in self.named_objects:
            raise AssertionError(f"tried to create object at existing path: {path}")
        self.named_objects[path] = obj

    def register_namespace(self, prefix: Tuple[str, ...]) -> None:
        path = compute_path(prefix[:-1], prefix[-1])
        self._set_named_obj(path, _NS)

    def alloc_within(self, prefix, annotation, f) -> Variable:
        index = len(self._aux)
        path = compute_path(prefix, resolve_annotation(annotation))
        self._aux.append((resolve_value(f) % self.field.p, path))
        var = Variable(Index.aux(index))
        self._set_named_obj(path, var)
        return var

    def alloc_input_within(self, prefix, annotation, f) -> Variable:
        index = len(self._inputs)
        path = compute_path(prefix, resolve_annotation(annotation))
        self._inputs.append((resolve_value(f) % self.field.p, path))
        var = Variable(Index.input(index))
        self._set_named_obj(path, var)
        return var

    def enforce_within(self, prefix, annotation, a, b, c) -> None:
        path = compute_path(prefix, resolve_annotation(annotation))
        index = len(self._constraints)
        self._set_named_obj(path, index)
        self._constraints.append(
            Constraint(
                build_lc(a, self.field),
                build_lc(b, self.field),
                build_lc(c, self.field),
                path,
            )
        )

    # -- evaluation / oracle --------------------------------------------------
    def _eval_lc(self, lc: LinearCombination) -> int:
        p = self.field.p
        acc = 0
        for k, v in lc.inputs.iter():
            acc += v * self._inputs[k][0]
        for k, v in lc.aux.iter():
            acc += v * self._aux[k][0]
        return acc % p

    def which_is_unsatisfied(self) -> Optional[str]:
        """First failing constraint path, or None (test_cs.rs:239-253)."""
        p = self.field.p
        for a, b, c, path in self._constraints:
            if (self._eval_lc(a) * self._eval_lc(b) - self._eval_lc(c)) % p != 0:
                return path
        return None

    def is_satisfied(self) -> bool:
        failed = self.which_is_unsatisfied()
        if failed is not None:
            print(f"fail: {failed!r}")
            return False
        return True

    # -- mutation probing -------------------------------------------------------
    def set(self, path: str, to: int) -> None:
        obj = self.named_objects.get(path)
        if obj is None:
            raise AssertionError(f"no variable exists at path: {path}")
        if not isinstance(obj, Variable):
            raise AssertionError(
                f"tried to set path `{path}` to value, but `{obj!r}` already exists there."
            )
        idx = obj.index
        to = to % self.field.p
        if idx.tag == INPUT:
            self._inputs[idx.idx] = (to, self._inputs[idx.idx][1])
        else:
            self._aux[idx.idx] = (to, self._aux[idx.idx][1])

    def get(self, path: str) -> int:
        obj = self.named_objects.get(path)
        if obj is None:
            raise AssertionError(f"no variable exists at path: {path}")
        if not isinstance(obj, Variable):
            raise AssertionError(
                f"tried to get value of path `{path}`, but `{obj!r}` exists there (not a variable)"
            )
        idx = obj.index
        return self._inputs[idx.idx][0] if idx.tag == INPUT else self._aux[idx.idx][0]

    def get_input(self, index: int, path: str) -> int:
        value, name = self._inputs[index]
        assert path == name
        return value

    def get_inputs(self) -> List[Tuple[int, str]]:
        return list(self._inputs)

    def verify(self, expected: List[int]) -> bool:
        """Check public inputs (skipping ONE) match (test_cs.rs:284-293)."""
        assert len(expected) + 1 == len(self._inputs)
        return all(
            a[0] == b % self.field.p for a, b in zip(self._inputs[1:], expected)
        )

    # -- introspection -----------------------------------------------------------
    def num_constraints(self) -> int:
        return len(self._constraints)

    def num_inputs(self) -> int:
        return len(self._inputs)

    def num_aux(self) -> int:
        return len(self._aux)

    def scalar_inputs(self) -> List[int]:
        return [v for v, _ in self._inputs]

    def scalar_aux(self) -> List[int]:
        return [v for v, _ in self._aux]

    def inputs(self) -> List[str]:
        return [name for _, name in self._inputs]

    def aux(self) -> List[str]:
        return [name for _, name in self._aux]

    def constraints(self) -> List[Constraint]:
        return self._constraints

    def pretty_print_list(self) -> List[str]:
        out = [f"INPUT {name}" for _, name in self._inputs]
        out += [f"AUX {name}" for _, name in self._aux]
        out += [c.name for c in self._constraints]
        return out

    def pretty_print(self) -> str:
        return "\n".join(self.pretty_print_list())

    # -- shape fingerprint ----------------------------------------------------------
    def hash(self) -> str:
        """Blake2s hex digest over the normalized CS shape
        (test_cs.rs:214-237). Bit-compatible with the reference:
        header = u64-BE (num_inputs, num_aux, num_constraints), then each
        constraint's A, B, C via hash_lc."""
        h = hashlib.blake2s()
        h.update(
            struct.pack(
                ">QQQ",
                len(self._inputs),
                len(self._aux),
                len(self._constraints),
            )
        )
        for a, b, c, _name in self._constraints:
            hash_lc(a, h, self.field)
            hash_lc(b, h, self.field)
            hash_lc(c, h, self.field)
        return h.hexdigest()
