"""Variables, indices, and linear combinations.

A copy of ``bellpepper_tpu/lc.py`` (the port imports nothing of the JAX
package): the re-design of the reference's core R1CS vocabulary
(reference: crates/bellpepper-core/src/lc.rs):

  - ``Index`` — input vs aux variable index (lc.rs:27-30). Here a tiny
    immutable tagged value instead of a Rust enum.
  - ``Variable`` — newtype over Index (lc.rs:8).
  - ``Indexer`` — sparse (index → coefficient) map with a
    sequential-insert fast path (lc.rs:40-122).  Kept because synthesis
    mostly appends ascending indices; coefficient values are canonical
    ints mod p.
  - ``LinearCombination`` — two Indexers (inputs + aux) over a field
    (lc.rs:32-375), with the same operator surface:
    ``lc + var``, ``lc + (coeff, var)``, ``lc + other_lc``,
    ``lc + (coeff, other_lc)`` and the ``-`` duals.

Unlike the reference (which moves `self`), Python operators copy; the
in-place ``iadd_*`` methods are the zero-copy path used by our gadgets'
hot loops (addmany / multieq accumulation).

Downstream, LCs are flattened into COO sparse matrices for the device
(see bellpepper_tpu_torch.r1cs)."""

from __future__ import annotations

from bisect import bisect_left
from typing import Iterator, Tuple

from .fields import PrimeField

INPUT = 0
AUX = 1


class Index:
    """Index of an input (public) or aux (private) variable. lc.rs:27-30."""

    __slots__ = ("tag", "idx")

    def __init__(self, tag: int, idx: int):
        self.tag = tag
        self.idx = idx

    @staticmethod
    def input(i: int) -> "Index":
        return Index(INPUT, i)

    @staticmethod
    def aux(i: int) -> "Index":
        return Index(AUX, i)

    def is_input(self) -> bool:
        return self.tag == INPUT

    def is_aux(self) -> bool:
        return self.tag == AUX

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Index) and self.tag == other.tag and self.idx == other.idx
        )

    def __hash__(self) -> int:
        return hash((self.tag, self.idx))

    def __repr__(self) -> str:
        return f"Input({self.idx})" if self.tag == INPUT else f"Aux({self.idx})"

    # Ordering used by the shape hash / pretty printing: all inputs sort
    # before all aux variables (test_cs.rs:53-62 OrderedVariable).
    def order_key(self) -> Tuple[int, int]:
        return (self.tag, self.idx)

    # -- serde parity (lc.rs:26 `#[derive(Serialize, Deserialize)]`) ------
    # Matches serde_json's externally-tagged enum encoding of
    # `Index::Input(usize) | Aux(usize)`: {"Input": i} / {"Aux": i}.
    def to_json(self) -> dict:
        return {"Input" if self.tag == INPUT else "Aux": self.idx}

    @staticmethod
    def from_json(obj: dict) -> "Index":
        if "Input" in obj:
            return Index.input(int(obj["Input"]))
        if "Aux" in obj:
            return Index.aux(int(obj["Aux"]))
        raise ValueError(f"not an Index: {obj!r}")


class Variable:
    """A variable in the constraint system. lc.rs:7-22."""

    __slots__ = ("index",)

    def __init__(self, index: Index):
        self.index = index

    @staticmethod
    def new_unchecked(index: Index) -> "Variable":
        return Variable(index)

    # -- serde parity (lc.rs:7) -------------------------------------------
    # `Variable(pub Index)` is a newtype: serde serializes it transparently
    # as the inner Index.
    def to_json(self) -> dict:
        return self.index.to_json()

    @staticmethod
    def from_json(obj: dict) -> "Variable":
        return Variable(Index.from_json(obj))

    def get_unchecked(self) -> Index:
        return self.index

    def __eq__(self, other) -> bool:
        return isinstance(other, Variable) and self.index == other.index

    def __hash__(self) -> int:
        return hash(self.index)

    def __repr__(self) -> str:
        return f"Variable({self.index!r})"


class Indexer:
    """Sorted sparse (index → coefficient) store. lc.rs:40-122.

    Keeps parallel ``keys``/``values`` lists sorted by key, plus a
    ``last_inserted`` (position, key) cache so the common
    ascending-index insertion pattern is O(1) amortized
    (lc.rs:74-113 insert_or_update)."""

    __slots__ = ("keys", "values", "last_inserted")

    def __init__(self):
        self.keys: list[int] = []
        self.values: list[int] = []
        self.last_inserted: tuple[int, int] | None = None

    @staticmethod
    def from_value(index: int, value: int) -> "Indexer":
        ix = Indexer()
        ix.keys.append(index)
        ix.values.append(value)
        ix.last_inserted = (0, index)
        return ix

    def copy(self) -> "Indexer":
        ix = Indexer()
        ix.keys = self.keys[:]
        ix.values = self.values[:]
        ix.last_inserted = self.last_inserted
        return ix

    def add(self, key: int, coeff: int, p: int) -> None:
        """insert_or_update with update = add-mod-p (lc.rs:184-193)."""
        last = self.last_inserted
        if last is not None:
            last_index, last_key = last
            if last_key == key:
                self.values[last_index] = (self.values[last_index] + coeff) % p
                return
            if last_key + 1 == key:
                i = last_index + 1
                if i >= len(self.keys):
                    self.keys.append(key)
                    self.values.append(coeff % p)
                    self.last_inserted = (i, key)
                elif self.keys[i] == key:
                    self.values[i] = (self.values[i] + coeff) % p
                else:
                    self.keys.insert(i, key)
                    self.values.insert(i, coeff % p)
                    self.last_inserted = (i, key)
                return
        i = bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            self.values[i] = (self.values[i] + coeff) % p
        else:
            self.keys.insert(i, key)
            self.values.insert(i, coeff % p)
            self.last_inserted = (i, key)

    def __len__(self) -> int:
        return len(self.keys)

    def is_empty(self) -> bool:
        return not self.keys

    def iter(self) -> Iterator[Tuple[int, int]]:
        return zip(self.keys, self.values)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Indexer)
            and self.keys == other.keys
            and self.values == other.values
        )


class LinearCombination:
    """Σ coeff·var over a prime field. lc.rs:32-375.

    Stores inputs and aux terms in separate Indexers (lc.rs:35-38) so the
    COO flattening can assign global column ids (inputs first, then aux)
    without re-sorting."""

    __slots__ = ("field", "inputs", "aux")

    def __init__(self, field: PrimeField):
        self.field = field
        self.inputs = Indexer()
        self.aux = Indexer()

    @staticmethod
    def zero(field: PrimeField) -> "LinearCombination":
        return LinearCombination(field)

    @staticmethod
    def from_coeff(field: PrimeField, var: Variable, coeff: int) -> "LinearCombination":
        lc = LinearCombination(field)
        if var.index.tag == INPUT:
            lc.inputs = Indexer.from_value(var.index.idx, coeff % field.p)
        else:
            lc.aux = Indexer.from_value(var.index.idx, coeff % field.p)
        return lc

    @staticmethod
    def from_variable(field: PrimeField, var: Variable) -> "LinearCombination":
        return LinearCombination.from_coeff(field, var, 1)

    def copy(self) -> "LinearCombination":
        lc = LinearCombination(self.field)
        lc.inputs = self.inputs.copy()
        lc.aux = self.aux.copy()
        return lc

    # -- iteration ---------------------------------------------------------
    def iter(self) -> Iterator[Tuple[Variable, int]]:
        """All terms, inputs first then aux (lc.rs:155-160)."""
        for k, v in self.inputs.iter():
            yield Variable(Index(INPUT, k)), v
        for k, v in self.aux.iter():
            yield Variable(Index(AUX, k)), v

    def iter_inputs(self) -> Iterator[Tuple[int, int]]:
        return self.inputs.iter()

    def iter_aux(self) -> Iterator[Tuple[int, int]]:
        return self.aux.iter()

    def __len__(self) -> int:
        return len(self.inputs) + len(self.aux)

    def is_empty(self) -> bool:
        return self.inputs.is_empty() and self.aux.is_empty()

    # -- in-place builders (the gadget hot path) ----------------------------
    def iadd_term(self, var: Variable, coeff: int = 1) -> "LinearCombination":
        """add_unsimplified (lc.rs:195-209), mutating."""
        if var.index.tag == INPUT:
            self.inputs.add(var.index.idx, coeff, self.field.p)
        else:
            self.aux.add(var.index.idx, coeff, self.field.p)
        return self

    def isub_term(self, var: Variable, coeff: int = 1) -> "LinearCombination":
        return self.iadd_term(var, self.field.p - (coeff % self.field.p))

    def iadd_lc(self, other: "LinearCombination", scale: int | None = None) -> "LinearCombination":
        """``self += scale * other`` (lc.rs:303-317, 335-354), mutating."""
        p = self.field.p
        if scale is None:
            for k, v in other.inputs.iter():
                self.inputs.add(k, v, p)
            for k, v in other.aux.iter():
                self.aux.add(k, v, p)
        else:
            s = scale % p
            for k, v in other.inputs.iter():
                self.inputs.add(k, (v * s) % p, p)
            for k, v in other.aux.iter():
                self.aux.add(k, (v * s) % p, p)
        return self

    def isub_lc(self, other: "LinearCombination", scale: int | None = None) -> "LinearCombination":
        p = self.field.p
        s = 1 if scale is None else scale % p
        return self.iadd_lc(other, p - s if s != 0 else 0)

    # -- operator surface (copying, like gadget-level Rust usage) -----------
    def _apply(self, other, sign: int) -> "LinearCombination":
        out = self.copy()
        p = self.field.p
        if isinstance(other, Variable):
            out.iadd_term(other, 1 if sign > 0 else p - 1)
        elif isinstance(other, LinearCombination):
            out.iadd_lc(other) if sign > 0 else out.isub_lc(other)
        elif isinstance(other, tuple) and len(other) == 2:
            coeff, target = other
            coeff = coeff % p
            if isinstance(target, Variable):
                out.iadd_term(target, coeff if sign > 0 else p - coeff if coeff else 0)
            elif isinstance(target, LinearCombination):
                out.iadd_lc(target, coeff) if sign > 0 else out.isub_lc(target, coeff)
            else:
                raise TypeError(f"cannot add {other!r} to LinearCombination")
        else:
            raise TypeError(f"cannot add {other!r} to LinearCombination")
        return out

    def __add__(self, other) -> "LinearCombination":
        return self._apply(other, +1)

    def __sub__(self, other) -> "LinearCombination":
        return self._apply(other, -1)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, LinearCombination)
            and self.inputs == other.inputs
            and self.aux == other.aux
        )

    # -- evaluation ----------------------------------------------------------
    def eval(self, input_assignment, aux_assignment) -> int:
        """Σ coeff·assignment (lc.rs:245-267). Host-side oracle; the
        production path is the device sparse matvec in backend.matvec."""
        p = self.field.p
        acc = 0
        for k, v in self.inputs.iter():
            acc += input_assignment[k] if v == 1 else v * input_assignment[k]
        for k, v in self.aux.iter():
            acc += aux_assignment[k] if v == 1 else v * aux_assignment[k]
        return acc % p

    def __repr__(self) -> str:  # pragma: no cover
        terms = [f"{v}*{Variable(Index(INPUT, k))!r}" for k, v in self.inputs.iter()]
        terms += [f"{v}*{Variable(Index(AUX, k))!r}" for k, v in self.aux.iter()]
        return "LC(" + " + ".join(terms) + ")"
