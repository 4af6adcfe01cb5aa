"""R1CS compilation: from recorded constraints to device-ready sparse
matrices.

A copy of ``bellpepper_tpu/r1cs.py`` (the port imports nothing of the JAX
package). Constraints become three COO sparse matrices A, B, C over a
global column space (inputs first, then aux, matching `extend`'s merge
order, witness_cs.rs:158-163), and coefficients are deduplicated into a
small table (circuits built from the gadget library use only a handful of
distinct coefficients: ±1, ±2^i, lookup constants). The port's checks read
these arrays on the card (``backend``).

`ShapeCS` is the production compile backend: it records structure at full
speed — no path strings, no name registry, no value evaluation. Every
function of the port reads a template through the fields of ``R1CS``
alone, so ``native.NativeBuilder``'s templates and the JAX package's
``R1CS`` objects work too."""

from __future__ import annotations

from dataclasses import dataclass, field as dataclass_field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .constraint_system import ConstraintSystem, build_lc
from .fields import SCALAR, PrimeField
from .lc import Index, LinearCombination, Variable


class ShapeCS(ConstraintSystem):
    """Structure-only recording backend, optimized for compile speed.

    Like MetricCS it never evaluates value closures; unlike MetricCS it
    never resolves annotations either (the reference's laziness contract
    taken to its conclusion) and emits COO triples directly."""

    def __init__(self, field: PrimeField = SCALAR):
        self.field = field
        self.num_inputs = 1  # ONE
        self.num_aux = 0
        # Per-matrix COO buffers (python lists; frozen into numpy at finish).
        self.rows: Dict[str, List[int]] = {"a": [], "b": [], "c": []}
        self.cols: Dict[str, List[int]] = {"a": [], "b": [], "c": []}
        self.coeff_ids: Dict[str, List[int]] = {"a": [], "b": [], "c": []}
        self.coeff_table: List[int] = [1]
        self._coeff_lookup: Dict[int, int] = {1: 0}
        self.num_constraints = 0

    def alloc_within(self, _prefix, _annotation, _f) -> Variable:
        self.num_aux += 1
        return Variable(Index.aux(self.num_aux - 1))

    def alloc_input_within(self, _prefix, _annotation, _f) -> Variable:
        self.num_inputs += 1
        return Variable(Index.input(self.num_inputs - 1))

    def register_namespace(self, prefix) -> None:
        pass

    def _coeff_id(self, coeff: int) -> int:
        cid = self._coeff_lookup.get(coeff)
        if cid is None:
            cid = len(self.coeff_table)
            self.coeff_table.append(coeff)
            self._coeff_lookup[coeff] = cid
        return cid

    def _record(self, mat: str, row: int, lc: LinearCombination) -> None:
        rows = self.rows[mat]
        cols = self.cols[mat]
        cids = self.coeff_ids[mat]
        for k, v in lc.inputs.iter():
            if v == 0:
                continue
            rows.append(row)
            cols.append(k)  # input columns are global columns 0..num_inputs
            cids.append(self._coeff_id(v))
        for k, v in lc.aux.iter():
            if v == 0:
                continue
            rows.append(row)
            cols.append(~k)  # aux marked with bitwise-not; fixed in finish()
            cids.append(self._coeff_id(v))

    def enforce_within(self, _prefix, _annotation, a, b, c) -> None:
        row = self.num_constraints
        self.num_constraints += 1
        f = self.field
        self._record("a", row, build_lc(a, f))
        self._record("b", row, build_lc(b, f))
        self._record("c", row, build_lc(c, f))

    def finish(self) -> "R1CS":
        mats = {}
        for m in ("a", "b", "c"):
            cols = np.asarray(self.cols[m], dtype=np.int64)
            # Aux columns were stored as ~idx; global col = num_inputs + idx.
            neg = cols < 0
            cols = np.where(neg, self.num_inputs + (~cols), cols)
            mats[m] = COOMatrix(
                rows=np.asarray(self.rows[m], dtype=np.int32),
                cols=cols.astype(np.int32),
                coeff_ids=np.asarray(self.coeff_ids[m], dtype=np.int32),
            )
        return R1CS(
            field=self.field,
            num_inputs=self.num_inputs,
            num_aux=self.num_aux,
            num_constraints=self.num_constraints,
            a=mats["a"],
            b=mats["b"],
            c=mats["c"],
            coeff_table=list(self.coeff_table),
            names=None,
        )


@dataclass
class COOMatrix:
    rows: np.ndarray  # int32[E]
    cols: np.ndarray  # int32[E] — global columns (inputs then aux)
    coeff_ids: np.ndarray  # int32[E] into the shared coeff table

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])


@dataclass
class R1CS:
    """A compiled rank-1 constraint system: A·z ∘ B·z = C·z with
    z = inputs ++ aux."""

    field: PrimeField
    num_inputs: int
    num_aux: int
    num_constraints: int
    a: COOMatrix
    b: COOMatrix
    c: COOMatrix
    coeff_table: List[int]
    names: Optional[List[str]] = None  # constraint paths if compiled w/ names

    @property
    def num_vars(self) -> int:
        return self.num_inputs + self.num_aux

    @staticmethod
    def from_constraints(
        constraints: Sequence,
        num_inputs: int,
        num_aux: int,
        field: PrimeField,
    ) -> "R1CS":
        """Compile from a named recording CS's constraint list
        (TestConstraintSystem.constraints() / MetricCS.constraints())."""
        shape = ShapeCS(field)
        shape.num_inputs = num_inputs
        shape.num_aux = num_aux
        names = []
        for a, b, c, name in constraints:
            row = shape.num_constraints
            shape.num_constraints += 1
            shape._record("a", row, a)
            shape._record("b", row, b)
            shape._record("c", row, c)
            names.append(name)
        out = shape.finish()
        out.names = names
        return out

    @staticmethod
    def from_test_cs(cs) -> "R1CS":
        return R1CS.from_constraints(
            cs.constraints(), cs.num_inputs(), cs.num_aux(), cs.field
        )

    def replicate(self, n: int) -> "R1CS":
        """n independent copies of this input-free template as one R1CS
        (rows and aux columns offset a copy, ONE shared, no names): the
        reference's ``R1CS.replicate``, the compiled form of synthesizing
        n disjoint copies (constraint_system.rs:138-148)."""
        if self.num_inputs != 1:
            raise ValueError("replicate requires an input-free template")
        mats = {}
        for name in ("a", "b", "c"):
            m = getattr(self, name)
            is_aux = m.cols >= self.num_inputs
            mats[name] = COOMatrix(
                rows=np.concatenate([m.rows + np.int32(i * self.num_constraints) for i in range(n)]),
                cols=np.concatenate([np.where(is_aux, m.cols + np.int32(i * self.num_aux), m.cols)
                                     for i in range(n)]),
                coeff_ids=np.tile(m.coeff_ids, n),
            )
        return R1CS(field=self.field, num_inputs=1, num_aux=self.num_aux * n,
                    num_constraints=self.num_constraints * n, coeff_table=list(self.coeff_table), **mats)

    def extend(self, other: "R1CS") -> "R1CS":
        """Concatenate another compiled R1CS after this one (index-offset
        relabeling; the compiled form of WitnessCS::extend)."""
        assert other.field.p == self.field.p
        # Merge coefficient tables.
        remap = {}
        table = list(self.coeff_table)
        lookup = {c: i for i, c in enumerate(table)}
        for i, cfc in enumerate(other.coeff_table):
            j = lookup.get(cfc)
            if j is None:
                j = len(table)
                table.append(cfc)
                lookup[cfc] = j
            remap[i] = j
        remap_arr = np.asarray(
            [remap[i] for i in range(len(other.coeff_table))], dtype=np.int32
        )

        in_off = self.num_inputs - 1  # other's ONE aliases ours
        aux_off = self.num_aux
        row_off = self.num_constraints
        mats = {}
        for name in ("a", "b", "c"):
            mine: COOMatrix = getattr(self, name)
            theirs: COOMatrix = getattr(other, name)
            t_is_aux = theirs.cols >= other.num_inputs
            # Global column remap for `theirs`:
            #   input 0 (ONE) → 0; input i>0 → in_off + i;
            #   aux j → (num_inputs_total) + aux_off + j.
            new_inputs_total = self.num_inputs + other.num_inputs - 1
            t_cols = np.where(
                t_is_aux,
                theirs.cols - other.num_inputs + new_inputs_total + aux_off,
                np.where(theirs.cols == 0, 0, theirs.cols + in_off),
            )
            # My aux columns shift because the input block grows.
            m_is_aux = mine.cols >= self.num_inputs
            m_cols = np.where(
                m_is_aux, mine.cols + (other.num_inputs - 1), mine.cols
            )
            mats[name] = COOMatrix(
                rows=np.concatenate([mine.rows, theirs.rows + np.int32(row_off)]),
                cols=np.concatenate([m_cols, t_cols]).astype(np.int32),
                coeff_ids=np.concatenate(
                    [mine.coeff_ids, remap_arr[theirs.coeff_ids]]
                ),
            )
        names = None
        if self.names is not None and other.names is not None:
            names = list(self.names) + list(other.names)
        return R1CS(
            field=self.field,
            num_inputs=self.num_inputs + other.num_inputs - 1,
            num_aux=self.num_aux + other.num_aux,
            num_constraints=self.num_constraints + other.num_constraints,
            a=mats["a"],
            b=mats["b"],
            c=mats["c"],
            coeff_table=table,
            names=names,
        )

    # -- host oracle ---------------------------------------------------------
    def eval_host(self, inputs: List[int], aux: List[int]) -> Tuple[bool, Optional[int]]:
        """Reference satisfiability check with python ints (slow; for
        tests). Returns (satisfied, first_failing_row)."""
        p = self.field.p
        z = list(inputs) + list(aux)
        sums = {m: [0] * self.num_constraints for m in "abc"}
        for m in "abc":
            mat: COOMatrix = getattr(self, m)
            s = sums[m]
            ct = self.coeff_table
            for r, cl, ci in zip(mat.rows, mat.cols, mat.coeff_ids):
                s[r] = (s[r] + ct[ci] * z[cl]) % p
        for r in range(self.num_constraints):
            if (sums["a"][r] * sums["b"][r] - sums["c"][r]) % p != 0:
                return False, r
        return True, None
