"""The compiled R1CS data types of the port.

Copies of ``COOMatrix`` and ``R1CS`` from ``bellpepper_tpu/r1cs.py``
(the data only; the Python constraint-system layer that builds them there,
``ShapeCS``, is not ported: the port synthesizes through
``native.NativeBuilder``). Every function of the port reads a template
through these fields alone, so the JAX package's ``R1CS`` objects work
too."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .fields import PrimeField


@dataclass
class COOMatrix:
    rows: np.ndarray  # int32[E]
    cols: np.ndarray  # int32[E]: global columns (inputs then aux)
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
    names: Optional[List[str]] = None

    @property
    def num_vars(self) -> int:
        return self.num_inputs + self.num_aux

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
