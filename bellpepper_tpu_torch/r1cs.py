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
