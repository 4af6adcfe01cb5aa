"""The satisfiability checkers of one R1CS and of a template's batch.

Counterpart of ``bellpepper_tpu/backend/matvec.py``'s ``Satisfier``
(``:937-1007``, its Pallas route: the templated limbs check at batch 1)
with ``assemble_z`` (``:756``), and ``TemplatedSatisfier``
(``:3489-3570``). Both run on the CUDA card unless they are given a
device, and answer on the host (``is_satisfied`` and
``which_is_unsatisfied`` read the verdict back)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve
from ..r1cs import R1CS
from .field_backend import FieldBackend
from .matvec import build_templated_check
from .words import from_numpy_u32


def _row_name(r1cs: R1CS, row: int) -> str:
    return r1cs.names[row] if r1cs.names is not None else f"constraint #{row}"


def which_from_flat(template: R1CS, flat: int) -> str:
    """A flat violation index b·R + row as 'instance b: name'."""
    inst, row = divmod(int(flat), template.num_constraints)
    return f"instance {inst}: {_row_name(template, row)}"


class Satisfier:
    """Compiled satisfiability checker for one R1CS (inputs allowed): the
    templated limbs check of the whole system as one instance.
    ``which_is_unsatisfied`` names the first violated row, as
    TestConstraintSystem::which_is_unsatisfied does."""

    def __init__(self, r1cs: R1CS, device=None):
        self.r1cs = r1cs
        self.device = resolve(device)
        self.num_slots = r1cs.num_inputs + r1cs.num_aux
        self._check = (
            build_templated_check(r1cs, 1, "limbs", device=self.device) if r1cs.num_constraints else None
        )

    def z_from_assignments(self, inputs, aux) -> torch.Tensor:
        """Host witness → z = inputs ++ aux as canonical limbs int32[S, 16]
        on the checker's device."""
        return from_numpy_u32(FieldBackend.to_limbs(list(inputs) + list(aux)), self.device)

    def _verdict(self, z: torch.Tensor):
        if tuple(z.shape) != (self.num_slots, 16):
            raise ValueError(f"z must be int32[{self.num_slots}, 16], got {tuple(z.shape)}")
        if self._check is None:  # vacuously satisfied
            return 0, 0
        nb, first = self._check.verdict(z[None])
        return int(nb), int(first)

    def is_satisfied(self, z: torch.Tensor) -> bool:
        return self._verdict(z)[0] == 0

    def which_is_unsatisfied(self, z: torch.Tensor) -> Optional[str]:
        nb, first = self._verdict(z)
        return _row_name(self.r1cs, first) if nb else None


class TemplatedSatisfier:
    """Satisfiability checker for `batch` independent copies of one
    input-free template (slot 0 of every instance is ONE), in one witness
    form of ``build_templated_check``: ``"limbs"`` by default (z int32[B,
    S_t, 16] canonical limbs, any value in any slot), ``"mixed"`` (z =
    (vals, flimbs), with `field_slots`), ``"bits"`` (z int32[B, S_t] of
    0/1 values: a bit-valued witness domain only, see ``BitsCheck``) or
    ``"bits_packed"``."""

    def __init__(self, template: R1CS, batch: int, witness_form: Optional[str] = None,
                 field_slots=None, device=None):
        self.r1cs = template
        self.batch = batch
        self.witness_form = witness_form or "limbs"
        self.device = resolve(device)
        self.check = build_templated_check(template, batch, self.witness_form,
                                           field_slots=field_slots, device=self.device)
        self.num_constraints_total = batch * template.num_constraints

    def z_from_instances(self, z3) -> torch.Tensor:
        """Instance limbs (numpy uint32 or a tensor) as int32 words on the
        checker's device."""
        if isinstance(z3, np.ndarray):
            return from_numpy_u32(z3, self.device)
        return z3.to(device=self.device, dtype=torch.int32).contiguous()

    def _verdict(self, z):
        args = z if self.witness_form == "mixed" else (z,)
        if self.witness_form == "mixed" and not (isinstance(z, tuple) and len(z) == 2):
            raise ValueError("the mixed form takes z = (vals, flimbs)")
        nb, first = self.check.verdict(*args)
        return int(nb), int(first)

    def is_satisfied(self, z) -> bool:
        return self._verdict(z)[0] == 0

    def which_is_unsatisfied(self, z) -> Optional[str]:
        nb, first = self._verdict(z)
        return which_from_flat(self.r1cs, first) if nb else None
