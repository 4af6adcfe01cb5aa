"""The satisfiability checkers of one R1CS and of a template's batch.

Counterpart of ``bellpepper_tpu/backend/matvec.py``'s ``Satisfier``
(``:937-1007``) with ``assemble_z`` (``:756``), and ``TemplatedSatisfier``
(``:3489-3570``), with the reference's parameters and its precedence of
``config=``. Both run on the CUDA card unless they are given a device, and
answer on the host (``is_satisfied`` and ``which_is_unsatisfied`` read the
verdict back)."""

from __future__ import annotations

from typing import Optional

import torch

from ..device import check_use_pallas, resolve
from ..r1cs import R1CS
from .field_backend import get_backend
from .matvec import assemble_z, build_templated_check
from .row_chunked import DeviceR1CS, violation_mask
from .words import as_words


def _row_name(r1cs: R1CS, row: int) -> str:
    return r1cs.names[row] if r1cs.names is not None else f"constraint #{row}"


def which_from_flat(template: R1CS, flat: int) -> str:
    """A flat violation index b·R + row as 'instance b: name'."""
    inst, row = divmod(int(flat), template.num_constraints)
    return f"instance {inst}: {_row_name(template, row)}"


class Satisfier:
    """Compiled satisfiability checker for one R1CS (inputs allowed).
    ``which_is_unsatisfied`` names the first violated row, as
    TestConstraintSystem::which_is_unsatisfied does.

    Two routes, as in the reference, both on the port's kernels (their
    plain versions on the CPU); `use_pallas` picks one, and a `config`
    gives it where the argument is None:
      * None or True: the templated limbs check of the whole system as one
        instance (``build_templated_check(r1cs, 1, True, "limbs")``: row
        classes, ELL buckets, ``limbs_matvec``, ``mul_digits``,
        ``reduce_digits``, ``mul``, ``mulcmp`` and ``operand_mulcmp``);
      * False: ``DeviceR1CS.from_r1cs`` and ``violation_mask``, the
        reference's jnp route: every entry's z gathered and multiplied by
        its coefficient (``mul`` at [16, E] a matrix), the 8-bit digits of
        the products summed into their rows, each matrix's row sums reduced
        by ``reduce_digits`` (element-major [R, 32]), then A·z ∘ B·z by
        ``mul`` and a limb compare. It has no row classifier, so it builds
        in the time of three host-to-device copies.
    The first bad row is the least row of the mask; a system of no
    constraints is vacuously satisfied. ``device_r1cs`` holds the False
    route's tables (the reference's ``device`` attribute; here ``device``
    is the torch device)."""

    def __init__(self, r1cs: R1CS, use_pallas: bool | None = None, config=None, *, device=None):
        if config is not None and use_pallas is None:
            use_pallas = config.use_pallas
        self.use_pallas = check_use_pallas(use_pallas)
        self.r1cs = r1cs
        self.backend = get_backend(r1cs.field)
        self.device = resolve(device)
        self.num_slots = r1cs.num_inputs + r1cs.num_aux
        self.route = "device_r1cs" if use_pallas is False else "templated"
        self._check = None
        self.device_r1cs = None
        if not r1cs.num_constraints:  # vacuously satisfied
            return
        if use_pallas is False:
            self.device_r1cs = DeviceR1CS.from_r1cs(r1cs, device=self.device)
        else:
            self._check = build_templated_check(r1cs, 1, True, "limbs", device=self.device)

    def z_from_assignments(self, inputs, aux) -> torch.Tensor:
        """Host witness → z = inputs ++ aux as canonical limbs int32[S, 16]
        on the checker's device."""
        return assemble_z(self.backend, inputs, aux, device=self.device)

    def _verdict(self, z: torch.Tensor):
        if tuple(z.shape) != (self.num_slots, 16):
            raise ValueError(f"z must be int32[{self.num_slots}, 16], got {tuple(z.shape)}")
        if self.device_r1cs is not None:
            bad = violation_mask(self.backend, self.device_r1cs, z)
            nb, first = torch.stack([bad.sum(), bad.to(torch.uint8).argmax()]).tolist()
            return nb, first
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
    ``"bits_packed"``. A `config` gives `batch`, `use_pallas` and
    `witness_form` where they are None. `use_pallas` is checked and the
    same kernels run (see ``build_templated_check``)."""

    def __init__(self, template: R1CS, batch: int | None = None, use_pallas: bool | None = None,
                 witness_form: str | None = None, config=None, field_slots=None, *, device=None):
        if config is not None:
            batch = config.batch if batch is None else batch
            use_pallas = config.use_pallas if use_pallas is None else use_pallas
            witness_form = config.witness_form if witness_form is None else witness_form
        if batch is None:
            raise ValueError("batch required (directly or via config)")
        self.use_pallas = check_use_pallas(use_pallas)
        self.r1cs = template
        self.batch = batch
        self.witness_form = witness_form or "limbs"
        self.backend = get_backend(template.field)
        self.device = resolve(device)
        self.check = build_templated_check(template, batch, use_pallas, self.witness_form,
                                           field_slots=field_slots, device=self.device)
        self.num_constraints_total = batch * template.num_constraints

    def z_from_instances(self, z3) -> torch.Tensor:
        """Instance limbs (numpy uint32 or a tensor) as int32 words on the
        checker's device."""
        return as_words(z3, self.device)

    def _verdict(self, z):
        args = z if self.witness_form == "mixed" else (z,)
        if self.witness_form == "mixed" and not (isinstance(z, tuple) and len(z) == 2):
            raise ValueError("the mixed form takes z = (vals, flimbs)")
        nb, first = self.check.verdict(*args)
        return int(nb), int(first)

    def is_satisfied(self, z3) -> bool:
        return self._verdict(z3)[0] == 0

    def which_is_unsatisfied(self, z3) -> Optional[str]:
        nb, first = self._verdict(z3)
        return which_from_flat(self.r1cs, first) if nb else None
