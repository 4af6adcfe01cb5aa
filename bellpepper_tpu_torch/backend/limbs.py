"""The limbs witness form: templated checks of canonical field limbs.

Counterpart of the limbs route of ``bellpepper_tpu/backend/matvec.py``:

  * ``LimbsCheck``: ``build_templated_check(..., "limbs")`` without the
    trivial-row partition (reference ``:3205-3486``). Two routes, chosen
    exactly as the reference chooses them with ``use_pallas=True`` (the
    device plays no part, so the CPU tests take the card's route):
      - fused (batch % 128 == 0, every ELL width K ≤ MAX_FUSED_LIMBS_K and
        the fold tables under 1.5e9 bytes as the reference counts them):
        one ``limbs_matvec`` an ELL bucket, which reads the witness digits
        through the bucket's column table, against host-built fold planes
        (bytes), then ``mulcmp`` on the semi-reduced outputs;
      - non-fused: ``mul_digits`` of every gathered entry with its
        coefficient, bucket row sums, ``reduce_digits``, ``mul``, compare.
  * ``TrivialLimbsCheck``: ``_build_trivial_limbs_check`` (``:1349-1504``):
    booleanity rows as a limb compare, rows of ≤ 2 terms with coefficients
    ±1 through operand assembly and ``mulcmp``, the remaining rows through
    a ``LimbsCheck`` of their sub-template.
  * ``build_limbs_check``: the reference's ``_partition`` rule between the
    two.

Witnesses are int32 words (``words``): batch-major ``z3`` int32[B, S_t,
16] at the public entry points, as in the reference, and slot-major ``zt``
int32[S_t, 16, B] inside, so that every gather moves whole rows. Each limb
vector must encode a canonical value (< p) and slot 0 holds ONE: the
reference's domain contract. Masks are bool[R, B] in the template's row
order; verdicts ``(n_bad, first)`` are int64 0-d tensors, ``first`` the
least instance-major index b·R + row of a violation or 0xFFFFFFFF."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..r1cs import R1CS
from .field_backend import FieldBackend
from .check_common import _limb_rows, _mulcmp_bad, _Operand, mask_verdict
from .field_consts import L8, L16, _digits, fold_digit_table
from .field_kernels import limbs_matvec, mul, mul_digits, mulcmp, reduce_digits
from .layout import FIELD_SRC, MAX_FUSED_LIMBS_K, _build_shared_ell, _classify_trivial_limb_rows, _sub_rows_r1cs
from .words import device_table as _t

# the fused route's bound on its fold tables as the reference counts them
# (4 KB a slot in uint32; the port stores them as bytes, 1 KB a slot)
FUSED_TABLE_BYTES = 1.5e9


class _LimbsForm:
    """The public entry points of a limbs check, over its
    ``mask_slot_major`` (zt int32[S_t, 16, B] → bool[R, B])."""

    def _check_zt(self, zt: torch.Tensor) -> None:
        if zt.dtype != torch.int32 or tuple(zt.shape) != (self.S_t, L16, self.batch):
            raise ValueError(
                f"limbs z must be int32[S_t={self.S_t}, 16, batch={self.batch}] slot-major, "
                f"got {zt.dtype}{tuple(zt.shape)}"
            )

    def _slot_major(self, z3: torch.Tensor) -> torch.Tensor:
        if z3.dtype != torch.int32 or tuple(z3.shape) != (self.batch, self.S_t, L16):
            raise ValueError(
                f"limbs z must be int32[batch={self.batch}, S_t={self.S_t}, 16], "
                f"got {z3.dtype}{tuple(z3.shape)}"
            )
        return z3.permute(1, 2, 0).contiguous()

    def __call__(self, z3: torch.Tensor) -> torch.Tensor:
        """violations: bool[B·R] in instance-major original row order."""
        return self.mask_slot_major(self._slot_major(z3)).t().reshape(-1)

    def verdict(self, z3: torch.Tensor):
        """(n_bad, first) of z3 int32[B, S_t, 16]."""
        return self.verdict_slot_major(self._slot_major(z3))

    def verdict_slot_major(self, zt: torch.Tensor):
        """(n_bad, first) of zt int32[S_t, 16, B]; no host sync."""
        return mask_verdict(self.mask_slot_major(zt))


class LimbsCheck(_LimbsForm):
    """The limbs check of every row of a template through the fold
    matvecs (the reference's unpartitioned limbs route)."""

    def __init__(self, template: R1CS, batch: int, device):
        field = self.field = template.field
        if field.NUM_BITS < 250:
            # below 250 bits the reference's fold matvec output is canonical
            # and feeds a modmul, which the port has for 253..256 bits only
            raise NotImplementedError("the limbs check needs NUM_BITS >= 250")
        self.R = template.num_constraints
        self.S_t = template.num_inputs + template.num_aux
        self.batch = batch
        table = list(template.coeff_table)
        try:
            zero_id = table.index(0)
        except ValueError:
            zero_id = len(table)
            table.append(0)
        mats, pos_of_row, self.Rtp = _build_shared_ell(template, zero_id)
        self.pos = _t(pos_of_row, device)
        total_slots = sum(len(m.cols) for m in mats.values())
        self.fused = (
            batch % 128 == 0
            and self.R > 0
            and all(k <= MAX_FUSED_LIMBS_K for m in mats.values() for k, _s, _n in m.buckets)
            and total_slots * 4096 < FUSED_TABLE_BYTES
        )
        self.mats = {}
        if self.fused:
            fd = fold_digit_table(field, table)  # [T, 32 (j), 32 (d)]
            for name, m in mats.items():
                buckets = []
                for k, start, n_rows in m.buckets:
                    cid_b = np.asarray(m.coeff_ids[start : start + n_rows * k]).reshape(n_rows, k)
                    g = fd[cid_b]  # [n_rows, k, 32 (j), 32 (d)]
                    # F[r, d, 32e + j] = fd[cid[r, e], j, d]: K-major bytes
                    F = np.ascontiguousarray(g.transpose(0, 3, 1, 2).reshape(n_rows, L8, k * L8), np.uint8)
                    # an entry whose coefficient is 0 mod p is not read
                    cols = np.where(g.any((2, 3)), m.cols[start : start + n_rows * k].reshape(n_rows, k), -1)
                    buckets.append((_t(cols, device, torch.int32), torch.from_numpy(F).to(device)))
                self.mats[name] = buckets
        else:
            coeff_limbs = FieldBackend.to_limbs(table)  # [T, 16]
            for name, m in mats.items():
                coeffs = coeff_limbs[np.asarray(m.coeff_ids)].T.view(np.int32)  # [16, total]
                self.mats[name] = (_t(m.cols, device), _t(coeffs, device, torch.int32), m.buckets)

    def _matvec_fused(self, name: str, zt: torch.Tensor) -> torch.Tensor:
        """zt int32[S_t, 16, B] → the matrix's rows int32[17, Rtp·B]
        (each bucket's kernel reads the witness digits through its column
        table)."""
        parts = [limbs_matvec(zt, cols, F, self.field) for cols, F in self.mats[name]]
        return torch.cat(parts, dim=1).reshape(parts[0].shape[0], -1)

    def _matvec(self, name: str, zl: torch.Tensor) -> torch.Tensor:
        """zl int32[16, B, S_t] (limb-major view) → the matrix's canonical
        rows int32[16, B·Rtp]: every entry's product with its coefficient
        as digits, bucket row sums (< 2^24 by _assert_row_density), one
        reduction."""
        cols, coeffs, buckets = self.mats[name]
        B, total = zl.shape[1], cols.shape[0]
        zv = zl.index_select(2, cols).reshape(L16, B * total)
        cv = coeffs[:, None, :].expand(L16, B, total).reshape(L16, B * total)
        dig = mul_digits(zv, cv, self.field).reshape(L8, B, total)
        sums = torch.cat(
            [dig[:, :, s : s + n * k].reshape(L8, B, n, k).sum(-1, dtype=torch.int32) for k, s, n in buckets],
            dim=2,
        )  # [32, B, Rtp]
        return reduce_digits(sums.reshape(L8, B * self.Rtp).contiguous(), self.field)

    def mask_slot_major(self, zt: torch.Tensor) -> torch.Tensor:
        """zt int32[S_t, 16, B] → bool[R, B] in the template's row order."""
        self._check_zt(zt)
        B = zt.shape[2]
        if not self.R:
            return torch.zeros((0, B), dtype=torch.bool, device=zt.device)
        if self.fused:
            az, bz, cz = (self._matvec_fused(n, zt) for n in "abc")
            bad = mulcmp(az, bz, cz, self.field) != 0
            return bad.reshape(self.Rtp, B).index_select(0, self.pos)
        zl = zt.permute(1, 2, 0)
        az, bz, cz = (self._matvec(n, zl) for n in "abc")
        bad = (mul(az, bz, self.field) != cz).any(0).reshape(B, self.Rtp)
        return bad.index_select(1, self.pos).t()


class TrivialLimbsCheck(_LimbsForm):
    """The partitioned limbs check (the reference's
    _build_trivial_limbs_check): booleanity rows by a limb compare, trivial
    rows by operand assembly and ``mulcmp``, the other rows through a
    ``LimbsCheck`` of their sub-template."""

    def __init__(self, template: R1CS, batch: int, device, bit_rows, triv_rows, fold_idx):
        field = self.field = template.field
        if field.NUM_BITS < 250:
            raise NotImplementedError("the trivial limbs rows need NUM_BITS >= 250 (mulcmp)")
        self.R = template.num_constraints
        self.S_t = template.num_inputs + template.num_aux
        self.batch = batch
        self.n_bit, self.n_triv = len(bit_rows), len(triv_rows)
        self.p17 = _limb_rows(_digits(field.p, 16, 17), device)
        self.bit_cols = _t([c for _r, c in bit_rows], device)
        # every term is a witness slot: the mixed operand tables with all
        # sources "field" and z as the limb buffer
        specs = [
            (r, *((cv, [(FIELD_SRC, col, ng) for col, ng in vars_]) for cv, vars_ in sides))
            for r, *sides in triv_rows
        ]
        self.ops = [_Operand(specs, oi, device) for oi in range(3)]
        self.fold = LimbsCheck(_sub_rows_r1cs(template, fold_idx), batch, device) if len(fold_idx) else None
        order = np.concatenate([
            np.asarray([r for r, _c in bit_rows], np.int64),
            np.asarray([r for r, *_ in triv_rows], np.int64),
            np.asarray(fold_idx, np.int64),
        ])
        inv = np.empty(self.R, np.int64)
        inv[order] = np.arange(self.R)
        self.inv = _t(inv, device)

    def mask_slot_major(self, zt: torch.Tensor) -> torch.Tensor:
        """zt int32[S_t, 16, B] → bool[R, B] in the template's row order."""
        self._check_zt(zt)
        B = zt.shape[2]
        parts = []
        if self.n_bit:
            xb = zt.index_select(0, self.bit_cols)  # [n_bit, 16, B]
            parts.append(~((xb[:, 1:] == 0).all(1) & ((xb[:, 0] & -2) == 0)))  # value in {0, 1}
        if self.n_triv:
            parts.append(_mulcmp_bad(self.ops, None, zt, self.p17, self.field))
        if self.fold is not None:
            parts.append(self.fold.mask_slot_major(zt))
        return torch.cat(parts).index_select(0, self.inv)


def build_limbs_check(template: R1CS, batch: int, device=None):
    """The limbs-form check of `template` for `batch` instances on `device`
    (the CUDA card by default): the partitioned check when at least half
    the rows are booleanity or trivial rows, else the fold-matvec check of
    every row."""
    device = resolve(device)
    if not (template.num_inputs == 1 or batch == 1):
        raise ValueError("multi-instance templates must be input-free")
    part = _classify_trivial_limb_rows(template) if template.num_constraints else None
    if part is not None:
        return TrivialLimbsCheck(template, batch, device, *part)
    return LimbsCheck(template, batch, device)
