"""What the templated checks share: the verdict's sentinel values, the
rule between the semi-reduced and the canonical product compare, and the
limb operands of rows of a few ±1 terms (the reference's _operand_spec):
product rows go through ``operand_mulcmp``, which assembles and compares
them in one kernel (at least 250 bits), or are assembled in 16-bit limbs,
canonicalized and compared through ``mul`` (below 250 bits). The mixed
check (``matvec``) and the limbs checks (``limbs``) both use them."""

from __future__ import annotations

import numpy as np
import torch

from .field_consts import L16, SEMI, _digits
from .field_kernels import NONE, OperandTable, _cond_sub_rows, assemble_operand, mul, operand_mulcmp
from .layout import FIELD_SRC
from .words import device_table as _t, to_i32, to_u32

SENTINEL = 0xFFFFFFFF  # "no violation" value of `first`, as in the reference


def semi_ok(field) -> bool:
    """Whether products compare semi-reduced through ``mulcmp``: p·2^11
    must exceed every semi value (< 2^266), so NUM_BITS ≥ 250, as the
    reference's fused routes choose (``matvec.py:3258``, ``:1407``,
    ``:1867``); below that the outputs are canonical and ``mul``'s product
    is compared limb for limb."""
    return 250 <= field.NUM_BITS <= 256


def mask_verdict(bad: torch.Tensor):
    """bool[R, B] mask in row order → (n_bad, first) as int64 0-d tensors,
    first the least instance-major index b·R + row, or 0xFFFFFFFF."""
    nb = bad.sum()
    if not bad.numel():
        return nb, torch.full((), SENTINEL, dtype=torch.int64, device=bad.device)
    first = bad.t().reshape(-1).to(torch.uint8).argmax()
    return nb, torch.where(nb > 0, first, SENTINEL)


def _limb_rows(const_limbs, device) -> torch.Tensor:
    """Constant limbs as an int64 [1, L, 1] tensor (broadcasts against
    [n, L, B] limb planes)."""
    return _t(const_limbs, device).reshape(1, -1, 1)


class _Operand:
    """Static tables of one operand of a list of trivial rows (the
    reference's _operand_spec): const limbs, up to two field-source terms
    and up to two u32 terms, each with a sign."""

    def __init__(self, rows_specs, oi: int, device):
        n = self.n = len(rows_specs)
        const = np.zeros((n, 17), np.int64)
        f_idx = np.zeros((n, 2), np.int64)
        f_on = np.zeros((n, 2), bool)
        f_neg = np.zeros((n, 2), bool)
        u_col = np.zeros((n, 2), np.int64)
        u_on = np.zeros((n, 2), bool)
        u_neg = np.zeros((n, 2), bool)
        for w, (_r, *specs) in enumerate(rows_specs):
            cv, vars_ = specs[oi]
            const[w] = _digits(cv, 16, 17)
            nf = nu = 0
            for src, idx, ng in vars_:
                if src == FIELD_SRC:
                    f_idx[w, nf], f_on[w, nf], f_neg[w, nf] = idx, True, ng
                    nf += 1
                else:
                    u_col[w, nu], u_on[w, nu], u_neg[w, nu] = idx, True, ng
                    nu += 1
        self.host = dict(const=const, f_idx=f_idx, f_on=f_on, f_neg=f_neg, u_col=u_col, u_on=u_on, u_neg=u_neg)
        self.max_f = int(f_on.any(axis=0).sum()) if n else 0
        self.max_u = int(u_on.any(axis=0).sum()) if n else 0
        # every row one positive field term and no constant: the gathered
        # canonical limbs are the operand
        self.fast_single_field = bool(
            n and self.max_f == 1 and self.max_u == 0 and not const.any()
            and not f_neg.any() and f_on[:, 0].all()
        )
        self.const = _t(const, device)[:, :, None]
        self.f_idx = [_t(f_idx[:, t], device) for t in range(2)]
        self.f_on = [_t(f_on[:, t], device, torch.bool)[:, None, None] for t in range(2)]
        self.f_neg = [_t(f_neg[:, t], device, torch.bool)[:, None, None] for t in range(2)]
        self.u_col = [_t(u_col[:, t], device) for t in range(2)]
        self.u_on = [_t(u_on[:, t], device, torch.bool)[:, None, None] for t in range(2)]
        self.u_neg = [_t(u_neg[:, t], device, torch.bool)[:, None, None] for t in range(2)]

    def assemble(self, vals_p, flimbs_p, p17) -> torch.Tensor:
        """int64[n, 17, B]: the operand's value (< 4p) in 16-bit limbs, from
        u32 values vals_p [S, B] (unused without u32 terms) and canonical
        limbs flimbs_p [F, 16, B]."""
        if self.fast_single_field:
            x = to_u32(flimbs_p.index_select(0, self.f_idx[0]))
            return torch.nn.functional.pad(x, (0, 0, 0, 1))
        f_terms = list(zip(self.f_idx, self.f_on, self.f_neg))[: self.max_f]
        u_terms = list(zip(self.u_col, self.u_on, self.u_neg))[: self.max_u]
        return assemble_operand(self.const, f_terms, u_terms, vals_p, flimbs_p, p17)


def _canon_operand(x: torch.Tensor, p: int) -> torch.Tensor:
    """An assembled operand int64[n, 17, B] (a value below 4p) → its
    canonical limb-major int32[16, n·B]: conditional subtracts of 2p and p
    (the reference's canon, ``matvec.py:1902-1906``)."""
    rows = list(x.transpose(0, 1).unbind(0))
    for k in (1, 0):
        rows = _cond_sub_rows(rows, _digits(p << k, 16, SEMI))
    return to_i32(torch.stack(rows[:L16]).reshape(L16, -1)).contiguous()


class Products:
    """The operands (a, b, c) of a list of trivial product rows: their
    ``_Operand`` tables and, where products compare semi-reduced
    (``semi_ok``), the same tables packed for ``operand_mulcmp``."""

    def __init__(self, rows_specs, field, device):
        self.ops = [_Operand(rows_specs, oi, device) for oi in range(3)]
        self.n = self.ops[0].n
        self.table = OperandTable([o.host for o in self.ops], device) if semi_ok(field) else None


def _product_bad(prods: Products, vals_p, flimbs_p, p17, field) -> torch.Tensor:
    """bool[n, B]: a·b ≢ c (mod p) for the operands (a, b, c) of n trivial
    rows: assembled and compared by ``operand_mulcmp`` (``semi_ok``), or
    assembled, made canonical and compared with ``mul``'s product (the
    reference's route without mulcmp, ``matvec.py:1492-1496``,
    ``:1902-1909``)."""
    if prods.table is not None:
        return operand_mulcmp(prods.table, flimbs_p.contiguous(), vals_p, field)
    n, B = prods.n, flimbs_p.shape[-1]
    a, b, c = (_canon_operand(o.assemble(vals_p, flimbs_p, p17), field.p) for o in prods.ops)
    return (mul(a, b, field) != c).any(0).reshape(n, B)
