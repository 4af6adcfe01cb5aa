"""What the templated checks share: the verdict's sentinel values, the
rule between the semi-reduced and the canonical product compare, and the
limb operands of rows of a few ±1 terms (the reference's _operand_spec),
assembled in 16-bit limbs and compared through ``mulcmp`` (at least 250
bits) or canonicalized and compared through ``mul`` (below 250 bits). The
mixed check (``matvec``) and the limbs checks (``limbs``) both use
them."""

from __future__ import annotations

import numpy as np
import torch

from .field_consts import L16, SEMI, _digits
from .field_kernels import NONE, _cond_sub_rows, _signed_carry, mul, mulcmp
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


def _neg_const(x: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """const − x in 16-bit limbs along dim 1, the last borrow dropped (x ≤
    const; int64 [n, L, B] and [1, L, 1])."""
    return torch.stack(_signed_carry((const - x).transpose(0, 1))[0], dim=1)


def _carry_limbs(x: torch.Tensor) -> torch.Tensor:
    """Carry to 16-bit limbs along dim 1, the last carry dropped (limbs of
    the assembled operands stay far below 2^31, where the reference's
    uint32 sums never wrap)."""
    return torch.stack(_signed_carry(x.transpose(0, 1))[0], dim=1)


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
        B = flimbs_p.shape[-1]
        acc = self.const.expand(-1, -1, B)
        for t in range(self.max_f):
            x = torch.nn.functional.pad(to_u32(flimbs_p.index_select(0, self.f_idx[t])), (0, 0, 0, 1))
            term = torch.where(self.f_neg[t], _neg_const(x, p17), x)
            acc = acc + torch.where(self.f_on[t], term, 0)
        for t in range(self.max_u):
            v = to_u32(vals_p.index_select(0, self.u_col[t]))  # [n, B]
            x = torch.zeros_like(acc)
            x[:, 0] = v & 0xFFFF
            x[:, 1] = v >> 16
            term = torch.where(self.u_neg[t], _neg_const(x, p17), x)
            acc = acc + torch.where(self.u_on[t], term, 0)
        return _carry_limbs(acc)


def _canon_operand(x: torch.Tensor, p: int) -> torch.Tensor:
    """An assembled operand int64[n, 17, B] (a value below 4p) → its
    canonical limb-major int32[16, n·B]: conditional subtracts of 2p and p
    (the reference's canon, ``matvec.py:1902-1906``)."""
    rows = list(x.transpose(0, 1).unbind(0))
    for k in (1, 0):
        rows = _cond_sub_rows(rows, _digits(p << k, 16, SEMI))
    return to_i32(torch.stack(rows[:L16]).reshape(L16, -1)).contiguous()


def _product_bad(ops, vals_p, flimbs_p, p17, field) -> torch.Tensor:
    """bool[n, B]: a·b ≢ c (mod p) for the operands (a, b, c) of n trivial
    rows, assembled, then compared by ``mulcmp`` (``semi_ok``) or made
    canonical and compared with ``mul``'s product (the reference's route
    without mulcmp, ``matvec.py:1492-1496``, ``:1902-1909``)."""
    n, B = ops[0].n, flimbs_p.shape[-1]
    # one operand's int64 limbs at a time
    if semi_ok(field):
        a, b, c = (to_i32(o.assemble(vals_p, flimbs_p, p17).transpose(0, 1).reshape(SEMI, n * B)).contiguous()
                   for o in ops)
        return (mulcmp(a, b, c, field) != 0).reshape(n, B)
    a, b, c = (_canon_operand(o.assemble(vals_p, flimbs_p, p17), field.p) for o in ops)
    return (mul(a, b, field) != c).any(0).reshape(n, B)
