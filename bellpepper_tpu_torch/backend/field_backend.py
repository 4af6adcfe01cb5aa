"""Vectorized prime-field arithmetic on limb-decomposed torch tensors.

Counterpart of ``bellpepper_tpu/backend/field_jnp.py FieldBackend``
(``:52-330``). A field element is 16 little-endian limbs of 16 bits in
canonical form (no Montgomery), stored as ``int32[..., 16]`` (the port's
word contract, ``words``). In the JAX package this is XLA code outside
any kernel. Here ``add``, ``sub`` and ``neg`` are plain PyTorch that
carries and conditionally subtracts limb by limb, and the multiply goes
through the ``mul`` wrapper of ``field_kernels`` on every device: the CUDA
kernel for a card tensor, its plain version for a CPU one. ``square``,
``inv`` and ``pow_const`` are made of ``mul``s (``pow_ladder``). A
canonical result is unique, so every op gives the reference's bits. The
oracle is the Python-int ``fields.PrimeField``.

Ops take the limb axis last by default; ``dim`` names another (the
witness evaluator keeps limbs in dim 1 of ``[W, 16, B]``). The multiply
moves that axis to the front and hands the kernel one contiguous
``int32[16, N]``."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..fields import PrimeField
from .field_consts import L8, L16, _digits, consts_for  # noqa: F401  (L8: the reference module's name)
from . import field_kernels as fk
from .field_kernels import _add_canon_rows, _cond_sub_rows, _signed_carry, _table
from .words import to_i32, to_u32


MASK16 = np.uint32(0xFFFF)
MASK8 = np.uint32(0xFF)


class FieldBackend:
    """Arithmetic of one odd prime field of at most 255 bits (the
    reference's range, ``field_jnp.py:59``). Get instances via
    :func:`get_backend`."""

    def __init__(self, field: PrimeField):
        # add/sub keep a + b < 2p below 2^256, the 16-limb range
        if field.NUM_BITS > 255:
            raise ValueError("the backend supports fields up to 255 bits")
        self.field = field
        self.consts = consts_for(field)
        p = field.p
        self._p17 = _digits(p, 16, 17)
        nbits = (p - 2).bit_length()
        self._inv_bits = [(p - 2) >> (nbits - 1 - i) & 1 for i in range(nbits)]

    # -- host conversions (numpy) -------------------------------------------
    @staticmethod
    def to_limbs(values) -> np.ndarray:
        """List/array of Python ints → uint32[N, 16]."""
        out = np.empty((len(values), L16), dtype=np.uint32)
        for j, v in enumerate(values):
            out[j] = _digits(int(v), 16, L16)
        return out

    @staticmethod
    def from_limbs(arr) -> list:
        """uint32 or int32 limbs [..., 16] (numpy or torch) → Python ints
        (leading dims flattened)."""
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr).astype(np.int64).reshape(-1, L16) & 0xFFFFFFFF
        return [sum(int(x) << (16 * i) for i, x in enumerate(row)) for row in a]

    # -- field ops ---------------------------------------------------------
    @staticmethod
    def _rows(x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        return list(to_u32(x).unbind(dim))

    @staticmethod
    def _join(rows: List[torch.Tensor], dim: int) -> torch.Tensor:
        return to_i32(torch.stack(rows, dim=dim))

    def add(self, a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return self._join(_add_canon_rows(self._rows(a, dim), self._rows(b, dim), self.consts), dim)

    def _p_limbs(self, x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        """p's first n limbs, shaped to broadcast against x's stacked limb
        rows ([n, ...] with x's other dims)."""
        shape = (n,) + (1,) * (x.dim() - 1)
        return _table(self.field.p, "p17", self._p17, x.device)[:n].reshape(shape)

    def sub(self, a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """(a + p) − b (< 2p, positive), then one conditional subtract of
        p."""
        d = to_u32(a).movedim(dim, 0) + self._p_limbs(a, L16, dim) - to_u32(b).movedim(dim, 0)
        s, _ = _signed_carry(torch.cat([d, torch.zeros_like(d[:1])]))
        return self._join(_cond_sub_rows(s, self._p17)[:L16], dim)

    def neg(self, a: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """p − a, with 0 mapping to 0."""
        out, _ = _signed_carry(self._p_limbs(a, L16, dim) - to_u32(a).movedim(dim, 0))
        res = self._join(out, dim)
        return torch.where(self.is_zero(a, dim).unsqueeze(dim), torch.zeros_like(res), res)

    @staticmethod
    def _limb_major(x: torch.Tensor, dim: int) -> torch.Tensor:
        """x with its limb axis first, as a contiguous int32[16, N]."""
        return x.to(torch.int32).movedim(dim, 0).reshape(L16, -1).contiguous()

    @staticmethod
    def _unlimb(r: torch.Tensor, like: torch.Tensor, dim: int) -> torch.Tensor:
        """int32[16, N] back to like's shape, limb axis at dim."""
        return r.reshape(like.movedim(dim, 0).shape).movedim(0, dim).contiguous()

    def mul(self, a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
        a, b = torch.broadcast_tensors(a, b)
        r = fk.mul(self._limb_major(a, dim), self._limb_major(b, dim), self.field)
        return self._unlimb(r, a, dim)

    def square(self, a: torch.Tensor, dim: int = -1) -> torch.Tensor:
        x = self._limb_major(a, dim)
        return self._unlimb(fk.mul(x, x, self.field), a, dim)

    def mul_pow2(self, a: torch.Tensor, k: int, dim: int = -1) -> torch.Tensor:
        """a · 2^k mod p for a host-known k (field_jnp.py:280-285): one
        ``mul`` by the canonical limbs of 2^k mod p."""
        c = torch.tensor(_digits(pow(2, k, self.field.p), 16, L16), dtype=torch.int32, device=a.device)
        shape = [1] * a.dim()
        shape[dim] = L16
        return self.mul(a, c.reshape(shape), dim)

    def _ladder(self, a: torch.Tensor, bits: List[int], dim: int) -> torch.Tensor:
        """a^e for the MSB-first exponent bits e of an e ≥ 1: one
        ``fk.pow_ladder`` over a's limb-major form; e = 0 (no bits) gives
        ones."""
        if not bits:
            one = torch.zeros_like(a, dtype=torch.int32)
            one.select(dim, 0).fill_(1)
            return one
        return self._unlimb(fk.pow_ladder(self._limb_major(a, dim), bits, self.field), a, dim)

    def inv(self, a: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """a^(p−2) (Fermat, field_jnp.py:287); zero maps to zero."""
        return self._ladder(a, self._inv_bits, dim)

    def pow_const(self, a: torch.Tensor, e: int, dim: int = -1) -> torch.Tensor:
        """a^e for a host-known exponent e ≥ 0."""
        if e < 0:
            raise ValueError("pow_const needs e >= 0")
        nbits = e.bit_length()
        return self._ladder(a, [e >> (nbits - 1 - i) & 1 for i in range(nbits)], dim)

    @staticmethod
    def eq(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Elementwise equality over the limb axis → bool."""
        return (a == b).all(dim=dim)

    @staticmethod
    def is_zero(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return (a == 0).all(dim=dim)


_BACKENDS: Dict[int, FieldBackend] = {}


def get_backend(field: PrimeField) -> FieldBackend:
    be = _BACKENDS.get(field.p)
    if be is None:
        be = _BACKENDS[field.p] = FieldBackend(field)
    return be
