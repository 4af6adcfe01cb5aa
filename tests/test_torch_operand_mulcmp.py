"""The product rows' operand table and ``operand_mulcmp`` on the CPU.

``OperandTable`` packs the ``_Operand`` tables of the mixed and limbs
checks' trivial product rows for the ``operand_mulcmp`` kernel: read back
in Python integers it gives each row's constant, terms and signs, for
rows of every operand shape (``tests/torch_operand_cases.py``). On CPU
tensors ``_product_bad`` takes the kernel's plain version, the eager
route, and returns the mask of the route before the kernel (operands
assembled by ``_Operand.assemble``, compared by ``mulcmp``) and of Python
integers, with and without u32 terms (the limbs checks' call passes no
u32 values); the wrapper refuses what the kernel does not take. The
kernel itself is held to the same masks on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from bellpepper_tpu_torch import PALLAS_SCALAR, SCALAR, VESTA_SCALAR
from bellpepper_tpu_torch.backend import field_kernels as fk
from bellpepper_tpu_torch.backend.check_common import Products, _limb_rows, _product_bad
from bellpepper_tpu_torch.backend.field_consts import _digits
from torch_circuits import eager_product_bad  # the eager route, as before operand_mulcmp
from torch_operand_cases import decode_table, operand_rows
from torch_small_fields import GOLDILOCKS

FIELDS = [PALLAS_SCALAR, VESTA_SCALAR, SCALAR]


@pytest.mark.parametrize("u32", [True, False], ids=["mixed", "limbs"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_table_reads_back_the_operands(field, u32):
    specs, flimbs, vals, _want = operand_rows(field, 60, 4, 11, u32=u32)
    prods = Products(specs, field, "cpu")
    got = decode_table(prods.table)
    assert got == [[(c, sorted(t)) for c, t in sides] for _r, *sides in specs]
    consts = prods.table.consts.numpy()
    assert not consts[0].any() and len(np.unique(consts, axis=0)) == len(consts)
    f_rows = [i for _r, *sides in specs for _c, t in sides for src, i, _n in t if src == 1]
    u_rows = [i for _r, *sides in specs for _c, t in sides for src, i, _n in t if src == 0]
    assert (prods.table.f_max, prods.table.u_max) == (max(f_rows), max(u_rows, default=-1))


@pytest.mark.parametrize("u32", [True, False], ids=["mixed", "limbs"])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_plain_route_keeps_the_eager_mask(field, u32):
    specs, flimbs, vals, want = operand_rows(field, 90, 37, 12, u32=u32)
    prods = Products(specs, field, "cpu")
    got = _product_bad(prods, vals, flimbs, None, field)
    assert got.dtype == torch.bool and got.shape == (90, 37)
    assert torch.equal(got, torch.from_numpy(want))
    assert torch.equal(got, eager_product_bad(prods, vals, flimbs, field))
    assert want.any() and not want.all()
    assert fk.operand_mulcmp.launches == 0  # the CPU counts no launch


def test_below_250_bits_keeps_its_route():
    """Goldilocks: no table; the operands made canonical and compared with
    mul's product, as before."""
    specs, flimbs, vals, want = operand_rows(GOLDILOCKS, 30, 9, 13)
    prods = Products(specs, GOLDILOCKS, "cpu")
    assert prods.table is None
    p17 = _limb_rows(_digits(GOLDILOCKS.p, 16, 17), "cpu")
    assert torch.equal(_product_bad(prods, vals, flimbs, p17, GOLDILOCKS), torch.from_numpy(want))
    with pytest.raises(ValueError):
        fk.operand_mulcmp(Products(specs, PALLAS_SCALAR, "cpu").table, flimbs, vals, GOLDILOCKS)


def test_rows_without_terms_and_empty_shapes():
    """Constant-only operands (1·1 ≡ 1 holds, 1·1 ≡ 2 does not), no rows,
    and a batch of one instance."""
    p = PALLAS_SCALAR.p
    specs = [(0, (1, []), (1, []), (1, [])), (1, (1, []), (1, []), (2, [])), (2, (p - 1, []), (p - 1, []), (1, []))]
    flimbs = torch.zeros((1, 16, 1), dtype=torch.int32)
    got = _product_bad(Products(specs, PALLAS_SCALAR, "cpu"), None, flimbs, None, PALLAS_SCALAR)
    assert got[:, 0].tolist() == [False, True, False]
    empty = Products([], PALLAS_SCALAR, "cpu")
    assert fk.operand_mulcmp(empty.table, flimbs, None, PALLAS_SCALAR).shape == (0, 1)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    specs, flimbs, vals, _want = operand_rows(PALLAS_SCALAR, 20, 8, 14)
    table = Products(specs, PALLAS_SCALAR, "cpu").table
    with pytest.raises(TypeError):
        fk.operand_mulcmp(table, flimbs.to(torch.int64), vals, PALLAS_SCALAR)
    with pytest.raises(ValueError):  # limbs along the last axis
        fk.operand_mulcmp(table, flimbs.permute(0, 2, 1).contiguous(), vals, PALLAS_SCALAR)
    with pytest.raises(ValueError):
        fk.operand_mulcmp(table, flimbs[:, :, ::2], vals[:, ::2].contiguous(), PALLAS_SCALAR)
    with pytest.raises(ValueError):  # the table reads rows past the buffer
        fk.operand_mulcmp(table, flimbs[: table.f_max].contiguous(), vals, PALLAS_SCALAR)
    with pytest.raises(ValueError):  # u32 terms and no values
        fk.operand_mulcmp(table, flimbs, None, PALLAS_SCALAR)
    with pytest.raises(ValueError):
        fk.operand_mulcmp(table, flimbs, vals[:, :4].contiguous(), PALLAS_SCALAR)
