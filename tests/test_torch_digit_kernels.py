"""``reduce_digits`` and ``mul_digits`` on the CPU (their plain versions,
through the wrappers) against Python ints, for every shipped field: the
digit sums' two layouts (limb-major ``[32, N]`` and the transposed view of
an element-major ``[N, 32]``, which the card's kernel reads as it lies),
the sums at their corners (``torch_circuits.digit_sum_corners``: 0, 1 and
2^24 − 1 in every position; values that are multiples of p or one below
one), and ``mul_digits`` on raw witness values in [p, 2^256) by
canonical coefficients. The kernels themselves run on the card
(``test_torch_cuda.py``)."""

import numpy as np
import pytest

from bellpepper_tpu_torch.backend import field_kernels as fk
from bellpepper_tpu_torch.backend.words import from_numpy_u32, to_numpy_u32
from bellpepper_tpu_torch.fields import FIELDS
from torch_circuits import digit_sum_corners  # the corners the card's compares use too


def _value(col) -> int:
    return sum(int(x) << (8 * j) for j, x in enumerate(col))


def _limb_ints(out: np.ndarray):
    return [sum(int(out[l, i]) << (16 * l) for l in range(16)) for i in range(out.shape[1])]


@pytest.mark.parametrize("field", FIELDS.values(), ids=lambda f: f.name)
def test_reduce_digits_matches_python_ints_in_both_layouts(field):
    p = field.p
    em = digit_sum_corners(p, 0x5EED_0D16)
    want = [_value(col) % p for col in em]
    assert want[3 * 32 + 3] == 0 and want[3 * 32 + 4] == p - 1
    assert want[3 * 32 + 5 :][:8] == [0, p - 1] * 4
    view = from_numpy_u32(em).t()  # [32, N], strides (1, 32)
    lm = from_numpy_u32(em.T.copy())  # [32, N] contiguous
    assert view.stride() == (1, 32) and lm.is_contiguous()
    before = fk.reduce_digits.launches
    got_view, got_lm = (to_numpy_u32(fk.reduce_digits(d, field)) for d in (view, lm))
    assert fk.reduce_digits.launches == before  # CPU tensors: the plain version, no launch
    np.testing.assert_array_equal(got_view, got_lm)
    assert _limb_ints(got_lm) == want


@pytest.mark.parametrize("field", FIELDS.values(), ids=lambda f: f.name)
def test_mul_digits_plain_matches_python_ints_on_raw_values(field):
    """a in {p, p + 1, 2^256 − 1} (raw witness values) by b in {0, 1,
    p − 1}: the 32 digits of a·b mod p."""
    p = field.p
    pairs = [(a, b) for a in (p, p + 1, (1 << 256) - 1) for b in (0, 1, p - 1)]

    def lm(vals):
        return from_numpy_u32(np.asarray([[(v >> (16 * l)) & 0xFFFF for v in vals] for l in range(16)], np.uint32))

    a, b = lm([x for x, _ in pairs]), lm([y for _, y in pairs])
    for fn in (fk.mul_digits, fk.mul_digits_plain):
        got = to_numpy_u32(fn(a, b, field))
        assert got.shape == (32, len(pairs)) and got.max() < 256
        assert [_value(got[:, i]) for i in range(len(pairs))] == [x * y % p for x, y in pairs]
