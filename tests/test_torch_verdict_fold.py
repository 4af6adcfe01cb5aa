"""The packed check's verdict fold on the CPU (``verdict_fold`` takes its
plain version there): words and bool masks against a Python loop over
bits, exact count and first index, on the cases of
``torch_verdict_cases``; and the checks of its inputs."""

import numpy as np
import pytest
import torch

from bellpepper_tpu_torch.backend import field_kernels as fk
from torch_verdict_cases import CASES, NONE, folds, python_verdict


def _run(case_folds, acc=None):
    acc = fk.verdict_acc("cpu") if acc is None else acc
    for bad, rows, R, n_inst in case_folds:
        fk.verdict_fold(acc, bad, rows, R, n_inst)
    return int(acc[0]), int(acc[1])


@pytest.mark.parametrize("form", ["words", "mask"])
@pytest.mark.parametrize("case", CASES)
def test_verdict_fold_matches_python_loop(case, form):
    case_folds = folds(case, form, "cpu")
    before = fk.verdict_fold.launches
    got = _run(case_folds)
    assert got == python_verdict(case_folds)
    assert fk.verdict_fold.launches == before  # CPU tensors: the plain version, no launch
    if case == "zero":
        assert got == (0, NONE)
    if case == "above_2_32":
        assert got[1] >= 1 << 32


def test_verdict_fold_strided_rows_and_defaults():
    """A column slice (strided rows) folds as its copy; n_inst defaults to
    every instance of the input."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.integers(0, 1 << 32, size=(4, 9), dtype=np.uint64).astype(np.uint32).view(np.int32))
    rows = torch.tensor([1, 4, 6, 8])
    sl = w[:, 2:]
    assert not sl.is_contiguous()
    assert _run([(sl, rows, 9, None)]) == _run([(sl.contiguous(), rows, 9, 7 * 32)])
    m = sl.contiguous().ne(0)
    assert _run([(m[:, 1:], rows, 9, None)]) == _run([(m[:, 1:].contiguous(), rows, 9, 6)])


def test_verdict_fold_checks_its_inputs():
    acc = fk.verdict_acc("cpu")
    w = torch.zeros((2, 4), dtype=torch.int32)
    rows = torch.tensor([0, 1])
    with pytest.raises(TypeError):  # words are int32
        fk.verdict_fold(acc, w.to(torch.int64), rows, 4)
    with pytest.raises(TypeError):  # acc is int64[2]
        fk.verdict_fold(acc.to(torch.int32), w, rows, 4)
    with pytest.raises(ValueError):  # one row index a row
        fk.verdict_fold(acc, w, rows[:1].contiguous(), 4)
    with pytest.raises(ValueError):
        fk.verdict_fold(acc, w, rows.to(torch.int32), 4)
    with pytest.raises(ValueError):  # columns contiguous
        fk.verdict_fold(acc, w.t(), torch.arange(4), 4)
    with pytest.raises(ValueError):  # n_inst within the words
        fk.verdict_fold(acc, w, rows, 4, 129)
    with pytest.raises(ValueError):
        fk.verdict_fold(acc, w, rows, 4, -1)
    with pytest.raises(ValueError):  # inputs on one device
        fk.verdict_fold(acc.to("meta"), w, rows, 4)
    assert tuple(acc.tolist()) == (0, NONE)
