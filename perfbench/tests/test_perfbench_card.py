"""On the card (marker `cuda`; skips without one): each cell at a small
batch comes out correct, with a traced run's per-layer metrics, and its
control comes out not correct.

    python3 -m pytest perfbench/tests/test_perfbench_card.py -q"""

import time

import pytest
import torch

import _perfbench_paths  # noqa: F401
from perfbench.lib import bench, harness

CELLS = ["sha256.step_2m", "blake2s.step_2m", "sha256.check_2m"]
B = 8192


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_with_its_layers(card, name):
    cell = bench.Cell(bench.load(), name)
    r = harness.run_cell(cell, 2**31 + 99, 0.5, True, "cuda", time.monotonic(), card=card, instances=B)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    for m in cell.per_layer:
        assert m["name"] in r["metrics"], m["name"]
    assert 0 < r["metrics"]["check_roofline"]["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_control_is_not_correct(card, name, seed):
    from perfbench.control import put_in_place

    cell = bench.Cell(bench.load(), name)
    r = harness.run_cell(cell, seed, 0.1, False, "cuda", time.monotonic(), card=card, instances=B,
                         hook=put_in_place)
    assert not r["correct"], r["checks"]
