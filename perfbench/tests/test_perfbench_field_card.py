"""On the card (marker `cuda`; skips without one): `minroot.step_1k` at
its 65,536 iterations with a small batch and `blake2s.witness_2m` at a
small batch come out correct with a traced run's per-layer metrics, and
MinRoot with the evaluator's field multiply cut to wrapping 64-bit
integers (the control) comes out not correct.

    python3 -m pytest perfbench/tests/test_perfbench_field_card.py -q"""

import time

import pytest
import torch

import _perfbench_paths  # noqa: F401
from bellpepper_tpu_torch.backend import field_kernels
from perfbench.lib import bench, harness

SIZES = {"minroot.step_1k": 64, "blake2s.witness_2m": 8192}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SIZES))
def test_cell_is_correct_with_its_layers(card, name):
    cell = bench.Cell(bench.load(), name)
    r = harness.run_cell(cell, 2**31 + 77, 0.5, True, "cuda", time.monotonic(), card=card, instances=SIZES[name])
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    for m in cell.per_layer:
        assert m["name"] in r["metrics"], m["name"]
    for name_, m in r["metrics"].items():
        if name_.endswith("roofline"):
            assert 0 < m["value"] <= 100, name_


def _mul_mod_2_64(a, b, field):
    a64 = sum(a[j].to(torch.int64) << (16 * j) for j in range(4))
    b64 = sum(b[j].to(torch.int64) << (16 * j) for j in range(4))
    r = a64 * b64
    out = torch.zeros_like(a)
    for j in range(4):
        out[j] = ((r >> (16 * j)) & 0xFFFF).to(torch.int32)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_minroot_control_is_not_correct(card, monkeypatch, seed):
    monkeypatch.setattr(field_kernels, "mul", _mul_mod_2_64)
    cell = bench.Cell(bench.load(), "minroot.step_1k")
    r = harness.run_cell(cell, seed, 0.1, False, "cuda", time.monotonic(), card=card, instances=64)
    assert not r["correct"], r["checks"]
    assert r["checks"]["witness_values_wrong"]["value"] > 0
