"""Whole runs of the `field_step` and `witness_only` traffic kinds on the
CPU through the program's plain path: MinRoot at 16 iterations (a copy of
the benchmark with a toy configuration beside `minroot-65536`, files
alone) and `blake2s.witness_2m` at 512 instances come out correct, and
each fault their judges must see, and the control (the evaluator's field
multiply cut to wrapping 64-bit integers), comes out not correct."""

import json
import os
import shutil
import time

import pytest
import torch

import _perfbench_paths
from bellpepper_tpu_torch.backend import field_kernels, matvec
from bellpepper_tpu_torch.compile import pipeline, witness_program
from perfbench.lib import bench, harness

N_ITERS = 16
TOY_CONFIG = '''
from perfbench.lib.bench import load_module

_m = load_module(__file__.replace("minroot-toy", "minroot-65536"), "minroot_config")


def build():
    return _m.build({n})
'''
TOY_REFERENCE = '''
from perfbench.lib.bench import load_module

_m = load_module(__file__.replace("minroot-toy", "minroot-65536"), "minroot_reference")


def synthesize(p, capacity):
    return _m.synthesize(p, capacity, {n})
'''
SEED = 2**31 + 21


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """A checkout of the benchmark with `minroot.toy`: MinRoot at 16
    iterations, 32 instances a step in 4 chunks, advice from 4 chains."""
    root = tmp_path_factory.mktemp("field") / "checkout"
    shutil.copytree(os.path.join(_perfbench_paths.ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "minroot-65536.json").read_text())
    cfg["name"] = "minroot-toy"
    (pb / "configs" / "minroot-toy.json").write_text(json.dumps(cfg))
    (pb / "configs" / "minroot-toy.py").write_text(TOY_CONFIG.format(n=N_ITERS))
    (pb / "reference" / "minroot-toy.py").write_text(TOY_REFERENCE.format(n=N_ITERS))
    (pb / "traffic" / "toy_field.json").write_text(json.dumps(
        {"kind": "field_step", "instances": 32, "chunk": 8, "chains": 4, "pool": 1, "faults": 8}))
    b = bench.load()
    b["configs"].append({"name": "minroot-toy", "source": "a test", "file": "perfbench/configs/minroot-toy.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "minroot.toy", "config": "minroot-toy", "traffic": "toy_field", "chips": 1,
                           "why": "a test"})
    for m in b["per_layer"]:
        if "minroot.step_1k" in m.get("workloads", []):
            m["workloads"].append("minroot.toy")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return str(root)


def run_toy(root, seed=SEED, trace=False, **kw):
    cell = bench.Cell(bench.load(root), "minroot.toy", root)
    return harness.run_cell(cell, seed, 0.05, trace, "cpu", time.monotonic(), **kw)


def run_witness(seed=SEED, trace=False, **kw):
    cell = bench.Cell(bench.load(), "blake2s.witness_2m")
    return harness.run_cell(cell, seed, 0.05, trace, "cpu", time.monotonic(), instances=512, **kw)


class Trace:
    busy_s, window_s, device_ops, idle_gaps = 1.0, 2.0, [], []
    layer_device_s = {"witness": 0.01, "check": 0.02}


def _clean(r, cell):
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("seed", [5, SEED, 2**32 + 3])
def test_field_step_run_is_correct(toy_root, seed):
    r = run_toy(toy_root, seed)
    _clean(r, bench.Cell(bench.load(toy_root), "minroot.toy", toy_root))
    assert list(r["checks"]) == ["template_rows_wrong", "verdicts_wrong", "witness_values_wrong",
                                 "faulted_verdict_wrong", "reference_bad_rows"]


def test_field_step_traced_run_reads_its_metrics(toy_root):
    r = run_toy(toy_root, trace=True, capture=lambda *a: Trace(), card="NVIDIA H100 80GB HBM3")
    assert r["correct"]
    fields = {"field_witness_ms", "field_check_ms", "field_check_ops", "field_witness_roofline",
              "field_check_roofline"}
    assert fields <= set(r["metrics"])
    assert r["metrics"]["field_check_ops"]["value"] > 0


@pytest.mark.parametrize("seed", [7, SEED])
def test_witness_only_run_is_correct(seed):
    r = run_witness(seed)
    _clean(r, bench.Cell(bench.load(), "blake2s.witness_2m"))
    r = run_witness(seed, trace=True, capture=lambda *a: Trace(), card="NVIDIA H100 80GB HBM3")
    assert {"witness_ms", "witness_ops", "witness_roofline", "device_idle_pct"} <= set(r["metrics"])


def _value_altered(orig):
    def slot_major(self, *args, **kwargs):
        vals, flimbs = orig(self, *args, **kwargs)
        flimbs[0, 3, 1] ^= 1  # one computed field value altered where it is produced
        return vals, flimbs
    return slot_major


def _verdict_altered(orig):
    def verdict(self, vals_p, flimbs_p):
        nb, first = orig(self, vals_p, flimbs_p)
        return nb, torch.where(nb > 0, first + 1, first)
    return verdict


def _chunk_left_out(orig):
    def build(*args, **kwargs):
        step = orig(*args, **kwargs)
        return lambda free_bits, free_field=None: step(free_bits[:-1], free_field[:-1])
    return build


def _mul_mod_2_64(orig):
    """The control: a field multiply whose product wraps at 2^64, read from
    and written to the low four 16-bit limbs."""
    def mul(a, b, field):
        a64 = sum(a[j].to(torch.int64) << (16 * j) for j in range(4))
        b64 = sum(b[j].to(torch.int64) << (16 * j) for j in range(4))
        r = a64 * b64  # wraps mod 2^64
        out = torch.zeros_like(a)
        for j in range(4):
            out[j] = ((r >> (16 * j)) & 0xFFFF).to(torch.int32)
        return out
    return mul


@pytest.mark.parametrize("target, attr, wrap", [
    (witness_program.Evaluator, "slot_major", _value_altered),
    (matvec.MixedCheck, "verdict_slot_major", _verdict_altered),
    (pipeline, "build_production_step", _chunk_left_out),
    (field_kernels, "mul", _mul_mod_2_64),
])
def test_a_broken_field_step_is_not_correct(monkeypatch, toy_root, target, attr, wrap):
    monkeypatch.setattr(target, attr, wrap(getattr(target, attr)))
    r = run_toy(toy_root)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_the_control_is_not_correct(monkeypatch, toy_root, seed):
    monkeypatch.setattr(field_kernels, "mul", _mul_mod_2_64(field_kernels.mul))
    r = run_toy(toy_root, seed)
    assert r["checks"]["witness_values_wrong"]["value"] > 0 and r["checks"]["verdicts_wrong"]["value"] > 0


def _word_flipped(orig):
    def slot_major(self, free_packed):
        vals, flimbs = orig(self, free_packed)
        vals[vals.shape[0] // 2, 0] ^= 1
        return vals, flimbs
    return slot_major


def _chunk_constant(orig):
    def build(*args, **kwargs):
        orig(*args, **kwargs)
        return lambda free_packed: torch.zeros((1, free_packed.shape[1], 22113), dtype=torch.int32)
    return build


@pytest.mark.parametrize("target, attr, wrap", [
    (witness_program.PackedEvaluator, "slot_major", _word_flipped),
    (pipeline, "build_packed_chunked_witness", _chunk_constant),
])
def test_a_broken_generator_is_not_correct(monkeypatch, target, attr, wrap):
    monkeypatch.setattr(target, attr, wrap(getattr(target, attr)))
    r = run_witness()
    assert r["correct"] is False, r["checks"]
