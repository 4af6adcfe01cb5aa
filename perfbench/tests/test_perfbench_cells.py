"""Cells are found by name, and a configuration, a traffic mix and a
per-layer metric are added as files alone: a copy of the benchmark with
only new files and entries runs a new cell and reads a new metric."""

import json
import os
import shutil
import time

import pytest

import _perfbench_paths
from perfbench.lib import bench, harness


def test_cell_lookup_by_name():
    b = bench.load()
    cell = bench.Cell(b, "blake2s.step_2m")
    assert cell.config["name"] == "blake2s-compress" and cell.traffic["kind"] == "packed_step"
    assert [m["name"] for m in cell.end_to_end] == ["instances_per_s", "step_ms_p90", "setup_s"]
    assert "witness_ms" in cell.readers
    check = bench.Cell(b, "sha256.check_2m")
    assert "witness_ms" not in check.readers and check.traffic["kind"] == "check_only"
    assert "step_ms_p90" not in [m["name"] for m in bench.Cell(b, "sha256.step_2m").end_to_end]
    with pytest.raises(KeyError):
        bench.Cell(b, "no.such_cell")


def test_every_name_resolves_to_a_file():
    b = bench.load()
    for w in b["workloads"]:
        cell = bench.Cell(b, w["name"])
        for path in [cell.builder, cell.reference, cell.kind, *cell.readers.values()]:
            assert os.path.isfile(path), path


TOY_BUILDER = '''
from bellpepper_tpu_torch import NativeBuilder


def build():
    nb = NativeBuilder()
    a = [nb.alloc_bit() for _ in range(32)]
    b = [nb.alloc_bit() for _ in range(32)]
    nb.multieq_begin()
    nb.addmany([a, [nb.xor(x, y) for x, y in zip(a, b)]])
    nb.multieq_end()
    return nb.finish()
'''
TOY_REFERENCE = '''
from perfbench.reference.circuit import Circuit, MultiEq


def synthesize(p, capacity):
    cs = Circuit(p, capacity)
    a, b = cs.alloc_u32(), cs.alloc_u32()
    meq = MultiEq(cs)
    cs.addmany(meq, [a, cs.xor32(a, b)])
    meq.finish()
    return cs
'''
TOY_METRIC = '''
def read(ctx):
    return len(ctx["spans"].get("witness", []))
'''


def test_a_cell_and_a_metric_added_as_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(_perfbench_paths.ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench.load()
    field = json.load(open(os.path.join(_perfbench_paths.ROOT, "perfbench/configs/sha256-compress.json")))["field"]
    pb = root / "perfbench"
    (pb / "configs" / "toy-add.json").write_text(json.dumps(
        {"name": "toy-add", "source": "a test", "field": field, "reduced": [], "assumed": []}))
    (pb / "configs" / "toy-add.py").write_text(TOY_BUILDER)
    (pb / "reference" / "toy-add.py").write_text(TOY_REFERENCE)
    (pb / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"kind": "packed_step", "instances": 256, "pool": 3, "faults": 8}))
    (pb / "metrics" / "witness_spans.py").write_text(TOY_METRIC)
    b["configs"].append({"name": "toy-add", "source": "a test", "file": "perfbench/configs/toy-add.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "toy.mix", "config": "toy-add", "traffic": "toy_mix", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "witness_spans", "unit": "spans", "better": "higher", "source": "program_span",
                           "layer": "witness evaluator", "moves": "instances_per_s", "workloads": ["toy.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = bench.Cell(bench.load(str(root)), "toy.mix", str(root))
    r = harness.run_cell(cell, 5, 0.01, False, "cpu", time.monotonic())
    assert r["correct"] and r["attempted"] >= 3 and "instances_per_s" in r["metrics"]

    class Trace:
        busy_s, window_s, layer_device_s, device_ops, idle_gaps = 1.0, 2.0, {}, [], []

    r = harness.run_cell(cell, 6, 0.01, True, "cpu", time.monotonic(), capture=lambda *a: Trace())
    assert r["correct"] and r["metrics"]["witness_spans"]["value"] >= 3
    assert set(r["metrics"]) == {"witness_spans"}  # the other metrics list their cells
