"""Whole runs of each traffic kind at a toy batch on the CPU through the
program's plain path, and the comparison that decides `correct` seeing
each fault a cell can have, and the control, come out not correct."""

import json
import time

import numpy as np
import pytest
import torch

import _perfbench_paths  # noqa: F401
from bellpepper_tpu_torch.backend import matvec
from bellpepper_tpu_torch.compile import pipeline, witness_program
from perfbench.lib import bench, harness
from perfbench.lib.judge import random_words
from perfbench.reference.circuit import RowChecker, WitnessProgram, instance_bits
from perfbench.reference.control import Int64Check

B = 512  # toy batch: 16 words of 32 instances
SEED = 2**31 + 7


def run(name, seed=SEED, **kw):
    cell = bench.Cell(bench.load(), name)
    return harness.run_cell(cell, seed, 0.05, False, "cpu", time.monotonic(), instances=B, **kw)


@pytest.mark.parametrize("name", ["sha256.step_2m", "blake2s.step_2m", "sha256.check_2m"])
def test_whole_run_gives_the_contract_line(name):
    r = run(name)
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    cell = bench.Cell(bench.load(), name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in line["checks"].values())


def _flip_word(orig):
    def slot_major(self, free):
        vals, flimbs = orig(self, free)
        vals[vals.shape[0] // 2, 0] ^= 1  # one witness word altered where it is produced
        return vals, flimbs
    return slot_major


def _half_batch(orig):
    def verdict(self, vals_p, flimbs_p=None, n_inst=None):
        return orig(self, vals_p, flimbs_p, n_inst=16 * vals_p.shape[1])  # the upper half left out
    return verdict


def _verdict_altered(orig):
    def verdict(self, vals_p, flimbs_p=None, n_inst=None):
        nb, first = orig(self, vals_p, flimbs_p, n_inst)
        return nb, torch.where(nb > 0, first + 1, first)  # the answer altered where it is produced
    return verdict


@pytest.mark.parametrize("name, target, attr, wrap", [
    ("blake2s.step_2m", witness_program.PackedEvaluator, "slot_major", _flip_word),
    ("blake2s.step_2m", matvec.PackedBitsCheck, "verdict_slot_major", _half_batch),
    ("blake2s.step_2m", matvec.PackedBitsCheck, "verdict_slot_major", _verdict_altered),
    ("sha256.check_2m", matvec.PackedBitsCheck, "verdict_slot_major", _half_batch),
    ("sha256.check_2m", matvec.PackedBitsCheck, "verdict_slot_major", _verdict_altered),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, target, attr, wrap):
    monkeypatch.setattr(target, attr, wrap(getattr(target, attr)))
    r = run(name)
    assert r["correct"] is False, r["checks"]


def _constant_step(orig):
    def build(*args, **kwargs):
        orig(*args, **kwargs)  # built as usual, its parts kept, then never called
        return lambda free_packed: (torch.tensor(0), torch.tensor(0xFFFFFFFF))
    return build


def _half_count(orig):
    def aggregate(nbs, firsts, chunk_span):
        return orig(nbs // 2, firsts, chunk_span)  # the step's own verdict altered where it is summed
    return aggregate


def _half_chunk(orig):
    def build(prog, template, batch, *args, **kwargs):
        step = orig(prog, template, batch, *args, **kwargs)

        def half(free_packed):  # the upper half of the batch's instances left out
            cut = free_packed.clone()
            cut[:, batch // 64:] = free_packed[:, :batch // 64]
            return step(cut)
        return half
    return build


@pytest.mark.parametrize("name", ["sha256.step_2m", "blake2s.step_2m"])
@pytest.mark.parametrize("attr, wrap", [
    ("build_packed_production_step", _constant_step),
    ("_aggregate", _half_count),
    ("build_packed_production_step", _half_chunk),
])
def test_a_broken_step_is_not_correct(monkeypatch, name, attr, wrap):
    monkeypatch.setattr(pipeline, attr, wrap(getattr(pipeline, attr)))
    r = run(name)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", ["sha256.step_2m", "blake2s.step_2m", "sha256.check_2m"])
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_the_control_is_not_correct(name, seed):
    from perfbench.control import put_in_place

    r = run(name, seed, hook=put_in_place)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("config", ["sha256-compress", "blake2s-compress"])
def test_int64_control_check_is_the_reference_mod_2_64(config):
    cell = next(c for c in bench.load()["workloads"] if c["config"] == config)
    cs = bench.load_module(bench.Cell(bench.load(), cell["name"]).reference, "ref").synthesize(
        0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001, 254)
    W = WitnessProgram(cs, "cpu")(random_words((len(cs.free), 4), 5, "cpu"))
    rng = np.random.default_rng(3)
    inst = np.arange(0, 128, 3)
    var = rng.integers(1, cs.n_vars, size=inst.shape[0])
    for i, v in zip(inst, var):
        W[v, i // 32] ^= np.int32(np.int64(1 << (i % 32)) - (1 << 32 if i % 32 == 31 else 0))
    nb, first = Int64Check(cs, "cpu", block_words=2).verdict_slot_major(W)
    assert (int(nb), int(first)) == RowChecker(cs, 1 << 64).verdict(instance_bits(W, inst), inst)
    assert RowChecker(cs).verdict(instance_bits(W, inst), inst)[0] > int(nb)
