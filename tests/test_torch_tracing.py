"""The port's tracer (bellpepper_tpu_torch/utils/profiling.py) on the CPU,
on the sha256 packed step at B = 256: one span tree a step, with one
``witness.<opcode>`` span a stage of the program, children inside their
parents' host intervals; the check's spans (a family span for each
family, a ``check.fold`` a folded part, ``check.fallback`` on a template
with no small-row majority); with tracing off nothing is recorded and no
profiler range, CUDA event or launch count is touched; verdicts and
witness words are bit-identical with tracing on and off; the report's
self times and launches; ``phase_report``'s keys."""

import time
from collections import Counter

import numpy as np
import pytest
import torch

from bellpepper_tpu_torch import NativeBuilder, WitnessProgram, build_packed_production_step, build_templated_check
from bellpepper_tpu_torch.backend import field_kernels as fk
from bellpepper_tpu_torch.backend.words import from_numpy_u32
from bellpepper_tpu_torch.compile import pipeline
from bellpepper_tpu_torch.utils import profiling

from test_torch_bits_form import _big_coefficient_template

B = 256
SENT = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def empty_tracer():
    profiling.trace_report(reset=True)
    yield
    profiling.trace_report(reset=True)


def _raise(*args, **kwargs):
    raise AssertionError("touched with tracing off")


def _run(step, evaluator, free):
    """The step's verdict and the words its evaluator handed its check."""
    seen = []
    produce = evaluator.slot_major

    def keep(fp):
        seen.append(produce(fp))
        return seen[-1]

    evaluator.slot_major = keep
    try:
        verdict = tuple(int(v) for v in step(free))
    finally:
        del evaluator.slot_major
    return verdict, seen[0][0]


def _lone(check, words, flip):
    """The check's verdict alone on the words with one bit flipped."""
    bad = words.clone()
    bad[flip] ^= 1
    return tuple(int(v) for v in check.verdict_slot_major(bad))


@pytest.fixture(scope="module")
def sha256_runs():
    """The sha256 step run with tracing off (profiler ranges, CUDA events
    and launch counts patched to raise) and on, the traced step's and the
    traced lone verdict's spans apart."""
    nb = NativeBuilder()
    nb.sha256_compression([nb.alloc_bit() for _ in range(512)], nb.sha256_iv())
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    parts = []
    build = pipeline.build_packed_parts
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "build_packed_parts", lambda *a, **kw: parts.append(build(*a, **kw)) or parts[-1])
        step = build_packed_production_step(prog, template, B, device="cpu")
    (evaluator, check), = parts
    rng = np.random.default_rng(0x5EED_0018)
    free = from_numpy_u32(rng.integers(0, 1 << 32, size=(1, B // 32, len(prog.free_slots)),
                                       dtype=np.uint64).astype(np.uint32))
    flip = ((template.num_inputs + template.num_aux) // 2, 3)  # slot, word
    profiling.trace_report(reset=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _raise)
        mp.setattr(torch.cuda, "Event", _raise)
        mp.setattr(profiling, "_launches", _raise)
        off = _run(step, evaluator, free)
        off += (_lone(check, off[1], flip),)
    off_spans = profiling.trace_spans()
    with profiling.tracing():
        verdict, words = _run(step, evaluator, free)
        step_roots = profiling.trace_spans()
        profiling.trace_report(reset=True)
        lone = _lone(check, words, flip)
        check_roots = profiling.trace_spans()
    return {"prog": prog, "check": check, "off": off, "on": (verdict, words, lone), "off_spans": off_spans,
            "step_roots": step_roots, "check_roots": check_roots}


def test_tracing_off_records_nothing(sha256_runs):
    assert sha256_runs["off_spans"] == {}
    assert sha256_runs["off"][0] == (0, SENT)


def test_verdicts_and_words_equal_with_tracing_on_and_off(sha256_runs):
    off, on = sha256_runs["off"], sha256_runs["on"]
    assert on[0] == off[0]
    assert torch.equal(on[1], off[1])
    assert on[2] == off[2] and on[2][0] > 0


def _children(recs):
    by_id = {r["id"]: r for r in recs}
    return by_id, [(by_id[r["parent"]], r) for r in recs if r["parent"] is not None]


def test_step_span_tree(sha256_runs):
    roots = sha256_runs["step_roots"]
    assert len(roots) == 1
    (root_id, recs), = roots.items()
    by_id, edges = _children(recs)
    assert by_id[root_id]["name"] == "step" and by_id[root_id]["parent"] is None
    assert all(r["root"] == root_id for r in recs)
    names = Counter(r["name"] for r in recs)
    stages = Counter(st.opcode for st in sha256_runs["prog"].stages)
    assert {n[len("witness."):]: c for n, c in names.items()
            if n.startswith("witness.") and n != "witness.init"} == dict(stages)
    assert names["witness"] == names["witness.init"] == names["check"] == names["step.aggregate"] == 1
    for parent, child in edges:
        assert parent["host_start_ns"] <= child["host_start_ns"] <= child["host_end_ns"] <= parent["host_end_ns"]
        want = ("step" if child["name"] in ("witness", "check", "step.aggregate")
                else "check.families" if child["name"].startswith("check.family.")
                else "check" if child["name"].startswith("check.") else "witness")
        assert parent["name"] == want, child["name"]
    assert all(r["launches"] == 0 for r in recs)  # the plain versions on the CPU launch no kernel
    if not torch.cuda.is_initialized():
        assert all(r["device_s"] is None for r in recs)


def test_check_span_counts(sha256_runs):
    check = sha256_runs["check"]
    roots = sha256_runs["check_roots"]
    assert len(roots) == 1
    (root_id, recs), = roots.items()
    names = Counter(r["name"] for r in recs)
    assert recs[0]["name"] == "check" and recs[0]["id"] == root_id
    families = Counter("check.family." + f[0] for f in check.fam)
    assert {n: c for n, c in names.items() if n.startswith("check.family.")} == families
    parts = {"check.leftover": check.n_left > 0, "check.pow2": check.pow2_spec is not None,
             "check.big": check.big is not None}
    assert {n: names[n] for n in parts} == {n: int(v) for n, v in parts.items()}
    assert names["check.fold"] == len(families) + sum(parts.values())
    assert names["check.families"] == 1 and names["check.fallback"] == 0


def test_fallback_check_spans():
    template, n = _big_coefficient_template()
    check = build_templated_check(template, 64, None, "bits_packed", device="cpu")
    assert check.fallback is not None
    x = np.random.default_rng(18).integers(0, 1 << 32, size=(2, n + 1), dtype=np.uint64).astype(np.uint32)
    vals = np.concatenate([np.full((2, 1), SENT, np.uint32), x, x], axis=1)
    words = from_numpy_u32(vals).t().contiguous()
    want = tuple(int(v) for v in check.verdict_slot_major(words))
    with profiling.tracing():
        got = tuple(int(v) for v in check.verdict_slot_major(words))
    assert got == want == (0, SENT)
    (recs,) = profiling.trace_spans().values()
    assert Counter(r["name"] for r in recs) == {"check": 1, "check.fallback": 1, "check.fold": 1}


def test_report_self_times_and_launches(monkeypatch):
    monkeypatch.setattr(fk.mul, "launches", 0)
    assert not profiling.is_tracing()
    with pytest.raises(RuntimeError), profiling.tracing():
        assert profiling.is_tracing()
        with profiling.span("outer"):
            fk.mul.launches += 1
            with profiling.span("inner"):
                fk.mul.launches += 2
                time.sleep(0.01)
            with profiling.span("inner"):
                raise RuntimeError
    assert not profiling.is_tracing()
    with profiling.span("not recorded"):
        pass
    (recs,) = profiling.trace_spans().values()
    assert [r["name"] for r in recs] == ["outer", "inner", "inner"]
    assert [r["parent"] for r in recs] == [None, recs[0]["id"], recs[0]["id"]]
    rep = profiling.trace_report()
    assert set(rep) == {"outer", "inner"}
    assert rep["outer"]["count"] == 1 and rep["inner"]["count"] == 2
    assert rep["outer"]["launches"] == 3 and rep["inner"]["launches"] == 2
    assert rep["inner"]["host_total_s"] >= 0.01
    assert rep["outer"]["host_self_s"] == pytest.approx(rep["outer"]["host_total_s"] - rep["inner"]["host_total_s"])
    assert rep["inner"]["host_self_s"] == pytest.approx(rep["inner"]["host_total_s"])
    if not torch.cuda.is_initialized():
        assert rep["outer"]["device_total_s"] is None and rep["outer"]["device_self_s"] is None
    assert profiling.trace_report(reset=True) == rep and profiling.trace_report() == {}


def test_phase_report_keeps_its_keys():
    profiling.phase_report(reset=True)
    with profiling.phase("synthesize"):
        sum(range(100))
    with profiling.phase("synthesize", trace=True):
        sum(range(100))
    rep = profiling.phase_report(reset=True)
    assert list(rep) == ["synthesize"]
    assert list(rep["synthesize"]) == ["count", "total_s", "mean_s", "device_total_s", "device_mean_s"]
    assert rep["synthesize"]["count"] == 2 and rep["synthesize"]["total_s"] > 0
    if not torch.cuda.is_initialized():
        assert rep["synthesize"]["device_total_s"] is None
    assert profiling.trace_spans() == {}  # a phase is not a span of the trace
