"""The readings of the program's own spans (``perfbench/lib/program_trace.py``)
on known inputs: the idle gaps of a hand-made Chrome trace given to the
innermost ``bp.`` span at the launch that ended each, the three readings
on a synthetic ctx, pass (a) on the CPU through the program's tracer, and
nothing read from a program without one."""

import pytest

import _perfbench_paths  # noqa: F401
from bellpepper_tpu_torch.utils import profiling
from perfbench.lib import program_trace as pt


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, corr=corr)


def _kernel(ts, dur, corr):
    return _ev("kernel", f"k{corr}", ts, dur, tid=7, corr=corr)


EVENTS = [
    _ev("user_annotation", "perfbench.step", 0, 1100),
    _ev("user_annotation", "bp.step", 0, 1000),
    _ev("user_annotation", "bp.witness", 10, 490),
    _ev("user_annotation", "bp.witness.xor", 20, 80),
    _ev("user_annotation", "bp.check", 500, 490),
    _ev("user_annotation", "bp.check.fold", 600, 100),
    _ev("cpu_op", "aten::bitwise_xor", 25, 10),
    _launch(30, 1), _launch(50, 2),  # inside bp.witness.xor
    _launch(650, 3),  # inside bp.check.fold
    _launch(1050, 4),  # inside the step, outside every bp. span
    _launch(2000, 5),  # outside the steps: not counted
    _kernel(100, 50, 1), _kernel(200, 50, 2),  # gap 50 ended by work of witness.xor
    _kernel(240, 5, 2),  # overlaps: no gap
    _kernel(700, 60, 3),  # gap 450: check.fold
    _kernel(1100, 20, 4),  # gap 340: outside the program
    _kernel(2100, 10, 5),
]


def test_gaps_go_to_the_innermost_span_at_the_launch():
    got = pt.attribute_gaps(EVENTS)
    assert got["n_steps"] == 1 and got["window_s"] == pytest.approx(1100e-6)
    assert got["by_span"] == pytest.approx({"witness.xor": 50e-6, "check.fold": 450e-6, pt.OUTSIDE: 340e-6})
    assert got["idle_s"] == pytest.approx(840e-6)
    assert got["busy_s"] == pytest.approx(180e-6)
    assert pt.witness_idle_ms({"program_gaps": got}) == pytest.approx(0.05)


def test_gaps_need_a_step():
    with pytest.raises(ValueError):
        pt.attribute_gaps([e for e in EVENTS if e["name"] != "perfbench.step"])


def _rec(i, name, parent, t0_us, t1_us, device_ms=None):
    return {"id": i, "name": name, "parent": parent, "root": 0, "host_start_ns": int(t0_us * 1e3),
            "host_end_ns": int(t1_us * 1e3), "device_s": None if device_ms is None else device_ms / 1e3,
            "launches": 0}


def _program(device=True):
    def d(ms):
        return ms if device else None

    roots = []
    for step in range(2):
        roots.append([
            _rec(0, "step", None, 0, 1000, d(900)),
            _rec(1, "witness", 0, 0, 200e3 + 10e3 * step, d(150)),
            _rec(2, "witness.xor", 1, 10, 20, d(1)),
            _rec(3, "check", 0, 200, 900, d(340)),
            _rec(4, "check.fold", 3, 300, 400, d(100)),
            _rec(5, "check.fold", 3, 400, 500, d(150 + step)),
        ])
    return {"roots": roots, "report": {}, "step_s": [0.5, 0.6]}


def test_readings_on_a_synthetic_ctx():
    ctx = {"program": _program(), "program_gaps": {"n_steps": 4, "busy_s": 1.5, "by_span": {
        "witness": 0.010, "witness.xor": 0.030, "witness.init": 0.002, "check.fold": 1.0, pt.OUTSIDE: 2.0}}}
    assert pt.witness_enqueue_ms(ctx) == pytest.approx(205.0)  # the mean of 200 and 210 ms
    assert pt.check_fold_ms(ctx) == pytest.approx(250.5)  # (100 + 150 + 100 + 151) ms over 2 verdicts
    assert pt.witness_idle_ms(ctx) == pytest.approx(10.5)  # 42 ms over 4 steps
    assert {name: fn(ctx) for name, fn in pt.READINGS.items()} == pytest.approx(
        {"witness_enqueue_ms": 205.0, "check_fold_ms": 250.5, "witness_idle_ms": 10.5})


def test_nothing_read_without_the_passes_or_device_times():
    for ctx in ({}, {"program": None, "program_gaps": None}):
        assert all(fn(ctx) is None for fn in pt.READINGS.values())
    # no device number from the CPU: no events, a trace with no device work
    assert pt.check_fold_ms({"program": _program(device=False)}) is None
    assert pt.witness_idle_ms({"program_gaps": {"n_steps": 3, "busy_s": 0.0, "by_span": {}}}) is None
    assert pt.witness_enqueue_ms({"program": _program(device=False)}) == pytest.approx(205.0)


def _toy_step(k):
    with profiling.span("step"):
        with profiling.span("witness"):
            pass
        with profiling.span("check"):
            with profiling.span("check.fold"):
                pass
    return 0, 0xFFFFFFFF


def test_program_pass_through_the_tracer():
    got = pt.program_pass(_toy_step, 3)
    assert len(got["roots"]) == 3 and len(got["step_s"]) == 3
    assert [r["name"] for r in got["roots"][0]] == ["step", "witness", "check", "check.fold"]
    assert got["report"]["check.fold"]["count"] == 3
    assert not profiling.is_tracing() and profiling.trace_spans() == {}
    assert pt.witness_enqueue_ms({"program": got}) > 0
    assert pt.check_fold_ms({"program": got}) is None  # the CPU records no CUDA events
    table = pt.span_table(got)
    assert "check.fold" in table and "not measured" in table


def test_a_program_without_the_tracer_gives_no_pass(monkeypatch):
    monkeypatch.delattr(profiling, "tracing")
    assert pt.program_pass(_toy_step, 3) is None
    assert pt.gaps_pass(_toy_step, 3) is None
