"""The benchmark's arithmetic on known numbers: the window's rate and tail,
the device trace's busy and idle seconds, and the roofline byte counts of
a toy circuit."""

import pytest

import _perfbench_paths  # noqa: F401
from perfbench.lib import roofline, stats
from perfbench.lib.trace import TraceSummary, _innermost, union_seconds
from perfbench.reference.circuit import Circuit, MultiEq

P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def test_rate_is_all_work_over_all_time():
    assert stats.rate(3 * 2097152, 1.5) == 2 * 2097152


@pytest.mark.parametrize("values, want", [
    (list(range(1, 11)), 9.1),  # inclusive: between the 9th and 10th of 10
    ([5.0], 5.0),
    ([1.0, 2.0], 1.9),
    ([10.0] * 99 + [1000.0], 10.0),  # one slow step in 100 lies past p90
    ([10.0] * 80 + [1000.0] * 20, 1000.0),
])
def test_p90_of_all_steps(values, want):
    assert stats.p90(values) == pytest.approx(want)


def test_union_counts_overlap_once():
    assert union_seconds([(0, 10), (5, 15), (20, 25)]) == 20
    assert union_seconds([]) == 0


def test_innermost_host_op():
    ops = [(0, 100, "outer"), (10, 20, "inner"), (30, 40, "inner2")]
    got = _innermost(ops, [5, 15, 35, 50, 150])
    assert got == {5: "outer", 15: "inner", 35: "inner2", 50: "outer", 150: None}


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_summary_from_synthetic_events():
    ev = [
        _ev("user_annotation", "perfbench.step", 0, 100),
        _ev("user_annotation", "perfbench.step", 100, 100),
        _ev("user_annotation", "perfbench.witness", 300, 50),
        _ev("cpu_op", "aten::xor", 1, 8), _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        _ev("cpu_op", "aten::index_select", 40, 10), _ev("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=2),
        _ev("cpu_op", "aten::add", 120, 5), _ev("cuda_runtime", "cudaMemcpyAsync", 121, 1, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 301, 1, corr=4),
        # device: two overlapping kernels (two streams) count once
        _ev("kernel", "k_xor", 10, 20, tid=7, corr=1),
        _ev("kernel", "k_sel", 20, 30, tid=8, corr=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 130, 10, tid=7, corr=3),
        _ev("kernel", "k_wit", 305, 40, tid=7, corr=4),
    ]
    tr = TraceSummary(ev)
    assert tr.window_s == pytest.approx(200e-6)
    assert tr.busy_s == pytest.approx((40 + 10) * 1e-6)  # [10, 50) and [130, 140)
    assert tr.layer_device_s == {"witness": pytest.approx(40e-6)}
    assert tr.device_ops[0] == ["k_sel", pytest.approx(30e-6)]
    # the one gap inside the steps, [50, 130), ended by the copy aten::add launched
    assert tr.idle_gaps == [["aten::add", pytest.approx(80e-6)]]


def test_trace_without_steps_is_refused():
    with pytest.raises(ValueError):
        TraceSummary([_ev("kernel", "k", 0, 1, corr=1)])


def _toy_circuit():
    cs = Circuit(P, 254)
    a, b = cs.alloc_u32(), cs.alloc_u32()
    meq = MultiEq(cs)
    cs.addmany(meq, [a, cs.xor32(a, b)])
    meq.finish()
    return cs


def test_roofline_bytes_of_a_toy_circuit():
    cs = _toy_circuit()
    # 64 free bits, 32 xor outputs, 33 sum bits, ONE
    assert cs.n_vars == 1 + 64 + 32 + 33
    assert roofline.witness_bytes(len(cs.free), cs.n_vars, 16) == (64 + 130) * 16 * 4
    assert roofline.check_bytes(cs.rows, 16) == 130 * 16 * 4  # every variable, ONE too, once


def test_roofline_share_against_the_published_peak():
    card = "NVIDIA H100 80GB HBM3"
    assert roofline.share_pct(3.35e9, 2e-3, card) == pytest.approx(50.0)
    with pytest.raises(KeyError):
        roofline.share_pct(1, 1.0, "cpu")
