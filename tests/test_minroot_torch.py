"""Nova's MinRoot step circuit (``perfbench/configs/minroot-65536.py``) on
the port's field path, on the CPU at 16 iterations: the template and its
slots against the plain reference's synthesis
(``perfbench/reference/minroot-65536.py``), the reference's advice
against MinRoot's recurrence in Python integers, the mixed production
step's verdict and computed values, planted faults against the
reference's verdict, and the tracer's spans on the field path (none
recorded, no event, sync or launch count touched, with tracing off)."""

from collections import Counter

import numpy as np
import pytest
import torch

from bellpepper_tpu_torch import WitnessProgram, build_production_step
from bellpepper_tpu_torch.backend import matvec
from bellpepper_tpu_torch.compile import pipeline
from bellpepper_tpu_torch.compile.tape import TapeCS
from bellpepper_tpu_torch.fields import PALLAS_SCALAR
from bellpepper_tpu_torch.utils import profiling
from perfbench.lib import bench
from perfbench.lib.judge import template_rows_wrong

N = 16  # iterations
B = 16  # instances a chunk
CHUNKS = 2
CHAINS = 4  # chains of the advice; CHUNKS · B / CHAINS windows each
P = PALLAS_SCALAR.p
SENT = 0xFFFFFFFF
SEEDS = [3, 2**31 + 11, 2**33 + 5]


@pytest.fixture(scope="module")
def minroot():
    cfg = bench.load_module(f"{bench.HERE}/configs/minroot-65536.py", "minroot_config")
    ref = bench.load_module(f"{bench.HERE}/reference/minroot-65536.py", "minroot_reference")
    template, prog = cfg.build(N)
    return {"cfg": cfg, "ref": ref, "template": template, "prog": prog, "cs": ref.synthesize(P, 254, N)}


def _advice(m, seed):
    """(free_bits, free_field) of CHUNKS × B instances in the program's
    layout, and each instance's free values as Python integers in the
    reference's allocation order."""
    cs, prog = m["cs"], m["prog"]
    windows = CHUNKS * B // CHAINS
    chains = cs.chains(seed, CHAINS, windows)
    inst_vals = [[chains[i // windows][i % windows + off] for off in cs.free_offsets] for i in range(CHUNKS * B)]
    by_slot = [dict(zip(cs.free, v)) for v in inst_vals]
    ff = np.stack([m["ref"].limbs_of([d[s] for s in prog.free_field_slots]) for d in by_slot]).astype(np.int32)
    free_field = torch.from_numpy(ff).reshape(CHUNKS, B, len(prog.free_field_slots), 16)
    fb = np.asarray([[d[s] & 0xFFFFFFFF for s in prog.free_slots] for d in by_slot], np.uint64)
    free_bits = torch.from_numpy(fb.astype(np.uint32).view(np.int32)).reshape(CHUNKS, B, -1)
    return free_bits, free_field, inst_vals


def _step_and_parts(m):
    """The mixed step with its evaluator and check, caught as it builds them."""
    prog, kept = m["prog"], []
    build_check, build = pipeline.build_templated_check, prog.build
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "build_templated_check", lambda *a, **k: kept.append(build_check(*a, **k)) or kept[-1])
        mp.setattr(prog, "build", lambda *a, **k: kept.append(build(*a, **k)) or kept[-1], raising=False)
        step = build_production_step(prog, m["template"], B, witness_form="mixed", device="cpu")
    check, evaluator = kept
    return step, evaluator, check


def _ints(limbs):
    """int32[..., 16] canonical limbs → Python integers."""
    return [sum(int(v) << (16 * j) for j, v in enumerate(row)) for row in np.asarray(limbs).reshape(-1, 16)]


def test_template_and_slots_are_the_references(minroot):
    cs, prog, template = minroot["cs"], minroot["prog"], minroot["template"]
    assert template.num_constraints == len(cs.rows) == 3 * N
    assert template.num_inputs + template.num_aux == cs.n_vars == 3 * N + 3
    assert template_rows_wrong(cs, template, prog.free_slots) == 0
    # z_in and the advice are the free field inputs; x^2 and x^4 the field rows
    assert prog.free_slots == prog.free_field_slots == cs.free
    assert sorted(prog.field_rows) == sorted(cs.sq_vars + cs.quad_vars)
    assert [st.opcode for st in prog.stages] == ["fmul", "fmul"]


def test_field_inputs_name_free_slots_only(minroot):
    tape = TapeCS(PALLAS_SCALAR)
    minroot["cfg"].synthesize(tape, 2)
    # without them x_0 and y_0, which only rows read, stay u32 slots
    assert WitnessProgram(tape).free_field_slots == [3, 6]
    assert WitnessProgram(tape, field_inputs=(1, 2)).free_field_slots == [1, 2, 3, 6]
    with pytest.raises(ValueError, match="free slots"):
        WitnessProgram(tape, field_inputs=(4,))


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_advice_follows_minroot(minroot, seed):
    cs = minroot["cs"]
    windows = 4
    for chain in cs.chains(seed, 2, windows):
        assert len(chain) == N + 1 + windows
        for o in range(windows):
            y, x, *adv = chain[o:o + N + 2]
            for x_next in adv:
                assert pow(x_next, 5, P) == (x + y) % P
                y, x = x, x_next


@pytest.mark.parametrize("seed", SEEDS)
def test_mixed_step_is_clean_and_its_values_are_the_references(minroot, seed):
    step, evaluator, _check = _step_and_parts(minroot)
    free_bits, free_field, inst_vals = _advice(minroot, seed)
    seen = []
    produce = evaluator.slot_major
    evaluator.slot_major = lambda *a, **k: seen.append(produce(*a, **k)) or seen[-1]
    try:
        assert tuple(int(v) for v in step(free_bits, free_field)) == (0, SENT)
    finally:
        del evaluator.slot_major
    prog, cs = minroot["prog"], minroot["cs"]
    assert len(seen) == CHUNKS
    for k, (_vals, flimbs) in enumerate(seen):
        assert flimbs.shape == (prog.n_field_rows + len(prog.free_field_slots), 16, B)
        for b in range(B):
            got = dict(zip(prog.field_slots, _ints(flimbs[:, :, b].numpy())))
            xs = inst_vals[k * B + b][2:]
            assert [got[v] for v in cs.sq_vars] == [x * x % P for x in xs]
            assert [got[v] for v in cs.quad_vars] == [pow(x, 4, P) for x in xs]
            assert [got[v] for v in cs.free] == inst_vals[k * B + b]


def test_free_rows_hold_the_rows_then_the_free_inputs(minroot):
    evaluator = minroot["prog"].build(device="cpu")
    free_bits, free_field, _ = _advice(minroot, 7)
    vals, flimbs = evaluator.slot_major(free_bits[0], free_field[0])
    vals_r, flimbs_r = evaluator.slot_major(free_bits[0], free_field[0], free_rows=True)
    n_fr = minroot["prog"].n_field_rows
    assert torch.equal(vals, vals_r) and torch.equal(flimbs_r[:n_fr], flimbs[:n_fr])
    assert torch.equal(flimbs_r[n_fr:], free_field[0].permute(1, 2, 0))


@pytest.mark.parametrize("seed", SEEDS)
def test_planted_faults_give_the_references_verdict(minroot, seed):
    from perfbench.kinds.field_step import add_mod_p
    from perfbench.lib.judge import fault_sites

    cs, prog, ref = minroot["cs"], minroot["prog"], minroot["ref"]
    step, evaluator, _check = _step_and_parts(minroot)
    free_bits, free_field, inst_vals = _advice(minroot, seed)
    inst, var = fault_sites(seed, CHUNKS * B, cs.n_vars, 8)
    rng = np.random.default_rng([seed, 1])
    deltas = [1 + int.from_bytes(rng.bytes(40), "little") % (P - 1) for _ in inst]
    row_of = {s: i for i, s in enumerate(prog.field_slots)}
    calls = []
    produce = evaluator.slot_major

    def faulted(*a, **k):
        out = produce(*a, **k)
        k_chunk = len(calls)
        calls.append(k_chunk)
        here = [j for j, i in enumerate(inst) if i // B == k_chunk]
        if here:
            add_mod_p(out[1], [int(inst[j]) % B for j in here], [row_of[int(var[j])] for j in here],
                      [deltas[j] for j in here], P)
        return out

    evaluator.slot_major = faulted
    try:
        got = tuple(int(v) for v in step(free_bits, free_field))
    finally:
        del evaluator.slot_major
    field = cs.plain_field("cpu")
    advice = torch.tensor(np.stack([ref.limbs_of(inst_vals[i]) for i in inst]).astype(np.int64)).permute(1, 2, 0)
    z = cs.witness(advice, field)
    cs.plant(z, var, deltas)
    want = cs.verdict(z, inst, field)
    assert got == want and want[0] >= len(inst)


def _span_tree(step, free_bits, free_field):
    profiling.trace_report(reset=True)
    with profiling.tracing():
        verdict = tuple(int(v) for v in step(free_bits, free_field))
    roots = profiling.trace_spans()
    profiling.trace_report(reset=True)
    return verdict, roots


def test_field_step_spans_nest_as_named(minroot):
    step, _evaluator, check = _step_and_parts(minroot)
    free_bits, free_field, _ = _advice(minroot, 5)
    verdict, roots = _span_tree(step, free_bits, free_field)
    assert verdict == (0, SENT) and len(roots) == 1
    (root_id, recs), = roots.items()
    by_id = {r["id"]: r for r in recs}
    assert by_id[root_id]["name"] == "step"
    names = Counter(r["name"] for r in recs)
    classes = {"check." + c for c, n in zip(matvec.ROW_CLASSES, check.counts) if n}
    assert classes == {"check.mul"}
    assert names == Counter({"step": 1, "step.aggregate": 1, "witness": CHUNKS, "witness.init": CHUNKS,
                             "witness.fmul": 2 * CHUNKS, "check": CHUNKS, "check.mul": CHUNKS,
                             "check.verdict": CHUNKS})
    for r in recs:
        if r["parent"] is None:
            continue
        parent = by_id[r["parent"]]
        assert parent["host_start_ns"] <= r["host_start_ns"] <= r["host_end_ns"] <= parent["host_end_ns"]
        want = "step" if r["name"] in ("witness", "check", "step.aggregate") else r["name"].split(".")[0]
        assert parent["name"] == want, r["name"]


def _raise(*args, **kwargs):
    raise AssertionError("touched with tracing off")


def test_tracing_off_adds_no_event_sync_or_launch_count(minroot):
    step, _evaluator, _check = _step_and_parts(minroot)
    free_bits, free_field, _ = _advice(minroot, 9)
    profiling.trace_report(reset=True)
    with pytest.MonkeyPatch.context() as mp:
        for target, attr in ((torch.profiler, "record_function"), (torch.cuda, "Event"),
                             (torch.cuda, "synchronize"), (profiling, "_launches")):
            mp.setattr(target, attr, _raise)
        off = tuple(int(v) for v in step(free_bits, free_field))
    assert profiling.trace_spans() == {}
    assert off == _span_tree(step, free_bits, free_field)[0] == (0, SENT)
