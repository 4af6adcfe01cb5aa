"""Traffic kind `packed_step`: a closed loop of one client, each step one
chunk of packed free bits through the program's packed production step
(witness generation and the bits_packed check), the verdict read on the
host. Inputs: a pool of uniform free words made on the card from the
seed, used in turn.

`correct` judges the step object that the window times. Every window
step's verdict is the reference's, (0, 0xFFFFFFFF) on these honest
inputs. After the window the same step runs once more on each pooled
input, and the words that its own evaluator hands its own check are held
against the reference's witness; then it runs on the first input with
faults planted at seeded (instance, variable) sites in those words, on
their way from its evaluator to its check, and its verdict (n_bad, first)
must equal the reference's for the faulted witness."""

from __future__ import annotations

import gc

import torch

from bellpepper_tpu_torch import WitnessProgram
from bellpepper_tpu_torch.compile import pipeline
from perfbench.lib import judge, roofline
from perfbench.reference.circuit import SENTINEL, RowChecker, WitnessProgram as ReferenceWitness


def step_and_parts(prog, template, batch: int, device):
    """The program's packed production step and the evaluator and check
    that it closes over: the step module's ``build_packed_parts`` is
    wrapped while the step is built, so that the parts kept are the ones
    the step calls, not a second pair built alike."""
    kept = []
    build = pipeline.build_packed_parts

    def keep(*args, **kwargs):
        kept.append(build(*args, **kwargs))
        return kept[-1]

    pipeline.build_packed_parts = keep
    try:
        step = pipeline.build_packed_production_step(prog, template, batch, device=device)
    finally:
        pipeline.build_packed_parts = build
    if len(kept) != 1:
        raise RuntimeError(f"the packed step built {len(kept)} evaluator and check pairs through "
                           "build_packed_parts; the benchmark judges the one that the step calls")
    return step, kept[0]


class Traffic:
    def __init__(self, cell, seed: int, device, instances: int, builder):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.B = instances
        self.Bw = instances // 32
        self.builder = builder

    def setup(self, reference_circuit):
        t = judge.Stopwatch()
        template, tape = self.builder.build()
        self.template, self.prog = template, WitnessProgram(tape)
        self.free_slots = list(self.prog.free_slots)
        t.lap("circuit")
        n_free = len(self.free_slots)
        self.pool = [judge.random_words((self.Bw, n_free), self.seed * 8 + i, self.device)
                     for i in range(self.cell.traffic["pool"])]
        t.lap("inputs")
        self.run, (self.evaluator, self.check) = step_and_parts(self.prog, template, self.B, self.device)
        t.lap("step built")
        for k in range(len(self.pool)):  # every shape and every input once
            self.step(k)
        t.lap("warm-up")
        self.setup_split = t.laps

    def step(self, k: int):
        total, first = self.run(self.pool[k % len(self.pool)][None])
        return int(total), int(first)

    # -- the layers, for the traced run --------------------------------------
    def layer_calls(self):
        held = {}

        def witness():
            held["vals"] = self.evaluator.slot_major(self.pool[0])[0]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def check_call():
            if "vals" not in held:
                witness()
            nb, first = self.check.verdict_slot_major(held["vals"])
            int(nb), int(first)

        return {"witness": witness, "check": check_call}

    # -- correctness: the step's outputs after the window ---------------------
    def _through_step(self, k: int, sites=None):
        """Run the timed step on pooled input k once, keeping the words its
        evaluator hands its check (with the faults at `sites` planted in
        them on the way); return (verdict, words or None)."""
        ev, seen = self.evaluator, []
        produce = ev.slot_major

        def slot_major(*args, **kwargs):
            out = produce(*args, **kwargs)
            if sites is not None:
                judge.flip(out[0], *sites)
            else:
                seen.append(out[0])
            return out

        ev.slot_major = slot_major
        try:
            verdict = self.step(k)
        finally:
            del ev.slot_major
        return verdict, (seen[0] if len(seen) == 1 else None)

    def collect(self):
        """The step's outputs that the reference judges, made before the
        program is freed: the words of every pooled input and the verdicts
        of those runs, then the verdict on the first input with faults."""
        n_vars = self.template.num_inputs + self.template.num_aux
        self.sites = judge.fault_sites(self.seed, self.B, n_vars, self.cell.traffic["faults"])
        runs = [self._through_step(k) for k in range(len(self.pool))]
        self.words = [w for _, w in runs]
        self.after_verdicts = [v for v, _ in runs]
        self.faulted_verdict = self._through_step(0, self.sites)[0]

    def free_program(self):
        self.run = self.evaluator = self.check = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, verdicts, cs):
        wp = ReferenceWitness(cs, self.device)
        checker = RowChecker(cs)
        out = {"template_rows_wrong": judge.check(
            judge.template_rows_wrong(cs, self.template, self.free_slots), 0)}
        out["verdicts_wrong"] = judge.check(
            sum(v != (0, SENTINEL) for v in list(verdicts) + self.after_verdicts), 0)
        words_wrong, faulted_wrong, ref_bad = 0, 0, 0
        for i, free in enumerate(self.pool):
            W_ref = wp(free.t().contiguous())
            vals, self.words[i] = self.words[i], None
            # words the step never handed its check, or of another shape, are all wrong
            words_wrong += (W_ref.numel() if vals is None or vals.shape != W_ref.shape
                            else int((vals != W_ref).sum()))
            ref_bad += judge.reference_bad_rows(checker, W_ref, judge.sample(self.seed + i, self.B, 32))
            if i == 0:  # sites drawn over the program's slots, which must be the reference's
                want = (None if max(self.sites[1]) >= cs.n_vars
                        else judge.expected_faulted(checker, W_ref, *self.sites))
                faulted_wrong = int(self.faulted_verdict != want)
            del W_ref, vals
        out["witness_words_wrong"] = judge.check(words_wrong, 0)
        out["faulted_verdict_wrong"] = judge.check(faulted_wrong, 0)
        out["reference_bad_rows"] = judge.check(ref_bad, 0)
        return out

    def least_bytes(self, cs):
        return {"witness": roofline.witness_bytes(len(cs.free), cs.n_vars, self.Bw),
                "check": roofline.check_bytes(cs.rows, self.Bw)}
