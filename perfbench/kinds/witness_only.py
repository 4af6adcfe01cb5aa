"""Traffic kind `witness_only`: a closed loop of one client, each step one
chunk of packed free bits through the program's packed witness generation
alone (``build_packed_chunked_witness``), as a ``WitnessCS`` user runs it
to hand witnesses to a prover unchecked; each step ends in a host read of
the 64-bit wrapping sum of its output words. Inputs: a pool of uniform
free words made on the card from the seed, used in turn.

`correct` judges the generator that the window times, whose evaluator is
caught as the generator is built (``prog.build_packed``, wrapped for that
call). Every window step's sum is the sum of the reference's witness
words for its input. After the window the generator runs once more on
each pooled input, and every output word is held against the reference's
witness."""

from __future__ import annotations

import gc

import torch

from bellpepper_tpu_torch import WitnessProgram
from bellpepper_tpu_torch.compile import pipeline
from perfbench.lib import judge, roofline
from perfbench.reference.circuit import RowChecker, WitnessProgram as ReferenceWitness


def generator_and_evaluator(prog, device):
    """The program's packed chunked witness generator and the evaluator it
    closes over, caught while the generator is built."""
    kept = []
    build = prog.build_packed

    def keep(*args, **kwargs):
        kept.append(build(*args, **kwargs))
        return kept[-1]

    prog.build_packed = keep
    try:
        gen = pipeline.build_packed_chunked_witness(prog, device=device)
    finally:
        del prog.build_packed
    if len(kept) != 1:
        raise RuntimeError(f"the generator built {len(kept)} evaluators; the benchmark judges the one it calls")
    return gen, kept[0]


def word_sum(words: torch.Tensor) -> int:
    """The 64-bit wrapping sum of int32 words, as a Python integer."""
    return int(words.sum(dtype=torch.int64))


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
        self.gen, self.evaluator = generator_and_evaluator(self.prog, self.device)
        t.lap("generator built")
        for k in range(len(self.pool)):  # every shape and every input once
            self.step(k)
        t.lap("warm-up")
        self.setup_split = t.laps

    def step(self, k: int):
        return word_sum(self.gen(self.pool[k % len(self.pool)][None]))

    # -- the layers, for the traced run --------------------------------------
    def layer_calls(self):
        def witness():
            self.evaluator.slot_major(self.pool[0])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        return {"witness": witness}

    # -- correctness: the generator's outputs after the window ----------------
    def collect(self):
        """Every output word of the timed generator on each pooled input."""
        self.words = [self.gen(free[None]) for free in self.pool]

    def free_program(self):
        self.gen = self.evaluator = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, verdicts, cs):
        wp = ReferenceWitness(cs, self.device)
        sums, words_wrong, ref_bad = [], 0, 0
        for i, free in enumerate(self.pool):
            W_ref = wp(free.t().contiguous())  # [S, Bw]
            sums.append(word_sum(W_ref))
            out, self.words[i] = self.words[i], None
            # words of another shape are all wrong
            words_wrong += (W_ref.numel() if out.shape != (1, self.Bw, W_ref.shape[0])
                            else int((out[0].t() != W_ref).sum()))
            ref_bad += judge.reference_bad_rows(RowChecker(cs), W_ref, judge.sample(self.seed + i, self.B, 32))
            del W_ref, out
        return {
            "template_rows_wrong": judge.check(judge.template_rows_wrong(cs, self.template, self.free_slots), 0),
            "verdicts_wrong": judge.check(sum(v != sums[k % len(sums)] for k, v in enumerate(verdicts)), 0),
            "witness_words_wrong": judge.check(words_wrong, 0),
            "reference_bad_rows": judge.check(ref_bad, 0),
        }

    def least_bytes(self, cs):
        return {"witness": roofline.witness_bytes(len(cs.free), cs.n_vars, self.Bw)}
