"""Traffic kind `check_only`: a closed loop of one client, each step the
bits_packed check's verdict (``build_templated_check(..., "bits_packed")``)
over one of a pool of packed witnesses that set-up made with the
reference's witness generator from uniform free words drawn on the card
from the seed; the pool entries marked `faulted` carry faults planted at
instances and variables drawn from the seed. No witness generation runs
in the window.

The reference's synthesis and witness generation are timed apart
(`reference_s`) and left out of `setup_s`.

`correct`: every step's verdict equals the reference's for its witness:
(0, 0xFFFFFFFF) for an honest one, the exact count and first violated row
of the faulted instances for a faulted one."""

from __future__ import annotations

import gc

import torch

from bellpepper_tpu_torch import WitnessProgram
from bellpepper_tpu_torch.backend.matvec import build_templated_check
from perfbench.lib import judge, roofline
from perfbench.reference.circuit import SENTINEL, RowChecker, WitnessProgram as ReferenceWitness


class Traffic:
    def __init__(self, cell, seed: int, device, instances: int, builder):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.B = instances
        self.Bw = instances // 32
        self.builder = builder

    def setup(self, reference_circuit):
        t = judge.Stopwatch()
        self.template, self.tape = self.builder.build()
        t.lap("circuit")
        cs = reference_circuit()
        wp = ReferenceWitness(cs, self.device)
        mix = self.cell.traffic
        self.honest = wp(judge.random_words((len(cs.free), self.Bw), self.seed * 8, self.device))
        t.lap("reference's witness")
        # the reference's synthesis and witness are its own work, not the program's set-up
        self.reference_s = t.laps["reference's witness"]
        self.pool, self.faults = [], []
        for i, faulted in enumerate(mix["faulted"]):
            W = self.honest.clone() if i else self.honest
            sites = None
            if faulted:
                sites = judge.fault_sites(self.seed + i, self.B, cs.n_vars, mix["faults"])
                judge.flip(W, *sites)
            self.pool.append(W)
            self.faults.append(sites)
        t.lap("inputs")
        self.check = build_templated_check(self.template, self.B, None, "bits_packed", device=self.device)
        t.lap("check built")
        for k in range(len(self.pool)):
            self.step(k)
        t.lap("warm-up")
        self.setup_split = t.laps

    def step(self, k: int):
        nb, first = self.check.verdict_slot_major(self.pool[k % len(self.pool)])
        return int(nb), int(first)

    def layer_calls(self):
        def check_call():
            self.step(0)

        return {"check": check_call}

    def free_program(self):
        self.check = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, verdicts, cs):
        checker = RowChecker(cs)
        want = [(0, SENTINEL) if sites is None else judge.expected_faulted(checker, self.honest, *sites)
                for sites in self.faults]
        return {
            "template_rows_wrong": judge.check(
                judge.template_rows_wrong(cs, self.template, WitnessProgram(self.tape).free_slots), 0),
            "verdicts_wrong": judge.check(sum(v != want[k % len(want)] for k, v in enumerate(verdicts)), 0),
            "reference_bad_rows": judge.check(
                judge.reference_bad_rows(checker, self.honest, judge.sample(self.seed, self.B, 32)), 0),
        }

    def least_bytes(self, cs):
        return {"check": roofline.check_bytes(cs.rows, self.Bw)}

