"""Traffic kind `field_step`: a closed loop of one client, each step a
batch of step instances of a circuit over a prime field through the
program's field-path production step (``build_production_step(...,
witness_form="mixed")``: the evaluator, then ``MixedCheck``) in chunks,
the verdict read on the host. Inputs: one batch of advice that the
reference makes from the seed (windows of a few long chains, see the
configuration's reference), uploaded in the program's free-field layout
and used by every step.

The reference's synthesis and advice are timed apart (`reference_s`).

`correct` judges the step that the window times, whose evaluator and
check are caught as the step builds them (``prog.build`` and
``pipeline.build_templated_check``, wrapped for that call). Every window
step's verdict is (0, 0xFFFFFFFF). After the window the step runs once
more, and every computed field value that its evaluator hands its check
is held against the reference's; then it runs with additive faults mod p
planted at seeded (instance, variable) sites in those values, and its
verdict (n_bad, first) must equal the reference's for the faulted
witness."""

from __future__ import annotations

import gc

import numpy as np
import torch

from bellpepper_tpu_torch.compile import pipeline
from perfbench.lib import field_roofline, judge
from perfbench.reference.circuit import SENTINEL

BLOCK = 32  # instances a block of the reference's work after the window


def parts_of_step(prog, template, chunk: int, device):
    """The program's mixed production step and the evaluator and check that
    it closes over, caught while the step is built."""
    kept = {"evaluator": [], "check": []}
    build_check, build = pipeline.build_templated_check, prog.build

    def keep_check(*args, **kwargs):
        kept["check"].append(build_check(*args, **kwargs))
        return kept["check"][-1]

    def keep_evaluator(*args, **kwargs):
        kept["evaluator"].append(build(*args, **kwargs))
        return kept["evaluator"][-1]

    pipeline.build_templated_check, prog.build = keep_check, keep_evaluator
    try:
        step = pipeline.build_production_step(prog, template, chunk, witness_form="mixed", device=device)
    finally:
        pipeline.build_templated_check = build_check
        del prog.build
    if len(kept["evaluator"]) != 1 or len(kept["check"]) != 1:
        raise RuntimeError(f"the step built {len(kept['evaluator'])} evaluators and {len(kept['check'])} "
                           "checks; the benchmark judges the pair that the step calls")
    return step, kept["evaluator"][0], kept["check"][0]


def add_mod_p(flimbs: torch.Tensor, local, rows, deltas, p: int) -> None:
    """Add deltas[j] mod p to the canonical limbs flimbs[rows[j], :,
    local[j]] (int32[F, 16, B]), in place."""
    r = torch.as_tensor(rows, device=flimbs.device)
    b = torch.as_tensor(local, device=flimbs.device)
    limbs = flimbs[r, :, b].to(torch.int64).cpu().numpy() & 0xFFFF  # [n, 16]
    new = []
    for row, d in zip(limbs, deltas):
        x = sum(int(v) << (16 * j) for j, v in enumerate(row))
        y = (x + d) % p
        new.append([(y >> (16 * j)) & 0xFFFF for j in range(16)])
    flimbs[r, :, b] = torch.tensor(new, dtype=torch.int32, device=flimbs.device)


class Traffic:
    def __init__(self, cell, seed: int, device, instances: int, builder):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.B = instances
        self.chunk = min(cell.traffic["chunk"], instances)
        self.n_chains = min(cell.traffic["chains"], instances)
        if instances % self.chunk or instances % self.n_chains:
            raise ValueError(f"{instances} instances are not whole chunks of {self.chunk} and windows of "
                             f"{self.n_chains} chains")
        self.windows = instances // self.n_chains
        self.builder = builder

    def setup(self, reference_circuit):
        t = judge.Stopwatch()
        cs = reference_circuit()
        self.chain_limbs = cs.chain_limbs(cs.chains(self.seed, self.n_chains, self.windows))
        t.lap("reference's advice")
        self.reference_s = t.laps["reference's advice"]
        self.template, self.prog = self.builder.build()
        t.lap("circuit")
        prog = self.prog
        self.n_fr = prog.n_field_rows
        ff_index = {s: i for i, s in enumerate(prog.free_field_slots)}
        if any(s not in ff_index for s in prog.free_slots):
            raise ValueError("the program reads a free slot as u32; this kind gives field inputs only")
        # instance g·windows + o: chain g's window at offset o, in the program's free-field order
        offsets = dict(zip(cs.free, cs.free_offsets))
        pos = torch.tensor([offsets.get(s, 0) for s in prog.free_field_slots], device=self.device)
        limbs = torch.from_numpy(self.chain_limbs.astype(np.int32)).to(self.device)  # [G, L, 16]
        o = torch.arange(self.windows, device=self.device)
        self.free_field = limbs[:, o[:, None] + pos[None, :]].reshape(
            self.B // self.chunk, self.chunk, len(pos), 16)
        del limbs
        low = self.free_field.index_select(2, torch.tensor([ff_index[s] for s in prog.free_slots],
                                                           device=self.device))
        self.free_bits = (low[..., 0] | (low[..., 1] << 16)).contiguous()  # each free slot's low 32 bits
        del low
        t.lap("inputs")
        self.run, self.evaluator, self.check = parts_of_step(prog, self.template, self.chunk, self.device)
        t.lap("step built")
        self.step(0)
        t.lap("warm-up")
        self.setup_split = t.laps

    def step(self, k: int):
        total, first = self.run(self.free_bits, self.free_field)
        return int(total), int(first)

    # -- the layers, for the traced run --------------------------------------
    def layer_calls(self):
        held = {}

        def witness():
            held["out"] = self.evaluator.slot_major(self.free_bits[0], self.free_field[0], free_rows=True)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def check_call():
            if "out" not in held:
                witness()
            nb, first = self.check.verdict_slot_major(*held["out"])
            int(nb), int(first)

        return {"witness": witness, "check": check_call}

    # -- correctness: the step's outputs after the window ---------------------
    def _through_step(self, faults=None):
        """Run the timed step once, keeping the computed field values that
        its evaluator hands its check, a chunk a call (or, with `faults`
        {chunk: (local instances, limb rows, deltas)}, adding each delta
        mod p on their way); return (verdict, values a chunk)."""
        ev, seen = self.evaluator, []
        produce = ev.slot_major

        def slot_major(*args, **kwargs):
            out = produce(*args, **kwargs)
            k = len(seen)
            if faults is None:
                seen.append(out[1][: self.n_fr].clone())
            else:
                seen.append(None)
                if k in faults:
                    add_mod_p(out[1], *faults[k], self.prog.field.p)
            return out

        ev.slot_major = slot_major
        try:
            verdict = self.step(0)
        finally:
            del ev.slot_major
        return verdict, seen

    def collect(self):
        """The step's values of every instance and its verdict, then its
        verdict with additive faults planted, before the program is freed."""
        n_vars = self.template.num_inputs + self.template.num_aux
        inst, var = judge.fault_sites(self.seed, self.B, n_vars, self.cell.traffic["faults"])
        p = self.prog.field.p
        rng = np.random.default_rng([self.seed, 0xADD])
        deltas = [1 + int.from_bytes(rng.bytes(40), "little") % (p - 1) for _ in inst]
        self.sites = (inst, var, deltas)
        row_of = {s: i for i, s in enumerate(self.prog.field_slots)}
        faults = {}
        for i, v, d in zip(inst.tolist(), var.tolist(), deltas):
            if v not in row_of:
                raise ValueError(f"fault site variable {v} is no field slot")
            local, rows, ds = faults.setdefault(i // self.chunk, ([], [], []))
            local.append(i % self.chunk)
            rows.append(row_of[v])
            ds.append(d)
        self.after_verdict, self.values = self._through_step()
        self.faulted_verdict = self._through_step(faults)[0]

    def free_program(self):
        self.run = self.evaluator = self.check = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _values_wrong(self, cs, field) -> int:
        """Computed values (x^2 and x^4 of each iteration) that the step
        handed its check unlike the reference's; a chunk the step never
        handed over, or of another shape, counts all wrong."""
        rows = self.prog.field_rows
        sq_rows = torch.tensor([rows.get(v, -1) for v in cs.sq_vars], device=self.device)
        quad_rows = torch.tensor([rows.get(v, -1) for v in cs.quad_vars], device=self.device)
        n_chunks, per_chunk = self.B // self.chunk, 2 * cs.n_iters * self.chunk
        wrong = per_chunk * max(0, n_chunks - len(self.values))
        for k, vals in enumerate(self.values[:n_chunks]):
            if (vals is None or tuple(vals.shape) != (self.n_fr, 16, self.chunk)
                    or bool((sq_rows < 0).any() or (quad_rows < 0).any())):
                wrong += per_chunk
                continue
            for b0 in range(0, self.chunk, BLOCK):
                b1 = min(b0 + BLOCK, self.chunk)
                inst = np.arange(k * self.chunk + b0, k * self.chunk + b1)
                x = cs.advice(self.chain_limbs, inst, self.windows, self.device)[2:]  # x_1 .. x_N
                sq, quad = cs.powers(x.transpose(0, 1).reshape(16, -1), field)
                for want, r in ((sq, sq_rows), (quad, quad_rows)):
                    got = vals[r, :, b0:b1].to(torch.int64).transpose(0, 1).reshape(16, -1)
                    wrong += int((got != want).any(0).sum())
            self.values[k] = None
        return wrong

    def judge(self, verdicts, cs):
        field = cs.plain_field(self.device)
        out = {"template_rows_wrong": judge.check(
            judge.template_rows_wrong(cs, self.template, self.prog.free_slots), 0)}
        out["verdicts_wrong"] = judge.check(
            sum(v != (0, SENTINEL) for v in list(verdicts) + [self.after_verdict]), 0)
        out["witness_values_wrong"] = judge.check(self._values_wrong(cs, field), 0)
        inst, var, deltas = self.sites
        z = cs.witness(cs.advice(self.chain_limbs, inst, self.windows, self.device), field)
        cs.plant(z, var, deltas)
        out["faulted_verdict_wrong"] = judge.check(int(self.faulted_verdict != cs.verdict(z, inst, field)), 0)
        del z
        sample = judge.sample(self.seed, self.B, 4)
        z = cs.witness(cs.advice(self.chain_limbs, sample, self.windows, self.device), field)
        out["reference_bad_rows"] = judge.check(cs.verdict(z, sample, field)[0], 0)
        return out

    def least_bytes(self, cs):
        return {"witness": field_roofline.witness_work(cs, self.chunk),
                "check": field_roofline.check_work(cs, self.chunk)}
