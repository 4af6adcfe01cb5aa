#!/usr/bin/env python3
"""One step of the sharded production path over W ranks, each shard held
word-equal to single-rank execution; and the rank launcher of the port.

Counterpart of ``__graft_entry__.py:68-170`` (``dryrun_multichip``).
Across W ranks of a process group (one process a rank, spawned here) it
runs the flagship template, one sha256 compression (26,352 rows):

  * the unpacked step (``sharded_witness_and_check``, the bits form) at
    B = W, one instance a rank;
  * the packed step (``sharded_packed_witness_and_check``) at 512·W;
  * ``RowShardedSatisfier`` (bits form, one shard a rank) on 3 replicated
    compressions (79,056 rows), clean and with a witness bit flipped in
    the first and in the last copy, each located as on one rank.

Each rank compares its shard with its slice of the same step run whole on
its own device, so every shard is word-equal to single-rank execution.

    python3 -m bellpepper_tpu_torch.tools.dryrun_multichip 1                 # one rank, NCCL, on the card
    python3 -m bellpepper_tpu_torch.tools.dryrun_multichip 2 --backend gloo  # two ranks sharing one card
    python3 -m bellpepper_tpu_torch.tools.dryrun_multichip 2 --device cpu    # two ranks on the CPU (gloo)

``RankJob`` is the launcher the tests use too: W
spawned processes, a free local TCP port for the group's store, each
rank's result in a file, and any rank's failure raised in the caller."""

from __future__ import annotations

import argparse
import multiprocessing as mp
import multiprocessing.connection
import os
import shutil
import socket
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from bellpepper_tpu_torch import NativeBuilder, RowShardedSatisfier, WitnessProgram, pack_bits
from bellpepper_tpu_torch.backend.check_common import SENTINEL
from bellpepper_tpu_torch.backend.sharding import (
    default_group,
    rank_device,
    sharded_packed_witness_and_check,
    sharded_witness_and_check,
)
from bellpepper_tpu_torch.backend.words import from_numpy_u32
from bellpepper_tpu_torch.utils.multihost import init_group


def free_port() -> int:
    """A TCP port of localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n_ranks, port, backend, device, out, args):
    """A spawned rank: join the group, run fn(its device, *args), save
    the result to `out`; on failure write the traceback to out + '.err'
    and exit non-zero. The ranks share the host's CPU threads (torch's
    default, or OMP_NUM_THREADS): ranks that oversubscribe the cores spin
    in each other's way (two ranks of 8 threads on 8 cores ran the CPU dry
    run 15 times slower)."""
    torch.set_num_threads(max(1, torch.get_num_threads() // n_ranks))
    try:
        init_group(f"127.0.0.1:{port}", n_ranks, rank, backend, device)
        try:
            result = fn(rank_device(None, device), *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


class RankJob:
    """n_ranks spawned processes, started at once, rank r running
    fn(device, *args) in a process group over a free local port: the
    backend is the caller's, or nccl for a CUDA device and gloo for the
    CPU (``init_group``). fn must be importable by name (the processes are
    spawned) and return what ``torch.save`` stores; ``join`` gives the
    results."""

    def __init__(self, fn, n_ranks: int, *args, backend=None, device=None):
        self.dir = tempfile.mkdtemp(prefix="ranks-")
        self.outs = [os.path.join(self.dir, f"rank{r}.pt") for r in range(n_ranks)]
        ctx = mp.get_context("spawn")
        port = free_port()
        self.procs = [
            ctx.Process(target=_rank_main, args=(fn, r, n_ranks, port, backend, device, self.outs[r], args))
            for r in range(n_ranks)
        ]
        for p in self.procs:
            p.start()

    def join(self, timeout: float = 900.0) -> list:
        """Every rank's result, in rank order. A rank that fails (or the
        timeout) ends the others and raises, with the failed ranks'
        tracebacks."""
        deadline = time.monotonic() + timeout
        try:
            while True:
                alive = [p for p in self.procs if p.is_alive()]
                failed = [r for r, p in enumerate(self.procs) if p.exitcode not in (None, 0)]
                if not alive or failed:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks still running after {timeout:.0f} s")
                mp.connection.wait([p.sentinel for p in alive], min(left, 1.0))
            if failed:
                errs = []
                for r in failed:
                    path = self.outs[r] + ".err"
                    text = open(path).read() if os.path.exists(path) else ""
                    errs.append(f"rank {r} exited with {self.procs[r].exitcode}\n{text}")
                raise RuntimeError("\n".join(errs))
            return [torch.load(out) for out in self.outs]
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                p.join()
            shutil.rmtree(self.dir, ignore_errors=True)


def sha256_template():
    """The flagship template, one sha256 compression (constant IV, 512
    free message bits), through NativeBuilder: (template, tape)."""
    nb = NativeBuilder()
    bits = [nb.alloc_bit() for _ in range(512)]
    nb.sha256_compression(bits, nb.sha256_iv())
    return nb.finish()


def dryrun_rank(dev, seed: int = 3) -> dict:
    """One rank of the dry run (the group is the world): the three checks
    of the module docstring, its shards against its slices of the whole
    step run on `dev`. Returns the rank's verdicts and messages."""
    group = default_group()
    W, rank = dist.get_world_size(group), dist.get_rank(group)
    template, tape = sha256_template()
    prog = WitnessProgram(tape)
    rng = np.random.default_rng(seed)  # the same draws on every rank

    # the unpacked step: one instance a rank, the bits form
    step, shard = sharded_witness_and_check(prog, template, W, None, group=group, device=dev)
    free = rng.integers(0, 2, size=(W, 512)).astype(np.uint32)
    n_bad, z = step(shard(free))
    assert int(n_bad) == 0, f"unpacked dryrun found {int(n_bad)} violations"
    vals_single, _ = prog.build(device=dev)(from_numpy_u32(free, dev))
    assert torch.equal(z, vals_single[rank : rank + 1]), "sharded witness differs from single-rank execution"

    # the packed step: 512 instances a rank
    Bp = 512 * W
    pstep, pshard = sharded_packed_witness_and_check(prog, template, Bp, None, group=group, device=dev)
    free_p = from_numpy_u32(rng.integers(0, 2, size=(Bp, 512)).astype(np.uint32), dev)
    fp = pack_bits(free_p)
    nb_p, first_p, vals_p = pstep(pshard(fp))
    packed = (int(nb_p), int(first_p))
    assert packed == (0, SENTINEL), f"packed dryrun verdict {packed}"
    words = Bp // 32 // W
    single = prog.build_packed(device=dev)(fp)
    assert torch.equal(vals_p, single[rank * words : (rank + 1) * words]), "sharded packed witness differs"

    # the row-sharded check of 3 replicated compressions
    rep = 3
    big = template.replicate(rep)
    vals3, _ = prog.build(device=dev)(free_p[:rep])
    z_mono = torch.cat([vals3[0, :1]] + [vals3[i, 1:] for i in range(rep)])
    sat = RowShardedSatisfier(big, witness_form="bits", device=dev, group=group)
    one = RowShardedSatisfier(big, n_shards=1, witness_form="bits", device=dev)
    assert sat.is_satisfied(z_mono), "row-sharded dryrun: the clean witness is rejected"
    which = []
    for slot in (700, 700 + (rep - 1) * (template.num_aux)):  # a bit of the first and of the last copy
        z_bad = z_mono.clone()
        z_bad[slot] ^= 1
        got, want = sat.which_is_unsatisfied(z_bad), one.which_is_unsatisfied(z_bad)
        assert got is not None and got == want, (slot, got, want)
        which.append(got)
    return {"rank": rank, "world": W, "backend": dist.get_backend(group), "device": str(dev),
            "rows": template.num_constraints, "packed": packed, "big_rows": big.num_constraints, "which": which}


def dryrun_multichip(n_ranks: int, backend=None, device=None) -> list:
    """Run ``dryrun_rank`` on n_ranks spawned ranks (on the card unless
    `device` names another; the backend as ``RankJob`` picks it) and
    check that every rank saw the same verdicts. Returns the ranks'
    results."""
    results = RankJob(dryrun_rank, n_ranks, backend=backend, device=device).join()
    first = results[0]
    assert all(r["which"] == first["which"] and r["packed"] == first["packed"] for r in results), results
    print(f"dryrun_multichip OK: {n_ranks} ranks ({first['backend']}, {[r['device'] for r in results]}), "
          f"flagship sha256 ({first['rows']} constraints an instance): the unpacked step at batch {n_ranks} "
          f"and the packed step at batch {512 * n_ranks}, each rank's shard word-equal to single-rank "
          f"execution; the row-sharded {first['big_rows']}-row system clean, and a flipped bit in its "
          f"first and last copies located as on one rank: {first['which']}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", type=int, nargs="?", default=1)
    ap.add_argument("--backend", default=None, help="the process group's backend (default: nccl on the card)")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.backend, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
