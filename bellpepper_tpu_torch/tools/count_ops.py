#!/usr/bin/env python3
"""Count the aten ops that one call of the unpacked evaluator dispatches.

The template is the chain step of configs 4 and 4b: one sha256
compression whose 256 IV bits are free and allocated before the 512
message bits (26,960 rows, 26,935 slots). One call of
``Evaluator.slot_major`` runs on the CPU under a ``TorchDispatchMode``
that counts every op by name, at batches 1 and 64 (the count does not
depend on the batch); a CUDA graph of the block on the card holds the
same op sequence.

    python3 bellpepper_tpu_torch/tools/count_ops.py [--root DIR]

``--root`` imports the package from another checkout (an unpacked
``git archive`` of an older commit), to count its evaluator the same way."""

import argparse
import collections
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--root", default=here, help="the checkout whose package is counted")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from bellpepper_tpu_torch import NativeBuilder, WitnessProgram

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    nb = NativeBuilder()
    state = [nb.alloc_bit() for _ in range(256)]
    nb.sha256_compression([nb.alloc_bit() for _ in range(512)], state)
    template, tape = nb.finish()
    prog = WitnessProgram(tape)
    evaluator = prog.build(device="cpu")
    print(f"chain template: {template.num_constraints} rows, {prog.num_slots} slots, {len(prog.stages)} stages; "
          f"package from {os.path.abspath(args.root)}")
    for B in (1, 64):
        free = torch.randint(0, 2, (B, len(prog.free_slots)), dtype=torch.int32)
        with Count() as c:
            evaluator.slot_major(free)
        top = ", ".join(f"{k} {n}" for k, n in c.ops.most_common(8))
        print(f"B {B}: {sum(c.ops.values())} aten ops a call ({top})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
