"""An exact count of the aten ops one call dispatches (the counter of
bellpepper_tpu_torch/tools/count_ops.py, frozen here). A hand-written
kernel launched through ctypes is no aten op and is not counted."""

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn) -> int:
    """Aten ops dispatched by fn(), which ends in a synchronize."""
    with OpCounter() as c:
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return sum(c.ops.values())
