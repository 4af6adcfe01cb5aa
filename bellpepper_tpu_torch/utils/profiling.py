"""Phase profiling: wall-clock timers around synthesis, build, witness and
check phases, bridged to ``torch.profiler`` traces on request.

Counterpart of ``bellpepper_tpu/utils/profiling.py``, with the same report
format. A phase times the host's wall clock and adds no synchronize: work
that a phase enqueues on the card and does not wait for is counted in the
phase that waits for it. With ``trace=True`` the phase is also a
``torch.profiler.record_function`` range (a span in a profiler trace) and,
once CUDA is initialized, an NVTX range, so device traces line up with
host phases."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch

_PHASES: Dict[str, List[float]] = defaultdict(list)


@contextlib.contextmanager
def phase(name: str, trace: bool = False):
    """Time a named phase; with trace=True also mark it in profiler and
    NVTX traces."""
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(torch.profiler.record_function(name))
            if torch.cuda.is_initialized():
                stack.enter_context(torch.cuda.nvtx.range(name))
        t0 = time.perf_counter()
        yield
        _PHASES[name].append(time.perf_counter() - t0)


def phase_report(reset: bool = False) -> Dict[str, dict]:
    """Aggregate phase timings: {name: {count, total_s, mean_s}}."""
    out = {}
    for name, times in _PHASES.items():
        out[name] = {
            "count": len(times),
            "total_s": round(sum(times), 6),
            "mean_s": round(sum(times) / len(times), 6),
        }
    if reset:
        _PHASES.clear()
    return out
