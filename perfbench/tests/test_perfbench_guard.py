"""A run may load neither JAX nor the JAX package, compared on the whole
top-level module name, and the plain reference loads nothing of the
program."""

import subprocess
import sys

import pytest

import _perfbench_paths
from perfbench.lib.guard import forbidden_modules


@pytest.mark.parametrize("mods, want", [
    (["bellpepper_tpu_torch", "bellpepper_tpu_torch.backend.matvec", "torch"], []),
    (["bellpepper_tpu", "bellpepper_tpu.backend"], ["bellpepper_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jax_free", "bellpepper_tpu_x", "flaxen"], []),
])
def test_forbidden_names_compare_whole(mods, want):
    assert forbidden_modules(mods) == want


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=_perfbench_paths.ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_a_toy_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, '.')\n"
        "from perfbench.lib import bench, harness, guard\n"
        "cell = bench.Cell(bench.load(), 'sha256.check_2m')\n"
        "r = harness.run_cell(cell, 3, 0.01, False, 'cpu', time.monotonic(), instances=64)\n"
        "print(r['correct'], guard.forbidden_modules())\n"
    )
    assert _fresh(code) == "True []"


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from perfbench.lib.bench import load_module\n"
        "import perfbench.reference.control\n"
        "for n in ('sha256-compress', 'blake2s-compress'):\n"
        "    load_module(f'perfbench/reference/{n}.py', n).synthesize(7, 3)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'bellpepper_tpu_torch', 'bellpepper_tpu', 'jax'}))\n"
    )
    assert _fresh(code) == "[]"
