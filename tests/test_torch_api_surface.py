"""The port's frontend keeps the JAX package's public surface: for each of
the 19 ported frontend modules and the package itself, every name and
signature that tests/api_surface.json pins for ``bellpepper_tpu.<mod>``
exists alike in ``bellpepper_tpu_torch.<mod>``. The snapshot is read as
JSON only; the walk below is tests/test_api_surface.py's, under the
port's module names. Names the port adds may be extra."""

import importlib
import inspect
import json
import os

import pytest

SNAPSHOT = os.path.join(os.path.dirname(__file__), "api_surface.json")
REF, PORT = "bellpepper_tpu", "bellpepper_tpu_torch"
MODULES = [
    "",
    ".constraint_system",
    ".lc",
    ".r1cs",
    ".gadgets",
    ".gadgets.boolean",
    ".gadgets.boolean_utils",
    ".gadgets.num",
    ".gadgets.uint32",
    ".gadgets.multieq",
    ".gadgets.multipack",
    ".gadgets.lookup",
    ".gadgets.sha256",
    ".gadgets.blake2s",
    ".util_cs",
    ".util_cs.test_cs",
    ".util_cs.witness_cs",
    ".util_cs.metric_cs",
    ".util_cs.bench_cs",
    ".compile.tape",
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "<no-signature>"


def _public_names(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    return sorted(names)


def module_surface(modname: str) -> dict:
    """tests/test_api_surface.py's entry of one module, for the port's
    objects (owned by a ``bellpepper_tpu_torch`` module)."""
    mod = importlib.import_module(modname)
    entry = {}
    for name in _public_names(mod):
        obj = getattr(mod, name)
        if inspect.ismodule(obj):
            continue
        owner = getattr(obj, "__module__", "") or ""
        if owner and not owner.startswith(PORT):
            if not isinstance(obj, (int, str, tuple, list, dict)):
                continue
        if inspect.isclass(obj):
            methods = {}
            for mn, mv in sorted(vars(obj).items()):
                if mn.startswith("_") and mn not in ("__init__",):
                    continue
                if isinstance(mv, (staticmethod, classmethod)):
                    mv = mv.__func__
                if callable(mv):
                    methods[mn] = _sig(mv)
                elif isinstance(mv, property):
                    methods[mn] = "<property>"
            entry[name] = {"kind": "class", "methods": methods}
        elif callable(obj):
            entry[name] = {"kind": "function", "sig": _sig(obj)}
        else:
            entry[name] = {"kind": "value", "type": type(obj).__name__}
    return entry


@pytest.mark.parametrize("suffix", MODULES, ids=[s.lstrip(".") or "package" for s in MODULES])
def test_port_module_keeps_reference_surface(suffix):
    with open(SNAPSHOT) as f:
        frozen = json.load(f)[REF + suffix]
    current = module_surface(PORT + suffix)
    problems = []
    for name, spec in frozen.items():
        got = current.get(name)
        if got is None:
            problems.append(f"{PORT}{suffix}.{name}: missing")
        elif got != spec:
            problems.append(f"{PORT}{suffix}.{name}: differs\n  reference: {spec}\n  port:      {got}")
    assert not problems, "\n".join(problems[:40])
