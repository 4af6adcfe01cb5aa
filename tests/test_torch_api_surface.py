"""The port keeps the JAX package's public surface.

For each of the 19 ported frontend modules and the package itself, every
name and signature that tests/api_surface.json pins for
``bellpepper_tpu.<mod>`` exists alike in ``bellpepper_tpu_torch.<mod>``
(strictly: the walk below is tests/test_api_surface.py's, under the
port's module names; names the port adds may be extra).

For the 11 device-layer modules every name exists in the port, and every
function and method takes the reference's parameters first: the same
names, kinds and defaults in the same order (annotations, ``self`` and
the reference's private ``_`` parameters aside). The port's own
parameters (``device``, ``group``, ``n_shards``, ``dim``) come after, each
keyword-only or with a default. ``backend.field_jnp`` is the port's
``backend.field_backend``. The snapshot is read as JSON only."""

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


# reference module → the port's module of the same names
DEVICE_MODULES = {
    ".backend.field_jnp": ".backend.field_backend",
    ".backend.matvec": ".backend.matvec",
    ".backend.sharding": ".backend.sharding",
    ".compile.pipeline": ".compile.pipeline",
    ".compile.witness_program": ".compile.witness_program",
    ".config": ".config",
    ".fields": ".fields",
    ".native": ".native",
    ".utils.multihost": ".utils.multihost",
    ".utils.profiling": ".utils.profiling",
    ".utils.serialize": ".utils.serialize",
}
_P = inspect.Parameter


def _split_top(s: str, sep: str):
    """s split at the `sep` characters outside brackets and quotes."""
    out, depth, quote, cur = [], 0, None, ""
    for ch in s:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == sep and depth == 0:
            out.append(cur)
            cur = ""
            continue
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        cur += ch
    return out + [cur]


def parse_params(sig: str):
    """A snapshot signature string → [(name, kind, default text or None)]."""
    body = _split_top(sig.strip()[1:], ")")[0]
    params, kind = [], _P.POSITIONAL_OR_KEYWORD
    for p in (x.strip() for x in _split_top(body, ",") if x.strip()):
        if p == "*":
            kind = _P.KEYWORD_ONLY
        elif p == "/":
            params = [(n, _P.POSITIONAL_ONLY, d) for n, _k, d in params]
        elif p.startswith("**"):
            params.append((p[2:].split(":")[0].strip(), _P.VAR_KEYWORD, None))
        elif p.startswith("*"):
            params.append((p[1:].split(":")[0].strip(), _P.VAR_POSITIONAL, None))
            kind = _P.KEYWORD_ONLY
        else:
            head, *default = _split_top(p, "=")
            params.append((head.split(":")[0].strip(), kind, "=".join(default).strip() if default else None))
    return params


def port_params(obj):
    return [(p.name, p.kind, None if p.default is _P.empty else repr(p.default))
            for p in inspect.signature(obj).parameters.values()]


def _public(params):
    return [p for p in params if p[0] not in ("self", "cls") and not p[0].startswith("_")]


def params_problems(ref_sig: str, obj, what: str) -> list:
    ref = _public(parse_params(ref_sig))
    try:
        got = _public(port_params(obj))
    except (TypeError, ValueError):
        return [f"{what}: no signature"]
    problems = []
    if got[: len(ref)] != ref:
        problems.append(f"{what}: parameters differ\n  reference: {ref}\n  port:      {got}")
    for name, kind, default in got[len(ref):]:
        if kind not in (_P.KEYWORD_ONLY, _P.VAR_POSITIONAL, _P.VAR_KEYWORD) and default is None:
            problems.append(f"{what}: the port's extra parameter {name} is positional and required")
    return problems


def test_parameter_rule_parses_snapshot_signatures():
    got = parse_params("(self, field: 'PrimeField' = PrimeField(bls12_381_fr, 255 bits), names=('a', 'b'), "
                       "*, k: 'int' = 2, **kw) -> 'X'")
    assert got == [("self", _P.POSITIONAL_OR_KEYWORD, None),
                   ("field", _P.POSITIONAL_OR_KEYWORD, "PrimeField(bls12_381_fr, 255 bits)"),
                   ("names", _P.POSITIONAL_OR_KEYWORD, "('a', 'b')"),
                   ("k", _P.KEYWORD_ONLY, "2"), ("kw", _P.VAR_KEYWORD, None)]

    def port(template, batch, use_pallas, witness_form="limbs", field_slots=None, *, device=None):
        pass

    ref = "(template: 'R1CS', batch: 'int', use_pallas: 'bool', witness_form: 'str' = 'limbs', " \
          "_partition: 'bool' = True, field_slots=None)"
    assert params_problems(ref, port, "f") == []

    def moved(template, batch, witness_form="limbs", use_pallas=None, device=None):
        pass

    assert params_problems(ref, moved, "f")

    def extra_required(template, batch, use_pallas, witness_form="limbs", field_slots=None, device=None, z=0, w=None):
        pass

    assert params_problems(ref, extra_required, "f") == []
    assert params_problems("(a)", lambda a, b: None, "f") == [
        "f: the port's extra parameter b is positional and required"]


@pytest.mark.parametrize("ref_suffix", list(DEVICE_MODULES), ids=[s.lstrip(".") for s in DEVICE_MODULES])
def test_port_device_module_takes_reference_parameters(ref_suffix):
    with open(SNAPSHOT) as f:
        frozen = json.load(f)[REF + ref_suffix]
    mod = importlib.import_module(PORT + DEVICE_MODULES[ref_suffix])
    problems = []
    for name, spec in frozen.items():
        what = f"{mod.__name__}.{name}"
        if not hasattr(mod, name):
            problems.append(f"{what}: missing")
            continue
        obj = getattr(mod, name)
        if spec["kind"] == "function":
            problems += params_problems(spec["sig"], obj, what)
        elif spec["kind"] == "class":
            if not inspect.isclass(obj):
                problems.append(f"{what}: not a class")
                continue
            for mn, msig in spec["methods"].items():
                if not hasattr(obj, mn):
                    problems.append(f"{what}.{mn}: missing")
                elif msig == "<property>":
                    if not isinstance(inspect.getattr_static(obj, mn), property):
                        problems.append(f"{what}.{mn}: not a property")
                else:
                    problems += params_problems(msig, getattr(obj, mn), f"{what}.{mn}")
    assert not problems, "\n".join(problems[:40])
