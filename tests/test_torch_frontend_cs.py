"""The port's constraint-system frontend (``lc``, ``constraint_system``,
``util_cs`` and ``r1cs``) against the JAX package's: the cases of
tests/test_core_cs.py and tests/test_api_parity.py, each run once a package
on the same inputs, with the original asserts, and their observations
(LC terms, paths, hashes, pretty prints, deltas, assignments, R1CS
arrays) compared equal. No JAX function runs here: both frontends are host
Python."""

import hashlib
import importlib
import json
import random
import struct
from types import SimpleNamespace

import numpy as np
import pytest

REF, PORT = "bellpepper_tpu", "bellpepper_tpu_torch"


def pkg(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(top=importlib.import_module(root), lc=mod("lc"), cs=mod("constraint_system"),
                           r1cs=mod("r1cs"), num=mod("gadgets.num"))


def plain(x):
    """A package-free form of an observation: LCs as their (index,
    coefficient) terms, variables as (tag, index), deltas as (kind, info),
    numpy arrays as lists."""
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    name = type(x).__name__
    if name == "LinearCombination":
        return ("lc", tuple(x.inputs.iter()), tuple(x.aux.iter()))
    if name == "Variable":
        return ("var", x.index.tag, x.index.idx)
    if name == "Delta":
        return ("delta", x.kind, plain(x.info))
    return x


def raised(fn):
    """(exception type, message) of fn(), or None if it returns."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the observation
        return type(e).__name__, str(e)
    return None


def r1cs_arrays(r):
    return (r.num_inputs, r.num_aux, r.num_constraints, list(r.coeff_table), r.names,
            *((getattr(r, m).rows, getattr(r, m).cols, getattr(r, m).coeff_ids) for m in "abc"))


# -- the cases of tests/test_core_cs.py --------------------------------------

def indexer_insert_or_update(m):
    ix = m.lc.Indexer()
    p = m.top.SCALAR.p
    states = []
    for idx in (2, 3, 1, 2):
        ix.add(idx, 1, p)
        states.append((list(ix.iter()), ix.last_inserted))
    assert states[-1] == ([(1, 1), (2, 2), (3, 1)], (0, 1))
    return states


def lc_add_simplify(m):
    n = 5
    lc = m.top.LinearCombination.zero(m.top.SCALAR)
    for i in range(n):
        for _ in range(i + 1):
            lc = lc + (1, m.lc.Variable(m.lc.Index.aux(i)))
    assert len(lc) == n
    # and the operator surface: lc ± var, ± (coeff, var), ± lc, ± (coeff, lc)
    one = m.top.ConstraintSystem.one()
    v = m.lc.Variable(m.lc.Index.aux(7))
    lc2 = (lc - v + (3, one)) - (5, lc) + lc + (2, lc)
    return list(lc.iter()), lc2


def compute_path(m):
    got = m.cs.compute_path(("hello", "world", "things"), "thing")
    assert got == "hello/world/things/thing"
    return got, raised(lambda: m.cs.compute_path((), "has/slash"))


def cs_set_and_unsatisfied(m):
    cs = m.top.TestConstraintSystem()
    obs = [cs.is_satisfied(), cs.num_constraints()]
    a = cs.namespace("a").alloc("var", 10)
    b = cs.namespace("b").alloc("var", 4)
    c = cs.alloc("product", 40)
    cs.enforce("mult", lambda lc: lc + a, lambda lc: lc + b, lambda lc: lc + c)
    obs += [cs.is_satisfied(), cs.num_constraints()]
    cs.set("a/var", 4)
    one = m.top.TestConstraintSystem.one()
    cs.enforce("eq", lambda lc: lc + a, lambda lc: lc + one, lambda lc: lc + b)
    obs += [cs.is_satisfied(), cs.which_is_unsatisfied(), cs.get("product")]
    cs.set("product", 16)
    ns2 = cs.namespace("test1").namespace("test2")
    ns2.alloc("hehe", 1)
    obs += [cs.is_satisfied(), cs.get("test1/test2/hehe"), cs.hash()]
    assert obs[:8] == [True, 0, True, 1, False, "mult", 40, True]
    return obs


def duplicate_path_panics(m):
    cs = m.top.TestConstraintSystem()
    cs.alloc("x", 1)
    got = raised(lambda: cs.alloc("x", 2))
    assert got[0] == "AssertionError"
    return got


def namespace_nesting_paths(m):
    cs = m.top.TestConstraintSystem()
    v = cs.namespace("outer").namespace("inner").alloc("v", 7)
    assert cs.get("outer/inner/v") == 7 and v.index.is_aux()
    return v, cs.aux(), cs.inputs()


def hash_stable_and_shape_sensitive(m):
    def build(val):
        cs = m.top.TestConstraintSystem()
        a = cs.alloc("a", val)
        b = cs.alloc("b", 3)
        c = cs.alloc("c", (val * 3) % m.top.SCALAR.p)
        cs.enforce("mul", lambda lc: lc + a, lambda lc: lc + b, lambda lc: lc + c)
        return cs

    h1 = build(2).hash()
    assert h1 == build(9).hash() and len(h1) == 64
    cs3 = build(2)
    cs3.enforce("extra", lambda lc: lc, lambda lc: lc, lambda lc: lc)
    assert cs3.hash() != h1
    return h1, cs3.hash()


def hash_known_vector(m):
    h = m.top.TestConstraintSystem().hash()
    assert h == hashlib.blake2s(struct.pack(">QQQ", 1, 0, 0)).hexdigest()
    return h


def metric_cs_delta_equal(m):
    def synth(cs):
        a = cs.alloc("a", 3)
        b = cs.alloc("b", 4)
        c = cs.alloc("c", 12)
        cs.enforce("mul", lambda lc: lc + a, lambda lc: lc + b, lambda lc: lc + c)

    test_cs, metric_cs = m.top.TestConstraintSystem(), m.top.MetricCS()
    synth(test_cs)
    synth(metric_cs)
    d = test_cs.delta(metric_cs, False)
    assert d == m.top.Delta.Equal and "mul" in metric_cs.pretty_print()
    return d, metric_cs.pretty_print(), metric_cs.pretty_print_list()


def metric_cs_delta_mismatch(m):
    test_cs = m.top.TestConstraintSystem()
    a = test_cs.alloc("a", 3)
    test_cs.enforce("c0", lambda lc: lc + a, lambda lc: lc + a, lambda lc: lc + a)
    metric = m.top.MetricCS()
    b = metric.alloc("a", None)
    metric.enforce("c0", lambda lc: lc + b + b, lambda lc: lc + b, lambda lc: lc + b)
    d = test_cs.delta(metric, False)
    assert d.kind == m.top.Delta.CONSTRAINT_MISMATCH and d.info[0] == 0
    return d


def bench_cs_counts(m):
    cs = m.top.BenchCS()
    a = cs.alloc("a", None)
    b = cs.alloc_input("b", None)
    cs.enforce("c", lambda lc: lc, lambda lc: lc, lambda lc: lc)
    counts = (cs.num_constraints(), cs.num_inputs(), cs.num_aux())
    assert counts == (1, 2, 1) and a.index.is_aux() and b.index.is_input()
    return counts, a, b


def witness_cs_basic_and_extend(m):
    cs = m.top.WitnessCS()
    assert cs.is_witness_generator()
    cs.alloc("x", 5)
    cs.alloc_input("y", 6)
    cs.enforce("noop", lambda lc: lc, lambda lc: lc, lambda lc: lc)
    before = (list(cs.input_assignment), list(cs.aux_assignment))
    other = m.top.WitnessCS()
    other.alloc_input("z", 9)
    other.alloc("w", 11)
    cs.extend(other)
    assert (cs.input_assignment, cs.aux_assignment) == ([1, 6, 9], [5, 11])
    return before, cs.input_assignment, cs.aux_assignment


def witness_cs_allocate_empty(m):
    cs = m.top.WitnessCS()
    aux, inputs = cs.allocate_empty(3, 2)
    aux[0] = 7
    inputs[1] = 8
    more_aux = cs.allocate_empty_aux(2)
    more_aux[1] = 4
    more_in = cs.allocate_empty_inputs(1)
    more_in[0] = 3
    assert cs.aux_assignment[:3] == [7, 0, 0] and cs.input_assignment[:3] == [1, 0, 8]
    return len(aux), len(inputs), cs.inputs_slice(), cs.aux_slice()


def extend_matches_sequential(m):
    def part1(cs):
        cs.alloc("a", 5)
        cs.alloc_input("pub1", 10)

    def part2(cs):
        cs.alloc("b", 6)
        cs.alloc_input("pub2", 20)

    seq, cs1, cs2, merged = (m.top.WitnessCS() for _ in range(4))
    part1(seq)
    part2(seq)
    part1(cs1)
    part2(cs2)
    merged.extend(cs1)
    merged.extend(cs2)
    assert merged == seq
    return merged.to_assignments()


def verify_inputs(m):
    cs = m.top.TestConstraintSystem()
    cs.alloc_input("x", 3)
    cs.alloc_input("y", 4)
    obs = (cs.verify([3, 4]), cs.verify([3, 5]), cs.get_input(1, "x"), cs.get_inputs())
    assert obs[:3] == (True, False, 3)
    return obs


# -- the cases of tests/test_api_parity.py -----------------------------------

def version_export(m):
    assert m.top.__version__ == m.top.BELLPEPPER_TPU_VERSION
    return m.top.BELLPEPPER_TPU_VERSION


def pretty_print_list_format(m):
    cs = m.top.TestConstraintSystem()
    a = m.num.AllocatedNum.alloc(cs.namespace("x"), 2)
    a.square(cs.namespace("y"))
    items = cs.pretty_print_list()
    assert items[0] == "INPUT ONE" and "AUX x/num" in items and "y/squaring constraint" in items
    assert cs.pretty_print() == "\n".join(items)
    return items


def metric_pretty_print_renders_constraints(m):
    cs = m.top.MetricCS()
    a = m.num.AllocatedNum.alloc(cs.namespace("x"), None)
    a.square(cs.namespace("y"))
    out = cs.pretty_print()
    assert "y/squaring constraint: (`Ax/num`) * (`Ax/num`) = (`Ay/squared num`)" in out
    return out


def delta_ignore_counts(m):
    def build(variant):
        cs = m.top.TestConstraintSystem()
        a = m.num.AllocatedNum.alloc(cs.namespace("x"), 3)
        b = a.square(cs.namespace("y"))
        if variant:
            b.mul(cs.namespace("z"), b)
            cs.alloc_input("extra", 1)
        else:
            b.mul(cs.namespace("z"), a)
        return cs

    a, b = build(False), build(True)
    d, d2 = a.delta(b, False), a.delta(b, True)
    assert d.kind == m.top.Delta.INPUT_COUNT_MISMATCH
    assert d2.kind == m.top.Delta.CONSTRAINT_MISMATCH and d2.info[0] == 1
    return d, d2


def witness_cs_assignment_roundtrip(m):
    w = m.top.WitnessCS()
    w.alloc("a", 5)
    w.alloc_input("b", 6)
    w2 = m.top.WitnessCS.from_assignments(*w.to_assignments())
    assert w2 == w and w2.inputs_slice() == [1, 6] and w2.aux_slice() == [5]
    return w2.to_assignments()


def namespace_push_pop_panics(m):
    ns = m.top.TestConstraintSystem().namespace("a")
    got = raised(lambda: ns.push_namespace("b")), raised(lambda: ns.pop_namespace())
    assert got[0][0] == got[1][0] == "RuntimeError"
    assert "root's push_namespace" in got[0][1] and "root's pop_namespace" in got[1][1]
    return got


def variable_allocated_num_serde(m):
    v = m.lc.Variable(m.lc.Index.aux(7))
    j = json.loads(json.dumps(v.to_json()))
    assert j == {"Aux": 7} and m.lc.Variable.from_json(j) == v
    cs = m.top.TestConstraintSystem()
    n = m.num.AllocatedNum.alloc(cs.namespace("x"), m.top.SCALAR.p - 2)
    jn = json.loads(json.dumps(n.to_json()))
    n2 = m.num.AllocatedNum.from_json(jn)
    assert n2.get_value() == n.get_value() and n2.get_variable() == n.get_variable()
    n3 = m.num.AllocatedNum(None, m.lc.Variable(m.lc.Index.aux(3)))
    return j, jn, n3.to_json(), m.num.AllocatedNum.from_json(n3.to_json()).get_value()


def synthesis_error_taxonomy(m):
    """The error classes, their base and their messages."""
    names = sorted(n for n, v in vars(m.cs).items()
                   if isinstance(v, type) and issubclass(v, m.cs.SynthesisError))
    return [(n, [b.__name__ for b in getattr(m.cs, n).__mro__[:3]], str(getattr(m.cs, n)()))
            for n in names]


# -- R1CS: from_test_cs, extend, replicate, eval_host -------------------------

def small_circuit(m, cs, x: int, inputs: bool):
    """x, x², x³ + x + 5 as an AllocatedNum chain, the result optionally
    made an input (tests/test_device_satisfy.py's cube circuit)."""
    p = m.top.SCALAR.p
    a = m.num.AllocatedNum.alloc(cs.namespace("x"), x)
    sq = a.square(cs.namespace("sq"))
    cube = sq.mul(cs.namespace("cube"), a)
    out = m.num.AllocatedNum.alloc_maybe_input(cs.namespace("out"), inputs, (x ** 3 + x + 5) % p)
    five = m.top.ConstraintSystem.one()
    cs.enforce("out = cube + x + 5", lambda lc: lc + cube.get_variable() + a.get_variable() + (5, five),
               lambda lc: lc + five, lambda lc: lc + out.get_variable())
    return out


def r1cs_from_test_cs_and_eval_host(m):
    cs = m.top.TestConstraintSystem()
    small_circuit(m, cs, 3, True)
    r = m.r1cs.R1CS.from_test_cs(cs)
    ok = r.eval_host(cs.scalar_inputs(), cs.scalar_aux())
    aux = list(cs.scalar_aux())
    aux[1] += 1
    bad = r.eval_host(cs.scalar_inputs(), aux)
    assert ok == (True, None) and bad[0] is False
    return r1cs_arrays(r), ok, bad


def r1cs_extend(m):
    parts = []
    for x, inputs in ((3, True), (5, False), (7, True)):
        cs = m.top.TestConstraintSystem()
        small_circuit(m, cs, x, inputs)
        parts.append((m.r1cs.R1CS.from_test_cs(cs), cs.scalar_inputs(), cs.scalar_aux()))
    r, z_in, z_aux = parts[0]
    for r2, in2, aux2 in parts[1:]:
        r = r.extend(r2)
        z_in, z_aux = z_in + in2[1:], z_aux + aux2
    assert r.eval_host(z_in, z_aux) == (True, None)
    return r1cs_arrays(r)


def r1cs_replicate(m):
    shape = m.r1cs.ShapeCS()
    small_circuit(m, shape, 0, False)
    r4 = shape.finish().replicate(4)
    w = m.top.WitnessCS()
    for i in range(4):
        small_circuit(m, w, 2 + i, False)
    assert r4.eval_host(w.inputs_slice(), w.aux_slice()) == (True, None)
    return r1cs_arrays(r4)


def shape_cs_matches_test_cs(m):
    """ShapeCS and from_test_cs give the same arrays (names aside); an
    empty ShapeCS finishes with zero rows."""
    shape, cs = m.r1cs.ShapeCS(), m.top.TestConstraintSystem()
    small_circuit(m, shape, 0, True)
    small_circuit(m, cs, 4, True)
    a, b = r1cs_arrays(shape.finish()), r1cs_arrays(m.r1cs.R1CS.from_test_cs(cs))
    assert plain(a[:4] + a[5:]) == plain(b[:4] + b[5:])
    empty = m.r1cs.ShapeCS()
    empty.alloc("x", None)
    return a, r1cs_arrays(empty.finish())


def seeded_lc_terms(m):
    """Random LC arithmetic from one seed: the same terms in both."""
    rnd = random.Random(12)
    p = m.top.SCALAR.p
    lc = m.top.LinearCombination.zero(m.top.SCALAR)
    for _ in range(200):
        idx = rnd.randrange(40)
        var = m.lc.Variable(m.lc.Index.aux(idx) if rnd.random() < 0.7 else m.lc.Index.input(idx))
        coeff = rnd.choice([1, p - 1, 2, rnd.randrange(p)])
        lc = lc + (coeff, var) if rnd.random() < 0.6 else lc - (coeff, var)
    return lc, len(lc)


CASES = [indexer_insert_or_update, lc_add_simplify, compute_path, cs_set_and_unsatisfied,
         duplicate_path_panics, namespace_nesting_paths, hash_stable_and_shape_sensitive, hash_known_vector,
         metric_cs_delta_equal, metric_cs_delta_mismatch, bench_cs_counts, witness_cs_basic_and_extend,
         witness_cs_allocate_empty, extend_matches_sequential, verify_inputs, version_export,
         pretty_print_list_format, metric_pretty_print_renders_constraints, delta_ignore_counts,
         witness_cs_assignment_roundtrip, namespace_push_pop_panics, variable_allocated_num_serde,
         synthesis_error_taxonomy, r1cs_from_test_cs_and_eval_host, r1cs_extend, r1cs_replicate,
         shape_cs_matches_test_cs, seeded_lc_terms]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_frontend_case_matches_reference(case):
    want = plain(case(pkg(REF)))
    got = plain(case(pkg(PORT)))
    assert got == want


def test_port_objects_are_the_ports():
    """Each package's frontend builds its own objects: a port system's
    variables and R1CS come from the port's classes."""
    m = pkg(PORT)
    shape = m.r1cs.ShapeCS()
    v = m.num.AllocatedNum.alloc(shape, None).get_variable()
    assert type(v) is m.lc.Variable and type(shape.finish()) is m.r1cs.R1CS
    assert type(v).__module__ == "bellpepper_tpu_torch.lc"
