"""Circuit / ConstraintSystem abstractions and the synthesis error taxonomy.

A copy of ``bellpepper_tpu/constraint_system.py`` (the port imports nothing
of the JAX package): the re-design of reference
crates/bellpepper-core/src/constraint_system.rs.

Key departures from the Rust design, chosen for Python:

  * **Prefix-carrying namespaces.** The reference mutates a namespace stack
    on the root CS and pops it in a ``Drop`` impl (constraint_system.rs:239-333).
    Python has no deterministic drop, so a ``Namespace`` here is an immutable
    view carrying its absolute path prefix; nothing needs popping.  Path
    strings are only materialized by *naming* backends (TestConstraintSystem,
    MetricCS) via ``alloc_within(prefix, ...)``; witness-only backends never
    touch strings (same laziness contract as the reference's annotation
    closures, witness_cs.rs:103-108).
  * Annotations and value closures may be plain values or callables; callables
    are only invoked by backends that need them (eager value evaluation in
    TestCS/WitnessCS; name evaluation in TestCS/MetricCS).
  * ``enforce`` accepts either ``LinearCombination`` values or builder
    callables ``lc -> lc`` (the reference's closure style,
    constraint_system.rs:97-103).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from .fields import PrimeField
from .lc import Index, LinearCombination, Variable

BELLPEPPER_TPU_VERSION = "0.1.0"


# ---------------------------------------------------------------------------
# SynthesisError taxonomy (constraint_system.rs:21-57, 13 variants)
# ---------------------------------------------------------------------------
class SynthesisError(Exception):
    """Base class for circuit-synthesis errors."""


class AssignmentMissingError(SynthesisError):
    def __init__(self, msg="an assignment for a variable could not be computed"):
        super().__init__(msg)


class DivisionByZeroError(SynthesisError):
    def __init__(self, msg="division by zero"):
        super().__init__(msg)


class UnsatisfiableError(SynthesisError):
    def __init__(self, msg="unsatisfiable constraint system"):
        super().__init__(msg)


class PolynomialDegreeTooLargeError(SynthesisError):
    def __init__(self, msg="polynomial degree is too large"):
        super().__init__(msg)


class UnexpectedIdentityError(SynthesisError):
    def __init__(self, msg="encountered an identity element in the CRS"):
        super().__init__(msg)


class IoError(SynthesisError):
    def __init__(self, msg="encountered an I/O error"):
        super().__init__(msg)


class MalformedVerifyingKeyError(SynthesisError):
    def __init__(self, msg="malformed verifying key"):
        super().__init__(msg)


class UnconstrainedVariableError(SynthesisError):
    def __init__(self, msg="auxiliary variable was unconstrained"):
        super().__init__(msg)


class MalformedProofsError(SynthesisError):
    def __init__(self, msg="attempted to aggregate malformed proofs"):
        super().__init__(msg)


class MalformedSrsError(SynthesisError):
    def __init__(self, msg="malformed SRS"):
        super().__init__(msg)


class NonPowerOfTwoError(SynthesisError):
    def __init__(self, msg="non power of two proofs given for aggregation"):
        super().__init__(msg)


class IncompatibleLengthVectorError(SynthesisError):
    def __init__(self, msg="incompatible vector length"):
        super().__init__(msg)


class InvalidPairingError(SynthesisError):
    def __init__(self, msg="invalid pairing"):
        super().__init__(msg)


# Enum-style accessors, so call sites read like the reference:
#   raise SynthesisError.AssignmentMissing()
SynthesisError.AssignmentMissing = AssignmentMissingError
SynthesisError.DivisionByZero = DivisionByZeroError
SynthesisError.Unsatisfiable = UnsatisfiableError
SynthesisError.PolynomialDegreeTooLarge = PolynomialDegreeTooLargeError
SynthesisError.UnexpectedIdentity = UnexpectedIdentityError
SynthesisError.IoError = IoError
SynthesisError.MalformedVerifyingKey = MalformedVerifyingKeyError
SynthesisError.UnconstrainedVariable = UnconstrainedVariableError
SynthesisError.MalformedProofs = MalformedProofsError
SynthesisError.MalformedSrs = MalformedSrsError
SynthesisError.NonPowerOfTwo = NonPowerOfTwoError
SynthesisError.IncompatibleLengthVector = IncompatibleLengthVectorError
SynthesisError.InvalidPairing = InvalidPairingError


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def resolve_annotation(annotation) -> str:
    """Annotations may be strings or lazy callables returning one."""
    return str(annotation() if callable(annotation) else annotation)


def resolve_value(f) -> int:
    """Value closures may be ints or callables returning one.

    Raises SynthesisError subclasses from inside the closure unchanged."""
    v = f() if callable(f) else f
    if v is None:
        raise AssignmentMissingError()
    return int(v)


def build_lc(builder, field: PrimeField) -> LinearCombination:
    """Materialize an enforce() operand: an LC, a builder callable, or a
    Variable (convenience)."""
    if isinstance(builder, LinearCombination):
        return builder
    if isinstance(builder, Variable):
        return LinearCombination.from_variable(field, builder)
    if callable(builder):
        out = builder(LinearCombination.zero(field))
        if not isinstance(out, LinearCombination):
            raise TypeError("enforce builder must return a LinearCombination")
        return out
    raise TypeError(f"cannot build LinearCombination from {builder!r}")


ONE = Variable(Index.input(0))


# ---------------------------------------------------------------------------
# Circuit
# ---------------------------------------------------------------------------
class Circuit:
    """A synthesizable circuit (constraint_system.rs:12-15)."""

    def synthesize(self, cs: "ConstraintSystem") -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# ConstraintSystem
# ---------------------------------------------------------------------------
class ConstraintSystem:
    """The backend interface circuits are written against
    (constraint_system.rs:61-237).

    Concrete backends: TestConstraintSystem (oracle), WitnessCS (production
    witness generator), MetricCS (shape), BenchCS (counters), ShapeCS
    (device R1CS compiler) — plus MultiEq, which wraps another CS.
    """

    field: PrimeField

    # -- construction ------------------------------------------------------
    @staticmethod
    def one() -> Variable:
        """The constant-1 public input, always Input(0)
        (constraint_system.rs:73-75)."""
        return ONE

    # -- allocation / constraints (implemented by backends) -----------------
    def alloc(self, annotation, f) -> Variable:
        return self.alloc_within(self.effective_prefix(), annotation, f)

    def alloc_input(self, annotation, f) -> Variable:
        return self.alloc_input_within(self.effective_prefix(), annotation, f)

    def enforce(self, annotation, a, b, c) -> None:
        self.enforce_within(self.effective_prefix(), annotation, a, b, c)

    # Prefix-carrying variants; naming backends override these. `prefix`
    # is the ABSOLUTE tuple of namespace components (each "/"-free).
    def alloc_within(self, prefix: Tuple[str, ...], annotation, f) -> Variable:
        raise NotImplementedError

    def alloc_input_within(self, prefix: Tuple[str, ...], annotation, f) -> Variable:
        raise NotImplementedError

    def enforce_within(self, prefix: Tuple[str, ...], annotation, a, b, c) -> None:
        raise NotImplementedError

    # -- namespaces ----------------------------------------------------------
    def effective_prefix(self) -> Tuple[str, ...]:
        """Absolute namespace prefix of this view (roots: the pushed stack)."""
        cur = getattr(self, "_current_namespace", None)
        return tuple(cur) if cur else ()

    def register_namespace(self, prefix: Tuple[str, ...]) -> None:
        """Record that a namespace path exists (naming backends override to
        detect duplicates, test_cs.rs:429-438)."""

    def namespace(self, name) -> "Namespace":
        name = resolve_annotation(name)
        ns = Namespace(self.get_root(), self.effective_prefix() + (name,))
        self.get_root().register_namespace(ns.prefix)
        return ns

    def push_namespace(self, name) -> None:
        """Mutable-stack protocol, kept for API parity
        (constraint_system.rs:107-114). Prefer `namespace`."""
        name = resolve_annotation(name)
        self.register_namespace(self.effective_prefix() + (name,))
        if not hasattr(self, "_current_namespace"):
            self._current_namespace = []
        self._current_namespace.append(name)

    def pop_namespace(self) -> None:
        assert getattr(self, "_current_namespace", None), "namespace stack empty"
        self._current_namespace.pop()

    def get_root(self) -> "ConstraintSystem":
        return self

    # -- witness-tape protocol (no reference counterpart) ----------
    # Gadgets report the semantic operation behind each allocation so a
    # tape-recording backend (compile.tape.TapeCS) can build a vectorized
    # device witness program. Non-recording backends ignore these.
    def record_witness_op(self, opcode: str, out_vars, operands) -> None:
        pass

    # -- extensibility protocol (constraint_system.rs:131-148) ----------------
    @staticmethod
    def is_extensible() -> bool:
        return False

    def extend(self, other) -> None:
        raise NotImplementedError(
            "ConstraintSystem.extend must be implemented for extensible backends"
        )

    # -- witness-generator protocol (constraint_system.rs:150-236) ------------
    def is_witness_generator(self) -> bool:
        return False

    def extend_inputs(self, new_inputs) -> None:
        assert self.is_witness_generator()
        raise NotImplementedError

    def extend_aux(self, new_aux) -> None:
        assert self.is_witness_generator()
        raise NotImplementedError

    def allocate_empty(self, aux_n: int, inputs_n: int):
        assert self.is_witness_generator()
        raise NotImplementedError

    def allocate_empty_inputs(self, n: int):
        assert self.is_witness_generator()
        raise NotImplementedError

    def allocate_empty_aux(self, n: int):
        assert self.is_witness_generator()
        raise NotImplementedError

    def inputs_slice(self):
        assert self.is_witness_generator()
        raise NotImplementedError

    def aux_slice(self):
        assert self.is_witness_generator()
        raise NotImplementedError


class Namespace(ConstraintSystem):
    """A namespaced view of a root CS (constraint_system.rs:239-333).

    Immutable: carries its absolute prefix; delegates all recording to the
    root. Usable as a context manager for scoping readability (no-op on
    exit — nothing to pop)."""

    __slots__ = ("_root", "prefix")

    def __init__(self, root: ConstraintSystem, prefix: Tuple[str, ...]):
        self._root = root
        self.prefix = prefix

    @property
    def field(self) -> PrimeField:  # type: ignore[override]
        return self._root.field

    def effective_prefix(self) -> Tuple[str, ...]:
        return self.prefix

    # alloc_within prefixes are absolute; pass through unchanged.
    def alloc_within(self, prefix, annotation, f) -> Variable:
        return self._root.alloc_within(prefix, annotation, f)

    def alloc_input_within(self, prefix, annotation, f) -> Variable:
        return self._root.alloc_input_within(prefix, annotation, f)

    def enforce_within(self, prefix, annotation, a, b, c) -> None:
        self._root.enforce_within(prefix, annotation, a, b, c)

    def namespace(self, name) -> "Namespace":
        name = resolve_annotation(name)
        ns = Namespace(self._root, self.prefix + (name,))
        self._root.register_namespace(ns.prefix)
        return ns

    def get_root(self) -> ConstraintSystem:
        return self._root

    def record_witness_op(self, opcode, out_vars, operands) -> None:
        self._root.record_witness_op(opcode, out_vars, operands)

    def is_witness_generator(self) -> bool:
        return self._root.is_witness_generator()

    def extend_inputs(self, new_inputs) -> None:
        self._root.extend_inputs(new_inputs)

    def extend_aux(self, new_aux) -> None:
        self._root.extend_aux(new_aux)

    def allocate_empty(self, aux_n, inputs_n):
        return self._root.allocate_empty(aux_n, inputs_n)

    def inputs_slice(self):
        return self._root.inputs_slice()

    def aux_slice(self):
        return self._root.aux_slice()

    def push_namespace(self, name) -> None:
        # Deliberate panic, mirroring constraint_system.rs:289-293: only
        # the root should create namespaces (use `namespace` instead).
        raise RuntimeError(
            "only the root's push_namespace should be called"
        )

    def pop_namespace(self) -> None:
        # constraint_system.rs:295-299.
        raise RuntimeError(
            "only the root's pop_namespace should be called"
        )

    def __enter__(self) -> "Namespace":
        return self

    def __exit__(self, *exc) -> None:
        return None


def compute_path(ns: Tuple[str, ...], this: str) -> str:
    """Join namespace components with '/' (test_cs.rs:363-375); '/' banned
    in the leaf name."""
    if "/" in this:
        raise ValueError("'/' is not allowed in names")
    if not ns:
        return this
    return "/".join(ns) + "/" + this
