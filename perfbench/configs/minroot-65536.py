"""`minroot-65536` through the program's public frontend: the step circuit
of Nova's MinRoot VDF (microsoft/Nova ``examples/minroot.rs``,
``MinRootCircuit::synthesize``) at 65,536 iterations a step over Pallas's
scalar field. z_in = (x_0, y_0) is allocated first, where Nova's augmented
circuit would allocate it; then each iteration allocates its advice
x_{i+1}, squares it twice and enforces x_{i+1}^4 · x_{i+1} = x_i + y_i.
The template comes from ``ShapeCS``, the witness tape from ``TapeCS``."""

from bellpepper_tpu_torch import WitnessProgram
from bellpepper_tpu_torch.compile.tape import TapeCS
from bellpepper_tpu_torch.fields import PALLAS_SCALAR
from bellpepper_tpu_torch.gadgets.num import AllocatedNum
from bellpepper_tpu_torch.r1cs import ShapeCS

N_ITERS = 65536
Z_IN = (1, 2)  # the slots of x_0 and y_0, which only rows read


def synthesize(cs, n_iters: int) -> None:
    """``MinRootCircuit::synthesize`` on `cs`, its advice left unassigned."""
    x_i = AllocatedNum.alloc(cs.namespace("x_0"), None)
    y_i = AllocatedNum.alloc(cs.namespace("y_0"), None)
    for i in range(n_iters):
        x_next = AllocatedNum.alloc(cs.namespace(f"x_i_plus_1_iter_{i}"), None)
        sq = x_next.square(cs.namespace(f"x_i_plus_1_sq_iter_{i}"))
        quad = sq.square(cs.namespace(f"x_i_plus_1_quad_{i}"))
        cs.enforce(f"x_i_plus_1_quad * x_i_plus_1 = x_i + y_i_iter_{i}",
                   lambda lc: lc + quad.get_variable(),
                   lambda lc: lc + x_next.get_variable(),
                   lambda lc: lc + x_i.get_variable() + y_i.get_variable())
        y_i, x_i = x_i, x_next


def build(n_iters: int = N_ITERS):
    """→ (template R1CS, witness program) of the step circuit; x_0 and y_0
    are the program's free field inputs alongside the advice."""
    shape, tape = ShapeCS(PALLAS_SCALAR), TapeCS(PALLAS_SCALAR)
    synthesize(shape, n_iters)
    synthesize(tape, n_iters)
    return shape.finish(), WitnessProgram(tape, field_inputs=Z_IN)
