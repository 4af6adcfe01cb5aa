"""The yardstick of the field path's roofline shares: the least time of a
layer is the larger of its bytes at the card's HBM peak and its 32-bit
products at an assumed multiply peak, both counted from the reference
circuit's shapes and the batch, never from the kernels that compute it.

Bytes count canonical field elements of 32 bytes: the witness reads its
free inputs and writes every computed value once; the check reads every
distinct variable that a row names once. Products count 64 32-bit
products a field multiply (8 × 8 words): one a computed value of the
witness (every one a product in the circuits measured here), one a row of
the check."""

from perfbench.lib.roofline import peak_bytes_per_s

ELEMENT = 32  # bytes of one canonical 255-bit field element
PRODUCTS_PER_MUL = 64
# 32-bit integer multiplies a second: 64 lanes × 132 SMs × 1.98 GHz, the
# assumed peak of PERF.md's kernel table (NVIDIA H100 SXM5 80 GB)
PRODUCTS_PER_S = {"NVIDIA H100 80GB HBM3": 64 * 132 * 1.98e9}


def witness_work(cs, batch: int) -> dict:
    """Bytes and products of one evaluator call at `batch` instances."""
    n_free = len(cs.free)
    n_computed = cs.n_vars - 1 - n_free
    return {"bytes": (n_free + n_computed) * ELEMENT * batch, "products": n_computed * PRODUCTS_PER_MUL * batch}


def check_work(cs, batch: int) -> dict:
    """Bytes and products of one verdict at `batch` instances: the distinct
    variables the rows read, one multiply a row whose A and B both name a
    variable."""
    used = set()
    n_mul = 0
    for a, b, c in cs.rows:
        used.update(v for lc in (a, b, c) for v in lc if v)
        n_mul += bool(a.keys() - {0}) and bool(b.keys() - {0})
    return {"bytes": len(used) * ELEMENT * batch, "products": n_mul * PRODUCTS_PER_MUL * batch}


def least_seconds(work: dict, card: str) -> float:
    if card not in PRODUCTS_PER_S:
        raise KeyError(f"no assumed multiply peak for {card!r}")
    return max(work["bytes"] / peak_bytes_per_s(card), work["products"] / PRODUCTS_PER_S[card])


def share_pct(work: dict, seconds: float, card: str) -> float:
    """100 × the least time over the measured time."""
    return 100.0 * least_seconds(work, card) / seconds
