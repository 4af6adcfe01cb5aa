"""The yardstick of the roofline shares: the card's published peak and the
bytes a layer must move, counted from the circuit's shapes and the batch,
never from the kernels that happen to compute it."""

# NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet): HBM3 bandwidth at the full
# 700 W power limit. The witness and the check are integer and bitwise
# work with no multiply-heavy inner loop, so bytes bound both.
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}
WORD = 4  # bytes of one packed word: 32 instances


def peak_bytes_per_s(card: str) -> float:
    if card not in PEAKS:
        raise KeyError(f"no published peak for {card!r}")
    return PEAKS[card]["hbm_bytes_per_s"]


def witness_bytes(n_free: int, n_slots: int, Bw: int) -> int:
    """The packed free words read once and every slot's words written once."""
    return (n_free + n_slots) * Bw * WORD


def check_bytes(rows, Bw: int) -> int:
    """The words of every distinct slot that some row of A, B or C reads,
    each read once. `rows`: (a, b, c) dicts {slot: coefficient}."""
    slots = set()
    for row in rows:
        for lc in row:
            slots.update(lc)
    return len(slots) * Bw * WORD


def share_pct(least_bytes: int, seconds: float, card: str) -> float:
    """100 × the least time at the peak over the measured time."""
    return 100.0 * least_bytes / peak_bytes_per_s(card) / seconds
