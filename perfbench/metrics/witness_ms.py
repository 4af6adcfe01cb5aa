"""witness_ms: the mean host-clock span of one packed evaluator call
(``evaluator.slot_major`` on a pooled input, ending in a synchronize)."""


def read(ctx):
    spans = ctx["spans"].get("witness")
    return 1e3 * sum(spans) / len(spans) if spans else None
