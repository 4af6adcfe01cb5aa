"""field_witness_ms: the mean host-clock span of one field-path evaluator
call (``Evaluator.slot_major`` on a chunk of the pooled advice, the
region of the program's ``witness`` span, ending in a synchronize)."""


def read(ctx):
    spans = ctx["spans"].get("witness")
    return 1e3 * sum(spans) / len(spans) if spans else None
