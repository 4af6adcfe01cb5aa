"""field_check_ms: the mean host-clock span of one mixed verdict
(``MixedCheck.verdict_slot_major``, the region of the program's ``check``
span, up to the verdict's read on the host)."""


def read(ctx):
    spans = ctx["spans"].get("check")
    return 1e3 * sum(spans) / len(spans) if spans else None
