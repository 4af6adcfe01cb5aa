"""check_ops: aten ops one verdict call dispatches on the card."""


def read(ctx):
    return ctx["ops"].get("check")
