"""field_check_ops: aten ops one mixed verdict call dispatches."""


def read(ctx):
    return ctx["ops"].get("check")
