"""witness_ops: aten ops one evaluator call dispatches on the card."""


def read(ctx):
    return ctx["ops"].get("witness")
