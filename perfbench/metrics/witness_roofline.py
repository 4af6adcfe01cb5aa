"""witness_roofline: the least time the witness needs (its free words read
and every slot's words written, once, at the card's HBM peak) over the
device time of the kernels launched inside one evaluator call."""

from perfbench.lib.roofline import share_pct


def read(ctx):
    dev = ctx["trace"].layer_device_s.get("witness")
    least = ctx["least_bytes"].get("witness")
    if not dev or least is None:
        return None
    return share_pct(least, dev, ctx["card"])
