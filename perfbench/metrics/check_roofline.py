"""check_roofline: the least time the check needs (the words of every
distinct slot a row reads, once, at the card's HBM peak) over the device
time of the kernels launched inside one verdict call."""

from perfbench.lib.roofline import share_pct


def read(ctx):
    dev = ctx["trace"].layer_device_s.get("check")
    least = ctx["least_bytes"].get("check")
    if not dev or least is None:
        return None
    return share_pct(least, dev, ctx["card"])
