"""field_witness_roofline: the least time of one witness call (the larger of
its canonical field elements at the card's HBM peak and its 32-bit
products at the assumed multiply peak, perfbench/lib/field_roofline.py)
over the device time of the kernels launched inside the call."""

from perfbench.lib.field_roofline import share_pct


def read(ctx):
    dev = ctx["trace"].layer_device_s.get("witness")
    work = ctx["least_bytes"].get("witness")
    if not dev or not isinstance(work, dict):
        return None
    return share_pct(work, dev, ctx["card"])
