"""device_idle_pct: 100 × (1 − the union of kernel, copy and memset
intervals ÷ the traced stretch of steady steps), from torch.profiler."""


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
