"""Share of the profiled stretch in which no kernel, copy or memset ran on
the device, in percent (``torch.profiler``, CPU and CUDA)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
