"""Device time of device-to-host copies per batch in the profiled stretch,
in ms (``torch.profiler``): the ``ids`` the front door brings back."""


def read(ctx):
    t, n = ctx.trace, ctx.trace_counters.get("batches", 0)
    if t is None or not n:
        return None
    s = t.seconds(lambda name, cat: cat == "gpu_memcpy" and "DtoH" in name)
    return s * 1e3 / n if s > 0 else None
