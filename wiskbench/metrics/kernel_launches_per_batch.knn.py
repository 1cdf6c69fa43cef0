"""CUDA kernel launches per kNN batch over the window, from the port's
launch counters (``kernels/_build.launch_counts``)."""


def read(ctx):
    n = sum(ctx.launches.values())
    return n / ctx.batches if n and ctx.batches else None  # CPU tensors launch nothing
