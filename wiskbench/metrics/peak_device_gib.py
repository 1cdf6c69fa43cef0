"""Peak device memory over set-up and window, in GiB
(``torch.cuda.max_memory_allocated``): the index's storage and what
serving adds."""


def read(ctx):
    return ctx.memory_peak_bytes / float(1 << 30) if ctx.memory_peak_bytes else None
