"""The fused SKR verify's share of its memory roofline, in percent.

The bytes are the least any verify needs for what it verified, whatever
implements it, counted from the traced batches: for each verified object
its location (8 B) and its keyword ids (4 B each, ``max_kw`` of the
configuration's objects); each result id written once (4 B); each query's
rectangle (16 B) and keyword ids (4 B each, ``n_keywords`` of the traffic).
The least time is those bytes at the H100's 3.35 TB/s (NVIDIA's data sheet,
SXM, 700 W); the share is that over the profiler's device time of the
kernels whose function names start with ``fused_verify``.
"""
from wiskbench.profiling import kernel_base

HBM_BYTES_PER_S = 3.35e12


def read(ctx):
    t, c = ctx.trace, ctx.trace_counters
    if t is None or not c.get("queries"):
        return None
    busy = t.seconds(lambda name, cat: cat == "kernel" and kernel_base(name).startswith("fused_verify"))
    if busy <= 0:
        return None
    kw_obj = int(ctx.config["data"]["max_kw"])
    kw_q = int(ctx.traffic["n_keywords"])
    need = c["verified"] * (8 + 4 * kw_obj) + c["results"] * 4 + c["queries"] * (16 + 4 * kw_q)
    return 100.0 * (need / HBM_BYTES_PER_S) / busy
