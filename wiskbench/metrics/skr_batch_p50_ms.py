"""Median of the window's SKR batch latencies, from dispatch to the result
dict on the host. Host clock."""
import numpy as np


def read(ctx):
    return float(np.median(ctx.latencies_s)) * 1e3 if ctx.latencies_s else None
