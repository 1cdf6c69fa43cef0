"""95th percentile of the window's SKR batch latencies, from dispatch to the
result dict on the host. Host clock."""
import numpy as np


def read(ctx):
    return float(np.percentile(ctx.latencies_s, 95)) * 1e3 if ctx.latencies_s else None
