"""The paper's Eq. 1 cost per SKR query, ``w1 * nodes_checked + w2 *
verified`` with the weights of the paper (§7.1: w1 = 0.1, w2 = 1), over the
window's queries, from the counts the port's ``retrieve`` returns."""
W1, W2 = 0.1, 1.0


def read(ctx):
    s = ctx.counters
    if not s.get("queries"):
        return None
    return (W1 * s["nodes_checked"] + W2 * s["verified"]) / s["queries"]
