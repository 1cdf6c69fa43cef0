"""Keyword-matching objects scored per kNN query over the window (the
``verified`` count the port's ``retrieve_knn`` returns)."""


def read(ctx):
    s = ctx.counters
    return s["verified"] / s["queries"] if s.get("queries") else None
