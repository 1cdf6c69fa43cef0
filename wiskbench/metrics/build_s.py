"""Seconds to build the index in set-up (``build_str_rtree`` or
``build_wisk``), host clock after a device synchronize."""


def read(ctx):
    return ctx.build_s
