"""SKR queries completed per second: every query of every batch completed in
the window over the time from the first dispatch to the end of the last
batch, less the harness's record() of each result. Host clock."""


def read(ctx):
    return ctx.queries / ctx.window_s if ctx.window_s > 0 else None
