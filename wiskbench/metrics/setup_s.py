"""Set-up seconds: from the process's start to the window's first dispatch
(imports, objects, index build, snapshot, pool, warm-up with the kernels'
build on a checkout's first run). Host clock."""


def read(ctx):
    return ctx.setup_s
