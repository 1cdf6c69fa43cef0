"""The served snapshot's bytes on the device (``IndexSnapshot.nbytes``), in
GiB."""


def read(ctx):
    return ctx.index_bytes / float(1 << 30)
