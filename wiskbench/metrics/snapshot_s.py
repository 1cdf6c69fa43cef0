"""Seconds of ``IndexSnapshot.build`` in set-up, host clock after a device
synchronize."""


def read(ctx):
    return ctx.snapshot_s
