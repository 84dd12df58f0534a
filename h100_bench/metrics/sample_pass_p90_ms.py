"""The 90th percentile of the window's passes, each from its call to the
synchronize that closes it."""

import readers


def read(ctx):
    return readers.unit_ms(ctx, 0.9)
