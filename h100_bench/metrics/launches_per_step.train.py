"""Kernels launched per train step, from the traced steps."""

import readers


def read(ctx):
    return readers.launches(ctx)
