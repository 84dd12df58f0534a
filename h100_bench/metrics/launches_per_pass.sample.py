"""Kernels launched per sampling pass, from the traced passes."""

import readers


def read(ctx):
    return readers.launches(ctx)
