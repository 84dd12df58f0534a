"""Clips of all the window's passes over the window's seconds."""

import readers


def read(ctx):
    return readers.rate(ctx)
