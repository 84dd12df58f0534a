"""K1 (``nice_net_stage``, three launches a coupling): the bf16 bound of every
coupling of the traced passes over their device time."""

import readers
from frozen.work import BF16_FLOPS


def read(ctx):
    return readers.roofline_pct(ctx, "nice_net_stage", "k1", BF16_FLOPS)
