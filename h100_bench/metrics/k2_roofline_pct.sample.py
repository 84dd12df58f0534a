"""K2 (``macow_unit_inverse_kernel``, one launch a MaCowUnit): the fp32 bound
of every unit of the traced passes over their device time."""

import readers
from frozen.work import FP32_FLOPS


def read(ctx):
    return readers.roofline_pct(ctx, "macow_unit_inverse_kernel", "k2", FP32_FLOPS)
