"""The FLOPs the window's train steps need over the window at the fp32 peak
(TF32 is off)."""

import readers
from frozen.work import FP32_FLOPS


def read(ctx):
    return readers.mfu_pct(ctx, FP32_FLOPS)
