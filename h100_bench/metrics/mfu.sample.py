"""The FLOPs the window's sampling passes need over the window at the bf16
peak."""

import readers
from frozen.work import BF16_FLOPS


def read(ctx):
    return readers.mfu_pct(ctx, BF16_FLOPS)
