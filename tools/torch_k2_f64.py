#!/usr/bin/env python3
"""Hold K2 and its fp32 plain version against the plain version in float64
on one NVIDIA GPU, for units drawn as ``tests/test_torch_cuda.py`` draws them
with out-conv gains of std 0.3: how far each fp32 result sits from float64,
and how large the float64 result grows (a unit whose inverse diverges has
no fp32 answer to hold a kernel to).

    python3 tools/torch_k2_f64.py
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
from ipoke_tpu_torch.ops import masked_conv  # noqa: E402
from test_torch_cuda import _unit_operands  # noqa: E402

# (B, H = W, C, Ch): two unconditioned B = 40 units and two conditioned ones
CASES = ((40, 8, 18, 0), (40, 16, 4, 0), (40, 8, 32, 128), (3, 16, 32, 128))


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0))
    for case in CASES:
        y, packed = _unit_operands(dev, *case, g_std=0.3)
        got = masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0)
        p32 = masked_conv.macow_unit_inverse_plain(y, *packed, 1.0)
        p64 = masked_conv.macow_unit_inverse_plain(
            y.double(), *(t.double() for t in packed), 1.0)
        fin = torch.isfinite(p64)
        print(f"{case}: max |x64| {p64[fin].abs().max().item():.4g}, non-finite "
              f"{(~fin).sum().item()} (float64) {(~torch.isfinite(got)).sum().item()} "
              f"(kernel) {(~torch.isfinite(p32)).sum().item()} (plain fp32); max "
              f"|kernel - x64| {(got.double() - p64)[fin].abs().max().item():.3e}, "
              f"|plain fp32 - x64| {(p32.double() - p64)[fin].abs().max().item():.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
