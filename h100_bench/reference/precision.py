"""The controls' lower precisions, applied to the plain reference from
outside: ``fp8`` computes it in fp8 e4m3 as a bf16 program computes in
bf16: both operands of every convolution and matrix product, and every
floating tensor that an operation returns, rounded to e4m3 under one scale
per tensor (as fp8 inference scales them), the products summed in fp32;
``tf32`` lets cuBLAS and cuDNN take TF32 for fp32 products."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
_PRODUCTS = {F.conv2d, F.conv3d, F.conv_transpose2d, F.linear, torch.matmul,
             torch.mm, torch.bmm, torch.Tensor.matmul, torch.Tensor.__matmul__}


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under one per-tensor scale, back in its dtype."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _round(out):
    if isinstance(out, torch.Tensor):
        return to_fp8(out) if out.is_floating_point() and out.numel() else out
    if isinstance(out, (tuple, list)):
        return type(out)(_round(o) for o in out)
    return out


class Fp8(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS and len(args) >= 2 and all(
                isinstance(a, torch.Tensor) and a.is_floating_point() for a in args[:2]):
            args = (to_fp8(args[0]), to_fp8(args[1]), *args[2:])
        with torch._C.DisableTorchFunction():
            return _round(func(*args, **kwargs))


@contextlib.contextmanager
def tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def lower(name: str):
    """The context that computes the reference in the named precision."""
    return {"fp8": Fp8, "tf32": tf32}[name]()
