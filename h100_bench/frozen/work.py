"""Work counts and the H100's published peaks: a frozen copy of
``chip_smoke.py``'s ``bound``, ``nice_work`` (its inference form) and
``unit_work``, the formulas the metrics read, so that a change to the program cannot change what a
roofline share divides by.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM, 989 TFLOP/s in bf16 on the tensor cores, 67
TFLOP/s in fp32 outside them.
"""

from __future__ import annotations

HBM_BYTES_PER_S, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12


def bound(nbytes, ops, peak):
    """(bound_ms, bound_by): the least time for ``nbytes`` of device memory
    traffic and ``ops`` operations at ``peak`` per second."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nice_work(m, k1, hid, n):
    """(bytes, flops) of K1: bf16 zcol and weights read once, u written in
    fp32."""
    nbytes = 2 * (m * k1 + k1 * hid + hid * hid + hid * n) + 4 * m * n
    return nbytes, 2 * m * (k1 * hid + hid * hid + hid * n)


def unit_work(b, s, c, hid):
    """(bytes, flops) of K2 in fp32: per MCF and pixel 6 tap dots C -> hid
    and the hid -> 2C out dot (hc is precomputed); y and x, the 4 flows'
    weights, hc and the ActNorms once each."""
    pix = b * s * s
    nbytes = 4 * (2 * pix * c + 4 * 6 * c * hid + 4 * hid * 2 * c
                  + 4 * pix * 2 * c + 4 * c)
    return nbytes, 4 * pix * 2 * (6 * c * hid + hid * 2 * c)


class FlopCount:
    """The FLOPs of the matrix products and convolutions run inside it
    (``torch.utils.flop_counter``'s formulas), in ``total``; over meta
    tensors it counts a whole step's shapes without running anything.
    (``FlopCounterMode`` itself tracks modules, which fails where a no-grad
    pass runs over parameters that require grad.)"""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    counter.total += formula(*args, **kwargs, out_val=out)
                return out

        self.total, self._mode = 0, _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)
