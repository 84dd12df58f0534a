"""Weights drawn from the run's seed on the device, in a few large calls,
in the dtype they are served in.

A configuration's reference says, leaf by leaf, how its weights are drawn
(``specs``: (key, shape, rule)): ``("normal", std)`` (``std`` a float, or
a tuple of stds for equal parts of the last axis), ``("const",
value)``, ``("perm",)`` (a random permutation along the last axis, one per
leading index) or ``("inv_perm", key)`` (the inverse of the permutation
under ``key``).  Every normal leaf comes from one ``torch.randn`` over
their total size, scaled once per distinct std; each leaf is then its own
tensor, as a model built leaf by leaf holds them.  The same seed gives the
same tensors on the same device, so the reference can draw them again
after the window, and the program and the reference read equal values.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def stream_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream ``tags`` of the run seeded ``seed``
    (any whole number, the driver's exceed 32 bits)."""
    words = []
    for t in (seed, *tags):
        t = int(t) if isinstance(t, int) else int.from_bytes(t.encode(), "little")
        words += [t & 0xFFFFFFFF, (t >> 32) & 0xFFFFFFFF]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> 1)


def draw(specs, seed: int, device, dtype) -> dict:
    """{key: tensor} for ``specs`` from ``seed``; permutations are int32."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "weights"))
    normals = sorted((s for s in specs if s[2][0] == "normal"), key=lambda s: repr(s[2][1]))
    total = sum(int(np.prod(shape)) for _, shape, _ in normals)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for std, group in itertools.groupby(normals, key=lambda s: s[2][1]):
        group = list(group)
        n = sum(int(np.prod(shape)) for _, shape, _ in group)
        if not isinstance(std, tuple):
            flat[off:off + n].mul_(std)
        for key, shape, _ in group:
            k = int(np.prod(shape))
            out[key] = flat[off:off + k].view(shape).clone()
            if isinstance(std, tuple):
                for part, s in zip(out[key].chunk(len(std), dim=-1), std):
                    part.mul_(s)
            off += k
    del flat
    for key, shape, rule in specs:
        if rule[0] == "const":
            out[key] = torch.full(shape, float(rule[1]), device=device, dtype=dtype)
        elif rule[0] == "perm":
            rows = int(np.prod(shape[:-1]))
            r = torch.rand((rows, shape[-1]), generator=gen, device=device)
            out[key] = r.argsort(dim=1).to(torch.int32).view(shape)
    for key, shape, rule in specs:
        if rule[0] == "inv_perm":
            out[key] = out[rule[1]].long().argsort(dim=-1).to(torch.int32)
    return out
