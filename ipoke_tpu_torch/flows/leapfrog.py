"""Leapfrog (Hamiltonian-inspired) vector flows over an (x, v) pair
(counterpart of ``ipoke_tpu/flows/leapfrog.py``; the reference's dormant
leapfrog family, no config builds them):

* ``LeapFrogCoupling``: two volume-preserving leapfrog steps, v' = v - dt/2
  gradU(x), x += dt scaleP(v'), v = v' - dt/2 gradU(x), with an ActNorm on
  (x, v) after the first; the logdet is the ActNorms' (zero under
  ``reference_logdet``, as the reference reports it).
* ``ExtendedLeapFrogCoupling``: velocity rescales around a double affine
  coupling on x that also injects exp(q) dt v'; the inverse inverts the
  forward exactly (the reference's own reverse drops the exp on q).
* ``LeapFlow``: ``n_flows`` blocks [ActNorm_x, ActNorm_v, coupling,
  Shuffle_x, Shuffle_v] over stacked per-block params (the JAX package's
  ``lax.scan``; here a loop over the leading axis).

They transport a pair: ``forward(params, x, v) -> (x, v, logdet)``,
``inverse(params, x, v) -> (x, v)``.  Parameter trees repeat the JAX
package's."""

from __future__ import annotations

import dataclasses

import torch

from .base import tree_map
from .fc import _mlp_apply, _mlp_init
from .macow import _stack
from .primitives import ActNorm, Shuffle


@dataclasses.dataclass(frozen=True)
class LeapFrogCoupling:
    """Volume-preserving leapfrog steps (reference LeapFrogCouplingBlock)."""

    in_channels: int
    hidden_dim: int
    depth: int = 2
    delta_t: float = 1.0
    reference_logdet: bool = False

    def _dims(self):
        c = self.in_channels
        return [c] + [self.hidden_dim] * (self.depth + 1) + [c]

    def init(self, generator, device):
        mlp = lambda: _mlp_init(generator, device, self._dims())
        an = ActNorm(self.in_channels)
        return {"grad_u": [mlp(), mlp()], "scale_p": [mlp(), mlp()],
                "an_x": an.init(generator, device), "an_v": an.init(generator, device)}

    def forward(self, params, x, v):
        an = ActNorm(self.in_channels)
        dt = self.delta_t
        ld = x.new_zeros(x.shape[0])
        for i in range(2):
            v_prime = v - 0.5 * dt * _mlp_apply(params["grad_u"][i], x, True)
            x = x + dt * _mlp_apply(params["scale_p"][i], v_prime, False)
            v = v_prime - 0.5 * dt * _mlp_apply(params["grad_u"][i], x, True)
            if i == 0:
                v, l1 = an.forward(params["an_v"], v)
                x, l2 = an.forward(params["an_x"], x)
                ld = ld + l1 + l2
        if self.reference_logdet:
            ld = torch.zeros_like(ld)
        return x, v, ld

    def inverse(self, params, x, v):
        an = ActNorm(self.in_channels)
        dt = self.delta_t
        for i in reversed(range(2)):
            if i == 0:
                v = an.inverse(params["an_v"], v)
                x = an.inverse(params["an_x"], x)
            v_prime = v + 0.5 * dt * _mlp_apply(params["grad_u"][i], x, True)
            x = x - dt * _mlp_apply(params["scale_p"][i], v_prime, False)
            v = v_prime + 0.5 * dt * _mlp_apply(params["grad_u"][i], x, True)
        return x, v


@dataclasses.dataclass(frozen=True)
class ExtendedLeapFrogCoupling:
    """Velocity rescale and a double affine x-coupling with velocity
    injection (reference ExtendedLeapFrogCouplingBlock), exactly
    invertible."""

    in_channels: int
    hidden_dim: int
    depth: int = 2
    delta_t: float = 1.0

    @property
    def _d1(self):
        return self.in_channels // 2 + self.in_channels % 2

    @property
    def _d2(self):
        return self.in_channels // 2

    def init(self, generator, device):
        half = [self._d1] + [self.hidden_dim] * (self.depth + 1) + [self._d2]
        full = [self.in_channels] + [self.hidden_dim] * (self.depth + 1) \
            + [self.in_channels]
        mlp = lambda dims: _mlp_init(generator, device, dims)
        return {key: [mlp(dims), mlp(dims)] for key, dims in
                (("s", half), ("t", half), ("q", half), ("f", full), ("v", full))}

    def _swap(self, a):
        return torch.cat([a[:, self._d1:], a[:, :self._d1]], dim=-1)

    def _unswap(self, a):
        return torch.cat([a[:, self._d2:], a[:, :self._d2]], dim=-1)

    def forward(self, params, x, v):
        dt = self.delta_t
        s_v1 = _mlp_apply(params["v"][0], x, True)
        v_prime = v * torch.exp(0.5 * s_v1) - 0.5 * dt * _mlp_apply(params["f"][0], x, False)
        ld = 0.5 * torch.sum(s_v1, dim=-1)
        for i in range(2):
            if i % 2:
                x, v_prime = self._swap(x), self._swap(v_prime)
            xa, xb = x[:, :self._d1], x[:, self._d1:]
            vb = v_prime[:, self._d1:]
            s = _mlp_apply(params["s"][i], xa, True)
            q = _mlp_apply(params["q"][i], xa, True)
            xb = xb * torch.exp(s) + _mlp_apply(params["t"][i], xa, False) \
                + torch.exp(q) * dt * vb
            x = torch.cat([xa, xb], dim=-1)
            ld = ld + torch.sum(s, dim=-1)
        s_v2 = _mlp_apply(params["v"][1], x, True)
        v = v_prime * torch.exp(0.5 * s_v2) - 0.5 * dt * _mlp_apply(params["f"][1], x, False)
        return x, v, ld + 0.5 * torch.sum(s_v2, dim=-1)

    def inverse(self, params, x, v):
        dt = self.delta_t
        v_prime = (v + 0.5 * dt * _mlp_apply(params["f"][1], x, False)) \
            * torch.exp(-0.5 * _mlp_apply(params["v"][1], x, True))
        for i in reversed(range(2)):
            xa, xb = x[:, :self._d1], x[:, self._d1:]
            vb = v_prime[:, self._d1:]
            s = _mlp_apply(params["s"][i], xa, True)
            q = _mlp_apply(params["q"][i], xa, True)
            xb = (xb - _mlp_apply(params["t"][i], xa, False)
                  - torch.exp(q) * dt * vb) * torch.exp(-s)
            x = torch.cat([xa, xb], dim=-1)
            if i % 2:
                x, v_prime = self._unswap(x), self._unswap(v_prime)
        return x, (v_prime + 0.5 * dt * _mlp_apply(params["f"][0], x, False)) \
            * torch.exp(-0.5 * _mlp_apply(params["v"][0], x, True))


@dataclasses.dataclass(frozen=True)
class LeapFlow:
    """``n_flows`` stacked [ActNorm_x | ActNorm_v | coupling | Shuffle_x |
    Shuffle_v] blocks over params stacked on a leading axis (``extended``:
    ``ExtendedLeapFrogCoupling``, else ``LeapFrogCoupling``)."""

    in_channels: int
    hidden_dim: int
    depth: int = 2
    n_flows: int = 4
    delta_t: float = 1.0
    extended: bool = True

    @property
    def _coupling(self):
        cls = ExtendedLeapFrogCoupling if self.extended else LeapFrogCoupling
        return cls(self.in_channels, self.hidden_dim, self.depth, self.delta_t)

    def init(self, generator, device):
        an, sh = ActNorm(self.in_channels), Shuffle(self.in_channels)
        return {"blocks": _stack([
            {"an_x": an.init(generator, device), "an_v": an.init(generator, device),
             "coupling": self._coupling.init(generator, device),
             "sh_x": sh.init(generator, device), "sh_v": sh.init(generator, device)}
            for _ in range(self.n_flows)])}

    def _blocks(self, params):
        n = params["blocks"]["an_x"]["bias"].shape[0]
        return [tree_map(lambda a: a[i], params["blocks"]) for i in range(n)]

    def forward(self, params, x, v):
        an, sh, coup = ActNorm(self.in_channels), Shuffle(self.in_channels), self._coupling
        ld = x.new_zeros(x.shape[0])
        for p in self._blocks(params):
            x, l1 = an.forward(p["an_x"], x)
            v, l2 = an.forward(p["an_v"], v)
            x, v, l3 = coup.forward(p["coupling"], x, v)
            x, _ = sh.forward(p["sh_x"], x)
            v, _ = sh.forward(p["sh_v"], v)
            ld = ld + l1 + l2 + l3
        return x, v, ld

    def inverse(self, params, x, v):
        an, sh, coup = ActNorm(self.in_channels), Shuffle(self.in_channels), self._coupling
        for p in reversed(self._blocks(params)):
            x = sh.inverse(p["sh_x"], x)
            v = sh.inverse(p["sh_v"], v)
            x, v = coup.inverse(p["coupling"], x, v)
            x = an.inverse(p["an_x"], x)
            v = an.inverse(p["an_v"], v)
        return x, v
