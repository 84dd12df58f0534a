"""Fully connected (vector-latent) coupling flows (counterpart of
``ipoke_tpu/flows/fc.py``): the flat flows of the FC tower, on (B, D)
vectors conditioned on (B, Dc), with the JAX package's parameter trees.

* ``ConditionalFlatFlow`` (the ``SupervisedTransformer`` core of the FC
  second stage): n_flows blocks, cond-only and concat-conditioned couplings
  in turn, the pairs stacked under ``ScannedSteps`` (a Python loop over
  the blocks, without the conv flows' activation checkpoints: the flat
  flows' activations are a few (B, D) vectors) and one leftover block when
  n_flows is odd;
* ``unconditional_flat_flow`` (the JAX package's ``UnconditionalFlatFlow``,
  the ``UnsupervisedTransformer3`` core of ``inn_fcae`` and of the FC third
  stage; ``build_unsupervised_transformer3`` reads its dims from the arch
  keys): n_flows unconditioned blocks, stacked;
* a block (``flat_block``, the JAX package's ``FlatCouplingBlock``) is
  ActNorm -> [InvLeakyRelu] -> VectorCoupling -> Shuffle.

``InvLeakyRelu`` accumulates its true per-sample logdet (log(alpha) times
the count of negative entries) unless ``reference_logdet``, which reports
0 as the reference does; the builders read that from the arch key of the
same name.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .base import Chain, Flow
from .macow import ScannedSteps
from .primitives import ActNorm, Shuffle


def _mlp_init(generator, device, dims):
    """Glorot-uniform weights (in, out), zero biases, per layer."""
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = (6.0 / (din + dout)) ** 0.5
        if torch.device(device).type == "meta":
            w = torch.empty((din, dout), device="meta")
        else:
            w = (torch.rand((din, dout), generator=generator, device=device)
                 * 2.0 - 1.0) * lim
        params.append({"w": w, "b": torch.zeros((dout,), device=device)})
    return params


def _mlp_apply(params, x, use_tanh: bool):
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = F.leaky_relu(h, 0.01)
    return torch.tanh(h) if use_tanh else h


@dataclasses.dataclass(frozen=True)
class InvLeakyRelu(Flow):
    alpha: float = 0.9
    reference_logdet: bool = False

    def init(self, generator, device):
        return {}

    def _scale(self, x):
        return torch.where(x >= 0, torch.ones_like(x), torch.full_like(x, self.alpha))

    def forward(self, params, x, h=None):
        s = self._scale(x)
        if self.reference_logdet:
            ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        else:
            ld = torch.log(s).reshape(x.shape[0], -1).float().sum(dim=1)
        return x * s, ld

    def inverse(self, params, y, h=None):
        return y / self._scale(y)


@dataclasses.dataclass(frozen=True)
class VectorCoupling(Flow):
    """Double affine coupling over vector halves with a half swap before
    the second; ``cond_mode``: 'none', 'concat' (the nets see [x_a, h]) or
    'cond_only' (they see h)."""

    in_channels: int
    hidden_dim: int
    depth: int = 2
    cond_channels: int = 0
    cond_mode: str = "none"

    def __post_init__(self):
        assert self.cond_mode in ("none", "concat", "cond_only")
        if self.cond_mode != "none":
            assert self.cond_channels > 0

    @property
    def _d1(self):
        return self.in_channels // 2 + self.in_channels % 2

    @property
    def _d2(self):
        return self.in_channels // 2

    def _net_in_dim(self):
        if self.cond_mode == "cond_only":
            return self.cond_channels
        return self._d1 + (self.cond_channels if self.cond_mode == "concat" else 0)

    def init(self, generator, device):
        dims = [self._net_in_dim()] + [self.hidden_dim] * (self.depth + 1) + [self._d2]
        mlp = lambda: _mlp_init(generator, device, dims)
        return {"s": [mlp(), mlp()], "t": [mlp(), mlp()]}

    def _cond_in(self, xa, h):
        if self.cond_mode == "cond_only":
            return h
        if self.cond_mode == "concat":
            return torch.cat([xa, h], dim=-1)
        return xa

    def forward(self, params, x, h=None):
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        for i in range(2):
            if i % 2 != 0:
                x = torch.cat([x[:, self._d1:], x[:, :self._d1]], dim=-1)
            xa, xb = x[:, :self._d1], x[:, self._d1:]
            ci = self._cond_in(xa, h)
            scale = _mlp_apply(params["s"][i], ci, use_tanh=True)
            xb = xb * torch.exp(scale) + _mlp_apply(params["t"][i], ci, False)
            x = torch.cat([xa, xb], dim=-1)
            ld = ld + scale.float().sum(dim=-1)
        return x, ld

    def inverse(self, params, y, h=None):
        x = y
        for i in reversed(range(2)):
            xa, xb = x[:, :self._d1], x[:, self._d1:]
            ci = self._cond_in(xa, h)
            scale = _mlp_apply(params["s"][i], ci, use_tanh=True)
            xb = (xb - _mlp_apply(params["t"][i], ci, False)) * torch.exp(-scale)
            x = torch.cat([xa, xb], dim=-1)
            if i % 2 != 0:  # undo forward step i's half swap
                x = torch.cat([x[:, self._d2:], x[:, :self._d2]], dim=-1)
        return x


def flat_block(in_channels, hidden_dim, depth=2, cond_channels=0,
               cond_mode="none", activation="none",
               reference_logdet=False) -> Chain:
    """ActNorm -> [InvLeakyRelu] -> VectorCoupling -> Shuffle (the JAX
    package's ``FlatCouplingBlock``; its params are the parts' list)."""
    parts = [ActNorm(in_channels)]
    if activation == "lrelu":
        parts.append(InvLeakyRelu(reference_logdet=reference_logdet))
    parts += [VectorCoupling(in_channels, hidden_dim, depth, cond_channels, cond_mode),
              Shuffle(in_channels)]
    return Chain(tuple(parts))


@dataclasses.dataclass(frozen=True)
class ConditionalFlatFlow(Flow):
    """{"pairs": the (cond_only, concat) block pairs, stacked; "last": the
    leftover cond_only block when n_flows is odd}."""

    in_channels: int
    cond_channels: int
    hidden_dim: int
    depth: int
    n_flows: int
    activation: str = "lrelu"
    reference_logdet: bool = False

    def _block(self, mode):
        return flat_block(self.in_channels, self.hidden_dim, self.depth,
                          self.cond_channels, mode, self.activation,
                          self.reference_logdet)

    def _structure(self):
        pair = Chain((self._block("cond_only"), self._block("concat")))
        scanned = ScannedSteps(pair, self.n_flows // 2, remat=False) \
            if self.n_flows >= 2 else None
        leftover = self._block("cond_only") if self.n_flows % 2 else None
        return scanned, leftover

    def init(self, generator, device):
        scanned, leftover = self._structure()
        params = {}
        if scanned:
            params["pairs"] = scanned.init(generator, device)
        if leftover:
            params["last"] = leftover.init(generator, device)
        return params

    def forward(self, params, x, h=None):
        scanned, leftover = self._structure()
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        if scanned:
            x, l = scanned.forward(params["pairs"], x, h)
            ld = ld + l
        if leftover:
            x, l = leftover.forward(params["last"], x, h)
            ld = ld + l
        return x, ld

    def inverse(self, params, y, h=None):
        scanned, leftover = self._structure()
        if leftover:
            y = leftover.inverse(params["last"], y, h)
        if scanned:
            y = scanned.inverse(params["pairs"], y, h)
        return y

    def ddi(self, params, x, h=None):
        scanned, leftover = self._structure()
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        new = dict(params)
        if scanned:
            x, l, new["pairs"] = scanned.ddi(params["pairs"], x, h)
            ld = ld + l
        if leftover:
            x, l, new["last"] = leftover.ddi(params["last"], x, h)
            ld = ld + l
        return x, ld, new


def build_supervised_transformer(arch) -> ConditionalFlatFlow:
    """Reference ``SupervisedTransformer`` (INN.py:19-88)."""
    get = arch.get
    return ConditionalFlatFlow(
        in_channels=get("flow_in_channels"),
        cond_channels=get("h_channels"),
        hidden_dim=get("flow_mid_channels"),
        depth=get("flow_hidden_depth", 2),
        n_flows=get("n_flows", 20),
        activation=get("flow_activation", "lrelu"),
        reference_logdet=bool(get("reference_logdet", False)),
    )


def unconditional_flat_flow(in_channels: int, hidden_dim: int, depth: int = 2,
                            n_flows: int = 20) -> ScannedSteps:
    """n_flows unconditioned blocks without the leaky relu, stacked (the JAX
    package's ``UnconditionalFlatFlow``, whose params are the stacked
    block's): the core of ``inn_fcae`` and of the FC third stage."""
    return ScannedSteps(flat_block(in_channels, hidden_dim, depth), n_flows,
                        remat=False)


def build_unsupervised_transformer3(arch) -> ScannedSteps:
    """Reference ``UnsupervisedTransformer3`` (INN.py:250-297) from its
    arch keys (``unconditional_flat_flow``)."""
    get = arch.get
    return unconditional_flat_flow(get("flow_in_channels"), get("flow_mid_channels"),
                                   get("flow_hidden_depth", 2), get("n_flows", 20))
