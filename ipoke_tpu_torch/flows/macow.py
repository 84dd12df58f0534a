"""MaCow conditional invertible flow (counterpart of
``ipoke_tpu/flows/macow.py``): density direction with logdet and
data-dependent init, and the inverse.

The same functional flows as the JAX package, NHWC, over the same parameter
trees.  Four places dispatch to hand-written kernels, as in the JAX
package, the NICE ones inside their kernels' shape family with bf16
activations: ``NICE2d._raw_inference`` (K1, ``ops/nice_net.py``),
``NICE2d._raw_train`` (K4 while autograd records, else K1),
``MaCowUnitChain.inverse`` (K2, ``ops/masked_conv.py``) for affine/ELU units
on the square latents it can hold, and ``MaskedConvFlow.inverse`` (K5) for
every other affine/ELU masked-conv flow.  Each wrapper takes its plain
PyTorch version on CPU tensors.

``ScannedSteps.forward`` recomputes each step in the backward pass (the JAX
package's ``remat``): the forward keeps only step boundaries, and its
no-grad pass runs K1 while the recompute runs K4.

On a rank of the dp x tp mesh (``ipoke_tpu_torch.parallel``) a NICE
coupling whose params hold a shard of ``w2`` runs split over the mesh's
model axis (``NICE2d._mesh``): K1 and K4 at the shard's shapes, or the
plain split coupling outside their family; every other flow runs whole.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .base import Chain, Flow, tree_flatten, tree_map
from .primitives import (
    ActNorm,
    InvConvLU,
    Shuffle,
    SpaceToDepth,
    conv1x1_dot,
    conv_init,
    get_transform,
    plain_conv_apply,
    shifted_conv_apply,
    wn_conv_apply,
    wn_conv_apply_packed,
    wn_conv_ddi,
    wn_conv_init,
)


def _act(name: str):
    return {"relu": F.relu, "elu": F.elu,
            "leaky_relu": lambda x: F.leaky_relu(x, 0.1)}[name]


def default_mcf_hidden(in_channels: int) -> int:
    if in_channels <= 96:
        return 4 * in_channels
    return min(2 * in_channels, 512)


# ---------------------------------------------------------------------------
# Masked convolutional flow
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaskedConvFlow(Flow):
    """Autoregressive masked-conv flow (one of orders A/B/C/D).  Orders C/D
    store their kernel with the dims already swapped, as the JAX package
    (and its reference) does."""

    in_channels: int
    kernel_size: Tuple[int, int]
    order: str = "A"
    hidden_channels: Optional[int] = None
    h_channels: int = 0
    transform: str = "affine"
    alpha: float = 1.0
    activation: str = "elu"

    @property
    def _hidden(self):
        return self.hidden_channels or default_mcf_hidden(self.in_channels)

    @property
    def _tr(self):
        return get_transform(self.transform, self.alpha)

    def init(self, generator, device):
        kh, kw = self.kernel_size
        out_c = self.in_channels * self._tr.n_params
        return {
            "w_shift": conv_init(generator, device, kh, kw, self.in_channels,
                                 self._hidden),
            "out": wn_conv_init(generator, device, 1, 1,
                                self._hidden + self.h_channels, out_c,
                                zero_init=True),
        }

    def _net_hidden(self, params, x, h):
        c = shifted_conv_apply(params["w_shift"], x, self.order)
        if self.h_channels:
            if h is None:
                raise ValueError(
                    f"MaskedConvFlow built with h_channels={self.h_channels} "
                    "requires conditioning input h")
            c = torch.cat([c, h], dim=-1)
        return _act(self.activation)(c)

    def _net(self, params, x, h):
        return wn_conv_apply(params["out"], self._net_hidden(params, x, h))

    def forward(self, params, x, h=None):
        return self._tr.fwd(x, self._tr.calc(self._net(params, x, h)))

    def ddi(self, params, x, h=None):
        new = dict(params, out=wn_conv_ddi(
            params["out"], self._net_hidden(params, x, h), init_scale=0.0))
        y, ld = self.forward(new, x, h)
        return y, ld, new

    def inverse(self, params, y, h=None):
        """Row by row: row i of x needs the rows of x before it (orders A/C)
        or after it (B/D).  An affine/ELU flow goes through K5 (its plain
        version on CPU tensors); another transform or activation has no
        kernel, here or in the JAX package, and takes the plain row scan
        (the JAX package's ``_inverse_portable``).  Computed in fp32,
        returned in ``y.dtype``."""
        from ..ops.masked_conv import (
            masked_conv_inverse,
            masked_conv_inverse_plain,
            scan_inverse,
        )

        if self.h_channels and h is None:
            raise ValueError(
                f"MaskedConvFlow built with h_channels={self.h_channels} "
                "requires conditioning input h")
        hh = h if self.h_channels else None
        if self.transform == "affine" and self.activation == "elu":
            x = masked_conv_inverse(y, hh, params, self.order, self.alpha)
        else:
            act = _act(self.activation)
            tr = None if self.transform == "affine" else self._tr
            x = scan_inverse(
                functools.partial(masked_conv_inverse_plain, act=act, tr=tr), y,
                None if hh is None else act(hh.to(torch.float32)), params,
                self.order, self.alpha)
        return x.to(y.dtype)


# ---------------------------------------------------------------------------
# NICE coupling over channel splits
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NICE2d(Flow):
    in_channels: int
    hidden_channels: Optional[int] = None
    h_channels: int = 0
    split_type: str = "continuous"  # or "skip"
    order: str = "up"  # or "down"
    factor: int = 2
    transform: str = "affine"
    alpha: float = 1.0
    activation: str = "elu"

    def __post_init__(self):
        if self.split_type == "skip" and self.in_channels % self.factor == 1:
            object.__setattr__(self, "split_type", "continuous")

    @property
    def _out_channels(self):
        return self.in_channels // self.factor

    @property
    def _in1(self):
        return self.in_channels - self._out_channels

    @property
    def z1_channels(self):
        return self._in1 if self.order == "up" else self._out_channels

    @property
    def _hidden(self):
        return self.hidden_channels or min(8 * self.in_channels, 512)

    @property
    def _tr(self):
        return get_transform(self.transform, self.alpha)

    def init(self, generator, device):
        hid = self._hidden
        out_c = self._out_channels * self._tr.n_params
        return {
            "w1": conv_init(generator, device, 3, 3, self._in1, hid),
            "w2": conv_init(generator, device, 1, 1, hid, hid),
            "out": wn_conv_init(generator, device, 3, 3, hid + self.h_channels,
                                out_c, zero_init=True),
        }

    def _split(self, z):
        if self.split_type == "continuous":
            return z[..., :self.z1_channels], z[..., self.z1_channels:]
        return z[..., 0::2], z[..., 1::2]

    def _unsplit(self, z1, z2):
        if self.split_type == "continuous":
            return torch.cat([z1, z2], dim=-1)
        return torch.stack([z1, z2], dim=-1).reshape(*z1.shape[:-1], -1)

    def _net_hidden(self, params, z, h):
        act = _act(self.activation)
        c = act(plain_conv_apply(params["w1"], z, padding="SAME"))
        c = conv1x1_dot(params["w2"], c)
        if self.h_channels:
            c = torch.cat([c, h], dim=-1)
        return act(c)

    def _raw(self, params, z, h):
        mesh = self._mesh(params)
        if mesh is not None:
            from ..ops.nice_net import nice_net_raw_split_plain

            return nice_net_raw_split_plain(
                params, z, h if self.h_channels else None, mesh,
                _act(self.activation))
        return wn_conv_apply_packed(params["out"], self._net_hidden(params, z, h))

    def _mesh(self, params):
        """The mesh whose model axis splits this coupling's hidden width,
        where ``params`` hold a rank's shard of w2 (Hid/tp of its columns,
        ``parallel.shard_params``); None for a whole w2."""
        hid, hs = params["w2"].shape[-2:]
        if hs == hid:
            return None
        from ..parallel.mesh import current_mesh

        mesh = current_mesh()
        if mesh is None or hs * mesh.tp != hid:
            raise ValueError(
                f"NICE2d params hold {hs} of {hid} hidden columns of w2: a "
                "shard runs inside `with mesh:` of its model_parallel")
        return mesh

    def _zp_z(self, z1, z2):
        return (z1, z2) if self.order == "up" else (z2, z1)

    def forward(self, params, x, h=None):
        z1, z2 = self._split(x)
        z, zp = self._zp_z(z1, z2)
        zp, ld = self._tr.fwd(zp, self._tr.calc(self._raw_train(params, z, h)))
        z1, z2 = (z, zp) if self.order == "up" else (zp, z)
        return self._unsplit(z1, z2), ld

    def inverse(self, params, y, h=None):
        z1, z2 = self._split(y)
        z, zp = self._zp_z(z1, z2)
        zp = self._tr.bwd(zp, self._tr.calc(self._raw_inference(params, z, h)))
        z1, z2 = (z, zp) if self.order == "up" else (zp, z)
        return self._unsplit(z1, z2)

    def _raw_inference(self, params, z, h):
        """``_raw`` through K1 inside the JAX package's family for it: ELU,
        bf16 activations, and the kernel's shape family."""
        from ..ops.nice_net import nice_net_fits, nice_net_raw

        hh = h if self.h_channels else None
        if (self.activation == "elu" and z.dtype == torch.bfloat16
                and (self.h_channels == 0 or h is not None)
                and nice_net_fits(params, z, hh)):
            return nice_net_raw(params, z, hh, self._mesh(params))
        return self._raw(params, z, h)

    def _raw_train(self, params, z, h):
        """``_raw`` of the density direction inside the JAX package's gate
        (ELU, bf16 activations, bf16 out bias, the kernels' shape family):
        K4 with its hand-written backward while autograd records, K1 when
        it does not (the no-grad pass of a remat step); else plain."""
        from ..ops.nice_net import (
            nice_net_fits,
            nice_net_raw,
            nice_net_raw_train,
            nice_net_raw_train_split,
        )

        hh = h if self.h_channels else None
        mesh = self._mesh(params)
        if (self.activation == "elu" and z.dtype == torch.bfloat16
                and params["out"]["b"].dtype == torch.bfloat16
                and (self.h_channels == 0 or h is not None)
                and nice_net_fits(params, z, hh)):
            inputs = [z, hh, params["w1"], params["w2"], *params["out"].values()]
            if torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad for t in inputs):
                if mesh is not None:
                    return nice_net_raw_train_split(params, z, hh, mesh)
                return nice_net_raw_train(params, z, hh)
            return nice_net_raw(params, z, hh, mesh)
        return self._raw(params, z, h)

    def ddi(self, params, x, h=None):
        if params["w2"].shape[-1] != params["w2"].shape[-2]:
            raise ValueError("NICE2d DDI runs on the whole tree: shard after it")
        z1, z2 = self._split(x)
        z, _ = self._zp_z(z1, z2)
        new = dict(params, out=wn_conv_ddi(
            params["out"], self._net_hidden(params, z, h), init_scale=0.0))
        y, ld = self.forward(new, x, h)
        return y, ld, new


# ---------------------------------------------------------------------------
# Units / steps / multi-scale
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaCowUnitChain(Chain):
    """A MaCowUnit chain whose inverse runs as one kernel (K2) for affine/ELU
    units on the square latents K2 can hold (``unit_fits``); otherwise the
    chain inverse, whose masked-conv flows go through K5 one by one.  The
    route depends on shapes only, never on the device."""

    def inverse(self, params, y, h=None):
        from ..ops.masked_conv import macow_unit_inverse, unit_fits

        mcf = self.flows[0]
        if (isinstance(mcf, MaskedConvFlow) and mcf.transform == "affine"
                and mcf.activation == "elu"
                and unit_fits(y.shape, mcf._hidden, mcf.kernel_size)
                # a unit built with h-conditioning rows must receive h
                and (mcf.h_channels == 0 or h is not None)):
            x = macow_unit_inverse(
                y, h if mcf.h_channels else None,
                [params[0], params[1], params[3], params[4]],
                [params[2], params[5]], mcf.kernel_size, mcf.alpha)
            return x.to(y.dtype)
        return super().inverse(params, y, h)


def make_macow_unit(in_channels, kernel_size, h_channels=0, transform="affine",
                    alpha=1.0, activation="elu") -> Chain:
    """MCF(A) -> MCF(B) -> ActNorm -> MCF(C) -> MCF(D) -> ActNorm."""
    kh, kw = kernel_size
    mk = lambda order, ks: MaskedConvFlow(
        in_channels, ks, order=order, h_channels=h_channels,
        transform=transform, alpha=alpha, activation=activation)
    return MaCowUnitChain((
        mk("A", (kh, kw)), mk("B", (kh, kw)), ActNorm(in_channels),
        mk("C", (kw, kh)), mk("D", (kw, kh)), ActNorm(in_channels),
    ))


def make_macow_step(in_channels, kernel_size, hidden_channels, h_channels=0,
                    transform="affine", alpha=1.0, activation="elu",
                    condition_nice=False) -> Chain:
    """ActNorm -> Shuffle -> 2x unit -> NICE(up) -> NICE(dn) -> ActNorm ->
    2x unit -> NICE(skip,up) -> NICE(skip,dn)."""
    nice_h = h_channels if condition_nice else 0
    unit = lambda: make_macow_unit(in_channels, kernel_size, h_channels,
                                   transform, alpha, activation)
    nice = lambda split, order: NICE2d(
        in_channels, hidden_channels=hidden_channels, h_channels=nice_h,
        split_type=split, order=order, transform=transform, alpha=alpha,
        activation=activation)
    return Chain((
        ActNorm(in_channels), Shuffle(in_channels), unit(), unit(),
        nice("continuous", "up"), nice("continuous", "down"),
        ActNorm(in_channels), unit(), unit(),
        nice("skip", "up"), nice("skip", "down"),
    ))


def _permutation(use_1x1: bool, channels: int) -> Flow:
    return InvConvLU(channels) if use_1x1 else Shuffle(channels)


@dataclasses.dataclass(frozen=True)
class MultiScalePrior(Flow):
    """perm -> NICE(continuous, up) -> ActNorm on the factored-out half."""

    in_channels: int
    hidden_channels: int
    h_channels: int = 0
    factor: int = 2
    transform: str = "affine"
    alpha: float = 1.0
    activation: str = "elu"
    use_1x1: bool = False
    condition_nice: bool = False

    @property
    def _perm(self):
        return _permutation(self.use_1x1, self.in_channels)

    @property
    def _coupling(self):
        return NICE2d(
            self.in_channels, hidden_channels=self.hidden_channels,
            h_channels=self.h_channels if self.condition_nice else 0,
            split_type="continuous", order="up", factor=self.factor,
            transform=self.transform, alpha=self.alpha,
            activation=self.activation)

    @property
    def z1_channels(self):
        return self._coupling.z1_channels

    @property
    def _actnorm(self):
        return ActNorm(self.in_channels // self.factor)

    def init(self, generator, device):
        return {"perm": self._perm.init(generator, device),
                "coupling": self._coupling.init(generator, device),
                "actnorm": self._actnorm.init(generator, device)}

    def forward(self, params, x, h=None):
        out, ld = self._perm.forward(params["perm"], x)
        out, l2 = self._coupling.forward(params["coupling"], out, h)
        z1, z2 = out[..., :self.z1_channels], out[..., self.z1_channels:]
        z2, l3 = self._actnorm.forward(params["actnorm"], z2)
        return torch.cat([z1, z2], dim=-1), ld + l2 + l3

    def inverse(self, params, y, h=None):
        z1, z2 = y[..., :self.z1_channels], y[..., self.z1_channels:]
        z2 = self._actnorm.inverse(params["actnorm"], z2)
        out = torch.cat([z1, z2], dim=-1)
        out = self._coupling.inverse(params["coupling"], out, h)
        return self._perm.inverse(params["perm"], out)

    def ddi(self, params, x, h=None):
        out, ld = self._perm.forward(params["perm"], x)
        out, l2, new_coupling = self._coupling.ddi(params["coupling"], out, h)
        z1, z2 = out[..., :self.z1_channels], out[..., self.z1_channels:]
        z2, l3, new_an = self._actnorm.ddi(params["actnorm"], z2)
        new = {"perm": params["perm"], "coupling": new_coupling,
               "actnorm": new_an}
        return torch.cat([z1, z2], dim=-1), ld + l2 + l3, new


@dataclasses.dataclass(frozen=True)
class ScannedSteps(Flow):
    """``n`` structurally identical steps over stacked parameters: every leaf
    carries a leading axis of length ``n``, as in the JAX package; the
    inverse walks the steps in reverse.

    While autograd records, each step of ``forward`` runs in a reentrant
    checkpoint unless ``remat`` is off (the JAX package's ``remat``, the scan under
    ``jax.checkpoint``), so training stores only the step boundaries.  The
    checkpoint's first pass runs without grad; the step's parameter leaves
    are its explicit inputs, since the level-0 input (the stop-gradient
    motion latent) requires no grad."""

    step: Flow
    n: int
    remat: bool = True

    def init(self, generator, device):
        return _stack([self.step.init(generator, device) for _ in range(self.n)])

    def forward(self, params, x, h=None):
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        for i in range(self.n):
            p = tree_map(lambda a: a[i], params)
            leaves, unflatten = tree_flatten(p)
            if self.remat and torch.is_grad_enabled() and any(
                    t.requires_grad for t in [x, *leaves]):
                def run(x, h, *leaves, unflatten=unflatten):
                    return self.step.forward(unflatten(leaves), x, h)

                x, l = checkpoint(run, x, h, *leaves, use_reentrant=True,
                                  preserve_rng_state=False)
            else:
                x, l = self.step.forward(p, x, h)
            ld = ld + l
        return x, ld

    def inverse(self, params, y, h=None):
        for i in reversed(range(self.n)):
            y = self.step.inverse(tree_map(lambda a: a[i], params), y, h)
        return y

    def ddi(self, params, x, h=None):
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        new = []
        for i in range(self.n):
            x, l, p2 = self.step.ddi(tree_map(lambda a: a[i], params), x, h)
            ld = ld + l
            new.append(p2)
        return x, ld, _stack(new)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


@dataclasses.dataclass(frozen=True)
class MultiScaleInternal(Flow):
    """Multi-scale MaCow stack with channel factoring per level.

    Per level i: ``num_steps[i]`` MaCowSteps (stacked), a MultiScalePrior, a
    permutation, then the last ``in_channels // factor`` channels are
    factored out.  The packed z is [final, split_{L-1}, ..., split_0] on the
    channel axis."""

    num_steps: Tuple[int, ...]
    in_channels: int
    hidden_channels: int
    h_channels: int = 0
    factor: int = 16
    transform: str = "affine"
    prior_transform: str = "affine"
    alpha: float = 1.0
    kernel_size: Tuple[int, int] = (2, 3)
    activation: str = "elu"
    use_1x1: bool = False
    condition_nice: bool = False

    def __post_init__(self):
        if len(self.num_steps) >= self.factor:
            raise ValueError("need len(num_steps) < factor")

    def _levels(self):
        """Static per-level structure: (steps, prior, perm, z1_channels)."""
        levels = []
        c = self.in_channels
        channel_step = self.in_channels // self.factor
        factor = self.factor
        for n in self.num_steps:
            step = make_macow_step(
                c, self.kernel_size, self.hidden_channels, self.h_channels,
                self.transform, self.alpha, self.activation,
                self.condition_nice)
            prior = MultiScalePrior(
                c, self.hidden_channels, self.h_channels, factor,
                self.prior_transform, self.alpha, self.activation,
                self.use_1x1, self.condition_nice)
            perm = _permutation(self.use_1x1, c)
            levels.append((ScannedSteps(step, n), prior, perm,
                           prior.z1_channels))
            c = c - channel_step
            factor -= 1
        return levels

    def init(self, generator, device):
        return [{"steps": steps.init(generator, device),
                 "prior": prior.init(generator, device),
                 "perm": perm.init(generator, device)}
                for steps, prior, perm, _ in self._levels()]

    def forward(self, params, x, h=None):
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        out, splits = x, []
        for (steps, prior, perm, z1c), p in zip(self._levels(), params):
            out, l1 = steps.forward(p["steps"], out, h)
            out, l2 = prior.forward(p["prior"], out, h)
            out, l3 = perm.forward(p["perm"], out)
            ld = ld + l1 + l2 + l3
            splits.append(out[..., z1c:])
            out = out[..., :z1c]
        splits.append(out)
        return torch.cat(splits[::-1], dim=-1), ld

    def ddi(self, params, x, h=None):
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        out, splits, new = x, [], []
        for (steps, prior, perm, z1c), p in zip(self._levels(), params):
            out, l1, new_steps = steps.ddi(p["steps"], out, h)
            out, l2, new_prior = prior.ddi(p["prior"], out, h)
            out, l3 = perm.forward(p["perm"], out)
            ld = ld + l1 + l2 + l3
            new.append({"steps": new_steps, "prior": new_prior,
                        "perm": p["perm"]})
            splits.append(out[..., z1c:])
            out = out[..., :z1c]
        splits.append(out)
        return torch.cat(splits[::-1], dim=-1), ld, new

    def inverse(self, params, y, h=None):
        levels = self._levels()
        out = y
        splits = []
        for _, _, _, z1c in levels:
            splits.append(out[..., z1c:])
            out = out[..., :z1c]
        for (steps, prior, perm, _), p, z2 in zip(
                reversed(levels), reversed(params), reversed(splits)):
            out = torch.cat([out, z2], dim=-1)
            out = perm.inverse(p["perm"], out)
            out = prior.inverse(p["prior"], out, h)
            out = steps.inverse(p["steps"], out, h)
        return out


@dataclasses.dataclass(frozen=True)
class MultiscaleStack(Flow):
    """MultiScaleInternal blocks in sequence (``architecture.multistack``),
    block i with ``levels[i]`` steps per level, ``factors[i]`` and a NICE
    hidden width of ``mid_channels_factor`` times its channels.  With
    ``reshape`` "down" ("up") the blocks from the middle one on see the
    latent space-to-depth (depth-to-space) reshaped, and their conditioning
    passes a 3x3 conv of its own (``h_transforms``, no bias): stride 2 with
    XLA's SAME padding (0 before, 1 after on an even size) for "down", stride
    1 then a nearest 2x upsample for "up"."""

    levels: Tuple[Tuple[int, ...], ...]
    factors: Tuple[int, ...]
    in_channels: int
    mid_channels_factor: int = 8
    h_channels: int = 0
    reshape: str = "none"  # none | down | up
    transform: str = "affine"
    prior_transform: str = "affine"
    kernel_size: Tuple[int, int] = (2, 3)
    activation: str = "elu"
    use_1x1: bool = False
    condition_nice: bool = False

    def __post_init__(self):
        if len(self.levels) != len(self.factors):
            raise ValueError("need one factor per block")
        if self.reshape not in ("none", "down", "up"):
            raise ValueError(f"reshape {self.reshape!r}")

    @property
    def _reshape_step(self):
        return len(self.levels) // 2 if self.reshape != "none" else None

    def _blocks(self):
        blocks, c = [], self.in_channels
        for i, (steps, f) in enumerate(zip(self.levels, self.factors)):
            if i == self._reshape_step:
                c = c * 4 if self.reshape == "down" else c // 4
            blocks.append(MultiScaleInternal(
                num_steps=tuple(steps), in_channels=c,
                hidden_channels=self.mid_channels_factor * c,
                h_channels=self.h_channels, factor=f, transform=self.transform,
                prior_transform=self.prior_transform,
                kernel_size=self.kernel_size, activation=self.activation,
                use_1x1=self.use_1x1, condition_nice=self.condition_nice))
        return blocks

    @property
    def _reshaper(self):
        return SpaceToDepth(inverse_direction=(self.reshape == "up"))

    def init(self, generator, device):
        params = {"blocks": [b.init(generator, device) for b in self._blocks()]}
        if self.h_channels and self._reshape_step is not None:
            n = len(self.levels) - self._reshape_step
            params["h_transforms"] = [
                conv_init(generator, device, 3, 3, self.h_channels, self.h_channels)
                for _ in range(n)]
        return params

    def _cond_for(self, params, i, h):
        if h is None or self._reshape_step is None or i < self._reshape_step:
            return h
        w = params["h_transforms"][i - self._reshape_step]
        hc = h.permute(0, 3, 1, 2)
        if self.reshape == "down":
            hc = F.conv2d(F.pad(hc, (0, 1, 0, 1)), w.permute(3, 2, 0, 1), stride=2)
        else:
            hc = F.conv2d(hc, w.permute(3, 2, 0, 1), padding=1)
            hc = hc.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return hc.permute(0, 2, 3, 1)

    def forward(self, params, x, h=None):
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        out = x
        for i, (b, p) in enumerate(zip(self._blocks(), params["blocks"])):
            if i == self._reshape_step:
                out, _ = self._reshaper.forward({}, out)
            out, l = b.forward(p, out, self._cond_for(params, i, h))
            ld = ld + l
        return out, ld

    def inverse(self, params, y, h=None):
        blocks, out = self._blocks(), y
        for i in reversed(range(len(blocks))):
            out = blocks[i].inverse(params["blocks"][i], out,
                                    self._cond_for(params, i, h))
            if i == self._reshape_step:
                out = self._reshaper.inverse({}, out)
        return out

    def ddi(self, params, x, h=None):
        """Data-dependent init through every block."""
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        out, new_blocks = x, []
        for i, (b, p) in enumerate(zip(self._blocks(), params["blocks"])):
            if i == self._reshape_step:
                out, _ = self._reshaper.forward({}, out)
            out, l, p2 = b.ddi(p, out, self._cond_for(params, i, h))
            new_blocks.append(p2)
            ld = ld + l
        return out, ld, dict(params, blocks=new_blocks)

    def output_shape(self, x_shape):
        h, w, c = x_shape
        if self.reshape == "down":
            return (h // 2, w // 2, c * 4)
        if self.reshape == "up":
            return (h * 2, w * 2, c // 4)
        return tuple(x_shape)
