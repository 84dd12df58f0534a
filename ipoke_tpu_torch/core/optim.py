"""Optimizers (counterpart of ``ipoke_tpu/core/optim.py``).

``gan_adam`` is the first stage's: ``torch.optim.Adam`` with betas (0.5,
0.9) and coupled L2 weight decay, which is optax's ``add_decayed_weights``
before ``scale_by_adam``; ``exp_decay_per_epoch`` its staircase schedule.
A gated step (``disc_gate`` 0) is skipped, so neither params nor moments
move, as the JAX package's ``gated_update`` keeps them.

``flow_adam`` is the JAX package's default flow optimizer: an optional clip
by global norm (``clip_grad_norm`` > 0, optax's ``clip_by_global_norm``:
every grad scaled by clip / norm where the norm reaches clip), coupled L2
weight decay, then torch's exact AMSGrad, then the learning-rate schedule, which is
read at the update count before the update (optax's ``count`` starts at 0, so
a warmup's first step has lr 0).  ``torch.optim.Adam(amsgrad=True,
weight_decay=...)`` is exactly that update.  Only parameters are handed in:
the ``buf_*`` leaves of a flow tree are buffers and never get a gradient.

With ``use_adafactor`` the rule is optax's ``scale_by_factored_rms()`` at its
defaults (``Adafactor``; not ``torch.optim.Adafactor``, which factors every
tensor of 2 or more dims, clips the update and scales it by the parameter's
RMS); with ``use_adabelief`` optax's ``scale_by_belief()`` (``AdaBelief``).
The chain around them is the same: clip, coupled decay, rule, schedule.

``adam`` is plain ``optax.adam`` (the flow VAE's).

``master_weights`` is the mixed-precision recipe: bf16-resident params, an
fp32 master copy of each that the inner optimizer updates, and params set to
``bf16(master)`` after every step (the inner optimizer's clip sees the fp32
grads).

``with_grad_accumulation`` is ``optax.MultiSteps``: k microbatches' grads
averaged (a running mean in the params' dtype) into one update of the inner
optimizer, whose count and schedule advance once per k; params do not move
between updates.

Every optimizer has ``state_dict`` / ``load_state_dict`` (its count, the
torch Adam state, masters, the accumulator) for checkpoints.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]


def warmup_linear_decay(lr: float, warmup_steps: int,
                        total_steps: int) -> Callable[[int], float]:
    """Linear 0 -> lr over ``warmup_steps``, then linear decay to 0 at
    ``total_steps`` (optax's ``join_schedules`` of two linear schedules)."""
    decay_steps = max(1, total_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return lr * count / warmup_steps
        frac = min(max(count - warmup_steps, 0), decay_steps) / decay_steps
        return lr * (1.0 - frac)

    return schedule


def exp_decay_per_epoch(lr: float, gamma: float,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """torch ``ExponentialLR`` stepped once per epoch: lr * gamma ** (count
    // steps_per_epoch) (optax's staircase ``exponential_decay``)."""
    steps = max(1, steps_per_epoch)
    return lambda count: lr * gamma ** (count // steps)


def cast_floats(tree, dtype):
    """Cast every float tensor of a dict/list tree to ``dtype``; others pass
    through."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the ``.grad`` of ``params``: where the
    global norm (summed in fp32 or wider) reaches ``max_norm``, every gradient
    becomes ``g / norm * max_norm`` (``torch.nn.utils.clip_grad_norm_``
    scales by ``max_norm / (norm + 1e-6)`` instead).  Returns the norm."""
    params = [p for p in params if p.grad is not None]
    norm = torch.sqrt(sum((p.grad.to(torch.promote_types(p.grad.dtype, torch.float32)) ** 2)
                          .sum() for p in params))
    keep = norm < max_norm  # no host sync
    for p in params:
        g = p.grad
        p.grad = torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
    return norm


WEIGHT_DECAY = 1e-5  # the JAX package's flow_adam default, which the trainer uses


class _Adam:
    """An optax Adam chain over a list of tensors: ``torch.optim.Adam`` with
    coupled weight decay at lr = ``schedule(count)``, ``count`` the updates
    made so far.  ``step`` reads each tensor's ``.grad`` (a missing one
    counts as zero, as in optax, so decay and moments still move) and clears
    it."""

    def __init__(self, params: Iterable[torch.Tensor], lr_schedule: Schedule,
                 betas, weight_decay: float, amsgrad: bool,
                 clip_grad_norm: float = 0.0):
        self.params = list(params)
        self.schedule = lr_schedule if callable(lr_schedule) \
            else (lambda _: lr_schedule)
        self.clip = float(clip_grad_norm or 0.0)
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=0.0, betas=betas,
                                     eps=1e-8, weight_decay=weight_decay,
                                     amsgrad=amsgrad)

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip > 0:
            clip_by_global_norm_(self.params, self.clip)
        for group in self.adam.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adam": self.adam.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.adam.load_state_dict(state["adam"])


class _Chain:
    """An optax chain over a list of tensors: the clip by global norm (when
    ``clip_grad_norm`` > 0), coupled weight decay ``g + wd * p``, the rule's
    ``_update(i, g)`` for the i-th tensor, then ``p + (-lr * u)`` with lr =
    ``schedule(count)`` read before the update.  ``step`` reads each
    tensor's ``.grad`` (a missing one counts as zero) and clears it."""

    def __init__(self, params: Iterable[torch.Tensor], lr_schedule: Schedule,
                 weight_decay: float, clip_grad_norm: float = 0.0):
        self.params = list(params)
        self.schedule = lr_schedule if callable(lr_schedule) \
            else (lambda _: lr_schedule)
        self.wd = float(weight_decay)
        self.clip = float(clip_grad_norm or 0.0)
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip > 0:
            clip_by_global_norm_(self.params, self.clip)
        lr = float(self.schedule(self.count))
        for i, p in enumerate(self.params):
            g = p.grad.add(p, alpha=self.wd) if self.wd else p.grad
            p.grad = None
            p.add_(self._update(i, g).mul_(-lr))
        self.count += 1

    def _update(self, i: int, g: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _state(self) -> dict:
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {"count": self.count, **self._state()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for key, dst in self._state().items():
            for a, v in zip(dst, state[key]):
                if a is not None:
                    a.copy_(v)


def factored_dims(shape, min_dim_size_to_factor: int = 128) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest axis of ``shape`` in numpy's argsort order, or None when the tensor has fewer than 2 dims or the second
    largest is under ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Chain):
    """optax ``scale_by_factored_rms()`` at its defaults in the chain: per
    tensor, g^2 + 1e-30 into second moments decayed by ``1 - (count +
    1)^-0.8`` (its own count: under ``MultiSteps`` it moves once per k).  A
    tensor whose two largest dims are both >= 128 keeps their row and column
    means (``v_row`` without the largest axis d0, ``v_col`` without d1) and
    updates ``g * (v_row / mean v_row)^-1/2 * v_col^-1/2``; any other keeps
    a full ``v`` and updates ``g * v^-1/2``.  No momentum, no update clip,
    no parameter scaling.  The state is the rule's, in the tensors' own
    layout (a stacked leaf factors per 2-D slice of its two largest axes)."""

    def __init__(self, params, lr_schedule: Schedule, weight_decay: float,
                 clip_grad_norm: float = 0.0):
        super().__init__(params, lr_schedule, weight_decay, clip_grad_norm)
        self.dims = [factored_dims(tuple(p.shape)) for p in self.params]
        self.v_row, self.v_col, self.v = [], [], []
        for p, dims in zip(self.params, self.dims):
            z = lambda drop: torch.zeros(
                [n for a, n in enumerate(p.shape) if a != drop],
                dtype=p.dtype, device=p.device)
            self.v_row.append(z(dims[1]) if dims else None)
            self.v_col.append(z(dims[0]) if dims else None)
            self.v.append(None if dims else torch.zeros_like(p))

    def _update(self, i, g):
        t = torch.tensor(self.count + 1, dtype=torch.float32)
        decay = float(1.0 - t ** -0.8)
        g2 = g * g + 1e-30
        if self.dims[i] is None:
            v = self.v[i]
            v.mul_(decay).add_(g2.mul_(1.0 - decay))
            return g * v.rsqrt()
        d1, d0 = self.dims[i]
        v_row, v_col = self.v_row[i], self.v_col[i]
        v_row.mul_(decay).add_(g2.mean(dim=d0).mul_(1.0 - decay))
        v_col.mul_(decay).add_(g2.mean(dim=d1).mul_(1.0 - decay))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)).rsqrt()
        return g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)

    def _state(self):
        return {"v_row": self.v_row, "v_col": self.v_col, "v": self.v}


class AdaBelief(_Chain):
    """optax ``scale_by_belief()`` in the chain: b1 0.9, b2 0.999, eps
    1e-16, eps_root 1e-16; mu = b1 mu + (1 - b1) g, the prediction error
    g - mu against the new mu, nu = b2 nu + (1 - b2) (g - mu)^2 + eps_root
    (every step), update mu_hat / (sqrt(nu_hat) + eps) with the bias
    corrections at count + 1."""

    b1, b2, eps, eps_root = 0.9, 0.999, 1e-16, 1e-16

    def __init__(self, params, lr_schedule: Schedule, weight_decay: float,
                 clip_grad_norm: float = 0.0):
        super().__init__(params, lr_schedule, weight_decay, clip_grad_norm)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _update(self, i, g):
        b1, b2, t = self.b1, self.b2, self.count + 1
        mu, nu = self.mu[i], self.nu[i]
        mu.mul_(b1).add_(g * (1.0 - b1))
        err = g - mu
        nu.mul_(b2).add_(err.mul_(err).mul_(1.0 - b2)).add_(self.eps_root)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        return (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))

    def _state(self):
        return {"mu": self.mu, "nu": self.nu}


def state_bytes(tx) -> int:
    """The bytes of an optimizer's state tensors (moments, masters,
    accumulators), whatever its wrapping."""
    def walk(node):
        if torch.is_tensor(node):
            return node.numel() * node.element_size()
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(walk(v) for v in node)
        return 0
    return walk(tx.state_dict())


def adam(params, lr_schedule: Schedule) -> _Adam:
    """``optax.adam``: betas (0.9, 0.999), no weight decay, no AMSGrad (the
    flow VAE's optimizer)."""
    return _Adam(params, lr_schedule, (0.9, 0.999), 0.0, False)


def flow_adam(params, lr_schedule: Schedule, clip_grad_norm: float = 0.0,
              use_adabelief: bool = False, use_adafactor: bool = False):
    """The flow optimizer over ``params`` (the trainable leaves), after the
    clip by global norm when ``clip_grad_norm`` > 0: ``Adafactor`` with
    ``use_adafactor``, else ``AdaBelief`` with ``use_adabelief``, else
    AMSGrad (the JAX package's ``flow_adam`` chooses so)."""
    if use_adafactor:
        return Adafactor(params, lr_schedule, WEIGHT_DECAY, clip_grad_norm)
    if use_adabelief:
        return AdaBelief(params, lr_schedule, WEIGHT_DECAY, clip_grad_norm)
    return _Adam(params, lr_schedule, (0.9, 0.999), WEIGHT_DECAY, True,
                 clip_grad_norm)


def gan_adam(params, lr_schedule: Schedule, weight_decay: float = 1e-5) -> _Adam:
    """The first stage's optimizer over ``params``: Adam, betas (0.5, 0.9)."""
    return _Adam(params, lr_schedule, (0.5, 0.9), weight_decay, False)


def gated_update(tx, gate) -> bool:
    """The JAX package's ``gated_update``: ``tx.step()`` when ``gate`` > 0
    (a float or a 0-dim tensor, read on the host); otherwise the grads are
    dropped and neither params, Adam's moments nor its count move.  Zero
    grads would not do: the coupled weight decay would still step the
    params and the moments would decay.  Returns whether it stepped."""
    if float(gate) > 0:
        tx.step()
        return True
    for p in tx.params:
        p.grad = None
    return False


class _MasterWeights:
    """bf16-resident ``params`` with fp32 masters: ``step`` hands the grads,
    upcast, to the inner optimizer over the masters, then copies
    ``master.to(param dtype)`` into each param (the JAX package's update
    ``bf16(master) - p`` leaves p within 1 ulp of that; here it is exact)."""

    def __init__(self, params: Iterable[torch.Tensor],
                 make_inner: Callable[[list], _Adam]):
        self.params = list(params)
        self.master = [p.detach().float().clone() for p in self.params]
        self.inner = make_inner(self.master)

    @torch.no_grad()
    def step(self) -> None:
        for p, m in zip(self.params, self.master):
            m.grad = None if p.grad is None else p.grad.float()
            p.grad = None
        self.inner.step()
        for p, m in zip(self.params, self.master):
            p.copy_(m)

    @property
    def count(self) -> int:
        return self.inner.count

    def state_dict(self) -> dict:
        return {"master": list(self.master), "inner": self.inner.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for m, v in zip(self.master, state["master"]):
            m.copy_(v)
        self.inner.load_state_dict(state["inner"])


def master_weights(params, make_inner: Callable[[list], _Adam]) -> _MasterWeights:
    """``make_inner(masters)`` builds the inner optimizer over fp32 copies
    of ``params``, taken now (after any bf16 cast, as the JAX trainer
    builds its optimizer after DDI and the cast)."""
    return _MasterWeights(params, make_inner)


class _MultiSteps:
    """``optax.MultiSteps(tx, every_k_schedule=k)`` over ``tx.params``:
    ``step`` folds each param's ``.grad`` (zero when missing) into a running
    mean, ``acc + (g - acc) / (n + 1)``, and clears it; the k-th call hands
    the mean to ``tx`` as its grads and steps it."""

    def __init__(self, tx, k: int):
        self.inner, self.k = tx, k
        self.params = tx.params
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.n = 0

    @property
    def count(self) -> int:
        return self.inner.count

    @torch.no_grad()
    def step(self) -> None:
        for p, acc in zip(self.params, self.acc):
            if p.grad is not None:
                acc.add_((p.grad.to(acc.dtype) - acc) / (self.n + 1))
            else:
                acc.sub_(acc / (self.n + 1))
            p.grad = None
        self.n += 1
        if self.n < self.k:
            return
        for p, acc in zip(self.params, self.acc):
            p.grad = acc.clone()
            acc.zero_()
        self.n = 0
        self.inner.step()

    def state_dict(self) -> dict:
        return {"acc": list(self.acc), "n": self.n,
                "inner": self.inner.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for a, v in zip(self.acc, state["acc"]):
            a.copy_(v)
        self.n = int(state["n"])
        self.inner.load_state_dict(state["inner"])


def with_grad_accumulation(tx, config, batch_size: int):
    """``(tx, k)``: ``tx`` wrapped to accumulate k = ceil(min_acc_batch_size
    / batch_size) microbatches per update (``training.min_acc_batch_size``,
    reference experiments/experiment.py:81-82); ``tx`` itself when k is 1."""
    import math

    min_acc = int(config.get("training", {}).get("min_acc_batch_size", 0) or 0)
    bs = max(1, int(batch_size))
    if min_acc <= bs:
        return tx, 1
    k = math.ceil(min_acc / bs)
    return _MultiSteps(tx, k), k
