"""Functional invertible-flow protocol (counterpart of ``ipoke_tpu/flows/base.py``).

A flow is a small frozen dataclass holding static configuration, with

  * ``init(generator, device) -> params``   a tree (nested dicts/lists) of tensors
  * ``forward(params, x, h=None) -> (y, logdet)``   logdet (B,) fp32
  * ``inverse(params, y, h=None) -> x``
  * ``ddi(params, x, h=None) -> (y, logdet, params')``  data-dependent init
  * ``output_shape(x_shape)``   the per-sample output shape

exactly as in the JAX package, so that a parameter tree converted from JAX
(``ipoke_tpu_torch.convert``) drives the same code path as one made here.
Arrays are NHWC; channel ops act on the last axis.  Leaves under keys that
start with ``buf_`` (the shuffle permutations, the LU permutation and
signs) are buffers, not parameters.

:class:`ParamTree` registers such a tree in an ``nn.Module`` so that
``.to(device/dtype)``, ``state_dict`` and ``parameters()`` work on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch
from torch import nn

Params = Any


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_flatten(tree):
    """(leaves, unflatten): ``unflatten(leaves)`` rebuilds the tree's
    nesting around new leaves, in ``tree_leaves`` order."""
    leaves = tree_leaves(tree)

    def unflatten(new):
        it = iter(new)
        return tree_map(lambda _: next(it), tree)

    return leaves, unflatten


def count_params(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


def randn(shape, generator, device, std: float = 1.0) -> torch.Tensor:
    """``std * N(0, 1)`` drawn from ``generator`` on ``device``; on ``meta``
    only the shape is made (no draw), for counting parameters."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return std * torch.randn(shape, generator=generator, device=device)


@dataclasses.dataclass(frozen=True)
class Flow:
    """Base class; subclasses are frozen dataclasses (static config)."""

    def init(self, generator, device) -> Params:
        raise NotImplementedError

    def forward(self, params, x, h=None):
        raise NotImplementedError

    def inverse(self, params, y, h=None):
        raise NotImplementedError

    def output_shape(self, x_shape):
        """The per-sample shape of ``forward``'s output for an input of
        per-sample shape ``x_shape``: the same, unless the flow reshapes."""
        return tuple(x_shape)

    def ddi(self, params, x, h=None):
        """Default: forward with the params unchanged."""
        y, ld = self.forward(params, x, h)
        return y, ld, params


@dataclasses.dataclass(frozen=True)
class Chain(Flow):
    """Sequential composition of heterogeneous flows."""

    flows: Tuple[Flow, ...]

    def init(self, generator, device):
        return [f.init(generator, device) for f in self.flows]

    def forward(self, params, x, h=None):
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        for f, p in zip(self.flows, params):
            x, l = f.forward(p, x, h)
            ld = ld + l
        return x, ld

    def inverse(self, params, y, h=None):
        for f, p in zip(reversed(self.flows), reversed(params)):
            y = f.inverse(p, y, h)
        return y

    def ddi(self, params, x, h=None):
        ld = x.new_zeros(x.shape[0], dtype=torch.float32)
        new_params = []
        for f, p in zip(self.flows, params):
            x, l, p2 = f.ddi(p, x, h)
            new_params.append(p2)
            ld = ld + l
        return x, ld, new_params


class ParamTree(nn.Module):
    """A parameter tree held by an ``nn.Module``: dict keys and list indices
    become submodule names, ``buf_*`` leaves buffers and every other leaf an
    ``nn.Parameter``, frozen until ``trainable()`` hands the leaves out (the
    JAX package's ``trainable_mask``).  ``tree()`` gives the nested tree
    back."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        items = enumerate(tree) if self._is_list else tree.items()
        self._keys = []
        for k, v in items:
            name = str(k)
            self._keys.append(name)
            if isinstance(v, (dict, list, tuple)):
                self.add_module(name, ParamTree(v))
            elif name.startswith("buf_"):
                self.register_buffer(name, v)
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))

    def tree(self):
        vals = [getattr(self, k) for k in self._keys]
        vals = [v.tree() if isinstance(v, ParamTree) else v for v in vals]
        return vals if self._is_list else dict(zip(self._keys, vals))

    def trainable(self) -> list:
        """The trainable leaves (every parameter; ``buf_*`` leaves are
        buffers), switched to ``requires_grad=True``."""
        return [p.requires_grad_(True) for p in self.parameters()]

    @torch.no_grad()
    def load_tree(self, tree) -> None:
        """Copy the values of a tree of the same structure in, in place, key
        by key (dtype and device stay the module's)."""
        for k in self._keys:
            dst, src = getattr(self, k), tree[int(k) if self._is_list else k]
            if isinstance(dst, ParamTree):
                dst.load_tree(src)
            else:
                dst.copy_(src)
