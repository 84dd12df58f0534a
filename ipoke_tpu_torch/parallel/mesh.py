"""Device mesh layer (counterpart of ``ipoke_tpu/parallel/mesh.py``): one
process a device over ``torch.distributed``, a ``data`` axis for batch
parallelism and a ``model`` axis that splits the cINN's NICE couplings'
hidden width.

A :class:`Mesh` is this rank's view: its coordinates on the axes and the
process groups of its rows.  Ranks are laid out as the JAX package's
``reshape``: ``(data, model)`` row-major, or ``(slice, data, model)`` for a
hybrid mesh, whose batch splits over the flattened ``(slice, data)``
groups while the hidden split stays inside a slice.  ``with mesh:`` makes
it the mesh that a NICE coupling holding a shard of its params runs on
(``current_mesh``).

The split (``flow_param_specs``), by the port's own layout (ROADMAP §3,
"Deliberate divergences"): a NICE coupling's ``w2`` (1, 1, Hid, Hid) is
split by its output columns over ``model``, so each rank computes Hid/tp
of the second hidden layer ``b`` exactly as the single device does; ``w1``
and the weight-norm out conv ``out.v`` stay whole on every rank, each rank
reading the out weight's rows of its own hidden units, so the norm
``||v||`` is taken over the whole contraction axis with no collective.
One all-reduce of the coupling's fp32 output closes the forward; the
backward sums the first hidden's gradient and the out weight's hidden rows
over ``model`` (``ops/nice_net.py``).  JAX shards ``w1`` by output, ``w2``
by input and ``out.v`` by contraction, and lets XLA place two all-reduces
of (M, Hid).  Every other leaf (ActNorms, shuffles, the masked-conv flows,
whose inverse is a row recurrence that a hidden split would cost an
all-reduce a row) stays replicated.  Stacked ``ScannedSteps`` leaves carry
a leading step axis; the split applies to the same trailing axes.

Placement: ``shard_batch`` is the rank's slice of a host batch (every rank
holds the whole batch, drawn from the same seed), ``replicate`` broadcasts
rank 0's values, ``shard_params`` cuts the rank's shard from a whole tree
and ``gather_params`` puts the whole tree back together (for
``convert.py`` and checkpoints).  ``average_grads`` is the data-parallel
gradient all-reduce, bucketed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..flows.base import tree_map
from .comm import all_reduce_, gather_slot

# the meshes of the enclosing ``with mesh:`` blocks, innermost last (JAX's
# ``with mesh:`` idiom: the flows' signatures carry no mesh)
_CURRENT: list = []


def current_mesh() -> Optional["Mesh"]:
    """The mesh of the innermost ``with mesh:``, or None."""
    return _CURRENT[-1] if _CURRENT else None


@dataclasses.dataclass
class Mesh:
    """This rank's place on a device mesh.  ``shape`` maps each axis to its
    size (as ``jax.sharding.Mesh.shape``), ``coords`` to this rank's index;
    ``groups`` holds the process group of this rank's row along ``model``,
    along the batch (``batch``: the flattened ``(slice, data)`` axes), and
    on a hybrid mesh along ``data`` inside the slice and along ``slice``.
    A group is None where its row is this rank alone."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, name: str):
        return self.groups.get(name)

    @property
    def tp(self) -> int:
        """Ranks that split a coupling's hidden width."""
        return self.size("model")

    @property
    def dp(self) -> int:
        """Ranks that split the batch: the product of ``slice`` and ``data``."""
        return self.size("slice") * self.size("data")

    @property
    def batch_index(self) -> int:
        """This rank's slot of the batch: (slice, data) flattened."""
        return self.index("slice") * self.size("data") + self.index("data")

    def __enter__(self):
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.pop()


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _group_of(rows: Sequence[Sequence[int]], rank: int):
    """Create one process group per row (every rank creates every row's, in
    the same order, as ``new_group`` asks) and return the one holding
    ``rank``; None for rows of one rank."""
    mine = None
    for row in rows:
        if len(row) == 1:
            if rank in row:
                mine = None
            continue
        g = dist.new_group(list(row))
        if rank in row:
            mine = g
    return mine


def _build(names: Tuple[str, ...], sizes: Tuple[int, ...], n_devices) -> Mesh:
    world, rank = _world()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs a process group of {n} ranks, one a "
            f"device; this one has {world} (torch.distributed.init_process_group "
            "with world_size n)")
    shape = dict(zip(names, sizes))
    strides = {a: math.prod(sizes[i + 1:]) for i, a in enumerate(names)}
    coords = {a: rank // strides[a] % shape[a] for a in names}

    def rows(free: Sequence[str]):
        """Ranks that differ only along the ``free`` axes, grouped."""
        fixed = [a for a in names if a not in free]
        out: Dict[tuple, list] = {}
        for r in range(n):
            key = tuple(r // strides[a] % shape[a] for a in fixed)
            out.setdefault(key, []).append(r)
        return list(out.values())

    batch_axes = [a for a in names if a != "model"]
    groups = {"model": _group_of(rows(["model"]), rank),
              "batch": _group_of(rows(batch_axes), rank)}
    if "slice" in names:
        groups["data"] = _group_of(rows(["data"]), rank)
        groups["slice"] = _group_of(rows(["slice"]), rank)
    return Mesh(names, shape, coords, groups)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """Mesh with axes (data, model); data = n_devices / model_parallel.
    Called by every rank of an initialised process group of ``n_devices``
    ranks (default: the whole group); without one, a mesh of one device."""
    world, _ = _world()
    n = world if n_devices is None else int(n_devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into model_parallel {model_parallel}")
    return _build(("data", "model"), (n // model_parallel, model_parallel), n)


def make_hybrid_mesh(n_slices: int, model_parallel: int = 1,
                     n_devices: Optional[int] = None) -> Mesh:
    """Mesh with axes (slice, data, model): data = n / (n_slices *
    model_parallel).  The batch splits over (slice, data); the gradient
    all-reduce runs inside each slice, then once across slices (the slow
    links of a multi-host deployment), and the hidden split stays inside
    a slice."""
    world, _ = _world()
    n = world if n_devices is None else int(n_devices)
    if n % (n_slices * model_parallel):
        raise ValueError(f"{n} devices do not split into {n_slices} slices x "
                         f"model_parallel {model_parallel}")
    dp = n // (n_slices * model_parallel)
    return _build(("slice", "data", "model"), (n_slices, dp, model_parallel), n)


def batch_spec(batch) -> Any:
    """The per-leaf split of a batch: its leading axis over ``data``."""
    return tree_map(lambda x: ("data",) + (None,) * (x.ndim - 1), batch)


def hybrid_batch_spec(batch) -> Any:
    """The leading axis over the (slice, data) super-axis."""
    return tree_map(lambda x: (("slice", "data"),) + (None,) * (x.ndim - 1), batch)


def shard_batch(batch, mesh: Mesh):
    """This rank's slice of a host batch along its leading axis (over the
    flattened (slice, data) axes; the model ranks of a row share it)."""
    def cut(x):
        n = x.shape[0]
        if n % mesh.dp:
            raise ValueError(f"a batch of {n} does not split over {mesh.dp} data ranks")
        k = n // mesh.dp
        return x.narrow(0, mesh.batch_index * k, k)

    return tree_map(cut, batch)


shard_batch_hybrid = shard_batch


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch from every rank's slice along the leading axis (the
    inverse of ``shard_batch``), on every rank."""
    return gather_slot(x, mesh.batch_index, mesh.dp, mesh.group("batch"))


def replicate(tree, mesh: Mesh):
    """Every tensor leaf set to global rank 0's value, in place."""
    if _world()[0] > 1:
        for t in _leaves(tree):
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=0)
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def flow_param_specs(params) -> Any:
    """The split of each leaf of a flow (or second-stage) tree: a tuple of
    one entry per axis, ``"model"`` on the axis split over the model axis,
    None elsewhere.  Only a NICE coupling's ``w2`` (..., 1, 1, Hid, Hid) is
    split, on its output columns (its last axis); every other leaf is
    replicated."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        keys = [k for k in path if isinstance(k, str)]
        spec = [None] * node.ndim
        if keys and keys[-1] == "w2" and node.ndim >= 4:
            spec[-1] = "model"
        return tuple(spec)

    return walk(params, ())


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_params(params, mesh: Mesh, specs=None):
    """This rank's shard of a whole tree: each leaf split on its
    ``"model"`` axis (``flow_param_specs``) cut to the rank's contiguous
    block, every other leaf as it is.  Works on ``meta`` tensors."""
    specs = flow_param_specs(params) if specs is None else specs
    tp, r = mesh.tp, mesh.index("model")

    def cut(x, spec):
        if "model" not in spec:
            return x
        ax = spec.index("model")
        if x.shape[ax] % tp:
            raise ValueError(f"a hidden width of {x.shape[ax]} does not split "
                             f"over model_parallel {tp}")
        k = x.shape[ax] // tp
        return x.narrow(ax, r * k, k).clone()

    return _zip_map(cut, params, specs)


def gather_params(params, mesh: Mesh, specs=None):
    """The whole tree from every model rank's shard (the inverse of
    ``shard_params``), on every rank."""
    specs = flow_param_specs(params) if specs is None else specs
    group, tp, r = mesh.group("model"), mesh.tp, mesh.index("model")

    def join(x, spec):
        if "model" not in spec:
            return x
        return gather_slot(x.detach(), r, tp, group, dim=spec.index("model"))

    return _zip_map(join, params, specs)


def average_grads(params, mesh: Mesh, bucket_elems: int = 1 << 24) -> None:
    """The data-parallel step: every ``.grad`` of ``params`` averaged over
    the batch axes, in place, in buckets of at most ``bucket_elems``
    elements a dtype (inside each slice, then across slices, on a hybrid
    mesh)."""
    groups = [mesh.group("data"), mesh.group("slice")] if "slice" in mesh.shape \
        else [mesh.group("batch")]
    groups = [g for g in groups if g is not None]
    if not groups:
        return
    grads = [p.grad for p in params if p.grad is not None]
    buckets: Dict[tuple, list] = {}
    for g in grads:
        key = (g.dtype, g.device)
        run = buckets.setdefault(key, [[]])
        if run[-1] and sum(x.numel() for x in run[-1]) + g.numel() > bucket_elems:
            run.append([])
        run[-1].append(g)
    for runs in buckets.values():
        for run in runs:
            flat = torch.cat([g.reshape(-1) for g in run])
            for group in groups:
                all_reduce_(flat, group)
            flat /= mesh.dp
            for g, part in zip(run, flat.split([g.numel() for g in run])):
                g.copy_(part.view_as(g))


def mean_over_batch(values: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Scalar logs averaged over the data ranks (the whole batch's mean)."""
    group = mesh.group("batch")
    if group is None or not values:
        return values
    keys = sorted(values)
    flat = torch.stack([values[k].float() for k in keys])
    all_reduce_(flat, group)
    flat /= mesh.dp
    return {k: flat[i].to(values[k].dtype) for i, k in enumerate(keys)}
