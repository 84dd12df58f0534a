"""Weights carried across from the JAX package.

The JAX package's trees arrive as nested dicts/lists of numpy arrays
(``to_numpy_tree`` makes them from JAX/flax trees; it imports no JAX itself).

* A flow tree (the cINN's, the third stage's bridge) maps 1:1 onto the
  port's (``flow_params``): same nesting, same leaf shapes.  The second
  stage's params go both ways with ``second_stage_params`` and
  ``jax_second_stage_params``: with ``augmented_input`` its ``flow_params``
  is JAX's whole tree, ``scale_augment`` and ``shift_augment`` included.  Stacked
  ``ScannedSteps`` leaves keep their leading n axis; the port walks them
  like the JAX scan does.  Under ``conv_adapt`` the tree also holds the
  adapters ``adapt_poke`` / ``adapt_cond`` in flax's layout.
* The flax nets map path by path onto the port's modules, whose names
  repeat flax's (``load_flax``).  Conv kernels go from HWIO to OIHW (3D
  kernels from DHWIO to OIDHW), transpose-conv kernels are flipped (under
  ``torch_crop``, flax's ``transpose_kernel=True``, transposed instead).  A
  flax spectral norm keeps its ``u`` and ``sigma`` in ``batch_stats``: a
  port conv built with ``snorm`` (training) takes them as they are; one
  without it (a frozen net) takes the kernel collapsed with flax's eval
  rule (``collapse_spectral_norm``).  The third stage's ``ConvFlowVAE``
  keeps its spectral norms live, frozen or trained, and takes every u and
  sigma.
* The image AE's state, ``{'ae', 'logvar'}`` with its discriminator
  (``load_image_ae``); the FirstStageWrapper's decoder maps like any flax
  net, and so do a variational encoder's ``NormConv2d`` heads (their ``v``
  stays HWIO).
* The FC tower maps like any flax net, by name, through ``load_flax``:
  the BigAE (its conditional batch norms' Dense layers, the attention's
  ``gamma``), ``FirstStageFCWrapper`` and ``FCBaselineModel`` with every
  spectral norm's ``u`` and ``sigma`` (``NormConv2d``'s ``v`` stays HWIO,
  the GRU cells' ``ir`` .. ``hn`` are Dense layers); its flat flows'
  trees through ``flow_params``.  MotionFeatureNet reads the JAX package's flat npz keys itself
  (``nn.motion_feat.load_motion_feat``).
* The dormant zoo maps like the rest: the flow trees of ``flows.extra``
  (MixCDF, the hierarchical coupling flow, MADE, the gated conv and
  attention) and ``flows.leapfrog`` through ``flow_params``; the flax
  ``Generator3D`` (its ``_Spade3D``, ``AdaIN`` and biased 3D convs) and
  ``MinibatchDiscrimination`` (``T``) through ``load_flax``.
* A tree sharded over a mesh's model axis (``ipoke_tpu_torch.parallel``):
  ``flow_params_shard`` cuts a rank's shard from a JAX tree,
  ``jax_flow_params`` gathers a rank's shard back into the whole numpy
  tree.
* The evaluation nets: I3D and PoseResNet map like any flax net, their
  inference BatchNorms taking ``scale``/``bias`` from ``params`` and
  ``mean``/``var`` from ``batch_stats``; PoseResNet's deconvs
  (``transpose_kernel=True``) take the kernel transposed, not flipped.
  LPIPS params ``{'vgg', 'lins'}`` go through ``load_lpips``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .flows.base import tree_map
from .nn.blocks import BatchNorm, Conv, ConvTranspose, ConvTransposeTK, GroupNorm
from .nn.motion import Conv3d


def to_numpy_tree(tree):
    """A JAX/flax tree (dicts, FrozenDicts, lists, tuples, arrays) as nested
    dicts/lists of numpy arrays."""
    if isinstance(tree, Mapping):
        return {str(k): to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def flow_params(tree, device="cpu", dtype=None):
    """Torch tree of a numpy flow tree; float leaves cast to ``dtype``."""
    def leaf(a):
        t = torch.as_tensor(np.array(a), device=device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return tree_map(leaf, tree)


def flow_params_shard(tree, mesh, device="cpu", dtype=None):
    """This rank's shard (``parallel.shard_params``) of a numpy flow tree."""
    from .parallel import shard_params

    return shard_params(flow_params(tree, device, dtype), mesh)


def jax_flow_params(tree, mesh=None):
    """A port flow tree as the JAX package's numpy tree, fp32: on a mesh
    rank's shard the whole tree, gathered over the model axis
    (``parallel.gather_params``; every rank of the row calls it)."""
    if mesh is not None:
        from .parallel import gather_params

        tree = gather_params(tree, mesh)
    return tree_map(lambda t: (t.detach().float() if t.is_floating_point() else t)
                    .cpu().numpy(), tree)


def second_stage_params(params, device="cpu", dtype=None):
    """The port's ``flow_params`` tree of the JAX package's second-stage
    params ``{"flow": ..., ["scale_augment", "shift_augment"], ["adapt_poke"],
    ["adapt_cond"]}``: the whole tree when it holds more than the flow
    (``augmented_input``, ``conv_adapt``), the flow's alone otherwise.  The
    adapters keep flax's layout (HWIO kernels)."""
    tree = params if len(params) > 1 else params["flow"]
    return flow_params(tree, device, dtype)


def jax_second_stage_params(model):
    """The JAX package's second-stage params, as numpy, of the port's
    ``SecondStageModel``: ``{"flow": ...}`` and the leaves beside it
    (``augmented_input``'s scale and shift, the ``conv_adapt`` adapters);
    float leaves as fp32."""
    tree = tree_map(lambda t: (t.detach().float() if t.is_floating_point() else t)
                    .cpu().numpy(), model.flow_params.tree())
    return tree if model.wraps_flow else {"flow": tree}


def _l2_normalize(x, eps):
    return x * (1.0 / np.sqrt((x * x).sum(keepdims=True) + eps))


def collapse_spectral_norm(kernel, u, eps: float = 1e-12):
    """The weight that flax's ``SpectralNorm`` uses in eval mode
    (``update_stats=False``): one power-iteration step from the stored ``u``
    over the kernel reshaped to (-1, out), sigma = v W u^T, then W / sigma.
    Computed in fp32 like flax."""
    kernel = np.asarray(kernel, np.float32)
    value = kernel.reshape(-1, kernel.shape[-1])
    u0 = np.asarray(u, np.float32).reshape(1, -1)
    v0 = _l2_normalize(u0 @ value.T, eps)
    u0 = _l2_normalize(v0 @ value, eps)
    sigma = (v0 @ value @ u0.T)[0, 0]
    return kernel / (sigma if sigma != 0 else np.float32(1.0))


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _copy(param, value, where):
    value = torch.as_tensor(np.array(value))
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"{where}: port shape {tuple(param.shape)} != "
                         f"converted {tuple(value.shape)}")
    with torch.no_grad():
        param.copy_(value)


def spectral_norm_stats(stats, path):
    """(u, sigma) of the flax spectral norm around the layer at ``path``, or
    None.  flax keeps them under the parent, at
    ``SpectralNorm_<i>/"<layer>/kernel/u"`` (and ``.../sigma``), the i-th
    spectral norm of the parent, whichever layer it wraps."""
    if not path:
        return None
    try:
        parent = _get(stats, path[:-1])
    except KeyError:
        return None
    key = f"{path[-1]}/kernel/"
    for name, node in parent.items():
        if name.startswith("SpectralNorm_") and key + "u" in node:
            return node[key + "u"], node[key + "sigma"]
    return None


def load_flax(module: torch.nn.Module, params, stats=None) -> None:
    """Copy a flax variable tree (``params`` and its ``batch_stats``) into
    ``module``, whose submodule names repeat the flax names.  Every port
    parameter must be found; flax leaves of submodules the port does not
    have (e.g. the motion encoder of a model built without one) are
    ignored."""
    stats = stats or {}
    for name, sub in module.named_modules():
        path = name.split(".") if name else []
        where = "/".join(path) or "<root>"
        if isinstance(sub, (Conv, ConvTranspose, Conv3d)):
            node = _get(params, path)
            kernel = np.asarray(node["kernel"], np.float32)
            sn = spectral_norm_stats(stats, path)
            if sub.snorm:
                if sn is None:
                    raise KeyError(f"{where}: no spectral norm stats")
                _copy(sub.u, sn[0], f"{where}/u")
                _copy(sub.sigma, sn[1], f"{where}/sigma")
            elif sn is not None:
                kernel = collapse_spectral_norm(kernel, sn[0])
            if isinstance(sub, Conv):
                w = kernel.transpose(3, 2, 0, 1)
            elif isinstance(sub, ConvTranspose):  # torch_crop: transpose_kernel
                w = kernel.transpose(3, 2, 0, 1) if sub.torch_crop \
                    else np.flip(kernel, (0, 1)).transpose(2, 3, 0, 1)
            else:  # DHWIO -> OIDHW, no bias
                w = kernel.transpose(4, 3, 0, 1, 2)
            _copy(sub.weight, w, where)
            if getattr(sub, "bias", None) is not None:
                _copy(sub.bias, node["bias"], where)
        elif isinstance(sub, ConvTransposeTK):
            kernel = np.asarray(_get(params, path)["kernel"], np.float32)
            _copy(sub.weight, kernel.transpose(3, 2, 0, 1), where)
        elif isinstance(sub, BatchNorm):
            node, st = _get(params, path), _get(stats, path)
            for name, value in (("scale", node["scale"]), ("bias", node["bias"]),
                                ("mean", st["mean"]), ("var", st["var"])):
                _copy(getattr(sub, name), value, f"{where}/{name}")
        elif isinstance(sub, GroupNorm):
            if sub.scale is not None:
                node = _get(params, path)
                _copy(sub.scale, node["scale"], where)
                _copy(sub.bias, node["bias"], where)
        else:
            for pname, p in sub.named_parameters(recurse=False):
                _copy(p, _get(params, path + [pname]), f"{where}/{pname}")


def load_image_ae(model, params, stats=None, disc=None, params_d=None,
                  stats_d=None) -> None:
    """The JAX package's image-AE state (``models/image_ae.py``'s
    ``AETrainState``): ``params`` {'ae': the ``FirstStageWrapper`` tree,
    'logvar': ()} and its ``stats`` into the port's ``ImageAE``, and the
    discriminator's ``params_d`` / ``stats_d`` into ``disc`` if given."""
    load_flax(model.ae, params["ae"], stats)
    _copy(model.logvar, params["logvar"], "logvar")
    if disc is not None:
        load_flax(disc, params_d, stats_d)


def load_lpips(net, params) -> None:
    """The JAX package's LPIPS params ``{'vgg': the VGG16 tree, 'lins': five
    (C,) heads}`` into the port's ``nn.lpips.LPIPS``."""
    load_flax(net.vgg, params["vgg"])
    for k, w in enumerate(params["lins"]):
        _copy(net.lins[k], w, f"lins/{k}")


# ---------------------------------------------------------------------------
# optimizer states
# ---------------------------------------------------------------------------

def _empty(node) -> bool:
    """An empty optax state as restored: None (``to_numpy_tree`` makes it a
    0-d object array), or an empty container."""
    if isinstance(node, np.ndarray) and node.dtype == object and node.shape == ():
        node = node.item()
    return node is None or (isinstance(node, (dict, list, tuple)) and not node)


def _rule_states(node, path):
    """The rule state (``mu`` / ``v_row`` ...) and the schedule's ``{count}``
    of one optax chain's state, as orbax restores it (named tuples as
    dicts, tuples as lists, empty states None), under an optional
    ``multi_transform`` mask (its ``train`` label)."""
    if isinstance(node, dict) and "inner_states" in node:
        node, path = node["inner_states"]["train"]["inner_state"], \
            path + "/inner_states/train/inner_state"
    items = node if isinstance(node, list) else [node]
    rule = sched = None
    for i, item in enumerate(items):
        if _empty(item):
            continue
        if not isinstance(item, dict):
            raise ValueError(f"{path}/{i}: an optax state the port cannot map")
        if set(item) == {"count"}:
            sched = int(np.asarray(item["count"]))
        elif "count" in item and ({"mu", "nu"} <= set(item) or "v_row" in item):
            rule = item
        else:
            raise ValueError(f"{path}/{i}: an optax state the port cannot map "
                             f"(keys {sorted(item)})")
    if rule is None:
        raise ValueError(f"{path}: no optimizer rule state")
    count = int(np.asarray(rule["count"]))
    if sched is not None and sched != count:
        raise ValueError(f"{path}: the schedule's count {sched} is not the rule's {count}")
    return rule, count


def optax_state_dict(state, tx, moments, path="opt"):
    """``tx.state_dict()`` (a port optimizer of ``core.optim``) holding the
    optax state ``state`` of the JAX package's counterpart, as orbax
    restores it: ``optax.MultiSteps`` -> ``_MultiSteps`` (the mini-step
    count and the accumulator), ``master_weights`` -> ``_MasterWeights``,
    the torch-exact AMSGrad / ``gan_adam``'s and ``optax.adam``'s Adam ->
    ``_Adam`` (each tensor's step, first, second and max second moments),
    ``scale_by_factored_rms`` -> ``Adafactor``, ``scale_by_belief`` ->
    ``AdaBelief``; the count of updates, which the lr schedule reads, from
    the rule (and the schedule, which must agree).  ``moments(tree)`` maps a
    tree shaped like the JAX params (a moment, an accumulator, the masters)
    to tensors in ``tx.params`` order.  A state the port cannot map raises
    and names its path; nothing starts fresh."""
    from .core import optim

    # copies: torch's Adam keeps the tensors it loads, and steps them in place
    tensors = lambda tree: [t.detach().clone() for t in moments(tree)]
    if isinstance(tx, optim._MultiSteps):
        for key in ("mini_step", "acc_grads", "inner_opt_state"):
            if not isinstance(state, dict) or key not in state:
                raise ValueError(f"{path}: not an optax.MultiSteps state (no {key})")
        return {"acc": tensors(state["acc_grads"]), "n": int(np.asarray(state["mini_step"])),
                "inner": optax_state_dict(state["inner_opt_state"], tx.inner, moments,
                                          path + "/inner_opt_state")}
    if isinstance(tx, optim._MasterWeights):
        if not isinstance(state, dict) or {"master", "inner"} - set(state):
            raise ValueError(f"{path}: not a master_weights state")
        return {"master": [t.float() for t in tensors(state["master"])],
                "inner": optax_state_dict(state["inner"], tx.inner, moments,
                                          path + "/inner")}
    rule, count = _rule_states(state, path)
    if isinstance(tx, optim.Adafactor):
        if "v_row" not in rule:
            raise ValueError(f"{path}: Adafactor wants scale_by_factored_rms's state")
        return {"count": count, **{key: [t if dst is not None else None
                                         for t, dst in zip(tensors(rule[key]), own)]
                                   for key, own in tx._state().items()}}
    if isinstance(tx, optim.AdaBelief):
        if set(rule) != {"count", "mu", "nu"}:
            raise ValueError(f"{path}: AdaBelief wants scale_by_belief's state")
        return {"count": count, "mu": tensors(rule["mu"]), "nu": tensors(rule["nu"])}
    if not isinstance(tx, optim._Adam):
        raise ValueError(f"{path}: no mapping onto {type(tx).__name__}")
    amsgrad = bool(tx.adam.defaults["amsgrad"])
    if amsgrad != ("nu_max" in rule) or "mu" not in rule:
        raise ValueError(f"{path}: the state (keys {sorted(rule)}) is not the "
                         f"{'AMSGrad' if amsgrad else 'Adam'} rule of the port's optimizer")
    keys = (("exp_avg", "mu"), ("exp_avg_sq", "nu")) + \
        ((("max_exp_avg_sq", "nu_max"),) if amsgrad else ())
    per = {k: tensors(rule[j]) for k, j in keys}
    adam = {"state": {i: {"step": torch.tensor(float(count)),
                          **{k: per[k][i] for k, _ in keys}}
                      for i in range(len(tx.params))},
            "param_groups": tx.adam.state_dict()["param_groups"]}
    return {"count": count, "adam": adam}
