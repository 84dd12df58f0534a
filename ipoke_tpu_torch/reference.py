"""The paper's PyTorch checkpoints in the port (the counterpart of the JAX
package's ``tools/convert_torch_checkpoint.py``, ``tools/port_reference_encoders.py``
and ``tools/port_reference_flow.py``).

A reference state dict (a Lightning ``.ckpt``, a plain ``torch.save``d
state dict, or the ``.npz`` that ``dump`` writes) goes in two steps, as in
the JAX package:

1. ``read_state`` / ``dump``: the tensors as numpy, the Lightning prefixes
   ``model.`` and ``module.`` stripped.
2. ``port_*``: the tools' key surgery, copied here as numpy code, gives the
   JAX package's flax trees; ``convert.load_flax`` and
   ``convert.flow_params`` put them into the port's modules
   (``load_first_stage``, ``load_conv_encoder``, ``load_flow``).  Torch
   spectral-norm convs (``weight_orig``, ``weight_u``, ``weight_v``)
   collapse to their eval weight W / (u W v); the cINN's per-level steps
   stack on a leading axis.

The reference's first stage decodes with its own transposed-conv crop, its
"elu" -> ReLU and an ``align_corners`` SPADE resize: the first stage that
takes these weights is built with ``architecture.torch_compat: true`` (no
spectral norm in its decoder), as the JAX package builds it.

``python -m ipoke_tpu_torch.reference port ...`` writes a second-stage run
of the port from the four reference state dicts: ``forward_sample``,
``python -m ipoke_tpu_torch.main --test`` and the UI load it (``main``).
``draw_*`` make reference-layout state dicts with random values from a
seed, for the tests and ``chip_smoke.py``: the official weights are not in
the repository.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import convert
from .flows.base import ParamTree, tree_map

STRIP = ("model.", "module.")


# ---------------------------------------------------------------------------
# Step 1: the state dict as numpy
# ---------------------------------------------------------------------------

def read_state(path: str, strip_prefixes=STRIP) -> Dict[str, np.ndarray]:
    """The tensors of a reference checkpoint as numpy (the ``.npz`` that
    ``dump`` writes is read as it is), the Lightning prefixes stripped."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    out = {}
    for k, v in state.items():
        if not hasattr(v, "numpy"):
            continue
        for p in strip_prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v.detach().cpu().numpy()
    return out


def dump(ckpt_path: str, out_path: str) -> Dict[str, np.ndarray]:
    out = read_state(ckpt_path)
    np.savez(out_path, **out)
    print(f"wrote {len(out)} tensors "
          f"({sum(a.size for a in out.values()) / 1e6:.1f}M params) -> {out_path}")
    return out


# ---------------------------------------------------------------------------
# Step 2: the reference's keys -> the JAX package's flax trees
# ---------------------------------------------------------------------------

def _sub(state, prefix):
    if not prefix:
        return state
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _conv_w(w):  # OIHW -> HWIO
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _conv3d_w(w):  # OIKTKHKW -> KTKHKWIO
    return np.transpose(np.asarray(w), (2, 3, 4, 1, 0))


def _convT_w(w):  # torch (in, out, kh, kw) -> flax transpose_kernel (kh, kw, out, in)
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def spectral_eval_weight(state, key, transpose: bool = False):
    """The eval weight of a torch ``spectral_norm`` conv: weight_orig / (u W
    v), W its weight as a matrix over dim 0 (dim 1 for a transposed conv)."""
    w = np.asarray(state[f"{key}.weight_orig"])
    u = np.asarray(state[f"{key}.weight_u"])
    v = np.asarray(state[f"{key}.weight_v"])
    dim = 1 if transpose else 0
    w_mat = np.moveaxis(w, dim, 0).reshape(w.shape[dim], -1)
    return w / float(u @ w_mat @ v)


def _conv_block(state, key, snorm=True, has_norm=True, transpose=False):
    """A reference Conv2dBlock (or its transposed form) -> flax's block
    without spectral norm."""
    w = spectral_eval_weight(state, f"{key}.conv", transpose) if snorm \
        else np.asarray(state[f"{key}.conv.weight"])
    name = "ConvTranspose_0" if transpose else "Conv_0"
    out = {name: {"kernel": _convT_w(w) if transpose else _conv_w(w),
                  "bias": np.asarray(state[f"{key}.conv.bias"])}}
    if has_norm and f"{key}.norm.weight" in state:
        out["GroupNorm_0"] = {"scale": np.asarray(state[f"{key}.norm.weight"]),
                              "bias": np.asarray(state[f"{key}.norm.bias"])}
    return out


def _res_block(state, key, snorm=True, has_res_conv=True):
    out = {"Conv2dBlock_0": _conv_block(state, f"{key}.conv1", snorm),
           "Conv2dBlock_1": _conv_block(state, f"{key}.conv2", snorm)}
    if has_res_conv:  # res_conv is instance-normed: no params
        out["Conv2dBlock_2"] = _conv_block(state, f"{key}.res_conv", snorm,
                                           has_norm=False)
    return out


def _res_block_up(state, key, snorm=True):
    """Upsampling ResBlock: conv1 transposed, conv2, res_conv transposed."""
    return {
        "Conv2dTransposeBlock_0": _conv_block(state, f"{key}.conv1", snorm,
                                              transpose=True),
        "Conv2dBlock_0": _conv_block(state, f"{key}.conv2", snorm),
        "Conv2dTransposeBlock_1": _conv_block(state, f"{key}.res_conv", snorm,
                                              has_norm=False, transpose=True),
    }


def port_conv_encoder(state, n_stages: int, prefix: str = "") -> Dict:
    """A reference deterministic ``ConvEncoder`` -> flax
    ``ConvEncoder(snorm=False)``."""
    state = _sub(state, prefix)
    params = {"Conv2dBlock_0": _conv_block(state, "model.0")}
    for i in range(1, n_stages):
        params[f"ResBlock_{i - 1}"] = _res_block(state, f"model.{i}")
    # the bottleneck has no spectral norm; a res_conv iff nf != nf_max
    params[f"ResBlock_{n_stages - 1}"] = _res_block(
        state, "bottleneck.0", snorm=False,
        has_res_conv="bottleneck.0.res_conv.conv.weight" in state)
    return params


def _basic_block3d(state, key, has_downsample):
    out = {
        "Conv_0": {"kernel": _conv3d_w(state[f"{key}.conv1.weight"])},
        "GroupNorm_0": {"scale": np.asarray(state[f"{key}.bn1.weight"]),
                        "bias": np.asarray(state[f"{key}.bn1.bias"])},
        "Conv_1": {"kernel": _conv3d_w(state[f"{key}.conv2.weight"])},
        "GroupNorm_1": {"scale": np.asarray(state[f"{key}.bn2.weight"]),
                        "bias": np.asarray(state[f"{key}.bn2.bias"])},
    }
    if has_downsample:
        out["Conv_2"] = {"kernel": _conv3d_w(state[f"{key}.downsample.0.weight"])}
        out["GroupNorm_2"] = {
            "scale": np.asarray(state[f"{key}.downsample.1.weight"]),
            "bias": np.asarray(state[f"{key}.downsample.1.bias"])}
    return out


def port_motion_encoder(state, prefix: str = "") -> Dict:
    """A reference ``resnet18_alternative`` -> flax ``ResNetMotionEncoder``."""
    state = _sub(state, prefix)
    params = {"Conv_0": {"kernel": _conv3d_w(state["conv1.weight"])},
              "GroupNorm_0": {"scale": np.asarray(state["bn1.weight"]),
                              "bias": np.asarray(state["bn1.bias"])}}
    blk = 0
    for layer in ("layer1", "layer2", "layer3", "layer4", "layer5"):
        j = 0
        while f"{layer}.{j}.conv1.weight" in state:
            params[f"BasicBlock3d_{blk}"] = _basic_block3d(
                state, f"{layer}.{j}", f"{layer}.{j}.downsample.0.weight" in state)
            blk += 1
            j += 1
    params["Conv_1"] = {"kernel": _conv_w(state["conv_mu.weight"]),
                        "bias": np.asarray(state["conv_mu.bias"])}
    params["Conv_2"] = {"kernel": _conv_w(state["conv_var.weight"]),
                        "bias": np.asarray(state["conv_var.bias"])}
    return params


def _spade(state, key):
    def conv(k):
        return {"kernel": _conv_w(state[f"{key}.{k}.weight"]),
                "bias": np.asarray(state[f"{key}.{k}.bias"])}
    return {"Conv_0": conv("conv"), "Conv_1": conv("conv_gamma"),
            "Conv_2": conv("conv_beta")}


def port_spade_decoder(state, n_blocks: int, in_block_has_res: bool = True,
                       prefix: str = "") -> Dict:
    """A reference ``SpadeCondConvDecoder`` -> flax's with ``snorm=False,
    torch_compat=True``."""
    state = _sub(state, prefix)
    params = {"ResBlock_0": _res_block(state, "in_block",
                                       has_res_conv=in_block_has_res)}
    for i in range(n_blocks):
        params[f"ResBlock_{i + 1}"] = _res_block_up(state, f"blocks.{i}")
        params[f"Spade_{i}"] = _spade(state, f"spade_blocks.{i}")
    params["Conv2dBlock_0"] = _conv_block(state, "out_conv", snorm=False,
                                          has_norm=False)
    return params


def port_conv_gru(state, n_layers: int, prefix: str = "") -> Dict:
    """A reference ``ConvGRU`` -> flax ``ConvGRU``."""
    state = _sub(state, prefix)
    return {f"cell_{i}": {
        gate: {"kernel": _conv_w(state[f"cells.{i}.{gate}.weight"]),
               "bias": np.asarray(state[f"cells.{i}.{gate}.bias"])}
        for gate in ("update_gate", "reset_gate", "out_gate")}
        for i in range(n_layers)}


def port_first_stage(state, n_gru_layers: int, n_dec_blocks: int,
                     prefix: str = "") -> Dict:
    """A reference ``SpadeCondMotionModel`` -> flax ``FirstStageModel(
    torch_compat=True)``: motion encoder, ConvGRU, ``motion_bias`` (where the
    reference has one) and SPADE decoder."""
    state = _sub(state, prefix)
    params = {
        "enc_motion": port_motion_encoder(state, prefix="enc_motion."),
        "rnn": port_conv_gru(state, n_gru_layers, prefix="rnn."),
        "gen": port_spade_decoder(
            state, n_dec_blocks, prefix="gen.",
            in_block_has_res="gen.in_block.res_conv.conv.weight_orig" in state),
    }
    if "motion_bias" in state:
        params["motion_bias"] = np.transpose(np.asarray(state["motion_bias"]),
                                             (0, 2, 3, 1))
    return params


# the cINN: layers.{i}.{j} -> params[i]["steps"] (stacked over j),
# priors.{i} -> params[i]["prior"], shuffle_layers.{i} -> params[i]["perm"]

def _wn(state, key):
    return {"v": _conv_w(state[f"{key}.conv.weight_v"]),
            "g": np.asarray(state[f"{key}.conv.weight_g"]).reshape(-1),
            "b": np.asarray(state[f"{key}.conv.bias"])}


def _actnorm(state, key):
    return {"log_scale": np.asarray(state[f"{key}.log_scale"]).reshape(-1),
            "bias": np.asarray(state[f"{key}.bias"]).reshape(-1)}


def _shuffle(state, key):
    perm = np.asarray(state[f"{key}.forward_shuffle_idx"]).astype(np.int32)
    return {"buf_perm": perm, "buf_inv_perm": np.argsort(perm).astype(np.int32)}


def _masked_conv(state, key):
    return {"w_shift": _conv_w(state[f"{key}.net.shift_conv.weight"]),
            "out": _wn(state, f"{key}.net.conv1x1")}


def _nice(state, key):
    return {"w1": _conv_w(state[f"{key}.net.conv1.weight"]),
            "w2": _conv_w(state[f"{key}.net.conv2.weight"]),
            "out": _wn(state, f"{key}.net.conv3")}


def _macow_unit(state, key) -> List:
    """[MCF A, MCF B, ActNorm, MCF C, MCF D, ActNorm]: the chain order."""
    return [_masked_conv(state, f"{key}.conv1"), _masked_conv(state, f"{key}.conv2"),
            _actnorm(state, f"{key}.actnorm1"), _masked_conv(state, f"{key}.conv3"),
            _masked_conv(state, f"{key}.conv4"), _actnorm(state, f"{key}.actnorm2")]


def _macow_step(state, key) -> List:
    return [
        _actnorm(state, f"{key}.actnorm1"), _shuffle(state, f"{key}.conv1x1"),
        _macow_unit(state, f"{key}.units1.0"), _macow_unit(state, f"{key}.units1.1"),
        _nice(state, f"{key}.coupling1_up"), _nice(state, f"{key}.coupling1_dn"),
        _actnorm(state, f"{key}.actnorm2"),
        _macow_unit(state, f"{key}.units2.0"), _macow_unit(state, f"{key}.units2.1"),
        _nice(state, f"{key}.coupling2_up"), _nice(state, f"{key}.coupling2_dn"),
    ]


def _prior(state, key):
    return {"perm": _shuffle(state, f"{key}.conv1x1"),
            "coupling": _nice(state, f"{key}.coupling"),
            "actnorm": _actnorm(state, f"{key}.actnorm")}


def _stack(trees: List):
    """The trees' leaves stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return np.stack(trees)


def port_multiscale_state(state, num_steps, prefix: str = "") -> List:
    """A reference ``MultiScaleInternal`` -> the flow's param list."""
    state = _sub(state, prefix)
    return [{"steps": _stack([_macow_step(state, f"layers.{i}.{j}")
                              for j in range(n)]),
             "prior": _prior(state, f"priors.{i}"),
             "perm": _shuffle(state, f"shuffle_layers.{i}")}
            for i, n in enumerate(num_steps)]


# ---------------------------------------------------------------------------
# Into the port's modules
# ---------------------------------------------------------------------------

def load_first_stage(model, state, prefix: str = "") -> None:
    """A reference first stage into ``model`` (a ``FirstStageModel`` built
    with ``torch_compat``; one built without it computes the same weights
    with the package's own semantics)."""
    if (model.motion_bias is None) != (prefix + "motion_bias" not in state):
        raise ValueError("motion_bias: the reference state and the model's "
                         "architecture.motion_bias disagree")
    convert.load_flax(model, port_first_stage(state, model.n_gru_layers,
                                              model.gen.n_up, prefix))


def load_conv_encoder(wrapper, state, prefix: str = "") -> None:
    """A reference ``ConvEncoder`` into a ``FirstStageWrapper``'s encoder
    (built without spectral norm, or frozen: ``freeze_spectral_norm``)."""
    convert.load_flax(wrapper.encoder,
                      port_conv_encoder(state, wrapper.encoder.n_res, prefix=prefix))


def load_flow(model, state, prefix: str = "") -> None:
    """A reference cINN into the ``flow_params`` of a ``SecondStageModel``,
    on the device and in the dtype of its current params."""
    if model.wraps_flow:
        raise ValueError("the reference cINN loads without augmented_input "
                         "and conv_adapt")
    ref = next(model.flow_params.parameters())
    tree = port_multiscale_state(state, model.config["architecture"]["num_steps"],
                                 prefix)
    model.flow_params = ParamTree(convert.flow_params(tree, ref.device, ref.dtype))


def load_second_stage(model, first_stage, conditioner, poke_embedder, flow,
                      flow_prefix: str = "") -> None:
    """The four reference state dicts into a ``SecondStageModel``."""
    load_first_stage(model.first_stage, first_stage)
    load_conv_encoder(model.conditioner, conditioner)
    load_conv_encoder(model.poke_embedder, poke_embedder)
    load_flow(model, flow, flow_prefix)


# ---------------------------------------------------------------------------
# Reference-layout states drawn from a seed
# ---------------------------------------------------------------------------

def _normal(rng, shape, std):
    return (std * rng.standard_normal(shape)).astype(np.float32)


def _draw_conv(rng, out, key, shape, snorm, transpose=False, bias=True, norm=None):
    """A reference conv at ``key`` (``.conv`` of a Conv2dBlock): its weight
    (spectral-normed: ``weight_orig`` with a ``weight_v`` and the ``weight_u``
    of one power step from it, so u W v > 0), bias and group norm."""
    fan_in = shape[0 if transpose else 1] * shape[2] * shape[3]
    w = _normal(rng, shape, fan_in ** -0.5)
    if snorm:
        dim = 1 if transpose else 0
        w_mat = np.moveaxis(w, dim, 0).reshape(shape[dim], -1)
        v = rng.standard_normal(w_mat.shape[1]).astype(np.float32)
        v /= np.linalg.norm(v)
        u = w_mat @ v
        out.update({f"{key}.weight_orig": w, f"{key}.weight_v": v,
                    f"{key}.weight_u": (u / np.linalg.norm(u)).astype(np.float32)})
    else:
        out[f"{key}.weight"] = w
    if bias:
        out[f"{key}.bias"] = _normal(rng, shape[1 if transpose else 0], 0.1)
    if norm:
        out[f"{key[:-len('.conv')]}.norm.weight"] = 1 + _normal(rng, norm, 0.1)
        out[f"{key[:-len('.conv')]}.norm.bias"] = _normal(rng, norm, 0.1)


def _draw_block(rng, out, key, block, snorm):
    """A port Conv2dBlock / Conv2dTransposeBlock's reference keys."""
    transpose = hasattr(block, "ConvTranspose_0")
    conv = block.ConvTranspose_0 if transpose else block.Conv_0
    norm = block.GroupNorm_0
    _draw_conv(rng, out, f"{key}.conv", tuple(conv.weight.shape), snorm, transpose,
               bias=conv.bias is not None,
               norm=norm.scale.shape[0] if norm is not None and norm.scale is not None
               else None)


def _draw_res(rng, out, key, blk, snorm):
    if blk.upsampling:
        names = ("Conv2dTransposeBlock_0", "Conv2dBlock_0", "Conv2dTransposeBlock_1")
    else:
        names = ("Conv2dBlock_0", "Conv2dBlock_1", "Conv2dBlock_2")
    for ref, name in zip(("conv1", "conv2", "res_conv"), names):
        if hasattr(blk, name):
            _draw_block(rng, out, f"{key}.{ref}", getattr(blk, name), snorm)


def draw_conv_encoder(encoder, rng) -> Dict[str, np.ndarray]:
    """A reference ``ConvEncoder`` state of the port ``encoder``'s shape."""
    out: Dict[str, np.ndarray] = {}
    _draw_block(rng, out, "model.0", encoder.Conv2dBlock_0, True)
    for i in range(encoder.n_res - 1):
        _draw_res(rng, out, f"model.{i + 1}", getattr(encoder, f"ResBlock_{i}"), True)
    _draw_res(rng, out, "bottleneck.0",
              getattr(encoder, f"ResBlock_{encoder.n_res - 1}"), False)
    return out


def _draw_gn(rng, out, key, gn):
    out[f"{key}.weight"] = 1 + _normal(rng, gn.scale.shape[0], 0.1)
    out[f"{key}.bias"] = _normal(rng, gn.scale.shape[0], 0.1)


def draw_first_stage(model, rng) -> Dict[str, np.ndarray]:
    """A reference first-stage state (motion encoder, ConvGRU, motion bias,
    SPADE decoder) of the port ``model``'s shape."""
    out: Dict[str, np.ndarray] = {}
    enc = model.enc_motion

    def conv3d(key, conv):
        w = conv.weight
        out[key] = _normal(rng, tuple(w.shape), w[0].numel() ** -0.5)

    conv3d("enc_motion.conv1.weight", enc.Conv_0)
    _draw_gn(rng, out, "enc_motion.bn1", enc.GroupNorm_0)
    for i in range(enc.n_blocks):
        blk, key = getattr(enc, f"BasicBlock3d_{i}"), f"enc_motion.layer{i // 2 + 1}.{i % 2}"
        conv3d(f"{key}.conv1.weight", blk.Conv_0)
        _draw_gn(rng, out, f"{key}.bn1", blk.GroupNorm_0)
        conv3d(f"{key}.conv2.weight", blk.Conv_1)
        _draw_gn(rng, out, f"{key}.bn2", blk.GroupNorm_1)
        if blk.has_res:
            conv3d(f"{key}.downsample.0.weight", blk.Conv_2)
            _draw_gn(rng, out, f"{key}.downsample.1", blk.GroupNorm_2)
    for ref, conv in (("conv_mu", enc.Conv_1), ("conv_var", enc.Conv_2)):
        _draw_conv(rng, out, f"enc_motion.{ref}", tuple(conv.weight.shape), False)
    for i in range(model.n_gru_layers):
        cell = getattr(model.rnn, f"cell_{i}")
        for gate in ("update_gate", "reset_gate", "out_gate"):
            _draw_conv(rng, out, f"rnn.cells.{i}.{gate}",
                       tuple(getattr(cell, gate).weight.shape), False)
    if model.motion_bias is not None:
        s, z = model.min_spatial_size, model.z_dim
        out["motion_bias"] = _normal(rng, (1, z, s, s), 1.0)
    gen = model.gen
    _draw_res(rng, out, "gen.in_block", gen.ResBlock_0, True)
    for i in range(gen.n_up):
        _draw_res(rng, out, f"gen.blocks.{i}", getattr(gen, f"ResBlock_{i + 1}"), True)
        spade = getattr(gen, f"Spade_{i}")
        for ref, name in (("conv", "Conv_0"), ("conv_gamma", "Conv_1"),
                          ("conv_beta", "Conv_2")):
            _draw_conv(rng, out, f"gen.spade_blocks.{i}.{ref}",
                       tuple(getattr(spade, name).weight.shape), False)
    _draw_conv(rng, out, "gen.out_conv.conv",
               tuple(gen.Conv2dBlock_0.Conv_0.weight.shape), False)
    return out


def _ref_layer(out, key, node):
    """The reference keys of one flow-tree node (the inverse of the maps
    above)."""
    def oihw(w):
        return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))

    def wn(k, n):
        out[f"{k}.conv.weight_v"] = oihw(n["v"])
        out[f"{k}.conv.weight_g"] = n["g"].reshape(-1, 1, 1, 1)
        out[f"{k}.conv.bias"] = n["b"]

    if "log_scale" in node:
        out[f"{key}.log_scale"] = node["log_scale"].reshape(-1, 1, 1)
        out[f"{key}.bias"] = node["bias"].reshape(-1, 1, 1)
    elif "buf_perm" in node:
        out[f"{key}.forward_shuffle_idx"] = node["buf_perm"].astype(np.int64)
    elif "w_shift" in node:
        out[f"{key}.net.shift_conv.weight"] = oihw(node["w_shift"])
        wn(f"{key}.net.conv1x1", node["out"])
    else:  # NICE
        out[f"{key}.net.conv1.weight"] = oihw(node["w1"])
        out[f"{key}.net.conv2.weight"] = oihw(node["w2"])
        wn(f"{key}.net.conv3", node["out"])


_STEP = ("actnorm1", "conv1x1", "units1.0", "units1.1", "coupling1_up",
         "coupling1_dn", "actnorm2", "units2.0", "units2.1", "coupling2_up",
         "coupling2_dn")
_UNIT = ("conv1", "conv2", "actnorm1", "conv3", "conv4", "actnorm2")


def reference_flow_state(tree) -> Dict[str, np.ndarray]:
    """The reference ``MultiScaleInternal`` state of a flow tree (numpy,
    the JAX package's layout): the inverse of ``port_multiscale_state``."""
    out: Dict[str, np.ndarray] = {}
    for i, level in enumerate(tree):
        n = level["steps"][0]["log_scale"].shape[0]
        for j in range(n):
            for name, node in zip(_STEP, level["steps"]):
                key = f"layers.{i}.{j}.{name}"
                pick = tree_map(lambda a: a[j], node)
                if isinstance(pick, list):
                    for uname, unode in zip(_UNIT, pick):
                        _ref_layer(out, f"{key}.{uname}", unode)
                else:
                    _ref_layer(out, key, pick)
        _ref_layer(out, f"priors.{i}.conv1x1", level["prior"]["perm"])
        _ref_layer(out, f"priors.{i}.coupling", level["prior"]["coupling"])
        _ref_layer(out, f"priors.{i}.actnorm", level["prior"]["actnorm"])
        _ref_layer(out, f"shuffle_layers.{i}", level["perm"])
    return out


def draw_flow(model, generator: torch.Generator, g_std: float = 0.01) -> Dict[str, np.ndarray]:
    """A reference cINN state of ``model``'s flow: the package's init drawn
    from ``generator`` with every coupling and ActNorm perturbed
    (``entry.perturb``), in the reference's keys."""
    from .entry import perturb

    params = ParamTree(model.flow.init(generator, "cpu"))
    perturb(params, generator, g_std, g_std)
    tree = tree_map(lambda t: t.numpy(), params.tree())
    return reference_flow_state(tree)


def draw_second_stage(model, seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Reference states ``{"first_stage", "conditioner", "poke_embedder",
    "flow"}`` of ``model``'s shapes (a ``SecondStageModel``, on ``meta`` or
    any device), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return {"first_stage": draw_first_stage(model.first_stage, rng),
            "conditioner": draw_conv_encoder(model.conditioner.encoder, rng),
            "poke_embedder": draw_conv_encoder(model.poke_embedder.encoder, rng),
            "flow": draw_flow(model, torch.Generator().manual_seed(seed))}


def save_ckpt(state: Dict[str, np.ndarray], path: str, prefix: str = "model.") -> None:
    """``state`` as a Lightning-style ``.ckpt`` (``{"state_dict": ...}``,
    keys under ``prefix``)."""
    torch.save({"state_dict": {prefix + k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in state.items()}}, path)


# ---------------------------------------------------------------------------
# A port run of reference weights
# ---------------------------------------------------------------------------

def write_run(config, base_dir: str, model_name: str, states, flow_prefix: str = "",
              generator: Optional[torch.Generator] = None) -> str:
    """A second-stage run of the port under ``base_dir`` from the four
    reference states (``read_state``), for ``main --test``, the UI and
    ``forward_sample``: the frozen first stage (``torch_compat``),
    conditioner and poke embedder as runs of their own holding frozen
    weights (the image AEs' decoders, which the reference checkpoints lack
    and sampling does not run, drawn from ``generator``), the cINN as the
    second stage's ``last`` without optimizer state (a ``--resume`` starts a
    fresh one).  Returns the run's config path, the one to pass as
    ``--config``."""
    from .cli.experiments import load_frozen
    from .core.checkpoint import CheckpointStore, create_dir_structure
    from .core.config import Config, load_config
    from .models.second_stage import SecondStageModel

    generator = generator or torch.Generator().manual_seed(0)
    config = Config(copy.deepcopy(config.to_dict() if hasattr(config, "to_dict")
                                  else config))
    for section in ("first_stage", "conditioner", "poke_embedder"):
        sec = dict(config[section])
        sub = load_config(sec["config"]).to_dict() if isinstance(
            sec.get("config"), str) else copy.deepcopy(sec.get("config", {}))
        if section == "first_stage":
            sub["architecture"]["torch_compat"] = True
        sec.pop("ckpt", None)
        sec.pop("model_name", None)
        config[section] = dict(sec, config=sub)
    model = SecondStageModel(config, *load_frozen(config, generator))
    model.flow_params = ParamTree(model.init_params(generator, "cpu"))
    load_second_stage(model, states["first_stage"], states["conditioner"],
                      states["poke_embedder"], states["flow"], flow_prefix)
    for section, net in (("first_stage", model.first_stage),
                         ("conditioner", model.conditioner),
                         ("poke_embedder", model.poke_embedder)):
        dirs = create_dir_structure(base_dir, section, f"{model_name}_{section}")
        weights = net.state_dict()
        CheckpointStore(os.path.join(dirs["ckpt"], "0")).save(weights, 0, weights=weights)
        config[section]["ckpt"] = os.path.join(dirs["ckpt"], "0")
    experiment = config.get_path("general.experiment") or "second_stage"
    dirs = create_dir_structure(base_dir, experiment, model_name)
    flow = model.flow_params.state_dict()
    CheckpointStore(os.path.join(dirs["ckpt"], "0")).save(
        {"flow": flow, "tx": None, "step": 0}, 0, weights=flow)
    path = os.path.join(dirs["config"], "0.yaml")
    config.save(path)
    return path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump", help="a reference checkpoint's tensors as .npz")
    d.add_argument("--ckpt", required=True)
    d.add_argument("--out", required=True)
    r = sub.add_parser("port", help="a port second-stage run of reference weights")
    r.add_argument("--config", required=True, help="the second stage's YAML")
    r.add_argument("--model_name", required=True)
    for section in ("first_stage", "conditioner", "poke_embedder", "flow"):
        r.add_argument(f"--{section}", required=True,
                       help="its reference checkpoint (.ckpt, .pt or dump's .npz)")
    r.add_argument("--flow_prefix", default="",
                   help="the cINN's key prefix in --flow (e.g. flow.flow.)")
    r.add_argument("--base_dir", default=None,
                   help="the runs' base directory (default $DATAPATH_BASE, "
                        "else general.base_dir)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from .core.config import load_config

    args = parse_args(argv)
    if args.cmd == "dump":
        dump(args.ckpt, args.out)
        return 0
    config = load_config(args.config)
    base = args.base_dir or os.environ.get("DATAPATH_BASE") \
        or config.get_path("general.base_dir")
    states = {s: read_state(getattr(args, s))
              for s in ("first_stage", "conditioner", "poke_embedder", "flow")}
    path = write_run(config, base, args.model_name, states, args.flow_prefix)
    print(f"wrote the run {args.model_name} under {base}; its config: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
