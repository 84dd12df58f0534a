"""JAX-trained runs of every experiment in the port
(``tools/jax_run_to_torch.py``), optimizer state included.

* Trees: for each of the nine experiments beyond the conv pipeline's four
  (``tests/test_torch_jax_run.py``), the JAX experiment's own initial state
  (its ``build`` under ``jax.eval_shape``, no compile: nets, optimizer,
  ``MultiSteps`` where ``training.min_acc_batch_size`` asks for it) filled
  from a numpy seed is saved by the JAX package's store, converted, and
  restored by the port's experiment: every param, buffer and optimizer
  tensor equal to its JAX value, the update count carried (never fresh).
* Optimizer rules: for each optimizer family of the JAX package (AMSGrad,
  ``gan_adam``'s and ``optax.adam``'s Adam, Adafactor, AdaBelief, the fp32
  masters of ``master_weights`` and ``MultiSteps``' accumulator), two optax
  updates on a small tree, then the state converted into the port's
  optimizer, then one more update in both: params within 1e-6.
"""

import copy
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ipoke_tpu.cli import experiments as jex
from ipoke_tpu.core import optim as joptim
from ipoke_tpu.core.checkpoint import CheckpointStore as JStore
from ipoke_tpu.core.config import Config as JConfig
from ipoke_tpu_torch.convert import load_flax, load_image_ae, optax_state_dict
from ipoke_tpu_torch.core import optim as toptim
from ipoke_tpu_torch.core.checkpoint import CheckpointStore
from tools.jax_run_to_torch import FLOWS, _flat, _flow_tree, convert_runs, port_experiment

from test_torch_cli import CONFIGS, DATA, FM, SS
from test_torch_cli_fc import FC
from test_torch_ops import _few_threads  # noqa: F401 (_few_threads)

def _inline(exp, body):
    """A frozen section naming its run's config inline (no ckpt: drawn)."""
    return {"config": dict(copy.deepcopy(body), data=dict(DATA),
                           general={"experiment": exp})}


def _fs_sections(fc):
    if fc:
        return {"first_stage": _inline("first_stage_fc", FC["first_stage_fc"]),
                "conditioner": dict(_inline("img_encoder_fc", FC["img_encoder_fc"]),
                                    nf_max=16),
                "poke_embedder": dict(_inline("poke_encoder_fc", FC["poke_encoder_FC"]),
                                      nf_max=16)}
    return {"first_stage": _inline("first_stage", CONFIGS["first_stage"]),
            "conditioner": dict(_inline("img_encoder", CONFIGS["img_encoder"]), use=True),
            "poke_embedder": _inline("poke_encoder", CONFIGS["poke_encoder"])}


def _config(kind):
    """The toy config of ``kind`` (the CLI tests' widths), its frozen runs
    inline; ``flow_vae`` accumulates 2 microbatches (``MultiSteps``: optax's
    cannot carry the flows' int buffers)."""
    body = {"img_encoder_fc": FC["img_encoder_fc"], "poke_encoder_fc": FC["poke_encoder_FC"],
            "first_stage_fc": FC["first_stage_fc"], "flow_encoder_fc": FC["flow_encoder_fc"],
            "inn_fcae": FC["inn_fcae"], "second_stage_fc": FC["second_stage_fc"],
            "third_stage_fc": FC["third_stage_fc"], "flow_vae": CONFIGS["flow_vae"],
            "flow_motion": FM}[kind]
    cfg = dict(copy.deepcopy(body), data=dict(DATA), general={"experiment": kind, "seed": 1})
    fe = _inline("flow_encoder_fc", FC["flow_encoder_fc"])
    if kind == "inn_fcae":
        cfg["flow_encoder"] = fe
    if kind == "flow_vae":
        cfg["training"]["min_acc_batch_size"] = 2 * DATA["batch_size"]
    if kind in ("second_stage_fc", "third_stage_fc"):
        cfg.update(_fs_sections(True))
    if kind == "third_stage_fc":
        cfg["second_stage"] = _inline("second_stage_fc", FC["second_stage_fc"])
        cfg["second_stage"]["config"].update(_fs_sections(True))
        cfg["flow_encoder"] = fe
    if kind == "flow_motion":
        cfg.update(_fs_sections(False))
        ss = dict(copy.deepcopy(SS), data=dict(DATA),
                  general={"experiment": "second_stage"})
        ss["training"].update(mixed_prec_master=False)
        cfg["second_stage"] = {"config": ss}
        cfg["flow_vae"] = {}
    return cfg


def _jax_experiment(kind, cfg):
    """The JAX experiment of ``kind`` without its run dir and data, and its
    initial (state, sidecar stats) as shapes."""
    cls = jex._registry()[kind]
    e = cls.__new__(cls)
    jcfg = JConfig(copy.deepcopy(cfg))
    if kind == "poke_encoder_fc":  # what its __init__ sets
        jcfg["input_key"], jcfg["target_key"] = "poke", "flow"
    e.config, e.rng, e.logger, e.debug = jcfg, jax.random.PRNGKey(1), \
        logging.getLogger("jax_runs"), False
    e.batch_size, e.n_epochs, e.max_batches, e.max_val_batches = \
        DATA["batch_size"], 1, 2, 1

    def init():
        e.build()
        return e.state, getattr(e, "stats", None)
    return e, jax.eval_shape(init)


def _fill(shapes, rng):
    """numpy values for a tree of shapes: floats N(0, 0.1^2) (abs: second
    moments and the like stay valid), counts 3, int buffers 0."""
    def leaf(s):
        if jnp.issubdtype(s.dtype, jnp.floating):
            return np.abs(0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
        return np.full(s.shape, 3 if s.shape == () else 0, s.dtype)
    return jax.tree_util.tree_map(leaf, shapes)


KINDS = ("img_encoder_fc", "poke_encoder_fc", "first_stage_fc", "flow_encoder_fc",
         "inn_fcae", "second_stage_fc", "third_stage_fc", "flow_vae", "flow_motion")


def _optimizers(kind, e):
    """(port optimizer, JAX state key, the port's module holding its
    params) of each optimizer the port's experiment ``e`` saves."""
    if kind in FLOWS:
        return [(e.tx, "opt", FLOWS[kind][0](e))]
    if kind == "first_stage_fc":
        return [(tx, f"opt_{k}", net) for tx, k, net in
                zip(e.trainer.tx, ("g", "ds", "dt"), (e.model, e.disc_s, e.disc_t))]
    out = [(e.tx, "opt", e.model)]
    if getattr(e, "tx_d", None) is not None:
        out.append((e.tx_d, "opt_d", e.disc))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_converted_run_restores_every_leaf(kind, tmp_path, monkeypatch):
    """The JAX experiment's initial state, filled, through orbax, the tool
    and the port's restore (``load_checkpoint_state`` after
    ``_resume_template``, as ``--resume`` does): params, spectral-norm
    stats and optimizer tensors equal to the JAX values, the count 3
    everywhere, the ``last_weights`` sidecar the model's."""
    cfg = _config(kind)
    je, (shapes, stat_shapes) = _jax_experiment(kind, cfg)
    rng = np.random.default_rng(KINDS.index(kind))
    state = jax.tree_util.tree_map(jnp.asarray, _fill(shapes, rng))
    if stat_shapes is not None:
        je.stats = jax.tree_util.tree_map(jnp.asarray, _fill(stat_shapes, rng))
    src, dst = str(tmp_path / "jax"), str(tmp_path / "port")
    store = JStore(os.path.join(src, kind, "ckpt", "toy", "0"))
    store.save(state, 3, weights=je.export_weights(state))
    os.makedirs(os.path.join(src, kind, "config", "toy"))
    with open(os.path.join(src, kind, "config", "toy", "0.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    # the port's experiment, built once: the tool converts through a copy,
    # and the untouched one restores
    e = port_experiment(kind, cfg)
    monkeypatch.setattr("tools.jax_run_to_torch.port_experiment",
                        lambda *a: copy.deepcopy(e))
    assert convert_runs(src, dst, log=lambda line: None) == 1

    got = CheckpointStore(os.path.join(dst, kind, "ckpt", "toy", "0")).restore("last")
    assert got["step"] == 3
    e._resume_template()
    e.load_checkpoint_state(got)
    tree = jax.tree_util.tree_map(np.asarray, state)
    # params and buffers, by an independent map: flows by path, nets by load
    if kind in FLOWS:
        flat = _flat(_flow_tree(kind, tree.params))
        for name, t in FLOWS[kind][0](e).state_dict().items():
            torch.testing.assert_close(t, torch.as_tensor(np.array(flat[name])).to(t.dtype),
                                       rtol=0, atol=0, msg=name)
    for tx, key, root in _optimizers(kind, e):
        opt = getattr(tree, key)
        assert tx.count == 3, key
        if kind in FLOWS:
            names = {id(p): n for n, p in root.named_parameters()}
            flat = {k: _flat(_flow_tree(kind, v)) for k, v in (
                ("mu", _rule(opt)["mu"]), ("nu", _rule(opt)["nu"]))}
            for p in tx.params:
                s = _adam_state(tx, p)
                for k, j in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                    torch.testing.assert_close(
                        s[k], torch.as_tensor(np.array(flat[j][names[id(p)]])).to(s[k].dtype),
                        rtol=0, atol=0)
            continue
        params = getattr(tree, {"opt": "params", "opt_d": "params_d"}.get(
            key, key.replace("opt", "params")))
        stats = _stats(tree, key, je)
        want = _loaded(root, params, stats, kind, key)
        names = {id(p): n for n, p in root.named_parameters()}
        for p in tx.params:
            torch.testing.assert_close(p.detach(), want[names[id(p)]], rtol=0, atol=0)
        mus = _loaded(root, _rule(opt)["mu"], stats, kind, key)
        for p in tx.params:
            torch.testing.assert_close(_adam_state(tx, p)["exp_avg"], mus[names[id(p)]],
                                       rtol=0, atol=0)
    sidecar = CheckpointStore(os.path.join(dst, kind, "ckpt", "toy", "0")) \
        .restore("last_weights")
    own = e.export_weights()
    assert sidecar.keys() == own.keys()
    for k, v in own.items():
        torch.testing.assert_close(sidecar[k], v, rtol=0, atol=0, msg=k)


def _rule(opt):
    """The Adam-family rule state of an optax state tree."""
    if isinstance(opt, optax.MultiStepsState):
        opt = opt.inner_opt_state
    if hasattr(opt, "inner_states"):
        opt = opt.inner_states["train"].inner_state
    for s in opt if isinstance(opt, tuple) else (opt,):
        if hasattr(s, "mu"):
            return {"mu": s.mu, "nu": s.nu}
    raise AssertionError(opt)


def _adam_state(tx, p):
    inner = tx
    while not isinstance(inner, toptim._Adam):
        inner = inner.inner
    i = next(i for i, q in enumerate(tx.params) if q is p)
    return inner.adam.state[inner.params[i]]


def _stats(tree, key, je):
    if key in ("opt_g", "opt_ds", "opt_dt"):
        return getattr(tree, key.replace("opt", "stats"))
    if key == "opt_d":
        return tree.stats_d
    if hasattr(tree, "stats"):
        return tree.stats
    return jax.tree_util.tree_map(np.asarray, getattr(je, "stats", None) or {})


def _loaded(root, params, stats, kind, key):
    """{name: tensor} of ``root`` holding a params-shaped tree."""
    ref = copy.deepcopy(root)
    if key == "opt" and kind in ("img_encoder_fc", "poke_encoder_fc"):
        load_image_ae(ref, params, stats)
    else:
        load_flax(ref, params, stats)
    return {n: t.detach() for n, t in ref.named_parameters()}


# ---------------------------------------------------------------------------
# optimizer rules
# ---------------------------------------------------------------------------

def _tree(rng):
    """A small params tree: a factored (128 x 160) matrix, a (3, 5) one and
    a vector, and an int buffer the flow optimizers mask out."""
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"a": n(128, 160), "b": n(3, 5), "c": n(7), "buf_perm": np.arange(4, dtype=np.int32)}


RULES = {  # (the JAX optimizer over params, the port's over a list)
    "amsgrad": (lambda p: joptim.flow_adam(1e-2, params=p),
                lambda ps: toptim.flow_adam(ps, 1e-2)),
    "gan_adam": (lambda p: joptim.gan_adam(joptim.exp_decay_per_epoch(1e-2, 0.5, 2), 1e-5),
                 lambda ps: toptim.gan_adam(ps, toptim.exp_decay_per_epoch(1e-2, 0.5, 2),
                                            1e-5)),
    "adam": (lambda p: optax.adam(1e-2), lambda ps: toptim.adam(ps, 1e-2)),
    "adafactor": (lambda p: joptim.flow_adam(joptim.warmup_linear_decay(1e-2, 2, 10),
                                             params=p, use_adafactor=True),
                  lambda ps: toptim.flow_adam(ps, toptim.warmup_linear_decay(1e-2, 2, 10),
                                              use_adafactor=True)),
    "adabelief": (lambda p: joptim.flow_adam(1e-2, params=p, use_adabelief=True),
                  lambda ps: toptim.flow_adam(ps, 1e-2, use_adabelief=True)),
    "master_weights": (lambda p: joptim.master_weights(joptim.flow_adam(1e-2, params=p)),
                       lambda ps: toptim.master_weights(ps, lambda m: toptim.flow_adam(m, 1e-2))),
    "multisteps": (lambda p: optax.MultiSteps(joptim.flow_adam(1e-2, params=p),
                                              every_k_schedule=2),
                   lambda ps: toptim._MultiSteps(toptim.flow_adam(ps, 1e-2), 2)),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_optimizer_state_carries_over(rule):
    """Two optax updates (the flow optimizers masking the ``buf_*`` leaf as
    the JAX experiments do), the state converted, in orbax's tree form,
    into the port's optimizer over the updated params, then one more update
    from the same gradient in both: params within 1e-6 (under
    ``master_weights`` its fp32 masters, the bf16 params being their
    rounding); ``MultiSteps`` is stopped between its microbatches."""
    rng = np.random.default_rng(sorted(RULES).index(rule))
    tree = _tree(rng)
    # optax.MultiSteps cannot carry an int leaf (its cond's branches differ
    # in dtype), so neither do the JAX runs that accumulate
    flows = rule not in ("gan_adam", "adam", "multisteps")
    params = {k: jnp.asarray(v) for k, v in tree.items() if flows or k != "buf_perm"}
    if rule == "master_weights":
        params = {k: v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v
                  for k, v in params.items()}
    make_j, make_t = RULES[rule]
    tx = make_j(params)
    opt = tx.init(params)
    keys = [k for k in params if not k.startswith("buf_")]
    grads = [{k: jnp.asarray(rng.standard_normal(params[k].shape).astype(np.float32))
              .astype(params[k].dtype) if k in keys else jnp.zeros_like(params[k])
              for k in params} for _ in range(4)]
    n_before = 3 if rule == "multisteps" else 2
    for g in grads[:n_before]:
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    port = [torch.as_tensor(np.array(params[k].astype(jnp.float32))).to(
        torch.bfloat16 if rule == "master_weights" else torch.float32).clone()
        for k in keys]
    ttx = make_t(port)
    moments = lambda t: [torch.as_tensor(np.asarray(t[k], np.float32)) for k in keys]
    ttx.load_state_dict(optax_state_dict(_orbax_form(opt), ttx, moments))
    assert ttx.count == (1 if rule == "multisteps" else 2)
    g = grads[-1]
    upd, opt = tx.update(g, opt, params)
    params = optax.apply_updates(params, upd)
    for p, k in zip(port, keys):
        p.grad = torch.as_tensor(np.asarray(g[k].astype(jnp.float32))).to(p.dtype)
    ttx.step()
    got, want = (ttx.master, opt.master) if rule == "master_weights" else (port, params)
    for p, k in zip(got, keys):
        np.testing.assert_allclose(p.float().numpy(), np.asarray(want[k], np.float32),
                                   rtol=0, atol=1e-6, err_msg=k)


def _orbax_form(node):
    if node is None or isinstance(node, (optax.EmptyState, optax.MaskedNode)) or (
            isinstance(node, tuple) and hasattr(node, "_fields") and not node._fields):
        return None
    if hasattr(node, "_fields"):
        return {f: _orbax_form(getattr(node, f)) for f in node._fields}
    if isinstance(node, dict):
        return {k: _orbax_form(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_orbax_form(v) for v in node]
    return np.asarray(node)


def test_unmappable_state_names_its_leaf():
    """A state the port has no rule for raises and names where."""
    ttx = toptim.flow_adam([torch.zeros(3)], 1e-2)
    bad = {"inner_states": {"train": {"inner_state": [None, {"count": np.int32(1),
                                                             "z": np.zeros(3)}]}}}
    with pytest.raises(ValueError, match=r"opt/inner_states/train/inner_state/1"):
        optax_state_dict(bad, ttx, lambda t: [torch.zeros(3)])
    adam = {"count": np.int32(1), "mu": {"a": np.zeros(3)}, "nu": {"a": np.zeros(3)}}
    with pytest.raises(ValueError, match="AMSGrad"):  # no nu_max: not the port's rule
        optax_state_dict([None, adam, None], ttx, lambda t: [torch.zeros(3)])
