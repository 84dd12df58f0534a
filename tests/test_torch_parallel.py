"""The port's dp x hidden-channel mesh (``ipoke_tpu_torch/parallel``)
against one process and against the JAX package's sharded step.

Four CPU ranks over gloo (``parallel.dryrun.launch``) run, in one process
group (the legs in ``torch_mesh_legs.py``, which imports no JAX): the flow-only NLL step of ``tests/test_parallel.py`` on a dp 2 x tp
2 mesh and a hybrid 2 x 1 x 2 mesh and in one process, the converters'
round trip of the sharded tree, the toy second-stage train step and
``forward_sample`` of the dryrun, and one NICE coupling split two ways and
four ways, whole against split (K1 and K4's plain stages on the CPU, in
bf16; the plain split in fp32).  The JAX package's sharded step on its
8-device CPU mesh is the file's one jitted program.
"""

import threading

import jax
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.core.optim import flow_adam, zero_buffer_grads
from ipoke_tpu.flows import build_macow_transformer, flow_loss
from ipoke_tpu.parallel import make_mesh as jax_make_mesh
from ipoke_tpu.parallel import shard_batch as jax_shard_batch
from ipoke_tpu.parallel import shard_params as jax_shard_params
from ipoke_tpu_torch.convert import to_numpy_tree
from ipoke_tpu_torch.flows import build_macow_transformer as tbuild
from ipoke_tpu_torch.flows.base import tree_leaves
from ipoke_tpu_torch.ops.nice_net import im2col3x3, nice_net_train_plain
from ipoke_tpu_torch.parallel import dryrun, flow_param_specs, shard_params
from ipoke_tpu_torch.parallel.mesh import Mesh

import torch_mesh_legs as legs
from test_torch_ops import _few_threads  # noqa: F401 (a module fixture)

TOL = 2e-4
# tests/test_parallel.py's flow
ARCH = {"flow_in_channels": 8, "flow_mid_channels_factor": 4,
        "h_channels": 16, "factor": 4, "num_steps": [1, 1]}


def _perturbed_tree(seed=0):
    """The flow's tree (the port's init: JAX's eager init is slow to trace;
    the trees map 1:1) with every weight-norm out conv's g and b drawn
    (init leaves them at 0, which makes every coupling an identity whose
    hidden weights get no gradient), as numpy."""
    params = to_numpy_tree(tbuild(ARCH).init(torch.Generator().manual_seed(2), "cpu"))
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if {"v", "g", "b"} <= node.keys():
                node["g"] = (0.1 * rng.standard_normal(node["g"].shape)).astype(np.float32)
                node["b"] = (0.01 * rng.standard_normal(node["b"].shape)).astype(np.float32)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(params)
    return params


def _jax_sharded_step(params, x, h):
    """(loss, updated params) of JAX's step on the 8-device mesh (dp 4 x
    tp 2), as in ``tests/test_parallel.py``."""
    flow = build_macow_transformer(ARCH)
    mesh = jax_make_mesh(8, model_parallel=2)
    tx = flow_adam(1e-3, params=params)

    @jax.jit
    def step(params, opt, x, h):
        def loss_fn(p):
            z, ld = flow.forward(p, x, h)
            return flow_loss(z, ld)[0]

        loss, grads = jax.value_and_grad(loss_fn, allow_int=True)(params)
        grads = zero_buffer_grads(grads, params)
        upd, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd), loss

    xs = jax_shard_batch({"x": x, "h": h}, mesh)
    new, loss = step(jax_shard_params(params, mesh), tx.init(params), xs["x"], xs["h"])
    return float(loss), jax.tree_util.tree_map(np.asarray, new)


@pytest.fixture(scope="module")
def both():
    """(rank 0's results of the legs on four CPU ranks over gloo, JAX's
    sharded step): the ranks run while this process traces JAX's step."""
    params = _perturbed_tree()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 8, 8, 8)).astype(np.float32)
    h = rng.standard_normal((8, 8, 8, 16)).astype(np.float32)
    calls = [(legs.flow_leg, (ARCH, params, x, h, ("mesh", "hybrid"), 2)),
             (dryrun.toy_leg, ("mesh", 2)),
             (legs.coupling_leg, (16, 512)),
             (legs.coupling_leg, (16, 64, 8, (4, 4), 2, "float32"))]
    got = {}

    def run():
        try:
            got["ranks"] = dryrun.launch(dryrun.legs, 4, "cpu", None, (calls,))[0]
        except Exception as err:  # raised below, in the test's thread
            got["error"] = err

    thread = threading.Thread(target=run)
    thread.start()
    jax_res = _jax_sharded_step(params, x, h)
    thread.join()
    if "error" in got:
        raise got["error"]
    return got["ranks"], jax_res


@pytest.fixture(scope="module")
def ranks(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_sharded(both):
    return both[1]


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("kind", ["mesh", "hybrid"])
def test_sharded_flow_step_matches_one_process(ranks, kind):
    """The dp 2 x tp 2 step and the hybrid (slice 2, data 1, model 2) step
    against the one-process step: loss within 2e-4 relative, every updated
    leaf within 2e-4."""
    (loss, tree), (loss1, tree1) = ranks[0][kind], ranks[0]["single"]
    np.testing.assert_allclose(loss, loss1, rtol=TOL)
    for a, b in zip(_leaves(tree), _leaves(tree1)):
        np.testing.assert_allclose(a, b, atol=TOL)


def test_sharded_flow_step_matches_jax_sharded(ranks, jax_sharded):
    """The port's dp 2 x tp 2 step against the JAX package's step on its
    8-device mesh (dp 4 x tp 2), from the same tree and batch."""
    jloss, jtree = jax_sharded
    loss, tree = ranks[0]["mesh"]
    np.testing.assert_allclose(loss, jloss, rtol=TOL)
    assert len(_leaves(tree)) == len(_leaves(jtree))
    for a, b in zip(_leaves(tree), _leaves(jtree)):
        np.testing.assert_allclose(a, b, atol=TOL)


@pytest.mark.parametrize("kind", ["mesh", "hybrid"])
def test_sharded_tree_round_trip(ranks, kind):
    """``convert.flow_params_shard`` then ``convert.jax_flow_params``
    (``shard_params`` then ``gather_params``) gives the JAX tree back bit
    for bit."""
    assert ranks[0][kind + "_roundtrip"]


def test_toy_second_stage_step_and_sample(ranks):
    """The dryrun's toy second stage: one dp 2 x tp 2 trainer step (DDI on
    the whole batch, the shard cut at ``start``) and a
    ``forward_sample(length=3)`` gathered over the data ranks, against the
    same in one process, within 2e-4."""
    res = ranks[1]
    assert res["shape"] == {"data": 2, "model": 2}
    dryrun.check(res, "toy")
    assert res["video_shape"] == (4, 3, 32, 32, 3)


@pytest.mark.parametrize("i,tol", [(2, 1e-2), (3, 1e-5)])
def test_split_coupling_matches_whole(ranks, i, tol):
    """One NICE coupling split four ways over the model axis against the
    whole coupling: the sampling output, the train output and the
    gradients of z, h, w1, w2 (gathered), v, g and b.  bf16 at hid 512
    (K1 and K4's family: their plain stages on the CPU, the split K4
    backward with its all-reduce of da) within 1e-2 of max |ref| (a bf16
    rounding of a differently ordered fp32 sum); fp32 at hid 64 (the plain
    split through autograd) within 1e-5."""
    res = ranks[i]
    assert res["w2_shard"][-1] * 4 == res["w2_shard"][-2]
    assert res["sample"] <= tol and res["train"] <= tol
    for name, err in res["grads"].items():
        assert err <= tol, (name, err)


def test_split_stages_match_unsplit():
    """K1/K4's plain stages at a shard: S1 (a) is the whole a, S2 at N =
    Hid/2 is the whole b's columns bit for bit (each element the same dot),
    and the partial u of S3 at K = Hid/2 sums to the whole u."""
    rng = np.random.default_rng(3)
    t = lambda *s, std=1.0: torch.as_tensor(
        (std * rng.standard_normal(s)).astype(np.float32)).to(torch.bfloat16)
    z = t(2, 4, 4, 16)
    zcol, w1 = im2col3x3(z), t(144, 256, std=144 ** -0.5)
    w2, wp = t(256, 256, std=256 ** -0.5), t(256, 288, std=0.05)
    u, a, b = nice_net_train_plain(zcol, w1, w2, wp)
    parts = []
    for r in range(2):
        cols = slice(128 * r, 128 * (r + 1))
        ur, ar, br = nice_net_train_plain(zcol, w1, w2[:, cols], wp[cols])
        assert torch.equal(ar, a) and torch.equal(br, b[:, cols])
        parts.append(ur)
    torch.testing.assert_close(parts[0] + parts[1], u, atol=1e-5 * float(u.abs().max()),
                               rtol=0)


def test_flow_param_specs_split_w2_only():
    """Only the NICE couplings' w2 splits, on its output columns (the last
    axis, also under the stacked step axis of ``ScannedSteps``); every
    other leaf (w1, the out convs, ActNorms, shuffles, masked-conv flows)
    stays whole; ``shard_params`` cuts the rank's columns."""
    flow = tbuild(dict(ARCH, h_channels=0))
    tree = flow.init(torch.Generator().manual_seed(0), "cpu")
    specs = _spec_leaves(flow_param_specs(tree))
    split = [(x.shape, s) for x, s in zip(tree_leaves(tree), specs) if "model" in s]
    assert split and all(s[-1] == "model" and s.count("model") == 1 for _, s in split)
    assert {len(shape) for shape, _ in split} == {4, 5}  # prior and stacked steps
    assert all(shape[-1] == shape[-2] == 32 for shape, _ in split)
    assert sum(all(a is None for a in s) for s in specs) > len(split)
    mesh = Mesh(("data", "model"), {"data": 1, "model": 2}, {"data": 0, "model": 1}, {})
    shard = tree_leaves(shard_params(tree, mesh))
    for got, whole, s in zip(shard, tree_leaves(tree), specs):
        assert torch.equal(got, whole[..., 16:] if "model" in s else whole)


def _spec_leaves(specs):
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in _spec_leaves(v)]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


def test_weight_norm_of_the_split_out_conv_is_whole():
    """The port keeps the out conv's v whole on every rank and reads the
    rows of its own hidden units from ``v * g / ||v||`` with the norm over
    the whole contraction axis (ROADMAP §3, the split layout); a norm
    taken over a rank's rows alone, which a per-shard weight norm of a
    split v would compute, is another weight."""
    rng = np.random.default_rng(4)
    v = torch.as_tensor(rng.standard_normal((3, 3, 64 + 8, 32)).astype(np.float32))
    g = torch.as_tensor(rng.standard_normal(32).astype(np.float32))
    from ipoke_tpu_torch.flows.primitives import _v_norm

    whole = v * (g / _v_norm(v))
    shard = v[:, :, 32:64] * (g / _v_norm(v[:, :, 32:64]))
    assert not torch.allclose(whole[:, :, 32:64], shard, atol=1e-3)
    tree = {"w1": torch.zeros(3, 3, 8, 64), "w2": torch.zeros(1, 1, 64, 64),
            "out": {"v": v, "g": g, "b": torch.zeros(32)}}
    mesh = Mesh(("data", "model"), {"data": 1, "model": 2}, {"data": 0, "model": 1}, {})
    assert shard_params(tree, mesh)["out"]["v"] is v


def test_nccl_takes_one_rank_a_device(monkeypatch):
    """More ranks than cards over NCCL raise (no fallback to gloo or to
    fewer ranks); gloo takes them; NCCL refuses the CPU; without a card
    ``--device cuda`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        dryrun.check_backend(2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL takes one rank a device"):
        dryrun.check_backend(2, "cuda")
    with pytest.raises(ValueError, match="NCCL takes one rank a device"):
        dryrun.main(["--n", "2"])
    assert dryrun.check_backend(2, "cuda", "gloo") == "gloo"
    assert dryrun.check_backend(1, "cuda") == "nccl"
    with pytest.raises(ValueError, match="NCCL runs on the card only"):
        dryrun.check_backend(2, "cpu", "nccl")


def test_shipped_shard_bytes_on_meta():
    """The SHIPPED flow cut at tp = 2 and 4 on ``meta``: each rank holds
    the replicated leaves and 1/tp of every w2; the ranks' bytes sum to the
    whole plus (tp - 1) copies of the replicated part."""
    b2, b4 = dryrun.shipped_shard_bytes(2), dryrun.shipped_shard_bytes(4)
    assert b2["whole"] == b4["whole"] and len(set(b2["ranks"])) == 1
    w2 = 2 * (b2["whole"] - b2["ranks"][0])  # the w2 bytes
    assert b4["ranks"][0] == b2["whole"] - w2 * 3 // 4
    assert 1000e6 < b2["whole"] / 4 < 1100e6  # 1054M fp32 params


def test_mesh_step_refuses_clip_and_adafactor():
    """A model_parallel mesh step refuses the clip by global norm and
    Adafactor, which read the whole of a split w2 (ROADMAP §3); a data-only
    mesh takes both."""
    from types import SimpleNamespace

    from ipoke_tpu_torch.models.second_stage import make_second_stage_train_step

    tp2 = Mesh(("data", "model"), {"data": 1, "model": 2}, {"data": 0, "model": 0}, {})
    dp2 = Mesh(("data", "model"), {"data": 2, "model": 1}, {"data": 0, "model": 0}, {})
    model = lambda tcfg: SimpleNamespace(config={"training": tcfg})
    clipped = SimpleNamespace(inner=SimpleNamespace(clip=1.0))  # under master_weights
    with pytest.raises(NotImplementedError, match="clip_grad_norm nor Adafactor"):
        make_second_stage_train_step(model({}), clipped, tp2)
    with pytest.raises(NotImplementedError, match="clip_grad_norm nor Adafactor"):
        make_second_stage_train_step(model({"use_adafactor": True}),
                                     SimpleNamespace(clip=0.0), tp2)
    make_second_stage_train_step(model({"use_adafactor": True}), clipped, dp2)
