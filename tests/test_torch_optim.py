"""The port's Adafactor and AdaBelief (``ipoke_tpu_torch.core.optim``)
against the JAX package's ``flow_adam(..., params=...)`` (optax's
``scale_by_factored_rms`` / ``scale_by_belief`` between the clip and coupled
decay and the schedule), plain, under ``master_weights`` and under
``MultiSteps``, on a tree with a factored stacked leaf, a leaf with one dim
under 128, a vector and a ``buf_`` leaf.  Eager optax, but for MultiSteps'
update, jitted (two small programs, one a rule)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu_torch.core import optim as toptim

from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)

STEPS = 30
SHAPES = {"a": (2, 1, 1, 128, 256), "b": (3, 3, 16, 256), "c": (64,)}
RULES = {"adafactor": dict(use_adafactor=True),
         "adabelief": dict(use_adabelief=True)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    tree = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}
    # a float buffer: optax's MultiSteps cannot carry an int leaf's zeros
    tree["buf_perm"] = np.arange(6, dtype=np.float32)
    return tree


def _grads(n, seed):
    """``n`` gradient trees; every third one large enough for the clip."""
    rng = np.random.default_rng(seed)
    return [{k: ((4.0 if i % 3 == 2 else 0.02) * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES.items()} for i in range(n)]


def _sched(mod):
    return mod.warmup_linear_decay(1e-2, 5, 40)


def _run(rule, mode, tree, grads):
    """(JAX fp32 values, port optimizer, port fp32 values) after feeding
    ``grads``: the masters under ``master_weights``."""
    kw = RULES[rule]
    cfg = {"training": {"min_acc_batch_size": 4}}
    params = {k: jnp.asarray(v) for k, v in tree.items()}
    jtx = joptim.flow_adam(_sched(joptim), params=params, clip_grad_norm=1.5, **kw)
    if mode == "master":
        jtx = joptim.master_weights(jtx)
        params = joptim.cast_floats(params, jnp.bfloat16)
    elif mode == "multisteps":
        jtx, _ = joptim.with_grad_accumulation(jtx, cfg, 2)
    opt = jtx.init(params)
    # MultiSteps' lax.cond would compile at every eager call: jit its update
    update = jax.jit(jtx.update) if mode == "multisteps" else jtx.update
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        jg["buf_perm"] = jnp.zeros(6, jnp.float32)
        if mode == "master":
            jg = joptim.cast_floats(jg, jnp.bfloat16)
        upd, opt = update(jg, opt, params)
        params = optax.apply_updates(params, upd)
    want = opt.master if mode == "master" else params

    port = [torch.tensor(tree[k]) for k in SHAPES]
    make = lambda ps: toptim.flow_adam(ps, _sched(toptim), 1.5, **kw)
    if mode == "master":
        port = [p.bfloat16() for p in port]
        ttx = toptim.master_weights(port, make)
    elif mode == "multisteps":
        ttx, k = toptim.with_grad_accumulation(make(port), cfg, 2)
        assert k == 2
    else:
        ttx = make(port)
    for g in grads:
        for q, k in zip(port, SHAPES):
            q.grad = torch.tensor(g[k]).to(q.dtype)
        ttx.step()
    got = ttx.master if mode == "master" else port
    return {k: np.asarray(want[k], np.float32) for k in SHAPES}, ttx, port, got


@pytest.mark.parametrize("mode", ["plain", "master", "multisteps"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_optax(rule, mode):
    """30 updates (60 microbatches under MultiSteps k = 2) with weight decay,
    a warmup schedule and a clip at 1.5: every value within 1e-6 relative
    (1e-7 absolute) of optax's; under ``master_weights`` the fp32 masters,
    and the bf16 params equal to them rounded."""
    n = STEPS * (2 if mode == "multisteps" else 1)
    want, ttx, port, got = _run(rule, mode, _tree(0), _grads(n, 1))
    assert ttx.count == STEPS
    for k, w, g in zip(SHAPES, want.values(), got):
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    if mode == "master":
        for p, m in zip(port, got):
            assert p.dtype == torch.bfloat16 and torch.equal(p, m.bfloat16())


def test_adafactor_factors_as_optax():
    """The factored dims: the two largest axes where both reach 128, in
    numpy's argsort order as optax takes them; the stacked leaf keeps (2, 1, 1, 128) row and (2, 1, 1,
    256) column moments, the others a full ``v``."""
    assert toptim.factored_dims((2, 1, 1, 128, 256)) == (3, 4)
    assert toptim.factored_dims((3, 3, 2048, 2048)) == (2, 3)
    assert toptim.factored_dims((2048, 2048, 1, 1)) == (1, 0)
    assert toptim.factored_dims((3, 3, 16, 256)) is None
    assert toptim.factored_dims((4096,)) is None
    tx = toptim.flow_adam([torch.zeros(s) for s in SHAPES.values()], 1e-3,
                          use_adafactor=True)
    assert [tuple(v.shape) for v in tx.v_row if v is not None] == [(2, 1, 1, 128)]
    assert [tuple(v.shape) for v in tx.v_col if v is not None] == [(2, 1, 1, 256)]
    assert [v is None for v in tx.v] == [True, False, False]
    assert not isinstance(tx, torch.optim.Optimizer)


@pytest.mark.parametrize("mode", ["plain", "master", "multisteps"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_state_dict_round_trips(rule, mode):
    """A state saved after 7 microbatches and loaded into a new optimizer
    (through ``torch.save``) equals the saved one bitwise, and both go on
    to the same params bitwise."""
    kw = RULES[rule]
    cfg = {"training": {"min_acc_batch_size": 4}}
    grads = _grads(12, 2)

    def make_tx(seed):
        tree = _tree(seed)
        port = [torch.tensor(tree[k]) for k in SHAPES]
        make = lambda ps: toptim.flow_adam(ps, _sched(toptim), 1.5, **kw)
        if mode == "master":
            port = [p.bfloat16() for p in port]
            return port, toptim.master_weights(port, make)
        if mode == "multisteps":
            return port, toptim.with_grad_accumulation(make(port), cfg, 2)[0]
        return port, make(port)

    def feed(port, tx, gs):
        for g in gs:
            for q, k in zip(port, SHAPES):
                q.grad = torch.tensor(g[k]).to(q.dtype)
            tx.step()

    port_a, tx_a = make_tx(0)
    feed(port_a, tx_a, grads[:7])
    buf = io.BytesIO()
    torch.save(tx_a.state_dict(), buf)
    buf.seek(0)
    port_b, tx_b = make_tx(0)
    with torch.no_grad():
        for a, b in zip(port_a, port_b):
            b.copy_(a)
    tx_b.load_state_dict(torch.load(buf))
    assert _flat(tx_b.state_dict()) == _flat(tx_a.state_dict())
    feed(port_a, tx_a, grads[7:])
    feed(port_b, tx_b, grads[7:])
    assert all(torch.equal(a, b) for a, b in zip(port_a, port_b))
    assert tx_a.count == tx_b.count


def _flat(state):
    """A state dict as nested lists of (dtype, shape, bytes) for bitwise
    comparison."""
    if torch.is_tensor(state):
        return (str(state.dtype), tuple(state.shape), state.numpy().tobytes())
    if isinstance(state, dict):
        return {k: _flat(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_flat(v) for v in state]
    return state


def test_state_bytes_counts_moments():
    """``state_bytes``: AMSGrad's three fp32 moments a param; Adafactor's
    rows and columns for the factored leaf and a full v for the rest."""
    ps = [torch.zeros(s) for s in SHAPES.values()]
    n = sum(p.numel() for p in ps)
    ams = toptim.flow_adam(ps, 1e-3)
    for p in ps:
        p.grad = torch.ones_like(p)
    ams.step()
    assert toptim.state_bytes(ams) >= 3 * 4 * n
    fac = toptim.flow_adam(ps, 1e-3, use_adafactor=True)
    want = 4 * (2 * 128 + 2 * 256 + 3 * 3 * 16 * 256 + 64)
    assert toptim.state_bytes(fac) == want
