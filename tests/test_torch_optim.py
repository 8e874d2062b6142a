"""The port's schedules and optimizer against the JAX package's optax chain,
on the CPU.

Schedules: 50 steps, 1e-6 relative (the JAX ones run in float32 under
``jnp``, the port's in Python floats).  Optimizer: 5 steps on a small tree
shaped like the LID model's (encoder leaf, two language heads, an unused
discriminator leaf) with the idle head's gradient zero (JAX) or absent
(port), the clip active on one step: parameters within 1e-6 (atol and rtol)
after every step, for plain Adam (``routed=False``: the idle head keeps
moving on decayed momentum) and routing-aware Adam (``routed=True``: the
idle head stands still), and for AdamW, Adam with L2 and SGD."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechlid_tpu.core.optim import make_optimizer as jax_make_optimizer
from speechlid_tpu.core.optim import schedules as jsched
from speechlid_tpu_torch.core.optim import make_optimizer, schedules

TOL = 1e-6
TRISTAGE = dict(lr=2e-3, warmup_steps=10, hold_steps=15, decay_steps=20)


@pytest.mark.parametrize("name,conf", [
    ("tristage_schedule", TRISTAGE),
    ("tristage_schedule", dict(lr=1e-3, phase_ratio=(0.2, 0.3, 0.5), max_update=40)),
    ("cosine_annealing_warmup_restarts",
     dict(first_cycle_steps=20, max_lr=1e-2, min_lr=1e-4, warmup_steps=5, gamma=0.5)),
    ("cosine_annealing_warmup_restarts",
     dict(first_cycle_steps=10, cycle_mult=2.0, max_lr=1e-2, min_lr=1e-4, warmup_steps=3)),
])
def test_schedules_match_jax(name, conf):
    ref, got = getattr(jsched, name)(**conf), getattr(schedules, name)(**conf)
    for step in range(50):
        want = float(ref(step))
        assert abs(got(step) - want) <= TOL * abs(want), (step, got(step), want)


def test_schedule_arguments_are_checked():
    with pytest.raises(ValueError):
        schedules.tristage_schedule(phase_ratio=(0.5, 0.4, 0.4))
    with pytest.raises(ValueError):
        schedules.tristage_schedule()
    with pytest.raises(ValueError):
        schedules.cosine_annealing_warmup_restarts(first_cycle_steps=5, warmup_steps=5)


def test_plateau_matches_jax():
    ref = jsched.ReduceLROnPlateau(lr=1e-2, factor=0.5, patience=1, cooldown=1)
    got = schedules.ReduceLROnPlateau(lr=1e-2, factor=0.5, patience=1, cooldown=1)
    for metric in (3.0, 2.0, 2.1, 2.2, 2.3, 2.4, 2.5, 1.0, 1.1, 1.2, 1.3):
        assert got.step(metric) == ref.step(metric)
        assert got.state_dict() == ref.state_dict()
    fresh = schedules.ReduceLROnPlateau(lr=1.0)
    fresh.load_state_dict(got.state_dict())
    assert fresh.state_dict() == got.state_dict()


# ------------------------------------------------------------------ optimizer


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"featurizer": {"w": rng.randn(4, 3).astype(np.float32)},
            "heads": {"w": rng.randn(2, 3).astype(np.float32)},
            "discriminator": {"b": rng.randn(2).astype(np.float32)}}


def _grads(step, rng):
    """Language step % 2 is trained: its head row has a gradient, the other
    row and the discriminator none.  Step 2 is large enough to be clipped."""
    scale = 300.0 if step == 2 else 1.0
    own = step % 2
    heads = np.zeros((2, 3), np.float32)
    heads[own] = scale * rng.randn(3)
    return own, {"featurizer": {"w": (scale * rng.randn(4, 3)).astype(np.float32)},
                 "heads": {"w": heads},
                 "discriminator": {"b": np.zeros(2, np.float32)}}


def _torch_side(tree):
    return [("featurizer.w", torch.nn.Parameter(torch.tensor(tree["featurizer"]["w"]))),
            ("heads.heads.0.w", torch.nn.Parameter(torch.tensor(tree["heads"]["w"][0]))),
            ("heads.heads.1.w", torch.nn.Parameter(torch.tensor(tree["heads"]["w"][1]))),
            ("discriminator.b", torch.nn.Parameter(torch.tensor(tree["discriminator"]["b"])))]


def _assert_same(named, params):
    got = dict(named)
    np.testing.assert_allclose(got["featurizer.w"].detach().numpy(),
                               np.asarray(params["featurizer"]["w"]), rtol=TOL, atol=TOL)
    for lang in (0, 1):
        np.testing.assert_allclose(got[f"heads.heads.{lang}.w"].detach().numpy(),
                                   np.asarray(params["heads"]["w"][lang]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["discriminator.b"].detach().numpy(),
                               np.asarray(params["discriminator"]["b"]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [
    dict(name="adam", routed=False),
    dict(name="adam", routed=True),
    dict(name="adamw", weight_decay=0.1),
    dict(name="adam", weight_decay=0.1),
    dict(name="sgd"),
], ids=["adam", "routed_adam", "adamw", "adam_l2", "sgd"])
def test_five_steps_match_optax(kw):
    conf = dict(lr=1e-2, clip_norm=5.0, schedule="tristage",
                schedule_conf=dict(warmup_steps=2, hold_steps=1, decay_steps=4), **kw)
    routed = conf.get("routed", False)
    tree = _tree()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx, _ = jax_make_optimizer(**conf)
    opt_state = tx.init(params)
    named = _torch_side(tree)
    optimizer, plateau = make_optimizer(named, **conf)
    assert plateau is None
    rng = np.random.RandomState(1)
    idle_moved = False
    for step in range(5):
        own, grads = _grads(step, rng)
        jgrads = jax.tree_util.tree_map(jnp.asarray, grads)
        if routed:
            onehot = (np.arange(2) == own).astype(np.float32)[:, None]
            mask = {"featurizer": {"w": jnp.ones(())}, "heads": {"w": jnp.asarray(onehot)},
                    "discriminator": {"b": jnp.ones(())}}
            updates, opt_state = tx.update(jgrads, opt_state, params, mask=mask)
            updates = jax.tree_util.tree_map(lambda u, m: u * m, updates, mask)
        else:
            updates, opt_state = tx.update(jgrads, opt_state, params)
        before = np.asarray(params["heads"]["w"][1 - own])
        params = optax.apply_updates(params, updates)
        idle_moved |= step > 0 and not np.array_equal(
            before, np.asarray(params["heads"]["w"][1 - own]))

        got = dict(named)
        got["featurizer.w"].grad = torch.tensor(grads["featurizer"]["w"])
        got[f"heads.heads.{own}.w"].grad = torch.tensor(grads["heads"]["w"][own])
        assert abs(optimizer.lr_at(optimizer.count) - float(
            schedules.tristage_schedule(lr=1e-2, **conf["schedule_conf"])(
                step + 1 if routed else step))) == 0.0
        optimizer.step()
        optimizer.zero_grad()
        _assert_same(named, params)
    if conf["name"] != "sgd":
        assert idle_moved == (not routed)  # the semantics the two modes differ in


def test_frozen_parameter_keeps_moments_and_resumes():
    named = _torch_side(_tree())
    optimizer, _ = make_optimizer(named, "adam", lr=1e-2, clip_norm=None)
    rng = np.random.RandomState(2)

    def step():
        for _, p in named:
            p.grad = torch.tensor(rng.randn(*p.shape).astype(np.float32))
        optimizer.step()
        optimizer.zero_grad()

    step()
    frozen = named[0][1]
    frozen.requires_grad_(False)
    value, mu, nu = frozen.detach().clone(), optimizer.mu[0].clone(), optimizer.nu[0].clone()
    step()
    assert torch.equal(frozen, value)
    assert torch.equal(optimizer.mu[0], mu) and torch.equal(optimizer.nu[0], nu)

    other = _torch_side(_tree(seed=5))
    restored, _ = make_optimizer(other, "adam", lr=1e-2, clip_norm=None)
    restored.load_state_dict(optimizer.state_dict())
    assert restored.count == optimizer.count == 2
    for a, b in zip(restored.mu + restored.nu, optimizer.mu + optimizer.nu):
        assert torch.equal(a, b)


def test_factory_rejects_what_is_not_ported():
    named = _torch_side(_tree())
    # every optimizer's options are ported (tests/test_torch_novograd.py and
    # tests/test_torch_optim_conf.py hold them to optax); a key an optimizer
    # does not take raises
    novograd, _ = make_optimizer(named, "novograd", optim_conf=dict(amsgrad=True))
    assert novograd.nu_max is not None and all(n.shape == () for n in novograd.nu)
    adam, _ = make_optimizer(named, "adam", optim_conf=dict(b1=0.8))
    assert adam.b1 == 0.8
    with pytest.raises(TypeError):
        make_optimizer(named, "adam", optim_conf=dict(beta1=0.8))
    with pytest.raises(TypeError):
        make_optimizer(named, "novograd", optim_conf=dict(beta3=0.5))
    with pytest.raises(ValueError):
        make_optimizer(named, "adamw", routed=True)
    with pytest.raises(ValueError):
        make_optimizer(named, "adam", schedule="plateau", routed=True)
    with pytest.raises(ValueError):
        make_optimizer(named, "lamb")
    optimizer, plateau = make_optimizer(named, "adam", lr=0.5, schedule="plateau",
                                        schedule_conf=dict(factor=0.1, patience=0))
    plateau.step(1.0)
    plateau.step(2.0)
    assert optimizer.lr_at(0) == plateau.lr == 0.05
