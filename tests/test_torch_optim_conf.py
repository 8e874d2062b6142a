"""``optim_conf`` for Adam, AdamW, SGD and routed Adam
(``speechlid_tpu_torch/core/optim/factory.py``) against the JAX package's
optax chain, on the CPU, as ``tests/test_torch_optim.py`` holds the
defaults.

- Six steps on the small tree of ``tests/test_torch_optim.py`` (encoder
  leaf, two language heads, an idle discriminator leaf, the clip active on
  step 2, a tristage schedule) for every key the port takes: parameters
  within 1e-6 (atol and rtol) after every step.
- SGD's momentum trace and Adam's moments ride in the state dict: a
  resume after three steps takes the same three more, bit for bit, and the
  trace equals optax's ``TraceState`` within 1e-6.
- A key the optimizer does not take raises ``TypeError`` in both
  packages."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechlid_tpu.core.optim import make_optimizer as jax_make_optimizer
from speechlid_tpu_torch.core.optim import make_optimizer
from tests.test_torch_optim import _assert_same, _grads, _torch_side, _tree

TOL = 1e-6
SCHEDULE = dict(lr=1e-2, clip_norm=5.0, schedule="tristage",
                schedule_conf=dict(warmup_steps=2, hold_steps=1, decay_steps=4))
CONFS = {
    "adam_betas_eps": dict(name="adam", optim_conf=dict(b1=0.8, b2=0.99, eps=1e-6)),
    "adam_eps_root": dict(name="adam", optim_conf=dict(eps_root=1e-4, eps=0.0)),
    "adam_nesterov": dict(name="adam", optim_conf=dict(nesterov=True, b1=0.85)),
    "adam_l2_nesterov": dict(name="adam", weight_decay=0.1, optim_conf=dict(nesterov=True)),
    "adamw_all": dict(name="adamw", weight_decay=0.1,
                      optim_conf=dict(b1=0.8, b2=0.95, eps=1e-7, eps_root=1e-5, nesterov=True)),
    "sgd_momentum": dict(name="sgd", optim_conf=dict(momentum=0.9)),
    "sgd_nesterov": dict(name="sgd", optim_conf=dict(momentum=0.9, nesterov=True)),
    "sgd_momentum_zero": dict(name="sgd", optim_conf=dict(momentum=0.0)),
    "routed_adam": dict(name="adam", routed=True, optim_conf=dict(b1=0.8, b2=0.99, eps=1e-6)),
}


def _jax_step(tx, opt_state, params, own, grads, routed):
    jgrads = jax.tree_util.tree_map(jnp.asarray, grads)
    if not routed:
        updates, opt_state = tx.update(jgrads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state
    onehot = (np.arange(2) == own).astype(np.float32)[:, None]
    mask = {"featurizer": {"w": jnp.ones(())}, "heads": {"w": jnp.asarray(onehot)},
            "discriminator": {"b": jnp.ones(())}}
    updates, opt_state = tx.update(jgrads, opt_state, params, mask=mask)
    updates = jax.tree_util.tree_map(lambda u, m: u * m, updates, mask)
    return optax.apply_updates(params, updates), opt_state


def _port_step(optimizer, named, own, grads):
    got = dict(named)
    got["featurizer.w"].grad = torch.tensor(grads["featurizer"]["w"])
    got[f"heads.heads.{own}.w"].grad = torch.tensor(grads["heads"]["w"][own])
    optimizer.step()
    optimizer.zero_grad()


@pytest.mark.parametrize("conf", CONFS.values(), ids=list(CONFS))
def test_six_steps_match_optax(conf):
    kw = dict(SCHEDULE, **conf)
    routed = kw.get("routed", False)
    tree = _tree()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx, _ = jax_make_optimizer(**kw)
    opt_state = tx.init(params)
    named = _torch_side(tree)
    optimizer, _ = make_optimizer(named, **kw)
    rng = np.random.RandomState(1)
    for step in range(6):
        own, grads = _grads(step, rng)
        params, opt_state = _jax_step(tx, opt_state, params, own, grads, routed)
        _port_step(optimizer, named, own, grads)
        _assert_same(named, params)


@pytest.mark.parametrize("conf", [CONFS["sgd_nesterov"], CONFS["adamw_all"]],
                         ids=["sgd_nesterov", "adamw_all"])
def test_a_resume_continues_the_same_steps(conf):
    """The state dict taken after three steps carries SGD's trace (optax's
    ``TraceState``) and Adam's moments: the resumed optimizer takes the
    uninterrupted one's three more steps bit for bit."""
    kw = dict(SCHEDULE, **conf)
    tree = _tree(3)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx, _ = jax_make_optimizer(**kw)
    opt_state = tx.init(params)
    named = _torch_side(tree)
    optimizer, _ = make_optimizer(named, **kw)
    rng = np.random.RandomState(4)
    steps = [_grads(step, rng) for step in range(6)]
    for own, grads in steps[:3]:
        params, opt_state = _jax_step(tx, opt_state, params, own, grads, False)
        _port_step(optimizer, named, own, grads)
    state = optimizer.state_dict()
    assert sorted(state["mu"]) == sorted(optimizer.names)
    if conf["name"] == "sgd":
        trace = opt_state[-1][0].trace  # clip → (trace, scale by lr)
        np.testing.assert_allclose(state["mu"]["featurizer.w"].numpy(),
                                   np.asarray(trace["featurizer"]["w"]), rtol=TOL, atol=TOL)
    resumed_named = [(n, torch.nn.Parameter(p.detach().clone())) for n, p in named]
    resumed, _ = make_optimizer(resumed_named, **kw)
    resumed.load_state_dict(state)
    for own, grads in steps[3:]:
        params, opt_state = _jax_step(tx, opt_state, params, own, grads, False)
        _port_step(optimizer, named, own, grads)
        _port_step(resumed, resumed_named, own, grads)
        _assert_same(resumed_named, params)
    for (_, a), (_, b) in zip(named, resumed_named):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw,key", [
    (dict(name="adam"), "momentum"),
    (dict(name="adamw"), "beta1"),
    (dict(name="sgd"), "b1"),
    (dict(name="adam", routed=True), "eps_root"),
], ids=["adam", "adamw", "sgd", "routed_adam"])
def test_an_unknown_key_raises_type_error_in_both(kw, key):
    named = _torch_side(_tree())
    with pytest.raises(TypeError, match=key):
        make_optimizer(named, optim_conf={key: 0.5}, **kw)
    with pytest.raises(TypeError, match=key):
        jax_make_optimizer(optim_conf={key: 0.5}, **kw)
