"""The port's Novograd (``speechlid_tpu_torch/core/optim/novograd.py``
through ``make_optimizer``) against the JAX package's optax transform, on
the CPU, as ``tests/test_torch_optim.py`` holds Adam.

- Eight steps on a small tree shaped like the LID model's (an encoder leaf,
  the two language heads stacked on one leaf in JAX and two tensors in the
  port, an idle discriminator leaf), the clip active on one step and a
  tristage schedule: parameters within 1e-6 (atol and rtol) after every
  step, for every combination of ``weight_decay``, ``grad_averaging``,
  ``amsgrad`` and ``luc`` that changes the arithmetic.  The heads share one
  second moment, as the JAX leaf does.
- A state dict taken after four steps resumes to the same four more.
- Through the trainers: ``LidASRTask(optimizer="novograd")`` on both
  ``Trainer``s for six steps, under ``tests/test_torch_trainer.py``'s bars
  (Novograd divides rounding noise by its own norm as Adam does, so a
  leaf whose true gradient is zero takes the band of Σ lr)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechlid_tpu.core.optim import make_optimizer as jax_make_optimizer
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.core.optim import make_optimizer
from speechlid_tpu_torch.core.optim.novograd import leaf_name
from tests.test_torch_trainer import (
    DETERMINISTIC,
    HPARAMS,
    LOSS_TOL,
    assert_variables_close,
    batches,
    lr_sum,
    run_jax,
    run_port,
)
from tests.torch_parity import lid_pair, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-6
SCHEDULE = dict(schedule="tristage",
                schedule_conf=dict(warmup_steps=2, hold_steps=2, decay_steps=6))


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"featurizer": {"w": rng.randn(4, 3).astype(np.float32)},
            "heads": {"w": rng.randn(2, 3).astype(np.float32)},
            "discriminator": {"b": rng.randn(2).astype(np.float32)}}


def _named(tree):
    return [("featurizer.w", torch.nn.Parameter(torch.tensor(tree["featurizer"]["w"]))),
            ("heads.heads.0.w", torch.nn.Parameter(torch.tensor(tree["heads"]["w"][0]))),
            ("heads.heads.1.w", torch.nn.Parameter(torch.tensor(tree["heads"]["w"][1]))),
            ("discriminator.b", torch.nn.Parameter(torch.tensor(tree["discriminator"]["b"])))]


def _grads(step, rng):
    """Language step % 2 trains: its head row has a gradient, the other
    row and the discriminator none.  Step 2 is large enough to be clipped."""
    scale = 300.0 if step == 2 else 1.0
    own = step % 2
    heads = np.zeros((2, 3), np.float32)
    heads[own] = scale * rng.randn(3)
    return own, {"featurizer": {"w": (scale * rng.randn(4, 3)).astype(np.float32)},
                 "heads": {"w": heads},
                 "discriminator": {"b": np.zeros(2, np.float32)}}


def _assert_same(named, params):
    got = dict(named)
    want = {"featurizer.w": params["featurizer"]["w"],
            "heads.heads.0.w": params["heads"]["w"][0],
            "heads.heads.1.w": params["heads"]["w"][1],
            "discriminator.b": params["discriminator"]["b"]}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(w),
                                   rtol=TOL, atol=TOL, err_msg=name)


def _set_grads(named, own, grads):
    got = dict(named)
    got["featurizer.w"].grad = torch.tensor(grads["featurizer"]["w"])
    got[f"heads.heads.{own}.w"].grad = torch.tensor(grads["heads"]["w"][own])


CONFS = {
    "plain": dict(),
    "weight_decay": dict(weight_decay=0.1),
    "grad_averaging": dict(optim_conf=dict(grad_averaging=True)),
    "amsgrad": dict(optim_conf=dict(amsgrad=True)),
    "luc": dict(optim_conf=dict(luc=True, luc_trust=2e-2)),
    "all": dict(weight_decay=0.05, optim_conf=dict(grad_averaging=True, amsgrad=True,
                                                   luc=True, luc_trust=2e-2, beta1=0.9)),
}


@pytest.mark.parametrize("conf", CONFS.values(), ids=list(CONFS))
def test_eight_steps_match_optax(conf):
    kw = dict(lr=1e-2, clip_norm=5.0, **SCHEDULE, **conf)
    tree = _tree()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx, _ = jax_make_optimizer("novograd", **kw)
    opt_state = tx.init(params)
    named = _named(tree)
    optimizer, _ = make_optimizer(named, "novograd", **kw)
    assert optimizer.nu_names == ["featurizer.w", "heads.heads.*.w", "discriminator.b"]
    rng = np.random.RandomState(1)
    for step in range(8):
        own, grads = _grads(step, rng)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        _set_grads(named, own, grads)
        optimizer.step()
        optimizer.zero_grad()
        _assert_same(named, params)
    nu = opt_state[-1].nu[0] if conf.get("optim_conf", {}).get("amsgrad") else opt_state[-1].nu
    np.testing.assert_allclose(optimizer.nu[1].item(), float(nu["heads"]["w"]), rtol=TOL)


def test_state_dict_resumes_the_same_steps():
    kw = dict(lr=1e-2, clip_norm=5.0, **SCHEDULE, optim_conf=dict(amsgrad=True))
    tree = _tree(3)
    named = _named(tree)
    optimizer, _ = make_optimizer(named, "novograd", **kw)
    rng = np.random.RandomState(4)
    steps = [_grads(step, rng) for step in range(8)]
    for own, grads in steps[:4]:
        _set_grads(named, own, grads)
        optimizer.step()
        optimizer.zero_grad()
    state = optimizer.state_dict()
    assert sorted(state["nu"]) == sorted(state["nu_max"]) == sorted(optimizer.nu_names)
    resumed_named = [(n, torch.nn.Parameter(p.detach().clone())) for n, p in named]
    resumed, _ = make_optimizer(resumed_named, "novograd", **kw)
    resumed.load_state_dict(state)
    for own, grads in steps[4:]:
        for opt, nm in ((optimizer, named), (resumed, resumed_named)):
            _set_grads(nm, own, grads)
            opt.step()
            opt.zero_grad()
    for (_, a), (_, b) in zip(named, resumed_named):
        assert torch.equal(a, b)


def test_leaf_names():
    assert leaf_name("heads.heads.2.blocks.0.ff1.fc1.weight") == "heads.heads.*.blocks.0.ff1.fc1.weight"
    assert leaf_name("featurizer.blocks.1.attn.to_q.weight") == "featurizer.blocks.1.attn.to_q.weight"


def test_trainers_match_on_the_joint_task():
    hp = dict(HPARAMS, **DETERMINISTIC, optimizer="novograd", lr=1e-3)
    jtask, variables, ptask = lid_pair(hp)
    train = batches(2, [0, 1, 1, 0, 2, 0])
    jrec, jfinal = run_jax(jtask, variables, train)
    prec, ptrainer = run_port(ptask, train)
    diffs = np.abs(np.array(prec.losses) - np.array(jrec.losses))
    assert len(diffs) == 6 and diffs.max() <= LOSS_TOL, diffs
    assert_variables_close(convert.lid_variables(ptask.model.state_dict()), jfinal,
                           lr_sum(ptrainer))
    heads = [n for n in ptrainer.optimizer.nu_names if n.startswith("heads.heads.*.")]
    assert heads and not any(n.startswith("heads.heads.0.") for n in ptrainer.optimizer.nu_names)
