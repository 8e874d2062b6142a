"""The port's Conformer modules in TRAINING mode against the JAX package's
(``deterministic=False``, ``mutable=["batch_stats"]``), with converted
weights, on the CPU: masked BatchNorm batch statistics and running updates
(1e-5, atol and rtol: one float32 reduction each); conv module, block and
model outputs, input gradients and parameter gradients with dropout 0 and
stochastic depth off (1e-4: float32 through attention and two blocks, summed
in another order than XLA's); and stochastic depth under a fixed keep
pattern, where a dropped block leaves x unchanged yet moves its BatchNorm
statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import conformer as jconf
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import conformer
from tests.torch_parity import init_variables, one_thread, tree_leaves_with_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
BN_TOL = 1e-5
DIM = 32
RNGS = {"dropout": jax.random.PRNGKey(1), "stochastic_depth": jax.random.PRNGKey(2)}


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mask(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _grad_state(module):
    """{name: gradient} of every parameter plus the buffers as they are:
    the shape ``convert``'s reverse direction takes."""
    state = {k: v for k, v in module.state_dict().items()}
    state.update({k: p.grad for k, p in module.named_parameters()})
    return state


def _assert_trees_close(got, want, tol):
    got, want = tree_leaves_with_names(got), tree_leaves_with_names(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("lengths", [(50, 33), (50, 0), (1, 0), None])
def test_masked_batch_norm_statistics_and_running_update(lengths):
    """Valid frames only; n = 1 and n = 0 clamp the unbiased factor; no mask
    is the plain batch statistics."""
    x = _x((2, 50, DIM), 0) * 2.0 + 0.5
    mask = None if lengths is None else _mask(lengths, 50)
    jm = jconf._MaskedBatchNorm(use_running_average=False)
    jmask = None if mask is None else jnp.asarray(mask)
    v = init_variables(jm, 0, jnp.asarray(x), jmask)
    want, mut = jm.apply(v, jnp.asarray(x), jmask, mutable=["batch_stats"])
    tm = conformer.MaskedBatchNorm(DIM).train()
    tm.load_state_dict({"weight": torch.tensor(v["params"]["scale"]),
                        "bias": torch.tensor(v["params"]["bias"]),
                        "running_mean": torch.tensor(v["batch_stats"]["mean"]),
                        "running_var": torch.tensor(v["batch_stats"]["var"])})
    got = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=BN_TOL, atol=BN_TOL)
    np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=BN_TOL, atol=BN_TOL)
    assert not np.allclose(tm.running_mean.numpy(), v["batch_stats"]["mean"])
    # eval mode reads the running statistics and leaves them alone
    before = tm.running_mean.clone()
    tm.eval()(torch.from_numpy(x))
    assert torch.equal(tm.running_mean, before)


def test_conv_module_train():
    x, mask, cot = _x((2, 50, DIM), 1), _mask((50, 33), 50), _x((2, 50, DIM), 2)
    jm = jconf.ConformerConvModule(dim=DIM)
    v = init_variables(jm, 1, jnp.asarray(x), True, jnp.asarray(mask))

    def loss(params, xin):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xin, False,
                          jnp.asarray(mask), mutable=["batch_stats"], rngs=RNGS)
        return jnp.sum(y * cot), (y, mut)

    (_, (want, mut)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    tm = conformer.ConformerConvModule(DIM).train()
    convert.load_into(tm, convert.conv_module_state(v["params"], v["batch_stats"], ""))
    xin = torch.from_numpy(x).requires_grad_(True)
    got = tm(xin, torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xin.grad.numpy(), np.asarray(gx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.depthwise.weight.grad.numpy(),
                               np.asarray(gp["depthwise"]["kernel"])[:, 0, :], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.depthwise.bias.grad.numpy(),
                               np.asarray(gp["depthwise"]["bias"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.bn.weight.grad.numpy(), np.asarray(gp["bn"]["scale"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.pointwise_in.weight.grad.numpy(),
                               np.asarray(gp["Dense_0"]["kernel"]).T, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["var"]), rtol=BN_TOL, atol=BN_TOL)


def test_block_train():
    x, mask, cot = _x((2, 40, DIM), 3), _mask((40, 17), 40), _x((2, 40, DIM), 4)
    jm = jconf.ConformerBlock(dim=DIM, dim_head=16, heads=2)
    v = init_variables(jm, 3, jnp.asarray(x), jnp.asarray(mask))

    def loss(params):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                          jnp.asarray(mask), False, mutable=["batch_stats"], rngs=RNGS)
        return jnp.sum(y * cot), (y, mut)

    (_, (want, mut)), gp = jax.value_and_grad(loss, has_aux=True)(v["params"])
    tm = conformer.ConformerBlock(DIM, dim_head=16, heads=2).train()
    convert.load_into(tm, convert.block_state(v["params"], v["batch_stats"], ""))
    got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    grads, stats = convert.block_variables(_grad_state(tm), "")
    _assert_trees_close(grads, gp, TOL)
    _assert_trees_close(stats, mut["batch_stats"], BN_TOL)


@pytest.mark.parametrize("sub_sampling", [4, 2])
def test_model_train(sub_sampling):
    feats, lengths, = _x((2, 101, 80), 5), np.array([101, 60], np.int32)
    kw = dict(n_blocks=2, encoder_dim=DIM, heads=2, dim_head=16, sub_sampling=sub_sampling,
              use_stochastic_depth=False, pos_dropout=0.0)
    jm = jconf.ConformerModel(**kw)
    v = init_variables(jm, 5, jnp.asarray(feats), jnp.asarray(lengths))
    cot = None

    def loss(params):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          jnp.asarray(feats), jnp.asarray(lengths), False,
                          mutable=["batch_stats"], rngs=RNGS)
        return jnp.sum(y * cot), (y, mut)

    t_out = int(jm.subsampled_lengths(jnp.asarray([101]))[0])
    cot = _x((2, t_out, DIM), 6)
    (_, (want, mut)), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    tm = conformer.ConformerModel(**kw).train()
    convert.load_into(tm, convert.conformer_state(v["params"], v["batch_stats"]))
    got = tm(torch.from_numpy(feats), torch.from_numpy(lengths))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    grads, stats = convert.conformer_variables(_grad_state(tm))
    _assert_trees_close(grads, gp, TOL)
    _assert_trees_close(stats, mut["batch_stats"], BN_TOL)


def test_dropped_block_leaves_x_unchanged_yet_moves_its_statistics(monkeypatch):
    """Keep pattern (True, False) in both packages: the JAX model through a
    pinned ``jax.random.bernoulli``, the port through ``draw_keep``."""
    feats, lengths = _x((2, 101, 80), 7), np.array([101, 77], np.int32)
    kw = dict(n_blocks=2, encoder_dim=DIM, heads=2, dim_head=16, sub_sampling=4,
              use_stochastic_depth=True, pos_dropout=0.0)
    jm = jconf.ConformerModel(**kw)
    v = init_variables(jm, 7, jnp.asarray(feats), jnp.asarray(lengths))
    pattern = iter([True, False])
    monkeypatch.setattr(jax.random, "bernoulli", lambda *a, **k: jnp.asarray(next(pattern)))
    want, mut = jm.apply(v, jnp.asarray(feats), jnp.asarray(lengths), False,
                         mutable=["batch_stats"], rngs=RNGS)

    tm = conformer.ConformerModel(**kw).train()
    convert.load_into(tm, convert.conformer_state(v["params"], v["batch_stats"]))
    monkeypatch.setattr(tm, "draw_keep", lambda device: torch.tensor([True, False]))
    got = tm(torch.from_numpy(feats), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    _, stats = convert.conformer_variables(tm.state_dict())
    _assert_trees_close(stats, mut["batch_stats"], BN_TOL)

    # the dropped block's output is gone, its statistics have moved
    first = conformer.ConformerModel(**kw).train()
    convert.load_into(first, convert.conformer_state(v["params"], v["batch_stats"]))
    monkeypatch.setattr(first, "draw_keep", lambda device: torch.tensor([True, True]))
    mask = torch.from_numpy(_mask(first.subsampled_lengths(torch.from_numpy(lengths)), 24))
    x0 = first.subsample(torch.from_numpy(feats)) * DIM ** 0.5
    after_block0 = first.blocks[0](x0, mask)
    torch.testing.assert_close(got, after_block0, rtol=1e-6, atol=1e-6)
    moved = tm.blocks[1].conv.bn.running_mean.numpy()
    assert not np.allclose(moved, v["batch_stats"]["block_1"]["conv"]["bn"]["mean"])
    got.sum().backward()
    assert float(tm.blocks[1].ff1.fc1.weight.grad.abs().max()) == 0.0  # dropped: zero, not None
    assert float(tm.blocks[0].ff1.fc1.weight.grad.abs().max()) > 0.0


def test_survival_probabilities_and_draw():
    model = conformer.ConformerModel(n_blocks=14, encoder_dim=DIM, heads=2, dim_head=16)
    want = [1.0 - ((i + 1) / 14) * (1.0 - 0.7) for i in range(14)]
    np.testing.assert_allclose(model.survival.numpy(), want, rtol=1e-6)
    conformer.set_generator(model, torch.Generator().manual_seed(0))
    keeps = torch.stack([model.draw_keep(torch.device("cpu")) for _ in range(400)]).float()
    np.testing.assert_allclose(keeps.mean(0).numpy(), want, atol=0.08)
    conformer.set_generator(model, torch.Generator().manual_seed(0))
    assert torch.equal(model.draw_keep(torch.device("cpu")), keeps[0].bool())
    assert "survival" not in model.state_dict()


def test_dropout_draws_from_its_generator():
    drop = conformer.Dropout(0.25).train()
    x = torch.ones(200, 100)
    drop.generator = torch.Generator().manual_seed(3)
    y = drop(x)
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.02
    assert y.unique().tolist() == pytest.approx([0.0, 1.0 / 0.75])
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(drop(x), y)
    assert drop.eval()(x) is x
    assert conformer.Dropout(0.0).train()(x) is x
    with pytest.raises(ValueError):
        conformer.Dropout(1.0)
    model = conformer.ConformerModel(n_blocks=1, encoder_dim=DIM, heads=2, dim_head=16)
    gen = torch.Generator().manual_seed(4)
    conformer.set_generator(model, gen)
    assert all(m.generator is gen for m in model.modules()
               if isinstance(m, (conformer.Dropout, conformer.ConformerModel)))
