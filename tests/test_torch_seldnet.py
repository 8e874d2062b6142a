"""The port's SELDNet (``speechlid_tpu_torch/models/seldnet.py``) and its
bidirectional GRU (``models/rnn.BiGRU``) against the JAX package's on the
CPU, both presets at narrow widths.

Weights are flax's initial distributions drawn on the port's side and moved
by N(0, 0.05²) per entry, with random BatchNorm statistics
(``torch_parity.port_drawn``), carried across by ``convert.seldnet_variables``
/ ``seldnet_state``; their tree is the JAX init's (``jax.eval_shape``), and
so is the tree of each preset at its JAX defaults.  Tolerances:

- the eval forward (running statistics) within 1e-5 relative and 1e-4
  absolute of JAX's;
- training mode (batch statistics, dropout 0): ``sed``, ``doa``, the moved
  BatchNorm statistics and every parameter gradient of the test's loss
  Σ sed·c₁ + Σ doa·c₂ (a check's loss; the JAX package trains no SELDNet)
  within 1e-4 of the leaf's largest entry of the JAX model run in float64,
  as ``tests/test_torch_extras_models.py`` holds its recurrent models; a
  conv bias feeds a train-mode BatchNorm, so its true gradient is zero:
  both sides within 1e-4 of the largest gradient entry of any leaf;
- ``BiGRU`` against flax's ``nn.Bidirectional(nn.RNN(nn.GRUCell))``: the
  output within 1e-5 and every gradient within 1e-4 of its leaf's largest
  entry."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import seldnet as jseldnet
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import rnn
from speechlid_tpu_torch.models import seldnet as pseldnet
from tests.test_torch_extras_models import _float64, _float64_carries
from tests.torch_parity import (  # noqa: F401
    assert_leaves_close,
    assert_same_tree,
    one_thread,
    perturbed,
    port_drawn,
    random_batch_stats,
    tree_leaves_with_names,
)

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL, ATOL = 1e-5, 1e-4
GRAD_TOL = 1e-4
B, C, FREQ, T = 2, 3, 256, 12

# the presets' structure (pools, depths, head layers) at narrow widths
NARROW = {
    "vanilla": dict(cnn_filters=(4, 4, 4), pool_size=((8, 2), (8, 2), (2, 2)), rnn_size=6,
                    n_rnn=2, fc_size=8, head_layers=1),
    "vanilla_pool_time_off": dict(cnn_filters=(4, 4, 4), pool_size=((8, 2), (8, 2), (2, 2)),
                                  rnn_size=6, n_rnn=2, fc_size=8, head_layers=1,
                                  pool_time=False),
    "augmented": dict(cnn_filters=(4, 6, 8, 8), pool_size=((8, 2), (8, 2), (2, 2), (1, 1)),
                      rnn_size=6, n_rnn=3, fc_size=10, head_layers=3),
}
SHAPE = dict(freq_dim=FREQ, output_classes=2, class_overlaps=3)


def drawn(name, seed=0):
    """(JAX module, port module with the converted weights, numpy variables,
    input)."""
    jmodule = jseldnet.SELDNet(**SHAPE, **NARROW[name])
    pmodule = pseldnet.SELDNet(C, **SHAPE, **NARROW[name])
    variables = port_drawn(
        pmodule, seed, lambda sd: convert.seldnet_variables(sd, pmodule),
        lambda v: convert.seldnet_state(v, pmodule),
        adjust=lambda v, s: random_batch_stats(perturbed(v, s), s))
    x = np.random.RandomState(seed + 1).randn(B, C, FREQ, T).astype(np.float32)
    return jmodule, pmodule, variables, x


@pytest.mark.parametrize("name", sorted(NARROW))
def test_round_trip_tree_is_the_jax_init(name):
    jmodule, pmodule, variables, x = drawn(name)
    want = jax.eval_shape(lambda k: jmodule.init(k, jnp.asarray(x)), jax.random.PRNGKey(0))
    assert_same_tree(variables, dict(want))
    back = convert.seldnet_state(variables, pmodule)
    state = pmodule.state_dict()
    assert set(back) == set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(back[key], value.numpy(), err_msg=key)


@pytest.mark.parametrize("preset", ["vanilla", "augmented"])
def test_presets_are_the_jax_presets(preset):
    """Each preset at its JAX defaults (freq 256; 8 and 4 input channels)
    holds the JAX preset's leaves."""
    channels = {"vanilla": 8, "augmented": 4}[preset]
    pmodule = getattr(pseldnet, f"seldnet_{preset}")()
    jmodule = getattr(jseldnet, f"seldnet_{preset}")()
    want = jax.eval_shape(lambda k: jmodule.init(k, jnp.zeros((1, channels, 256, 8))),
                          jax.random.PRNGKey(0))
    assert_same_tree(convert.seldnet_variables(pmodule.state_dict(), pmodule), dict(want))
    assert pmodule.dropout.p == jmodule.dropout


@pytest.mark.parametrize("name", sorted(NARROW))
def test_eval_forward_matches_jax(name):
    jmodule, pmodule, variables, x = drawn(name)
    want = jax.jit(lambda v, a: jmodule.apply(v, a))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pmodule.eval()(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    frames = T // 8 if NARROW[name].get("pool_time", True) else T
    assert got[0].shape == (B, frames, 6) and got[1].shape == (B, frames, 18)


def _jax_train_float64(jmodule, variables, x, cot):
    def f(params):
        (sed, doa), mut = jmodule.apply({"params": params,
                                         "batch_stats": variables["batch_stats"]},
                                        x, deterministic=False, mutable=["batch_stats"])
        return jnp.sum(sed * cot[0]) + jnp.sum(doa * cot[1]), ((sed, doa), mut)

    with jax.enable_x64(True), _float64_carries():
        variables = _float64(variables)
        x = jnp.asarray(_float64(x))
        cot = [jnp.asarray(_float64(c)) for c in cot]
        (_, (outs, mut)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            variables["params"])
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), (outs, mut, grads))


@pytest.mark.parametrize("name", sorted(NARROW))
def test_train_mode_matches_jax_in_float64(name):
    jmodule, pmodule, variables, x = drawn(name)
    pmodule.train()
    got = pmodule(torch.from_numpy(x))
    rng = np.random.RandomState(7)
    cot = [rng.randn(*g.shape).astype(np.float32) for g in got]
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cot)).backward()
    outs, mut, grads = _jax_train_float64(jmodule, variables, x, cot)
    for g, w in zip(got, outs):
        assert float(np.abs(g.detach().numpy() - w).max()) <= GRAD_TOL * float(np.abs(w).max())
    named = lambda tree: dict(tree_leaves_with_names(tree))  # noqa: E731
    sd = dict(pmodule.state_dict())
    sd.update({k: p.grad for k, p in pmodule.named_parameters()})
    got_grads, want_grads = named(convert.seldnet_variables(sd, pmodule)["params"]), named(grads)
    largest = max(float(np.abs(w).max()) for w in want_grads.values())
    for i in range(len(pmodule.convs)):  # each conv bias feeds a train-mode BatchNorm
        leaf = f"conv_{i}/bias"
        assert max(np.abs(got_grads.pop(leaf)).max(), np.abs(want_grads.pop(leaf)).max()) \
            <= GRAD_TOL * largest, leaf
    assert_leaves_close(got_grads, want_grads, GRAD_TOL, name)
    moved = convert.seldnet_variables(pmodule.state_dict(), pmodule)["batch_stats"]
    assert_leaves_close(named(moved), named(mut["batch_stats"]), GRAD_TOL, name)


def test_feature_order_is_channel_major():
    """The GRU reads (C, F') channel-major per frame, as the JAX reshape of
    (B, T, C, F): the same weights over a frequency-major flatten give other
    outputs (test_eval_forward_matches_jax holds the channel-major one)."""
    _, pmodule, _, x = drawn("vanilla")
    pmodule.eval()
    with torch.no_grad():
        y = torch.from_numpy(x)
        for conv, bn, pool in zip(pmodule.convs, pmodule.bns, pmodule.pools):
            y = torch.nn.functional.max_pool2d(torch.relu(bn(conv(y))), pool, stride=pool)
        b, c, f, t = y.shape
        y = y.permute(0, 3, 2, 1).reshape(b, t, f * c)
        for layer in pmodule.rnns:
            y = layer(y)
        sed = torch.sigmoid(pmodule.sed(y))
        assert not torch.allclose(sed, pmodule(torch.from_numpy(x))[0], atol=1e-3)


class _FlaxBiGRU(fnn.Module):
    hidden: int

    @fnn.compact
    def __call__(self, x):
        return fnn.Bidirectional(fnn.RNN(fnn.GRUCell(self.hidden)),
                                 fnn.RNN(fnn.GRUCell(self.hidden)))(x)


def test_bigru_matches_flax_bidirectional_gru():
    port = rnn.BiGRU(4, 6)

    def to_vars(sd):
        return {"params": {"GRUCell_0": convert.gru_variables(sd, "fwd."),
                           "GRUCell_1": convert.gru_variables(sd, "bwd.")}}

    def to_state(v):
        return {**convert.gru_state(v["params"]["GRUCell_0"], "fwd."),
                **convert.gru_state(v["params"]["GRUCell_1"], "bwd.")}

    variables = port_drawn(port, 3, to_vars, to_state)
    x = np.random.RandomState(3).randn(3, 9, 4).astype(np.float32)
    want_tree = jax.eval_shape(lambda k: _FlaxBiGRU(6).init(k, jnp.asarray(x)),
                               jax.random.PRNGKey(0))
    assert_same_tree(variables, dict(want_tree))
    cot = np.random.RandomState(4).randn(3, 9, 12).astype(np.float32)

    def loss(params, x):
        y = _FlaxBiGRU(6).apply({"params": params}, x)
        return jnp.sum(y * cot), y

    (_, want), (jgrad, jdx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port.train()(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=RTOL)
    (got * torch.from_numpy(cot)).sum().backward()
    named = lambda tree: dict(tree_leaves_with_names(tree))  # noqa: E731
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert_leaves_close(named(to_vars(grads)["params"]), named(jgrad), GRAD_TOL, "bigru")
    assert_leaves_close({"x": xt.grad}, {"x": jdx}, GRAD_TOL, "bigru dx")
    # the backward direction reads the sequence reversed: its output at the
    # last frame depends on that frame alone
    with torch.no_grad():
        cut = port(xt[:, -1:].detach())
    np.testing.assert_allclose(got[:, -1, 6:].detach().numpy(), cut[:, 0, 6:].numpy(),
                               rtol=RTOL, atol=RTOL)
