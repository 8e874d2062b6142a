"""The port's secondary-task models (``speechlid_tpu_torch/models/extras.py``,
the ``GRU`` of ``models/rnn.py``) against the JAX package's on the CPU.

Weights are flax's initial distributions drawn on the port's side and moved
by N(0, 0.05²) per entry (``torch_parity.port_drawn``), carried across by
``convert.extras_variables`` / ``extras_state``; the round trip holds that
tree to the JAX init's (``jax.eval_shape``).  Tolerances:

- every eval forward within 1e-5 relative and 1e-4 absolute of JAX's
  (``rtol``/``atol`` of ``np.testing.assert_allclose``); the bidirectional
  LM on its valid frames only (flax leaves values at padded frames, the
  port's packed LSTM zeros);
- flax's ``nn.RNN(nn.GRUCell)`` against ``rnn.GRU``: forward 1e-5 and every
  gradient 1e-4 of its leaf's largest entry;
- ``ResNet1D`` in training mode (batch statistics, dropout 0) and the
  recurrent models: the output, the moved BatchNorm statistics and every
  parameter gradient of Σ out·c within 1e-4 of the leaf's largest entry of
  the JAX model run in float64 (``jax.enable_x64``), the port in float32, as
  the classifier zoo's tests hold its train-mode ResNets; a conv bias whose
  only way out is a train-mode BatchNorm has a true gradient of zero
  (:func:`zero_grad_leaves`): both sides within 1e-4 of the largest
  gradient entry of any leaf;
- fresh parameters (``models/init.py``) per model: the JAX init's leaf names
  and shapes, its constants exactly, and each drawn leaf of 256 entries or
  more with a standard deviation within 10 % of the JAX draw's.
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import extras as jextras
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import extras as pextras
from speechlid_tpu_torch.models import rnn
from speechlid_tpu_torch.models.init import init_like_flax_
from tests.torch_parity import (  # noqa: F401
    assert_leaves_close,
    assert_same_tree,
    one_thread,
    port_drawn,
    tree_leaves_with_names,
)

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL, ATOL = 1e-5, 1e-4
GRAD_TOL = 1e-4
B = 3
IDS_T, VOCAB = 7, 13
LENGTHS = np.array([7, 4, 2], np.int32)
IQ_T = 37  # odd: the 'SAME' max-pool pads the right
WIN, D = 8, 3


def ids(seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, IDS_T)).astype(np.int32)


def floats(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# name → (JAX module, port module, inputs, port forward keyword: whether the
# JAX module reads lengths)
def _cases():
    return {
        "base_cnn": (jextras.BaseCNN(num_classes=4), pextras.BaseCNN(num_classes=4),
                     (floats(B, 8, 8, 1),)),
        "lstm_lm": (jextras.LSTMLM(VOCAB, 6, 5), pextras.LSTMLM(VOCAB, 6, 5),
                    (ids(), LENGTHS)),
        "bilstm_lm": (jextras.LSTMLM(VOCAB, 6, 5, num_layers=2, bidirectional=True),
                      pextras.LSTMLM(VOCAB, 6, 5, num_layers=2, bidirectional=True),
                      (ids(), LENGTHS)),
        "resnet1d": (jextras.ResNet1D(n_classes=4, base_filters=4, kernel_size=16, n_blocks=5),
                     pextras.ResNet1D(n_classes=4, base_filters=4, kernel_size=16, n_blocks=5),
                     (floats(B, IQ_T, 2),)),
        "resnet1d_rnn_snr": (
            jextras.ResNet1D(n_classes=4, base_filters=4, kernel_size=16, n_blocks=5,
                             use_rnn=True, use_snr_head=True),
            pextras.ResNet1D(n_classes=4, base_filters=4, kernel_size=16, n_blocks=5,
                             use_rnn=True, use_snr_head=True),
            (floats(B, IQ_T, 2),)),
        "mlp": (jextras.ForecastMLP(out_dim=D, hidden=5),
                pextras.ForecastMLP(D, D, WIN, hidden=5), (floats(B, WIN, D),)),
        "lstm": (jextras.ForecastLSTM(out_dim=D, hidden=5, num_layers=2),
                 pextras.ForecastLSTM(D, D, hidden=5, num_layers=2), (floats(B, WIN, D),)),
        "cnn_lstm": (jextras.ForecastCnnLSTM(out_dim=D, hidden=5),
                     pextras.ForecastCnnLSTM(D, D, hidden=5), (floats(B, WIN, D),)),
        "causal_conv": (jextras.ForecastTCN(out_dim=D, channels=(4, 4, 6)),
                        pextras.ForecastTCN(D, D, channels=(4, 4, 6)), (floats(B, WIN, D),)),
        "transformer": (jextras.ForecastTransformer(out_dim=D, d_model=8, heads=2, layers=2),
                        pextras.ForecastTransformer(D, D, WIN, d_model=8, heads=2, layers=2),
                        (floats(B, WIN, D),)),
    }


CASES = _cases()
RECURRENT = ("lstm_lm", "bilstm_lm", "lstm", "cnn_lstm", "resnet1d_rnn_snr")


def drawn(name, seed=0):
    """(JAX module, port module with the converted weights, numpy variables,
    inputs)."""
    jmodule, pmodule, args = _cases()[name]
    variables = port_drawn(pmodule, seed, lambda sd: convert.extras_variables(sd, pmodule),
                           lambda v: convert.extras_state(v, pmodule))
    return jmodule, pmodule, variables, args


def port_forward(pmodule, args):
    tensors = [torch.from_numpy(a) for a in args]
    if isinstance(pmodule, pextras.LSTMLM):
        return pmodule(*tensors)
    return pmodule(tensors[0])


def _outs(out):
    return list(out) if isinstance(out, tuple) else [out]


def valid_frames(name, out):
    """The bidirectional LM's valid frames only."""
    if name != "bilstm_lm":
        return out
    return np.concatenate([np.asarray(out)[b, :n] for b, n in enumerate(LENGTHS)])


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_tree_is_the_jax_init(name):
    jmodule, pmodule, variables, args = drawn(name)
    want = jax.eval_shape(lambda k: jmodule.init(k, *map(jnp.asarray, args)),
                          jax.random.PRNGKey(0))
    assert_same_tree(variables, dict(want))
    back = convert.extras_state(variables, pmodule)
    for key, value in pmodule.state_dict().items():
        if key in back:
            np.testing.assert_array_equal(back[key], value.numpy(), err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_forward_matches_jax(name):
    jmodule, pmodule, variables, args = drawn(name)
    want = _outs(jax.jit(lambda v, *a: jmodule.apply(v, *a))(variables, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = _outs(port_forward(pmodule.eval(), args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(valid_frames(name, g.numpy()), valid_frames(name, w),
                                   rtol=RTOL, atol=ATOL)


def test_base_cnn_flattens_channels_last():
    """The first Dense reads flax's NHWC rows: the port's channels-last
    permute is what makes the forward agree (test_eval_forward_matches_jax);
    flattened channel-first, the same weights give other logits."""
    _, pmodule, _, args = drawn("base_cnn")
    x = torch.from_numpy(args[0])
    with torch.no_grad():
        y = x.permute(0, 3, 1, 2)
        for conv in (pmodule.conv1, pmodule.conv2):
            y = torch.nn.functional.max_pool2d(torch.relu(conv(y)), 2, 2)
        nchw = pmodule.fc2(torch.relu(pmodule.fc1(y.flatten(1))))
        assert not torch.allclose(nchw, pmodule.eval()(x), atol=1e-3)


def test_same_padding_is_xla_s():
    # k 16 at stride 2 over 37 frames: out 19, total (19 - 1)·2 + 16 − 37 = 15
    assert pextras.same_pad(37, 16, 2) == (7, 8)
    assert pextras.same_pad(36, 16, 2) == (7, 7)
    assert pextras.same_pad(10, 3) == (1, 1)
    assert pextras.same_pad(4, 1, 2) == (0, 0)


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


@contextlib.contextmanager
def _float64_carries():
    """flax's cells start their carry in ``param_dtype`` (float32) whatever
    the input's dtype; in float64 the scan needs a float64 carry."""
    originals = {cls: cls.initialize_carry for cls in (fnn.OptimizedLSTMCell, fnn.GRUCell)}

    def float64_carry(original):
        def initialize_carry(self, rng, input_shape):
            return jax.tree_util.tree_map(lambda c: c.astype(jnp.float64),
                                          original(self, rng, input_shape))
        return initialize_carry

    for cls, original in originals.items():
        cls.initialize_carry = float64_carry(original)
    try:
        yield
    finally:
        for cls, original in originals.items():
            cls.initialize_carry = original


def _jax_train_float64(jmodule, variables, args, cot):
    """(outputs, moved batch_stats, parameter gradients of Σ out·cot) of the
    JAX module in training mode, run in float64; → float32 numpy."""
    stats = variables.get("batch_stats")

    def f(params):
        v = {"params": params, **({"batch_stats": stats} if stats else {})}
        kwargs = {} if isinstance(jmodule, jextras.LSTMLM) else {"train": True}
        if stats:
            out, mut = jmodule.apply(v, *args, **kwargs, mutable=["batch_stats"])
        else:
            out, mut = jmodule.apply(v, *args, **kwargs), {}
        outs = _outs(out)
        loss = sum(jnp.sum(o * c) for o, c in zip(outs, cot))
        return loss, (outs, mut)

    with jax.enable_x64(True), _float64_carries():
        variables = _float64(variables)
        stats = variables.get("batch_stats")
        args = tuple(jnp.asarray(_float64(a)) for a in args)
        cot = [jnp.asarray(_float64(c)) for c in cot]
        (_, (outs, mut)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            variables["params"])
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), (outs, mut, grads))


def zero_grad_leaves(pmodule):
    """The conv biases of a ``ResNet1D``: each reaches the loss only through
    train-mode BatchNorms, which remove any per-channel constant.  ``conv1``
    feeds ``bn2``; the stem and every ``conv2`` add to the residual stream,
    which reaches the head through the next ``bn1`` and ``bn_final`` only
    (the max-pool and the channel padding carry a constant through)."""
    if not isinstance(pmodule, pextras.ResNet1D):
        return []
    return ["stem/bias"] + [f"block_{i}/conv{j}/bias" for i in range(len(pmodule.blocks))
                            for j in (1, 2)]


def _port_grads(pmodule):
    """The parameters' gradients as a flax params tree (buffers as they are)."""
    sd = dict(pmodule.state_dict())
    for key, p in pmodule.named_parameters():
        sd[key] = p.grad
    return convert.extras_variables(sd, pmodule)["params"]


@pytest.mark.parametrize("name", ["resnet1d", *RECURRENT])
def test_train_step_matches_jax_in_float64(name):
    jmodule, pmodule, variables, args = drawn(name)
    if isinstance(jmodule, jextras.ResNet1D):  # the dropout draws differ: off on both sides
        jmodule = jmodule.clone(dropout=0.0)
        for m in pmodule.modules():
            if isinstance(m, pextras.Dropout):
                m.p = 0.0
    pmodule.train()
    got = _outs(port_forward(pmodule, args))
    cot = [floats(*g.shape, seed=7 + i) for i, g in enumerate(got)]
    if name == "bilstm_lm":  # the Dense sees flax's padded-frame values there: no gradient
        for b, n in enumerate(LENGTHS):
            cot[0][b, n:] = 0.0
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cot)).backward()
    outs, mut, grads = _jax_train_float64(jmodule, variables, args, cot)
    for g, w in zip(got, outs):
        g, w = valid_frames(name, g.detach().numpy()), valid_frames(name, w)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * float(np.abs(w).max())
    named = lambda tree: dict(tree_leaves_with_names(tree))
    got_grads, want_grads = named(_port_grads(pmodule)), named(grads)
    largest = max(float(np.abs(w).max()) for w in want_grads.values())
    for leaf in zero_grad_leaves(pmodule):
        assert max(np.abs(got_grads.pop(leaf)).max(), np.abs(want_grads.pop(leaf)).max()) \
            <= GRAD_TOL * largest, leaf
    assert_leaves_close(got_grads, want_grads, GRAD_TOL, name)
    if "batch_stats" in variables:
        moved = convert.extras_variables(pmodule.state_dict(), pmodule)["batch_stats"]
        assert_leaves_close(named(moved), named(mut["batch_stats"]), GRAD_TOL, name)


class _FlaxGRU(fnn.Module):
    hidden: int

    @fnn.compact
    def __call__(self, x):
        return fnn.RNN(fnn.GRUCell(self.hidden))(x)


def test_gru_matches_flax_gru_cell():
    port = rnn.GRU(4, 6)
    to_vars = lambda sd: {"params": {"GRUCell_0": convert.gru_variables(sd, "cell.")}}
    to_state = lambda v: convert.gru_state(v["params"]["GRUCell_0"], "cell.")
    variables = port_drawn(port, 3, to_vars, to_state)
    x = floats(B, 9, 4, seed=3)
    want_tree = jax.eval_shape(lambda k: _FlaxGRU(6).init(k, jnp.asarray(x)), jax.random.PRNGKey(0))
    assert_same_tree(variables, dict(want_tree))
    cot = floats(B, 9, 6, seed=4)

    def loss(params, x):
        y = _FlaxGRU(6).apply({"params": params}, x)
        return jnp.sum(y * cot), y

    (_, want), (jgrad, jdx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port.train()(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=RTOL)
    (got * torch.from_numpy(cot)).sum().backward()
    grads = {k: p.grad for k, p in port.named_parameters()}
    named = lambda tree: dict(tree_leaves_with_names(tree))
    assert_leaves_close(named(to_vars(grads)["params"]), named(jgrad), GRAD_TOL, "gru")
    assert_leaves_close({"x": xt.grad}, {"x": jdx}, GRAD_TOL, "gru dx")
    # b_hh's r and z blocks are a zero buffer, not a parameter
    assert sorted(dict(port.named_parameters())) == [
        "cell.bias_hn", "cell.bias_ih", "cell.weight_hh", "cell.weight_ih"]
    assert torch.equal(port.cell.flat_weights()[3][:12], torch.zeros(12))


# wider shapes for the statistics of the draws
INIT_CASES = {
    "base_cnn": (jextras.BaseCNN(), lambda: pextras.BaseCNN(), (floats(1, 8, 8, 1),)),
    "lstm_lm": (jextras.LSTMLM(300, 32, 32), lambda: pextras.LSTMLM(300, 32, 32),
                (ids()[:1], LENGTHS[:1])),
    "resnet1d_rnn_snr": (
        jextras.ResNet1D(n_classes=11, base_filters=16, kernel_size=16, n_blocks=5,
                         use_rnn=True, use_snr_head=True),
        lambda: pextras.ResNet1D(n_classes=11, base_filters=16, kernel_size=16, n_blocks=5,
                                 use_rnn=True, use_snr_head=True),
        (floats(1, 64, 2),)),
    "transformer": (jextras.ForecastTransformer(out_dim=16, d_model=32, heads=4, layers=1),
                    lambda: pextras.ForecastTransformer(16, 16, 32, d_model=32, heads=4, layers=1),
                    (floats(1, 32, 16),)),
    "cnn_lstm": (jextras.ForecastCnnLSTM(out_dim=16, hidden=32),
                 lambda: pextras.ForecastCnnLSTM(16, 16, hidden=32), (floats(1, 32, 16),)),
    "causal_conv": (jextras.ForecastTCN(out_dim=16, channels=(32, 32)),
                    lambda: pextras.ForecastTCN(16, 16, channels=(32, 32)), (floats(1, 32, 16),)),
    "mlp": (jextras.ForecastMLP(out_dim=16, hidden=64),
            lambda: pextras.ForecastMLP(16, 16, 32, hidden=64), (floats(1, 32, 16),)),
}


@pytest.mark.parametrize("name", sorted(INIT_CASES))
def test_fresh_parameters_drawn_like_flax(name):
    jmodule, make, args = INIT_CASES[name]
    pmodule = make()
    init_like_flax_(pmodule, torch.Generator().manual_seed(0))
    got = dict(tree_leaves_with_names(convert.extras_variables(pmodule.state_dict(), pmodule)))
    init = jax.jit(lambda key, *a: jmodule.init(key, *a))
    want = dict(tree_leaves_with_names(jax.tree_util.tree_map(
        np.asarray, dict(init(jax.random.PRNGKey(0), *map(jnp.asarray, args))))))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if np.all(w == w.flat[0]):  # a constant: zeros, ones
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif w.size >= 256:
            assert abs(g.std() / w.std() - 1.0) < 0.1, (key, g.std(), w.std())
