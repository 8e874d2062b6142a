"""The cross-entropy LID task (``tasks/lid_cross_entropy.py``) against the
JAX ``LidCrossEntropyTask`` on the CPU, weights carried across by
``convert.lid_ce_state``.

- ``train_loop``: the loss within 1e-4 and every gradient within 1e-4 of
  its leaf's largest entry, for ``linear``, ``resnet2`` and ``xvector2``
  (no dropout), and for ``xvector`` with the port's dropout given the
  keep-masks of the JAX run (captured test-side from its dropout outputs);
  SpecAugment off (each package draws its own masks).  For ``resnet2`` the
  gradients are held against the JAX model run in float64
  (``jax.enable_x64``) on its frontend's float32 features, the port in
  float32: JAX's own float32 gradients of
  the train-mode ResNet lie up to 1e-2 of a leaf's largest entry from its
  float64 sums (``tests/test_torch_classifier.py``); its float32 loss is
  held too.  The port's float32 gradients lie within 2e-4 of a leaf's
  largest entry from that float64 step (at most 1.08e-4, on 4 of the
  524288 entries of ``seg_1``'s kernel, after the train-mode BatchNorm of
  a batch of 3), so ``resnet2``'s gradients are held at 2e-4.  MHASTP's last bias ``att_b_1`` has a true gradient of zero
  (it shifts a softmax over time): both sides hold rounding noise there,
  held to 1e-4 of the largest gradient of all.  The batch holds a clip shorter than the TDNN receptive
  fields;
- ``val_loop``: loss and probabilities within 1e-4 for every back-end and
  for a WavLM upstream; ``val_loop_end``'s metrics equal to JAX's on the
  same probabilities, repeat-padded rows cut by ``n_valid``;
- ``freeze_upstream``: the frozen set equals the JAX mask (WavLM with
  ``last_hidden_state``, wav2vec2 with ``hidden_states``);
- ``init_like_flax_``: leaf shapes, constants and standard deviations
  against the JAX init, MHASTP's fan-in H·D_in included;
- ``convert``: both directions round-trip bit for bit, for every back-end
  and the SSL nesting."""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechlid_tpu.tasks.lid_cross_entropy import LidCrossEntropyTask as JaxCETask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models.classifier import TDNNLayerUnfold
from speechlid_tpu_torch.models.init import TRUNCATED_NORMAL_STD
from speechlid_tpu_torch.tasks.lid_cross_entropy import LidCrossEntropyTask
from tests.torch_parity import (  # noqa: F401
    TINY_SSL,
    W2V,
    one_thread,
    random_batch_stats,
    tree_leaves_with_names,
)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
RESNET_GRAD_TOL = 2e-4  # resnet2's gradients against JAX in float64 (docstring)
N_MELS = 16
BACKENDS = ("xvector", "linear", "resnet2", "xvector2")


def hparams(backend, **kw):
    return {**dict(num_classes=3, backend=backend, n_mels=N_MELS, mask_times=0, lr=1e-3,
                   schedule=None), **kw}


def ssl_hparams(featurizer, selection):
    conf = dict(TINY_SSL) if featurizer == "wavlm" else dict(W2V)
    return hparams("linear", featurizer=featurizer, ssl_config=conf,
                   feature_selection=selection)


def batch(seed=0):
    """Three ragged clips of at most 0.6 s; the last one's 7 fbank frames are
    fewer than the TDNN receptive fields (9 and 15 frames)."""
    rng = np.random.RandomState(seed)
    return {"wavs": (0.1 * rng.randn(3, 9600)).astype(np.float32),
            "wav_lengths": np.array([9600, 7001, 1000], np.int32),
            "langs": np.array([2, 0, 1], np.int32), "n_valid": np.int32(0),
            "texts": np.zeros((3, 4), np.int32), "text_lengths": np.ones(3, np.int32)}


def ce_pair(hp, seed=0):
    """(JAX task, numpy variables with random BatchNorm statistics, port
    task on the CPU with the converted weights)."""
    jtask = JaxCETask(**hp)
    variables = jtask.init_variables(jax.random.PRNGKey(seed), batch(seed))
    variables = (random_batch_stats(variables, seed) if "batch_stats" in variables
                 else jax.tree_util.tree_map(np.asarray, dict(variables)))
    ptask = LidCrossEntropyTask(**hp, device="cpu")
    convert.load_into(ptask.model, convert.lid_ce_state(variables))
    return jtask, variables, ptask


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


def jax_train_step(jtask, variables, b, float64):
    """(loss, gradients, dropout outputs by TDNN layer) of the JAX task's
    ``train_loop``; the dropout outputs of the same draw, captured."""
    rngs = {k: jax.random.PRNGKey(3) for k in jtask.rng_keys}
    stats = variables.get("batch_stats", {})

    def loss_fn(params, v_stats, jb):
        loss, _, _ = jtask.train_loop({"params": params, "batch_stats": v_stats}, jb, rngs)
        return loss

    def dropout_outputs(params, v_stats, jb):
        feats, f_len = jtask._model_inputs(jb["wavs"], jb["wav_lengths"], rngs=rngs)
        _, state = jtask.model.apply(
            {"params": params, "batch_stats": v_stats}, feats, f_len, train=True, rngs=rngs,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
        return state.get("intermediates", {})

    def loss_fn_on_features(params, v_stats, feats, f_len, langs):
        logits, _ = jtask.model.apply({"params": params, "batch_stats": v_stats}, feats, f_len,
                                      train=True, rngs=rngs, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, langs).mean()

    jb = {k: jnp.asarray(v) for k, v in b.items()}
    params = variables["params"]
    if float64:  # the model in float64 on the JAX frontend's float32 features
        feats, f_len = jtask._model_inputs(jb["wavs"], jb["wav_lengths"], rngs=rngs)
        with jax.enable_x64(True):
            loss, grads = jax.jit(jax.value_and_grad(loss_fn_on_features))(
                _float64(params), _float64(stats), jnp.asarray(np.asarray(feats), jnp.float64),
                f_len, jb["langs"])
            loss, grads = float(loss), jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), grads)
    else:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, stats, jb)
        loss, grads = float(loss), jax.tree_util.tree_map(np.asarray, grads)
    captured = jax.tree_util.tree_map(np.asarray, dropout_outputs(params, stats, jb))
    return loss, grads, captured


class _FixedKeep(torch.nn.Module):
    """Dropout with a given keep-mask (test-side): x · keep / (1 − p)."""

    def __init__(self, keep: np.ndarray, p: float):
        super().__init__()
        self.keep, self.p = torch.from_numpy(keep.astype(np.float32)), p

    def forward(self, x):
        return x * self.keep / (1.0 - self.p)


def port_train_step(ptask, b):
    ptask.set_generators(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    ptask.model.train()
    try:
        ptask.model.zero_grad()
        loss, metrics = ptask.train_loop(ptask.place_batch(b))
        loss.backward()
    finally:
        ptask.model.eval()
    state = dict(ptask.model.state_dict())
    for name, p in ptask.model.named_parameters():
        state[name] = p.grad.clone()
    ptask.model.zero_grad()
    return loss.item(), metrics, convert.lid_ce_variables(state)["params"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_train_loop_loss_and_gradients_match_jax(backend):
    jtask, variables, ptask = ce_pair(hparams(backend))
    b = batch(1)
    loss32, want, captured = jax_train_step(jtask, variables, b, float64=False)
    loss, want = loss32, want
    if backend == "resnet2":  # the JAX step's own float32 error (docstring)
        loss, want, _ = jax_train_step(jtask, variables, b, float64=True)
    if backend == "xvector":  # the JAX run's keep-masks, from its dropout outputs
        layers = captured["xvector"]
        for name, module in ptask.model.xvector.named_children():
            if isinstance(module, TDNNLayerUnfold):
                out = layers[name]["Dropout_0"]["__call__"][0]
                # an output of 0 is a dropped unit or a ReLU at 0: either
                # way the unit's output and gradient are 0 with either mask
                module.dropout = _FixedKeep(out != 0, module.dropout.p)
    got_loss, metrics, got = port_train_step(ptask, b)
    for ref in (loss, loss32):
        assert abs(got_loss - ref) <= TOL * max(abs(ref), 1.0), (got_loss, ref)
    assert 0.0 <= float(metrics["acc"]) <= 1.0
    a, w = tree_leaves_with_names(got), tree_leaves_with_names(want)
    assert [n for n, _ in a] == [n for n, _ in w]
    largest = max(float(np.abs(ref).max()) for _, ref in w)
    for (name, g), (_, ref) in zip(a, w):
        if name.endswith("att_b_1"):  # a true gradient of 0: rounding noise on both sides
            assert max(np.abs(g).max(), np.abs(ref).max()) <= TOL * largest, name
            continue
        scale = max(float(np.abs(ref).max()), 1e-6)
        tol = RESNET_GRAD_TOL if backend == "resnet2" else TOL
        np.testing.assert_allclose(g, ref, rtol=0, atol=tol * scale, err_msg=name)


def _port_val(ptask, b):
    out = ptask.val_loop(ptask.place_batch(b))
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}


@pytest.mark.parametrize("featurizer", ["fbank", "wavlm"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_val_loop_matches_jax(backend, featurizer):
    hp = hparams(backend)
    if featurizer != "fbank":
        hp.update(featurizer=featurizer, ssl_config=dict(TINY_SSL))
    jtask, variables, ptask = ce_pair(hp)
    b = batch(2)
    want = jax.jit(jtask.val_loop)(variables, {k: jnp.asarray(v) for k, v in b.items()})
    got = _port_val(ptask, b)
    assert abs(got["loss"] - float(want["loss"])) <= TOL * max(float(want["loss"]), 1.0)
    np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got["langs"], b["langs"])


def test_val_loop_end_metrics_equal_jax():
    """The same probabilities through both tasks' ``val_loop_end``: a full
    batch and a partial one repeat-padded to the batch size (``n_valid``)."""
    jtask, _, ptask = ce_pair(hparams("linear"))
    rng = np.random.RandomState(5)
    outputs = []
    for n_valid in (0, 3):
        probs = rng.dirichlet(np.ones(3), size=5).astype(np.float32)
        langs = rng.randint(0, 3, 5).astype(np.int32)
        if n_valid:  # the feeder repeats rows to fill a partial batch
            probs[n_valid:], langs[n_valid:] = probs[0], langs[0]
        outputs.append({"loss": float(rng.rand()), "probs": probs, "langs": langs,
                        "n_valid": n_valid})
    got = ptask.val_loop_end(outputs)
    want = jtask.val_loop_end(outputs)
    assert set(got) == set(want) == {"avg_val_loss", "val_acc", "eer", "cavg"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("featurizer,selection", [("wavlm", "last_hidden_state"),
                                                  ("wav2vec2", "hidden_states")])
@pytest.mark.parametrize("freeze", [True, False])
def test_freeze_upstream_matches_the_jax_mask(featurizer, selection, freeze):
    """The frozen set is the JAX mask carried across like the weights: every
    upstream parameter (the Featurizer's ``layer_weights`` included) with
    ``freeze_upstream``, none without."""
    hp = dict(ssl_hparams(featurizer, selection), freeze_upstream=freeze)
    jtask, variables, ptask = ce_pair(hp)
    jtask.trainer = types.SimpleNamespace(state=types.SimpleNamespace(params=variables["params"]))
    mask = jtask.before_train_loop(0)
    ptask.before_train_loop(0)
    frozen = {n for n, p in ptask.model.named_parameters() if not p.requires_grad}
    if not freeze:
        assert mask is None and not frozen
        return
    full = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m, np.float32), mask,
                                  variables["params"])
    want = {k for k, v in convert.lid_ce_state({"params": full}).items() if not v.any()}
    assert frozen == want
    assert any(n.endswith("layer_weights") for n in frozen) == (selection == "hidden_states")
    assert not any(n.startswith("classifier.") for n in frozen)


STD_TOL = 0.10
MIN_SIZE = 2048


@pytest.mark.parametrize("backend", BACKENDS)
def test_init_leaves_drawn_like_flax(backend):
    """Per leaf against the JAX task's ``init_variables``: the same names and
    shapes; constants exact (biases, BatchNorm scales and statistics); kernels
    truncated at ±2σ with σ from the fan-in (MHASTP's ``att_w_i``: H·D_in);
    standard deviations within 10 % for leaves of ≥ 2048 elements."""
    hp = hparams(backend, n_mels=80)
    want = jax.tree_util.tree_map(
        np.asarray, JaxCETask(**hp).init_variables(jax.random.PRNGKey(0), batch()))
    ptask = LidCrossEntropyTask(**hp, device="cpu")
    ptask.init_parameters(torch.Generator().manual_seed(0))
    got = convert.lid_ce_variables(ptask.model.state_dict())
    checked = {"std": 0, "att_w": 0}
    for kind in ("params", "batch_stats"):
        a, b = tree_leaves_with_names(got.get(kind, {})), tree_leaves_with_names(
            want.get(kind, {}))
        assert [n for n, _ in a] == [n for n, _ in b], kind
        for (name, x), (_, y) in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype == np.float32, name
            if np.all(y == y.reshape(-1)[0]):
                np.testing.assert_array_equal(x, y, err_msg=name)
                continue
            if "/att_w_" in name:  # (H, D_in, D_out): the head axis counts
                fan_in = y.shape[0] * y.shape[1]
                checked["att_w"] += 1
            else:
                assert name.endswith("/kernel"), name
                fan_in = int(np.prod(y.shape[:-1]))
            intended = np.sqrt(1.0 / fan_in)
            sigma = intended / TRUNCATED_NORMAL_STD
            for z in (x, y):
                assert np.abs(z).max() <= 2 * sigma * (1 + 1e-6), name
            if x.size >= MIN_SIZE:
                assert abs(x.std() / intended - 1) <= STD_TOL, (name, x.std(), intended)
                assert abs(x.std() / y.std() - 1) <= STD_TOL, (name, x.std(), y.std())
                checked["std"] += 1
    assert checked["std"] >= (0 if backend == "linear" else 3)
    assert checked["att_w"] == (4 if backend == "resnet2" else 0)  # 2 queries × 2 layers


@pytest.mark.parametrize("hp", [hparams(b) for b in BACKENDS]
                         + [ssl_hparams("wavlm", "last_hidden_state"),
                            ssl_hparams("wav2vec2", "hidden_states")],
                         ids=list(BACKENDS) + ["wavlm", "wav2vec2"])
def test_convert_round_trips_both_ways(hp):
    _, variables, ptask = ce_pair(hp)
    back = convert.lid_ce_variables(convert.lid_ce_state(variables))
    for kind in ("params", "batch_stats"):
        a = tree_leaves_with_names(back.get(kind, {}))
        b = tree_leaves_with_names(variables.get(kind, {}))
        assert [n for n, _ in a] == [n for n, _ in b], kind
        for (name, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
    sd = ptask.model.state_dict()
    again = convert.lid_ce_state(convert.lid_ce_variables(sd))
    assert set(again) == set(sd)
    for name, value in sd.items():
        np.testing.assert_array_equal(again[name], value.numpy(), err_msg=name)
