"""The port's speech enhancement (``speechlid_tpu_torch/models/{rnn,se}.py``,
``tasks/se.py``, ``cli/main_extras.py se``, ``cli/test_lid.py --se-ckpt``,
``/se`` in ``cli/serve.py``) against the JAX package's on the CPU.

Weights are flax's initial distributions drawn on the port's side and
moved by N(0, 0.05²) per entry (``torch_parity.port_drawn``,
``perturbed``), converted by ``convert.se_variables``; the round trip
holds that tree to the JAX init's (``jax.eval_shape``).
Tolerances, each relative to the largest entry of the JAX result:

- flax's bidirectional ``OptimizedLSTMCell`` against ``models/rnn.BiLSTM``:
  1e-5 on every frame without ``lengths``, and on the valid frames with
  them (flax leaves values at padded frames, the port zeros);
- the DPRNN's decoder (flax's unflipped ``ConvTranspose``) 1e-5, and
  without the tap flip it is off by more than 10 %;
- ``DPRNNEnhancer`` forward 1e-5 (2.7e-7 absolute seen); ``si_snr`` 1e-5;
  ``SETask``'s loss 1e-5 and every parameter gradient 1e-4 of its leaf's
  largest entry, for ``si_snr`` and ``l1``;
- fresh parameters drawn as flax draws them (per leaf: names, shapes,
  constants exact, standard deviations within 10 %, recurrent kernels
  orthogonal per gate, PReLU 0.01 in ``test_torch_fasnet.py``);
- a JAX ``SETask`` checkpoint through the port's ``build_se_fn``, through
  ``cli.test_lid --se-ckpt`` and through ``/se`` enhances as the JAX
  task's ``make_enhance_fn`` on the weights the JAX reader restores, within
  1e-5."""

import contextlib
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speechlid_tpu_torch.eval as port_eval
from speechlid_tpu.core.checkpoint import load_checkpoint as jax_load_checkpoint
from speechlid_tpu.core.checkpoint import save_checkpoint
from speechlid_tpu.models import se as jse
from speechlid_tpu.tasks.se import SETask as JaxSETask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.cli import main_extras, serve, test_lid
from speechlid_tpu_torch.models import rnn, se
from speechlid_tpu_torch.models.init import TRUNCATED_NORMAL_STD
from speechlid_tpu_torch.tasks.se import SETask
from tests.test_torch_test_lid import _base, world  # noqa: F401
from tests.torch_parity import (  # noqa: F401
    assert_leaves_close,
    assert_same_tree,
    one_thread,
    port_drawn,
    tree_leaves_with_names,
)

pytestmark = pytest.mark.usefixtures("one_thread")

SR = 16000
TINY = dict(enc_dim=16, win=16, chunk=20, n_blocks=2, hidden=8)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def tones(n, t, seed, noise=0.3):
    """(noisy, clean): sine tones plus white noise, as the JAX SE tests."""
    rng = np.random.RandomState(seed)
    time = np.arange(t) / SR
    clean = 0.5 * np.stack([np.sin(2 * np.pi * (200 + 50 * i) * time) for i in range(n)])
    noisy = clean + noise * rng.randn(n, t)
    return noisy.astype(np.float32), clean.astype(np.float32)


def se_pair(hp, seed=0):
    """(JAX SETask, numpy variables, port SETask on the CPU), same weights,
    drawn on the port's side (``torch_parity.port_drawn``)."""
    ptask = SETask(**hp, device="cpu")
    variables = port_drawn(ptask.model, seed, convert.se_variables, convert.se_state)
    return JaxSETask(**hp), variables, ptask


def jax_apply(jtask, variables, noisy):
    return np.asarray(jax.jit(jtask._apply)(variables, jnp.asarray(noisy)))


def _close(got, want, tol=FWD_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))
    return err


class _FlaxBiLSTM(fnn.Module):
    hidden: int

    @fnn.compact
    def __call__(self, x, lengths=None):
        return fnn.Bidirectional(fnn.RNN(fnn.OptimizedLSTMCell(self.hidden)),
                                 fnn.RNN(fnn.OptimizedLSTMCell(self.hidden)))(
            x, seq_lengths=lengths)


def _bilstm_variables(state):
    return {"params": {cell: convert.lstm_variables(state, prefix)
                       for cell, prefix in zip(("OptimizedLSTMCell_0", "OptimizedLSTMCell_1"),
                                               ("fwd.", "bwd."))}}


def _bilstm_state(variables):
    p = variables["params"]
    return {**convert.lstm_state(p["OptimizedLSTMCell_0"], "fwd."),
            **convert.lstm_state(p["OptimizedLSTMCell_1"], "bwd.")}


@pytest.mark.parametrize("with_lengths", [False, True], ids=["full", "lengths"])
def test_bilstm_matches_flax(with_lengths):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 11, 5).astype(np.float32)
    lengths = np.array([11, 7, 1], np.int32) if with_lengths else None
    jm = _FlaxBiLSTM(6)
    port = rnn.BiLSTM(5, 6)
    variables = port_drawn(port, 1, _bilstm_variables, _bilstm_state)
    assert_same_tree(variables, jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, lengths))
    p = variables["params"]
    want = np.asarray(jm.apply(variables, x, lengths))
    got = port(torch.from_numpy(x), None if lengths is None else torch.from_numpy(lengths))
    got = got.detach().numpy()
    if lengths is None:
        _close(got, want)
        return
    valid = np.arange(11)[None, :] < lengths[:, None]
    _close(got[valid], want[valid])
    assert np.all(got[~valid] == 0)  # flax leaves values there; the port zeros
    assert np.abs(want[~valid]).max() > 1e-3
    # the state dict round-trips to flax's eight leaves a direction
    back = convert.lstm_variables(port.state_dict(), "fwd.")
    for name, leaf in tree_leaves_with_names(back):
        np.testing.assert_array_equal(leaf, _take_path(p["OptimizedLSTMCell_0"], name))


def _take_path(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return np.asarray(tree)


def test_decoder_is_flax_conv_transpose_with_its_taps_flipped():
    _, variables, ptask = se_pair(TINY)
    x = np.random.RandomState(2).randn(2, 37, TINY["enc_dim"]).astype(np.float32)
    want = fnn.ConvTranspose(1, (16,), strides=(8,), padding="VALID").apply(
        {"params": variables["params"]["decoder"]}, x)[:, :, 0]
    dec = ptask.model.decoder
    got = dec(torch.from_numpy(x).transpose(1, 2))[:, 0]
    assert got.shape == want.shape == (2, (37 + 1) * 8)
    _close(got, want)
    unflipped = torch.nn.functional.conv_transpose1d(
        torch.from_numpy(x).transpose(1, 2), dec.weight.flip(-1), dec.bias, stride=8)[:, 0]
    assert float((unflipped - torch.from_numpy(np.asarray(want))).abs().max()) > 0.1 * float(
        np.abs(want).max())


@pytest.mark.parametrize("t", [1234, 23])
def test_dprnn_forward_matches_jax(t):
    """A wave that ends inside a frame and a chunk, and one shorter than a chunk."""
    jtask, variables, ptask = se_pair(TINY)
    noisy, _ = tones(2, t, 3)
    want = jax_apply(jtask, variables, noisy)
    with torch.no_grad():
        _close(ptask._apply(torch.from_numpy(noisy)), want)


def test_si_snr_matches_jax():
    noisy, clean = tones(3, 2000, 4)
    _close(se.si_snr(torch.from_numpy(noisy), torch.from_numpy(clean)),
           jse.si_snr(jnp.asarray(noisy), jnp.asarray(clean)))
    x = torch.from_numpy(clean)
    assert torch.all(se.si_snr(x, x) > 50)


@pytest.mark.parametrize("loss_type", ["si_snr", "l1"])
def test_task_loss_and_gradients_match_jax(loss_type):
    hp = dict(TINY, loss_type=loss_type)
    jtask, variables, ptask = se_pair(hp)
    noisy, clean = tones(2, 1500, 6)

    def loss_fn(params):
        est = jtask._apply({"params": params}, jnp.asarray(noisy))
        return jtask._loss(est, jnp.asarray(clean)), est

    (want_loss, est), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    ptask.model.train()
    loss, metrics = ptask.train_loop({"noisy": torch.from_numpy(noisy),
                                      "clean": torch.from_numpy(clean)})
    loss.backward()
    _close(loss, want_loss)
    assert abs(float(metrics["si_snr"]) - float(np.mean(jse.si_snr(
        est, jnp.asarray(clean))))) <= 1e-3
    want = convert.se_state({"params": jax.tree_util.tree_map(np.asarray, grads)})
    got = {n: p.grad for n, p in ptask.model.named_parameters()}
    if loss_type == "si_snr":
        # SI-SNR removes the mean, so the decoder's bias (a constant offset)
        # has a true gradient of 0: both sides hold rounding noise there,
        # held to the largest gradient of all
        largest = max(float(np.abs(g).max()) for g in want.values())
        assert float(got.pop("decoder.bias").abs().max()) <= GRAD_TOL * largest
        assert float(np.abs(want.pop("decoder.bias")).max()) <= GRAD_TOL * largest
    assert_leaves_close(got, want, GRAD_TOL, loss_type)
    val = ptask.val_loop({"noisy": torch.from_numpy(noisy), "clean": torch.from_numpy(clean)})
    _close(val["loss"], want_loss)


def test_convert_round_trip_and_hyper_parameters():
    jtask, variables, ptask = se_pair(TINY)
    noisy, _ = tones(1, 400, 0)
    assert_same_tree(variables, jax.eval_shape(
        lambda k: jtask.init_variables(k, {"noisy": noisy}), jax.random.PRNGKey(0)))
    back = convert.se_variables(ptask.model.state_dict())
    a = tree_leaves_with_names(back["params"])
    b = tree_leaves_with_names(variables["params"])
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert ptask.hyper_parameters == jtask.hyper_parameters
    assert SETask(lr=3e-4, device="cpu").hyper_parameters == JaxSETask(lr=3e-4).hyper_parameters
    with pytest.raises(ValueError, match="model_type"):
        SETask(model_type="fasnet_origin", device="cpu")


CONSTANT_LEAVES = {"bias": 0.0, "scale": 1.0, "negative_slope": 0.01}


def _check_like_flax(got, want):
    """Per leaf, a port draw against flax's initializers: the names and
    shapes of ``want`` (a flax draw, or ``jax.eval_shape`` of one), biases
    0, scales 1, PReLU slopes 0.01 (exactly, and equal to flax's draw where
    it is given); recurrent kernels ``hi/hf/hg/ho`` orthogonal; the other
    kernels ``lecun_normal``, cut at 2σ, with a standard deviation within
    10 % of 1/√fan_in for leaves of ≥ 2048 entries (flax's too, where
    given).  → the kinds of leaf seen."""
    a, b = tree_leaves_with_names(got), tree_leaves_with_names(want)
    assert [n for n, _ in a] == [n for n, _ in b]
    kinds = set()
    for (name, x), (_, y) in zip(a, b):
        drawn = isinstance(y, np.ndarray)
        assert x.shape == tuple(y.shape), name
        leaf = name.split("/")[-1]
        if leaf in CONSTANT_LEAVES:
            np.testing.assert_array_equal(x, np.full(x.shape, CONSTANT_LEAVES[leaf], np.float32),
                                          err_msg=name)
            if drawn:
                np.testing.assert_array_equal(x, y, err_msg=name)
            kinds.add("constant")
            continue
        assert leaf == "kernel", name
        if name.split("/")[-2] in ("hi", "hf", "hg", "ho"):  # orthogonal (H, H)
            for k in (x, y) if drawn else (x,):
                np.testing.assert_allclose(k.T @ k, np.eye(k.shape[0]), atol=1e-5, err_msg=name)
            kinds.add("orthogonal")
            continue
        intended = np.sqrt(1.0 / np.prod(y.shape[:-1]))
        sigma = intended / TRUNCATED_NORMAL_STD
        assert np.abs(x).max() <= 2 * sigma * (1 + 1e-6), name
        if x.size >= 2048:
            for k in (x, y) if drawn else (x,):
                assert abs(k.std() / intended - 1) < 0.10, (name, k.std(), intended)
        kinds.add("lecun")
    return kinds


def test_fresh_parameters_drawn_like_flax():
    """At ``SETask``'s widths, the DPRNN the JAX ``main_extras se`` trains,
    with one of its two dual-path blocks (both draw alike)."""
    noisy, _ = tones(1, 1600, 0)
    init = jax.jit(lambda k: JaxSETask(n_blocks=1).init_variables(k, {"noisy": noisy}))
    want = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))  # flax's own draw
    task = SETask(n_blocks=1, device="cpu")
    task.init_parameters(torch.Generator().manual_seed(0))
    got = convert.se_variables(task.model.state_dict())
    assert _check_like_flax(got["params"], want["params"]) == {"constant", "orthogonal", "lecun"}
    again = SETask(n_blocks=1, device="cpu")
    again.init_parameters(torch.Generator().manual_seed(0))
    for (n, p), (_, q) in zip(task.model.named_parameters(), again.model.named_parameters()):
        assert torch.equal(p, q), n


@pytest.fixture(scope="module")
def jax_se_ckpt(tmp_path_factory):
    """A JAX ``SETask`` checkpoint (msgpack, as the JAX trainer writes) and
    the JAX package's enhance hook on the weights its reader restores (as
    ``build_se_fn`` makes it, without its template init)."""
    root = tmp_path_factory.mktemp("torch_se")
    jtask, variables, _ = se_pair(TINY)
    path = str(root / "se.ckpt")
    save_checkpoint(path, {"params": variables["params"]},
                    {"hyper_parameters": jtask.hyper_parameters, "epoch": 0})
    payload = jax_load_checkpoint(path)
    jax_task = JaxSETask(**payload["meta"]["hyper_parameters"])
    return path, jax_task.make_enhance_fn({"params": payload["state"]["params"]})


def test_jax_checkpoint_through_build_se_fn(jax_se_ckpt):
    path, jax_fn = jax_se_ckpt
    wav = tones(1, 5000, 8)[0][0]
    port_fn = serve.build_se_fn(path, device="cpu")
    out = port_fn(wav)
    assert out.shape == wav.shape and out.dtype == np.float32
    _close(out, jax_fn(wav))
    task, _ = SETask.resume_from_checkpoint(path, device="cpu")
    assert task.hyper_parameters == JaxSETask(**TINY).hyper_parameters


def test_eval_cli_se_ckpt_and_factor_sweep(world, jax_se_ckpt, tmp_path, monkeypatch):  # noqa: F811
    """``--se-ckpt`` (a JAX checkpoint) with ``--factor-sweep 0:1:0.5``: the
    evaluator gets the JAX model's enhancement, called on every utterance
    of the cells with a factor above 0, and factor 0 scores as the run
    without SE does."""
    path, jax_fn = jax_se_ckpt
    built = []

    class Recording(port_eval.LidEvaluator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if self.enhance_fn is not None:
                inner = self.enhance_fn
                calls = []

                def enhance(w):
                    calls.append(len(w))
                    return inner(w)

                self.enhance_fn, self.calls = enhance, calls
            built.append(self)

    monkeypatch.setattr(port_eval, "LidEvaluator", Recording)
    cell = ["--snr", "5", "--noise", "white", "--noise-dir", str(world["root"] / "noise")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = test_lid.main(_base(world, *cell, "--se-ckpt", path, "--factor-sweep", "0:1:0.5",
                                   "--csv", str(tmp_path / "f.jsonl"), "--device", "cpu"))
    assert [r["factor"] for r in rows] == [0.0, 0.5, 1.0]
    assert [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")] == rows
    ev = built[-1]
    assert len(ev.calls) == 2 * rows[0]["n_utts"] and len(set(ev.calls)) <= 2  # bucket rows
    wav = tones(1, ev.calls[0], 9)[0][0]
    _close(ev.enhance_fn(wav), jax_fn(wav))
    # factor 0 is the run without SE: same noise draws, the same numbers
    plain = test_lid.main(_base(world, *cell, "--device", "cpu"))
    for key in ("acc", "eer", "cavg", "eer_true", "cavg_true", "cer", "n_utts"):
        assert rows[0][key] == plain[key], key
    single = test_lid.main(_base(world, *cell, "--se-ckpt", path, "--factor", "0.5",
                                 "--device", "cpu"))
    assert single["n_utts"] == rows[1]["n_utts"] and len(built[-1].calls) == single["n_utts"]


def test_main_extras_se_trains_and_writes_a_checkpoint(tmp_path):
    noisy, clean = tones(10, 2400, 10)
    data = tmp_path / "pairs.npz"
    np.savez(data, noisy=noisy, clean=clean)
    trainer = main_extras.main(["se", "--data", str(data), "--epochs", "2", "--batch-size", "3",
                                "--device", "cpu", "--no-progress",
                                "--ckpt-dir", str(tmp_path / "ckpt")])
    assert trainer.global_step == 2 * 3  # 9 training utterances in batches of 3
    task, ckpt = SETask.resume_from_checkpoint(str(tmp_path / "ckpt" / "last.ckpt"),
                                               device="cpu")
    for name, p in trainer.module.model.state_dict().items():
        assert torch.equal(p, task.model.state_dict()[name]), name
    assert ckpt["hyper_parameters"] == JaxSETask(lr=1e-3).hyper_parameters
    # the other subcommands are ported (tests/test_torch_extras_tasks.py); each
    # still refuses an option it does not take
    for cmd in ("lm", "rml", "spec_pred", "image"):
        with pytest.raises(SystemExit):
            main_extras.main([cmd, "--no-such-option"])


def test_serve_se_pads_to_the_bucket_and_trims(jax_se_ckpt):
    path, jax_fn = jax_se_ckpt
    se_fn = serve.build_se_fn(path, device="cpu")
    state = serve.InferenceState(None, buckets_s=(0.25, 0.5), se_fn=se_fn)
    state.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        wav = tones(1, 3000, 11)[0][0]
        req = urllib.request.Request(url + "/se", data=wav.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = np.frombuffer(resp.read(), np.float32)
        assert out.shape == wav.shape
        padded, n = state.pad(wav)
        assert n == len(wav) and padded.shape == (1, 4000)
        np.testing.assert_array_equal(out, se_fn(padded[0])[:n])
        _close(out, jax_fn(padded[0])[:n])
        np.testing.assert_array_equal(serve.http_enhance_client(url + "/se")(wav), out)
        with pytest.raises(urllib.error.HTTPError) as err:  # no LID model loaded
            urllib.request.urlopen(urllib.request.Request(url + "/lid", data=wav.tobytes(),
                                                          method="POST"), timeout=60)
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
    with pytest.raises(SystemExit):
        serve.main([])
