"""The joint LID+ASR task through the int8 engine
(``LidASRTask(quant_dot="int8" | "int8_ste")``) against the JAX task with
the same options, on the CPU, weights drawn on the port's side
(``tests/torch_parity.port_drawn``) with random BatchNorm statistics.

- ``infer`` in ``int8``, the Conformer and the WavLM featurizer (the latter
  with ``ssl_conv_impl="matmul"``, its extractor through the framed GEMM):
  the scores within ``SCORE_TOL`` of the largest and nearer JAX's int8
  scores than the port's own exact ones; ``pred_lang`` equal.  The int8
  products are bit-equal to JAX's at one layer
  (``tests/test_torch_quant.py``); the whole model is not, because a code
  whose input sits within a float32 ulp of a rounding boundary flips when
  the input differs by that ulp, and a flipped code moves its output by a
  step of its scale, which flips more codes downstream.  So the bar is
  JAX's own spread: JAX's int8 model run again on the wave moved by one
  float32 ulp (``np.nextafter``).  The featurizer's codes are counted
  against JAX's, layer for layer (captured with
  ``flax.linen.intercept_methods``): the port flips no more than
  ``SPREAD`` × the codes the one-ulp nudge flips in JAX (measured: the
  Conformer 10 against 10 of 147456, WavLM 15633 against 18327 of 1534080,
  most of them downstream of the extractor's GroupNorm).
- One ``int8_ste`` train step, float32 and bfloat16: the loss, the worst
  and the median gradient leaf (each of its leaf's largest JAX entry)
  within ``SPREAD`` × the distance of JAX's own step on the nudged wave.
- The hyper-parameters round trip: ``quant_dot`` and ``ssl_conv_impl``
  are the JAX task's, and a checkpoint's hyper-parameters rebuild the same
  int8 task.
- The JAX package's fault, copied: its WavLM config says "q/k/v/out +
  fc1/fc2", its code quantizes q/k/v/out and fc1 only; the port quantizes
  the same layers (``fc2``, ``grep_linear``, ``post_extract_proj`` exact),
  and in the Conformer the same ones as JAX (the subsampling's output
  projection exact).
- ``serve --quant int8`` through ``cli.serve.main`` on a port checkpoint:
  ``/stats`` names the engine and the answers are JAX's int8 scores.
  ``test_lid --quant int8`` is held in ``tests/test_torch_test_lid.py``,
  ``main_lid`` on ``configs/lid_wavlm_qat.yaml`` in
  ``tests/test_torch_cli.py``."""

import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.cli import serve
from speechlid_tpu_torch.core.checkpoint import save_checkpoint
from speechlid_tpu_torch.models.conformer import Linear
from speechlid_tpu_torch.ops import quant
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.torch_parity import (  # noqa: F401
    TINY_SSL,
    one_thread,
    port_drawn,
    random_batch_stats,
    tree_leaves_with_names,
)

pytestmark = pytest.mark.usefixtures("one_thread")

SR = 16000
# scores, of the largest JAX int8 score (measured: conformer 1.9e-4 against
# 5.9e-3 between the port's int8 and exact scores, wavlm 1.5e-3 against 3.5e-3)
SCORE_TOL = 5e-3
# the port against JAX, over JAX against itself on the wave nudged by one ulp.
# Measured ratios: flips 1.0 (conformer), 0.85 (wavlm); the int8_ste step's
# loss 2.7 (float32), 1.3 (bfloat16), worst gradient leaf 0.25, 1.7, median 0.36, 1.5
SPREAD = 3.0
ZERO_GRAD_LEAVES = ("depthwise/bias",)  # a train-mode BatchNorm follows the conv


def hparams(featurizer="conformer", quant_dot="int8", dtype="float32", ssl_conv_impl=None):
    hp = dict(lang2vocab={"aa": 6, "bb": 9}, lang2index={"aa": 0, "bb": 1},
              featurizer=featurizer, head_dim_head=8, head_num_head=4, dropout=0.0,
              lr=1e-3, schedule=None, quant_dot=quant_dot, dtype=dtype,
              ssl_conv_impl=ssl_conv_impl)
    if featurizer == "conformer":
        hp.update(n_blocks=2, encoder_dim=64, heads=4, dim_head=16, sub_sampling=4,
                  pos_dropout=0.0, use_stochastic_depth=False, mask_times=0)
    else:
        hp.update(ssl_config=dict(TINY_SSL, mask_prob=0.0))
    return hp


def sample(seed, b=3, t=SR):
    rng = np.random.RandomState(seed)
    return {"wavs": (0.1 * rng.randn(b, t)).astype(np.float32),
            "wav_lengths": np.array([t, 11000, 7000][:b], np.int32)}


def batch(seed, lang):
    out = sample(seed)
    rng = np.random.RandomState(seed + 100)
    out.update(texts=rng.randint(0, 5, (3, 6)).astype(np.int32),
               text_lengths=np.array([6, 4, 3], np.int32), langs=np.full(3, lang, np.int32),
               n_valid=np.int32(0))
    return out


_PAIRS = {}
_JITTED = {}  # one compile for each JAX function


def pair(**kw):
    """(JAX task, numpy variables, port task on the CPU), the weights drawn
    on the port's side."""
    key = tuple(sorted(kw.items()))
    if key not in _PAIRS:
        hp = hparams(**kw)
        port = LidASRTask(**hp, device="cpu")
        variables = port_drawn(port.model, 0, convert.lid_variables, convert.lid_state,
                               adjust=random_batch_stats)
        _PAIRS[key] = JaxLidASRTask(**hp), variables, port
    return _PAIRS[key]


def _quantized_inputs(name, jtask, variables, s):
    """JAX ``infer`` and the inputs of every quantized ``nn.Dense`` of the
    featurizer, in call order, from one jitted call."""
    if name not in _JITTED:
        def fn(v, w, lengths):
            xs = []

            def capture(next_fun, args, kwargs, context):
                mod = context.module
                if (isinstance(mod, nn.Dense) and context.method_name == "__call__"
                        and mod.dot_general is not None and mod.path[0] == "featurizer"):
                    xs.append(args[0])
                return next_fun(*args, **kwargs)

            with nn.intercept_methods(capture):
                out = jtask.infer_fn()(v, w, lengths)
            return out, xs

        _JITTED[name] = jax.jit(fn)
    out, xs = _JITTED[name](jax.tree_util.tree_map(jnp.asarray, variables),
                            jnp.asarray(s["wavs"]), jnp.asarray(s["wav_lengths"]))
    return {k: np.asarray(v) for k, v in out.items()}, [np.asarray(x) for x in xs]


def _port_infer(port, s, capture=False):
    xs = []
    hooks = [m.register_forward_pre_hook(lambda m, a: xs.append(a[0].detach().clone()))
             for m in port.model.featurizer.modules()
             if capture and isinstance(m, Linear) and m.dot is not None]
    try:
        out = port.infer_fn()(torch.from_numpy(s["wavs"]), torch.from_numpy(s["wav_lengths"]))
    finally:
        for h in hooks:
            h.remove()
    return {k: v.numpy() for k, v in out.items()}, xs


def _codes(x):
    x = torch.as_tensor(np.array(x))
    x = x.reshape(-1, x.shape[-1])
    return quant.quantize(x, quant.scales(x))


def _flips(xs, ys):
    return sum(int((_codes(x) != _codes(y)).sum()) for x, y in zip(xs, ys))


def nudged(s):
    """``s`` with its wave moved by one float32 ulp."""
    return dict(s, wavs=np.nextafter(s["wavs"], np.float32(np.inf)).astype(np.float32))


@pytest.mark.parametrize("featurizer", ["conformer", "wavlm"])
def test_infer_matches_jax(featurizer):
    impl = "matmul" if featurizer == "wavlm" else None
    jtask, variables, port = pair(featurizer=featurizer, ssl_conv_impl=impl)
    s = sample(1)
    want, jax_inputs = _quantized_inputs(f"infer_{featurizer}", jtask, variables, s)
    _, nudged_inputs = _quantized_inputs(f"infer_{featurizer}", jtask, variables, nudged(s))
    got, port_inputs = _port_infer(port, s, capture=True)
    exact = LidASRTask(**hparams(featurizer, quant_dot=None), device="cpu")
    exact.model.load_state_dict(port.model.state_dict())
    got_exact, _ = _port_infer(exact, s)

    n_layers = 9 * 2 if featurizer == "conformer" else 5 * TINY_SSL["encoder_layers"]
    assert len(jax_inputs) == len(port_inputs) == n_layers
    assert [x.shape for x in jax_inputs] == [tuple(x.shape) for x in port_inputs]
    flips, own_flips = _flips(jax_inputs, port_inputs), _flips(jax_inputs, nudged_inputs)
    assert 0 < own_flips and flips <= SPREAD * own_flips, (flips, own_flips)

    scale = np.abs(want["scores"]).max()
    jax_gap = np.abs(got["scores"] - want["scores"]).max()
    quant_gap = np.abs(got["scores"] - got_exact["scores"]).max()
    assert jax_gap <= SCORE_TOL * scale and jax_gap < quant_gap, (jax_gap, quant_gap, flips)
    np.testing.assert_array_equal(got["pred_lang"], want["pred_lang"])
    np.testing.assert_array_equal(got["feat_lengths"], want["feat_lengths"])


def _jax_step(jtask, variables, b):
    key = ("step", jtask.hyper_parameters["dtype"])
    if key not in _JITTED:
        def loss_fn(params, batch_stats, b):
            loss, _, _ = jtask.train_loop({"params": params, "batch_stats": batch_stats}, b,
                                          {k: jax.random.PRNGKey(0) for k in jtask.rng_keys})
            return loss

        _JITTED[key] = jax.jit(jax.value_and_grad(loss_fn))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    loss, grads = _JITTED[key](jvars["params"], jvars["batch_stats"],
                               jax.tree_util.tree_map(jnp.asarray, b))
    return float(loss), dict(tree_leaves_with_names(
        jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads)))


def _port_step(port, b):
    """One step's loss and every gradient in the JAX tree's names (zeros
    for the head that did not run)."""
    port.set_generators(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    port.model.train()
    try:
        port.model.zero_grad()
        loss, _ = port.train_loop(port.place_batch(b))
        loss.backward()
    finally:
        port.model.eval()
    state = dict(port.model.state_dict())
    for name, p in port.model.named_parameters():
        state[name] = torch.zeros_like(p) if p.grad is None else p.grad.clone()
    port.model.zero_grad()
    return loss.item(), dict(tree_leaves_with_names(convert.lid_variables(state)["params"]))


def _leaf_errors(got, want):
    """Each leaf's max |got − want| over its largest ``want`` entry (leaves
    whose true gradient is 0 over the largest of all); the other language's
    head, all zeros in ``want``, must be all zeros in ``got``."""
    largest = max(float(np.abs(g).max()) for g in want.values())
    errors = {}
    for name, g in got.items():
        scale = float(np.abs(want[name]).max())
        if scale == 0.0:
            assert not np.abs(g).any(), name
            continue
        if name.endswith(ZERO_GRAD_LEAVES):
            scale = largest
        errors[name] = float(np.abs(g - want[name]).max()) / scale
    return errors


@pytest.mark.parametrize("dtype,seed,lang", [("float32", 3, 1), ("bfloat16", 4, 0)])
def test_ste_step_matches_jax(dtype, seed, lang):
    jtask, variables, port = pair(quant_dot="int8_ste", dtype=dtype)
    b = batch(seed, lang)
    want_loss, want = _jax_step(jtask, variables, b)
    own_loss, own = _jax_step(jtask, variables, nudged(b))
    loss, got = _port_step(port, b)
    assert set(got) == set(want)
    assert abs(loss - want_loss) <= SPREAD * abs(own_loss - want_loss), (
        loss, want_loss, own_loss)
    err, own_err = _leaf_errors(got, want), _leaf_errors(own, want)
    assert max(err.values()) <= SPREAD * max(own_err.values()), (
        max(err, key=err.get), max(err.values()), max(own_err.values()))
    assert np.median(list(err.values())) <= SPREAD * np.median(list(own_err.values()))


def test_hyper_parameters_round_trip(tmp_path):
    for kw in (dict(quant_dot="int8_ste"), dict(featurizer="wavlm", ssl_conv_impl="matmul")):
        jtask, _, port = pair(**kw)
        assert port.hyper_parameters == jtask.hyper_parameters
        path = str(tmp_path / "task.ckpt")
        save_checkpoint(path, {"model": port.model.state_dict()},
                        {"hyper_parameters": port.hyper_parameters})
        rebuilt, _ = LidASRTask.resume_from_checkpoint(path, device="cpu")
        assert rebuilt.hyper_parameters == port.hyper_parameters
        heads = rebuilt.model.heads.heads[0]
        assert heads.out.quant_dot == port.hyper_parameters["quant_dot"]
        s = sample(6)
        np.testing.assert_array_equal(_port_infer(rebuilt, s)[0]["scores"],
                                      _port_infer(port, s)[0]["scores"])


def _jax_quantized_dense_names(jtask, variables):
    """Names of the featurizer's ``nn.Dense`` layers, quantized and exact,
    as JAX runs them (one traced call)."""
    names = {True: set(), False: set()}

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dense) and context.method_name == "__call__" \
                and mod.path[0] == "featurizer":
            names[mod.dot_general is not None].add(mod.name)
        return next_fun(*args, **kwargs)

    s = sample(7)
    with nn.intercept_methods(record):
        jax.eval_shape(jtask.infer_fn(), jax.tree_util.tree_map(jnp.asarray, variables),
                       jnp.asarray(s["wavs"]), jnp.asarray(s["wav_lengths"]))
    return names


@pytest.mark.parametrize("featurizer", ["wavlm", "conformer"])
def test_quantized_layers_are_the_jax_codes(featurizer):
    """wavlm: q/k/v/out and fc1, not fc2 (the JAX config comment's claim),
    grep_linear or post_extract_proj; conformer: every block projection,
    not the subsampling's output."""
    jtask, variables, port = pair(featurizer=featurizer)
    want = _jax_quantized_dense_names(jtask, variables)
    got = {True: set(), False: set()}
    for name, m in port.model.featurizer.named_modules():
        if isinstance(m, Linear):
            got[m.dot is not None].add(name.rsplit(".", 1)[-1])
    if featurizer == "wavlm":
        assert want == {True: {"q_proj", "k_proj", "v_proj", "out_proj", "fc1"},
                        False: {"fc2", "grep_linear", "post_extract_proj"}}
        assert got == want
    else:  # flax names them Dense_i; the port fc1, to_q, …: count them instead
        n_quant = sum(isinstance(m, Linear) and m.dot is not None
                      for m in port.model.featurizer.modules())
        assert n_quant == 9 * 2 and got[False] == {"out"}
        assert len(want[False]) == 1  # the subsampling's output Dense


def test_serve_quant_int8_answers_jax_int8_scores(tmp_path, monkeypatch):
    jtask, variables, port = pair()
    exact_hp = dict(port.hyper_parameters, quant_dot=None)
    ckpt = str(tmp_path / "last.ckpt")
    save_checkpoint(ckpt, {"model": port.model.state_dict()},
                    {"hyper_parameters": exact_hp})
    servers = []

    class Recording(ThreadingHTTPServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    monkeypatch.setattr(serve, "ThreadingHTTPServer", Recording)
    thread = threading.Thread(target=serve.main, daemon=True, args=([
        "--ckpt", ckpt, "--quant", "int8", "--device", "cpu", "--port", "0",
        "--buckets", "1,2"],))
    thread.start()
    deadline = time.monotonic() + 60
    while not servers and time.monotonic() < deadline:
        time.sleep(0.05)
    assert servers, "the server did not start"
    url = f"http://127.0.0.1:{servers[0].server_address[1]}"
    state = serve.InferenceState(None, buckets_s=(1.0, 2.0))
    jinfer = _JITTED.setdefault("serve", jax.jit(jtask.infer_fn()))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    try:
        rng = np.random.RandomState(8)
        for seconds in (0.7, 1.6):
            wav = (0.1 * rng.randn(int(seconds * SR))).astype(np.float32)
            req = urllib.request.Request(url + "/lid", data=wav.tobytes(), method="POST")
            with urllib.request.urlopen(req, timeout=30) as resp:
                body = json.loads(resp.read())
            padded, n = state.pad(wav)
            want = np.asarray(jinfer(jvars, jnp.asarray(padded), jnp.asarray([n]))["scores"])[0]
            got = np.array([body["scores"][lang] for lang in ("aa", "bb")])
            assert np.abs(got - want).max() <= SCORE_TOL * np.abs(want).max(), (got, want)
        with urllib.request.urlopen(url + "/stats", timeout=10) as resp:
            stats = json.loads(resp.read())
        assert stats["engine"] == "int8" and stats["total"]["n"] == 2
    finally:
        servers[0].shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()
