"""The port's checkpoint reader and ``/lid`` server against the JAX package,
on the CPU: a checkpoint written by ``speechlid_tpu.core.checkpoint`` is
read without JAX (every array equal), served by the port, and each answer
is held against the JAX ``infer_fn`` on the same padded input.

Tolerance for served scores: 1e-4 (atol and rtol), as for the whole-slice
parity test; the checkpoint arrays are compared exactly."""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechlid_tpu.core import checkpoint as jckpt
from speechlid_tpu.core.state import TrainState
from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch.cli import serve
from speechlid_tpu_torch.core import checkpoint

TOL = 1e-4
HPARAMS = dict(
    lang2vocab={"aa": 6, "bb": 8, "cc": 5},
    lang2index={"aa": 0, "bb": 1, "cc": 2},
    n_blocks=2, encoder_dim=32, heads=2, dim_head=16, sub_sampling=4,
    head_dim_head=8, head_num_head=4,
)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX checkpoint of a TrainState (Adam state included) whose arrays
    over 4 KiB are written as flax's chunked arrays."""
    torch.set_num_threads(1)
    jtask = JaxLidASRTask(**HPARAMS)
    rng = np.random.RandomState(0)
    sample = {"wavs": rng.randn(1, 16000).astype(np.float32),
              "wav_lengths": np.array([16000], np.int32)}
    variables = jtask.init_variables(jax.random.PRNGKey(0), sample)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        variables["batch_stats"])
    state = TrainState.create(variables["params"], {"batch_stats": stats},
                              optax.adam(1e-3).init(variables["params"]),
                              jax.random.PRNGKey(1))
    path = str(tmp_path_factory.mktemp("ckpt") / "last.ckpt")
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    try:
        jckpt.save_checkpoint(path, state, meta={
            "hyper_parameters": jtask.hyper_parameters, "epoch": 3,
            "best_score": np.float32(0.25)})
    finally:
        mp.undo()
    return path, jtask


def test_reader_matches_jax_loader(saved):
    path, jtask = saved
    ref = jckpt.load_checkpoint(path)
    got = checkpoint.load_checkpoint(path)
    assert got["hyper_parameters"] == ref["meta"]["hyper_parameters"]
    for key, ref_tree in (("params", ref["state"]["params"]),
                          ("batch_stats", ref["state"]["model_state"]["batch_stats"])):
        ref_leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
        got_leaves = dict(jax.tree_util.tree_flatten_with_path(got[key])[0])
        assert len(got_leaves) == len(ref_leaves)
        for leaf_path, leaf in ref_leaves:
            np.testing.assert_array_equal(got_leaves[leaf_path], np.asarray(leaf))
            assert got_leaves[leaf_path].dtype == np.asarray(leaf).dtype
    payload = checkpoint.read_payload(path)
    assert payload["meta"]["epoch"] == 3 and payload["meta"]["best_score"] == np.float32(0.25)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_serve_matches_jax_infer(saved):
    path, jtask = saved
    lid_fn, index2lang = serve.build_lid_fn(path, device="cpu")
    state = serve.InferenceState(lid_fn, index2lang)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read()) == {"status": "ok"}
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(url + "/lid", b"abc")  # not float32 PCM
        assert bad.value.code == 400

        ref = jckpt.load_checkpoint(path)["state"]
        variables = {"params": ref["params"], "batch_stats": ref["model_state"]["batch_stats"]}
        jinfer = jax.jit(jtask.infer_fn())
        rng = np.random.RandomState(5)
        for seconds in (0.7, 1.5, 2.0):
            wav = (0.1 * rng.randn(int(seconds * 16000))).astype(np.float32)
            status, body = _post(url + "/lid", wav.tobytes())
            assert status == 200 and set(body) == {"lang", "scores"}
            padded, n = state.pad(wav)
            want = np.asarray(jinfer(variables, jnp.asarray(padded), jnp.asarray([n]))["scores"])[0]
            got = np.array([body["scores"][index2lang[i]] for i in range(3)])
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
            assert body["lang"] == index2lang[int(np.argmax(got))]
        with urllib.request.urlopen(url + "/stats", timeout=10) as resp:
            stats = json.loads(resp.read())
        assert stats["total"]["n"] == 3 and stats["bucket_hits"] == {"1s": 1, "2s": 2}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
