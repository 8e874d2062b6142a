"""The joint task with an SSL featurizer (``LidASRTask(featurizer="wavlm" |
"wav2vec2")``) against the JAX task, on the CPU, weights carried across by
``convert`` (unrolled and scanned upstreams) and served from checkpoints of
either package.

Tolerances: ``infer`` logits, scores and mlp scores 1e-4, ``pred_lang``
exact; the train step's CTC loss within 2e-4 (the trainer test's bar) and
every gradient within 2e-4 of its leaf's largest entry, with both
packages' span masks fixed to the same mask and dropout off; the freeze
sets and warm-started weights exact.

Why 2e-4 for the task's gradients, where the featurizer alone holds 1e-4
(``tests/test_torch_wavlm.py``): with the CTC loss near 270 and a head
whose train-mode BatchNorm has random statistics, each package's float32
gradients lie up to 1e-4 of a leaf's largest entry from the same sums in
float64 (measured with the port run in float64: JAX up to 9.8e-5, the port
up to 5.7e-5, in the wav2vec2 task's heads and its extractor's GroupNorm
bias), so the two can differ by their sum.  Two leaves have a true
gradient of zero, so both packages give rounding noise there, held to the
same share of the largest gradient: ``k_proj``'s bias (the softmax cancels
it) and a head's depthwise bias (a train-mode BatchNorm follows)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import wav2vec2 as jw2v
from speechlid_tpu.models import wavlm as jwavlm
from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.cli.serve import build_lid_fn, load_lid_weights
from speechlid_tpu_torch.core.callbacks import CkptCallback
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.models import wavlm as pwavlm
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.torch_parity import (  # noqa: F401
    TINY_SSL,
    W2V,
    lid_pair,
    one_thread,
    random_batch_stats,
    tree_leaves_with_names,
    write_wav2vec2_pt,
    write_wavlm_pt,
)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
LOSS_TOL = 2e-4
GRAD_TOL = 2e-4
FEATURIZERS = ("wavlm", "wav2vec2")
NO_REL_POS = ("relative_position_embedding", "num_buckets", "max_distance", "gru_rel_pos")


def ssl_config(featurizer):
    """TINY_SSL; wav2vec2 has no relative position bias."""
    if featurizer == "wav2vec2":
        return {k: v for k, v in TINY_SSL.items() if k not in NO_REL_POS}
    return dict(TINY_SSL)


def hparams(featurizer, **kw):
    return dict(lang2vocab={"aa": 6, "bb": 9}, lang2index={"aa": 0, "bb": 1},
                featurizer=featurizer, ssl_config=ssl_config(featurizer),
                feature_selection="hidden_states", head_dim_head=8, head_num_head=4,
                dropout=0.0, lr=1e-3, schedule=None, **kw)


def sample(seed=0, b=2, t=3200):
    rng = np.random.RandomState(seed)
    return {"wavs": (0.1 * rng.randn(b, t)).astype(np.float32),
            "wav_lengths": np.array([t, 2111, 1700][:b], np.int32)}


def batch(seed, lang=0):
    rng = np.random.RandomState(seed)
    out = sample(seed)
    out.update(texts=rng.randint(0, 5, (2, 6)).astype(np.int32),
               text_lengths=np.array([6, 4], np.int32), langs=np.full(2, lang, np.int32),
               n_valid=np.int32(0))
    return out


def ssl_pair(featurizer, **kw):
    """(JAX task, numpy variables, port task on the CPU) with the weights of
    the JAX init carried across through the server's loader."""
    hp = hparams(featurizer, **kw)
    jtask = JaxLidASRTask(**hp)
    variables = random_batch_stats(jtask.init_variables(jax.random.PRNGKey(0), sample()), 0)
    ptask = LidASRTask(**hp, device="cpu")
    load_lid_weights(ptask, variables)
    return jtask, variables, ptask


@pytest.fixture(scope="module", params=FEATURIZERS)
def pair(request):
    torch.set_num_threads(1)
    return (request.param, *ssl_pair(request.param))


def jax_infer(jtask, variables, wavs, lengths):
    out = jax.jit(jtask.infer_fn())(variables, jnp.asarray(wavs), jnp.asarray(lengths))
    return {k: np.asarray(v) for k, v in out.items()}


def assert_infer_close(p, j):
    np.testing.assert_array_equal(p["feat_lengths"], j["feat_lengths"])
    for key in ("logits", "scores", "mlp_scores"):
        np.testing.assert_allclose(p[key], j[key], rtol=TOL, atol=TOL, err_msg=key)
    np.testing.assert_array_equal(p["pred_lang"], j["pred_lang"])


def port_infer(ptask, wavs, lengths):
    out = ptask.infer_fn()(torch.from_numpy(wavs), torch.from_numpy(lengths))
    return {k: v.numpy() for k, v in out.items()}


def test_infer_matches_jax(pair):
    _, jtask, variables, ptask = pair
    s = sample(1, b=3, t=4000)
    assert_infer_close(port_infer(ptask, s["wavs"], s["wav_lengths"]),
                       jax_infer(jtask, variables, s["wavs"], s["wav_lengths"]))


def test_scanned_upstream_loads_and_round_trips(pair):
    """The JAX task with ``scan_blocks`` keeps layers 1..N−1 stacked under
    ``layers_rest``: those variables load into the port and infer as the
    scanned JAX task does; the unrolled tree round-trips bit for bit."""
    featurizer, _, variables, ptask = pair
    back = convert.lid_variables(convert.lid_state(variables))
    for kind in ("params", "batch_stats"):
        a, b = tree_leaves_with_names(back[kind]), tree_leaves_with_names(variables[kind])
        assert [n for n, _ in a] == [n for n, _ in b], kind
        for (name, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
    scanned = jax.tree_util.tree_map(lambda x: x, variables)
    feat = dict(scanned["params"]["featurizer"])
    feat["upstream"] = jax.tree_util.tree_map(np.asarray,
                                              jwavlm.stack_scan_layers(feat["upstream"]))
    scanned["params"] = dict(scanned["params"], featurizer=feat)
    assert "layers_rest" in feat["upstream"] and "layers_1" not in feat["upstream"]
    jtask = JaxLidASRTask(**hparams(featurizer, scan_blocks=True))
    port = LidASRTask(**hparams(featurizer, scan_blocks=True), device="cpu")
    load_lid_weights(port, scanned)
    s = sample(2)
    assert_infer_close(port_infer(port, s["wavs"], s["wav_lengths"]),
                       jax_infer(jtask, scanned, s["wavs"], s["wav_lengths"]))


def test_train_loss_and_gradients_match_jax(pair, monkeypatch):
    featurizer, jtask, variables, ptask = pair
    b = batch(3, lang=1)
    t_out = int(pwavlm.conv_out_lengths(torch.tensor(3200), pwavlm.WavLMConfig.from_dict(
        TINY_SSL).conv_layers))
    spans = np.zeros((2, t_out), bool)
    spans[0, 10:30] = spans[1, 70:80] = True
    monkeypatch.setattr(jwavlm, "compute_mask_spans", lambda *a, **k: jnp.asarray(spans))
    monkeypatch.setattr(pwavlm, "compute_mask_spans", lambda *a, **k: torch.from_numpy(spans))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    def loss_fn(params):
        loss, _, _ = jtask.train_loop({"params": params, "batch_stats": jvars["batch_stats"]},
                                      jax.tree_util.tree_map(jnp.asarray, b),
                                      {k: jax.random.PRNGKey(0) for k in jtask.rng_keys})
        return loss

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(jvars["params"])
    ptask.set_generators(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    ptask.model.train()
    try:
        ptask.model.zero_grad()
        loss, _ = ptask.train_loop(ptask.place_batch(b))
        loss.backward()
    finally:
        ptask.model.eval()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL, (loss.item(), float(want_loss))
    state = dict(ptask.model.state_dict())
    for name, p in ptask.model.named_parameters():
        # the head that did not run has no gradient here, a zero one in JAX
        state[name] = torch.zeros_like(p) if p.grad is None else p.grad.clone()
    ptask.model.zero_grad()
    got = convert.lid_variables(state)["params"]
    leaves = tree_leaves_with_names(jax.tree_util.tree_map(np.asarray, want))
    largest = max(float(np.abs(w).max()) for _, w in leaves)
    assert float(np.abs(dict(leaves)["featurizer/upstream/mask_emb"]).max()) > 0
    for (name, g), (_, w) in zip(tree_leaves_with_names(got), leaves):
        if name.endswith(("k_proj/bias", "depthwise/bias")):
            assert max(np.abs(g).max(), np.abs(w).max()) <= GRAD_TOL * largest, name
            continue
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale, err_msg=name)


# ----------------------------------------------------------- freeze sets


def jax_frozen(jtask, variables, ptask, epoch):
    """Port parameter names whose JAX mask leaf is zero in ``epoch``: the
    mask pytree carried across by ``convert`` like the weights."""
    params = variables["params"]
    jtask.trainer = types.SimpleNamespace(state=types.SimpleNamespace(params=params))
    mask = jtask.before_train_loop(epoch)
    full = jax.tree_util.tree_map(
        lambda m, p: np.broadcast_to(np.asarray(m, np.float32), np.shape(p)), mask, params)
    carried = convert.lid_state({"params": full, "batch_stats": variables["batch_stats"]})
    return {name for name, _ in ptask.model.named_parameters()
            if not np.any(carried[name])}


def port_frozen(ptask, epoch):
    ptask.before_train_loop(epoch)
    return {name for name, p in ptask.model.named_parameters() if not p.requires_grad}


@pytest.mark.parametrize("featurizer", [*FEATURIZERS, "conformer"])
@pytest.mark.parametrize("gates", [(1, 0, None), (0, 2, None), (-1, -1, "bb")],
                         ids=["extractor_longer", "transformer_longer", "keep_lang"])
def test_freeze_sets_match_the_jax_mask(featurizer, gates):
    """Epochs on both sides of each gate (``configs/lid_wavlm.yaml``'s 1 / 0
    first): the port's frozen parameters are the JAX mask's zero leaves."""
    feat_epoch, trans_epoch, keep = gates
    kw = dict(freeze_featurizer_epoch=feat_epoch, freeze_transformer_epoch=trans_epoch,
              keep_train_lang=keep)
    jtask, variables, ptask = freeze_pair(featurizer)
    for task in (jtask, ptask):
        for key, value in kw.items():
            setattr(task, key, value)
    seen = []
    for epoch in range(4):
        want = jax_frozen(jtask, variables, ptask, epoch)
        got = port_frozen(ptask, epoch)
        assert got == want, (epoch, sorted(got ^ want)[:5])
        seen.append(len(got))
    if keep is not None:
        assert all(n > 0 for n in seen)
    else:
        assert seen[0] > 0 and seen[-1] == 0
    if featurizer != "conformer" and gates[2] is None:
        frozen0 = port_frozen(ptask, 0)
        extractor = {n for n in frozen0 if ".feature_extractor." in n}
        layers = {n for n in frozen0 if ".layers." in n}
        assert extractor and layers  # both gates hold at epoch 0
        # the post-extract LayerNorm, mask_emb and the layer weights never freeze
        assert not any(n.endswith(("upstream.layer_norm.weight", "mask_emb", "layer_weights"))
                       for n in frozen0)


_FREEZE_PAIRS = {}


def freeze_pair(featurizer):
    if featurizer not in _FREEZE_PAIRS:
        if featurizer == "conformer":
            _FREEZE_PAIRS[featurizer] = lid_pair(dict(
                lang2vocab={"aa": 6, "bb": 9}, lang2index={"aa": 0, "bb": 1}, n_blocks=1,
                encoder_dim=32, heads=2, dim_head=16, head_dim_head=8, head_num_head=4))
        else:
            _FREEZE_PAIRS[featurizer] = ssl_pair(featurizer)
    return _FREEZE_PAIRS[featurizer]


# ------------------------------------------------- warm start and serving


@pytest.mark.parametrize("featurizer", FEATURIZERS)
def test_pt_warm_start_matches_jax_and_survives_init(tmp_path, featurizer):
    """Both tasks warm-start their upstream from the same test-written
    ``.pt``; the port's upstream is the file's after ``init_parameters``'
    fresh draw and after the trainer's prepare, and equal to the JAX task's
    upstream after its init."""
    if featurizer == "wavlm":
        cfg, write = jwavlm.WavLMConfig.from_dict(TINY_SSL), write_wavlm_pt
    else:
        cfg, write = jw2v.wav2vec2_config(**W2V), write_wav2vec2_pt
    jm = jwavlm.WavLM(cfg)
    s = sample(4)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda key: jm.init(
        key, jnp.asarray(s["wavs"]), jnp.asarray(s["wav_lengths"])))(jax.random.PRNGKey(5)))
    path = str(tmp_path / "upstream.pt")
    write(path, params["params"], TINY_SSL if featurizer == "wavlm" else W2V)
    hp = dict(hparams(featurizer), pt_path=path, ssl_config=None)
    jvars = JaxLidASRTask(**hp).init_variables(jax.random.PRNGKey(0), s)
    want = convert.ssl_featurizer_state(
        jax.tree_util.tree_map(np.asarray, jvars["params"]["featurizer"]), "featurizer.")
    task = LidASRTask(**hp, device="cpu")
    task.init_parameters(torch.Generator().manual_seed(7))
    Trainer(seed=3, device="cpu", use_progress_bar=False).trainer_prepare(task)
    state = task.model.state_dict()
    upstream = [n for n in want if n.startswith("featurizer.upstream.")]
    assert len(upstream) > 20
    for name in upstream:
        np.testing.assert_array_equal(state[name].numpy(), want[name], err_msg=name)
    # the rest was drawn fresh: the heads are not the JAX task's
    assert state["featurizer.featurizer.layer_weights"].abs().max() == 0


def test_port_checkpoint_serves_and_resumes(tmp_path):
    """One fit epoch of the WavLM task with masking on, its checkpoint
    served by ``build_lid_fn`` with the task's own scores, and resumed."""
    hp = hparams("wavlm")
    task = LidASRTask(**hp, device="cpu")
    trainer = Trainer(total_epoch=1, seed=0, device="cpu", use_progress_bar=False,
                      callbacks=[CkptCallback(str(tmp_path))])
    before = task.model.featurizer.upstream.mask_emb.detach().clone()
    trainer.fit(task, [batch(5, 0), batch(6, 1)], [batch(7, 0)])
    assert not torch.equal(before, task.model.featurizer.upstream.mask_emb)  # masked steps ran
    lid_fn, index2lang = build_lid_fn(str(tmp_path / "last.ckpt"), device="cpu")
    s = sample(8, b=1)
    want = task.infer_fn()(torch.from_numpy(s["wavs"]), torch.from_numpy(s["wav_lengths"]))
    np.testing.assert_array_equal(lid_fn(s["wavs"], int(s["wav_lengths"][0])),
                                  want["scores"].numpy())
    assert index2lang == {0: "aa", 1: "bb"}
    resumed = LidASRTask(**hp, device="cpu")
    Trainer(seed=1, device="cpu", use_progress_bar=False,
            checkpoint_path=str(tmp_path / "last.ckpt")).trainer_prepare(resumed)
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, task.model.state_dict()[name]), name


def test_ssl_options_that_still_raise():
    # bfloat16 heads over the float32 encoder (the task's dtype alone) infer,
    # with float32 logits; the int8 path (ported) quantizes what JAX does
    bf16 = LidASRTask(**hparams("wavlm", dtype="bfloat16"), device="cpu")
    s = sample(5)
    out = port_infer(bf16, s["wavs"], s["wav_lengths"])
    assert out["logits"].dtype == np.float32 and np.isfinite(out["scores"]).all()
    assert bf16.model.heads.heads[0].out.compute_dtype == torch.bfloat16
    assert bf16.model.featurizer.upstream.layers[0].fc1.compute_dtype == torch.float32
    int8 = LidASRTask(**hparams("wavlm", quant_dot="int8"), device="cpu")
    layer = int8.model.featurizer.upstream.layers[0]
    assert layer.self_attn.v_proj.quant_dot == layer.fc1.quant_dot == "int8"
    assert layer.fc2.dot is None and int8.model.heads.heads[0].out.quant_dot == "int8"
    out = port_infer(int8, s["wavs"], s["wav_lengths"])
    assert np.isfinite(out["scores"]).all()
    with pytest.raises(ValueError, match="unknown featurizer"):
        LidASRTask(**hparams("hubert"), device="cpu")
    with pytest.raises(TypeError):  # wav2vec2_config takes known fields only
        LidASRTask(**dict(hparams("wav2vec2"), ssl_config={"mask_time": 1}), device="cpu")
