"""The joint LID+ASR task in bfloat16 (``LidASRTask(dtype="bfloat16")``),
Conformer, WavLM and wav2vec2 featurizers, against the JAX task with the
same options, on the CPU, weights through ``convert``, on ragged batches.

- ``infer``: the logits (float32 in both packages: the vocab mask promotes
  them), the scores and the MLP scores by the bars of ``tests/torch_parity.
  assert_bf16_close`` against the float32 task of the same weights;
  ``pred_lang`` equal wherever JAX's bfloat16 margin between the two best
  languages exceeds the scores' measured distance.
- One bfloat16 train step (dropout, span masking, SpecAugment and
  stochastic depth off): the CTC loss and every gradient leaf by the same
  bars, gradients relative to the leaf's largest float32 entry (leaves
  whose true gradient is 0 to the largest gradient of all); parameters,
  gradients and Adam's moments float32 through ``Trainer.fit``.
- The task's ``dtype`` reaches the Conformer featurizer and the heads, not
  an SSL encoder, in both packages: with ``dtype="bfloat16"`` alone the
  encoder's output equals the float32 task's bit for bit while the heads
  compute in bfloat16; ``ssl_config.dtype`` puts the encoder in bfloat16.

Tolerances measured here, in brackets beside each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.torch_parity import (  # noqa: F401
    TINY_SSL,
    assert_bf16_close,
    one_thread,
    random_batch_stats,
    tree_leaves_with_names,
)

pytestmark = pytest.mark.usefixtures("one_thread")

FEATURIZERS = ("conformer", "wavlm", "wav2vec2")
NO_REL_POS = ("relative_position_embedding", "num_buckets", "max_distance", "gru_rel_pos")
# measured (a) distances over the float32 result's largest entry, per featurizer
INFER_TOL = {"logits": 3e-2,   # (conformer 9.5e-3, wavlm 1.1e-2, wav2vec2 1.2e-2)
             "scores": 3e-2,   # (2.9e-3, 1.2e-3, 1.3e-3)
             "mlp_scores": 3e-2}  # (3.0e-3, 1.1e-3, 2.2e-3)
LOSS_TOL = 1e-2  # (conformer 2.3e-4, wavlm 2.5e-4, wav2vec2 3.1e-4)
# Every gradient leaf, of its largest float32 entry: the worst leaves are
# conformer attn/rel_pos_emb 6.8e-2 (47 of its 1025 rows carry a gradient;
# JAX's own bfloat16 gradient lies 1.3e-1 from float32 there), wavlm
# layers_0/fc2/bias 5.4e-2 (a sum over every frame; JAX's own 5.4e-2) and
# wav2vec2 layers_1/self_attn/v_proj/bias 4.5e-2.  Bar (b) holds in every
# leaf: the port is no further from float32 than twice JAX.
GRAD_TOL = 1e-1
# leaves whose true gradient is 0: the softmax cancels k_proj's bias, a
# train-mode BatchNorm follows the depthwise conv
ZERO_GRAD_LEAVES = ("k_proj/bias", "depthwise/bias")


def ssl_config(featurizer, **kw):
    conf = dict(TINY_SSL, mask_prob=0.0, **kw)
    if featurizer == "wav2vec2":  # no relative position bias; pre-LN, wave normalisation
        # (the layer-norm extractor is held in tests/test_torch_bf16_wavlm.py:
        # on a zero-padded wave its padded frames are ill-conditioned in
        # float32 too, and the unmasked attention carries them into the valid
        # frames; ROADMAP §3)
        conf = {k: v for k, v in conf.items() if k not in NO_REL_POS}
        conf.update(layer_norm_first=True, normalize=True)
    return conf


def hparams(featurizer, dtype, ssl_dtype=None):
    """Small task options; ``ssl_dtype`` is the SSL encoder's own dtype
    (``ssl_config.dtype``), by default the task's."""
    hp = dict(lang2vocab={"aa": 6, "bb": 9, "cc": 7}, lang2index={"aa": 0, "bb": 1, "cc": 2},
              featurizer=featurizer, head_dim_head=8, head_num_head=4, dropout=0.0, lr=1e-3,
              schedule=None, dtype=dtype)
    if featurizer == "conformer":
        hp.update(n_blocks=2, encoder_dim=64, heads=4, dim_head=16, sub_sampling=4,
                  pos_dropout=0.0, use_stochastic_depth=False, mask_times=0)
    else:
        hp.update(ssl_config=ssl_config(featurizer, dtype=ssl_dtype or dtype),
                  feature_selection="hidden_states" if featurizer == "wav2vec2"
                  else "last_hidden_state")
    return hp


def sample(seed, b=3, t=16000):
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


_TASKS = {}


def tasks(featurizer):
    """(JAX tasks by dtype, numpy variables, port bfloat16 task), the
    weights of the float32 JAX init with random BatchNorm statistics."""
    if featurizer not in _TASKS:
        jtasks = {dt: JaxLidASRTask(**hparams(featurizer, dt)) for dt in ("float32", "bfloat16")}
        variables = random_batch_stats(jtasks["float32"].init_variables(
            jax.random.PRNGKey(0), sample(0)), 0)
        port = LidASRTask(**hparams(featurizer, "bfloat16"), device="cpu")
        convert.load_into(port.model, convert.lid_state(variables))
        _TASKS[featurizer] = jtasks, variables, port
    return _TASKS[featurizer]


def jax_infer(jtask, variables, s):
    out = jax.jit(jtask.infer_fn())(variables, jnp.asarray(s["wavs"]),
                                    jnp.asarray(s["wav_lengths"]))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("featurizer", FEATURIZERS)
def test_infer_matches_jax_bf16(featurizer):
    jtasks, variables, port = tasks(featurizer)
    s = sample(1)
    want = {dt: jax_infer(jt, variables, s) for dt, jt in jtasks.items()}
    out = port.infer_fn()(torch.from_numpy(s["wavs"]), torch.from_numpy(s["wav_lengths"]))
    assert out["logits"].dtype == torch.float32 and want["bfloat16"]["logits"].dtype == np.float32
    got = {k: v.numpy() for k, v in out.items()}
    j16, j32 = want["bfloat16"], want["float32"]
    np.testing.assert_array_equal(got["feat_lengths"], j16["feat_lengths"])
    neg = np.finfo(np.float32).min
    live = j32["logits"] > neg
    np.testing.assert_array_equal(got["logits"] > neg, live)
    assert np.isfinite(got["logits"][live]).all() and np.isfinite(got["scores"]).all()
    assert_bf16_close(f"{featurizer} logits", got["logits"][live], j16["logits"][live],
                      j32["logits"][live], INFER_TOL["logits"])
    for key in ("scores", "mlp_scores"):
        assert_bf16_close(f"{featurizer} {key}", got[key], j16[key], j32[key], INFER_TOL[key])
    err = float(np.abs(got["scores"] - j16["scores"]).max())
    top2 = np.sort(j16["scores"], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err
    np.testing.assert_array_equal(got["pred_lang"][clear], j16["pred_lang"][clear])


@pytest.mark.parametrize("featurizer", FEATURIZERS)
def test_train_step_matches_jax_bf16(featurizer):
    """The loss and every gradient leaf of one step on the batch's own
    head; float32 gradients; the padded utterances' frames stay finite."""
    jtasks, variables, port = tasks(featurizer)
    b = batch(3, lang=1)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    want = {}
    for dt, jtask in jtasks.items():
        def loss_fn(params, jtask=jtask):
            loss, _, _ = jtask.train_loop(
                {"params": params, "batch_stats": jvars["batch_stats"]},
                jax.tree_util.tree_map(jnp.asarray, b),
                {k: jax.random.PRNGKey(0) for k in jtask.rng_keys})
            return loss

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jvars["params"])
        want[dt] = float(loss), dict(tree_leaves_with_names(
            jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads)))
    port.set_generators(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    port.model.train()
    try:
        port.model.zero_grad()
        loss, _ = port.train_loop(port.place_batch(b))
        loss.backward()
    finally:
        port.model.eval()
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    (loss16, g16), (loss32, g32) = want["bfloat16"], want["float32"]
    assert_bf16_close(f"{featurizer} loss", np.float32(loss.item()), np.float32(loss16),
                      np.float32(loss32), LOSS_TOL)
    state = dict(port.model.state_dict())
    for name, p in port.model.named_parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or (p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all())
        # the heads that did not run have no gradient here, a zero one in JAX
        state[name] = torch.zeros_like(p) if p.grad is None else p.grad.clone()
    port.model.zero_grad()
    got = dict(tree_leaves_with_names(convert.lid_variables(state)["params"]))
    assert set(got) == set(g32)
    largest = max(float(np.abs(g).max()) for g in g32.values())
    for name, g in got.items():
        scale = float(np.abs(g32[name]).max())
        if scale == 0.0:  # another language's head
            assert not np.abs(g).any() and not np.abs(g16[name]).any(), name
            continue
        if name.endswith(ZERO_GRAD_LEAVES):
            scale = largest
        assert_bf16_close(f"{featurizer} grad {name}", g, g16[name], g32[name], GRAD_TOL,
                          scale)


@pytest.mark.parametrize("featurizer", FEATURIZERS)
def test_trainer_fits_bf16_task_with_float32_state(featurizer):
    """``Trainer.fit`` for two steps and an eval: every parameter, its
    gradient and both Adam moments stay float32 and finite; the eval's
    loss and scores are finite."""
    task = LidASRTask(**hparams(featurizer, "bfloat16"), device="cpu")
    trainer = Trainer(total_epoch=1, seed=0, device="cpu", use_progress_bar=False)
    metrics = trainer.fit(task, [batch(5, 0), batch(6, 2)], [batch(7, 1)])
    assert trainer.optimizer.count == 2
    for p, mu, nu in zip(trainer.optimizer.params, trainer.optimizer.mu, trainer.optimizer.nu):
        assert p.dtype == mu.dtype == nu.dtype == torch.float32
        assert torch.isfinite(p).all() and torch.isfinite(mu).all() and torch.isfinite(nu).all()
    assert metrics is None or np.isfinite(metrics.get("avg_val_loss", 0.0))
    out = task.val_loop(task.place_batch(batch(8, 1)))
    assert out["scores"].dtype == torch.float32 and torch.isfinite(out["scores"]).all()
    assert torch.isfinite(out["loss"])


def _port_featurizer_out(task, s):
    seen = []
    hook = task.model.featurizer.register_forward_hook(lambda m, a, out: seen.append(out))
    try:
        task.infer_fn()(torch.from_numpy(s["wavs"]), torch.from_numpy(s["wav_lengths"]))
    finally:
        hook.remove()
    return seen[0]


def _jax_intermediates(jtask, variables, s):
    feats, f_len = jtask._model_inputs(jnp.asarray(s["wavs"]), jnp.asarray(s["wav_lengths"]))
    (logits, _), state = jtask.model.apply(variables, feats, f_len, capture_intermediates=True,
                                           mutable=["intermediates"])
    inter = state["intermediates"]
    return (np.asarray(inter["featurizer"]["__call__"][0]), np.asarray(logits),
            _float_dtypes(inter["featurizer"]))


def _float_dtypes(tree):
    return {str(a.dtype) for a in jax.tree_util.tree_leaves(tree)
            if jnp.issubdtype(a.dtype, jnp.floating)}


def test_task_dtype_does_not_reach_the_ssl_encoder():
    """WavLM with ``dtype="bfloat16"`` and no ``ssl_config.dtype``: in both
    packages the encoder's output equals the float32 task's bit for bit,
    every intermediate of the JAX encoder is float32, the heads compute in
    bfloat16 (so the logits move); with ``ssl_config.dtype: bfloat16`` the
    encoder runs in bfloat16 too."""
    _, variables, _ = tasks("wavlm")
    s = sample(2)
    conf = ssl_config("wavlm")  # no dtype key: the config's float32
    base = hparams("wavlm", "float32")
    runs = {"f32": dict(base, ssl_config=conf),
            "heads_bf16": dict(base, ssl_config=conf, dtype="bfloat16"),
            "all_bf16": dict(base, ssl_config=dict(conf, dtype="bfloat16"), dtype="bfloat16")}
    jax_out, port_out = {}, {}
    for name, hp in runs.items():
        jax_out[name] = _jax_intermediates(JaxLidASRTask(**hp), variables, s)
        port = LidASRTask(**hp, device="cpu")
        convert.load_into(port.model, convert.lid_state(variables))
        port_out[name] = (_port_featurizer_out(port, s), port)
    # JAX: the same encoder output, every encoder intermediate float32; the
    # live logits are bfloat16 values (the heads' last Dense is bfloat16)
    feat32, logits32, _ = jax_out["f32"]
    feat, logits, feat_dtypes = jax_out["heads_bf16"]
    np.testing.assert_array_equal(feat, feat32)
    assert feat_dtypes == {"float32"}
    live = logits32 > np.finfo(np.float32).min
    assert _bf16_values(logits[live]) and not _bf16_values(logits32[live])
    assert "bfloat16" in jax_out["all_bf16"][2]
    assert not np.array_equal(jax_out["all_bf16"][0], feat32)
    # the port
    p32, p16, pall = (port_out[n][0] for n in ("f32", "heads_bf16", "all_bf16"))
    assert torch.equal(p16, p32) and p32.dtype == torch.float32
    heads_task, all_task = port_out["heads_bf16"][1], port_out["all_bf16"][1]
    upstream = heads_task.model.featurizer.upstream
    assert upstream.layers[0].fc1.compute_dtype == torch.float32
    assert heads_task.model.heads.heads[0].out.compute_dtype == torch.bfloat16
    assert all_task.model.featurizer.upstream.layers[0].fc1.compute_dtype == torch.bfloat16
    assert not torch.equal(pall, p32)
    port_logits = heads_task.infer_fn()(torch.from_numpy(s["wavs"]),
                                        torch.from_numpy(s["wav_lengths"]))["logits"]
    assert _bf16_values(port_logits.numpy()[live])


def _bf16_values(a):
    """Whether every entry of the float32 array ``a`` is a bfloat16 value."""
    return bool(np.array_equal(a, np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)))
