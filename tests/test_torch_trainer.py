"""The port's training slice as a whole: the JAX ``Trainer`` and the port's
``Trainer`` on the same converted initial variables and the same batches,
step for step, on the CPU.

Dropout 0, ``pos_dropout`` 0, stochastic depth off, no SpecAugment and no
stretch (the two packages' random streams differ); Adam + tristage + clip.
Tolerances: per-step max |Δloss| ≤ 2e-4 (the bar the JAX package held
against its own reference), parameters and BatchNorm statistics after the
last step within 1e-4 (atol and rtol) through the reverse converter, with
two stated exceptions, both Adam's doing (its step is lr·m̂/√v̂, so an
element whose gradient is float32 rounding noise moves by up to ±lr on that
noise in either package):

- a depthwise conv's bias feeds a train-mode BatchNorm, which subtracts the
  batch mean, so its true gradient is zero.  Those leaves, and the BatchNorm
  running means that carry the bias, are held to Σ lr over the steps, the
  most Adam can move a parameter.  So that this band hides no fault in
  them (a leaf never updated, a wrong running-mean momentum), the same eight
  steps run once more under SGD, whose step is lr·g without the division:
  there every leaf, those included, is held to 1e-4 with no exception;
- in any other leaf at most 1 % of the elements (at least one) may lie
  outside 1e-4, and they too within Σ lr (seen: 48 of 19456 elements of the
  subsampling Dense kernel, 6 of 9216 of the second subsampling conv's, up
  to 5.0e-4).  A fault in the step's semantics (schedule, clip, idle heads,
  frozen leaves) moves most elements of a leaf by about lr, not a few.

The gradient itself, before Adam, is held to 1e-4 of each leaf's largest
entry.  Eval outputs 1e-4; ``val_loop_end`` on the same outputs equal to 1e-12; a resumed
run's losses equal to the uninterrupted run's exactly."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.core import Trainer as JaxTrainer
from speechlid_tpu.core.callbacks import Callback as JaxCallback
from speechlid_tpu.data.tokenizer import CTCTokenizer
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.cli.serve import build_lid_fn
from speechlid_tpu_torch.core.callbacks import Callback, CkptCallback, LrCallback
from speechlid_tpu_torch.core.checkpoint import load_checkpoint
from speechlid_tpu_torch.core.loggers import JsonlLogger, Logger
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.parallel import make_mesh
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.torch_parity import lid_pair, one_thread, tree_leaves_with_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

LOSS_TOL = 2e-4
TOL = 1e-4
HPARAMS = dict(
    lang2vocab={"aa": 5, "bb": 9, "cc": 7},
    lang2index={"aa": 0, "bb": 1, "cc": 2},
    n_blocks=2, encoder_dim=32, heads=2, dim_head=16, sub_sampling=4,
    head_dim_head=8, head_num_head=4,
    lr=1e-3, clip_norm=1.0, schedule="tristage",
    schedule_conf=dict(warmup_steps=3, hold_steps=2, decay_steps=10),
)
DETERMINISTIC = dict(dropout=0.0, pos_dropout=0.0, use_stochastic_depth=False,
                     mask_times=0, t_stretch=False)


def make_batch(rng, lang, b=3, t=16000, s=6):
    vocab = HPARAMS["lang2vocab"][sorted(HPARAMS["lang2index"])[lang]]
    return {
        "wavs": (0.1 * rng.randn(b, t)).astype(np.float32),
        "wav_lengths": np.array([t, 12000, 9000][:b], np.int32),
        "texts": rng.randint(0, vocab, (b, s)).astype(np.int32),
        "text_lengths": np.array([6, 4, 3][:b], np.int32),
        "langs": np.full(b, lang, np.int32),
        "n_valid": np.int32(0),
    }


def batches(seed, langs):
    rng = np.random.RandomState(seed)
    return [make_batch(rng, lang) for lang in langs]


class _Losses(Callback):
    """Records every training step's loss (both packages' callbacks have
    this hook) and a snapshot after each epoch."""

    def __init__(self, snapshot=None):
        super().__init__()
        self.losses, self.snapshots, self._snapshot = [], [], snapshot

    def after_train_loop(self, step, metrics):
        self.losses.append(metrics["loss"])

    def after_train_epoch(self, epoch, metrics):
        if self._snapshot is not None:
            self.snapshots.append(self._snapshot(self.trainer))


class _JaxLosses(_Losses, JaxCallback):
    pass


def run_jax(jtask, variables, train, epochs=1, snapshot=None):
    jtask.init_variables = lambda rng, sample: jax.tree_util.tree_map(jnp.asarray, variables)
    rec = _JaxLosses(snapshot)
    trainer = JaxTrainer(total_epoch=epochs, use_progress_bar=False, callbacks=[rec])
    trainer.fit(jtask, train)
    state = jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.state))
    return rec, {"params": state.params, "batch_stats": state.model_state["batch_stats"]}


def run_port(ptask, train, val=None, epochs=1, snapshot=None, **kw):
    ptask.init_parameters = lambda generator: None  # keep the weights it was given
    rec = _Losses(snapshot)
    trainer = Trainer(total_epoch=epochs, use_progress_bar=False, device="cpu",
                      callbacks=[rec, *kw.pop("callbacks", [])], **kw)
    trainer.fit(ptask, train, val)
    return rec, trainer


def assert_variables_close(got, want, lr_sum, tol=TOL):
    """Every leaf within ``tol`` but for the two exceptions of the module
    docstring, which are held to ``lr_sum``; ``lr_sum=None`` allows none."""
    band = 0.0 if lr_sum is None else lr_sum
    for kind in ("params", "batch_stats"):
        a, b = tree_leaves_with_names(got[kind]), tree_leaves_with_names(want[kind])
        assert [n for n, _ in a] == [n for n, _ in b]
        for (name, x), (_, y) in zip(a, b):
            label = f"{kind}/{name}"
            np.testing.assert_allclose(x, y, rtol=tol, atol=band + tol, err_msg=label)
            if lr_sum is not None and not name.endswith(("depthwise/bias", "bn/mean")):
                outside = int((~np.isclose(x, y, rtol=tol, atol=tol)).sum())
                assert outside <= max(1, int(0.01 * x.size)), (label, outside, x.size)


def lr_sum(trainer):
    return sum(trainer.optimizer.lr_at(i) for i in range(trainer.optimizer.count))


@pytest.mark.parametrize("routed", [False, True], ids=["adam", "routed_adam"])
def test_eight_steps_match_jax_trainer(routed):
    """Languages 0 and 1 alternate over 8 steps; language 2 never trains."""
    hp = dict(HPARAMS, **DETERMINISTIC, routed_optim=routed)
    jtask, variables, ptask = lid_pair(hp)
    train = batches(1, [0, 1, 0, 1, 1, 0, 0, 1])
    jrec, jfinal = run_jax(jtask, variables, train)
    prec, ptrainer = run_port(ptask, train)

    assert len(prec.losses) == len(jrec.losses) == 8
    diffs = np.abs(np.array(prec.losses) - np.array(jrec.losses))
    assert diffs.max() <= LOSS_TOL, diffs
    assert prec.losses[-1] != prec.losses[0]
    pfinal = convert.lid_variables(ptask.model.state_dict())
    assert_variables_close(pfinal, jfinal, lr_sum(ptrainer))
    assert ptrainer.global_step == 8 and ptrainer.optimizer.count == 8

    # own-head-only BatchNorm commits: head 2 saw no batch, in either package
    head_stats = pfinal["batch_stats"]["heads"]["heads"]["block_0"]["conv"]["bn"]
    init_stats = variables["batch_stats"]["heads"]["heads"]["block_0"]["conv"]["bn"]
    np.testing.assert_array_equal(head_stats["mean"][2], init_stats["mean"][2])
    assert not np.allclose(head_stats["mean"][0], init_stats["mean"][0])
    # the idle head's weights: plain Adam moves nothing without a gradient
    # ever (zero moments); routed Adam never counted a step for it
    out2 = pfinal["params"]["heads"]["heads"]["Dense_0"]["kernel"][2]
    np.testing.assert_array_equal(out2, variables["params"]["heads"]["heads"]["Dense_0"]["kernel"][2])
    names = ptrainer.optimizer.names
    idle = names.index("heads.heads.2.out.weight")
    own = names.index("heads.heads.0.out.weight")
    if routed:
        assert ptrainer.optimizer.counts[idle] == 0 and ptrainer.optimizer.counts[own] == 4


def test_eight_steps_match_jax_trainer_sgd_every_leaf():
    """The same eight steps under SGD (lr 0.05, tristage, clip 1): rounding
    noise in a gradient stays rounding noise in the parameter, so the
    depthwise biases and the BatchNorm running means are held to 1e-4 like
    every other leaf, and the running statistics have moved."""
    hp = dict(HPARAMS, **DETERMINISTIC, optimizer="sgd", lr=0.05)
    jtask, variables, ptask = lid_pair(hp)
    train = batches(1, [0, 1, 0, 1, 1, 0, 0, 1])
    jrec, jfinal = run_jax(jtask, variables, train)
    prec, ptrainer = run_port(ptask, train)
    diffs = np.abs(np.array(prec.losses) - np.array(jrec.losses))
    assert diffs.max() <= LOSS_TOL, diffs
    pfinal = convert.lid_variables(ptask.model.state_dict())
    assert_variables_close(pfinal, jfinal, None)
    bn = lambda tree: tree["batch_stats"]["featurizer"]["block_0"]["conv"]["bn"]  # noqa: E731
    assert np.abs(bn(pfinal)["mean"] - bn(variables)["mean"]).max() > 100 * TOL
    assert np.abs(bn(pfinal)["var"] - bn(variables)["var"]).max() > 100 * TOL
    dense = lambda tree: tree["params"]["heads"]["heads"]["Dense_0"]["kernel"]  # noqa: E731
    assert np.abs(dense(pfinal)[0] - dense(variables)[0]).max() > 10 * TOL


def test_first_step_gradients_match_jax():
    """The train step's loss and every parameter's gradient, before any
    optimizer: within 1e-4 of the leaf's largest entry."""
    hp = dict(HPARAMS, **DETERMINISTIC)
    jtask, variables, ptask = lid_pair(hp, seed=3)
    batch = batches(8, [1])[0]
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    def loss_fn(params):
        loss, _, _ = jtask.train_loop({"params": params, "batch_stats": jvars["batch_stats"]},
                                      jax.tree_util.tree_map(jnp.asarray, batch),
                                      {k: jax.random.PRNGKey(0) for k in jtask.rng_keys})
        return loss

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(jvars["params"])
    ptask.set_generators(torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    ptask.model.train()
    loss, _ = ptask.train_loop(ptask.place_batch(batch))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    state = dict(ptask.model.state_dict())
    for name, p in ptask.model.named_parameters():
        # heads that did not run have no gradient here, a zero one in JAX
        state[name] = torch.zeros_like(p) if p.grad is None else p.grad
    assert ptask.model.heads.heads[0].out.weight.grad is None
    got = convert.lid_variables(state)["params"]
    leaves = tree_leaves_with_names(want)
    largest = max(float(np.abs(b).max()) for _, b in leaves)
    for (name, a), (_, b) in zip(tree_leaves_with_names(got), leaves):
        if name.endswith("depthwise/bias"):
            # true gradient zero (train-mode BatchNorm follows): noise in both
            assert max(np.abs(a).max(), np.abs(b).max()) <= TOL * largest, name
            continue
        scale = max(float(np.abs(b).max()), 1e-3)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale, err_msg=name)


def test_freeze_featurizer_epoch_and_keep_train_lang_match_jax(monkeypatch):
    """Epoch 0 trains with the encoder frozen, both epochs train only head
    'bb': frozen leaves and their moments stand still, and the end state
    matches the JAX trainer's."""
    # the JAX trainer's freeze signature calls float() on the per-language
    # vector masks that keep_train_lang builds and raises; read them as arrays
    monkeypatch.setattr(JaxTrainer, "_mask_freeze_sig", staticmethod(lambda mask: tuple(sorted(
        name for name, sub in mask.items()
        if all(not np.any(np.asarray(leaf)) for leaf in jax.tree_util.tree_leaves(sub))))))
    hp = dict(HPARAMS, **DETERMINISTIC, freeze_featurizer_epoch=0, keep_train_lang="bb")
    jtask, variables, ptask = lid_pair(hp, seed=1)
    train = batches(2, [1, 0, 1])

    def snapshot(trainer):
        opt = trainer.optimizer
        sd = {k: v.clone() for k, v in trainer.module.model.state_dict().items()}
        return sd, [m.clone() for m in opt.mu]

    jrec, jfinal = run_jax(jtask, variables, train, epochs=2)
    prec, ptrainer = run_port(ptask, train, epochs=2, snapshot=snapshot)
    diffs = np.abs(np.array(prec.losses) - np.array(jrec.losses))
    assert diffs.max() <= LOSS_TOL, diffs
    assert_variables_close(convert.lid_variables(ptask.model.state_dict()), jfinal,
                           lr_sum(ptrainer))

    init = convert.lid_state(variables)
    sd0, mu0 = prec.snapshots[0]
    names = ptrainer.optimizer.names
    for name, p in ptask.model.named_parameters():
        i = names.index(name)
        if name.startswith("featurizer."):
            # frozen through epoch 0 (moments still zero), trained in epoch 1
            np.testing.assert_array_equal(sd0[name].numpy(), init[name], err_msg=name)
            assert float(mu0[i].abs().max()) == 0.0, name
            assert p.requires_grad
        elif name.startswith("heads.heads.") and not name.startswith("heads.heads.1."):
            np.testing.assert_array_equal(p.detach().numpy(), init[name], err_msg=name)
            assert not p.requires_grad
    moved = ptask.model.featurizer.blocks[0].ff1.fc1.weight.detach().numpy()
    assert not np.array_equal(moved, init["featurizer.blocks.0.ff1.fc1.weight"])
    assert not np.array_equal(sd0["heads.heads.1.out.weight"].numpy(),
                              init["heads.heads.1.out.weight"])
    # BatchNorm statistics of the frozen encoder still move (train mode)
    assert not np.array_equal(sd0["featurizer.blocks.0.conv.bn.running_mean"].numpy(),
                              init["featurizer.blocks.0.conv.bn.running_mean"])


def test_val_loop_and_val_loop_end_match_jax():
    hp = dict(HPARAMS, **DETERMINISTIC)
    vocabs = {"aa": list("abcde"), "bb": list("abcdefghi"), "cc": list("abcdefg")}
    toks = {k: CTCTokenizer(v) for k, v in vocabs.items()}
    jtask, variables, ptask = lid_pair(dict(hp, tokenizers=toks), seed=2)
    val = batches(3, [0, 1, 2])
    val[2]["n_valid"] = np.int32(2)  # a repeat-padded partial batch
    jval = jax.jit(jtask.val_loop)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    outputs = []
    for batch in val:
        want = {k: np.asarray(v) for k, v in
                jval(jvars, jax.tree_util.tree_map(jnp.asarray, batch)).items()}
        got = ptask.val_loop(ptask.place_batch(batch))
        got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in got.items()}
        assert set(got) == set(want)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=TOL, atol=TOL)
        for key in ("pred_ids", "feat_lens", "langs", "texts", "text_lengths", "n_valid"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["pred_ids"].dtype == np.int32
        outputs.append({k: (float(v) if np.ndim(v) == 0 and k == "loss" else v)
                        for k, v in got.items()})
    want_metrics = jtask.val_loop_end([dict(o) for o in outputs])
    got_metrics = ptask.val_loop_end([dict(o) for o in outputs])
    assert set(got_metrics) == set(want_metrics) == {
        "avg_val_loss", "val_acc", "val_wer", "eer", "cavg", "eer_true", "cavg_true"}
    for key, value in want_metrics.items():
        assert abs(got_metrics[key] - value) <= 1e-12, key
    assert 0.0 <= got_metrics["val_acc"] <= 1.0 and got_metrics["val_wer"] > 0.0


def test_checkpoint_resume_serve_and_loggers(tmp_path):
    """Everything random on: SpecAugment, stretch, dropout, stochastic depth.
    Run A trains 3 epochs.  Run B trains 2, and run C resumes B's last.ckpt
    for the third: C's losses equal A's third epoch exactly (weights, Adam
    moments, step counts and both generators came back)."""
    hp = dict(HPARAMS, t_stretch=True, routed_optim=True)
    train, val = batches(4, [0, 1, 2, 1]), batches(5, [0, 2])
    torch.manual_seed(0)
    init = LidASRTask(**hp, device="cpu").model.state_dict()

    def task():
        t = LidASRTask(**hp, device="cpu")
        t.model.load_state_dict(init)
        return t

    rec_a, _ = run_port(task(), train, val, epochs=3)
    log_path = str(tmp_path / "metrics.jsonl")
    ckpt = CkptCallback(str(tmp_path / "ckpt"), save_topk=1)
    rec_b, trainer_b = run_port(task(), train, val, epochs=2, callbacks=[ckpt, LrCallback()],
                                loggers=Logger([JsonlLogger(log_path)], train_interval=2))
    trainer_b.logger.finish()
    assert rec_b.losses == rec_a.losses[:8]
    files = sorted(os.listdir(tmp_path / "ckpt"))
    assert "last.ckpt" in files and len(files) == 2  # last + the best of two
    assert ckpt.best_path.endswith(".ckpt") and "avg_val_loss" in ckpt.best_path
    last = str(tmp_path / "ckpt" / "last.ckpt")
    saved = load_checkpoint(last)
    assert saved["meta"]["epoch"] == 1 and saved["state"]["step"] == 8
    assert saved["hyper_parameters"]["lang2vocab"] == hp["lang2vocab"]
    assert "device" not in saved["hyper_parameters"]
    with open(log_path) as f:
        assert sum("avg_val_loss" in line for line in f) == 2

    rec_c, trainer_c = run_port(task(), train, val, epochs=3, checkpoint_path=last)
    assert trainer_c.start_epoch == 2 and trainer_c.global_step == 12
    assert rec_c.losses == rec_a.losses[8:]
    assert trainer_c.current_lr() == trainer_c.optimizer.lr_at(12)

    # the same file serves: build_lid_fn answers like the trained task
    lid_fn, index2lang = build_lid_fn(last, device="cpu")
    assert index2lang == {0: "aa", 1: "bb", 2: "cc"}
    wav = train[0]["wavs"][:1]
    want = trainer_b.module.infer_fn()(torch.from_numpy(wav), torch.tensor([16000]))["scores"]
    np.testing.assert_array_equal(lid_fn(wav, 16000), want.numpy())
    module, _ = LidASRTask.resume_from_checkpoint(last, device="cpu")
    assert torch.equal(module.model.heads.heads[0].out.weight,
                       trainer_b.module.model.heads.heads[0].out.weight)


def test_accum_grad_steps_every_second_batch():
    hp = dict(HPARAMS, **DETERMINISTIC)
    train = batches(6, [0, 0, 1, 1])
    _, trainer = run_port(LidASRTask(**hp, device="cpu"), train, accum_grad=2)
    assert trainer.global_step == 4 and trainer.optimizer.count == 2


def test_trainer_rejects_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError):
        Trainer(device="cpu", param_rules=[("a", None)])
    # the data-parallel mesh is ported (tests/test_torch_dist.py): one process
    # is a mesh of one, which trains; a mesh not from make_mesh is refused
    with pytest.raises(TypeError, match="make_mesh"):
        Trainer(device="cpu", mesh=object())
    _, meshed = run_port(LidASRTask(**HPARAMS, device="cpu"), batches(8, [0, 1]),
                         mesh=make_mesh())
    assert meshed.mesh.shape == {"data": 1, "model": 1} and meshed.optimizer.count == 2
    # the profile_dir trace is ported (tests/test_torch_profile.py)
    traced = Trainer(device="cpu", profile_dir=str(tmp_path / "trace"))
    assert traced.profile_dir == str(tmp_path / "trace") and traced.profile_epochs == 1
    # SWA and quant_dot are ported (tests/test_torch_swa.py, test_torch_quant*.py)
    swa = Trainer(device="cpu", use_swa=True)
    assert swa.use_swa and swa.swa_start_ratio == 0.7
    task = LidASRTask(**HPARAMS, device="cpu")
    mixed = batches(7, [0])[0]
    mixed["langs"] = np.array([0, 1, 0], np.int32)
    with pytest.raises(ValueError, match="one language"):
        Trainer(total_epoch=1, use_progress_bar=False, device="cpu").fit(task, [mixed])
    with pytest.raises(ValueError, match="lives on"):
        Trainer(device="meta").fit(task, [mixed])
    with pytest.raises(NotImplementedError):
        LidASRTask(**dict(HPARAMS, dtype="float16"), device="cpu")
    tiny_wavlm = dict(encoder_layers=1, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
                      encoder_attention_heads=2, conv_feature_layers="[(16,10,5)]",
                      conv_pos=16, conv_pos_groups=4)
    quant = LidASRTask(**dict(HPARAMS, featurizer="wavlm", quant_dot="int8",
                              ssl_config=tiny_wavlm), device="cpu")
    assert quant.model.featurizer.upstream.layers[0].self_attn.q_proj.quant_dot == "int8"
    with pytest.raises(ValueError, match="quant_dot"):
        LidASRTask(**dict(HPARAMS, quant_dot="int4"), device="cpu")
    with pytest.raises(ValueError, match="head_type"):
        LidASRTask(**dict(HPARAMS, head_type="lstm"), device="cpu")
    # bilstm heads train (tests/test_torch_bilstm_head.py holds them against JAX)
    _, bilstm = run_port(LidASRTask(**dict(HPARAMS, head_type="bilstm"), device="cpu"),
                         batches(8, [0, 1]))
    assert bilstm.optimizer.count == 2
    # bfloat16 compute trains: float32 parameters and Adam moments, finite
    _, bf16 = run_port(LidASRTask(**dict(HPARAMS, dtype="bfloat16"), device="cpu"),
                       batches(8, [0, 1]))
    assert bf16.optimizer.count == 2
    assert all(p.dtype == m.dtype == torch.float32 and torch.isfinite(p).all()
               for p, m in zip(bf16.optimizer.params, bf16.optimizer.mu))
    with pytest.raises(TypeError, match="mask_time"):  # a misspelt option is an error
        LidASRTask(**dict(HPARAMS, mask_time=0), device="cpu")
