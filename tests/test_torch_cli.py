"""The port's training CLI (``speechlid_tpu_torch/cli/main_lid.py``) against
the JAX package's, on a tiny 2-language corpus on the CPU.

- ``main([... "--device", "cpu"])`` (1 block × 32-d, 1 epoch) writes the
  ``metrics.jsonl`` lines the JAX CLI writes (the same keys at the same
  steps, the same run config) and a checkpoint that
  ``build_lid_fn(..., device="cpu")`` serves; ``stage=test`` runs from it;
- the two CLIs' ``build_data`` / ``build_feeder`` give identical batches
  (one process and one shard of two), and ``build_task`` the same
  ``hyper_parameters``;
- ``data.wav_augment`` trains through the augmentor and feeds the JAX CLI's
  batch lengths, and an unknown key of it raises ``TypeError`` in both;
- every option not ported yet raises ``NotImplementedError``, and without
  ``--device`` the CLI asks for the card; ``trainer.use_swa=true``, ported,
  trains and writes ``swa_final.ckpt``; ``trainer.data_parallel=true``,
  ported, trains in a process group of one, bit-equal to the run without
  it (two ranks: ``tests/test_torch_dist.py``); ``trainer.model_parallel=2``,
  ported, refuses a group of one (two ranks: ``tests/test_torch_tp_trainer.py``);
- the other two tasks: ``lid_cross.yaml`` (the ``xvector`` and ``linear``
  back-ends on fbank), ``lid_cross_wavlm.yaml`` and ``lid_cross_wav2vec.yaml``
  (tiny ``module.ssl_config``) and ``asr.yaml`` (one language) train an
  epoch on the CPU, write a checkpoint and finite metrics, run
  ``stage=test`` from it, and build the JAX CLI's task
  ``hyper_parameters``;
- the SSL configs: ``lid_wavlm.yaml`` with a tiny ``module.ssl_config``
  trains across both freeze gates and has the JAX CLI's hyper-parameters,
  ``lid_wav2vec.yaml`` trains without its augmentor and raises the JAX
  CLI's ``TypeError`` with it, the int8 WavLM config
  (``lid_wavlm_qat.yaml``: bf16, ``int8_ste``, the framed extractor) trains
  an epoch and builds the JAX CLI's task, and the bf16 one builds the task the JAX CLI builds (bfloat16 heads over a float32
  encoder, as its ``module.dtype`` alone gives) and infers; it trains in
  ``tests/test_torch_bf16_cli.py``."""

import json
import os

import numpy as np
import pytest
import torch

from speechlid_tpu.cli import main_lid as jax_main_lid
from speechlid_tpu.core.config import load_config as jax_load_config
from speechlid_tpu.data.audio_io import write_wav
from speechlid_tpu_torch.cli import main_lid
from speechlid_tpu_torch.cli.serve import build_lid_fn
from speechlid_tpu_torch.core.config import load_config
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SR = 16000
TINY = ["module.n_blocks=1", "module.encoder_dim=32", "module.heads=2", "module.dim_head=16",
        "module.head_dim_head=8", "module.head_num_head=2", "data.batch_size=3",
        "data.buckets_s=[0.5, 1.0]", "trainer.total_epoch=1", "trainer.progress_bar=false",
        "trainer.log_interval=2", "module.schedule=null"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_corpus")
    rng = np.random.RandomState(0)
    texts = {"aa": ["ba ba", "ab", "a b"], "bb": ["cd cd", "dc", "c"]}
    for li, (lang, txts) in enumerate(sorted(texts.items())):
        wav_dir = root / lang / "wav" / "train"
        wav_dir.mkdir(parents=True)
        lines = []
        for i in range(5):
            t = np.arange(int(SR * (0.4 + 0.15 * i))) / SR
            wav = (np.sin(2 * np.pi * (150 + 200 * li) * t)
                   + 0.01 * rng.randn(len(t))).astype(np.float32) * 0.3
            write_wav(str(wav_dir / f"u{i}.wav"), wav, SR)
            lines.append(f"u{i}.wav\t{txts[i % len(txts)]}")
        (root / lang / "train.txt").write_text("\n".join(lines))
        (root / lang / "val.txt").write_text("\n".join(lines[:3]))
    return root


def _langs(corpus, val=True):
    entries = [f"manifest: {corpus / lang / 'train.txt'}"
               + (f", val_manifest: {corpus / lang / 'val.txt'}" if val else "")
               for lang in ("aa", "bb")]
    return "data.langs=[" + ", ".join("{" + e + "}" for e in entries) + "]"


def _args(corpus, exp_dir, *extra, val=True):
    return ["--config-dir", "configs", "--config-name", "lid_supervised",
            _langs(corpus, val), f"exp_dir={exp_dir}", *TINY, *extra]


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """One epoch through each CLI on the same corpus and config."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SPEECHLID_CACHE_DIR", str(tmp_path_factory.mktemp("cli_cache")))
    try:
        port_dir = tmp_path_factory.mktemp("port_exp")
        jax_dir = tmp_path_factory.mktemp("jax_exp")
        main_lid.main(_args(corpus, port_dir) + ["--device", "cpu"])
        jax_main_lid.main(_args(corpus, jax_dir))
    finally:
        mp.undo()
    return port_dir, jax_dir


def test_metrics_jsonl_has_the_jax_cli_lines(runs):
    port_dir, jax_dir = runs
    got, want = _lines(port_dir / "metrics.jsonl"), _lines(jax_dir / "metrics.jsonl")
    assert [(r.get("step"), sorted(r)) for r in got] == [(r.get("step"), sorted(r)) for r in want]
    assert got[0]["config"] == want[0]["config"]  # the task's hyper-parameters, as JSON
    keys = set().union(*(set(r) for r in got))
    assert {"loss", "lr", "avg_train_loss", "avg_val_loss", "val_acc", "val_wer", "eer",
            "cavg", "eer_true", "cavg_true"} <= keys
    assert all(np.isfinite(r["loss"]) for r in got if "loss" in r)


def test_checkpoint_serves_and_stage_test_runs(runs, corpus, tmp_path, monkeypatch):
    port_dir, _ = runs
    ckpt = str(port_dir / "ckpt" / "last.ckpt")
    assert os.path.exists(ckpt)
    lid_fn, index2lang = build_lid_fn(ckpt, device="cpu")
    assert index2lang == {0: "aa", 1: "bb"}
    scores = lid_fn((0.1 * np.random.RandomState(1).randn(1, SR)).astype(np.float32), SR)
    assert scores.shape == (1, 2) and np.isfinite(scores).all()

    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    main_lid.main(_args(corpus, tmp_path / "test_exp", "stage=test",
                        f"trainer.resume_from={ckpt}") + ["--device", "cpu"])
    result = _lines(tmp_path / "test_exp" / "metrics.jsonl")[-1]
    assert 0.0 <= result["val_acc"] <= 1.0 and np.isfinite(result["avg_val_loss"])


@pytest.mark.parametrize("shard", [None, (1, 2)], ids=["one_process", "shard_1_of_2"])
@pytest.mark.parametrize("val", [True, False], ids=["val_manifests", "no_val"])
def test_build_data_feeder_and_task_equal_jax(corpus, tmp_path, monkeypatch, shard, val):
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    if shard:
        monkeypatch.setenv("SPEECHLID_SHARD_ID", str(shard[0]))
        monkeypatch.setenv("SPEECHLID_NUM_SHARDS", str(shard[1]))
    overrides = _args(corpus, tmp_path, val=val)[4:]
    conf = load_config("configs", "lid_supervised", overrides)
    jconf = jax_load_config("configs", "lid_supervised", overrides)
    data, jdata = main_lid.build_data(conf), jax_main_lid.build_data(jconf)
    assert data["lang2index"] == jdata["lang2index"] == {"aa": 0, "bb": 1}
    assert data["lang2vocab"] == jdata["lang2vocab"]
    assert (data["val_dataset"] is None) == (jdata["val_dataset"] is None) == (not val)
    for key in ("dataset", "val_dataset"):
        if data[key] is None:
            continue
        feeder = main_lid.build_feeder(conf, data[key], seed=conf.seed, train=key == "dataset")
        jfeeder = jax_main_lid.build_feeder(jconf, jdata[key], seed=jconf.seed,
                                            train=key == "dataset")
        for _ in range(2):
            pairs = list(zip(feeder, jfeeder, strict=True))
            assert pairs
            for got, want in pairs:
                assert set(got) == set(want)
                for name in want:
                    np.testing.assert_array_equal(got[name], want[name], err_msg=name)
                    assert np.asarray(got[name]).dtype == np.asarray(want[name]).dtype
    task = main_lid.build_task(conf, data, device="cpu")
    jtask = jax_main_lid.build_task(jconf, jdata)
    assert task.hyper_parameters == jtask.hyper_parameters


@pytest.mark.parametrize("override", [
    "trainer.data_parallel=true", "trainer.model_parallel=2", "trainer.use_swa=true",
])
def test_unported_options_raise(corpus, tmp_path, monkeypatch, override):
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    if override == "trainer.data_parallel=true":  # ported: a group of one, the same bits
        for env in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SPEECHLID_SHARD_ID",
                    "SPEECHLID_NUM_SHARDS"):
            monkeypatch.delenv(env, raising=False)
        main_lid.main(_args(corpus, tmp_path, override) + ["--device", "cpu"])
        assert not torch.distributed.is_initialized()  # the CLI left its group
        port_dir = tmp_path / "plain"
        main_lid.main(_args(corpus, port_dir) + ["--device", "cpu"])
        got = torch.load(tmp_path / "ckpt" / "last.ckpt", weights_only=True)["state"]
        want = torch.load(port_dir / "ckpt" / "last.ckpt", weights_only=True)["state"]
        assert got["model"].keys() == want["model"].keys()
        for name, value in want["model"].items():
            assert torch.equal(got["model"][name], value), name
        assert len(got["device_generators"]) == 1
        assert torch.equal(got["device_generators"][0], want["generators"]["device"])
        strip = lambda rows: [{k: v for k, v in r.items() if k != "ts"} for r in rows]  # noqa: E731
        assert strip(_lines(tmp_path / "metrics.jsonl")) == strip(
            _lines(port_dir / "metrics.jsonl"))
        return
    if override == "trainer.use_swa=true":  # ported: SWA trains and saves its average
        main_lid.main(_args(corpus, tmp_path, override, "trainer.total_epoch=2")
                      + ["--device", "cpu"])
        swa = torch.load(tmp_path / "ckpt" / "swa_final.ckpt", weights_only=True)
        assert swa["state"]["swa"]["count"] == 1  # epoch 1 of 2: int(2 · 0.7) = 1
        for name, avg in swa["state"]["swa"]["params"].items():
            assert torch.equal(swa["state"]["model"][name], avg), name
        return
    # trainer.model_parallel=2: ported (tests/test_torch_tp_trainer.py trains it
    # on two ranks); a group of one cannot hold a model axis of two
    for env in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(env, raising=False)
    with pytest.raises(ValueError, match="model_parallel=2 needs a multiple of 2 processes"):
        main_lid.main(_args(corpus, tmp_path, override) + ["--device", "cpu"])
    assert not torch.distributed.is_initialized()  # the CLI left its group


@pytest.mark.parametrize("cli", ["port", "jax"])
def test_unknown_wav_augment_key_raises_type_error(corpus, tmp_path, monkeypatch, cli):
    """``WavAugmentor`` has no ``p_noise``: both CLIs refuse it when they
    build the train feeder."""
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    args = _args(corpus, tmp_path / "exp", "data.wav_augment={p_noise: 0.5}")
    with pytest.raises(TypeError, match="p_noise"):
        if cli == "port":
            main_lid.main(args + ["--device", "cpu"])
        else:
            jax_main_lid.main(args)


def test_wav_augment_trains_and_feeds_jax_lengths(corpus, tmp_path, monkeypatch):
    """``data.wav_augment={speed: true}``: the port's CLI trains a step with
    it on the CPU, and its train feeder gives the batch lengths of the JAX
    CLI's, and its wavs up to the dither (the speed draws are the same; the
    dither is each side's own)."""
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    aug = "data.wav_augment={speed: true}"
    main_lid.main(_args(corpus, tmp_path / "exp", aug, "trainer.train_data_factor=0.25")
                  + ["--device", "cpu"])
    ckpt = torch.load(tmp_path / "exp" / "ckpt" / "last.ckpt", weights_only=True)
    assert ckpt["meta"]["global_step"] == 1
    assert all(np.isfinite(r["avg_val_loss"]) for r in _lines(tmp_path / "exp" / "metrics.jsonl")
               if "avg_val_loss" in r)

    overrides = _args(corpus, tmp_path, aug)[4:]
    conf = load_config("configs", "lid_supervised", overrides)
    jconf = jax_load_config("configs", "lid_supervised", overrides)
    feeder = main_lid.build_feeder(conf, main_lid.build_data(conf)["dataset"], seed=conf.seed)
    jfeeder = jax_main_lid.build_feeder(jconf, jax_main_lid.build_data(jconf)["dataset"],
                                        seed=jconf.seed)
    assert feeder.augmentor.speed and not feeder.augmentor.pitch
    for _ in range(3):
        for got, want in zip(feeder, jfeeder, strict=True):
            np.testing.assert_array_equal(got["wav_lengths"], want["wav_lengths"])
            np.testing.assert_array_equal(got["texts"], want["texts"])
            # the same chain up to the dither, U[0, 1e-5) on each side
            np.testing.assert_allclose(got["wavs"], want["wavs"], rtol=0, atol=1e-4)
    val = main_lid.build_feeder(conf, main_lid.build_data(conf)["val_dataset"], train=False)
    assert val.augmentor is None


def test_device_defaults_to_the_card(corpus, tmp_path, monkeypatch):
    """Without ``--device`` the task is built on ``cuda``: on a machine
    without a card that fails, and nothing falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    with pytest.raises((AssertionError, RuntimeError)):
        main_lid.main(_args(corpus, tmp_path / "exp"))
    assert not (tmp_path / "exp" / "metrics.jsonl").exists()


TINY_WAVLM = ("module.ssl_config={encoder_layers: 1, encoder_embed_dim: 32, "
              "encoder_ffn_embed_dim: 64, encoder_attention_heads: 2, "
              "conv_feature_layers: \"[(16,10,5)] + [(16,3,2)] * 2\", conv_pos: 16, "
              "conv_pos_groups: 4, relative_position_embedding: true, num_buckets: 16, "
              "max_distance: 64, gru_rel_pos: true}")


def test_wavlm_config_trains_across_both_freeze_gates(corpus, tmp_path, monkeypatch):
    """``configs/lid_wavlm.yaml`` with a tiny ``module.ssl_config`` trains
    through the CLI for three epochs (its gates: extractor frozen through
    epoch 1, the transformer through epoch 0), with span masking on; the
    task has the JAX CLI's hyper-parameters, and the checkpoint serves."""
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    args = ["--config-dir", "configs", "--config-name", "lid_wavlm", _langs(corpus),
            f"exp_dir={tmp_path / 'exp'}", TINY_WAVLM, "module.head_dim_head=8",
            "module.head_num_head=2", "data.batch_size=3", "data.buckets_s=[0.5, 1.0]",
            "trainer.total_epoch=3", "trainer.accum_grad=1", "trainer.progress_bar=false",
            "module.schedule=null"]
    frozen = {}
    build_task = main_lid.build_task

    def recording_build_task(conf, data, device="cuda"):
        task = build_task(conf, data, device)
        before = task.before_train_loop

        def record(epoch):
            before(epoch)
            frozen[epoch] = {n.split(".")[2] for n, p in task.model.named_parameters()
                             if not p.requires_grad}
        task.before_train_loop = record
        return task

    monkeypatch.setattr(main_lid, "build_task", recording_build_task)
    main_lid.main(args + ["--device", "cpu"])
    assert frozen == {0: {"feature_extractor", "post_extract_proj", "layers", "pos_conv",
                          "encoder_layer_norm"},
                      1: {"feature_extractor", "post_extract_proj"}, 2: set()}
    lines = _lines(tmp_path / "exp" / "metrics.jsonl")
    assert sum("avg_val_loss" in r for r in lines) == 3
    assert all(np.isfinite(r["loss"]) for r in lines if "loss" in r)
    lid_fn, _ = build_lid_fn(str(tmp_path / "exp" / "ckpt" / "last.ckpt"), device="cpu")
    scores = lid_fn((0.1 * np.random.RandomState(2).randn(1, SR)).astype(np.float32), SR)
    assert scores.shape == (1, 2) and np.isfinite(scores).all()
    conf = load_config("configs", "lid_wavlm", args[4:])
    jconf = jax_load_config("configs", "lid_wavlm", args[4:])
    data, jdata = main_lid.build_data(conf), jax_main_lid.build_data(jconf)
    assert build_task(conf, data, device="cpu").hyper_parameters == \
        jax_main_lid.build_task(jconf, jdata).hyper_parameters


TINY_WAV2VEC = ("module.ssl_config={encoder_layers: 1, encoder_embed_dim: 32, "
                "encoder_ffn_embed_dim: 64, encoder_attention_heads: 2, "
                "conv_feature_layers: \"[(16,10,5)] + [(16,3,2)] * 2\", conv_pos: 16, "
                "conv_pos_groups: 4, extractor_mode: layer_norm, layer_norm_first: true, "
                "normalize: true, mask_prob: 0.15, mask_channel_prob: 0.15}")


@pytest.mark.parametrize("cli", ["port", "jax"])
def test_ssl_configs_that_raise_as_in_jax(corpus, tmp_path, monkeypatch, cli):
    """``configs/lid_wav2vec.yaml``'s ``wav_augment`` (``speed_shift``)
    raises ``TypeError`` in both CLIs when the train feeder is built; the
    int8 WavLM config trains an epoch in the port with a tiny
    ``module.ssl_config`` and builds the JAX CLI's task, and the bf16 one
    builds the task the JAX CLI builds and infers in bfloat16."""
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    args = ["--config-dir", "configs", "--config-name", "lid_wav2vec", _langs(corpus),
            f"exp_dir={tmp_path / 'exp'}", TINY_WAV2VEC]
    with pytest.raises(TypeError, match="speed_shift"):
        if cli == "port":
            main_lid.main(args + ["--device", "cpu"])
        else:
            jax_main_lid.main(args)
    if cli == "port":
        qat = [_langs(corpus), f"exp_dir={tmp_path / 'qat'}", TINY_WAVLM,
               "module.head_dim_head=8", "module.head_num_head=2", "data.batch_size=3",
               "data.buckets_s=[0.5, 1.0]", "trainer.total_epoch=1",
               "trainer.progress_bar=false"]
        main_lid.main(["--config-dir", "configs", "--config-name", "lid_wavlm_qat", *qat,
                       "--device", "cpu"])
        lines = _lines(tmp_path / "qat" / "metrics.jsonl")
        assert any("avg_val_loss" in r for r in lines)
        assert all(np.isfinite(r["loss"]) for r in lines if "loss" in r)
        conf = load_config("configs", "lid_wavlm_qat", qat)
        task = main_lid.build_task(conf, main_lid.build_data(conf), device="cpu")
        jconf = jax_load_config("configs", "lid_wavlm_qat", qat)
        assert task.hyper_parameters == jax_main_lid.build_task(
            jconf, jax_main_lid.build_data(jconf)).hyper_parameters
        upstream = task.model.featurizer.upstream
        assert upstream.layers[0].fc1.quant_dot == "int8_ste"
        assert upstream.feature_extractor.framed_dot is not None
        overrides = [_langs(corpus), TINY_WAVLM, "module.head_dim_head=8",
                     "module.head_num_head=2"]
        conf = load_config("configs", "lid_wavlm_bf16", overrides)
        task = main_lid.build_task(conf, main_lid.build_data(conf), device="cpu")
        jconf = jax_load_config("configs", "lid_wavlm_bf16", overrides)
        assert task.hyper_parameters == jax_main_lid.build_task(
            jconf, jax_main_lid.build_data(jconf)).hyper_parameters
        assert task.dtype == torch.bfloat16
        assert task.model.heads.heads[0].out.compute_dtype == torch.bfloat16
        assert task.model.featurizer.upstream.layers[0].fc1.compute_dtype == torch.float32
        wav = torch.from_numpy((0.1 * np.random.RandomState(4).randn(2, SR)).astype(np.float32))
        out = task.infer_fn()(wav, torch.tensor([SR, SR // 2]))
        assert out["logits"].dtype == torch.float32 and torch.isfinite(out["scores"]).all()


def test_wav2vec_config_trains_without_its_augmentor(corpus, tmp_path, monkeypatch):
    """``configs/lid_wav2vec.yaml`` (pre-LN, layer-norm extractor, wave
    normalisation, span and channel masking) with a tiny ``ssl_config`` and
    ``data.wav_augment`` taken out trains an epoch and serves."""
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    main_lid.main(["--config-dir", "configs", "--config-name", "lid_wav2vec", _langs(corpus),
                   f"exp_dir={tmp_path / 'exp'}", TINY_WAV2VEC, "data.wav_augment=null",
                   "module.head_dim_head=8", "module.head_num_head=2", "data.batch_size=3",
                   "data.buckets_s=[0.5, 1.0]", "trainer.total_epoch=1",
                   "trainer.progress_bar=false", "module.schedule=null", "--device", "cpu"])
    lines = _lines(tmp_path / "exp" / "metrics.jsonl")
    assert any("avg_val_loss" in r for r in lines)
    assert all(np.isfinite(r["loss"]) for r in lines if "loss" in r)
    lid_fn, _ = build_lid_fn(str(tmp_path / "exp" / "ckpt" / "last.ckpt"), device="cpu")
    scores = lid_fn((0.1 * np.random.RandomState(3).randn(1, SR)).astype(np.float32), SR)
    assert scores.shape == (1, 2) and np.isfinite(scores).all()


TINY_CROSS_SSL = {
    "lid_cross_wavlm": TINY_WAVLM,
    "lid_cross_wav2vec": ("module.ssl_config={encoder_layers: 1, encoder_embed_dim: 32, "
                          "encoder_ffn_embed_dim: 64, encoder_attention_heads: 2, "
                          "conv_feature_layers: \"[(16,10,5)] + [(16,3,2)] * 2\", "
                          "conv_pos: 16, conv_pos_groups: 4}"),
}
CROSS_RUNS = {
    "lid_cross_xvector": ("lid_cross", ["module.backend=xvector"]),
    "lid_cross_linear": ("lid_cross", ["module.backend=linear"]),
    "lid_cross_wavlm": ("lid_cross_wavlm", [TINY_CROSS_SSL["lid_cross_wavlm"]]),
    "lid_cross_wav2vec": ("lid_cross_wav2vec", [TINY_CROSS_SSL["lid_cross_wav2vec"]]),
}
SHORT_CLIPS = ["data.batch_size=3", "data.buckets_s=[0.5, 1.0]", "trainer.total_epoch=1",
               "trainer.progress_bar=false"]


def _build_both(name, overrides):
    """The task the port's ``build_task`` builds on the CPU and the JAX
    CLI's, from the same config and overrides."""
    conf, jconf = load_config("configs", name, overrides), jax_load_config("configs", name,
                                                                         overrides)
    return (main_lid.build_task(conf, main_lid.build_data(conf), device="cpu"),
            jax_main_lid.build_task(jconf, jax_main_lid.build_data(jconf)))


@pytest.mark.parametrize("run", CROSS_RUNS)
def test_cross_entropy_configs_train_test_and_match_jax(corpus, tmp_path, monkeypatch, run):
    """A ``module.task: lid_cross_entropy`` config trains an epoch on the
    CPU (its plateau lr or tristage schedule, ``val_acc`` the monitor),
    writes a checkpoint and finite metrics, and runs ``stage=test`` from the
    checkpoint; its task has the JAX CLI's hyper-parameters."""
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    name, extra = CROSS_RUNS[run]
    overrides = [_langs(corpus), f"exp_dir={tmp_path / 'exp'}", *SHORT_CLIPS, *extra]
    main_lid.main(["--config-dir", "configs", "--config-name", name, *overrides,
                   "--device", "cpu"])
    ckpt = tmp_path / "exp" / "ckpt" / "last.ckpt"
    saved = torch.load(ckpt, weights_only=True)
    assert saved["meta"]["global_step"] > 0
    lines = _lines(tmp_path / "exp" / "metrics.jsonl")
    evals = [r for r in lines if "val_acc" in r]
    assert len(evals) == 1 and {"avg_val_loss", "eer", "cavg"} <= set(evals[0])
    assert all(np.isfinite(evals[0][k]) for k in ("avg_val_loss", "val_acc", "eer", "cavg"))
    assert all(np.isfinite(r["loss"]) and 0.0 <= r["acc"] <= 1.0 for r in lines if "loss" in r)
    main_lid.main(["--config-dir", "configs", "--config-name", name, *overrides[:1],
                   f"exp_dir={tmp_path / 'test'}", *SHORT_CLIPS, *extra, "stage=test",
                   f"trainer.resume_from={ckpt}", "--device", "cpu"])
    result = _lines(tmp_path / "test" / "metrics.jsonl")[-1]
    assert result["val_acc"] == evals[0]["val_acc"]
    task, jtask = _build_both(name, overrides)
    assert task.hyper_parameters == jtask.hyper_parameters
    assert task.hyper_parameters["num_classes"] == 2


def test_asr_config_trains_tests_and_matches_jax(corpus, tmp_path, monkeypatch):
    """``configs/asr.yaml`` on one language (its vocabulary the task's)
    trains an epoch on the CPU, writes a checkpoint and finite metrics, and
    runs ``stage=test`` from it; its task has the JAX CLI's
    hyper-parameters."""
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    one_lang = (f"data.langs=[{{manifest: {corpus / 'aa' / 'train.txt'}, "
                f"val_manifest: {corpus / 'aa' / 'val.txt'}}}]")
    overrides = [one_lang, f"exp_dir={tmp_path / 'exp'}", *SHORT_CLIPS, "module.n_blocks=1",
                 "module.encoder_dim=32", "module.heads=2", "module.dim_head=16",
                 "module.head_dim_head=8", "module.head_num_head=2", "module.schedule=null"]
    main_lid.main(["--config-dir", "configs", "--config-name", "asr", *overrides,
                   "--device", "cpu"])
    ckpt = tmp_path / "exp" / "ckpt" / "last.ckpt"
    assert torch.load(ckpt, weights_only=True)["meta"]["global_step"] > 0
    lines = _lines(tmp_path / "exp" / "metrics.jsonl")
    evals = [r for r in lines if "val_wer" in r]
    assert len(evals) == 1 and np.isfinite(evals[0]["avg_val_loss"])
    assert 0.0 <= evals[0]["val_wer"] and all(np.isfinite(r["loss"]) for r in lines
                                              if "loss" in r)
    main_lid.main(["--config-dir", "configs", "--config-name", "asr", *overrides[:1],
                   f"exp_dir={tmp_path / 'test'}", *overrides[2:], "stage=test",
                   f"trainer.resume_from={ckpt}", "--device", "cpu"])
    result = _lines(tmp_path / "test" / "metrics.jsonl")[-1]
    assert result["val_wer"] == evals[0]["val_wer"]
    task, jtask = _build_both("asr", overrides)
    assert task.hyper_parameters == jtask.hyper_parameters
    assert task.hyper_parameters["vocab"] == task.tokenizer.export_vocab()
