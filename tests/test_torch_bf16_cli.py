"""``configs/lid_wavlm_bf16.yaml`` through the port's CLIs on the CPU, with
a tiny ``module.ssl_config`` that carries ``dtype: bfloat16`` (the encoder
then computes in bfloat16 as well as the heads; the config's
``module.dtype`` alone would leave it float32, as in the JAX CLI): two
epochs of training across the config's freeze gates, a checkpoint whose
hyper-parameters bring the dtype back, and ``cli.test_lid`` clean on it,
whose ``acc`` is the ``val_acc`` the training CLI logged last."""

import json

import numpy as np
import pytest
import torch

from speechlid_tpu_torch.cli import main_lid, test_lid
from speechlid_tpu_torch.cli.serve import build_lid_fn
from speechlid_tpu_torch.core.checkpoint import load_checkpoint
from tests.test_torch_cli import SR, _langs, corpus  # noqa: F401
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TINY_WAVLM_BF16 = ("module.ssl_config={encoder_layers: 1, encoder_embed_dim: 32, "
                   "encoder_ffn_embed_dim: 64, encoder_attention_heads: 2, "
                   "conv_feature_layers: \"[(16,10,5)] + [(16,3,2)] * 2\", conv_pos: 16, "
                   "conv_pos_groups: 4, relative_position_embedding: true, num_buckets: 16, "
                   "max_distance: 64, gru_rel_pos: true, dtype: bfloat16}")


def test_bf16_config_trains_and_evaluates(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))
    exp = tmp_path / "exp"
    config = ["--config-dir", "configs", "--config-name", "lid_wavlm_bf16", _langs(corpus),
              TINY_WAVLM_BF16, "module.head_dim_head=8", "module.head_num_head=2",
              "data.batch_size=3", "data.buckets_s=[0.5, 1.0]", "module.schedule=null"]
    tasks = []
    build_task = main_lid.build_task

    def recording_build_task(conf, data, device="cuda"):
        tasks.append(build_task(conf, data, device))
        return tasks[-1]

    monkeypatch.setattr(main_lid, "build_task", recording_build_task)
    main_lid.main(config + [f"exp_dir={exp}", "trainer.total_epoch=2",
                            "trainer.progress_bar=false", "--device", "cpu"])
    (task,) = tasks
    assert task.dtype == torch.bfloat16
    assert task.model.featurizer.upstream.layers[0].fc1.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in task.model.parameters())
    with open(exp / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    evals = [r for r in lines if "val_acc" in r]
    assert len(evals) == 2 and all(np.isfinite(r["avg_val_loss"]) for r in evals)
    assert all(np.isfinite(r["loss"]) for r in lines if "loss" in r)
    last = str(exp / "ckpt" / "last.ckpt")
    hparams = load_checkpoint(last)["hyper_parameters"]
    assert hparams["dtype"] == "bfloat16" and hparams["ssl_config"]["dtype"] == "bfloat16"
    lid_fn, _ = build_lid_fn(last, device="cpu")
    scores = lid_fn((0.1 * np.random.RandomState(5).randn(1, SR)).astype(np.float32), SR)
    assert scores.dtype == np.float32 and np.isfinite(scores).all()
    result = test_lid.main(["--ckpt", last, *config, "--device", "cpu"])
    assert result["acc"] == evals[-1]["val_acc"]
