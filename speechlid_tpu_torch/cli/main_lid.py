"""Train / evaluate a task from a YAML config tree (port of
``speechlid_tpu/cli/main_lid.py``): ``module.task`` ``lid_asr`` (the joint
LID+ASR model), ``lid_cross_entropy`` (the cross-entropy LID classifier on
fbank or SSL features, ``configs/lid_cross*.yaml``) or ``asr`` (standalone
CTC ASR on the first language's vocabulary, ``configs/asr.yaml``).

The same config schema (trainer / module / data / logger / stage groups, the
loader of ``core/config.py``), the same data pipeline (per-language
manifests → ``MergedDataset`` → ``MultiBatchSampler`` → ``BucketFeeder``),
the same callbacks and ``Trainer`` arguments.  It runs on the card unless
``--device cpu`` asks for the CPU; it never moves to the CPU by itself.

Usage:
    python -m speechlid_tpu_torch.cli.main_lid --config-dir configs \
        --config-name lid_supervised [trainer.total_epoch=10 ...] [--device cpu]

``trainer.use_swa`` / ``swa_start_ratio`` average the weights (SWA, with
the BatchNorm re-estimation, ``core/trainer.py``); ``module.optimizer:
novograd`` is Novograd.

``trainer.data_parallel=true`` trains data-parallel, one process per card:

    python -m torch.distributed.run --nproc-per-node N \
        -m speechlid_tpu_torch.cli.main_lid --config-dir configs \
        --config-name lid_supervised trainer.data_parallel=true

Each process joins the group from the launcher's environment (nccl on the
card, gloo with ``--device cpu``; without a launcher a group of one), runs
on ``cuda:LOCAL_RANK`` unless ``--device`` says otherwise, and feeds its
own sampler shard of ``data.batch_size`` rows, so the global batch is N ×
``data.batch_size`` (a JAX process splits ``batch_size`` over its local
devices instead).  ``SPEECHLID_SHARD_ID`` / ``SPEECHLID_NUM_SHARDS``, where
set, must agree with the data index and the number of data indices.

``trainer.model_parallel=N`` (N > 1) lays the model out over a model axis
of N ranks (tensor and expert parallelism, ``parallel/sharding.py``), with
or without ``trainer.data_parallel``, as the JAX CLI builds its mesh either
way: the group is joined from the environment, the mesh is
``make_mesh(model=N)`` (the world a multiple of N), the rules
``EP_RULES + CONFORMER_TP_RULES + WAVLM_TP_RULES``, and the sampler is
sharded by data index (``shard_id = rank // N``, ``num_shards = world //
N``): the ranks of a model group take the same rows.  With a task whose
modules no rule splits the model is replicated over the model group and
trains as a data-parallel run does.
``data.wav_augment`` builds the train feeder's ``WavAugmentor`` from its
keys (an unknown key raises ``TypeError``, as in the JAX CLI).  The JAX
CLI's persistent compilation cache has no counterpart here.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List

from speechlid_tpu_torch.core.callbacks import CkptCallback, LrCallback, ProfileCallback
from speechlid_tpu_torch.core.config import load_config
from speechlid_tpu_torch.core.loggers import ConsoleLogger, JsonlLogger, Logger
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.data import (
    BucketFeeder,
    CTCTokenizer,
    MergedDataset,
    MultiBatchSampler,
    RawManifest,
)
from speechlid_tpu_torch.data.augmentor import WavAugmentor
from speechlid_tpu_torch.parallel import (
    CONFORMER_TP_RULES,
    EP_RULES,
    WAVLM_TP_RULES,
    initialize_multihost,
    initialized,
    make_mesh,
    process_count,
    shutdown,
)


def build_data(conf) -> Dict:
    """Per-language train (+optional val) manifests → merged datasets."""
    train_manifests, val_manifests, tokenizers = [], [], {}
    lang2index, lang2vocab = {}, {}
    for i, lang_conf in enumerate(conf.data.langs):
        m = RawManifest(
            lang_conf.manifest,
            max_duration=conf.data.get("max_duration", 16.7),
            train=True,
            source=conf.data.get("source", "xf"),
        )
        train_manifests.append(m)
        lang = m.lang()
        lang2index[lang] = i
        vocab = lang_conf.get("vocab") if isinstance(lang_conf, dict) else None
        tok = CTCTokenizer(vocab if vocab else m.export_vocab())
        tokenizers[lang] = tok
        lang2vocab[lang] = tok.vocab_size
        val_path = (
            lang_conf.get("val_manifest") if isinstance(lang_conf, dict) else None
        )
        if val_path:
            val_manifests.append(
                RawManifest(
                    val_path,
                    max_duration=conf.data.get("max_duration_eval", 16.7),
                    train=False,
                    source=conf.data.get("source", "xf"),
                )
            )
    dataset = MergedDataset(train_manifests, tokenizers, lang2index)
    val_dataset = (
        MergedDataset(val_manifests, tokenizers, lang2index)
        if val_manifests
        else None
    )
    return {
        "dataset": dataset,
        "val_dataset": val_dataset,
        "tokenizers": tokenizers,
        "lang2index": lang2index,
        "lang2vocab": lang2vocab,
    }


def build_feeder(conf, dataset, seed=0, train=True, shard_id=None,
                 num_shards=None) -> BucketFeeder:
    """The bucketed feeder of ``dataset``'s shard ``shard_id`` of
    ``num_shards`` (default: ``SPEECHLID_SHARD_ID`` / ``SPEECHLID_NUM_SHARDS``,
    else the whole set)."""
    sampler = MultiBatchSampler(
        dataset,
        batch_size=conf.data.get("batch_size", 8),
        drop_last=conf.data.get("drop_last", False),
        seed=seed,
        shard_id=int(os.environ.get("SPEECHLID_SHARD_ID", 0)) if shard_id is None else shard_id,
        num_shards=(int(os.environ.get("SPEECHLID_NUM_SHARDS", 1)) if num_shards is None
                    else num_shards),
    )
    augmentor = None
    aug_conf = conf.data.get("wav_augment") if train else None
    if aug_conf:
        augmentor = WavAugmentor(
            sample_rate=conf.data.get("sample_rate", 16000),
            **(aug_conf.to_dict() if hasattr(aug_conf, "to_dict") else dict(aug_conf)),
        )
    return BucketFeeder(
        dataset,
        sampler,
        sample_rate=conf.data.get("sample_rate", 16000),
        buckets_s=tuple(conf.data.get("buckets_s", [2.0, 4.0, 8.0, 13.0, 17.0])),
        max_text_len=conf.data.get("max_text_len", 256),
        augmentor=augmentor,
    )


def build_task(conf, data, device: str = "cuda"):
    module_conf = conf.module.to_dict() if hasattr(conf.module, "to_dict") else dict(conf.module)
    task_type = module_conf.pop("task", "lid_asr")
    if task_type == "lid_asr":
        from speechlid_tpu_torch.tasks.lid_asr import LidASRTask

        return LidASRTask(
            lang2vocab=data["lang2vocab"],
            lang2index=data["lang2index"],
            tokenizers=data["tokenizers"],
            device=device,
            **module_conf,
        )
    if task_type == "lid_cross_entropy":
        from speechlid_tpu_torch.tasks.lid_cross_entropy import LidCrossEntropyTask

        return LidCrossEntropyTask(num_classes=len(data["lang2index"]), device=device,
                                   **module_conf)
    if task_type == "asr":
        from speechlid_tpu_torch.tasks.asr import ASRTask

        lang = next(iter(data["tokenizers"]))
        return ASRTask(vocab=data["tokenizers"][lang].export_vocab(), device=device,
                       **module_conf)
    raise ValueError(f"unknown module.task: {task_type}")


def main(argv: List[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-dir", default="configs")
    parser.add_argument("--config-name", required=True)
    parser.add_argument("--device", default=None,
                        help="cuda (default; cuda:LOCAL_RANK under trainer.data_parallel) or cpu")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    args = parser.parse_args(argv)

    conf = load_config(args.config_dir, args.config_name, args.overrides)
    logging.basicConfig(
        level=getattr(logging, str(conf.get("log_level", "INFO"))),
        format="%(asctime)s %(levelname)s %(message)s",
        force=True,
    )
    logging.info("config: %s", conf.to_dict())
    model_parallel = int(conf.trainer.get("model_parallel", 1))
    if not conf.trainer.get("data_parallel", False) and model_parallel <= 1:
        run(conf, args.device or "cuda")
        return
    device = args.device or f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    joined = not initialized()  # a caller's own group stays the caller's
    initialize_multihost(device=device)
    try:
        if model_parallel > 1 and process_count() % model_parallel:
            raise ValueError(f"trainer.model_parallel={model_parallel} needs a multiple of "
                             f"{model_parallel} processes, the group has {process_count()}")
        mesh = make_mesh(model=max(model_parallel, 1))
        rules = EP_RULES + CONFORMER_TP_RULES + WAVLM_TP_RULES if model_parallel > 1 else None
        run(conf, device, mesh=mesh, param_rules=rules)
    finally:
        if joined:
            shutdown()


def _shard(mesh) -> dict:
    """This rank's sampler shard, by data index; the environment's, where
    set, must agree."""
    if mesh is None:
        return {}
    shard = {"shard_id": mesh.index("data"), "num_shards": mesh.data}
    for key, env in (("shard_id", "SPEECHLID_SHARD_ID"), ("num_shards", "SPEECHLID_NUM_SHARDS")):
        if env in os.environ and int(os.environ[env]) != shard[key]:
            raise ValueError(f"{env}={os.environ[env]} disagrees with the process group's "
                             f"{key} {shard[key]}")
    return shard


def run(conf, device: str, mesh=None, param_rules=None) -> None:
    """Train or test one task from ``conf`` on ``device`` (over ``mesh``'s
    ranks where given, laid out by ``param_rules``)."""
    shard = _shard(mesh)
    data = build_data(conf)
    task = build_task(conf, data, device=device)

    exp_dir = conf.get("exp_dir", "exp/default")
    callbacks = [
        CkptCallback(
            os.path.join(exp_dir, "ckpt"),
            monitor=conf.trainer.get("monitor", "avg_val_loss"),
            mode=conf.trainer.get("monitor_mode", "min"),
            save_topk=conf.trainer.get("save_topk", 3),
        ),
        LrCallback(),
        ProfileCallback(),
    ]
    logger = Logger(
        [ConsoleLogger(), JsonlLogger(os.path.join(exp_dir, "metrics.jsonl"))],
        train_interval=conf.trainer.get("log_interval", 10),
    )

    trainer = Trainer(
        total_epoch=conf.trainer.get("total_epoch", 10),
        accum_grad=conf.trainer.get("accum_grad", 1),
        eval_interval=conf.trainer.get("eval_interval", 1),
        train_data_factor=conf.trainer.get("train_data_factor", 1.0),
        use_swa=conf.trainer.get("use_swa", False),
        swa_start_ratio=conf.trainer.get("swa_start_ratio", 0.7),
        lr_exec_mode=conf.trainer.get("lr_exec_mode", "step"),
        seed=conf.get("seed", 0),
        callbacks=callbacks,
        loggers=logger,
        mesh=mesh,
        param_rules=param_rules,
        checkpoint_path=conf.trainer.get("resume_from") or None,
        use_progress_bar=conf.trainer.get("progress_bar", True),
        device=device,
    )

    stage = conf.get("stage", "train")
    train_feeder = build_feeder(conf, data["dataset"], seed=conf.get("seed", 0), **shard)
    val_feeder = (
        build_feeder(conf, data["val_dataset"], seed=conf.get("seed", 0),
                     train=False, **shard)
        if data["val_dataset"] is not None
        else train_feeder
    )
    if stage == "train":
        trainer.fit(task, train_feeder, val_feeder)
    elif stage == "test":
        trainer.test(task, val_feeder)
    else:
        raise ValueError(f"unknown stage: {stage}")
    logger.finish()


if __name__ == "__main__":
    main()
