"""The rank processes of ``tests/test_torch_dist.py`` and of the tests of
tensor, expert, pipeline and sequence parallelism
(``tests/test_torch_{sharding,tp_trainer,pipeline}.py``): each job runs in N
processes of a gloo group on the CPU and writes what it saw to
``<dir>/rank<r>.pt``.  This module imports the port only (no JAX).

    python -m tests.torch_dist_ranks JOB RANK WORLD DIR

``DIR/inputs.pt`` holds the job's inputs, written by the test.
"""

from __future__ import annotations

import os
import sys
from datetime import timedelta

import numpy as np
import torch

from speechlid_tpu_torch.core.callbacks import Callback
from speechlid_tpu_torch.metrics import CAvg, EER, Accuracy, WordErrorRate
from speechlid_tpu_torch.metrics.dist import allgather_rows, allreduce_sum_counts
from speechlid_tpu_torch.models import conformer as pconformer
from speechlid_tpu_torch.models.batchnorm import flax_batch_norm
from speechlid_tpu_torch.models.conformer import MaskedBatchNorm
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.parallel import (
    CONFORMER_TP_RULES,
    EP_RULES,
    WAVLM_TP_RULES,
    describe_shardings,
    gather_stages,
    gather_time,
    initialize_multihost,
    make_mesh,
    make_param_sharder,
    pipeline_apply,
    shard_batch,
    shard_time,
    shutdown,
    sp_wav2mel,
)

TIMEOUT = timedelta(seconds=60)  # a hung collective fails fast


def rows_of(rank: int, world: int, array):
    """Rank ``rank``'s contiguous share of the leading axis."""
    n = len(array) // world
    return array[rank * n:(rank + 1) * n]


def masked_bn_run(inputs: dict, rank: int, world: int) -> dict:
    out = {}
    for case in ("mask", "no_mask"):
        x = rows_of(rank, world, inputs["bn_x"]).clone().requires_grad_(True)
        mask = rows_of(rank, world, inputs["bn_mask"]) if case == "mask" else None
        bn = MaskedBatchNorm(x.shape[-1])
        bn.load_state_dict(inputs["bn_state"])
        bn.train()
        y = bn(x, mask)
        (y * rows_of(rank, world, inputs["bn_cot"])).sum().backward()
        out[case] = {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
                     "dbias": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                     "running_var": bn.running_var.clone()}
    return out


def flax_bn_run(inputs: dict, rank: int, world: int) -> dict:
    x = rows_of(rank, world, inputs["fbn_x"]).clone().requires_grad_(True)
    weight = inputs["fbn_weight"].clone().requires_grad_(True)
    bias = inputs["fbn_bias"].clone().requires_grad_(True)
    mean, var = inputs["fbn_mean"].clone(), inputs["fbn_var"].clone()
    y = flax_batch_norm(x, mean, var, weight, bias, training=True, dim=1)
    (y * rows_of(rank, world, inputs["fbn_cot"])).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": weight.grad, "dbias": bias.grad,
            "running_mean": mean, "running_var": var}


def job_collectives(inputs: dict, rank: int, world: int) -> dict:
    """``allgather_rows`` over uneven rows, ``allreduce_sum_counts``, the
    metrics' ``sync`` on this rank's trials, and both BatchNorms synced and
    (the control) unsynced."""
    out = {"gathered": allgather_rows(np.full((rank + 1, 3), rank, np.float64), 3),
           "empty": allgather_rows(np.zeros((0, 2)) if rank == 0 else np.ones((2, 2)), 2),
           "counts": allreduce_sum_counts(rank + 1.0, 10.0 * rank)}
    scores, langs = rows_of(rank, world, inputs["scores"]), rows_of(rank, world, inputs["langs"])
    eer, cavg, acc, wer = EER(3), CAvg(3), Accuracy(), WordErrorRate()
    eer.update(scores, langs)
    cavg.update(scores, langs)
    acc.update(scores, langs)
    wer.update(*[list(rows_of(rank, world, inputs[k])) for k in ("hyps", "refs")])
    for metric in (eer, cavg, acc, wer):
        metric.sync()
    out["metrics"] = {"eer": eer.compute(), "cavg": cavg.compute(), "acc": acc.compute(),
                      "wer": wer.compute()}
    out["masked_bn"] = masked_bn_run(inputs, rank, world)
    out["flax_bn"] = flax_bn_run(inputs, rank, world)
    # the control: the same layers with each rank's statistics only
    from speechlid_tpu_torch.models import batchnorm as pbatchnorm

    local = lambda: False  # noqa: E731
    saved = (pconformer.data_parallel, pbatchnorm.data_parallel)
    pconformer.data_parallel = pbatchnorm.data_parallel = local
    try:
        out["masked_bn_local"] = masked_bn_run(inputs, rank, world)
        out["flax_bn_local"] = flax_bn_run(inputs, rank, world)
    finally:
        pconformer.data_parallel, pbatchnorm.data_parallel = saved
    return out


class _EvalMetrics(Callback):
    def __init__(self):
        super().__init__()
        self.evals, self.losses = [], []

    def after_train_loop(self, step, metrics):
        self.losses.append(metrics["loss"])

    def after_eval_epoch(self, epoch, metrics):
        self.evals.append(dict(metrics))


def _fit(inputs: dict, rank: int, world: int, model: int = 1, rules=None, epochs: int = 1,
         ckpt_dir=None) -> dict:
    from speechlid_tpu_torch.core.callbacks import CkptCallback
    from speechlid_tpu_torch.core.trainer import Trainer
    from speechlid_tpu_torch.data.tokenizer import CTCTokenizer
    from speechlid_tpu_torch.tasks.lid_asr import LidASRTask

    hp = dict(inputs["hparams"])
    hp["tokenizers"] = {k: CTCTokenizer(v) for k, v in inputs["vocabs"].items()}
    task = LidASRTask(**hp, device="cpu")
    task.model.load_state_dict(inputs["state"])
    task.init_parameters = lambda generator: None  # keep the weights it was given
    mesh = make_mesh(model=model)
    split = lambda batches: [shard_batch(mesh, b) for b in batches]  # noqa: E731
    rec = _EvalMetrics()
    callbacks = [rec] + ([CkptCallback(ckpt_dir, save_topk=3)] if ckpt_dir else [])
    trainer = Trainer(total_epoch=epochs, use_progress_bar=False, device="cpu",
                      callbacks=callbacks, mesh=mesh, param_rules=rules)
    trainer.fit(task, split(inputs["train"]), split(inputs["val"]))
    opt = trainer.optimizer
    return {"state": convert.full_state(task.model), "evals": rec.evals, "losses": rec.losses,
            "steps": opt.count, "lr_sum": sum(opt.lr_at(i) for i in range(opt.count)),
            "report": describe_shardings(task.model)}


def job_trainer(inputs: dict, rank: int, world: int) -> dict:
    """``Trainer.fit`` on this rank's rows of every batch, with global
    BatchNorm statistics and, the control, with each rank's own."""
    out = {"synced": _fit(inputs, rank, world)}
    local = pconformer.data_parallel
    pconformer.data_parallel = lambda: False
    try:
        out["local"] = _fit(inputs, rank, world)
    finally:
        pconformer.data_parallel = local
    return out


def job_ckpt_async(inputs: dict, rank: int, world: int) -> dict:
    """``Trainer.fit`` under a data mesh with ``CkptCallback``'s async
    writes into this rank's own directory; every write is recorded (and
    slowed, so that writes are in flight while training goes on)."""
    import time

    from speechlid_tpu_torch.core import checkpoint

    written = []
    write = checkpoint._write

    def slow_write(paths, payload):
        time.sleep(0.2)
        write(paths, payload)
        written.extend(paths)

    checkpoint._write = slow_write
    out = _fit(inputs, rank, world, epochs=2, ckpt_dir=inputs["ckpt_dirs"][rank])
    out["written"] = list(written)  # fit returned: every write has landed
    return out


def job_cli(inputs: dict, rank: int, world: int) -> dict:
    """``main_lid`` with ``trainer.data_parallel=true``; each rank names its
    own ``exp_dir``, so what rank 1 would write would show."""
    from speechlid_tpu_torch.cli import main_lid

    trainers, full = [], []

    class Recorded(main_lid.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            trainers.append(self)

        def fit(self, *args, **kw):
            super().fit(*args, **kw)
            full.append(convert.full_state(self.module.model))  # while the group is up

    main_lid.Trainer = Recorded
    main_lid.main(inputs["args"] + [f"exp_dir={inputs['exp_dirs'][rank]}", "--device", "cpu"])
    (trainer,) = trainers
    return {"state": trainer.module.model.state_dict(), "steps": trainer.optimizer.count,
            "mesh": trainer.mesh.shape, "full_state": full[0],
            "report": describe_shardings(trainer.module.model)}


def job_tp_fit(inputs: dict, rank: int, world: int) -> dict:
    """``Trainer.fit`` with ``param_rules`` on a (world / model, model)
    mesh; with ``control``, tp alone (the heads replicated, so that every
    rank runs the own head) with the BatchNorm statistics taken over the
    world instead of the data group."""
    rules = EP_RULES + CONFORMER_TP_RULES
    model = inputs["model"]
    out = {"run": _fit(inputs, rank, world, model, rules, inputs.get("epochs", 1),
                       inputs.get("ckpt_dirs", [None] * world)[rank])}
    if inputs.get("control"):
        from speechlid_tpu_torch.parallel.mesh import world_group

        saved = pconformer.data_group
        pconformer.data_group = world_group
        try:
            out["control"] = _fit(inputs, rank, world, model, CONFORMER_TP_RULES)
        finally:
            pconformer.data_group = saved
    return out


def _grads(model) -> dict:
    """Every parameter's gradient, whole (gathered over the model group)."""
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return model.layout.full_state(grads, params_only=True)


def job_tp_model(inputs: dict, rank: int, world: int) -> dict:
    """The tiny flagship and a tiny WavLM laid out over a model axis of
    ``world`` ranks: the eval forward and its gradient (gathered whole),
    the layout's report, and the whole state gathered back."""
    from speechlid_tpu_torch.models.wavlm import WavLM, WavLMConfig
    from speechlid_tpu_torch.ops.ctc import ctc_loss
    from speechlid_tpu_torch.tasks.lid_asr import LidASRTask

    mesh = make_mesh(model=world)
    out = {}
    for case in inputs["lid"]:
        model = LidASRTask(**case["hparams"], device="cpu").model
        model.load_state_dict(case["state"])
        model.eval()
        make_param_sharder(mesh, EP_RULES + CONFORMER_TP_RULES)(model)
        logits, feat_lens = model(case["x"], case["lengths"])
        langs = case["langs"]
        own = logits[langs, torch.arange(len(langs))]
        loss = ctc_loss(torch.log_softmax(own, dim=-1), case["labels"], feat_lens,
                        case["label_lengths"], blank=-1, reduction="none").mean()
        loss.backward()
        out[case["name"]] = {"logits": logits.detach(), "loss": loss.detach(),
                             "grads": _grads(model), "report": describe_shardings(model),
                             "replicated": model.layout.replicated,
                             "state": convert.full_state(model)}
    wav = inputs["wavlm"]
    model = WavLM(WavLMConfig.from_dict(wav["config"]))
    model.load_state_dict(wav["state"])
    model.eval()
    make_param_sharder(mesh, WAVLM_TP_RULES)(model)
    y = model(wav["x"])[0]
    (y * wav["cot"]).sum().backward()
    out["wavlm"] = {"y": y.detach(), "grads": _grads(model), "report": describe_shardings(model),
                    "state": convert.full_state(model)}
    return out


def job_tp_remat(inputs: dict, rank: int, world: int) -> dict:
    """One train step of the tiny flagship laid out over a model axis of
    ``world`` ranks, with ``remat`` off and on: loss, whole gradients, the
    whole state (the BatchNorm statistics) and the generators' states."""
    from speechlid_tpu_torch.tasks.lid_asr import LidASRTask

    mesh = make_mesh(model=world)
    out = {"calls": {}}
    for remat in (False, True):
        task = LidASRTask(**inputs["hparams"], remat=remat, device="cpu")
        task.model.load_state_dict(inputs["state"])
        make_param_sharder(mesh, EP_RULES + CONFORMER_TP_RULES)(task.model)
        gens = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
        task.set_generators(*gens)
        calls = [0]
        for block in task.model.featurizer.blocks:  # the recomputation runs no forward hooks
            def counted(*args, _forward=block.forward):
                calls[0] += 1
                return _forward(*args)
            block.forward = counted
        task.model.train()
        loss, _ = task.train_loop(task.place_batch(inputs["batch"]))
        loss.backward()
        out["calls"][remat] = calls[0]
        out[remat] = (loss.detach(), _grads(task.model), convert.full_state(task.model),
                      [g.get_state() for g in gens])
    return out


def job_int8_row(inputs: dict, rank: int, world: int) -> dict:
    """A row-parallel int8 product on this rank's slice of the contracted
    axis: the forward under ``torch.no_grad()``, and for ``int8`` and
    ``int8_ste`` the output and this rank's slices of the gradients under
    the cotangent ``cot``."""
    from speechlid_tpu_torch.ops.quant import row_parallel_int8

    mesh = make_mesh(model=world)
    k = inputs["x"].shape[-1] // world
    cols = slice(rank * k, (rank + 1) * k)
    with torch.no_grad():
        out = {"y": row_parallel_int8(inputs["x"][..., cols], inputs["w"][:, cols],
                                      mesh.group("model"), "int8")}
    for kind in ("int8", "int8_ste"):
        x = inputs["x"][..., cols].clone().requires_grad_(True)
        w = inputs["w"][:, cols].clone().requires_grad_(True)
        y = row_parallel_int8(x, w, mesh.group("model"), kind)
        (y * inputs["cot"]).sum().backward()
        out[kind] = {"y": y.detach(), "dx": x.grad, "dw": w.grad}
    return out


def _trunk(states, x, mesh, n_microbatch=None) -> dict:
    from speechlid_tpu_torch.models.conformer import ConformerBlock

    s = mesh.index("stage")
    block = ConformerBlock(x.shape[-1], dim_head=16, heads=2)
    block.load_state_dict(states[s])
    block.eval()
    y = pipeline_apply(block, x, mesh, n_microbatch=n_microbatch)
    (y ** 2).mean().backward()
    grads = {n: p.grad for n, p in block.named_parameters()}
    return {"stage": s, "y": y.detach(), "grads": grads, "stacked": gather_stages(block, mesh)}


def job_pipeline(inputs: dict, rank: int, world: int) -> dict:
    """``pipeline_apply`` on a (1, 4) mesh with M = 4 and 8, then on (2, 2)
    with rows the data axis divides and rows it does not."""
    out = {}
    mesh = make_mesh(stage=4)
    for m in (4, 8):
        out[f"m{m}"] = _trunk(inputs["stages4"], inputs["x"], mesh, m)
    mesh = make_mesh(data=2, stage=2)
    out["dp"] = _trunk(inputs["stages2"], inputs["x"], mesh)
    # 3 rows a microbatch: the data axis does not divide them, every data
    # rank runs them all
    out["dp_ragged"] = _trunk(inputs["stages2"], inputs["x"][:6], mesh)
    return out


def job_sp(inputs: dict, rank: int, world: int) -> dict:
    """``sp_wav2mel`` over a seq axis of ``world`` ranks, gathered; and the
    ``shard_time`` / ``gather_time`` round trip with its gradient."""
    mesh = make_mesh(seq=world)
    wavs, lengths = inputs["wavs"], inputs["lengths"]
    frames = 1 + wavs.shape[1] // 160
    local = sp_wav2mel(wavs, lengths, mesh)
    x = inputs["x"].clone().requires_grad_(True)
    part = shard_time(x, mesh)
    back = gather_time(part * 2.0, mesh)
    back.sum().backward()
    return {"mel": gather_time(local, mesh, time_dim=2, size=frames), "local": local.shape,
            "part": part.shape, "back": back.detach(), "dx": x.grad}


JOBS = {"collectives": job_collectives, "trainer": job_trainer, "cli": job_cli,
        "tp_fit": job_tp_fit, "tp_model": job_tp_model, "int8_row": job_int8_row,
        "ckpt_async": job_ckpt_async, "tp_remat": job_tp_remat,
        "pipeline": job_pipeline, "sp": job_sp}


def main(argv) -> None:
    job, rank, world, root = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    initialize_multihost(f"file://{os.path.join(root, 'pg')}", world, rank, device="cpu",
                         timeout=TIMEOUT)
    try:
        out = JOBS[job](inputs, rank, world)
    finally:
        shutdown()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
