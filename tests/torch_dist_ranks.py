"""The rank processes of ``tests/test_torch_dist.py``: each job runs in N
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
from speechlid_tpu_torch.parallel import initialize_multihost, make_mesh, shutdown

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


def _fit(inputs: dict, rank: int, world: int) -> dict:
    from speechlid_tpu_torch.core.trainer import Trainer
    from speechlid_tpu_torch.data.tokenizer import CTCTokenizer
    from speechlid_tpu_torch.tasks.lid_asr import LidASRTask

    hp = dict(inputs["hparams"])
    hp["tokenizers"] = {k: CTCTokenizer(v) for k, v in inputs["vocabs"].items()}
    task = LidASRTask(**hp, device="cpu")
    task.model.load_state_dict(inputs["state"])
    task.init_parameters = lambda generator: None  # keep the weights it was given
    split = lambda batches: [{k: (rows_of(rank, world, v) if np.ndim(v) else v)  # noqa: E731
                              for k, v in b.items()} for b in batches]
    rec = _EvalMetrics()
    trainer = Trainer(total_epoch=1, use_progress_bar=False, device="cpu", callbacks=[rec],
                      mesh=make_mesh())
    trainer.fit(task, split(inputs["train"]), split(inputs["val"]))
    opt = trainer.optimizer
    return {"state": task.model.state_dict(), "evals": rec.evals, "losses": rec.losses,
            "steps": opt.count, "lr_sum": sum(opt.lr_at(i) for i in range(opt.count))}


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


def job_cli(inputs: dict, rank: int, world: int) -> dict:
    """``main_lid`` with ``trainer.data_parallel=true``; each rank names its
    own ``exp_dir``, so what rank 1 would write would show."""
    from speechlid_tpu_torch.cli import main_lid

    trainers = []

    class Recorded(main_lid.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            trainers.append(self)

    main_lid.Trainer = Recorded
    main_lid.main(inputs["args"] + [f"exp_dir={inputs['exp_dirs'][rank]}", "--device", "cpu"])
    (trainer,) = trainers
    return {"state": trainer.module.model.state_dict(), "steps": trainer.optimizer.count,
            "mesh": trainer.mesh.shape}


JOBS = {"collectives": job_collectives, "trainer": job_trainer, "cli": job_cli}


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
