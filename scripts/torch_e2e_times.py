"""Host-bound end-to-end times of the PyTorch/CUDA port on one CUDA card:
the flagship's train step (B = 8, 4 s clips, 12 steps a reading) and its
B = 1 forward on a 3 s clip (30 calls a reading), three readings each, then
one train step under ``torch.profiler`` and three more readings of each
(what the profiler leaves behind in its process), as one JSON line after
the label given as the first argument.

    PYTHONPATH=. python3 scripts/torch_e2e_times.py LABEL    # from the repo root

Both paths are bound by the host's launches, and host times move by tens of
percent from run to run, so two trees are compared by alternating this
script between their checkouts in one go on one machine (parent, change,
change, parent, and again).  It takes its model, batches and
hyper-parameters from ``chip_smoke.py``.
"""

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as c
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask

READINGS, STEPS, CALLS = 3, 12, 30


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_e2e_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(0)
    train = [c.synthetic_batch(rng, i % c.N_LANG, c.TRAIN_B, c.TRAIN_SECONDS) for i in range(6)]
    task = LidASRTask(**dict(c.FLAGSHIP, **c.TRAIN_HPARAMS), device="cuda")
    c.init_random_(task.model, gen)
    trainer = Trainer(total_epoch=1, use_progress_bar=False, seed=0, callbacks=[])
    trainer.fit(task, train[:2], train[:1])  # sets the trainer up and warms the step
    infer = task.infer_fn()
    wavs = 0.1 * torch.randn(1, 3 * c.SR, generator=gen)
    lengths = torch.tensor([3 * c.SR])
    for _ in range(3):
        infer(wavs, lengths)

    def step_ms() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEPS):
            metrics = trainer.train_step(train[i % len(train)])
        float(metrics["loss"])
        return round((time.perf_counter() - t0) / STEPS * 1e3, 2)

    def b1_ms() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            scores = infer(wavs, lengths)["scores"]
        scores.cpu()
        return round((time.perf_counter() - t0) / CALLS * 1e3, 2)

    out = {"train_ms": [step_ms() for _ in range(READINGS)],
           "b1_ms": [b1_ms() for _ in range(READINGS)]}
    c._profile_device(lambda: trainer.train_step(train[0]))
    out["train_ms_after_profiler"] = [step_ms() for _ in range(READINGS)]
    out["b1_ms_after_profiler"] = [b1_ms() for _ in range(READINGS)]
    print(sys.argv[1] if len(sys.argv) > 1 else "tree", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
