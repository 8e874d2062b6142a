"""How far the float16 flagship train step lies from float32, on the card
and on the CPU, and where.

    PYTHONPATH=. python3 scripts/f16_step_precision.py    # from the root of a checkout, one CUDA card

One deterministic train step of the Conformer flagship (``chip_smoke``'s
weights and its B = 8, 4 s batch) with ``dtype="float16"``, each run
against the float32 step on the card: the loss, and the gradients in
relative L2 norm (every leaf together, by part: the subsampling, the
encoder blocks, the heads; the median and the largest leaf).  Every run
takes the float32 card step's fbank features and its subsampling ReLU
decisions (as ``chip_smoke.pin_subsampling_relus`` hands them on), so no
flipped unit is in the distances.  Runs:

- ``card``: the card as the port runs it (the depthwise kernels' float16
  instantiations, cuBLAS and cuDNN in float16);
- ``card_plain_conv``: the card with the conv module's plain PyTorch
  versions in place of the depthwise kernels;
- ``card_cudnn_off``: the card with cuDNN switched off (TF32 stays off);
- ``cpu``: the CPU in float16.

Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

import chip_smoke as c
from speechlid_tpu_torch.models import conformer
from speechlid_tpu_torch.ops.cuda import depthwise_kernel as dw
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask

PARTS = ("featurizer.subsample.", "featurizer.blocks.", "heads.")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def step(task: LidASRTask, batch: dict, feats, f_len) -> tuple:
    """(loss, {name: gradient on the host}) of one step of ``task``."""
    task._features = lambda wavs, wav_lengths, augment=False: (
        feats.to(task.device), f_len.to(task.device))
    task.set_generators(torch.Generator(task.device).manual_seed(0),
                        torch.Generator().manual_seed(0))
    task.model.train()
    task.model.zero_grad(set_to_none=True)
    loss, _ = task.train_loop(task.place_batch(batch))
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu() for n, p in task.model.named_parameters()
                         if p.grad is not None}


def distances(grads: dict, ref: dict) -> dict:
    leaves = {n: rel_l2(g, ref[n]) for n, g in grads.items()}
    worst = max(leaves, key=leaves.get)

    def whole(names):
        names = sorted(names)
        return rel_l2(torch.cat([grads[n].flatten() for n in names]),
                      torch.cat([ref[n].flatten() for n in names]))

    return {"rel_l2_all": whole(grads), "median_leaf": float(np.median(list(leaves.values()))),
            "largest_leaf": leaves[worst], "largest_leaf_name": worst,
            **{f"rel_l2_{part.rstrip('.')}": whole(n for n in grads if n.startswith(part))
               for part in PARTS}}


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator().manual_seed(0)
    hp = dict(c.CONFORMER_DETERMINISTIC, dtype="float16")
    card32 = LidASRTask(**c.as_float32(hp), device="cuda")
    c.init_random_(card32.model, gen)
    state = card32.model.state_dict()
    batch = c.synthetic_batch(np.random.RandomState(4), lang=1, b=8, seconds=4.0)
    placed = card32.place_batch(batch)
    feats, f_len = card32._features(placed["wavs"], placed["wav_lengths"])

    masks = []
    hooks = [conv.register_forward_hook(lambda mod, args, out: masks.append(out > 0))
             for conv in (card32.model.featurizer.subsample.conv0,
                          card32.model.featurizer.subsample.conv1)]
    loss32, ref = step(card32, batch, feats, f_len)
    for hook in hooks:
        hook.remove()

    def pinned(task: LidASRTask) -> tuple:
        """``task``'s step with the float32 card step's ReLU decisions (as
        ``chip_smoke.pin_subsampling_relus`` hands them on)."""
        sub, differ = task.model.featurizer.subsample, {"conv0": 0, "conv1": 0}
        m0, m1 = (m.to(task.device) for m in masks)

        def forward(x):
            z0 = sub.conv0(x[:, None])
            differ["conv0"] += int(((z0 > 0) != m0).sum())
            z1 = sub.conv1(z0 * m0)
            differ["conv1"] += int(((z1 > 0) != m1).sum())
            y = (z1 * m1).permute(0, 2, 3, 1)
            b, t, f, ch = y.shape
            return sub.out(y.reshape(b, t, f * ch))

        sub.forward = forward
        return (*step(task, batch, feats, f_len), differ)

    out = {"nvidia_smi": smi, "batch": [8, 4.0], "loss_float32": loss32, "runs": {}}
    glu_depthwise = conformer.glu_depthwise
    for name in ("card", "card_plain_conv", "card_cudnn_off", "cpu"):
        task = LidASRTask(**hp, device="cpu" if name == "cpu" else "cuda")
        task.model.load_state_dict(state)
        if name == "card_plain_conv":
            conformer.glu_depthwise = lambda h, mask, w, b, pad_l=None: (
                dw.glu_depthwise_plain(h, mask, w, b, pad_l)[1])
        try:
            with torch.backends.cudnn.flags(enabled=name != "card_cudnn_off", allow_tf32=False):
                loss, grads, differ = pinned(task)
        finally:
            conformer.glu_depthwise = glu_depthwise
        out["runs"][name] = {"loss": loss, "rel_err_loss": abs(loss - loss32) / abs(loss32),
                             "relu_units_decided_otherwise": differ,
                             **distances(grads, ref)}
        del task
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
