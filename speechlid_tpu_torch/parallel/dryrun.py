"""A sharded training step on n ranks, held to one process (port of the JAX
package's ``__graft_entry__.dryrun_multichip``).

    python -m speechlid_tpu_torch.parallel.dryrun N [--device cuda|cpu]

:func:`dryrun_multichip` spawns N rank processes (a gloo group over a
``file://`` rendezvous; on the card rank r runs on ``cuda:r mod count``,
every rank on ``cuda:0`` where there is one card) and each runs
:func:`_dryrun_body`, as the JAX function runs its body on an N-device
mesh:

1. the tiny flagship (2 blocks × 32, ``n_lang = 2·model``) takes one Adam
   step (clip 20, lr 1e-3) on a ``(data, seq, model)`` mesh, ``model = 2``
   where N is even, ``seq = 2`` where 4 divides N, the rest ``data``:
   ep (``EP_RULES``) and tp (``CONFORMER_TP_RULES``) lay the model out,
   sp computes each seq rank's frames of the dB mel (``sp_wav2mel``) before
   ``gather_time`` hands the model the whole, and dp gives each data index
   its rows.  Every row's own head scores it (the batch is not one
   language), the CTC loss is the rows' mean.  The dropout rates are 0, so
   that a data axis draws no masks of its own;
2. a 4-stage ``ConformerBlock(dim=32, heads=2, dim_head=16)`` trunk (in
   eval mode, BatchNorm on its running statistics; 2 or 1 stages where 4
   does not divide N) on a ``(data, stage)`` mesh through
   ``pipeline_apply``, with an MSE loss against a fixed random target.

The parent process runs both in one process on the same weights and
inputs.  The losses must agree within JAX's rtol 2e-4 / atol 1e-5, and the
trunk's parameter gradients within the pipeline tests' 5e-5 (atol and
rtol).  It runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from datetime import timedelta
from pathlib import Path
from typing import Dict

import numpy as np
import torch

LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-5
GRAD_TOL = 5e-5
TIMEOUT = timedelta(seconds=300)  # the group's: a hung collective fails the run
T_WAV, S_TEXT = 7840, 8  # t / 160 even: the mel's 50 frames split on 'seq'
TRUNK_DIM, TRUNK_T = 32, 20


def mesh_axes(n: int) -> Dict[str, int]:
    """The JAX dryrun's mesh rule: model 2 where n is even, seq 2 where 4
    divides n, the rest data."""
    model = 2 if n % 2 == 0 and n >= 2 else 1
    seq = 2 if n % 4 == 0 and n >= 4 else 1
    return {"data": n // (model * seq), "seq": seq, "model": model}


def stage_axes(n: int) -> Dict[str, int]:
    stage = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    return {"data": n // stage, "stage": stage}


def flagship(n_lang: int, device) -> torch.nn.Module:
    """The tiny flagship of ``_flagship(tiny=True)``, weights drawn from
    seed 0, the dropout rates 0."""
    from speechlid_tpu_torch.models.conformer import ConformerModel
    from speechlid_tpu_torch.models.init import init_like_flax_
    from speechlid_tpu_torch.models.multilang import MutiLangModel

    feat = ConformerModel(n_blocks=2, encoder_dim=32, heads=2, dim_head=16, sub_sampling=4,
                          use_stochastic_depth=False, pos_dropout=0.0)
    model = MutiLangModel(feat, (8,) * n_lang, linear_dim=32, dim_head=8, num_head=4,
                          dropout=0.0).to(device)
    init_like_flax_(model, torch.Generator().manual_seed(0))
    return model.train()


def flagship_batch(b: int, n_lang: int) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(0)
    return {"wavs": rng.randn(b, T_WAV).astype(np.float32),
            "wav_lengths": np.full((b,), T_WAV, np.int32),
            "texts": rng.randint(0, 7, (b, S_TEXT)).astype(np.int32),
            "text_lengths": np.full((b,), S_TEXT, np.int32),
            "langs": (np.arange(b) % n_lang).astype(np.int64)}


def flagship_loss(model, mel, batch, device) -> torch.Tensor:
    """The rows' mean CTC loss, every row scored by its own head."""
    from speechlid_tpu_torch.ops.ctc import ctc_loss
    from speechlid_tpu_torch.ops.frontend import frame_lengths

    t = lambda k: torch.as_tensor(batch[k], device=device)  # noqa: E731
    f_len = frame_lengths(t("wav_lengths"), 160)
    logits, feat_lens = model(mel.transpose(1, 2), f_len)
    own = logits[t("langs"), torch.arange(len(batch["langs"]), device=device)]
    lp = torch.log_softmax(own, dim=-1)
    return ctc_loss(lp, t("texts"), feat_lens, t("text_lengths"), blank=-1,
                    reduction="none").mean()


def trunk_block(stage: int, device) -> torch.nn.Module:
    from speechlid_tpu_torch.models.conformer import ConformerBlock
    from speechlid_tpu_torch.models.init import init_like_flax_

    block = ConformerBlock(TRUNK_DIM, dim_head=16, heads=2).to(device)
    init_like_flax_(block, torch.Generator().manual_seed(2 + stage))
    return block.eval()


def trunk_data(rows: int):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(rows, TRUNK_T, TRUNK_DIM).astype(np.float32))
    target = torch.from_numpy(rng.randn(rows, TRUNK_T, TRUNK_DIM).astype(np.float32))
    return x, target


def one_process(n: int, device) -> dict:
    """Both steps in one process, no group."""
    from speechlid_tpu_torch.ops.frontend import wav2mel

    axes = mesh_axes(n)
    n_lang = 2 * axes["model"]
    model = flagship(n_lang, device)
    batch = flagship_batch(2 * axes["data"], n_lang)
    wavs = torch.as_tensor(batch["wavs"], device=device)
    lengths = torch.as_tensor(batch["wav_lengths"], device=device)
    loss1 = flagship_loss(model, wav2mel(wavs, lengths=lengths), batch, device)
    stages = stage_axes(n)
    blocks = [trunk_block(s, device) for s in range(stages["stage"])]
    x, target = trunk_data(4 * stages["data"])
    y = x.to(device)
    for block in blocks:
        y = block(y)
    loss2 = ((y - target.to(device)) ** 2).mean()
    loss2.backward()
    grads = [{k: p.grad.cpu() for k, p in b.named_parameters()} for b in blocks]
    return {"flagship_loss": float(loss1.detach()), "trunk_loss": float(loss2.detach()),
            "trunk_grads": grads}


def _dryrun_body(n: int, rank: int, root: str, device: str) -> dict:
    """Rank ``rank``'s part of both steps; → what it saw."""
    from speechlid_tpu_torch.core.optim import make_optimizer
    from speechlid_tpu_torch.core.precision import strict_float32
    from speechlid_tpu_torch.parallel import (
        CONFORMER_TP_RULES,
        EP_RULES,
        average_grads,
        gather_time,
        initialize_multihost,
        make_mesh,
        make_param_sharder,
        pipeline_apply,
        shard_batch,
        shutdown,
        sp_wav2mel,
    )
    from speechlid_tpu_torch.parallel.mesh import all_reduce_, data_group

    if device != "cpu":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    strict_float32(torch.device(device))
    initialize_multihost(f"file://{os.path.join(root, 'pg')}", n, rank, device=device,
                         backend="gloo", timeout=TIMEOUT)
    try:
        axes = mesh_axes(n)
        mesh = make_mesh(**axes)
        n_lang = 2 * axes["model"]
        model = flagship(n_lang, device)
        layout = make_param_sharder(mesh, EP_RULES + CONFORMER_TP_RULES)(model)
        opt, _ = make_optimizer(model.named_parameters(), "adam", lr=1e-3, clip_norm=20.0)
        batch = shard_batch(mesh, flagship_batch(2 * axes["data"], n_lang))
        wavs = torch.as_tensor(batch["wavs"], device=device)
        lengths = torch.as_tensor(batch["wav_lengths"], device=device)
        mel = sp_wav2mel(wavs, lengths, mesh, normalize=False)
        span = list(mel.shape)
        mel = gather_time(mel, mesh, time_dim=2, size=1 + T_WAV // 160)
        loss = flagship_loss(model, mel, batch, device)
        loss.backward()
        average_grads(model)
        opt.step()
        group = data_group()
        loss1 = all_reduce_(loss.detach().clone(), group) / group.size
        finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
        out = {"flagship_loss": float(loss1), "mel_span": span, "finite": finite,
               "pieces": len(layout.pieces)}

        stages = stage_axes(n)
        pmesh = make_mesh(**stages)
        s = pmesh.index("stage")
        block = trunk_block(s, device)
        x, target = trunk_data(4 * stages["data"])
        y = pipeline_apply(block, x.to(device), pmesh, axis="stage")
        loss2 = ((y - target.to(device)) ** 2).mean()
        loss2.backward()
        out.update(trunk_loss=float(loss2), stage=s,
                   trunk_grads={k: p.grad.cpu() for k, p in block.named_parameters()})
    finally:
        shutdown()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    return out


def dryrun_multichip(n: int, device: str = "cuda", timeout: float = 900.0) -> dict:
    """Run both steps on ``n`` rank processes and in this process; raise
    unless they agree.  → a report (losses, gaps, the mesh shapes)."""
    from speechlid_tpu_torch.core.precision import strict_float32

    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip runs on the card (device='cpu' for the CPU)")
    dev = "cuda:0" if device != "cpu" else "cpu"
    strict_float32(torch.device(dev))
    with tempfile.TemporaryDirectory() as root:
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env.setdefault("OMP_NUM_THREADS", "1")
        cwd = str(Path(__file__).resolve().parents[2])
        procs = [subprocess.Popen(
            [sys.executable, "-m", "speechlid_tpu_torch.parallel.dryrun", str(n),
             "--device", device, "--rank", str(r), "--root", root],
            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        try:
            want = one_process(n, dev)
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun rank {r} failed ({p.returncode}):\n{log[-4000:]}")
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(n)]
    loss1 = ranks[0]["flagship_loss"]
    loss2 = ranks[0]["trunk_loss"]
    grad_gap, grads_close = 0.0, True
    for out in ranks:
        for k, g in want["trunk_grads"][out["stage"]].items():
            got = out["trunk_grads"][k]
            grad_gap = max(grad_gap, float((got - g).abs().max()))
            grads_close &= torch.allclose(got, g, rtol=GRAD_TOL, atol=GRAD_TOL)
    checks = {
        "flagship_loss": bool(np.isclose(loss1, want["flagship_loss"], rtol=LOSS_RTOL,
                                         atol=LOSS_ATOL)),
        "flagship_ranks_agree": len({out["flagship_loss"] for out in ranks}) == 1,
        "finite": all(out["finite"] for out in ranks),
        "trunk_loss": bool(np.isclose(loss2, want["trunk_loss"], rtol=LOSS_RTOL,
                                      atol=LOSS_ATOL)),
        "trunk_grads": grads_close,
    }
    report = {"mesh": mesh_axes(n), "pipeline_mesh": stage_axes(n), "device": dev,
              "flagship_loss": loss1, "flagship_loss_one_process": want["flagship_loss"],
              "trunk_loss": loss2, "trunk_loss_one_process": want["trunk_loss"],
              "trunk_grad_gap": grad_gap, "mel_spans": [out["mel_span"] for out in ranks],
              "checks": checks}
    if not all(checks.values()):
        raise AssertionError(f"dryrun_multichip failed: {report}")
    axes, stages = mesh_axes(n), stage_axes(n)
    print(f"dryrun_multichip ok: mesh=({axes['data']}x{axes['seq']}x{axes['model']} "
          f"data×seq×model) n_lang={2 * axes['model']} loss={loss1:.4f} "
          f"(single-process parity {want['flagship_loss']:.4f})")
    print(f"dryrun pp ok: mesh=({stages['data']}x{stages['stage']} data×stage) "
          f"loss={loss2:.4f} (sequential parity {want['trunk_loss']:.4f})")
    return report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("n", type=int, help="ranks")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        torch.set_num_threads(1)
        _dryrun_body(args.n, args.rank, args.root, args.device)
        return
    print(json.dumps(dryrun_multichip(args.n, args.device)))


if __name__ == "__main__":
    main()
