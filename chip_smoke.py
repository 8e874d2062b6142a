#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``speechlid_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout, one H100

It builds the port's CUDA kernels from ``speechlid_tpu_torch/csrc`` (into
``build/``), holds each kernel, forward and backward, against its plain
PyTorch version on the card, runs the full-width Conformer joint-LID model
through the kernels and against the same weights on the CPU (inference, and
one deterministic training step with every parameter's gradient), serves it
on ``/lid`` from a thread and posts requests to it, trains it through
``Trainer.fit`` with augmentation, checkpoints, a resume and a served
request from the trained checkpoint, and times the kernels, the model and
the train step.  Each phase prints one JSON line; any failure raises and
exits non-zero.  The ``{"kernels": …}`` line lists every kernel at the
shape the served or the trained path gives it, with its launches as counted
on that path, its error against its plain version at that shape and its
times beside its bound.  The last line is
``{"ok": true, "device": …}``.

float32 throughout, with TF32 off for matmuls and cuDNN convolutions
(cuDNN would otherwise run the Conv2d subsampling in TF32).  Weights are
random, from a seeded ``torch.Generator``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.nn.functional as F

from speechlid_tpu_torch.cli.serve import (
    InferenceState,
    build_lid_fn,
    make_handler,
    make_lid_fn,
)
from speechlid_tpu_torch.core.callbacks import Callback, CkptCallback
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.models.conformer import DepthwiseConv1d, MaskedBatchNorm
from speechlid_tpu_torch.ops import frontend
from speechlid_tpu_torch.ops.cuda import _build
from speechlid_tpu_torch.ops.cuda.depthwise_kernel import (
    depthwise_conv1d,
    depthwise_conv1d_bwd_w,
    depthwise_conv1d_bwd_w_plain,
    depthwise_conv1d_plain,
)
from speechlid_tpu_torch.ops.cuda.fbank_kernel import log_mel, log_mel_plain
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask

SR = 16000
# H100 SXM data sheet, dense, at the 700 W limit: FP32 outside the tensor
# cores, and HBM3 bandwidth.  Bounds are stated against these peaks.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12
FBANK_TOL = 1e-3  # dB, atol and rtol: the JAX package's fbank tolerance
DW_TOL = 1e-5  # f32, atol and rtol (tests/test_pallas_depthwise.py)
DW_BF16_TOL = (0.1, 0.15)  # rtol, atol of bf16 against the f32 result
DW_BF16_GRAD_TOL = 2e-2  # bf16 gradients: of the f32 gradient's largest entry
DW_GRAD_TOL = 1e-4  # f32 gradients, atol and rtol (tests/test_pallas_depthwise.py)
MODEL_TOL = 1e-3  # card vs CPU scores: 14 + 1 float32 blocks, sums in another order

# The flagship joint-LID model (configs/lid_supervised.yaml module block,
# __graft_entry__.py): 14 × 144-d Conformer, 4 heads × 64, ×4 subsampling,
# one ConformerLinear head block per language at 144-d, 8 heads × 32.
FLAGSHIP = dict(
    lang2vocab={"lang0": 40, "lang1": 96, "lang2": 88},
    lang2index={"lang0": 0, "lang1": 1, "lang2": 2},
    n_blocks=14, encoder_dim=144, heads=4, dim_head=64, sub_sampling=4,
    head_type="conformer_linear", head_layers=1, head_dim_head=32, head_num_head=8,
)
DW_PER_FORWARD = FLAGSHIP["n_blocks"] + len(FLAGSHIP["lang2vocab"])  # 14 + 3
SERVE_SECONDS = (0.7, 1.5, 3.0, 5.0, 12.0)
SERVE_ROUNDS = 2

# Training: Adam + tristage + clip 20 as configs/lid_supervised.yaml has them,
# the schedule shortened to this run's 18 steps; SpecAugment, time stretch,
# dropout and stochastic depth on (the task's defaults plus t_stretch).
TRAIN_HPARAMS = dict(
    t_stretch=True, lr=1e-3, optimizer="adam", clip_norm=20.0, schedule="tristage",
    schedule_conf=dict(warmup_steps=3, hold_steps=9, decay_steps=6),
)
TRAIN_B, TRAIN_SECONDS, TRAIN_BATCHES, TRAIN_EPOCHS = 8, 4.0, 6, 2
TRAIN_TOL = 1e-3  # card vs CPU: the loss, and each gradient relative to its largest entry
N_BLOCKS, N_LANG = FLAGSHIP["n_blocks"], len(FLAGSHIP["lang2vocab"])
DW_PER_TRAIN_STEP = N_BLOCKS + 1  # the encoder's blocks and the batch's own head
# what one train step is expected to launch: forward and dX through the one
# kernel, dW/db through the other; the counts found are held to it
TRAIN_STEP_LAUNCHES = {"fbank": 1, "depthwise": 2 * DW_PER_TRAIN_STEP,
                       "depthwise_dx": DW_PER_TRAIN_STEP, "depthwise_bwd_w": DW_PER_TRAIN_STEP}


def _encoder_frames(seconds: float) -> int:
    """Frames the encoder's convs see for a clip: hop-160 fbank frames, then
    two stride-2, 3-tap subsampling convs without padding."""
    t = 1 + int(seconds * SR) // 160
    for _ in range(2):
        t = (t - 3) // 2 + 1
    return t


# the encoder conv module's shape on the training path (8, 99, 288), k = 31
TRAIN_DW_SHAPE = (TRAIN_B, _encoder_frames(TRAIN_SECONDS), 2 * FLAGSHIP["encoder_dim"], 31)
SERVE_DW_SHAPE = (1, _encoder_frames(3.0), 2 * FLAGSHIP["encoder_dim"], 31)  # B=1, 3 s clip


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed ``rounds`` times between CUDA events; the median replay over
    ``reps``.  Launch gaps of the host are not in it."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def bound_ms(n_bytes: float, flops: float):
    """The least time the card could take: bytes over HBM rate or FP32
    operations over the FP32 rate, whichever is larger."""
    t_bytes = n_bytes / PEAK_HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases


def phase_build() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    path = _build.library_path()
    _build.lib()
    emit({
        "phase": "build", "seconds": round(time.perf_counter() - t0, 3),
        "library": str(path.relative_to(_build.BUILD_DIR.parent)),
        "ptxas": [l.strip() for l in path.with_suffix(".log").read_text().splitlines()
                  if "registers" in l or "spill" in l],
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvidia_smi": smi,
    })


def _wav(b: int, seconds: float, gen: torch.Generator) -> torch.Tensor:
    wav = torch.randn(b, int(seconds * SR), generator=gen)
    return frontend.normalize_wav(wav).cuda()


def phase_fbank(gen: torch.Generator) -> float:
    worst = 0.0
    for b, seconds in ((1, 3.0), (32, 3.0), (1, 17.0)):
        wav = _wav(b, seconds, gen)
        got = log_mel(wav)
        ref = log_mel_plain(wav)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        ok = torch.allclose(got, ref, rtol=FBANK_TOL, atol=FBANK_TOL)
        emit({"phase": "fbank_vs_plain", "shape": [b, wav.shape[1]],
              "out": list(got.shape), "max_abs_err_db": err, "tol": FBANK_TOL,
              "ok": ok})
        if not ok:
            raise AssertionError(f"fbank kernel disagrees with plain at B={b}, {seconds}s")
        worst = max(worst, err)
    return worst


DW_SHAPES = (SERVE_DW_SHAPE, (32, 74, 288, 31), (1, 7, 64, 31),
             (3, 100, 129, 15), (2, 50, 96, 4), TRAIN_DW_SHAPE)


def phase_depthwise(gen: torch.Generator) -> dict:
    """The forward kernel against its plain version; returns the f32 error
    found at each shape."""
    found = {}
    for b, t, c, k in DW_SHAPES:
        x = torch.randn(b, t, c, generator=gen).cuda()
        w = (0.1 * torch.randn(k, c, generator=gen)).cuda()
        bias = (0.1 * torch.randn(c, generator=gen)).cuda()
        got = depthwise_conv1d(x, w, bias)
        ref = depthwise_conv1d_plain(x, w, bias)
        got16 = depthwise_conv1d(x.bfloat16(), w.bfloat16(), bias.bfloat16())
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        err16 = (got16.float() - ref).abs().max().item()
        ok = torch.allclose(got, ref, rtol=DW_TOL, atol=DW_TOL)
        ok16 = got16.dtype == torch.bfloat16 and torch.allclose(
            got16.float(), ref, rtol=DW_BF16_TOL[0], atol=DW_BF16_TOL[1])
        emit({"phase": "depthwise_vs_plain", "shape": [b, t, c], "k": k,
              "max_abs_err_f32": err, "tol_f32": DW_TOL,
              "max_abs_err_bf16_vs_f32": err16, "tol_bf16": DW_BF16_TOL,
              "ok": ok and ok16})
        if not (ok and ok16):
            raise AssertionError(f"depthwise kernel disagrees with plain at {(b, t, c, k)}")
        found[(b, t, c, k)] = err
    return found


def _dw_grads(fn, x, w, bias, g):
    """(dX, dW, db) of ``fn(x, w, bias)`` under the output gradient ``g``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, bias)]
    return torch.autograd.grad(fn(*leaves), leaves, g)


def phase_depthwise_bwd(gen: torch.Generator) -> dict:
    """The autograd Function on the card (dX through the forward kernel,
    dW and db through the reduction kernel) against autograd through the
    plain version on the card; bf16 against the f32 result, each gradient
    also relative to its own largest entry; and two runs on the same input
    give the same bits.  Returns, for each shape, the f32 errors of dX and
    of dW/db (the larger, the wrapper called directly included)."""
    found = {}
    for b, t, c, k in DW_SHAPES:
        x = torch.randn(b, t, c, generator=gen).cuda()
        w = (0.1 * torch.randn(k, c, generator=gen)).cuda()
        bias = (0.1 * torch.randn(c, generator=gen)).cuda()
        # a unit-scale gradient over B·T frames would grow the sums: keep dW near 1
        g = (torch.randn(b, t, c, generator=gen) / (b * t) ** 0.5).cuda()
        before = launches()
        got = _dw_grads(depthwise_conv1d, x, w, bias, g)
        counted = {name: n - before[name] for name, n in launches().items()}
        again = _dw_grads(depthwise_conv1d, x, w, bias, g)
        ref = _dw_grads(depthwise_conv1d_plain, x, w, bias, g)
        got16 = _dw_grads(depthwise_conv1d, x.bfloat16(), w.bfloat16(), bias.bfloat16(),
                          g.bfloat16())
        direct = depthwise_conv1d_bwd_w(x, g, k)
        direct_plain = depthwise_conv1d_bwd_w_plain(x, g, k)
        torch.cuda.synchronize()
        errs = [(a - r).abs().max().item() for a, r in zip(got, ref)]
        errs16 = [(a.float() - r).abs().max().item() for a, r in zip(got16, ref)]
        rel16 = [e / r.abs().max().item() for e, r in zip(errs16, ref)]
        direct_errs = [(a - r).abs().max().item() for a, r in zip(direct, direct_plain)]
        ok = all(torch.allclose(a, r, rtol=DW_GRAD_TOL, atol=DW_GRAD_TOL)
                 for a, r in zip(got + direct, ref + direct_plain))
        ok16 = all(a.dtype == torch.bfloat16 and torch.allclose(
            a.float(), r, rtol=DW_BF16_TOL[0], atol=DW_BF16_TOL[1]) for a, r in zip(got16, ref))
        ok16 = ok16 and max(rel16) <= DW_BF16_GRAD_TOL
        same_bits = all(torch.equal(a, b2) for a, b2 in zip(got, again))
        emit({"phase": "depthwise_bwd_vs_plain", "shape": [b, t, c], "k": k,
              "max_abs_err_f32": dict(zip(("dx", "dw", "db"), errs)), "tol_f32": DW_GRAD_TOL,
              "max_abs_err_bf16_vs_f32": dict(zip(("dx", "dw", "db"), errs16)),
              "tol_bf16": DW_BF16_TOL,
              "max_err_bf16_over_largest_f32": dict(zip(("dx", "dw", "db"), rel16)),
              "tol_bf16_over_largest": DW_BF16_GRAD_TOL,
              "max_abs_err_direct_bwd_w": dict(zip(("dw", "db"), direct_errs)),
              "launches": counted,
              "bit_equal_reruns": same_bits, "ok": ok and ok16 and same_bits})
        expect = {"fbank": 0, "depthwise": 2, "depthwise_dx": 1, "depthwise_bwd_w": 1}
        if not (ok and ok16 and same_bits and counted == expect):
            raise AssertionError(f"depthwise backward disagrees with plain at {(b, t, c, k)}")
        found[(b, t, c, k)] = {"dx": errs[0], "bwd_w": max(errs[1], errs[2], *direct_errs)}
    return found


def init_random_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights at the scale of a trained model, and BatchNorm
    running statistics away from the identity (mean ≠ 0, var ≠ 1)."""
    with torch.no_grad():
        for module in model.modules():
            for name, p in module.named_parameters(recurse=False):
                r = torch.randn(p.shape, generator=gen)
                if name == "weight" and isinstance(module, (torch.nn.LayerNorm, MaskedBatchNorm)):
                    p.copy_(1.0 + 0.1 * r)
                elif name == "rel_pos_emb":
                    p.copy_(r)
                elif name == "weight" and isinstance(module, DepthwiseConv1d):
                    p.copy_(r * p.shape[0] ** -0.5)  # (k, C): fan-in k
                elif p.dim() >= 2:  # Linear (out, in), Conv2d (out, in, kh, kw)
                    p.copy_(r * p[0].numel() ** -0.5)
                else:
                    p.copy_(0.05 * r)
            if isinstance(module, MaskedBatchNorm):
                module.running_mean.copy_(0.2 * torch.randn(module.running_mean.shape, generator=gen))
                module.running_var.copy_(0.5 + torch.rand(module.running_var.shape, generator=gen))


def reset_launches() -> None:
    log_mel.launches = 0
    depthwise_conv1d.launches = 0
    depthwise_conv1d.dx_launches = 0
    depthwise_conv1d_bwd_w.launches = 0


def launches() -> dict:
    """The wrappers' counts; ``depthwise`` holds forward and dX launches of
    the one kernel, ``depthwise_dx`` the dX ones among them."""
    return {"fbank": log_mel.launches, "depthwise": depthwise_conv1d.launches,
            "depthwise_dx": depthwise_conv1d.dx_launches,
            "depthwise_bwd_w": depthwise_conv1d_bwd_w.launches}


def phase_model(gen: torch.Generator) -> LidASRTask:
    """The full-width flagship on the card (kernels) against the same
    state_dict on the CPU (plain versions), on ragged 3 s clips."""
    task = LidASRTask(**FLAGSHIP, device="cuda")
    init_random_(task.model, gen)
    cpu_task = LidASRTask(**FLAGSHIP, device="cpu")
    cpu_task.model.load_state_dict(task.model.state_dict())
    wavs = 0.1 * torch.randn(2, 3 * SR, generator=gen)
    lengths = torch.tensor([3 * SR, 40000])

    infer = task.infer_fn()
    infer(wavs, lengths)  # first call: cuBLAS / cuDNN set-up
    torch.cuda.synchronize()
    reset_launches()
    out = infer(wavs, lengths)
    torch.cuda.synchronize()
    per_forward = launches()
    ref = cpu_task.infer_fn()(wavs, lengths)

    got = {k: v.cpu() for k, v in out.items()}
    neg = torch.finfo(torch.float32).min
    live = ref["logits"] > neg
    score_err = (got["scores"] - ref["scores"]).abs().max().item()
    report = {
        "phase": "model_card_vs_cpu", "config": "flagship 14x144, heads 3x(40,96,88)",
        "batch": [2, 3 * SR], "lengths": lengths.tolist(),
        "params": sum(p.numel() for p in task.model.parameters()),
        "logits_shape": list(got["logits"].shape),
        "max_abs_err_logits": (got["logits"][live] - ref["logits"][live]).abs().max().item(),
        "max_abs_err_scores": score_err,
        "max_abs_err_mlp_scores": (got["mlp_scores"] - ref["mlp_scores"]).abs().max().item(),
        "scores": got["scores"].tolist(), "pred_lang": got["pred_lang"].tolist(),
        "pred_lang_cpu": ref["pred_lang"].tolist(), "tol": MODEL_TOL,
        "launches_per_forward": per_forward,
    }
    emit(report)
    checks = {
        "finite": bool(torch.isfinite(got["logits"]).all() and torch.isfinite(got["scores"]).all()
                       and torch.isfinite(got["mlp_scores"]).all()),
        "scores": score_err <= MODEL_TOL,
        "masked_slots": bool(torch.equal(got["logits"] == neg, ref["logits"] == neg)),
        "pred_lang": torch.equal(got["pred_lang"], ref["pred_lang"]),
        "launches": per_forward == {"fbank": 1, "depthwise": DW_PER_FORWARD,
                                    "depthwise_dx": 0, "depthwise_bwd_w": 0},
    }
    if not all(checks.values()):
        raise AssertionError(f"full model on the card failed: {checks}")
    return task


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        if resp.status != 200:
            raise AssertionError(f"GET {url}: {resp.status}")
        return json.loads(resp.read())


def phase_serve(task: LidASRTask, gen: torch.Generator) -> dict:
    """The main path: /lid served from a thread, requests of several
    lengths; launch counts are read around exactly these requests."""
    state = InferenceState(make_lid_fn(task), task.index2lang)
    state.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    wavs = [(0.1 * torch.randn(int(s * SR), generator=gen)).numpy() for s in SERVE_SECONDS]
    answers, client_ms = [], []
    try:
        torch.cuda.synchronize()
        reset_launches()
        for _ in range(SERVE_ROUNDS):
            for wav in wavs:
                t0 = time.perf_counter()
                req = urllib.request.Request(url + "/lid", data=wav.tobytes(), method="POST")
                with urllib.request.urlopen(req, timeout=120) as resp:
                    status, body = resp.status, json.loads(resp.read())
                client_ms.append((time.perf_counter() - t0) * 1e3)
                answers.append((wav, status, body))
        served = launches()
        health = _get(url + "/healthz")
        stats = _get(url + "/stats")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    n_req = len(answers)
    lid_fn = make_lid_fn(task)
    worst = 0.0
    for wav, status, body in answers:
        if status != 200 or set(body) != {"lang", "scores"} or len(body["scores"]) != 3:
            raise AssertionError(f"bad /lid answer: {status} {body}")
        padded, n = state.pad(wav)
        direct = lid_fn(padded, n)[0]
        got = np.array([body["scores"][task.index2lang[i]] for i in range(3)], np.float32)
        worst = max(worst, float(np.abs(got - direct).max()))
    report = {
        "phase": "serve", "requests": n_req, "seconds": list(SERVE_SECONDS),
        "rounds": SERVE_ROUNDS, "launches": served,
        "max_abs_diff_vs_direct_infer": worst,
        "client_p50_ms": statistics.median(client_ms),
        "client_ms": client_ms, "healthz": health, "stats": stats,
        "langs": [body["lang"] for _, _, body in answers[:len(wavs)]],
    }
    emit(report)
    ok = (worst == 0.0 and health == {"status": "ok"} and not thread.is_alive()
          and served == {"fbank": n_req, "depthwise": DW_PER_FORWARD * n_req,
                         "depthwise_dx": 0, "depthwise_bwd_w": 0})
    if not ok:
        raise AssertionError("serving phase failed")
    return report


def synthetic_batch(rng: np.random.RandomState, lang: int, b: int, seconds: float) -> dict:
    """One language-homogeneous batch in the feeder's layout: ragged clips
    in the ``seconds`` bucket, label lengths 5–30."""
    t = int(seconds * SR)
    vocab = list(FLAGSHIP["lang2vocab"].values())[lang]
    text_lengths = rng.randint(5, 31, b).astype(np.int32)
    return {
        "wavs": (0.1 * rng.randn(b, t)).astype(np.float32),
        "wav_lengths": rng.randint(t // 2, t + 1, b).astype(np.int32),
        "texts": rng.randint(0, vocab, (b, 30)).astype(np.int32),
        "text_lengths": text_lengths,
        "langs": np.full(b, lang, np.int32),
        "n_valid": np.int32(0),
    }


def phase_train_card_vs_cpu(gen: torch.Generator) -> None:
    """One deterministic train step (no dropout, stochastic depth or
    augmentation) at full width on the card (kernels) and on the CPU (plain
    versions) from the same state_dict: the loss and every gradient."""
    hp = dict(FLAGSHIP, dropout=0.0, pos_dropout=0.0, use_stochastic_depth=False,
              mask_times=0, t_stretch=False)
    card, cpu = LidASRTask(**hp, device="cuda"), LidASRTask(**hp, device="cpu")
    init_random_(card.model, gen)
    cpu.model.load_state_dict(card.model.state_dict())
    batch = synthetic_batch(np.random.RandomState(1), lang=1, b=2, seconds=3.0)
    results = {}
    for name, task in (("card", card), ("cpu", cpu)):
        task.set_generators(torch.Generator(task.device).manual_seed(0),
                            torch.Generator().manual_seed(0))
        task.model.train()
        reset_launches()
        loss, _ = task.train_loop(task.place_batch(batch))
        loss.backward()
        results[name] = (loss.item(), launches(),
                         {k: p.grad.cpu() for k, p in task.model.named_parameters()
                          if p.grad is not None})
    (loss_card, counted, grads_card), (loss_cpu, _, grads_cpu) = results["card"], results["cpu"]
    largest = max(float(g.abs().max()) for g in grads_cpu.values())
    worst, worst_name = 0.0, ""
    for name, g_cpu in grads_cpu.items():
        if name.endswith("depthwise.bias"):
            # a train-mode BatchNorm follows: the true gradient is zero and
            # both sides hold rounding noise; hold the noise, not its ratio
            err = max(float(grads_card[name].abs().max()), float(g_cpu.abs().max())) / largest
        else:
            err = float((grads_card[name] - g_cpu).abs().max()) / max(float(g_cpu.abs().max()),
                                                                      1e-6 * largest)
        if err > worst:
            worst, worst_name = err, name
    emit({"phase": "train_card_vs_cpu", "batch": [2, 3 * SR], "loss_card": loss_card,
          "loss_cpu": loss_cpu, "gradients": len(grads_cpu),
          "max_rel_err_gradient": worst, "worst_gradient": worst_name,
          "largest_gradient_entry": largest, "tol": TRAIN_TOL,
          "launches_per_train_step": counted})
    ok = (set(grads_card) == set(grads_cpu) and abs(loss_card - loss_cpu) <= TRAIN_TOL
          and worst <= TRAIN_TOL and counted == TRAIN_STEP_LAUNCHES)
    if not ok:
        raise AssertionError("train step on the card disagrees with the CPU")


class _StepLosses(Callback):
    """Records each step's loss and each eval's metrics, and counts the
    kernels' launches of the train epochs apart from those of the eval
    passes (a wrapper counts when the host makes the launch, so a train
    epoch's launches are all counted when its last step returns)."""

    def __init__(self):
        super().__init__()
        self.losses, self.evals = [], []
        self.train_launches = dict.fromkeys(launches(), 0)
        self.eval_launches = dict.fromkeys(launches(), 0)
        self._mark = None

    def _add_since_mark(self, into: dict) -> None:
        now = launches()
        for name in into:
            into[name] += now[name] - self._mark[name]
        self._mark = now

    def before_train_epoch(self, epoch):
        self._mark = launches()

    def after_train_loop(self, step, metrics):
        self.losses.append(metrics["loss"])

    def after_train_epoch(self, epoch, metrics):
        self._add_since_mark(self.train_launches)

    def after_eval_epoch(self, epoch, metrics):
        self._add_since_mark(self.eval_launches)
        self.evals.append(metrics)


def phase_train(gen: torch.Generator):
    """The training main path: ``Trainer.fit`` on the full-width flagship
    with everything random on, checkpoints, a resume and a served request
    from the trained checkpoint.  Launch counts are read around the fit."""
    hp = dict(FLAGSHIP, **TRAIN_HPARAMS)
    rng = np.random.RandomState(0)
    train = [synthetic_batch(rng, i % N_LANG, TRAIN_B, TRAIN_SECONDS)
             for i in range(TRAIN_BATCHES)]
    val = [synthetic_batch(rng, lang, TRAIN_B, TRAIN_SECONDS) for lang in range(N_LANG)]
    task = LidASRTask(**hp, device="cuda")
    init_random_(task.model, gen)
    rec = _StepLosses()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(total_epoch=TRAIN_EPOCHS, use_progress_bar=False, seed=0,
                          callbacks=[rec, CkptCallback(ckpt_dir)])
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        trainer.fit(task, train, val)
        torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - t0
        counted = launches()
        last = f"{ckpt_dir}/last.ckpt"

        resumed_task = LidASRTask(**hp, device="cuda")
        resumed_rec = _StepLosses()
        resumed = Trainer(total_epoch=TRAIN_EPOCHS + 1, use_progress_bar=False, seed=0,
                          callbacks=[resumed_rec], checkpoint_path=last)
        resumed.fit(resumed_task, train, val)
        lid_fn, index2lang = build_lid_fn(last)
        state = InferenceState(lid_fn, index2lang)
        scores = lid_fn(*state.pad(train[0]["wavs"][0][:3 * SR]))

    n_steps, n_evals = TRAIN_EPOCHS * TRAIN_BATCHES, TRAIN_EPOCHS * len(val)
    per_train_step = {k: v / n_steps for k, v in rec.train_launches.items()}
    per_eval_batch = {k: v / n_evals for k, v in rec.eval_launches.items()}
    epoch_loss = [float(np.mean(rec.losses[i * TRAIN_BATCHES:(i + 1) * TRAIN_BATCHES]))
                  for i in range(TRAIN_EPOCHS)]
    last_eval = rec.evals[-1]
    emit({
        "phase": "train", "epochs": TRAIN_EPOCHS, "batches": TRAIN_BATCHES,
        "batch": [TRAIN_B, int(TRAIN_SECONDS * SR)], "fit_seconds": fit_seconds,
        "losses": rec.losses, "epoch_loss": epoch_loss, "evals": rec.evals,
        "launches": counted, "launches_train_steps": rec.train_launches,
        "launches_eval_batches": rec.eval_launches,
        "launches_per_train_step": per_train_step,
        "launches_per_train_step_expected": TRAIN_STEP_LAUNCHES,
        "launches_per_eval_batch": per_eval_batch,
        "resumed": {"start_epoch": resumed.start_epoch, "global_step": resumed.global_step,
                    "losses": resumed_rec.losses},
        "served_from_trained_ckpt": scores.tolist(),
    })
    checks = {
        "finite_losses": bool(np.isfinite(rec.losses + resumed_rec.losses).all()),
        "loss_falls": epoch_loss[-1] < epoch_loss[0],
        "launches": (per_train_step == TRAIN_STEP_LAUNCHES
                     and per_eval_batch == {"fbank": 1, "depthwise": DW_PER_FORWARD,
                                            "depthwise_dx": 0, "depthwise_bwd_w": 0}
                     and counted == {k: rec.train_launches[k] + rec.eval_launches[k]
                                     for k in counted}),
        "eval_metrics": all(np.isfinite(last_eval[k]) for k in ("val_acc", "eer", "cavg",
                                                                  "avg_val_loss")),
        "resume": (resumed.start_epoch == TRAIN_EPOCHS
                   and resumed.global_step == (TRAIN_EPOCHS + 1) * TRAIN_BATCHES
                   and len(resumed_rec.losses) == TRAIN_BATCHES),
        "served": scores.shape == (1, N_LANG) and bool(np.isfinite(scores).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"training phase failed: {checks}")
    return rec.train_launches, (trainer, train)


def _profile_device(fn) -> dict:
    """One ``fn()`` under torch.profiler: wall time, the summed device time
    of its kernels, their ratio, and the ten largest kernel rows."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []  # device-side events only: an aten op's row repeats its kernels' time
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    device_us = sum(r[0] for r in rows)
    return {"wall_us": wall_us, "device_us": device_us,
            "device_busy_share": device_us / wall_us,
            "device_kernels": sum(r[2] for r in rows),
            "top": [{"kernel": key[:80], "us": dev, "count": n} for dev, key, n in rows[:10]]}


def phase_timings(task: LidASRTask, gen: torch.Generator, errs: dict, served: dict,
                  serve_report: dict, trained: dict, training) -> None:
    """Kernel, plain and library times at the main paths' shapes (serving:
    B = 1, 3 s clip; training: B = 8, 4 s clips), their bounds, and the
    model's throughput, latency and train-step time."""
    n_req = serve_report["requests"]
    n_steps = TRAIN_EPOCHS * TRAIN_BATCHES
    kernels = []

    # kernel 1: fbank at B=1, 3 s → (1, 80, 301)
    wav = _wav(1, 3.0, gen)
    n_fft, win, hop, n_mels = 512, 400, 160, 80
    bins = n_fft // 2 + 1
    n_frames = 1 + wav.shape[1] // hop
    window = torch.hann_window(win, device="cuda")
    fb = frontend.mel_bases(n_fft, win, n_mels, SR, wav.device)[1]

    def stft_composite():  # one torch.stft plus the mel projection and log
        spec = torch.stft(wav, n_fft, hop, win, window, center=True, pad_mode="reflect",
                          return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2  # (1, bins, F)
        return 10.0 * torch.log10((power.transpose(1, 2) @ fb).clamp_min(1e-10)).transpose(1, 2)

    lib_err = (stft_composite() - log_mel(wav)).abs().max().item()
    flops = 2.0 * n_frames * win * 2 * bins + 2.0 * n_frames * bins * n_mels
    n_bytes = 4.0 * (wav.numel() + win * 2 * bins + bins * n_mels + n_frames * n_mels)
    b_ms, b_by = bound_ms(n_bytes, flops)
    k_ms = device_ms(lambda: log_mel(wav))
    kernels.append({
        "name": "fbank_log_mel", "route": "cuda",
        "source": "speechlid_tpu_torch/csrc/fbank.cu",
        "replaces": "speechlid_tpu/ops/pallas/fbank_kernel.py:87",
        "launches": served["fbank"], "launches_per_request": served["fbank"] / n_req,
        "launches_train_path": trained["fbank"],
        "launches_per_train_step": trained["fbank"] / n_steps,
        "max_abs_err": errs["fbank"], "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": device_ms(lambda: log_mel_plain(wav)),
        "library_ms": device_ms(stft_composite),
        "library_call": "composite: torch.stft -> |.|^2 -> @ mel fb -> 10 log10",
        "library_max_abs_err_db": lib_err,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "shape": "wav (1, 48000) f32 -> (1, 80, 301)", "flops": flops, "bytes": n_bytes,
        "ms_includes": "reflect pad + kernel (the wrapper call)",
    })

    # kernel 2: depthwise at the encoder's 3 s shape (1, 74, 288), k = 31
    b, t, c, k = SERVE_DW_SHAPE
    x = torch.randn(b, t, c, generator=gen).cuda()
    w = (k ** -0.5 * torch.randn(k, c, generator=gen)).cuda()
    bias = (0.05 * torch.randn(c, generator=gen)).cuda()
    w_conv = w.t().unsqueeze(1).contiguous()  # (C, 1, k) for F.conv1d

    def conv1d_library(inp):
        return F.conv1d(inp.transpose(1, 2), w_conv, bias, padding=(k - 1) // 2,
                        groups=c).transpose(1, 2)

    train_fwd = trained["depthwise"] - trained["depthwise_dx"]
    fwd_rates = {"launches_per_request": served["depthwise"] / n_req,
                 "launches_per_train_step": train_fwd / n_steps}

    def depthwise_entry(name, shape, count, inp, err):
        """The forward kernel's entry at ``inp``'s shape; ``count`` is its
        launches on the main path that has this shape."""
        nb, nt = inp.shape[:2]
        flops = 2.0 * nb * nt * c * k
        n_bytes = 4.0 * (2 * nb * nt * c + k * c + c)
        b_ms, b_by = bound_ms(n_bytes, flops)
        lib_err = (conv1d_library(inp) - depthwise_conv1d(inp, w, bias)).abs().max().item()
        k_ms = device_ms(lambda: depthwise_conv1d(inp, w, bias))
        return {
            "name": name, "route": "cuda",
            "source": "speechlid_tpu_torch/csrc/depthwise.cu",
            "replaces": "speechlid_tpu/ops/pallas/depthwise_kernel.py:122",
            "launches": count, **fwd_rates,
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": device_ms(lambda: depthwise_conv1d_plain(inp, w, bias)),
            "library_ms": device_ms(lambda: conv1d_library(inp)),
            "library_call": "F.conv1d(groups=C) on the (B, C, T) view",
            "library_max_abs_err": lib_err,
            "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
            "shape": shape, "flops": flops, "bytes": n_bytes,
        }

    kernels.append(depthwise_entry(
        "depthwise_conv1d_fwd", "x (1, 74, 288) f32, w (31, 288)", served["depthwise"], x,
        errs["depthwise"][SERVE_DW_SHAPE]))

    # the same kernel at the train step's encoder shape (8, 99, 288): the
    # forward, and dX as the backward calls it (flipped taps, zero bias)
    tb, tt = TRAIN_DW_SHAPE[:2]
    xt = torch.randn(tb, tt, c, generator=gen).cuda()
    gt = (torch.randn(tb, tt, c, generator=gen) / (tb * tt) ** 0.5).cuda()
    w_flip, zero = w.flip(0).contiguous(), torch.zeros_like(bias)
    pad_dx = k - 1 - (k - 1) // 2
    kernels.append(depthwise_entry(
        "depthwise_conv1d_fwd@train", "x (8, 99, 288) f32, w (31, 288)", train_fwd, xt,
        errs["depthwise"][TRAIN_DW_SHAPE]))

    def conv1d_input_library():
        return torch.nn.grad.conv1d_input((tb, c, tt), w_conv, gt.transpose(1, 2),
                                          padding=(k - 1) // 2, groups=c).transpose(1, 2)

    dx_lib_err = (conv1d_input_library()
                  - depthwise_conv1d(gt, w_flip, zero, pad_dx)).abs().max().item()
    flops = 2.0 * tb * tt * c * k
    n_bytes = 4.0 * (2 * tb * tt * c + k * c + c)
    b_ms, b_by = bound_ms(n_bytes, flops)
    k_ms = device_ms(lambda: depthwise_conv1d(gt, w_flip, zero, pad_dx))
    kernels.append({
        "name": "depthwise_conv1d_dx", "route": "cuda",
        "source": "speechlid_tpu_torch/csrc/depthwise.cu",
        "replaces": "speechlid_tpu/ops/pallas/depthwise_kernel.py:77",
        "launches": trained["depthwise_dx"],
        "launches_per_train_step": trained["depthwise_dx"] / n_steps,
        "launches_per_request": served["depthwise_dx"] / n_req,
        "max_abs_err": errs["depthwise_bwd"][TRAIN_DW_SHAPE]["dx"],
        "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": device_ms(lambda: depthwise_conv1d_plain(gt, w_flip, zero, pad_dx)),
        "library_ms": device_ms(conv1d_input_library),
        "library_call": "torch.nn.grad.conv1d_input(groups=C) on the (B, C, T) view",
        "library_max_abs_err": dx_lib_err,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "shape": "g (8, 99, 288) f32, flipped w (31, 288), zero bias",
        "flops": flops, "bytes": n_bytes,
        "ms_includes": "the forward kernel alone; the backward's flip and zero bias are not in it",
    })

    # kernel 3: the weight/bias gradient at the train step's encoder shape
    x_conv, g_conv = xt.transpose(1, 2), gt.transpose(1, 2)

    def conv1d_weight_library():
        dw = torch.nn.grad.conv1d_weight(x_conv, (c, 1, k), g_conv, padding=(k - 1) // 2,
                                         groups=c)
        return dw[:, 0, :].t(), gt.sum(dim=(0, 1))

    got_dw, got_db = depthwise_conv1d_bwd_w(xt, gt, k)
    lib_dw, lib_db = conv1d_weight_library()
    lib_err = max((got_dw - lib_dw).abs().max().item(), (got_db - lib_db).abs().max().item())
    n_bytes = 4.0 * 2 * tb * tt * c  # x and g read once; the (k+1, C) result is 0.5 % of that
    b_ms, b_by = bound_ms(n_bytes, flops)
    k_ms = device_ms(lambda: depthwise_conv1d_bwd_w(xt, gt, k))
    kernels.append({
        "name": "depthwise_conv1d_bwd_w", "route": "cuda",
        "source": "speechlid_tpu_torch/csrc/depthwise.cu",
        "replaces": "speechlid_tpu/ops/pallas/depthwise_kernel.py:78",
        "launches": trained["depthwise_bwd_w"],
        "launches_per_train_step": trained["depthwise_bwd_w"] / n_steps,
        "launches_per_request": served["depthwise_bwd_w"] / n_req,
        "max_abs_err": errs["depthwise_bwd"][TRAIN_DW_SHAPE]["bwd_w"],
        "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": device_ms(lambda: depthwise_conv1d_bwd_w_plain(xt, gt, k)),
        "library_ms": device_ms(conv1d_weight_library),
        "library_call": "torch.nn.grad.conv1d_weight(groups=C) + g.sum((0, 1))",
        "library_max_abs_err": lib_err,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "shape": "x, g (8, 99, 288) f32 -> dw (31, 288), db (288,)",
        "flops": flops, "bytes": n_bytes,
        "ms_includes": "partial-sum kernel + fixed-order reduce kernel (the wrapper call)",
    })
    for entry in kernels:
        if not entry["launches"] > 0:
            raise AssertionError(f"{entry['name']} was not launched on its main path")

    # end to end, training: the step at B = 8, 4 s clips, its launches as
    # counted over these steps, the shape its encoder convs see, and its profile
    trainer, train_batches = training
    seen = []
    conv = trainer.module.model.featurizer.blocks[0].conv.depthwise
    hook = conv.register_forward_hook(
        lambda mod, args, out: seen.append((*args[0].shape, mod.weight.shape[0])))
    for batch in train_batches[:3]:
        trainer.train_step(batch)
    torch.cuda.synchronize()
    timed_steps = 12
    reset_launches()
    t0 = time.perf_counter()
    for i in range(timed_steps):
        metrics = trainer.train_step(train_batches[i % len(train_batches)])
    float(metrics["loss"])
    step_s = (time.perf_counter() - t0) / timed_steps
    per_step = {name: n / timed_steps for name, n in launches().items()}
    hook.remove()
    if per_step != TRAIN_STEP_LAUNCHES or set(seen) != {TRAIN_DW_SHAPE}:
        raise AssertionError(f"train step: launches {per_step}, encoder conv shapes {set(seen)}")
    torch.cuda.reset_peak_memory_stats()
    train_profile = _profile_device(lambda: trainer.train_step(train_batches[0]))
    train_e2e = {"batch": [TRAIN_B, int(TRAIN_SECONDS * SR)], "ms_per_step": step_s * 1e3,
                 "utt_per_s": TRAIN_B / step_s, "timed_steps": timed_steps,
                 "launches_per_step": per_step,
                 "encoder_conv_shape": list(TRAIN_DW_SHAPE),
                 "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
                 "profile_step": train_profile}

    # end to end: infer throughput on 3 s clips, served p50
    infer = task.infer_fn()
    e2e = {}
    for batch, iters in ((1, 30), (32, 10)):
        wavs = 0.1 * torch.randn(batch, 3 * SR, generator=gen)
        lengths = torch.full((batch,), 3 * SR)
        for _ in range(3):
            infer(wavs, lengths)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = infer(wavs, lengths)
        out["scores"].cpu()
        dt = (time.perf_counter() - t0) / iters
        e2e[f"b{batch}"] = {"ms_per_batch": dt * 1e3, "utt_per_s": batch / dt}

    # one B=1 forward under the profiler: device time by kernel, busy share
    wavs = 0.1 * torch.randn(1, 3 * SR, generator=gen)
    lengths = torch.tensor([3 * SR])
    infer_profile = _profile_device(lambda: infer(wavs, lengths)["scores"].cpu())
    emit({
        "phase": "e2e", "infer_3s": e2e,
        "lid_p50_ms_client": serve_report["client_p50_ms"],
        "lid_p50_ms_handler": serve_report["stats"]["total"]["p50_ms"],
        "lid_p50_ms_device": serve_report["stats"]["device"]["p50_ms"],
        "profile_b1_3s": infer_profile,
        "train_step_b8_4s": train_e2e,
    })
    emit({"kernels": kernels})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    gen = torch.Generator().manual_seed(0)
    phase_build()
    errs = {"fbank": phase_fbank(gen), "depthwise": phase_depthwise(gen),
            "depthwise_bwd": phase_depthwise_bwd(gen)}
    task = phase_model(gen)
    serve_report = phase_serve(task, gen)
    served = serve_report["launches"]
    phase_train_card_vs_cpu(gen)
    trained, training = phase_train(gen)
    phase_timings(task, gen, errs, served, serve_report, trained, training)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
