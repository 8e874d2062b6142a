#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``speechlid_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout, one H100

It builds the port's CUDA kernels from ``speechlid_tpu_torch/csrc`` (into
``build/``), holds each kernel against its plain PyTorch version on the
card, runs the full-width Conformer joint-LID model through both kernels and
against the same weights on the CPU, serves it on ``/lid`` from a thread and
posts requests to it, and times the kernels and the model.  Each phase
prints one JSON line; any failure raises and exits non-zero.  The
``{"kernels": …}`` line lists every kernel with its launches on the served
path, its error against its plain version and its times beside its bound.
The last line is ``{"ok": true, "device": …}``.

float32 throughout, with TF32 off for matmuls and cuDNN convolutions
(cuDNN would otherwise run the Conv2d subsampling in TF32).  Weights are
random, from a seeded ``torch.Generator``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch
import torch.nn.functional as F

from speechlid_tpu_torch.cli.serve import InferenceState, make_handler, make_lid_fn
from speechlid_tpu_torch.models.conformer import DepthwiseConv1d, MaskedBatchNorm
from speechlid_tpu_torch.ops import frontend
from speechlid_tpu_torch.ops.cuda import _build
from speechlid_tpu_torch.ops.cuda.depthwise_kernel import (
    depthwise_conv1d,
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
SERVE_ROUNDS = 4


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


DW_SHAPES = ((1, 74, 288, 31), (32, 74, 288, 31), (1, 7, 64, 31),
             (3, 100, 129, 15), (2, 50, 96, 4))


def phase_depthwise(gen: torch.Generator) -> float:
    worst = 0.0
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
        worst = max(worst, err)
    return worst


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


def launches() -> dict:
    return {"fbank": log_mel.launches, "depthwise": depthwise_conv1d.launches}


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
        "launches": per_forward == {"fbank": 1, "depthwise": DW_PER_FORWARD},
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
          and served == {"fbank": n_req, "depthwise": DW_PER_FORWARD * n_req})
    if not ok:
        raise AssertionError("serving phase failed")
    return report


def phase_timings(task: LidASRTask, gen: torch.Generator, errs: dict, served: dict,
                  serve_report: dict) -> None:
    """Kernel, plain and library times at the main path's shapes (B = 1,
    3 s clip), their bounds, and the model's throughput and latency."""
    n_req = serve_report["requests"]
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
    b, t, c, k = 1, 74, 288, 31
    x = torch.randn(b, t, c, generator=gen).cuda()
    w = (k ** -0.5 * torch.randn(k, c, generator=gen)).cuda()
    bias = (0.05 * torch.randn(c, generator=gen)).cuda()
    w_conv = w.t().unsqueeze(1).contiguous()  # (C, 1, k) for F.conv1d

    def conv1d_library():
        return F.conv1d(x.transpose(1, 2), w_conv, bias, padding=(k - 1) // 2,
                        groups=c).transpose(1, 2)

    lib_err = (conv1d_library() - depthwise_conv1d(x, w, bias)).abs().max().item()
    flops = 2.0 * b * t * c * k
    n_bytes = 4.0 * (2 * b * t * c + k * c + c)
    b_ms, b_by = bound_ms(n_bytes, flops)
    k_ms = device_ms(lambda: depthwise_conv1d(x, w, bias))
    kernels.append({
        "name": "depthwise_conv1d_fwd", "route": "cuda",
        "source": "speechlid_tpu_torch/csrc/depthwise.cu",
        "replaces": "speechlid_tpu/ops/pallas/depthwise_kernel.py:122",
        "launches": served["depthwise"], "launches_per_request": served["depthwise"] / n_req,
        "max_abs_err": errs["depthwise"], "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": device_ms(lambda: depthwise_conv1d_plain(x, w, bias)),
        "library_ms": device_ms(conv1d_library),
        "library_call": "F.conv1d(groups=C) on the (B, C, T) view",
        "library_max_abs_err": lib_err,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "shape": "x (1, 74, 288) f32, w (31, 288)", "flops": flops, "bytes": n_bytes,
    })

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
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        infer(wavs, lengths)["scores"].cpu()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []  # device-side events only: an aten op's row repeats its kernels' time
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    device_us = sum(r[0] for r in rows)
    emit({
        "phase": "e2e", "infer_3s": e2e,
        "lid_p50_ms_client": serve_report["client_p50_ms"],
        "lid_p50_ms_handler": serve_report["stats"]["total"]["p50_ms"],
        "lid_p50_ms_device": serve_report["stats"]["device"]["p50_ms"],
        "profile_b1_3s": {"wall_us": wall_us, "device_us": device_us,
                          "device_busy_share": device_us / wall_us,
                          "top": [{"kernel": key[:80], "us": dev, "count": n}
                                  for dev, key, n in rows[:10]]},
    })
    emit({"kernels": kernels})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    gen = torch.Generator().manual_seed(0)
    phase_build()
    errs = {"fbank": phase_fbank(gen), "depthwise": phase_depthwise(gen)}
    task = phase_model(gen)
    serve_report = phase_serve(task, gen)
    served = serve_report["launches"]
    phase_timings(task, gen, errs, served, serve_report)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
