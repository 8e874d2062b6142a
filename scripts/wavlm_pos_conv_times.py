#!/usr/bin/env python3
"""Where the WavLM-Base+ positional conv's time goes on one CUDA card.

    python3 scripts/wavlm_pos_conv_times.py     # from the root of a checkout

The grouped positional conv (K = 128, 16 groups, 768 channels) of the
WavLM-Base+ joint model on 3 s clips, timed four ways: CUDA-graph replay
(``chip_smoke.device_ms``), CUDA events around eager calls, the summed
device time of its kernels under ``torch.profiler``, and a whole B = 1
forward with and without it (its output replaced by zeros) timed with CUDA
events.  Then the same conv's forward and backward (the input's and the
weights' gradients) at the train step's shape (8 × 4 s clips) in float32
and in bfloat16 (``WavLMConfig.dtype``), between CUDA events, with cuDNN's
default algorithms and with the ones its search picks, and the device time
of the data gradient's kernels under ``torch.profiler``.  Prints one JSON
line with the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from speechlid_tpu_torch.models.wavlm import WavLMConfig, _WeightNormConvPos  # noqa: E402
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask  # noqa: E402

SR = 16000


def event_ms(fn, reps: int = 20) -> float:
    """Mean ms of one eager ``fn()`` between CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_us(fn, match: str) -> dict:
    """Device µs and launches, under torch.profiler, of the kernels of one
    ``fn()`` whose name holds ``match``, and of all its kernels."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    hit = [e for e in rows if match in e.key]
    return {"us": sum(e.self_device_time_total for e in hit), "launches": sum(e.count for e in hit),
            "all_us": sum(e.self_device_time_total for e in rows)}


def main() -> int:
    if not torch.cuda.is_available():
        print("wavlm_pos_conv_times: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    task = LidASRTask(**chip_smoke.WAVLM, device="cuda")
    chip_smoke.init_wavlm_(task, gen)
    pos_conv = task.model.featurizer.upstream.pos_conv
    infer = task.infer_fn()
    out = {"nvidia_smi": smi, "torch": torch.__version__}
    with torch.no_grad():
        for batch in (1, 32):
            x = torch.randn(batch, chip_smoke._wavlm_frames(3.0), 768, generator=gen).cuda()
            out[f"pos_conv_b{batch}"] = {
                "graph_replay_ms": chip_smoke.device_ms(lambda: pos_conv(x)),
                "events_ms": event_ms(lambda: pos_conv(x)),
                "profiled": profiled_us(lambda: pos_conv(x), "convolve"),
            }
    for batch in (1, 32):
        wavs = 0.1 * torch.randn(batch, 3 * SR, generator=gen)
        lengths = torch.full((batch,), 3 * SR)
        with_conv = event_ms(lambda: infer(wavs, lengths), reps=10)
        profiled = profiled_us(lambda: infer(wavs, lengths), "convolve")
        forward = pos_conv.forward
        pos_conv.forward = lambda y: torch.zeros_like(y)
        try:
            without = event_ms(lambda: infer(wavs, lengths), reps=10)
        finally:
            pos_conv.forward = forward
        out[f"infer_b{batch}_3s"] = {"events_ms": with_conv, "events_ms_without_pos_conv": without,
                                     "profiled_convolve": profiled}
    x = torch.randn(chip_smoke.WAVLM_TRAIN_B, chip_smoke._wavlm_frames(4.0), 768,
                    generator=gen).cuda()
    g = torch.randn(x.shape, generator=gen).cuda()
    for dtype in ("float32", "bfloat16"):
        conv = _WeightNormConvPos(WavLMConfig.from_dict(
            dict(chip_smoke.WAVLM_BASE_PLUS, dtype=dtype))).cuda()
        conv.load_state_dict(pos_conv.state_dict())
        xin = x.to(conv.dtype).requires_grad_(True)
        grad = g.to(conv.dtype)

        def step():
            return torch.autograd.grad(conv(xin), [xin, conv.weight_v], grad)

        row = {"forward_backward_events_ms": event_ms(step),
               "dgrad_profiled": profiled_us(step, "dgrad")}
        with torch.no_grad():
            row["forward_events_ms"] = event_ms(lambda: conv(xin))
        torch.backends.cudnn.benchmark = True  # what cuDNN's own search would pick
        try:
            row["forward_backward_events_ms_cudnn_benchmark"] = event_ms(step)
        finally:
            torch.backends.cudnn.benchmark = False
        out[f"pos_conv_train_b8_4s_{dtype}"] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
