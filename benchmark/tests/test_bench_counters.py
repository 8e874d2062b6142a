"""The frozen yardstick: the kernels' bounds as the port's kernel table
(PERF.md) has them, the model FLOPs against torch's FLOP counter on the
reference, the launch records and the trace reader."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_config
from harness import counters, launches, trace, weights
from reference import frontend
from reference import model as ref


@pytest.mark.parametrize("mode, shape, bound_ms", [
    ("glu", (8, 99, 288), 0.00110),
    ("glu_bn_act", (32, 149, 1536), 0.0263),
    ("glu_bn_act", (32, 74, 288), 0.00246),
    ("glu_dx", (8, 99, 288), 0.00137),
    ("bwd_w", (8, 99, 288), 0.000545),
    ("glu_dx", (8, 199, 1536), 0.01466),
    ("glu", (2, 649, 2048), 0.01278),
])
def test_depthwise_bounds(mode, shape, bound_ms):
    n_bytes, flops = counters.depthwise_cost(mode, *shape, 31)
    assert counters.bound_s(n_bytes, flops) * 1e3 == pytest.approx(bound_ms, rel=5e-3)


@pytest.mark.parametrize("shape, bound_ms", [((8, 64000), 0.000918), ((32, 48000), 0.002755),
                                             ((1, 48000), 0.0000867)])
def test_fbank_bounds(shape, bound_ms):
    """The log-mel's least work: the wave in and the mel out over the
    bandwidth, above an FFT a frame over the float32 rate (the kernel
    table's 0.0217 / 0.0650 / 0.00203 ms counted its dense DFT)."""
    n_bytes, flops = counters.fbank_cost(*shape)
    assert n_bytes / counters.PEAK_HBM_BYTES_S > flops / counters.PEAK_FP32_FLOPS
    assert counters.bound_s(n_bytes, flops) * 1e3 == pytest.approx(bound_ms, rel=5e-3)


def _reference_flops(cfg, samples):
    shapes = []
    from harness import program
    task = program.build_task(cfg, "cpu")
    params = weights.make_weights(weights.float_entries(task.model), 3, "cpu")
    wav = torch.randn(1, samples)
    with FlopCounterMode(display=False) as counter:
        ref.logits_all(cfg, params, wav, torch.tensor([samples]))
    return counter.get_total_flops()


@pytest.mark.parametrize("name, samples", [("conformer_flagship", 8000),
                                           ("wavlm_base_plus", 8000)])
def test_model_flops_match_the_flop_counter(name, samples):
    cfg = tiny_config(name)
    n = len(cfg["langs"])
    disc = 2.0 * (n * 128 + 128 * n)  # the discriminator, which logits_all does not run
    want = counters.model_flops(cfg, [samples], train=False) - disc
    if cfg["task"]["featurizer"] == "conformer":
        # the reference computes its STFT as a dense DFT product; the count
        # takes the log-mel's least work in its place
        frames, bins = 1 + samples // frontend.HOP, frontend.N_FFT // 2 + 1
        mels = cfg["task"]["n_mels"]
        dense = 2.0 * frames * frontend.WIN * 2 * bins + 2.0 * frames * bins * mels
        want += dense - frontend.least_flops(frames, mels)
    assert _reference_flops(cfg, samples) == pytest.approx(want, rel=1e-9)


def test_training_counts_one_head_and_three_passes():
    cfg = tiny_config("conformer_flagship")
    score = counters.model_flops(cfg, [8000], train=False)
    train = counters.model_flops(cfg, [8000], train=True)
    assert 0 < train < score


def test_launch_description_and_pairing():
    fwd = (1, 2, 3, 4, None, None, None, None, 0.0, 0, 5, 6, 8, 99, 288, 31, 15, 0, 7)
    glu = launches.describe("depthwise_conv1d_glu_fwd", fwd)
    assert glu.mode == "glu" and glu.layer == "depthwise"
    assert glu.cost == counters.depthwise_cost("glu", 8, 99, 288, 31)
    fb = launches.describe("fbank_log_mel_f32", (1, 8, 64000, 401, 2, 400, 8, 257, 3, 4, 80,
                                                 160, 0, 1, 5, 6))
    assert fb.cost == counters.fbank_cost(8, 64000)
    kernels = [("void depthwise_conv1d_kernel<float, 1, 0, true>(FwdArgs)", 2e-5),
               ("ampere_sgemm", 1e-4), ("fbank_log_mel_kernel(...)", 1e-4)]
    paired = launches.pair([glu, fb], kernels)
    share = launches.roofline_share(paired, "fbank")
    assert share == pytest.approx(100 * fb.bound_s / 1e-4)
    assert launches.pair([glu, glu], kernels) is None  # a dropped record: nothing paired


def test_trace_reader():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.SPAN, "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 10.0, "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 25.0, "dur": 15.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60.0, "dur": 10.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 40.0, "dur": 25.0}]
    t = trace.read(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)  # [10, 40] and [60, 70]
    assert [k[0] for k in t.kernels] == ["a", "b"]
    gaps = dict(t.idle_gaps)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(20e-6)  # the gap [40, 60]
    assert gaps["host: between CUDA calls"] == pytest.approx(40e-6)  # [0, 10] and [70, 100]
