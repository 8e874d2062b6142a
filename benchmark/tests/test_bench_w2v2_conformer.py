"""The wav2vec 2.0 Conformer Large configuration
(``configs/wav2vec2_conformer_large.json``) on the CPU at tiny widths: a
training run through the harness comes out ``correct`` against
``reference/wav2vec2_conformer.py``, a program whose conv extractor trains
against the recipe's freeze does not; the conv-module and rel-pos roofline
readers say nothing for scoring and read the program's spans and counter in
training; ``flops`` is the hand count at one length."""

import copy
import json

import pytest
import torch

from conftest import BENCH, TINY_TRAFFIC
from harness import runner, spec
from harness.counters import PEAK_FP32_FLOPS
from harness.trace import Trace

TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 0.05,
                "w_loss_gap": 1e-5, "w_grad_gap": 1e-3, "w_change_gap": 0.05}
SEED = 2 ** 31 + 5151
READERS = ("device_ms.conv_module.train", "roofline_relpos.train")
NAME = "wav2vec2_conformer_large"


@pytest.fixture
def one_thread():
    """One intra-op thread, so that test workers sharing the machine leave
    the window time to reach the step it keeps."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def recoder():
    from speechlid_tpu_torch.core.profile import _time_cost_recoder

    _time_cost_recoder.remove_recoder()
    yield _time_cost_recoder
    _time_cost_recoder.remove_recoder()


def tiny_cell(mode: str, limits: dict, batch: int = 3) -> spec.Cell:
    """The configuration at tiny widths (head width 32), the conftest's tiny
    traffic."""
    with open(BENCH / "configs" / f"{NAME}.json") as f:
        cfg = json.load(f)
    cfg["task"]["ssl_config"].update(
        encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
        encoder_attention_heads=2, depthwise_conv_kernel_size=7,
        conv_feature_layers="[(16,10,5)] + [(16,3,2)] * 2")
    cfg["task"].update(head_dim_head=4, head_num_head=2)
    params = {"mode": mode, "batch": batch, "sample_per_kind": 1, "limits": limits}
    return spec.Cell(f"{NAME}.tiny_{mode}", cfg, copy.deepcopy(TINY_TRAFFIC), params, 1)


def _train():
    """A run on the CPU whose window reaches the step it keeps (after the
    loader's first cycle: about a dozen tiny batches)."""
    torch.manual_seed(0)
    return runner.run(tiny_cell("train", TRAIN_LIMITS), SEED, 6.0, False, "cpu")


def test_training_agrees(one_thread):
    result = _train()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_trainable_extractor_is_caught(one_thread, monkeypatch):
    """The extractor left out of the freeze: its gradients and steps have
    no counterpart in the reference, which holds it still."""
    from speechlid_tpu_torch.tasks import lid_asr

    monkeypatch.setattr(lid_asr, "SSL_EXTRACTOR_PARTS", ())
    result = _train()
    assert not result["correct"]
    assert result["checks"]["grad_gap"]["value"] > TRAIN_LIMITS["grad_gap"]


def test_readers_say_nothing_for_scoring():
    cell = tiny_cell("score", {"lp_err": 1.0})
    readers = spec.load_readers(list(READERS))
    trace = Trace(window_s=1.0, busy_s=0.5, kernels=[("relpos_fwd_kernel<64>", 1e-3)])
    for name in READERS:
        assert readers[name](runner.Run(cell, "score", trace=trace)) is None, name


def test_readers_in_training(one_thread, recoder, monkeypatch):
    """Off the card the spans have no device time and the wrappers launch
    nothing, so both readers say nothing; with the host time standing in
    for the device's, the conv-module reader gives its spans' sum a forward
    (the encoder's layers and the own head's block), and with launches in
    the counter and relpos kernels in the trace the roofline reader gives
    their products (a masked launch's at its valid pairs) over the peak over
    the kernels' seconds."""
    from speechlid_tpu_torch.core import profile

    cell = tiny_cell("train", {"loss_gap": 1.0})
    torch.manual_seed(0)
    state = runner.mode_class(cell)(cell, SEED, "cpu")
    recoder.remove_recoder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        window = state.loop(0.5)
    kernels = [("void (anonymous namespace)::xl::relpos_fwd_kernel<64>(Args)", 2e-3),
               ("sgemm", 5e-3),
               ("void (anonymous namespace)::xl::relpos_bwd_kernel<64>(Args)", 6e-3)]
    run = runner.Run(cell, "train", window=window,
                     trace=Trace(window_s=1.0, busy_s=0.5, kernels=kernels))
    readers = spec.load_readers(list(READERS))
    assert all(readers[name](run) is None for name in READERS)
    monkeypatch.setattr(profile.Span, "device_ms", property(lambda s: s.host_ms))
    spans = recoder.spans()
    forwards = sum(s.name == "trainer.forward" for s in spans)
    convs = [s.host_ms for s in spans if s.name == "model.conv_module"]
    layers = cell.config["task"]["ssl_config"]["encoder_layers"]
    assert forwards == window.steps and len(convs) == (layers + 1) * forwards
    assert readers["device_ms.conv_module.train"](run) == pytest.approx(
        sum(convs) / forwards, rel=1e-12)
    # rows of 649 and 300 valid frames (the flagship's masked call), then
    # the XL cell's unmasked one
    mask = torch.arange(649)[None, :] < torch.tensor([649, 300])[:, None]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        recoder.count("relpos_attn", ("forward", 2, 4, 649, 64, mask))
        recoder.count("relpos_attn", ("backward", 8, 16, 649, 64, None))
    recoder.count("relpos_attn", ("forward", 8, 16, 649, 64, None))  # no profiler: not counted
    least = (3 * 2.0 * 4 * (649 ** 2 + 300 ** 2) * 64
             + 2 * 3 * 2.0 * 8 * 16 * 649 * 649 * 64) / PEAK_FP32_FLOPS
    assert readers["roofline_relpos.train"](run) == pytest.approx(100.0 * least / 8e-3,
                                                                  rel=1e-12)
    monkeypatch.setattr(profile, "_time_cost_recoder", object())  # a program without either
    assert all(readers[name](run) is None for name in READERS)


def test_flops_is_the_hand_count():
    """One row of 13 s at the published widths: 649 frames out of the
    extractor; per layer two FFNs (8·t·c·f), q, k, v, out (8·t·c²), the conv
    module's pointwise GEMMs (6·t·c²) and depthwise (2·t·c·k), the
    attention's three products (6·t²·c)."""
    from reference import wav2vec2_conformer as ref

    with open(BENCH / "configs" / f"{NAME}.json") as f:
        cfg = json.load(f)
    total, t = ref.flops(cfg, 208000)
    assert t == 649
    c, f, k = 1024, 4096, 31
    extractor = 2.0 * 41599 * 512 * 10
    for t_out, kk in ((20799, 3), (10399, 3), (5199, 3), (2599, 3), (1299, 2), (649, 2)):
        extractor += 2.0 * t_out * 512 * 512 * kk
    layer = 8.0 * t * c * f + 8.0 * t * c * c + 6.0 * t * c * c + 2.0 * t * c * k \
        + 6.0 * t * t * c
    assert total == pytest.approx(extractor + 2.0 * t * 512 * c + 24 * layer, rel=1e-12)
