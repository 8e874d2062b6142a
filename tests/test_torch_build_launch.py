"""The kernel wrappers' one launch path, ``ops/cuda/_build.launch``, against
a fake library on the CPU: it counts the kernels of each launch under its
key, raises on a CUDA error without counting, counts no query, and looks
the entry point up at every call, so that a wrapper put in its place (the
benchmark's ``harness.launches.LaunchRecorder``) sees every launch."""

import collections
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from speechlid_tpu_torch.ops.cuda import _build

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.launches import LaunchRecorder  # noqa: E402


class FakeLibrary(SimpleNamespace):
    """Every entry point of ``_build._SIGNATURES``, recording its arguments
    and returning ``err``."""

    def __init__(self, err: int = 0):
        super().__init__(calls=[])
        for entry in _build._SIGNATURES:
            setattr(self, entry, self._entry(entry, err))

    def _entry(self, entry, err):
        def fn(*args):
            self.calls.append((entry, args))
            return err
        return fn

    @staticmethod
    def speechlid_cuda_error_string(err):
        return b"an illegal memory access was encountered"


@pytest.fixture
def fake(monkeypatch):
    library = FakeLibrary()
    monkeypatch.setattr(_build, "lib", lambda: library)
    monkeypatch.setattr(_build, "launches", collections.Counter())
    return library


def test_counts_kernels_per_key(fake):
    for _ in range(2):
        _build.launch("depthwise_conv1d_glu_fwd", 1, 2, mode="glu", dtype=torch.float32,
                      width=144)
    _build.launch("depthwise_conv1d_glu_bwd", 3, mode="glu_dx", dtype=torch.bfloat16, width=144)
    _build.launch("depthwise_conv1d_bwd_w", 4, mode="bwd_w", dtype=torch.float32, width=288)
    _build.launch("relpos_attn_bwd", 5, kernels=3)
    assert _build.launches == {
        _build.LaunchKey("depthwise_conv1d_glu_fwd", "glu", torch.float32, 144): 2,
        _build.LaunchKey("depthwise_conv1d_glu_bwd", "glu_dx", torch.bfloat16, 144): 1,
        _build.LaunchKey("depthwise_conv1d_bwd_w", "bwd_w", torch.float32, 288): 1,
        _build.LaunchKey("relpos_attn_bwd"): 3,
    }
    assert _build.launched() == 7
    assert _build.launched(width=144) == 3
    assert _build.launched(dtype=torch.float32) == 3
    assert _build.launched(mode="glu", width=144) == 2
    assert _build.launched(entry="relpos_attn_bwd") == 3
    assert _build.launched(mode="plain") == 0
    assert [args for _, args in fake.calls] == [(1, 2), (1, 2), (3,), (4,), (5,)]


def test_raises_on_a_cuda_error_and_counts_nothing(monkeypatch):
    monkeypatch.setattr(_build, "lib", lambda: FakeLibrary(err=700))
    monkeypatch.setattr(_build, "launches", collections.Counter())
    with pytest.raises(RuntimeError, match=r"subsample_fwd: CUDA error 700 \(an illegal"):
        _build.launch("subsample_fwd", 1)
    with pytest.raises(RuntimeError, match="fbank_log_mel_setup: CUDA error 700"):
        _build.call("fbank_log_mel_setup", 160, 400, 8, 0, 0)
    assert _build.launched() == 0


def test_a_query_is_not_counted(fake):
    _build.call("fbank_log_mel_setup", 160, 400, 8, 0, 0)
    assert fake.calls == [("fbank_log_mel_setup", (160, 400, 8, 0, 0))]
    assert _build.launched() == 0


def test_sees_an_entry_swapped_after_the_first_call(fake):
    _build.launch("relpos_attn_fwd", 1)
    original, seen = fake.relpos_attn_fwd, []

    def wrapper(*args):
        seen.append(args)
        return original(*args)

    fake.relpos_attn_fwd = wrapper
    _build.launch("relpos_attn_fwd", 2)
    fake.relpos_attn_fwd = original
    _build.launch("relpos_attn_fwd", 3)
    assert seen == [(2,)]
    assert [args for _, args in fake.calls] == [(1,), (2,), (3,)]
    assert _build.launched(entry="relpos_attn_fwd") == 3


def test_the_benchmark_recorder_sees_each_launch(fake):
    """``LaunchRecorder`` swaps the entry points on ``_build.lib()`` for its
    span: each launch made then is recorded once, with its arguments read
    by position, and none after."""
    # wav, batch, T, n_frames, basis, win_pad, n_tiles, bins, fb, mel_range,
    # n_mels, hop, frame_offset, resident_clusters, out, stream
    fbank_args = (0, 8, 64000, 401, 0, 416, 5, 257, 0, 0, 80, 160, -56, 33, 0, 0)
    with LaunchRecorder(_build.lib()) as recorder:
        _build.launch("fbank_log_mel_f32", *fbank_args)
        _build.launch("depthwise_conv1d_bwd_w", 0, 0, 0, 0, 8, 99, 288, 31, 15, 0, 0,
                      mode="bwd_w", dtype=torch.float32, width=288)
    _build.launch("fbank_log_mel_f32", *fbank_args)
    assert [(r.entry, r.mode) for r in recorder.launches] == [
        ("fbank_log_mel_f32", "log_mel"), ("depthwise_conv1d_bwd_w", "bwd_w")]
    assert len(fake.calls) == 3
    assert _build.launched(entry="fbank_log_mel_f32") == 2
