"""The port's time stretch and SpecAugment against the JAX package's, on the
CPU.  torch's generators cannot reproduce JAX's random streams, so the
deterministic parts are held against JAX on given values (1e-5, atol and
rtol: float32 linear interpolation of dB features; masks and lengths
exact), and the draws against their distributions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.ops import frontend as jfrontend
from speechlid_tpu.ops import specaugment as jspec
from speechlid_tpu_torch.ops import frontend, specaugment
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5


def _spec(seed, b=3, f=80, t=301):
    return (20.0 * np.random.RandomState(seed).randn(b, f, t) - 30.0).astype(np.float32)


@pytest.mark.parametrize("rate", [0.9, 1.0, 1.1])
@pytest.mark.parametrize("t", [301, 74])
def test_phase_vocoder_matches_jax(rate, t):
    spec = _spec(0, t=t)
    want = np.asarray(jspec.phase_vocoder(jnp.asarray(spec), rate, 160, 80))
    got = specaugment.phase_vocoder(torch.from_numpy(spec), rate).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("index,rate", [(0, 0.9), (1, 1.0), (2, 1.1)])
def test_time_stretch_width_and_lengths_match_jax(monkeypatch, index, rate):
    """The JAX function with its rate draw pinned to ``index``: the output
    keeps the input width (cropped for 0.9, zero-padded for 1.1) and the
    lengths are min(ceil(len / rate), T)."""
    spec = _spec(1)
    lengths = np.array([301, 200, 7], np.int32)
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(index))
    want, want_len = jspec.random_time_stretch(
        jax.random.PRNGKey(0), jnp.asarray(spec), 160, lengths=jnp.asarray(lengths))
    got, got_len = specaugment.time_stretch(torch.from_numpy(spec), rate,
                                            torch.from_numpy(lengths))
    assert got.shape == spec.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32


def test_masks_from_given_spans_match_jax():
    """The same (start, end) spans: the port's keep-masks and masked
    spectrogram equal the JAX package's comparison-and-where."""
    spec = _spec(2, t=120)
    rng = np.random.RandomState(3)
    spans = {}
    for name, axis_len, param in (("f", 80, 27.0), ("t", 120, 6.0)):
        value = rng.rand(2, 3).astype(np.float32) * param
        start = rng.rand(2, 3).astype(np.float32) * (axis_len - value)
        spans[name] = (start, start + value, axis_len)

    def jax_keep(start, end, axis_len):
        idx = jnp.arange(axis_len)[None, None, :].astype(jnp.float32)
        masked = jnp.any((idx >= start[..., None]) & (idx < end[..., None]), axis=0)
        return ~masked

    keep_f = specaugment.spans_keep_mask(*map(torch.from_numpy, spans["f"][:2]), 80)
    keep_t = specaugment.spans_keep_mask(*map(torch.from_numpy, spans["t"][:2]), 120)
    want_f, want_t = jax_keep(*spans["f"]), jax_keep(*spans["t"])
    np.testing.assert_array_equal(keep_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(want_t))
    want = jnp.where(want_f[:, :, None] & want_t[:, None, :], jnp.asarray(spec), 0.0)
    got = specaugment.apply_masks(torch.from_numpy(spec), keep_f, keep_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).any() and (got.numpy() != 0).any()


def test_drawn_spans_stay_in_their_bounds():
    """length ~ U[0, param), start ~ U[0, axis_len - length), per utterance
    when the bound is a (B,) tensor; the mean length is near param / 2."""
    gen = torch.Generator().manual_seed(0)
    param = torch.tensor([5.0, 15.0, 0.0])
    start, end = specaugment.draw_axis_spans(gen, 3, 300, param, n_masks=400)
    length = end - start
    assert start.shape == (400, 3)
    assert (length >= 0).all() and (length < param.clamp_min(1e-9)).all()
    assert (start >= 0).all() and (end <= 300).all()
    np.testing.assert_allclose(length.mean(0).numpy(), [2.5, 7.5, 0.0], atol=0.6)
    again = specaugment.draw_axis_spans(torch.Generator().manual_seed(0), 3, 300, param, 400)
    assert torch.equal(again[0], start)  # the generator decides the draw


def test_spec_augment_scales_time_masks_with_valid_length():
    spec = torch.from_numpy(_spec(4, b=2, t=400))
    lengths = torch.tensor([400, 40])
    widest = [0, 0]
    gen = torch.Generator().manual_seed(1)
    for _ in range(50):
        out = specaugment.spec_augment(gen, spec, time_mask_ratio=0.05, freq_mask_param=0,
                                       n_time_masks=1, n_freq_masks=1, lengths=lengths)
        masked_t = (out == 0).all(dim=1)  # (B, T)
        for b in range(2):
            widest[b] = max(widest[b], int(masked_t[b].sum()))
    assert 0 < widest[0] <= 21  # < 0.05 · 400 frames, +1 for the span's edges
    assert widest[1] <= 3       # < 0.05 · 40 frames
    assert widest[0] > widest[1]


def test_draw_stretch_rate_covers_the_rates():
    gen = torch.Generator().manual_seed(2)
    seen = {specaugment.draw_stretch_rate(gen) for _ in range(60)}
    assert seen == {0.9, 1.0, 1.1}


def test_fused_frontend_eval_unchanged_and_train_augments():
    rng = np.random.RandomState(5)
    wav = (0.1 * rng.randn(2, 16000)).astype(np.float32)
    lengths = np.array([16000, 9000], np.int32)
    want, want_len = jfrontend.fused_frontend(jnp.asarray(wav), jnp.asarray(lengths),
                                              method="dft_conv")
    got, got_len = frontend.fused_frontend(torch.from_numpy(wav), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))

    gen = torch.Generator().manual_seed(3)
    host = torch.Generator().manual_seed(4)
    rates = set()
    for _ in range(12):
        aug, aug_len = frontend.fused_frontend(
            torch.from_numpy(wav), torch.from_numpy(lengths), generator=gen,
            stretch_generator=host, t_stretch=True, mask_times=2)
        assert aug.shape == got.shape
        assert (aug == 0).any()
        rates.add(int(aug_len[0]))
    assert rates == {101, 92}  # 101 frames at rates 1.0 and 0.9 (cropped), 92 at 1.1
    # mask_times=0 and no stretch: the eval features, generator or not
    same, _ = frontend.fused_frontend(torch.from_numpy(wav), torch.from_numpy(lengths),
                                      generator=gen, mask_times=0)
    assert torch.equal(same, got)
