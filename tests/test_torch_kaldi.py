"""The port's kaldi fbank (``speechlid_tpu_torch/ops/frontend.py``
``kaldi_fbank``, ``wav2mel(use_kaldi=True)``, ``fused_frontend(use_kaldi=True)``,
``frame_lengths(center=False)``) and ``models/conformer.FBankLayer`` against
the JAX package's on the CPU.

Tolerances:

- on unit-scale noise (the input of the JAX package's own frontend tests)
  the kaldi log mel within 1e-4 absolute of JAX's ``dft_conv`` (natural log;
  at most 8.2e-5 seen over four seeds), the port's ``fft`` within JAX's own
  bar for its ``fft`` against its ``dft_conv``, rtol and atol 1e-3
  (``tests/test_frontend.py``);
- on a zero-padded batch of tones (``padded_batch``) the bins of low energy
  are ill-conditioned in float32 (the DFT sums cancel): there JAX's float32
  lies up to 1.5e-4 from the same sums in float64 and the port's up to
  2.6e-4, and the two up to 1.8e-4 apart.  So on that batch the port's
  float32 (and every kaldi entry point built on it) is held to the port's
  float64 within max(1e-4, 2 × JAX's own distance from it);
- frame counts exact (a row shorter than the 400-sample window has 0);
- ``FBankLayer`` in eval within 1e-3 dB of the JAX layer (``dft_conv`` on the
  CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models.conformer import FBankLayer as JaxFBankLayer
from speechlid_tpu.ops import frontend as jfrontend
from speechlid_tpu_torch.models.conformer import FBankLayer, set_generator
from speechlid_tpu_torch.ops import frontend
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

KALDI_ATOL = 1e-4
FFT_TOL = 1e-3
DB_TOL = 1e-3
SR = 16000
LENGTHS = np.array([8000, 5210, 399, 400], np.int32)  # 399: no frame at all


def padded_batch(seed=0):
    rng = np.random.RandomState(seed)
    wav = np.zeros((len(LENGTHS), LENGTHS.max()), np.float32)
    for b, n in enumerate(LENGTHS):
        t = np.arange(n) / SR
        wav[b, :n] = 0.3 * np.sin(2 * np.pi * (300 + 170 * b) * t) + 0.05 * rng.randn(n)
    return wav


def assert_near_float64(got, jax_out, wav):
    """``got`` (the port's float32 kaldi features of ``wav``, any layout of
    them) within max(1e-4, 2 × JAX's distance) of the port's float64."""
    f64 = frontend.kaldi_fbank(torch.from_numpy(wav).double()).numpy()
    if got.shape != f64.shape:
        f64 = f64.transpose(0, 2, 1)
    own = float(np.abs(np.asarray(jax_out, np.float64) - f64).max())
    err = float(np.abs(np.asarray(got, np.float64) - f64).max())
    assert err <= max(KALDI_ATOL, 2.0 * own), (err, own)


JAX_KALDI = jax.jit(lambda w: jfrontend.kaldi_fbank(w, method="dft_conv"))


@pytest.mark.parametrize("seed", range(4))
def test_kaldi_fbank_matches_jax(seed):
    wav = np.random.RandomState(seed).randn(3, 16000).astype(np.float32)
    want = np.asarray(JAX_KALDI(wav))
    for method, rtol, atol in (("dft_conv", 0, KALDI_ATOL), ("fft", FFT_TOL, FFT_TOL)):
        got = frontend.kaldi_fbank(torch.from_numpy(wav), method=method).numpy()
        assert got.shape == want.shape == (3, 98, 80)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=method)


def test_kaldi_fbank_padded_batch_and_short_waves():
    wav = padded_batch(1)
    f32 = frontend.kaldi_fbank(torch.from_numpy(wav))
    assert f32.shape == (4, 48, 80)
    assert frontend.kaldi_fbank(torch.from_numpy(wav).double()).dtype == torch.float64
    assert_near_float64(f32.numpy(), JAX_KALDI(wav), wav)
    # a batch shorter than the window has no frame, as XLA's VALID patches
    assert frontend.kaldi_fbank(torch.zeros(2, 399)).shape == (2, 0, 80)
    with pytest.raises(ValueError, match="method"):
        frontend.kaldi_fbank(torch.from_numpy(wav), method="pallas")


def test_kaldi_bases_are_the_jax_bases():
    np.testing.assert_array_equal(frontend._povey_window(400), jfrontend._povey_window(400))
    np.testing.assert_array_equal(frontend._kaldi_mel_banks(80, 512, SR),
                                  jfrontend._kaldi_mel_banks(80, 512, SR))


def test_frame_lengths_snip_edges_exact():
    lengths = np.array([0, 1, 399, 400, 401, 559, 560, 8000, 64000], np.int32)
    for center in (True, False):
        want = np.asarray(jfrontend.frame_lengths(jnp.asarray(lengths), 160, center=center,
                                                  win_length=400))
        got = frontend.frame_lengths(torch.from_numpy(lengths), 160, center=center,
                                     win_length=400).numpy()
        np.testing.assert_array_equal(got, want)


def test_wav2mel_and_fused_frontend_use_kaldi():
    wav, lengths = padded_batch(2), LENGTHS
    want = np.asarray(jax.jit(lambda w: jfrontend.wav2mel(w, use_kaldi=True, method="dft_conv"))(
        wav))
    got = frontend.wav2mel(torch.from_numpy(wav), use_kaldi=True).numpy()
    assert got.shape == want.shape == (4, 80, 48)
    assert_near_float64(got, want, wav)
    jfeats, jlen = jax.jit(lambda w, n: jfrontend.fused_frontend(
        w, n, use_kaldi=True, method="dft_conv"))(wav, lengths)
    feats, f_len = frontend.fused_frontend(torch.from_numpy(wav), torch.from_numpy(lengths),
                                           use_kaldi=True)
    np.testing.assert_array_equal(f_len.numpy(), np.asarray(jlen))
    assert f_len.numpy().tolist() == [48, 31, 0, 1]
    # normalised per utterance first, so the float64 reference is of that wave
    normed = frontend.normalize_wav(torch.from_numpy(wav), torch.from_numpy(lengths)).numpy()
    assert_near_float64(feats.numpy(), jfeats, normed)


def test_fbank_layer_eval_matches_jax():
    wav = padded_batch(3)
    wav = wav / np.abs(wav).max()
    layer = JaxFBankLayer(t_stretch=True)
    jfeats, jlen = jax.jit(lambda w, n: layer.apply({}, w, n, deterministic=True))(wav, LENGTHS)
    feats, f_len = FBankLayer(t_stretch=True).eval()(torch.from_numpy(wav),
                                                     torch.from_numpy(LENGTHS))
    np.testing.assert_array_equal(f_len.numpy(), np.asarray(jlen))
    assert feats.shape == jfeats.shape == (4, 51, 80)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=0, atol=DB_TOL)


def test_fbank_layer_training_draws_from_its_generators():
    wav, lengths = torch.from_numpy(padded_batch(4)), torch.from_numpy(LENGTHS)
    layer = FBankLayer(t_stretch=True, mask_times=2).train()
    with pytest.raises(ValueError, match="generator"):
        layer(wav, lengths)
    runs = []
    for _ in range(2):
        gen, stretch = torch.Generator().manual_seed(5), torch.Generator().manual_seed(6)
        runs.append(layer(wav, lengths, gen, stretch))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    eval_feats, eval_len = layer.eval()(wav, lengths)
    assert runs[0][0].shape == eval_feats.shape
    assert not torch.equal(runs[0][0], eval_feats)  # masked and/or stretched
    # set_generator reaches the layer, as it reaches dropout
    set_generator(layer.train(), torch.Generator().manual_seed(5))
    feats, _ = layer(wav, lengths, stretch_generator=torch.Generator().manual_seed(6))
    assert torch.equal(feats, runs[0][0])
