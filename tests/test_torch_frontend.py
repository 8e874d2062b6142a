"""The port's frontend (``speechlid_tpu_torch/ops/frontend.py`` and the
fbank kernel's plain path) against the JAX package's, on the CPU.

Tolerances: dB mel 1e-3 (atol and rtol), the JAX package's own fbank
tolerance (tests/test_pallas_fbank.py); normalized wav 1e-5 (float32
reductions in another order); frame lengths exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.ops import frontend as jfrontend
from speechlid_tpu.ops.pallas.fbank_kernel import pallas_log_mel, pallas_wav2mel
from speechlid_tpu_torch.ops import frontend
from speechlid_tpu_torch.ops.cuda import _build, fbank_kernel

DB_TOL = 1e-3
LENGTHS = np.array([16000, 12345, 8000], np.int32)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _wav(b=3, t=16000, seed=0):
    return (0.1 * np.random.RandomState(seed).randn(b, t)).astype(np.float32)


@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_normalize_wav(lengths):
    wav = _wav(seed=1)
    ref = np.asarray(jfrontend.normalize_wav(
        jnp.asarray(wav), None if lengths is None else jnp.asarray(lengths)))
    got = frontend.normalize_wav(
        torch.from_numpy(wav), None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    if lengths is not None:
        assert (got.numpy()[1, 12345:] == 0).all()


def test_bases_match():
    np.testing.assert_array_equal(frontend.mel_filterbank(257, 80, 16000),
                                  jfrontend.mel_filterbank(257, 80, 16000))
    np.testing.assert_array_equal(frontend._hann_window(400), jfrontend._hann_window(400))
    for got, ref in zip(frontend._dft_basis(512), jfrontend._dft_basis(512)):
        np.testing.assert_array_equal(got, ref)


def test_wav2mel_matches_dft_conv():
    """Ragged lengths: the top_db clamp's peak is over valid frames only."""
    wav = _wav(seed=2)
    ref = np.asarray(jfrontend.wav2mel(
        jnp.asarray(wav), lengths=jnp.asarray(LENGTHS), method="dft_conv"))
    got = frontend.wav2mel(torch.from_numpy(wav), lengths=torch.from_numpy(LENGTHS))
    assert got.shape == ref.shape == (3, 80, 101)
    np.testing.assert_allclose(got.numpy(), ref, rtol=DB_TOL, atol=DB_TOL)


@pytest.mark.parametrize("t", [16000, 8000])
def test_log_mel_matches_pallas_kernel(t):
    """The plain path of the kernel wrapper against the Pallas kernel in
    interpret mode, as tests/test_pallas_fbank.py runs it."""
    wav = _wav(b=2, t=t, seed=3)
    ref = np.asarray(pallas_log_mel(jnp.asarray(wav), interpret=True))
    launches = dict(_build.launches)
    got = fbank_kernel.log_mel(torch.from_numpy(wav))
    assert dict(_build.launches) == launches  # CPU tensor: plain version
    assert got.shape == ref.shape == (2, 80, 1 + t // 160)
    np.testing.assert_allclose(got.numpy(), ref, rtol=DB_TOL, atol=DB_TOL)


def test_wav2mel_matches_pallas_wav2mel():
    """Ragged lengths through the Pallas path's own clamp (interpret mode)."""
    wav = _wav(seed=5)
    ref = np.asarray(pallas_wav2mel(jnp.asarray(wav), lengths=jnp.asarray(LENGTHS),
                                    interpret=True))
    got = frontend.wav2mel(torch.from_numpy(wav), lengths=torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(got.numpy(), ref, rtol=DB_TOL, atol=DB_TOL)


def test_fused_frontend_eval():
    wav = _wav(seed=4)
    ref_feats, ref_len = jfrontend.fused_frontend(
        jnp.asarray(wav), jnp.asarray(LENGTHS), method="dft_conv")
    feats, f_len = frontend.fused_frontend(torch.from_numpy(wav), torch.from_numpy(LENGTHS))
    assert feats.shape == (3, 101, 80)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref_feats), rtol=DB_TOL, atol=DB_TOL)
    np.testing.assert_array_equal(f_len.numpy(), np.asarray(ref_len))


def test_frame_lengths():
    n = np.array([0, 1, 159, 160, 161, 16000, 272000], np.int32)
    ref = np.asarray(jfrontend.frame_lengths(jnp.asarray(n), 160, center=True))
    np.testing.assert_array_equal(frontend.frame_lengths(torch.from_numpy(n), 160).numpy(), ref)


def test_log_mel_rejects_bad_input():
    with pytest.raises(ValueError):
        fbank_kernel.log_mel(torch.zeros(16000))
