"""The index arithmetic and the tiling that the fbank CUDA kernel shares
with its wrapper (``speechlid_tpu_torch/ops/cuda/fbank_kernel.py``), on the
CPU: the reflected sample index, the basis re-laid per bin tile, where each
bin's power lies, and the emulation of the kernel's tiling and summation
order (``log_mel_tiled_plain``) against the plain version and the JAX
package.  The kernel itself is held against both on the card by
``chip_smoke.py``.

Tolerances: the emulation against the plain version 2e-4 dB (the same
float32 products summed in another order); against the JAX package's
``dft_conv`` mel before the clamp 1e-3 (atol and rtol), the JAX package's
own fbank tolerance (tests/test_pallas_fbank.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speechlid_tpu.ops import frontend as jfrontend
from speechlid_tpu_torch.ops import frontend
from speechlid_tpu_torch.ops.cuda import fbank_kernel as fk
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

PLAIN_TOL = 2e-4
JAX_TOL = 1e-3
# a served 3 s clip; one sample more than the reflect padding; not a multiple of hop
SHAPES = [(1, 48000), (3, 48000), (1, 257), (3, 257), (1, 12345), (3, 12345)]


def _wav(b, t, seed=0):
    return (0.1 * np.random.RandomState(seed).randn(b, t)).astype(np.float32)


@pytest.mark.parametrize("b,t", SHAPES)
def test_tiled_emulation_matches_plain(b, t):
    wav = torch.from_numpy(_wav(b, t))
    got = fk.log_mel_tiled_plain(wav)
    ref = fk.log_mel_plain(wav)
    assert got.shape == ref.shape == (b, 80, 1 + t // 160)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=PLAIN_TOL)


@pytest.mark.parametrize("b,t", SHAPES)
def test_tiled_emulation_matches_jax_dft_conv(b, t):
    wav = _wav(b, t, seed=1)
    ref = jfrontend.amplitude_to_db(
        jfrontend.mel_spectrogram(jnp.asarray(wav), method="dft_conv"), top_db=None)
    got = fk.log_mel_tiled_plain(torch.from_numpy(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("n_fft,win,hop", [(512, 400, 160), (256, 256, 64), (400, 200, 80)])
def test_tiled_emulation_other_sizes(n_fft, win, hop):
    """Bin tiles that are not full (n_fft/2 not a multiple of the tile) and
    a window as long as n_fft."""
    wav = torch.from_numpy(_wav(2, 4000, seed=2))
    kw = dict(n_fft=n_fft, win_length=win, hop_length=hop, n_mels=40)
    np.testing.assert_allclose(fk.log_mel_tiled_plain(wav, **kw).numpy(),
                               fk.log_mel_plain(wav, **kw).numpy(), rtol=0, atol=PLAIN_TOL)


@pytest.mark.parametrize("t,pad", [(9, 8), (5, 3), (300, 256)])
def test_reflect_index_matches_reflect_pad(t, pad):
    """Every position of the padded wav, for a wav just longer than the pad."""
    wav = torch.arange(t, dtype=torch.float32)
    padded = F.pad(wav[None, None], (pad, pad), mode="reflect")[0, 0].numpy()
    idx = fk.reflect_index(np.arange(-pad, t + pad), t)
    assert idx.min() >= 0 and idx.max() < t
    np.testing.assert_array_equal(wav.numpy()[idx], padded)
    assert int(fk.reflect_index(-2, t)) == 2 and int(fk.reflect_index(t, t)) == t - 2


@pytest.mark.parametrize("n_fft,win", [(512, 400), (256, 256), (400, 200)])
def test_tiled_basis_untiles_to_windowed_basis(n_fft, win):
    """Un-tiling the re-laid basis gives ``windowed_dft_basis`` exactly on
    the window's span; the two columns it drops (the sines of DC and
    Nyquist) and the rows outside the window are zero up to rounding."""
    bins = n_fft // 2 + 1
    pad_left = (n_fft - win) // 2
    full = frontend.windowed_dft_basis(n_fft, win)
    tiled = fk.tiled_basis(n_fft, win)
    assert tiled.shape == (fk.n_bin_tiles(n_fft), -(-win // 4) * 4, 2 * fk.TILE_BINS)
    assert tiled.dtype == np.float32
    span = full[pad_left:pad_left + win]
    untiled = np.zeros_like(span)
    used = np.zeros(tiled.shape, bool)
    for k in range(bins):
        tile, slot = fk.bin_location(k, n_fft)
        if k == n_fft // 2:  # Nyquist: the real part in packed bin 0's imaginary column
            untiled[:, k] = tiled[0, :win, 1]
            used[0, :, 1] = True
            continue
        untiled[:, k] = tiled[tile, :win, 2 * slot]
        used[tile, :, 2 * slot] = True
        if k > 0:
            untiled[:, bins + k] = tiled[tile, :win, 2 * slot + 1]
            used[tile, :, 2 * slot + 1] = True
    kept = np.ones(2 * bins, bool)
    kept[[bins, 2 * bins - 1]] = False
    np.testing.assert_array_equal(untiled[:, kept], span[:, kept])
    assert np.abs(span[:, ~kept]).max() < 1e-12
    assert not np.delete(full, np.s_[pad_left:pad_left + win], axis=0).any()
    assert not tiled[~used].any()  # padding columns and rows hold zeros
    assert not tiled[:, win:].any()


@pytest.mark.parametrize("n_fft,n_mels", [(512, 80), (256, 40), (400, 40)])
def test_mel_ranges_cover_every_nonzero_bin_once(n_fft, n_mels):
    bins = n_fft // 2 + 1
    fb = frontend.mel_filterbank(bins, n_mels, 16000)
    ranges = fk.mel_ranges(n_fft, n_mels, 16000)
    assert ranges.shape == (n_mels, 2) and ranges.dtype == np.int32
    places = [fk.bin_location(k, n_fft) for k in range(bins)]
    assert len(set(places)) == bins  # no two bins share a slot
    assert all(0 <= tile < fk.n_bin_tiles(n_fft) and 0 <= slot <= fk.TILE_BINS
               for tile, slot in places)
    for m, (first, last) in enumerate(ranges):
        nonzero = np.flatnonzero(fb[:, m])
        covered = np.arange(first, last)
        assert set(nonzero) <= set(covered)
        assert len(covered) == len(set(covered))
        if len(nonzero):
            assert first == nonzero[0] and last == nonzero[-1] + 1
    # the sparse sums are the dense product: what lies outside a range is zero
    power = np.random.RandomState(3).rand(bins).astype(np.float32)
    sparse = np.array([sum(power[k] * fb[k, m] for k in range(first, last))
                       for m, (first, last) in enumerate(ranges)], np.float32)
    np.testing.assert_allclose(sparse, power @ fb, rtol=1e-5, atol=1e-6)


def test_kernel_limits_rejected_on_any_device():
    """What the kernel cannot take is refused before any device work."""
    with pytest.raises(ValueError):
        fk.log_mel(torch.zeros(2, 3, 4))
    assert fk.n_bin_tiles(512) == fk.MAX_TILES and fk.n_bin_tiles(514) > fk.MAX_TILES
