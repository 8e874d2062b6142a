"""The port's waveform ops and train-time augmentor
(``speechlid_tpu_torch/ops/{augment,resample}.py``, ``ops/frontend.preemphasis``,
``data/augmentor.py``) against the JAX package's, on the CPU.

Deterministic ops agree with JAX within 1e-5 (atol and rtol: float32 sums
in another order).  The random ones (``awgn``, ``dither``,
``synthetic_rir``) draw from a ``torch.Generator`` where JAX takes a key,
so they are held to their distributions: the achieved SNR within 0.1 dB
over 4 s, the U[0, 1e-5) range, the RIR's unit norm and its -60 dB decay at
rt60.  The augmentor draws its variants from ``random.Random(seed)`` in
JAX's order: the same seed picks the same variants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.data.augmentor import WavAugmentor as JaxWavAugmentor
from speechlid_tpu.ops import augment as jaugment
from speechlid_tpu.ops import resample as jresample
from speechlid_tpu.ops.frontend import preemphasis as jpreemphasis
from speechlid_tpu_torch.data.augmentor import WavAugmentor
from speechlid_tpu_torch.ops import augment, resample
from speechlid_tpu_torch.ops.frontend import preemphasis
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SR = 16000
TOL = 1e-5
LENGTHS = np.array([16000, 11111, 1], np.int32)


def _wav(b=3, t=16000, seed=0):
    return (0.3 * np.random.RandomState(seed).randn(b, t)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_preemphasis_equals_jax():
    wav = _wav()
    _close(preemphasis(torch.from_numpy(wav)), jpreemphasis(jnp.asarray(wav)))
    _close(preemphasis(torch.from_numpy(wav), 0.5), jpreemphasis(jnp.asarray(wav), 0.5))


@pytest.mark.parametrize("orig,new", [(10, 9), (10, 11), (1000, 1047), (22050, 16000),
                                      (16000, 16000)])
def test_resample_equals_jax(orig, new):
    wav = _wav(t=8000)
    got = resample.resample(torch.from_numpy(wav), orig, new)
    assert got.shape[-1] == -(-wav.shape[-1] * new // orig)
    _close(got, jresample.resample(jnp.asarray(wav), orig, new))


@pytest.mark.parametrize("speed", [0.9, 1.0, 1.1])
@pytest.mark.parametrize("output_len", [8000, 9500])
def test_speed_perturb_equals_jax(speed, output_len):
    wav = _wav(t=8000)
    _close(resample.speed_perturb(torch.from_numpy(wav), SR, speed, output_len),
           jresample.speed_perturb(jnp.asarray(wav), SR, speed, output_len))


@pytest.mark.parametrize("cents", [-80, -20, 20, 80])
def test_pitch_shift_equals_jax(cents):
    wav = _wav()
    _close(augment.pitch_shift(torch.from_numpy(wav), SR, float(cents)),
           jaugment.pitch_shift(jnp.asarray(wav), SR, float(cents)))
    # inside a jitted graph, as the JAX augmentor runs it
    _close(augment.pitch_shift(torch.from_numpy(wav), SR, float(cents)),
           jax.jit(lambda x: jaugment.pitch_shift(x, SR, float(cents)))(jnp.asarray(wav)))


def test_fir_reverb_equals_jax():
    wav = _wav(t=8000)
    rir = np.random.RandomState(5).randn(2048).astype(np.float32)
    rir *= np.exp(-np.arange(2048) / 300.0).astype(np.float32)
    rir /= np.linalg.norm(rir)
    _close(augment.fir_reverb(torch.from_numpy(wav), torch.from_numpy(rir)),
           jaugment.fir_reverb(jnp.asarray(wav), jnp.asarray(rir)))
    impulse = torch.zeros(256)
    impulse[0] = 1.0
    torch.testing.assert_close(augment.fir_reverb(torch.from_numpy(wav), impulse),
                               torch.from_numpy(wav), rtol=0, atol=0)


@pytest.mark.parametrize("lengths", [None, LENGTHS], ids=["full", "ragged"])
def test_mix_at_snr_and_signal_power_equal_jax(lengths):
    wav = _wav(seed=1)
    noise = 3.0 * _wav(seed=2)
    tl = None if lengths is None else torch.from_numpy(lengths)
    jl = None if lengths is None else jnp.asarray(lengths)
    _close(augment._signal_power(torch.from_numpy(wav), tl),
           jaugment._signal_power(jnp.asarray(wav), jl))
    for snr in (0.0, 5.0, 15.0):
        got = augment.mix_at_snr(torch.from_numpy(wav), torch.from_numpy(noise), snr, tl)
        _close(got, jaugment.mix_at_snr(jax.random.PRNGKey(0), jnp.asarray(wav),
                                        jnp.asarray(noise), snr, jl))
        n = wav.shape[1] if lengths is None else int(lengths[0])
        added = got.numpy()[0, :n] - wav[0, :n]
        achieved = 10 * np.log10((wav[0, :n] ** 2).mean() / (added ** 2).mean())
        assert abs(achieved - snr) < 1e-3


def test_awgn_hits_the_snr():
    """4 s of noise over the valid prefix: the achieved SNR within 0.1 dB."""
    t = np.arange(4 * SR) / SR
    wav = torch.from_numpy(np.stack([0.5 * np.sin(2 * np.pi * 220 * t),
                                     0.1 * np.sin(2 * np.pi * 330 * t)]).astype(np.float32))
    lengths = torch.tensor([4 * SR, 3 * SR])
    gen = torch.Generator().manual_seed(0)
    for snr in (0.0, 10.0, 20.0):
        added = (augment.awgn(gen, wav, snr, lengths) - wav).numpy()
        for i, n in enumerate(lengths.tolist()):
            ps = (wav[i, :n].numpy() ** 2).mean()
            achieved = 10 * np.log10(ps / (added[i, :n] ** 2).mean())
            assert abs(achieved - snr) < 0.1, (snr, i, achieved)


def test_dither_is_uniform_below_its_amount():
    wav = torch.zeros(2, 4 * SR)
    added = augment.dither(torch.Generator().manual_seed(0), wav).numpy()
    assert (added >= 0).all() and (added < 1e-5).all()
    assert abs(added.mean() - 5e-6) < 5e-8 and abs(added.std() - 1e-5 / 12 ** 0.5) < 5e-8


def test_synthetic_rir_decays_60db_at_rt60():
    rt60, length = 0.3, 6000
    h = augment.synthetic_rir(torch.Generator().manual_seed(0), SR, rt60, length).numpy()
    assert h.shape == (length,) and abs(np.linalg.norm(h) - 1.0) < 1e-5
    at = int(rt60 * SR)
    head, tail = slice(0, 400), slice(at - 200, at + 200)
    t = np.arange(length) / SR
    envelope2 = np.exp(-2 * 6.908 * t / rt60)
    assert abs(10 * np.log10(envelope2[at]) + 60.0) < 0.01
    measured = 10 * np.log10((h[tail] ** 2).mean() / (h[head] ** 2).mean())
    expected = 10 * np.log10(envelope2[tail].mean() / envelope2[head].mean())
    assert abs(measured - expected) < 1.5, (measured, expected)
    # the default is what the augmentor convolves with
    assert augment.synthetic_rir(torch.Generator().manual_seed(0)).shape == (2048,)


# ----------------------------------------------------------------- augmentor


@pytest.mark.parametrize("seed", range(4))
def test_augmentor_draws_jax_variants(seed, monkeypatch):
    """The same seed picks the same (speed, cents, reverb) as the JAX
    augmentor, call for call."""
    wavs, lengths = _wav(b=2, t=800), np.array([800, 500], np.int32)
    got, want = [], []
    port = WavAugmentor(speed=True, pitch=True, reverb=True, seed=seed)
    monkeypatch.setattr(port, "apply", lambda x, speed, cents, reverb:
                        got.append((speed, cents, reverb)) or x)
    ref = JaxWavAugmentor(speed=True, pitch=True, reverb=True, seed=seed)
    monkeypatch.setattr(ref, "_graph", lambda t, speed, cents, reverb:
                        want.append((speed, cents, reverb)) or (lambda key, x: x))
    for _ in range(20):
        assert port(wavs, lengths)[1].tolist() == ref(wavs, lengths)[1].tolist()
    assert got == want
    assert len({v[0] for v in got}) == 3 and any(v[2] for v in got) and not all(v[2] for v in got)


def test_augmentor_equals_jax_without_dither_and_reverb():
    wavs = _wav(b=2, t=4000, seed=3)
    lengths = np.array([4000, 2600], np.int32)
    kwargs = dict(speed=True, pitch=True, use_dither=False, seed=1)
    port, ref = WavAugmentor(**kwargs), JaxWavAugmentor(**kwargs)
    for _ in range(6):
        got, got_len = port(wavs, lengths)
        want, want_len = ref(wavs, lengths)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got_len, want_len)
        assert got.shape == wavs.shape and got_len.dtype == want_len.dtype


def test_augmentor_is_seeded():
    wavs, lengths = _wav(b=2, t=4000), np.array([4000, 3000], np.int32)
    a = WavAugmentor(speed=True, pitch=True, reverb=True, reverb_prob=1.0, seed=7)
    b = WavAugmentor(speed=True, pitch=True, reverb=True, reverb_prob=1.0, seed=7)
    for _ in range(3):
        (x, xl), (y, yl) = a(wavs, lengths), b(wavs, lengths)
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(xl, yl)
        assert np.isfinite(x).all() and not np.allclose(x, wavs, atol=1e-3)


@pytest.mark.parametrize("key", ["speed_shift", "pitch_shift", "p_noise"])
def test_augmentor_unknown_key_raises_type_error(key):
    with pytest.raises(TypeError, match=key):
        WavAugmentor(**{key: True})
    with pytest.raises(TypeError, match=key):
        JaxWavAugmentor(**{key: True})
