"""The port's data layer (``speechlid_tpu_torch/data``, ``core/cache.py``)
against the JAX package's: tokens, manifests, sampler index lists and
feeder batches **equal**, bit for bit.

The corpus: three languages in the XF layout (``<lang>/train.txt``, audio
under ``<lang>/wav/train``) with clips of 0.3–1.6 s (one longer than the
largest bucket, so truncated; one at 8 kHz, so resampled on the host) and
counts that leave partial batches; and a common-voice TSV."""

import os
import time

import numpy as np
import pytest
from scipy.io import wavfile

import speechlid_tpu.data.audio_io as jax_audio_io
from speechlid_tpu.core.cache import cacheable as jax_cacheable
from speechlid_tpu.data import (
    BucketFeeder as JaxBucketFeeder,
    CTCTokenizer as JaxCTCTokenizer,
    MergedDataset as JaxMergedDataset,
    MultiBatchSampler as JaxMultiBatchSampler,
    RawManifest as JaxRawManifest,
)
from speechlid_tpu.data.datasets import resample_linear as jax_resample_linear
from speechlid_tpu_torch.core.cache import TimeUnit, cacheable
from speechlid_tpu_torch.data import (
    Batch,
    BucketFeeder,
    CTCTokenizer,
    MergedDataset,
    MultiBatchSampler,
    RawManifest,
    read_wav,
    write_wav,
)
from speechlid_tpu_torch.data import audio_io
from speechlid_tpu_torch.data.datasets import resample_linear

SR = 16000
LANGS = {"aa": ("abc", 7), "bb": ("defg", 5), "cc": ("hij", 9)}  # chars, utterances
BATCH_FIELDS = ("wavs", "wav_lengths", "texts", "text_lengths", "langs")


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    """Both packages' manifest caches in this test's directory."""
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(tmp_path / "cache"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data_corpus")
    rng = np.random.RandomState(0)
    for li, (lang, (chars, n)) in enumerate(sorted(LANGS.items())):
        wav_dir = root / lang / "wav" / "train"
        wav_dir.mkdir(parents=True)
        lines = []
        for i in range(n):
            seconds = [0.3, 0.45, 0.7, 0.95, 1.6][(i + li) % 5]
            sr = 8000 if (lang == "bb" and i == 2) else SR
            wav = (0.3 * np.sin(2 * np.pi * (200 + 150 * li) * np.arange(int(seconds * sr)) / sr)
                   + 0.01 * rng.randn(int(seconds * sr))).astype(np.float32)
            write_wav(str(wav_dir / f"u{i}.wav"), wav, sr)
            text = " ".join("".join(rng.choice(list(chars), rng.randint(1, 4)))
                            for _ in range(rng.randint(1, 4)))
            # capitals, an out-of-vocabulary char and a run of spaces: encoder input
            lines.append(f"u{i}.wav\t{text.upper() if i == 1 else text}{'  ?  x' if i == 3 else ''}")
        (root / lang / "train.txt").write_text("\n".join(lines) + "\n\n")
    cv = root / "cv"
    (cv / "clips").mkdir(parents=True)
    rows = ["path\tsentence\tlocale"]
    for i in range(4):
        write_wav(str(cv / "clips" / f"c{i}.wav"),
                  (0.1 * rng.randn(int((0.5 + 0.4 * i) * SR))).astype(np.float32), SR)
        rows.append(f"c{i}.wav\thello {i}\tzz")
    (cv / "train.tsv").write_text("\n".join(rows) + "\n")
    return root


def _datasets(corpus, max_duration=2.0):
    """(port dataset, JAX dataset) over the three languages."""
    out = []
    for manifest_cls, tok_cls, ds_cls in ((RawManifest, CTCTokenizer, MergedDataset),
                                          (JaxRawManifest, JaxCTCTokenizer, JaxMergedDataset)):
        manifests, toks, l2i = [], {}, {}
        for i, lang in enumerate(sorted(LANGS)):
            m = manifest_cls(str(corpus / lang / "train.txt"), max_duration=max_duration,
                             train=True, source="xf")
            manifests.append(m)
            l2i[m.lang()] = i
            toks[m.lang()] = tok_cls(m.export_vocab())
        out.append(ds_cls(manifests, toks, l2i))
    return out


# ---------------------------------------------------------------- tokenizer


def test_tokenizer_equals_jax(tmp_path):
    chars = list("abc xyz'")
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("\n".join(chars))
    rng = np.random.RandomState(1)
    for vocab in (chars, str(vocab_file)):
        tok, jtok = CTCTokenizer(vocab), JaxCTCTokenizer(vocab)
        assert tok.vocab_size == jtok.vocab_size == len(tok) == 8
        assert tok.blank_id == jtok.blank_id == 8
        assert tok.export_vocab() == jtok.export_vocab() == chars
        for s in ("Abc  XYZ", "  a?!b   c  ", "", "x'y", "qq"):
            got, want = tok.encoder(s), jtok.encoder(s)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        ids = rng.randint(0, 11, (4, 20))
        lens = np.array([20, 13, 0, 5])
        assert tok.ctc_decode(ids) == jtok.ctc_decode(ids)
        assert tok.ctc_decode(ids, lens) == jtok.ctc_decode(ids, lens)
        assert tok.ctc_decode(ids, lens, blank_id=10) == jtok.ctc_decode(ids, lens, blank_id=10)
        assert tok.decoder(ids, lens) == jtok.decoder(ids, lens)
        lp = np.log(rng.dirichlet(np.ones(9), size=12)).astype(np.float32)
        assert tok.ctc_prefix_beam_search(lp, 4) == jtok.ctc_prefix_beam_search(lp, 4)


# ---------------------------------------------------------------- manifests


def test_xf_manifest_equals_jax(corpus):
    for lang in sorted(LANGS):
        for max_duration in (2.0, 1.0, 0.0):
            path = str(corpus / lang / "train.txt")
            got = RawManifest(path, max_duration=max_duration, train=True, source="xf")
            want = JaxRawManifest(path, max_duration=max_duration, train=True, source="xf")
            assert got.items == want.items and len(got) == len(want) > 0
            assert got.lang() == want.lang() == lang
            assert got.export_vocab() == want.export_vocab()
    assert len(RawManifest(str(corpus / "aa" / "train.txt"), max_duration=1.0,
                           source="xf")) < LANGS["aa"][1]


def test_common_voice_manifest_equals_jax(corpus):
    path = str(corpus / "cv" / "train.tsv")
    got = RawManifest(path, max_duration=1.5)
    want = JaxRawManifest(path, max_duration=1.5)
    assert got.items == want.items and len(got) == 3
    assert got[0]["path"] == str(corpus / "cv" / "clips" / "c0.wav")
    assert got.lang() == "zz" and got.export_vocab() == want.export_vocab()


# ------------------------------------------------------------------ sampler


@pytest.mark.parametrize("drop_last", [False, True])
def test_sampler_index_lists_equal_jax(corpus, drop_last):
    ds, jds = _datasets(corpus)
    for seed in (0, 5):
        for num_shards in (1, 2):
            for shard_id in range(num_shards):
                kw = dict(batch_size=3, drop_last=drop_last, seed=seed, shard_id=shard_id,
                          num_shards=num_shards)
                s, js = MultiBatchSampler(ds, **kw), JaxMultiBatchSampler(jds, **kw)
                assert len(s) == len(js)
                for epoch in range(3):
                    s.set_epoch(epoch)
                    js.set_epoch(epoch)
                    got = list(s)
                    assert got == list(js) and got
                    assert all(len({ds.lang_of_global(i) for i in b}) == 1 for b in got)


# ------------------------------------------------------------------- feeder


def _assert_batches_equal(got, want):
    assert isinstance(got, Batch)
    for field in BATCH_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.paths == want.paths and got.n_valid == want.n_valid


def _feeders(corpus, **kw):
    ds, jds = _datasets(corpus)
    args = dict(buckets_s=(0.5, 1.0), max_text_len=6, arrays_only=False)
    port = BucketFeeder(ds, MultiBatchSampler(ds, batch_size=4, seed=3), **args, **kw)
    jax_feeder = JaxBucketFeeder(jds, JaxMultiBatchSampler(jds, batch_size=4, seed=3), **args)
    return port, jax_feeder


def _two_epochs_equal(port, jax_feeder):
    partial = 0
    for _ in range(2):
        pairs = list(zip(port, jax_feeder, strict=True))
        assert len(pairs) == len(port) == len(jax_feeder)
        for got, want in pairs:
            _assert_batches_equal(got, want)
            partial += 0 < got.n_valid < 4
    assert partial >= 2  # repeat-padded partial batches, with their n_valid
    return pairs


def test_feeder_batches_equal_jax_native(corpus):
    port, jax_feeder = _feeders(corpus)
    assert port.native_batch_decode and jax_feeder.native_batch_decode
    _assert_batches_equal(port.peek(), jax_feeder.peek())
    pairs = _two_epochs_equal(port, jax_feeder)
    got = pairs[0][0]
    assert got.wavs.shape[1] in (8000, 16000) and got.texts.shape[1] == 6
    # the arrays the trainer takes: the JAX layout with n_valid an int32
    arrays = got.arrays()
    assert set(arrays) == {*BATCH_FIELDS, "n_valid"} and arrays["n_valid"].dtype == np.int32


def test_feeder_port_native_equals_jax_scipy(corpus, monkeypatch):
    """The port's native batch decode against the JAX package's scipy path."""
    monkeypatch.setattr(jax_audio_io, "_load_wavio", lambda: None)
    _two_epochs_equal(*_feeders(corpus))


def test_feeder_port_scipy_equals_jax_native(corpus, monkeypatch):
    """The port's per-item path through scipy against the JAX native batch
    decode."""
    def no_native(path):
        raise OSError("native decode off")

    monkeypatch.setattr(audio_io, "_read_wav_native", no_native)
    port, jax_feeder = _feeders(corpus, native_batch_decode=False)
    assert not port.native_batch_decode
    _two_epochs_equal(port, jax_feeder)


def test_feeder_prefetch_thread_is_released_when_abandoned(corpus):
    import threading

    port, _ = _feeders(corpus)
    before = threading.active_count()
    it = iter(port)
    next(it)
    it.close()  # an abandoned iterator (early break, train_data_factor < 1)
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def test_feeder_rejects_augmentor(corpus):
    """The feeder applies its augmentor to every assembled batch, as the JAX
    feeder does: the same stub in both gives the same batches and lengths
    (the port raised here before it had an augmentor)."""
    calls = []

    def stub(wavs, lengths):
        calls.append(wavs.shape)
        return (0.5 * wavs[:, ::-1]).copy(), np.maximum(lengths - 100, 1).astype(np.int32)

    ds, jds = _datasets(corpus)
    args = dict(buckets_s=(0.5, 1.0), max_text_len=6, arrays_only=False, augmentor=stub)
    port = BucketFeeder(ds, MultiBatchSampler(ds, batch_size=4, seed=3), **args)
    jax_feeder = JaxBucketFeeder(jds, JaxMultiBatchSampler(jds, batch_size=4, seed=3), **args)
    pairs = _two_epochs_equal(port, jax_feeder)
    assert len(calls) == 2 * 2 * len(pairs)  # once a batch, in each feeder
    plain, _ = _feeders(corpus)
    list(plain)  # pairs hold the second epoch
    for (got, _), clean in zip(pairs, plain, strict=True):
        np.testing.assert_array_equal(got.wavs, 0.5 * clean.wavs[:, ::-1])
        np.testing.assert_array_equal(got.wav_lengths, np.maximum(clean.wav_lengths - 100, 1))


# -------------------------------------------------------------------- audio


def test_write_read_round_trip_and_batch_decode_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    wav = np.clip(0.5 * rng.randn(3000), -1.2, 1.2).astype(np.float32)
    write_wav(str(tmp_path / "port.wav"), wav, SR)
    jax_audio_io.write_wav(str(tmp_path / "jax.wav"), wav, SR)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    got, sr = read_wav(str(tmp_path / "port.wav"))
    want, jsr = jax_audio_io.read_wav(str(tmp_path / "port.wav"))
    assert sr == jsr == SR and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    pcm = (np.clip(wav, -1, 1) * 32767.0).astype(np.int16)
    np.testing.assert_array_equal(got, pcm.astype(np.float32) / 32768.0)
    assert audio_io.wav_duration(str(tmp_path / "port.wav")) == 3000 / SR

    # other encodings: float32, 8-bit, stereo PCM16, int64 (native cannot: scipy)
    paths = [str(tmp_path / "port.wav")]
    for name, data in (("f32", wav), ("u8", (128 + 100 * np.clip(wav, -1, 1)).astype(np.uint8)),
                       ("stereo", np.stack([pcm, pcm[::-1]], 1)),
                       ("i64", pcm.astype(np.int64)), ("long", np.tile(pcm, 3))):
        wavfile.write(str(tmp_path / f"{name}.wav"), SR, data)
        paths.append(str(tmp_path / f"{name}.wav"))
    with pytest.raises(OSError):
        audio_io._read_wav_native(str(tmp_path / "i64.wav"))
    for path in paths:
        np.testing.assert_array_equal(read_wav(path)[0], jax_audio_io.read_wav(path)[0])
    got = audio_io.read_wav_batch(paths, 4000, truncate=True)
    want = jax_audio_io.read_wav_batch(paths, 4000, truncate=True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1][-1] == 4000  # truncated to the capacity
    with pytest.raises(ValueError, match="capacity"):
        audio_io.read_wav_batch(paths, 4000)
    with pytest.raises(ValueError, match="no reader"):
        read_wav(str(tmp_path / "x.flac"))


def test_native_library_is_built_under_build_by_source_hash():
    lib = audio_io.wavio_library_path()
    assert lib.parent == audio_io.BUILD_DIR and audio_io.BUILD_DIR.name == "build"
    assert lib.name.startswith("libwavio_") and len(lib.stem) == len("libwavio_") + 16
    audio_io.wavio()
    assert lib.exists()


def test_resample_linear_equals_jax():
    rng = np.random.RandomState(3)
    wav = rng.randn(1234).astype(np.float32)
    for sr in (8000, 22050, 16000):
        np.testing.assert_array_equal(resample_linear(wav, sr, SR), jax_resample_linear(wav, sr, SR))


# -------------------------------------------------------------------- cache


def test_ttl_cache_keys_expiry_and_namespace(tmp_path, monkeypatch):
    root = tmp_path / "ttl"
    monkeypatch.setenv("SPEECHLID_CACHE_DIR", str(root))
    # other test files of a worker process set it and leave it set
    monkeypatch.delenv("SPEECHLID_CACHE_DISABLE", raising=False)
    calls = []

    def scan(manifest_path=None, split="train"):
        calls.append((manifest_path, split))
        return [manifest_path, split, len(calls)]

    cached = cacheable(cache_key=("manifest_path", "split"), project="p")(scan)
    jax_cached = jax_cacheable(cache_key=("manifest_path", "split"), project="p")(scan)
    assert cached(manifest_path="a") == ["a", "train", 1]
    assert cached(manifest_path="a") == ["a", "train", 1]  # from the pickle
    assert cached(manifest_path="a", split="val") == ["a", "val", 2]  # split is in the key
    assert cached("a") == ["a", "train", 3]  # positional: not keyed, not cached
    assert jax_cached(manifest_path="a") == ["a", "train", 4]  # its own namespace
    assert sorted(os.listdir(root)) == ["p", "speechlid_tpu_torch"]
    assert len(os.listdir(root / "speechlid_tpu_torch" / "p")) == 2

    short = cacheable(cache_key="manifest_path", project="q", duration=1,
                      time_unit=TimeUnit.SECOND)(scan)
    assert short(manifest_path="b")[-1] == 5
    assert short(manifest_path="b")[-1] == 5
    (pkl,) = (root / "speechlid_tpu_torch" / "q").iterdir()
    os.utime(pkl, (time.time() - 5, time.time() - 5))  # older than the TTL
    assert short(manifest_path="b")[-1] == 6
    monkeypatch.setenv("SPEECHLID_CACHE_DISABLE", "1")
    assert cached(manifest_path="a")[-1] == 7
