"""The port's preparation CLIs against the JAX package's, exactly:
``cli/prepare_manifest.py`` (manifests, the dev split of the same
``random.Random(seed)`` shuffle, and ``vocab.txt``, from LibriSpeech-style
``*.trans.txt``, a ``transcripts.tsv`` and per-utterance sidecar ``.txt``
transcripts), and ``cli/prepare_spectrum.py`` (``convert``'s packed
``.npy`` and dates sidecar, ``denoise``, and ``plot``'s PNGs)."""

import json

import numpy as np
import pytest

from speechlid_tpu.cli import prepare_manifest as jax_prepare_manifest
from speechlid_tpu.cli import prepare_spectrum as jax_prepare_spectrum
from speechlid_tpu_torch.cli import prepare_manifest, prepare_spectrum


def write_tree(root, seed=0):
    """<root>/<lang>/...: LibriSpeech-style speaker/chapter dirs with a
    ``.trans.txt`` (aa), a ``transcripts.tsv`` (bb), sidecar ``.txt`` files
    and a wave without a transcript (cc).  The waves are empty files: the
    manifest builder reads names only."""
    rng = np.random.RandomState(seed)
    words = ["alpha", "beta", "gamma", "delta", "Eps"]
    for lang in ("aa", "bb", "cc"):
        lines = []
        for spk in range(2):
            chap = root / lang / str(spk) / "7"
            chap.mkdir(parents=True)
            for u in range(4):
                utt = f"{spk}-7-{u:04d}"
                (chap / f"{utt}.wav").write_bytes(b"")
                sentence = " ".join(rng.choice(words, 3))
                if lang == "cc" and u == 3:
                    continue  # no transcript: skipped
                if lang == "cc":
                    (chap / f"{utt}.txt").write_text(sentence)
                else:
                    lines.append((utt, sentence))
            if lang == "aa":
                (chap / f"{spk}-7.trans.txt").write_text(
                    "\n".join(f"{u} {t}" for u, t in lines[-4:]))
        if lang == "bb":
            (root / lang / "transcripts.tsv").write_text(
                "\n".join(f"{u}.wav\t{t}" for u, t in lines))
    (root / "README").write_text("not a language")


@pytest.mark.parametrize("dev_ratio", [0.1, 0.25, 0.0])
def test_prepare_manifest_writes_the_jax_files(tmp_path, dev_ratio):
    root = tmp_path / "corpus"
    write_tree(root)
    out, jout = tmp_path / "port", tmp_path / "jax"
    for main, dst in ((prepare_manifest.main, out), (jax_prepare_manifest.main, jout)):
        main(["--root", str(root), "--out", str(dst), "--dev-ratio", str(dev_ratio),
              "--seed", "3"])
    for lang in ("aa", "bb", "cc"):
        for name in ("train.txt", "dev.txt", "vocab.txt"):
            got, want = (out / lang / name).read_text(), (jout / lang / name).read_text()
            assert got == want, (lang, name)
    assert len((out / "aa" / "train.txt").read_text().splitlines()) \
        + len((out / "aa" / "dev.txt").read_text().splitlines()) == 8
    assert len((out / "cc" / "train.txt").read_text().splitlines()) \
        + len((out / "cc" / "dev.txt").read_text().splitlines()) == 6


def write_jsonl(path, rows, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(rows):
            f.write(json.dumps({"data": rng.randint(-120, 0, 16).tolist(),
                                "date": f"2024-01-{i + 1:02d}"}) + "\n")
        f.write("\n")


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_prepare_spectrum_convert_and_denoise(tmp_path, dtype):
    src = tmp_path / "spec.jsonl"
    write_jsonl(src, 12)
    got = prepare_spectrum.convert(str(src), str(tmp_path / "port"), dtype)
    want = jax_prepare_spectrum.convert(str(src), str(tmp_path / "jax"), dtype)
    assert got.dtype == want.dtype and got.shape == (12, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"))
    assert (tmp_path / "port.dates.json").read_text() == (tmp_path / "jax.dates.json").read_text()
    seg = got.astype(np.float32)
    for threshold in (-10.0, 0.0, 30.0):
        np.testing.assert_array_equal(prepare_spectrum.denoise(seg, threshold),
                                      jax_prepare_spectrum.denoise(seg, threshold))
    ragged = tmp_path / "ragged.jsonl"
    ragged.write_text('{"data": [1, 2]}\n{"data": [1, 2, 3]}\n')
    with pytest.raises(SystemExit, match="ragged"):
        prepare_spectrum.main(["convert", str(ragged), str(tmp_path / "r.npy")])


def test_prepare_spectrum_plot_writes_segment_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    src = tmp_path / "spec.jsonl"
    write_jsonl(src, 25)
    prepare_spectrum.main(["convert", str(src), str(tmp_path / "spec.npy")])
    written = prepare_spectrum.plot(str(tmp_path / "spec.npy"), str(tmp_path / "img"),
                                    interval=10, start=2, limit=5)
    assert [p.rsplit("/", 1)[1] for p in written] == ["11.png", "21.png"]
