"""The port's LM text data (``speechlid_tpu_torch/data/text.py``) and
``cli/prepare_text.py`` against the JAX package's, exactly: the filtered
sentences, the vocabulary, the tokenizer, the dataset's masking draws and
its padded batches (the same ``random.Random`` streams), and the files
``prepare_text`` writes."""

import numpy as np
import pytest

from speechlid_tpu.cli import prepare_text as jax_prepare_text
from speechlid_tpu.data import text as jtext
from speechlid_tpu_torch.cli import prepare_text
from speechlid_tpu_torch.data import text

WORDS = ("the cat sat on a mat while dogs ran over hills and rivers under grey skies "
         "of autumn near old towns").split()


def write_corpus(path, n=40, seed=0):
    """A wikitext-style file: headers, blank lines, short lines and sentences."""
    rng = np.random.RandomState(seed)
    lines = [" = Heading = ", ""]
    for i in range(n):
        k = rng.randint(2, 12)
        lines.append(" ".join(rng.choice(WORDS, k)))
        if i % 9 == 0:
            lines += ["", " = = Sub = = "]
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.fixture
def corpus(tmp_path):
    return write_corpus(tmp_path / "wiki.train.raw")


def test_filter_vocab_and_tokenizer_are_the_jax_ones(corpus):
    assert text.read_and_filter(str(corpus)) == jtext.read_and_filter(str(corpus))
    for kw in ({}, {"min_count": 3}, {"max_size": 7}):
        assert text.build_vocab(str(corpus), **kw) == jtext.build_vocab(str(corpus), **kw)
    vocab = text.build_vocab(str(corpus), max_size=10)
    tok, jtok = text.WordTokenizer(vocab), jtext.WordTokenizer(vocab)
    assert tok.vocab == jtok.vocab and len(tok) == len(jtok)
    s = "the cat saw an unknown dog"
    np.testing.assert_array_equal(tok.encoder(s), jtok.encoder(s))
    np.testing.assert_array_equal(tok.encoder(s, add_markers=False),
                                  jtok.encoder(s, add_markers=False))
    assert tok.decoder(tok.encoder(s)) == jtok.decoder(jtok.encoder(s))


@pytest.mark.parametrize("mask", [False, True])
def test_text_dataset_batches_are_the_jax_batches(corpus, mask):
    vocab = text.build_vocab(str(corpus))
    kw = dict(max_len=9, mask=mask, mask_prob=0.3, seed=4)
    ds = text.TextDataset(str(corpus), text.WordTokenizer(vocab), **kw)
    jds = jtext.TextDataset(str(corpus), jtext.WordTokenizer(vocab), **kw)
    assert len(ds) == len(jds)
    for shuffle in (True, False):
        got = list(ds.batches(6, shuffle=shuffle, seed=2))
        want = list(jds.batches(6, shuffle=shuffle, seed=2))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["ids", "lengths"]
            for key in g:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])


def test_prepare_text_writes_the_jax_files(tmp_path):
    root = tmp_path / "raw"
    root.mkdir()
    write_corpus(root / "wiki.train.raw", 30, 1)
    write_corpus(root / "valid.txt", 8, 2)  # the second spelling; no test split
    out, jout = tmp_path / "port", tmp_path / "jax"
    for main, dst in ((prepare_text.main, out), (jax_prepare_text.main, jout)):
        main(["--root", str(root), "--out", str(dst), "--max-size", "12", "--min-words", "3"])
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(p.name for p in jout.iterdir()) == ["train.txt", "valid.txt",
                                                               "vocab.txt"]
    for name in names:
        assert (out / name).read_text() == (jout / name).read_text(), name
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="train"):
        prepare_text.main(["--root", str(tmp_path / "empty"), "--out", str(tmp_path / "x")])


def test_prepare_text_vocab_ignores_min_words_in_both_packages(tmp_path):
    """A fault of the JAX CLI, copied: ``--min-words`` filters the written
    splits, but ``vocab.txt`` is built from the raw train file with
    ``build_vocab``'s own ``min_words`` of 4, so a word seen only in a
    3-word line is in ``train.txt`` and not in ``vocab.txt``."""
    root = tmp_path / "raw"
    root.mkdir()
    (root / "wiki.train.raw").write_text("alpha beta gamma delta\nonly three words\n")
    for main, dst in ((prepare_text.main, tmp_path / "port"),
                      (jax_prepare_text.main, tmp_path / "jax")):
        main(["--root", str(root), "--out", str(dst), "--min-words", "3"])
        assert "only three words" in (dst / "train.txt").read_text()
        assert "three" not in (dst / "vocab.txt").read_text().split("\n")
