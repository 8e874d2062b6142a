"""The port's binding of the native CTC decoder and n-gram LM
(``speechlid_tpu_torch/decode/beam_search.py``) against the JAX package's,
over the same ``csrc/ctc_decoder/ctc_decoder.cc``.

Scores and perplexities agree within 1e-6 on ``tests/data/tiny.arpa`` and
its KenLM binaries; beam search, with and without an LM, gives the same
strings.  The port builds its library into ``build/`` and writes nothing
under ``csrc/``."""

import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from speechlid_tpu.decode import BeamSearchDecoderWithLM as JaxDecoder
from speechlid_tpu.decode import NgramLM as JaxNgramLM
from speechlid_tpu.decode import build_native_library as jax_build_native_library
from speechlid_tpu_torch.core import native
from speechlid_tpu_torch.decode import BeamSearchDecoderWithLM, NgramLM, build_native_library
from speechlid_tpu_torch.decode import beam_search

DATA = Path(__file__).resolve().parent / "data"
MODELS = ["tiny.arpa", "tiny_probing.klm", "tiny_trie.klm", "tiny_qtrie.klm",
          "tiny_atrie.klm", "tiny_qatrie.klm"]
SENTENCES = ["the cat sat", "the dog ran", "cat the", "zebra", "the the the",
             "sat ran cat dog", "dog", "", "the cat sat the dog ran"]
VOCAB = [" ", "a", "b", "c"]  # the blank is last (4)
WORD_LM = ("\\data\\\nngram 1=5\nngram 2=2\n\n\\1-grams:\n"
           "-0.3\t<s>\t-0.1\n-0.4\t</s>\n-1.0\t<unk>\n-0.6\tab\t-0.2\n-0.9\tc\t-0.2\n"
           "\n\\2-grams:\n-0.1\tab c\n-0.2\tc ab\n\n\\end\\\n")


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX binding's library (it runs ``make`` in ``csrc/``)."""
    if jax_build_native_library() is None:
        pytest.fail("the JAX package's native decoder did not build")


def _csrc_sources():
    """The sources under ``csrc/`` and their mtimes.  The ``.so`` files that
    the JAX binding's ``make`` writes there are left out: another test
    process may be running that ``make`` at the same time."""
    root = native.ROOT / "csrc"
    return {str(p.relative_to(root)): p.stat().st_mtime_ns for p in sorted(root.rglob("*"))
            if p.suffix != ".so"}


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("model", MODELS)
def test_ngram_scores_equal_jax(model):
    lm, ref = NgramLM(str(DATA / model)), JaxNgramLM(str(DATA / model))
    assert lm.order == ref.order == 3
    for s in SENTENCES:
        assert abs(lm.score(s) - ref.score(s)) <= 1e-6, s
        assert abs(lm.perplexity(s) - ref.perplexity(s)) <= 1e-6 * max(1.0, ref.perplexity(s)), s


def test_missing_lm_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="failed to load LM"):
        NgramLM(str(tmp_path / "absent.arpa"))


def _probs(seed, b, t):
    logits = np.random.RandomState(seed).randn(b, t, len(VOCAB) + 1).astype(np.float32) * 2
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.usefixtures("jax_lib")
@pytest.mark.parametrize("lm", [None, "word", "tiny_probing.klm"])
def test_beam_search_equals_jax(lm, tmp_path):
    if lm == "word":
        (tmp_path / "word.arpa").write_text(WORD_LM)
        lm_path = str(tmp_path / "word.arpa")
    else:
        lm_path = None if lm is None else str(DATA / lm)
    kwargs = dict(beam_width=16, alpha=0.8, beta=0.4, lm_path=lm_path, num_cpus=2)
    dec, ref = BeamSearchDecoderWithLM(VOCAB, **kwargs), JaxDecoder(VOCAB, **kwargs)
    for seed in range(3):
        probs = _probs(seed, 4, 24)
        lengths = np.array([24, 20, 9, 1], np.int32)
        got = dec(probs, lengths)
        assert got == ref.forward(probs, lengths) and len(got) == 4
    with pytest.raises(ValueError, match="lengths"):
        dec(probs, lengths[:2])


def test_library_lands_in_build_and_csrc_is_untouched(jax_lib, tmp_path, monkeypatch):
    """A fresh build (into a build directory of this test) compiles the
    decoder's source once, writes its library there, named by the source's
    hash, and nothing under csrc/."""
    before = _csrc_sources()
    build_dir = tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    commands, real_run = [], subprocess.run

    def run(argv, **kwargs):
        commands.append(list(argv))
        return real_run(argv, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", run)
    path = build_native_library()
    assert path.parent == build_dir and path.exists()
    assert path.name.startswith("libctc_decoder_") and len(path.stem) == len("libctc_decoder_") + 16
    assert build_native_library() == path  # built once, then loaded as it is
    (argv,) = commands
    assert argv[-1] == str(beam_search.SOURCE)
    assert build_dir in Path(argv[argv.index("-o") + 1]).parents
    assert _csrc_sources() == before
    assert not list((native.ROOT / "csrc").rglob("libctc_decoder_*"))
    assert native.library_path(beam_search.SOURCE, "libctc_decoder").name == path.name


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="build failed"):
        native.build_library(broken, "libbroken")
    monkeypatch.setattr(native, "CXX", os.path.join(str(tmp_path), "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        build_native_library()


def test_library_links_the_system_libstdcxx(tmp_path, monkeypatch):
    """``g++`` from PATH, not ``$CXX``: the library needs the process's
    shared libstdc++, not a static copy of another one."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", os.path.join(str(tmp_path), "no-such-compiler"))
    path = build_native_library()
    needed = subprocess.run(["ldd", str(path)], capture_output=True, text=True).stdout
    assert "libstdc++.so" in needed
