"""The standalone CTC ASR task (``tasks/asr.py``) against the JAX
``ASRTask`` on the CPU, weights carried across by ``convert.lid_state``
(one head).

- ``val_loop``: one forward; loss, log-probs and scores within 1e-4 (the
  log-probs of the own head, kept for the LM), greedy ids and frame lengths
  equal;
- ``test_loop_end``: with an ARPA model the test writes, the greedy
  metrics and ``test_cer_lm`` equal to JAX's, on each package's own
  ``val_loop`` outputs and on the same outputs (log-probs peaked on a
  transcript, with noise);
- ``lm_param_search``: the same trials in the same order (the same
  ``RandomState`` draws, the same CERs);
- the hyper-parameters equal JAX's, and rebuild the task; the JAX task
  passes ``lang2vocab`` twice and raises ``TypeError`` on its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.decode import build_native_library as jax_build_native_library
from speechlid_tpu.tasks import asr as jasr
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.tasks import asr as pasr
from tests.torch_parity import one_thread, random_batch_stats  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
VOCAB = [" ", "a", "b", "c"]  # the blank is last (4)
WORD_LM = ("\\data\\\nngram 1=5\nngram 2=2\n\n\\1-grams:\n"
           "-0.3\t<s>\t-0.1\n-0.4\t</s>\n-1.0\t<unk>\n-0.6\tab\t-0.2\n-0.9\tc\t-0.2\n"
           "\n\\2-grams:\n-0.1\tab c\n-0.2\tc ab\n\n\\end\\\n")
HPARAMS = dict(n_blocks=1, encoder_dim=32, heads=2, dim_head=16, head_dim_head=8,
               head_num_head=4, dropout=0.0, mask_times=0, schedule=None, beam_width=8,
               alpha=0.8, beta=0.3, cutoff_top_n=4, num_cpus=1)


@pytest.fixture(scope="module")
def lm_path(tmp_path_factory):
    """A word bigram ARPA over the vocabulary's words, and the JAX binding's
    library (it runs ``make`` in ``csrc/``)."""
    if jax_build_native_library() is None:
        pytest.fail("the JAX package's native decoder did not build")
    path = tmp_path_factory.mktemp("asr_lm") / "words.arpa"
    path.write_text(WORD_LM)
    return str(path)


@pytest.fixture(scope="module")
def pair(lm_path):
    torch.set_num_threads(1)
    hp = dict(HPARAMS, vocab=VOCAB, lm_path=lm_path)
    jtask = jasr.ASRTask(**hp)
    rng = np.random.RandomState(0)
    sample = {"wavs": rng.randn(2, 8000).astype(np.float32),
              "wav_lengths": np.array([8000, 6000], np.int32)}
    variables = random_batch_stats(jtask.init_variables(jax.random.PRNGKey(0), sample), 0)
    ptask = pasr.ASRTask(**hp, device="cpu")
    convert.load_into(ptask.model, convert.lid_state(variables))
    return jtask, variables, ptask


def batch(seed, b=3):
    rng = np.random.RandomState(seed)
    texts = rng.randint(0, len(VOCAB), (b, 6)).astype(np.int32)
    return {"wavs": (0.1 * rng.randn(b, 9600)).astype(np.float32),
            "wav_lengths": np.array([9600, 7001, 4000][:b], np.int32),
            "texts": texts, "text_lengths": np.array([6, 4, 3][:b], np.int32),
            "langs": np.zeros(b, np.int32), "n_valid": np.int32(2)}


def _host(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def run_both(pair, b):
    jtask, variables, ptask = pair
    want = _host(jax.jit(jtask.val_loop)(variables, {k: jnp.asarray(v) for k, v in b.items()}))
    got = _host(ptask.val_loop(ptask.place_batch(b)))
    return got, want


def test_val_loop_one_forward_matches_jax(pair):
    got, want = run_both(pair, batch(1))
    assert set(got) == set(want)
    for key in ("feat_lens", "pred_ids", "langs", "texts", "text_lengths", "n_valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("loss", "scores", "log_probs"):
        scale = max(float(np.abs(want[key]).max()), 1.0)
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL * scale, err_msg=key)
    assert got["log_probs"].shape[-1] == len(VOCAB) + 1


def peaked_outputs(seed):
    """``val_loop``-shaped outputs whose log-probs spell a transcript of the
    LM's words through noise (so the LM has something to fix)."""
    rng = np.random.RandomState(seed)
    texts = np.array([[1, 2, 0, 3, 0, 0], [3, 0, 1, 2, 0, 0], [1, 2, 0, 0, 0, 0]], np.int32)
    text_lengths = np.array([4, 4, 2], np.int32)
    t, v = 24, len(VOCAB) + 1
    logits = rng.randn(3, t, v).astype(np.float32)
    for i in range(3):
        for j in range(text_lengths[i]):
            logits[i, 2 + 4 * j, texts[i, j]] += 3.5
        logits[i, :, -1] += 1.5
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return [{"loss": 1.0, "scores": np.zeros((3, 1), np.float32),
             "pred_ids": lp.argmax(-1).astype(np.int32),
             "feat_lens": np.array([24, 20, 12], np.int32), "langs": np.zeros(3, np.int32),
             "texts": texts, "text_lengths": text_lengths, "log_probs": lp.astype(np.float32),
             "n_valid": 0}]


def test_test_loop_end_with_lm_matches_jax(pair):
    jtask, _, ptask = pair
    got, want = run_both(pair, batch(2))
    own = ptask.test_loop_end([got]), jtask.test_loop_end([want])
    same = ptask.test_loop_end(peaked_outputs(3)), jtask.test_loop_end(peaked_outputs(3))
    for p, j in (own, same):
        assert "test_cer_lm" in p and set(p) == set(j)
        assert p["val_wer"] == j["val_wer"] and p["test_cer_lm"] == j["test_cer_lm"]
        assert abs(p["avg_val_loss"] - j["avg_val_loss"]) <= TOL * max(j["avg_val_loss"], 1.0)
    assert same[0]["test_cer_lm"] < same[0]["val_wer"]  # the LM mends the noisy greedy path


def test_lm_param_search_trials_equal_jax(lm_path):
    out = peaked_outputs(4)[0]
    refs = ["ab c", "c ab", "ab"]
    args = (VOCAB, lm_path, out["log_probs"], out["feat_lens"], refs)
    got = pasr.lm_param_search(*args, n_trials=4, seed=2, num_cpus=1)
    want = jasr.lm_param_search(*args, n_trials=4, seed=2, num_cpus=1)
    assert got == want


def test_hyper_parameters_equal_jax_and_rebuild(pair, tmp_path):
    jtask, _, ptask = pair
    assert ptask.hyper_parameters == jtask.hyper_parameters
    assert ptask.hyper_parameters["vocab"] == VOCAB
    rebuilt = pasr.ASRTask(**ptask.hyper_parameters, device="cpu")
    assert rebuilt.hyper_parameters == ptask.hyper_parameters
    assert rebuilt.vocab_sizes == ptask.vocab_sizes == (len(VOCAB),)
    with pytest.raises(TypeError, match="lang2vocab"):
        jasr.ASRTask(**jtask.hyper_parameters)
