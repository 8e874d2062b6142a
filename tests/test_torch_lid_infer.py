"""The port's slice as a whole: ``LidASRTask.infer_fn`` (Conformer
featurizer) against the JAX package's on the same wavs, lengths and
converted weights, on the CPU.

Tolerances: logits, scores and mlp_scores 1e-4 (float32 through a 2-block
encoder and one head block: summation order differs between XLA and
PyTorch); masked vocab slots and ``pred_lang`` exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu_torch import convert
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.torch_parity import lid_pair

TOL = 1e-4
HPARAMS = dict(
    lang2vocab={"aa": 5, "bb": 9, "cc": 7},
    lang2index={"aa": 0, "bb": 1, "cc": 2},
    n_blocks=2, encoder_dim=32, heads=2, dim_head=16, sub_sampling=4,
    head_dim_head=8, head_num_head=4,
)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    """(jax task, numpy variables, port task, jitted JAX infer) sharing
    converted weights; built once for the module."""
    torch.set_num_threads(1)
    jtask, variables, ptask = lid_pair(HPARAMS)
    return jtask, variables, ptask, jax.jit(jtask.infer_fn())


def run_both(pair, variables, wavs, lengths):
    _, _, ptask, jinfer = pair
    jout = jinfer(variables, jnp.asarray(wavs), jnp.asarray(lengths))
    pout = ptask.infer_fn()(torch.from_numpy(wavs), torch.from_numpy(lengths))
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in pout.items()})


def assert_infer_close(j, p):
    assert set(j) == set(p)
    np.testing.assert_array_equal(p["feat_lengths"], j["feat_lengths"])
    neg = np.finfo(np.float32).min
    np.testing.assert_array_equal(p["logits"] == neg, j["logits"] == neg)
    np.testing.assert_allclose(p["logits"], j["logits"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p["scores"], j["scores"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(p["mlp_scores"], j["mlp_scores"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(p["pred_lang"], j["pred_lang"])


def _wavs(seed, lengths, t):
    rng = np.random.RandomState(seed)
    wavs = (0.1 * rng.randn(len(lengths), t)).astype(np.float32)
    return wavs, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("lengths,t", [
    ((16000, 12345), 16000),        # ragged, padded tail masked
    ((32000, 8000, 20000), 32000),  # 2 s bucket, one short utterance
])
def test_infer_matches_jax(pair, lengths, t):
    wavs, lens = _wavs(2, lengths, t)
    j, p = run_both(pair, pair[1], wavs, lens)
    assert_infer_close(j, p)
    assert np.isfinite(p["scores"]).all() and np.isfinite(p["mlp_scores"]).all()


def test_all_blank_head_hits_floor(pair):
    """A head whose blank logit dominates decodes every frame as blank:
    both packages floor its score at -2.0."""
    variables = jax.tree_util.tree_map(np.array, pair[1])
    bias = variables["params"]["heads"]["heads"]["Dense_0"]["bias"]
    vmax = max(HPARAMS["lang2vocab"].values())
    bias[1, vmax] = 1e3  # language index 1: blank always wins
    ptask = LidASRTask(**HPARAMS, device="cpu")
    convert.load_into(ptask.model, convert.lid_state(variables))
    wavs, lens = _wavs(4, (16000, 11000), 16000)
    j, p = run_both(pair[:2] + (ptask, pair[3]), variables, wavs, lens)
    assert_infer_close(j, p)
    np.testing.assert_array_equal(p["scores"][:, 1], [-2.0, -2.0])
    np.testing.assert_array_equal(j["scores"][:, 1], [-2.0, -2.0])


@pytest.mark.parametrize("corrected", [False, True])
def test_confidence_scores_both_variants(corrected):
    """lang_confidence_scores on the same logits: the plain and the
    vocab-size-corrected score, with one all-blank head (the zero-evidence
    floor: -2.0, or conf 0 for the corrected variant) and ragged lengths."""
    from speechlid_tpu.models.multilang import lang_confidence_scores as jscores
    from speechlid_tpu_torch.models.multilang import lang_confidence_scores

    rng = np.random.RandomState(6)
    sizes = np.array([5, 9, 7], np.int32)
    logits = rng.randn(3, 2, 20, 10).astype(np.float32)
    logits[2, :, :, -1] += 50.0  # head 2 decodes every frame as blank
    lengths = np.array([20, 13], np.int32)
    ref = np.asarray(jscores(jnp.asarray(logits), jnp.asarray(sizes), jnp.asarray(lengths),
                             corrected=corrected))
    got = lang_confidence_scores(torch.from_numpy(logits), torch.from_numpy(sizes),
                                 torch.from_numpy(lengths), corrected=corrected).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[:, 2], [0.0, 0.0] if corrected else [-2.0, -2.0])
