"""``models/multilang.convert_joint_wavlm_lid_state``: the reference's joint
WavLM LID state dict (``WavLMMutiLangModel``) into the port's joint task,
against the JAX package's converter followed by ``convert.lid_state``.

The test writes the reference state dict itself (no checkpoint is
downloaded): the tiny WavLM (``torch_parity.TINY_SSL``) in the reference's
names (``torch_parity.reference_wavlm_state``, under
``model.featurizer.model.``, with a pre-training leftover the converters
ignore), and random heads and discriminator in the reference's
``ConformerLinear`` / ``lang_discriminator`` names.  Both converters give
the same keys and the same arrays, exactly; the padded-vocabulary blank
sits at V_max; ``infer`` of the port's task on the converted weights lies
within 1e-4 of the JAX task's (logits, scores, mlp scores; the predicted
language exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import multilang as jmultilang
from speechlid_tpu.models import wavlm as jwavlm
from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import multilang as pmultilang
from speechlid_tpu_torch.models import wavlm as pwavlm
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from tests.torch_parity import (  # noqa: F401
    TINY_SSL,
    one_thread,
    perturbed,
    reference_wavlm_state,
)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
LANGS = ("aa", "bb")
LANG2VOCAB = {"aa": 6, "bb": 9}
HP = dict(lang2vocab=LANG2VOCAB, lang2index={"aa": 0, "bb": 1}, featurizer="wavlm",
          ssl_config=dict(TINY_SSL), feature_selection="last_hidden_state",
          head_dim_head=8, head_num_head=4, dropout=0.0, schedule=None)


def reference_state(ptask: LidASRTask, seed: int = 0) -> dict:
    """A ``WavLMMutiLangModel`` state dict in the reference's names, random
    values, the port task's shapes."""
    rng = np.random.RandomState(seed)
    ours = {k: v.numpy() for k, v in ptask.model.state_dict().items()}
    upstream = perturbed(convert.wavlm_variables(ours, "featurizer.upstream."), seed)
    cfg = jwavlm.WavLMConfig.from_dict(TINY_SSL)
    sd = {"model.featurizer.model." + k: v.numpy()
          for k, v in reference_wavlm_state(upstream, cfg, "parametrizations").items()}

    def draw(shape, positive=False):
        if positive:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    for li, lg in enumerate(LANGS):
        src, dst = f"model.last_projects.{lg}.block.", f"heads.heads.{li}.blocks.0."
        for ref, name in pmultilang._REFERENCE_BLOCK.items():
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                if f"{dst}{name}.{leaf}" in ours:
                    sd[f"{src}{ref}.{leaf}"] = draw(ours[f"{dst}{name}.{leaf}"].shape,
                                                    positive=leaf == "running_var")
        sd[src + "attn.fn.rel_pos_emb.weight"] = draw(ours[dst + "attn.rel_pos_emb"].shape)
        for ref, name in (("conv.net.2", "conv.pointwise_in"),
                          ("conv.net.7", "conv.pointwise_out")):
            sd[f"{src}{ref}.weight"] = draw(ours[f"{dst}{name}.weight"].shape + (1,))
            sd[f"{src}{ref}.bias"] = draw(ours[f"{dst}{name}.bias"].shape)
        k, c = ours[dst + "conv.depthwise.weight"].shape
        sd[src + "conv.net.4.conv.weight"] = draw((c, 1, k))
        sd[src + "conv.net.4.conv.bias"] = draw((c,))
        dim = ours[f"heads.heads.{li}.out.weight"].shape[1]
        sd[f"model.last_projects.{lg}.linear.weight"] = draw((LANG2VOCAB[lg] + 1, dim))
        sd[f"model.last_projects.{lg}.linear.bias"] = draw((LANG2VOCAB[lg] + 1,))
    for ref, name in (("0", "fc1"), ("2", "fc2")):
        for leaf in ("weight", "bias"):
            sd[f"lang_discriminator.linear.{ref}.{leaf}"] = draw(
                ours[f"discriminator.{name}.{leaf}"].shape)
    return sd


@pytest.fixture(scope="module")
def converted():
    torch.set_num_threads(1)
    ptask = LidASRTask(**HP, device="cpu")
    ref = reference_state(ptask)
    jvars = jmultilang.convert_joint_wavlm_lid_state(
        ref, LANGS, LANG2VOCAB, jwavlm.WavLMConfig.from_dict(TINY_SSL))
    got = pmultilang.convert_joint_wavlm_lid_state(
        {k: torch.from_numpy(v) for k, v in ref.items()}, LANGS, LANG2VOCAB,
        pwavlm.WavLMConfig.from_dict(TINY_SSL))
    return ptask, ref, jvars, got


def test_converter_equals_jax_converter_then_lid_state(converted):
    ptask, _, jvars, got = converted
    want = convert.lid_state(jvars)
    assert set(got) == set(want) == set(ptask.model.state_dict())
    for key, value in want.items():
        assert got[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_padded_vocabulary_blank_at_vmax(converted):
    _, ref, _, got = converted
    vmax = max(LANG2VOCAB.values())
    w = ref["model.last_projects.aa.linear.weight"]  # (V + 1, D), blank at V
    out = got["heads.heads.0.out.weight"]
    assert out.shape == (vmax + 1, w.shape[1])
    np.testing.assert_array_equal(out[:6], w[:6])
    np.testing.assert_array_equal(out[vmax], w[6])
    assert not out[6:vmax].any() and not got["heads.heads.0.out.bias"][6:vmax].any()


def test_infer_on_converted_weights_matches_jax(converted):
    ptask, _, jvars, got = converted
    convert.load_into(ptask.model, got)
    rng = np.random.RandomState(3)
    wavs = (0.1 * rng.randn(3, 4000)).astype(np.float32)
    lengths = np.array([4000, 3100, 2200], np.int32)
    jtask = JaxLidASRTask(**HP)
    want = jax.jit(jtask.infer_fn())(jax.tree_util.tree_map(jnp.asarray, jvars),
                                     jnp.asarray(wavs), jnp.asarray(lengths))
    out = ptask.infer_fn()(torch.from_numpy(wavs), torch.from_numpy(lengths))
    for key in ("logits", "scores", "mlp_scores"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(out["pred_lang"].numpy(), np.asarray(want["pred_lang"]))
