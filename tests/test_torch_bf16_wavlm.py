"""bfloat16 compute in the port's SSL featurizers (``WavLMConfig.dtype``)
against the JAX package's with ``dtype: bfloat16`` in the same config, on
the CPU, weights through ``convert``, on ragged batches.

The JAX config's float32 islands are the port's: the convs and every
projection compute in bfloat16; the extractor's GroupNorm / LayerNorms and
every encoder LayerNorm compute and return float32, so a post-LN (Base+)
encoder's residual stream and output are float32 and a pre-LN one's
bfloat16 until its final LayerNorm; the attention logits and softmax are
float32.  Every output here has the dtype the JAX module gives it, and
meets the bars of ``tests/torch_parity.assert_bf16_close`` against the
float32 output of the same weights, with the tolerances measured (in
brackets).  ``mask_attention`` runs the padding mask into the attention
logits: a float32 fill value on float32 logits, which a bfloat16 tensor
could not hold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechlid_tpu.models import wav2vec2 as jw2v
from speechlid_tpu.models import wavlm as jwavlm
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import wav2vec2 as pw2v
from speechlid_tpu_torch.models import wavlm as pwavlm
from tests.torch_parity import TINY_SSL, assert_bf16_close, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

LENGTHS = np.array([3200, 2111], np.int32)
# pre-LN, layer-norm extractor with a bias, wave normalisation: wav2vec2 Large's shape
PRE_LN = dict(extractor_mode="layer_norm", conv_bias=True, layer_norm_first=True,
              normalize=True, relative_position_embedding=False, gru_rel_pos=False)
# measured (a) over the float32 output's largest entry
TOL = {
    "extractor_default": 2e-2,     # (8.8e-3)
    "extractor_layer_norm": 1e-2,  # (1.7e-3)
    "post_ln": 2e-2,         # (the worst hidden state, the last: 9.8e-3)
    "post_ln_masked": 2e-2,  # (9.8e-3)
    "pre_ln": 2e-2,          # (8.2e-3)
    "featurizer": 2e-2,      # (6.0e-3)
}


def _x(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _jax_dtype_name(a):
    return str(np.asarray(a).dtype) if a.dtype != jnp.bfloat16 else "bfloat16"


def _torch_dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("mode", ["default", "layer_norm"])
def test_extractor_matches_jax_bf16(mode):
    """The conv stack: bfloat16 convs, a float32 GroupNorm (default) or
    LayerNorm after every conv (layer_norm); the output's dtype as JAX's."""
    conf = dict(TINY_SSL, extractor_mode=mode, conv_bias=mode == "layer_norm")
    wav = _x((2, 3200), 1)
    out = {}
    for dt in ("float32", "bfloat16"):
        jm = jwavlm.ConvFeatureExtractor(jwavlm.WavLMConfig.from_dict(dict(conf, dtype=dt)))
        if dt == "float32":
            v = jax.tree_util.tree_map(np.asarray, jax.jit(
                lambda key: jm.init(key, jnp.asarray(wav)))(jax.random.PRNGKey(1)))
        out[dt] = jax.jit(jm.apply)(v, jnp.asarray(wav))
    full = {"feature_extractor": v["params"], "layer_norm": {"scale": 0, "bias": 0},
            "mask_emb": 0, "pos_conv": {"weight_v": 0, "weight_g": 0, "bias": 0},
            "encoder_layer_norm": {"scale": 0, "bias": 0}}
    state = {k[len("feature_extractor."):]: torch.tensor(a)
             for k, a in convert.wavlm_state(full).items() if k.startswith("feature_extractor.")}
    pm = pwavlm.ConvFeatureExtractor(pwavlm.WavLMConfig.from_dict(dict(conf, dtype="bfloat16")))
    pm.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(wav))
    assert _torch_dtype_name(got) == _jax_dtype_name(out["bfloat16"]) == (
        "bfloat16" if mode == "default" else "float32")
    assert_bf16_close(f"extractor_{mode}", got, np.asarray(out["bfloat16"], np.float32),
                      np.asarray(out["float32"]), TOL[f"extractor_{mode}"])


@pytest.mark.parametrize("case", ["post_ln", "post_ln_masked", "pre_ln"])
def test_wavlm_matches_jax_bf16(case):
    """The whole upstream with every hidden state (``ret_layer_results``):
    the gated relative position bias post-LN (Base+), the same with the
    padding mask in the attention, and a pre-LN wav2vec2-shaped encoder;
    each state's dtype as JAX's, each within the bars."""
    conf = dict(TINY_SSL, **(PRE_LN if case == "pre_ln" else {}))
    masked = case == "post_ln_masked"
    wav, lengths = _x((2, 3200), 2, 0.1), LENGTHS
    out = {}
    for dt in ("float32", "bfloat16"):
        jm = jwavlm.WavLM(jwavlm.WavLMConfig.from_dict(dict(conf, dtype=dt)),
                          mask_attention=masked)
        if dt == "float32":
            params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda key: jm.init(
                key, jnp.asarray(wav), jnp.asarray(lengths)))(jax.random.PRNGKey(2)))["params"]
        x, _, layers = jax.jit(lambda p, w, n: jm.apply(
            {"params": p}, w, n, ret_layer_results=True))(params, jnp.asarray(wav),
                                                          jnp.asarray(lengths))
        out[dt] = (x, layers)
    pm = pwavlm.WavLM(pwavlm.WavLMConfig.from_dict(dict(conf, dtype="bfloat16")),
                      mask_attention=masked)
    convert.load_into(pm, convert.wavlm_state(params))
    pm.eval()
    with torch.no_grad():
        x, feat_len, layers = pm(torch.from_numpy(wav), torch.from_numpy(lengths),
                                 ret_layer_results=True)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert feat_len.tolist() == [159, 104]
    (jx16, jl16), (jx32, jl32) = out["bfloat16"], out["float32"]
    assert _torch_dtype_name(x) == _jax_dtype_name(jx16)
    assert_bf16_close(case, x, np.asarray(jx16, np.float32), np.asarray(jx32), TOL[case])
    assert len(layers) == len(jl16) == TINY_SSL["encoder_layers"] + 1
    for i, (got, j16, j32) in enumerate(zip(layers, jl16, jl32)):
        assert _torch_dtype_name(got) == _jax_dtype_name(j16), i
        assert_bf16_close(f"{case} hidden state {i}", got, np.asarray(j16, np.float32),
                          np.asarray(j32), TOL[case])
    assert torch.isfinite(x).all()


def test_featurizer_weighted_sum_is_float32():
    """``SSLFeaturizerModel`` with the softmax-weighted layer sum over a
    pre-LN encoder's bfloat16 states: float32 out (the float32 weights
    promote them), as JAX's ``tensordot``."""
    conf = dict(TINY_SSL, **PRE_LN)
    wav, lengths = _x((2, 3200), 3, 0.1), LENGTHS
    out = {}
    for dt in ("float32", "bfloat16"):
        jm = jw2v.SSLFeaturizerModel(jwavlm.WavLMConfig.from_dict(dict(conf, dtype=dt)),
                                     feature_selection="hidden_states")
        if dt == "float32":
            params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda key: jm.init(
                key, jnp.asarray(wav), jnp.asarray(lengths)))(jax.random.PRNGKey(3)))["params"]
            params["featurizer"]["layer_weights"] = np.array([0.3, -0.2, 0.5], np.float32)
        out[dt] = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(wav),
                                             jnp.asarray(lengths)))(params)
    pm = pw2v.SSLFeaturizerModel(pwavlm.WavLMConfig.from_dict(dict(conf, dtype="bfloat16")),
                                 feature_selection="hidden_states")
    convert.load_into(pm, convert.ssl_featurizer_state(params))
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(wav), torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and out["bfloat16"].dtype == jnp.float32
    assert_bf16_close("featurizer", got, out["bfloat16"], out["float32"], TOL["featurizer"])


def test_config_dtype_names():
    """``dtype`` comes by name, as a config file or a checkpoint's
    ``ssl_config`` gives it; the JAX config keeps the same name."""
    conf = dict(TINY_SSL, dtype="bfloat16")
    assert pwavlm.WavLMConfig.from_dict(conf).dtype == "bfloat16"
    assert jwavlm.WavLMConfig.from_dict(conf).dtype == "bfloat16"
    model = pwavlm.WavLM(pwavlm.WavLMConfig.from_dict(conf))
    assert model.layers[0].fc1.compute_dtype == torch.bfloat16
    assert model.feature_extractor.conv_0.compute_dtype == torch.bfloat16
    half = pwavlm.WavLM(pwavlm.WavLMConfig.from_dict(dict(TINY_SSL, dtype="float16")))
    assert half.layers[0].fc1.compute_dtype == torch.float16
    with pytest.raises(NotImplementedError, match="float64"):
        pwavlm.WavLM(pwavlm.WavLMConfig.from_dict(dict(TINY_SSL, dtype="float64")))
