"""The port's SSL featurizer modules (``models/wavlm.py``,
``models/wav2vec2.py``) against the JAX package's, on the CPU, with weights
carried across by ``convert`` and the same seeded numpy inputs.

Tolerances: outputs 1e-4 (atol and rtol; float32 through two encoder
layers, summed in another order than XLA's); gradients of a scalar loss
within 1e-4 of each leaf's largest entry; the relative-position bucket
table, span-mask bookkeeping, lengths and the weight round trip exact.
The ``.pt`` loaders read checkpoints the tests write themselves, in the
reference's torch names."""

import math

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
from tests.torch_parity import (  # noqa: F401
    TINY_SSL,
    W2V,
    one_thread,
    tree_leaves_with_names,
    write_wav2vec2_pt,
    write_wavlm_pt,
)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
LENGTHS = np.array([3200, 2111], np.int32)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(**kw):
    d = dict(TINY_SSL, **kw)
    return jwavlm.WavLMConfig.from_dict(d), pwavlm.WavLMConfig.from_dict(d)


def _jax_init(module, seed, *args, **kwargs):
    return _np(jax.jit(lambda key: module.init(key, *args, **kwargs))(jax.random.PRNGKey(seed)))


def _apply(module, variables, *args, **kwargs):
    """``module.apply`` under ``jax.jit`` (static keyword arguments)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args)


def _load(module, state):
    convert.load_into(module, state)
    return module.eval()


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.fixture(scope="module")
def wavlm_pair():
    """(JAX WavLM, numpy params, port WavLM) of the TINY_SSL config, built once."""
    torch.set_num_threads(1)
    jcfg, pcfg = _configs()
    jm = jwavlm.WavLM(jcfg)
    params = _jax_init(jm, 0, jnp.asarray(_x((2, 3200), 0)), jnp.asarray(LENGTHS))["params"]
    return jm, params, _load(pwavlm.WavLM(pcfg), convert.wavlm_state(params))


# ------------------------------------------------------------------ pieces


@pytest.mark.parametrize("mode,bias,impl", [
    ("default", False, "conv"), ("layer_norm", True, "conv"), ("default", False, "matmul")])
def test_extractor_matches_jax(mode, bias, impl):
    jcfg, pcfg = _configs(extractor_mode=mode, conv_bias=bias, conv_extractor_impl=impl)
    wav = _x((2, 3200), 1)
    jm = jwavlm.ConvFeatureExtractor(jcfg)
    v = _jax_init(jm, 1, jnp.asarray(wav))
    want = _apply(jm, v, jnp.asarray(wav))
    pm = pwavlm.ConvFeatureExtractor(pcfg)
    state = {k[len("feature_extractor."):]: torch.tensor(a) for k, a in
             _extractor_state(v["params"]).items()}
    pm.load_state_dict(state, strict=True)
    got = pm(torch.from_numpy(wav))
    assert got.shape == want.shape == (2, 159, 32)
    _close(got.detach(), want)


def _extractor_state(p):
    """The extractor's entries of ``convert.wavlm_state`` for a bare
    ``ConvFeatureExtractor`` params tree."""
    full = {"feature_extractor": p, "layer_norm": {"scale": 0, "bias": 0}, "mask_emb": 0,
            "pos_conv": {"weight_v": 0, "weight_g": 0, "bias": 0},
            "encoder_layer_norm": {"scale": 0, "bias": 0}}
    return {k: v for k, v in convert.wavlm_state(full).items()
            if k.startswith("feature_extractor.")}


@pytest.mark.parametrize("num_buckets,max_distance", [(320, 800), (320, 1280), (16, 64)])
def test_bucket_table_equals_jax_exactly(num_buckets, max_distance):
    """Every T up to 849 frames (17 s): the table of T is the top-left
    block of the table of 849, since rel[i, j] = j − i."""
    t = 849
    pos = np.arange(t)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(jax.jit(lambda r: jwavlm._relative_positions_bucket(
        r, num_buckets, max_distance))(jnp.asarray(rel)))
    got = pwavlm._bucket_table(t, num_buckets, max_distance, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    for small in (1, 2, 99, 149, 199, 649):
        np.testing.assert_array_equal(
            pwavlm._bucket_table(small, num_buckets, max_distance, torch.device("cpu")).numpy(),
            want[:small, :small])
    assert want.min() == 0 and want.max() <= num_buckets - 1


@pytest.mark.parametrize("case", ["gated", "ungated", "no_bias", "padded", "given_bias"])
def test_attention_matches_jax(case):
    x = _x((2, 37, 64), 2)
    pad = None
    if case == "padded":
        pad = np.arange(37)[None, :] >= np.array([37, 20])[:, None]
    kw = dict(has_relative_attention_bias=case != "no_bias", num_buckets=16, max_distance=64,
              gru_rel_pos=case in ("gated", "padded", "given_bias"))
    jm = jwavlm.RelPosMultiheadAttention(64, 4, **kw)
    bias = None
    if case == "given_bias":  # a later layer: layer 0's bias comes in
        kw["has_relative_attention_bias"] = False
        jm = jwavlm.RelPosMultiheadAttention(64, 4, **kw)
        bias = _x((4, 37, 37), 3)
    args = (jnp.asarray(x), None if pad is None else jnp.asarray(pad),
            None if bias is None else jnp.asarray(bias))
    v = _jax_init(jm, 2, *args)
    want, want_bias = _apply(jm, v, *args)
    pm = pwavlm.RelPosMultiheadAttention(64, 4, **kw)
    layer = convert.wavlm_layer_state({"self_attn": v["params"],
                                       "self_attn_layer_norm": {"scale": 0, "bias": 0},
                                       "final_layer_norm": {"scale": 0, "bias": 0},
                                       "fc1": {"kernel": np.zeros((1, 1))},
                                       "fc2": {"kernel": np.zeros((1, 1))}}, "")
    pm.load_state_dict({k[len("self_attn."):]: torch.tensor(a) for k, a in layer.items()
                        if k.startswith("self_attn.")}, strict=True)
    got, got_bias = pm(torch.from_numpy(x), None if pad is None else torch.from_numpy(pad),
                       None if bias is None else torch.from_numpy(bias))
    _close(got.detach(), want)
    if want_bias is None:
        assert got_bias is None
    else:  # the UNGATED bias goes on to the next layer
        _close(got_bias.detach(), want_bias, tol=0)


@pytest.mark.parametrize("pre_ln,act", [(False, "gelu"), (True, "gelu"), (False, "glu")])
def test_encoder_layer_matches_jax(pre_ln, act):
    jcfg, pcfg = _configs(layer_norm_first=pre_ln, activation_fn=act)
    x = _x((2, 29, 64), 4)
    jm = jwavlm.WavLMEncoderLayer(jcfg, has_relative_attention_bias=True)
    v = _jax_init(jm, 4, jnp.asarray(x))
    want, want_bias = _apply(jm, v, jnp.asarray(x))
    pm = _load(pwavlm.WavLMEncoderLayer(pcfg, has_relative_attention_bias=True),
               convert.wavlm_layer_state(v["params"], ""))
    got, got_bias = pm(torch.from_numpy(x))
    _close(got.detach(), want)
    _close(got_bias.detach(), want_bias, tol=0)


@pytest.mark.parametrize("k,groups", [(16, 4), (7, 2)])
def test_pos_conv_matches_jax(k, groups):
    jcfg, pcfg = _configs(conv_pos=k, conv_pos_groups=groups)
    x = _x((2, 33, 64), 5)
    jm = jwavlm._WeightNormConvPos(jcfg)
    v = _jax_init(jm, 5, jnp.asarray(x))
    want = _apply(jm, v, jnp.asarray(x))
    pm = pwavlm._WeightNormConvPos(pcfg)
    pm.load_state_dict({n: torch.tensor(v["params"][n]) for n in ("weight_v", "weight_g", "bias")})
    got = pm(torch.from_numpy(x))
    assert got.shape == want.shape == x.shape
    _close(got.detach(), want)


# ------------------------------------------------------------------ WavLM


def test_wavlm_last_state_and_layer_results_match_jax(wavlm_pair):
    jm, params, pm = wavlm_pair
    wav = _x((2, 3200), 6)
    want, want_len, want_layers = _apply(jm, {"params": params}, jnp.asarray(wav),
                                           jnp.asarray(LENGTHS), ret_layer_results=True)
    got, got_len, got_layers = pm(torch.from_numpy(wav), torch.from_numpy(LENGTHS),
                                  ret_layer_results=True)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got_len.numpy(), [159, 104])
    _close(got.detach(), want)
    assert len(got_layers) == len(want_layers) == 3
    for i, (a, b) in enumerate(zip(got_layers, want_layers)):
        _close(a.detach(), b, what=f"layer_results[{i}]")


@pytest.mark.parametrize("kw", [
    dict(layer_norm_first=True, extractor_mode="layer_norm", normalize=True, conv_bias=True),
    dict(relative_position_embedding=False, gru_rel_pos=False, feature_grad_mult=0.1),
    dict(encoder_embed_dim=32, encoder_attention_heads=2, activation_fn="glu"),  # no projection
], ids=["pre_ln_layer_norm_normalize", "wav2vec2_like", "no_post_extract_proj"])
def test_wavlm_variants_match_jax(kw):
    jcfg, pcfg = _configs(**kw)
    wav = _x((2, 3200), 7)
    jm = jwavlm.WavLM(jcfg)
    params = _jax_init(jm, 7, jnp.asarray(wav), jnp.asarray(LENGTHS))["params"]
    assert ("post_extract_proj" in params) == (jcfg.encoder_embed_dim != 32)
    want, _ = _apply(jm, {"params": params}, jnp.asarray(wav), jnp.asarray(LENGTHS))
    pm = _load(pwavlm.WavLM(pcfg), convert.wavlm_state(params))
    got, _ = pm(torch.from_numpy(wav), torch.from_numpy(LENGTHS))
    _close(got.detach(), want)


def test_mask_attention_matches_jax():
    jcfg, pcfg = _configs()
    wav = _x((2, 3200), 8)
    jm = jwavlm.WavLM(jcfg, mask_attention=True)
    params = _jax_init(jm, 8, jnp.asarray(wav), jnp.asarray(LENGTHS))["params"]
    want, _ = _apply(jm, {"params": params}, jnp.asarray(wav), jnp.asarray(LENGTHS))
    pm = _load(pwavlm.WavLM(pcfg, mask_attention=True), convert.wavlm_state(params))
    got, _ = pm(torch.from_numpy(wav), torch.from_numpy(LENGTHS))
    _close(got.detach(), want)


def test_padding_takes_part_in_attention_by_default(wavlm_pair):
    """``mask_attention=False`` is the reference's call path: a valid
    frame's output depends on what lies in the padding."""
    _, _, pm = wavlm_pair
    wav = _x((1, 3200), 9)
    other = wav.copy()
    other[:, 2111:] = _x((1, 3200 - 2111), 10)
    lens = torch.tensor([2111])
    a, _ = pm(torch.from_numpy(wav), lens)
    b, _ = pm(torch.from_numpy(other), lens)
    assert float((a - b)[:, :50].abs().max().detach()) > 1e-3


def test_gradients_match_jax(wavlm_pair):
    """Every parameter's gradient of sum(y · cot), within 1e-4 of the
    leaf's largest entry (``mask_emb``'s, zero without masking, is held in
    the masked test below).  ``k_proj``'s bias adds q·b to a whole row of
    logits, which the softmax cancels: its true gradient is zero and both
    packages' are rounding noise, held to 1e-4 of the largest gradient."""
    jm, params, pm = wavlm_pair
    wav, cot = _x((2, 3200), 11), _x((2, 159, 64), 12)

    def jloss(p):
        y, _ = _apply(jm, {"params": p}, jnp.asarray(wav), jnp.asarray(LENGTHS))
        return jnp.sum(y * cot)

    want = _np(jax.jit(jax.grad(jloss))(jax.tree_util.tree_map(jnp.asarray, params)))
    pm.zero_grad()
    y, _ = pm(torch.from_numpy(wav), torch.from_numpy(LENGTHS))
    (y * torch.from_numpy(cot)).sum().backward()
    grads = {n: p.grad for n, p in pm.named_parameters()}
    grads["mask_emb"] = torch.zeros_like(pm.mask_emb)  # unmasked: no gradient in either
    got = convert.wavlm_variables(grads)
    a, b = tree_leaves_with_names(got), tree_leaves_with_names(want)
    assert [n for n, _ in a] == [n for n, _ in b]
    largest = max(float(np.abs(w).max()) for _, w in b)
    for (name, g), (_, w) in zip(a, b):
        if name.endswith("k_proj/bias"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= TOL * largest, name
            continue
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale, err_msg=name)
    pm.zero_grad()


def test_masked_forward_writes_mask_emb(wavlm_pair, monkeypatch):
    """One train-mode forward with both packages' ``compute_mask_spans``
    returning the same mask (dropout off): the outputs and the gradient of
    ``mask_emb`` agree, and the mask changed the output."""
    jm, params, pm = wavlm_pair
    wav, cot = _x((2, 3200), 13), _x((2, 159, 64), 14)
    spans = np.zeros((2, 159), bool)
    spans[0, 5:25] = spans[1, 60:70] = True
    monkeypatch.setattr(jwavlm, "compute_mask_spans", lambda *a, **k: jnp.asarray(spans))
    monkeypatch.setattr(pwavlm, "compute_mask_spans", lambda *a, **k: torch.from_numpy(spans))

    def jloss(p):
        y, _ = _apply(jm, {"params": p}, jnp.asarray(wav), jnp.asarray(LENGTHS), mask=True,
                        deterministic=False, rngs={"mask": jax.random.PRNGKey(0)})
        return jnp.sum(y * cot), y

    (_, want), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    pm.train()
    try:
        pm.zero_grad()
        got, _ = pm(torch.from_numpy(wav), torch.from_numpy(LENGTHS), mask=True)
        (got * torch.from_numpy(cot)).sum().backward()
        _close(got.detach(), want)
        g = np.asarray(grads["mask_emb"])
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(pm.mask_emb.grad.numpy(), g, rtol=0,
                                   atol=TOL * np.abs(g).max())
        plain, _ = pm(torch.from_numpy(wav), torch.from_numpy(LENGTHS), mask=False)
        assert float((plain - got).abs().max().detach()) > 1e-2
    finally:
        pm.eval()
        pm.zero_grad()


def test_layerdrop_one_skips_every_layer_in_training(wavlm_pair):
    """encoder_layerdrop 1: every layer runs and is skipped, in both
    packages; in eval mode none is."""
    jcfg, pcfg = _configs(encoder_layerdrop=1.0)
    _, params, _ = wavlm_pair
    wav = _x((2, 3200), 15)
    jm = jwavlm.WavLM(jcfg)
    want, _, jl = _apply(jm, {"params": params}, jnp.asarray(wav), jnp.asarray(LENGTHS),
                           ret_layer_results=True, deterministic=False,
                           rngs={"layerdrop": jax.random.PRNGKey(0)})
    pm = _load(pwavlm.WavLM(pcfg), convert.wavlm_state(params)).train()
    got, _, pl = pm(torch.from_numpy(wav), torch.from_numpy(LENGTHS), ret_layer_results=True)
    _close(got.detach(), want)
    for a, b in zip(pl, jl):
        _close(a.detach(), b)
    _close(got.detach(), pl[0].detach(), tol=0)
    evaluated, _ = pm.eval()(torch.from_numpy(wav), torch.from_numpy(LENGTHS))
    assert float((evaluated - got).abs().max().detach()) > 1e-2


# ------------------------------------------------------------ mask spans


@pytest.mark.parametrize("lengths", [None, (200, 123, 31, 5)])
def test_compute_mask_spans_law(lengths):
    """Bookkeeping exact (spans inside ``lengths``, at least ``min_masks``
    spans' worth of frames), the mean masked share within 0.02 of the JAX
    package's over 4000 rows, the same draws from the same generator
    state."""
    b, t, p, span = 4, 200, 0.3, 10
    lens = None if lengths is None else torch.tensor(lengths)
    gen = torch.Generator().manual_seed(0)
    masks = torch.stack([pwavlm.compute_mask_spans(gen, b, t, p, span, lengths=lens)
                         for _ in range(1000)])  # (1000, B, T)
    valid = t if lengths is None else np.asarray(lengths)
    if lengths is not None:
        beyond = torch.arange(t)[None, None, :] >= lens[None, :, None]
        assert not bool(masks[beyond.expand_as(masks)].any())
    # a span covers at least min(len, span) frames and two of them at least
    # one span's worth, unless the utterance is shorter than a span
    per_row = masks.sum(-1).numpy()
    assert (per_row >= np.minimum(valid, span)).all()
    jl = None if lengths is None else jnp.asarray(lengths)
    keys = jax.random.split(jax.random.PRNGKey(0), 1000)
    jmasks = np.asarray(jax.jit(jax.vmap(
        lambda k: jwavlm.compute_mask_spans(k, b, t, p, span, lengths=jl)))(keys))
    share = masks.float().mean((0, 2)).numpy()
    jshare = jmasks.mean((0, 2))
    np.testing.assert_allclose(share, jshare, atol=0.02)
    again = pwavlm.compute_mask_spans(torch.Generator().manual_seed(0), b, t, p, span,
                                      lengths=lens)
    assert torch.equal(again, masks[0])
    channel = pwavlm.compute_mask_spans(gen, b, 64, 0.0, 10, min_masks=0)
    assert not bool(channel.any())


# ---------------------------------------------------- wrappers, featurizer


@pytest.mark.parametrize("selection", ["last_hidden_state", "hidden_states"])
def test_ssl_featurizer_model_matches_jax(selection):
    jcfg, pcfg = _configs()
    wav = _x((2, 3200), 16)
    jm = jw2v.SSLFeaturizerModel(config=jcfg, feature_selection=selection)
    params = _jax_init(jm, 16, jnp.asarray(wav), jnp.asarray(LENGTHS))["params"]
    if selection == "hidden_states":  # zeros at init: a plain mean; make it weighted
        params["featurizer"]["layer_weights"] = _x((3,), 17)
    want = _apply(jm, {"params": params}, jnp.asarray(wav), jnp.asarray(LENGTHS))
    pm = _load(pw2v.SSLFeaturizerModel(pcfg, feature_selection=selection),
               convert.ssl_featurizer_state(params))
    got = pm(torch.from_numpy(wav), torch.from_numpy(LENGTHS))
    _close(got.detach(), want)
    np.testing.assert_array_equal(pm.subsampled_lengths(torch.from_numpy(LENGTHS)).numpy(),
                                  np.asarray(jm.subsampled_lengths(jnp.asarray(LENGTHS))))


@pytest.mark.parametrize("only_last", [True, False])
def test_wavlm_model_wrapper_matches_jax(only_last):
    jcfg, pcfg = _configs()
    wav = _x((2, 3200), 18)
    jm = jwavlm.WavLMModel(jcfg)
    params = _jax_init(jm, 18, jnp.asarray(wav), jnp.asarray(LENGTHS))["params"]
    want = _apply(jm, {"params": params}, jnp.asarray(wav), jnp.asarray(LENGTHS),
                    only_last=only_last)
    pm = _load(pwavlm.WavLMModel(pcfg), convert.ssl_featurizer_state(params))
    got = pm(torch.from_numpy(wav), torch.from_numpy(LENGTHS), only_last=only_last)
    assert got.shape == want.shape
    _close(got.detach(), want)


def test_wav2vec2_config_forward_matches_jax():
    kw = {k: v for k, v in TINY_SSL.items()
          if k not in ("relative_position_embedding", "num_buckets", "max_distance",
                       "gru_rel_pos")}
    jcfg, pcfg = jw2v.wav2vec2_config(**kw), pw2v.wav2vec2_config(**kw)
    assert not pcfg.relative_position_embedding and not pcfg.gru_rel_pos
    wav = _x((2, 3200), 19)
    jm = jw2v.Wav2Vec2(jcfg)
    params = _jax_init(jm, 19, jnp.asarray(wav), jnp.asarray(LENGTHS))["params"]
    want, _ = _apply(jm, {"params": params}, jnp.asarray(wav), jnp.asarray(LENGTHS))
    pm = pw2v.Wav2Vec2(pcfg)
    convert.load_into(pm, convert.wavlm_state(params["encoder"], "encoder."))
    got, _ = pm.eval()(torch.from_numpy(wav), torch.from_numpy(LENGTHS))
    _close(got.detach(), want)


def test_unrolled_and_scanned_params_round_trip(wavlm_pair):
    """flax params → state_dict → flax params gives the unrolled tree back
    bit for bit; the scanned layout loads to the same state_dict."""
    _, params, _ = wavlm_pair
    sd = convert.wavlm_state(params)
    back = convert.wavlm_variables(sd)
    a, b = tree_leaves_with_names(back), tree_leaves_with_names(params)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)
    scanned = convert.wavlm_state(_np(jwavlm.stack_scan_layers(params)))
    assert sorted(scanned) == sorted(sd)
    for name in sd:
        np.testing.assert_array_equal(scanned[name], sd[name], err_msg=name)


# ------------------------------------------------------- .pt checkpoints


@pytest.mark.parametrize("spelling", ["parametrizations", "weight_g"])
def test_wavlm_pt_loads_to_the_same_forward(tmp_path, wavlm_pair, spelling):
    jm, params, _ = wavlm_pair
    path = str(tmp_path / "wavlm.pt")
    write_wavlm_pt(path, params, TINY_SSL, spelling)
    jparams, jcfg = jwavlm.load_wavlm_checkpoint(path)
    state, pcfg = pwavlm.load_wavlm_checkpoint(path)
    assert dataclasses_equal(jcfg, pcfg)
    wav = _x((2, 3200), 20)
    want, _ = _apply(jwavlm.WavLM(jcfg), {"params": jparams}, jnp.asarray(wav),
                     jnp.asarray(LENGTHS))
    pm = pwavlm.WavLM(pcfg)
    pm.load_state_dict(state, strict=True)
    got, _ = pm.eval()(torch.from_numpy(wav), torch.from_numpy(LENGTHS))
    _close(got.detach(), want)


def test_fairseq_wav2vec2_pt_loads_to_the_same_forward(tmp_path):
    jcfg = jw2v.wav2vec2_config(**W2V)
    wav = _x((2, 3200), 21)
    jm = jwavlm.WavLM(jcfg)
    params = _jax_init(jm, 21, jnp.asarray(wav), jnp.asarray(LENGTHS))["params"]
    path = str(tmp_path / "w2v.pt")
    write_wav2vec2_pt(path, params, W2V)
    jparams, jcfg2 = jw2v.load_fairseq_wav2vec2_checkpoint(path)
    state, pcfg = pw2v.load_fairseq_wav2vec2_checkpoint(path)
    assert dataclasses_equal(jcfg2, pcfg) and pcfg.encoder_layers == 2
    assert not any(k.startswith(("quantizer", "project_q", "final_proj")) for k in state)
    want, _ = _apply(jm, {"params": jparams}, jnp.asarray(wav), jnp.asarray(LENGTHS))
    pm = pwavlm.WavLM(pcfg)
    pm.load_state_dict(state, strict=True)
    got, _ = pm.eval()(torch.from_numpy(wav), torch.from_numpy(LENGTHS))
    _close(got.detach(), want)


def dataclasses_equal(jcfg, pcfg):
    """The same fields with the same values, but for the compute dtype
    (a jnp type in the JAX config, a name in the port's)."""
    import dataclasses

    j = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    p = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg) if f.name != "dtype"}
    return j == p and pcfg.dtype == "float32" and jcfg.dtype == jnp.float32


def test_config_from_dict_and_conv_spec():
    cfg = pwavlm.WavLMConfig.from_dict(dict(TINY_SSL, not_a_field=3))
    assert cfg.conv_layers == [(32, 10, 5), (32, 3, 2), (32, 3, 2)]
    assert pwavlm._eval_conv_spec("[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2") == \
        jwavlm._eval_conv_spec("[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2")
    with pytest.raises(ValueError):
        pwavlm._eval_conv_spec("__import__('os')")
    lens = np.array([48000, 32000, 64000, 272000])
    np.testing.assert_array_equal(
        pwavlm.conv_out_lengths(torch.from_numpy(lens), pwavlm.WavLMConfig().conv_layers).numpy(),
        [149, 99, 199, 849])
    # bfloat16 compute builds and runs (a post-LN encoder's output is
    # float32, its last LayerNorm's); the int8 path (ported) builds, and an
    # unknown engine raises
    bf16 = pwavlm.WavLM(pwavlm.WavLMConfig.from_dict(dict(TINY_SSL, dtype="bfloat16"))).eval()
    with torch.no_grad():
        out, _ = bf16(torch.from_numpy(_x((1, 3200), 4, 0.1)))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    int8 = pwavlm.WavLM(pwavlm.WavLMConfig(encoder_layers=1, quant_dot="int8"))
    assert int8.layers[0].self_attn.q_proj.quant_dot == "int8" and int8.layers[0].fc2.dot is None
    with pytest.raises(ValueError, match="quant_dot"):
        pwavlm.WavLM(pwavlm.WavLMConfig(encoder_layers=1, quant_dot="int4"))
    assert math.isclose(pwavlm.LN_EPS, 1e-5)
