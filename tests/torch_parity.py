"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
seed a JAX module or task, convert its variables, and hand back both sides
with the same weights.  Everything random comes from a numpy seed."""

import argparse

import jax
import numpy as np
import pytest
import torch

from speechlid_tpu.models import wav2vec2 as jw2v
from speechlid_tpu.models import wavlm as jwavlm
from speechlid_tpu.tasks.lid_asr import LidASRTask as JaxLidASRTask
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models.init import init_like_flax_
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask


@pytest.fixture
def one_thread():
    """One intra-op thread: the test workers share the machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def random_batch_stats(variables, seed):
    """A numpy copy of flax ``variables`` whose BN mean/var are random
    (var positive), so that BatchNorm is not the identity."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        shape = np.shape(leaf)
        if getattr(path[-1], "key", "") == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.2 * rng.randn(*shape)).astype(np.float32)

    out = jax.tree_util.tree_map(np.asarray, dict(variables))
    out["batch_stats"] = jax.tree_util.tree_map_with_path(fill, out["batch_stats"])
    return out


def init_variables(module, seed, *args, **kwargs):
    """flax ``module.init`` on ``args`` → numpy variables with random BN
    statistics."""
    variables = jax.jit(lambda key: module.init(key, *args, **kwargs))(jax.random.PRNGKey(seed))
    return random_batch_stats(variables, seed)


def lid_pair(hparams, seed=0, **port_kwargs):
    """(JAX task, numpy variables, port task on the CPU) with the same
    hyper-parameters and converted weights."""
    jtask = JaxLidASRTask(**hparams)
    rng = np.random.RandomState(seed)
    sample = {"wavs": rng.randn(2, 16000).astype(np.float32),
              "wav_lengths": np.array([16000, 12000], np.int32)}
    variables = random_batch_stats(
        jtask.init_variables(jax.random.PRNGKey(seed), sample), seed)
    ptask = LidASRTask(**hparams, device="cpu", **port_kwargs)
    convert.load_into(ptask.model, convert.lid_state(variables))
    return jtask, variables, ptask


def _f32(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu()
    return np.asarray(x, np.float32)


def assert_bf16_close(name, port_bf16, jax_bf16, jax_f32, tol, scale=None):
    """The bfloat16 bars, stated against the float32 result of the same
    weights, since eager PyTorch and XLA round bfloat16 at different points
    (XLA computes a fused elementwise chain in float32 and rounds once):

    (a) ``max|port_bf16 − jax_bf16| ≤ tol · scale``;
    (b) ``max|port_bf16 − jax_f32| ≤ 2 · max|jax_bf16 − jax_f32| + 1e-3 · scale``,

    ``scale`` being ``max|jax_f32|`` unless given.  The failure message
    reports both distances beside their bars; returns them over ``scale``."""
    port, j16, f32 = _f32(port_bf16), _f32(jax_bf16), _f32(jax_f32)
    assert port.shape == j16.shape == f32.shape, (name, port.shape, j16.shape, f32.shape)
    scale = float(np.abs(f32).max()) if scale is None else float(scale)
    a = float(np.abs(port - j16).max())
    b = float(np.abs(port - f32).max())
    own = float(np.abs(j16 - f32).max())
    bar_a, bar_b = tol * scale, 2.0 * own + 1e-3 * scale
    assert np.isfinite(port).all(), f"{name}: the port's bfloat16 result is not finite"
    assert a <= bar_a and b <= bar_b, (
        f"{name}: (a) max|port_bf16 - jax_bf16| = {a:.4g} against {tol:g} x {scale:.4g} = "
        f"{bar_a:.4g}; (b) max|port_bf16 - f32| = {b:.4g} against 2 x {own:.4g} + 1e-3 x "
        f"{scale:.4g} = {bar_b:.4g}")
    return a / scale, b / scale


def tree_leaves_with_names(tree, prefix=""):
    """[(dotted name, leaf)] of a nested mapping, sorted by name; leaves as
    numpy arrays, but ``jax.ShapeDtypeStruct``s (``jax.eval_shape``) as
    they are."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        name = f"{prefix}{key}"
        if hasattr(value, "keys"):
            out.extend(tree_leaves_with_names(value, name + "/"))
        else:
            out.append((name, value if isinstance(value, jax.ShapeDtypeStruct)
                        else np.asarray(value)))
    return out


# ---------------------------------------------------------------------------
# SSL featurizers: a tiny shape, and .pt checkpoints in the reference's names
# ---------------------------------------------------------------------------

# tests/test_ssl_tasks.py's TINY_SSL with the gated relative position bias on,
# few buckets and a short positional conv
TINY_SSL = dict(
    encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
    encoder_attention_heads=4, conv_feature_layers="[(32,10,5)] + [(32,3,2)] * 2",
    dropout=0.0, attention_dropout=0.0, mask_prob=0.5,
    relative_position_embedding=True, num_buckets=16, max_distance=64, gru_rel_pos=True,
    conv_pos=16, conv_pos_groups=4,
)


def reference_wavlm_state(params, cfg, pos_conv_spelling):
    """flax WavLM params → a state_dict in the reference torch model's names
    (the inverse of the JAX package's ``convert_wavlm_state``), with the
    positional conv's weight norm under either spelling, plus keys the
    loaders must ignore."""
    sd = {}
    for i, _ in enumerate(cfg.conv_layers):
        p = params["feature_extractor"][f"conv_{i}"]
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = np.transpose(p["kernel"], (2, 1, 0))
        if "bias" in p:
            sd[f"feature_extractor.conv_layers.{i}.0.bias"] = p["bias"]
        if cfg.extractor_mode == "layer_norm":
            ln = params["feature_extractor"][f"ln_{i}"]
            sd[f"feature_extractor.conv_layers.{i}.2.1.weight"] = ln["scale"]
            sd[f"feature_extractor.conv_layers.{i}.2.1.bias"] = ln["bias"]
        elif i == 0:
            sd["feature_extractor.conv_layers.0.2.weight"] = params["feature_extractor"]["gn_0"]["scale"]
            sd["feature_extractor.conv_layers.0.2.bias"] = params["feature_extractor"]["gn_0"]["bias"]
    sd["layer_norm.weight"], sd["layer_norm.bias"] = (params["layer_norm"]["scale"],
                                                      params["layer_norm"]["bias"])
    if "post_extract_proj" in params:
        sd["post_extract_proj.weight"] = params["post_extract_proj"]["kernel"].T
        sd["post_extract_proj.bias"] = params["post_extract_proj"]["bias"]
    sd["mask_emb"] = params["mask_emb"]
    g, v = params["pos_conv"]["weight_g"], params["pos_conv"]["weight_v"]
    if pos_conv_spelling == "parametrizations":
        sd["encoder.pos_conv.0.parametrizations.weight.original0"] = g
        sd["encoder.pos_conv.0.parametrizations.weight.original1"] = v
    else:
        sd["encoder.pos_conv.0.weight_g"], sd["encoder.pos_conv.0.weight_v"] = g, v
    sd["encoder.pos_conv.0.bias"] = params["pos_conv"]["bias"]
    sd["encoder.layer_norm.weight"] = params["encoder_layer_norm"]["scale"]
    sd["encoder.layer_norm.bias"] = params["encoder_layer_norm"]["bias"]
    for i in range(cfg.encoder_layers):
        lp, pre = params[f"layers_{i}"], f"encoder.layers.{i}."
        attn = lp["self_attn"]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}self_attn.{proj}.weight"] = attn[proj]["kernel"].T
            sd[f"{pre}self_attn.{proj}.bias"] = attn[proj]["bias"]
        if "relative_attention_bias" in attn:
            sd[pre + "self_attn.relative_attention_bias.weight"] = attn["relative_attention_bias"]
        if "grep_linear" in attn:
            sd[pre + "self_attn.grep_linear.weight"] = attn["grep_linear"]["kernel"].T
            sd[pre + "self_attn.grep_linear.bias"] = attn["grep_linear"]["bias"]
            sd[pre + "self_attn.grep_a"] = attn["grep_a"]
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{pre}{ln}.weight"], sd[f"{pre}{ln}.bias"] = lp[ln]["scale"], lp[ln]["bias"]
        for fc in ("fc1", "fc2"):
            sd[f"{pre}{fc}.weight"], sd[f"{pre}{fc}.bias"] = lp[fc]["kernel"].T, lp[fc]["bias"]
    sd["label_embs_concat"] = np.zeros((3, 4), np.float32)  # a pre-training leftover
    return {k: torch.tensor(np.array(v)) for k, v in sd.items()}


def write_wavlm_pt(path, params, cfg_dict, spelling="parametrizations"):
    cfg = jwavlm.WavLMConfig.from_dict(cfg_dict)
    torch.save({"cfg": dict(cfg_dict, unknown_key=1),
                "model": reference_wavlm_state(params, cfg, spelling)}, path)


def write_wav2vec2_pt(path, params, cfg_dict):
    """A fairseq-style checkpoint: ``args`` a namespace, the pre-training
    heads beside the encoder."""
    cfg = jw2v.wav2vec2_config(**{k: v for k, v in cfg_dict.items()
                                  if k in ("encoder_layers", "encoder_embed_dim",
                                           "encoder_ffn_embed_dim", "encoder_attention_heads",
                                           "conv_feature_layers")})
    state = reference_wavlm_state(params, cfg, "weight_g")
    state["quantizer.vars"] = torch.zeros(3)
    state["project_q.weight"] = torch.zeros(4, 4)
    state["final_proj.weight"] = torch.zeros(4, 4)
    torch.save({"args": argparse.Namespace(**cfg_dict), "cfg": None, "model": state}, path)


# the encoder shape of TINY_SSL, as a fairseq checkpoint's args give it
W2V = {k: v for k, v in TINY_SSL.items() if k in (
    "encoder_layers", "encoder_embed_dim", "encoder_ffn_embed_dim", "encoder_attention_heads",
    "conv_feature_layers")}


def perturbed(variables, seed, scale=0.05):
    """A numpy copy of flax ``variables`` with every leaf moved by
    N(0, scale²): biases, norms and slopes leave their initial constants, so
    that a wrong conversion of any leaf shows."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + np.float32(scale) * np.asarray(rng.randn(*np.shape(a)), np.float32), dict(variables))


def port_drawn(model, seed, to_variables, to_state, adjust=perturbed):
    """flax variables drawn on the port's side, which spares a test the JAX
    init's compile: ``init_like_flax_(model)`` from ``seed``, converted by
    ``to_variables``, moved by ``adjust(variables, seed)`` (``perturbed`` or
    ``random_batch_stats``) and loaded back into ``model`` by ``to_state``.
    → the numpy variables.  A flax ``apply`` on them checks that no leaf is
    missing or misshapen; the round-trip tests compare their tree with
    ``jax.eval_shape`` of the JAX init, so that none is extra."""
    init_like_flax_(model, torch.Generator().manual_seed(seed))
    variables = jax.tree_util.tree_map(np.asarray, to_variables(model.state_dict()))
    variables = adjust(variables, seed)
    convert.load_into(model, to_state(variables))
    return variables


def assert_same_tree(got, want):
    """The same leaf names and shapes (``want`` may hold
    ``jax.ShapeDtypeStruct``s)."""
    a, b = tree_leaves_with_names(got), tree_leaves_with_names(want)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        assert np.shape(x) == tuple(y.shape), name


@pytest.fixture
def jax_zero_window_cosine(monkeypatch):
    """The JAX FaSNet's ``sliding_cosine`` with the port's rule at an
    all-zero window or target: cosine 0, the exact correlation's value.  The
    JAX function returns its FFT's rounding noise scaled by 1/eps there
    (anything in [-1, 1], different on every FFT library), so no two
    implementations agree on it."""
    import jax.numpy as jnp

    import speechlid_tpu.models.fasnet as jfasnet

    original = jfasnet.sliding_cosine

    def zero_window_cosine(ref, target, eps=1e-8):
        zero = ((jfasnet.sliding_sumsq(ref, target.shape[-1]) == 0)
                | (jnp.linalg.norm(target, axis=-1, keepdims=True) == 0))
        return jnp.where(zero, 0.0, original(ref, target, eps))

    monkeypatch.setattr(jfasnet, "sliding_cosine", zero_window_cosine)


def assert_leaves_close(got, want, rel, what=""):
    """Each leaf of ``got`` (name → tensor or array) within ``rel`` of the
    largest entry of the same leaf of ``want``; → the worst ratio."""
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    worst = 0.0
    for name, w in want.items():
        g, w = _f32(got[name]), _f32(w)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= rel, (what, name, err, rel)
        worst = max(worst, err)
    return worst
