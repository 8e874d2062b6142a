"""Weight bridge: the JAX package's flax variables → this port's ``state_dict``,
and back.

Input: ``{"params": …, "batch_stats": …}`` as nested mappings of arrays
(numpy, or anything ``np.asarray`` takes), e.g. from
``core.checkpoint.load_checkpoint``.  Output: a ``state_dict`` of CPU
tensors for ``MutiLangModel`` (or ``ConformerModel``) of ``models/``.

Layout changes, leaf by leaf:

- ``Dense`` kernel (in, out) → ``Linear.weight`` (out, in);
- 2-D ``Conv`` kernel (kh, kw, in, out) → (out, in, kh, kw); 1-D (k, in, out)
  → (out, in, k);
- the depthwise ``Conv`` kernel (k, 1, C) → the (k, C) the kernel takes;
- ``LayerNorm``/BN ``scale`` → ``weight``; ``batch_stats`` mean/var →
  ``running_mean``/``running_var``;
- the stacked heads ``heads/heads/…`` carry a leading language axis L:
  slice l goes to ``heads.heads.{l}``; ``bilstm`` heads hold flax
  ``OptimizedLSTMCell``s (:func:`lstm_state`: the eight per-gate kernels
  and biases of a direction stacked into torch's ``weight_ih``,
  ``weight_hh`` and one ``bias``), layer j's forward cell
  ``OptimizedLSTMCell_{2j}`` and backward ``_{2j+1}``;
- encoder blocks come unrolled (``block_i/``) or scanned
  (``blocks/ConformerBlock_0/`` with a leading block axis N); both load;
- an SSL featurizer (``featurizer/upstream/…``, or ``featurizer/wavlm/…``
  for ``WavLMModel``; ``featurizer/featurizer/layer_weights``): conv kernels
  (k, in, out) → (out, in, k), the other leaves by name; its encoder layers
  come unrolled (``layers_i/``) or scanned (``layers_0/`` and
  ``layers_rest/WavLMEncoderLayer_0/`` with a leading axis N − 1); both
  load.  It has no BatchNorm, so no ``featurizer`` batch statistics.

:func:`lid_variables` is the reverse direction (``state_dict`` → flax-shaped
numpy trees, unrolled ``block_i`` layout), so that parameters and BatchNorm
statistics after N training steps can be compared leaf by leaf.

The Conv2d subsampling's Dense needs no permutation: the port flattens its
(T', F', C) features frequency-major, as the JAX NHWC convolution does.

The speech-enhancement models (``DPRNNEnhancer``, ``FaSNetTAC``,
``FaSNetOrigin``; :func:`se_state`, :func:`se_variables`) convert by a list
of leaf specs that serves both directions.  flax's ``ConvTranspose`` does
not flip its taps where ``F.conv_transpose1d`` does, so the decoder's
kernel (k, in, out) becomes (in, out, k) with the taps reversed;
``GlobalLayerNorm``'s (1, C, 1…) scale and bias become (C,); flax's
``PReLU_j`` slopes take the port's names.

The cross-entropy classifier zoo (``models/classifier.py`` and what it
builds) converts by one rule for every back-end (:func:`classifier_state`,
:func:`classifier_variables`): a node with a ``kernel`` is a Dense or a
Conv by the kernel's rank; a node with running statistics is a BatchNorm
(its ``scale``/``bias`` only where it has them); MHASTP's ``att_w_i`` /
``att_b_i`` keep their layout; flax's automatic names become the port's
attributes (``Conv_0`` → ``conv``, ``BatchNorm_0`` → ``bn``, ``Dense_0`` →
``fc``, ``ResNet_0`` → ``resnet``).  The task (:func:`lid_ce_state`) nests
an SSL upstream's parameters at ``upstream/upstream`` and the back-end at
``classifier``.

``SELDNet`` (:func:`seldnet_state`, :func:`seldnet_variables`) converts by
the extras zoo's leaf kinds: its 3 × 3 convolutions, flax BatchNorms, Dense
heads, and bidirectional GRU layer i's cells ``GRUCell_{2i}`` (forward) and
``GRUCell_{2i+1}`` (backward) into ``rnns.i.fwd`` / ``rnns.i.bwd``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _take(tree: Mapping, index) -> Mapping:
    """Slice ``index`` off the leading axis of every leaf of ``tree``."""
    return {k: (_take(v, index) if isinstance(v, Mapping) else _a(v)[index])
            for k, v in tree.items()}


def _dense(p: Mapping, prefix: str) -> StateDict:
    out = {prefix + "weight": _a(p["kernel"]).T}
    if "bias" in p:
        out[prefix + "bias"] = _a(p["bias"])
    return out


def _norm(p: Mapping, prefix: str) -> StateDict:
    return {prefix + "weight": _a(p["scale"]), prefix + "bias": _a(p["bias"])}


def conv_module_state(p: Mapping, s: Mapping, prefix: str) -> StateDict:
    """One JAX ``ConformerConvModule`` (params ``p``, batch_stats ``s``)."""
    sd = _norm(p["LayerNorm_0"], prefix + "norm.")
    sd.update(_dense(p["Dense_0"], prefix + "pointwise_in."))
    sd[prefix + "depthwise.weight"] = _a(p["depthwise"]["kernel"])[:, 0, :]
    sd[prefix + "depthwise.bias"] = _a(p["depthwise"]["bias"])
    sd.update(_norm(p["bn"], prefix + "bn."))
    sd[prefix + "bn.running_mean"] = _a(s["bn"]["mean"])
    sd[prefix + "bn.running_var"] = _a(s["bn"]["var"])
    sd.update(_dense(p["Dense_1"], prefix + "pointwise_out."))
    return sd


def block_state(p: Mapping, s: Mapping, prefix: str) -> StateDict:
    """One JAX ``ConformerBlock`` (params ``p``, batch_stats ``s``)."""
    attn = p["attn"]
    sd: StateDict = {}
    sd.update(_norm(p["LayerNorm_0"], prefix + "norm_ff1."))
    sd.update(_dense(p["ff1"]["Dense_0"], prefix + "ff1.fc1."))
    sd.update(_dense(p["ff1"]["Dense_1"], prefix + "ff1.fc2."))
    sd.update(_norm(p["LayerNorm_1"], prefix + "norm_attn."))
    sd.update(_dense(attn["to_q"], prefix + "attn.to_q."))
    sd.update(_dense(attn["to_kv"], prefix + "attn.to_kv."))
    sd.update(_dense(attn["to_out"], prefix + "attn.to_out."))
    sd[prefix + "attn.rel_pos_emb"] = _a(attn["rel_pos_emb"])
    sd.update(conv_module_state(p["conv"], s["conv"], prefix + "conv."))
    sd.update(_norm(p["LayerNorm_2"], prefix + "norm_ff2."))
    sd.update(_dense(p["ff2"]["Dense_0"], prefix + "ff2.fc1."))
    sd.update(_dense(p["ff2"]["Dense_1"], prefix + "ff2.fc2."))
    sd.update(_norm(p["post_norm"], prefix + "post_norm."))
    return sd


def conformer_state(params: Mapping, stats: Mapping, prefix: str = "") -> StateDict:
    """JAX ``ConformerModel`` variables → ``ConformerModel`` state_dict."""
    sd: StateDict = {}
    sub = params["subsample"]
    if "Conv_1" in sub:  # Conv2dSubsampling: (kh, kw, in, out) → (out, in, kh, kw)
        for i in (0, 1):
            conv = sub[f"Conv_{i}"]
            sd[f"{prefix}subsample.conv{i}.weight"] = _a(conv["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{prefix}subsample.conv{i}.bias"] = _a(conv["bias"])
    else:  # Conv1dSubSampling2: (k, in, out) → (out, in, k)
        sd[prefix + "subsample.conv.weight"] = _a(sub["Conv_0"]["kernel"]).transpose(2, 1, 0)
        sd[prefix + "subsample.conv.bias"] = _a(sub["Conv_0"]["bias"])
    sd.update(_dense(sub["Dense_0"], prefix + "subsample.out."))

    if "blocks" in params:  # scanned: one ConformerBlock_0 with a leading N axis
        p_all = params["blocks"]["ConformerBlock_0"]
        s_all = stats["blocks"]["ConformerBlock_0"]
        n_blocks = _a(p_all["post_norm"]["scale"]).shape[0]
        blocks = [(_take(p_all, i), _take(s_all, i)) for i in range(n_blocks)]
    else:
        n_blocks = sum(1 for k in params if k.startswith("block_"))
        blocks = [(params[f"block_{i}"], stats[f"block_{i}"]) for i in range(n_blocks)]
    for i, (p, s) in enumerate(blocks):
        sd.update(block_state(p, s, f"{prefix}blocks.{i}."))
    return sd


SSL_UPSTREAMS = ("upstream", "wavlm")  # SSLFeaturizerModel's, WavLMModel's


def wavlm_layer_state(p: Mapping, prefix: str) -> StateDict:
    """One JAX ``WavLMEncoderLayer`` (params ``p``)."""
    attn = p["self_attn"]
    sd: StateDict = {}
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        sd.update(_dense(attn[proj], f"{prefix}self_attn.{proj}."))
    if "relative_attention_bias" in attn:
        sd[prefix + "self_attn.relative_attention_bias"] = _a(attn["relative_attention_bias"])
    if "grep_linear" in attn:
        sd.update(_dense(attn["grep_linear"], prefix + "self_attn.grep_linear."))
        sd[prefix + "self_attn.grep_a"] = _a(attn["grep_a"])
    for ln in ("self_attn_layer_norm", "final_layer_norm"):
        sd.update(_norm(p[ln], f"{prefix}{ln}."))
    for fc in ("fc1", "fc2"):
        sd.update(_dense(p[fc], f"{prefix}{fc}."))
    return sd


def wavlm_state(params: Mapping, prefix: str = "") -> StateDict:
    """JAX ``WavLM`` params → ``WavLM`` state_dict."""
    sd: StateDict = {}
    for name, node in params["feature_extractor"].items():
        dst = f"{prefix}feature_extractor.{name}."
        if name.startswith("conv_"):  # (k, in, out) → (out, in, k)
            sd[dst + "weight"] = _a(node["kernel"]).transpose(2, 1, 0)
            if "bias" in node:
                sd[dst + "bias"] = _a(node["bias"])
        else:  # gn_0, ln_i
            sd.update(_norm(node, dst))
    sd.update(_norm(params["layer_norm"], prefix + "layer_norm."))
    if "post_extract_proj" in params:
        sd.update(_dense(params["post_extract_proj"], prefix + "post_extract_proj."))
    sd[prefix + "mask_emb"] = _a(params["mask_emb"])
    for leaf in ("weight_v", "weight_g", "bias"):
        sd[f"{prefix}pos_conv.{leaf}"] = _a(params["pos_conv"][leaf])
    sd.update(_norm(params["encoder_layer_norm"], prefix + "encoder_layer_norm."))
    if "layers_rest" in params:  # scanned: layer 0, then N − 1 stacked
        rest = params["layers_rest"]["WavLMEncoderLayer_0"]
        n_rest = _a(rest["fc2"]["bias"]).shape[0]
        layers = [params["layers_0"]] + [_take(rest, i) for i in range(n_rest)]
    else:
        n_layers = sum(1 for k in params if k.startswith("layers_"))
        layers = [params[f"layers_{i}"] for i in range(n_layers)]
    for i, p in enumerate(layers):
        sd.update(wavlm_layer_state(p, f"{prefix}layers.{i}."))
    return sd


def ssl_featurizer_state(params: Mapping, prefix: str = "") -> StateDict:
    """JAX ``SSLFeaturizerModel`` (or ``WavLMModel``) params → its
    state_dict."""
    (upstream,) = [k for k in SSL_UPSTREAMS if k in params]
    sd = wavlm_state(params[upstream], f"{prefix}{upstream}.")
    if "featurizer" in params:
        sd[prefix + "featurizer.layer_weights"] = _a(params["featurizer"]["layer_weights"])
    return sd


def lid_state(variables: Mapping) -> StateDict:
    """JAX ``MutiLangModel`` (Conformer or SSL featurizer; Conformer or
    ``bilstm`` heads) variables → ``MutiLangModel`` state_dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    if "subsample" in params["featurizer"]:
        sd = conformer_state(params["featurizer"], stats.get("featurizer", {}), "featurizer.")
    else:
        sd = ssl_featurizer_state(params["featurizer"], "featurizer.")
    heads_p = params["heads"]["heads"]
    heads_s = stats.get("heads", {}).get("heads", {})  # bilstm heads have no BatchNorm
    n_lang = _a(heads_p["Dense_0"]["bias"]).shape[0]
    n_layers = sum(1 for k in heads_p if k.startswith("block_"))
    n_rnns = sum(1 for k in heads_p if k.startswith("OptimizedLSTMCell_")) // 2
    for lang in range(n_lang):
        p, s = _take(heads_p, lang), _take(heads_s, lang)
        prefix = f"heads.heads.{lang}."
        for j in range(n_layers):
            sd.update(block_state(p[f"block_{j}"], s[f"block_{j}"], f"{prefix}blocks.{j}."))
        for j in range(n_rnns):
            sd.update(_spec_state(("lstm", tuple((c,) for c in _cells(2 * j)),
                                   f"{prefix}rnns.{j}."), p))
        sd.update(_dense(p["Dense_0"], prefix + "out."))
    disc = params["discriminator"]
    sd.update(_dense(disc["Dense_0"], "discriminator.fc1."))
    sd.update(_dense(disc["Dense_1"], "discriminator.fc2."))
    return sd


# ---------------------------------------------------------------------------
# The reverse direction: state_dict → flax-shaped numpy trees
# ---------------------------------------------------------------------------


def _n(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


def _dense_tree(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _n(sd[prefix + "weight"]).T}
    if prefix + "bias" in sd:
        out["bias"] = _n(sd[prefix + "bias"])
    return out


def _norm_tree(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _n(sd[prefix + "weight"]), "bias": _n(sd[prefix + "bias"])}


def block_variables(sd: Mapping, prefix: str):
    """One ``ConformerBlock`` of a state_dict → (params, batch_stats) of the
    JAX ``ConformerBlock``."""
    conv = prefix + "conv."
    params = {
        "LayerNorm_0": _norm_tree(sd, prefix + "norm_ff1."),
        "ff1": {"Dense_0": _dense_tree(sd, prefix + "ff1.fc1."),
                "Dense_1": _dense_tree(sd, prefix + "ff1.fc2.")},
        "LayerNorm_1": _norm_tree(sd, prefix + "norm_attn."),
        "attn": {"to_q": _dense_tree(sd, prefix + "attn.to_q."),
                 "to_kv": _dense_tree(sd, prefix + "attn.to_kv."),
                 "to_out": _dense_tree(sd, prefix + "attn.to_out."),
                 "rel_pos_emb": _n(sd[prefix + "attn.rel_pos_emb"])},
        "conv": {
            "LayerNorm_0": _norm_tree(sd, conv + "norm."),
            "Dense_0": _dense_tree(sd, conv + "pointwise_in."),
            "depthwise": {"kernel": _n(sd[conv + "depthwise.weight"])[:, None, :],
                          "bias": _n(sd[conv + "depthwise.bias"])},
            "bn": _norm_tree(sd, conv + "bn."),
            "Dense_1": _dense_tree(sd, conv + "pointwise_out."),
        },
        "LayerNorm_2": _norm_tree(sd, prefix + "norm_ff2."),
        "ff2": {"Dense_0": _dense_tree(sd, prefix + "ff2.fc1."),
                "Dense_1": _dense_tree(sd, prefix + "ff2.fc2.")},
        "post_norm": _norm_tree(sd, prefix + "post_norm."),
    }
    stats = {"conv": {"bn": {"mean": _n(sd[conv + "bn.running_mean"]),
                             "var": _n(sd[conv + "bn.running_var"])}}}
    return params, stats


def _count(sd: Mapping, prefix: str) -> int:
    """How many ``{prefix}{i}.`` groups a state_dict holds."""
    return len({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})


def _stack(trees):
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def conformer_variables(sd: Mapping, prefix: str = ""):
    """``ConformerModel`` entries of a state_dict → (params, batch_stats) of
    the JAX ``ConformerModel`` (unrolled ``block_i`` layout): the inverse of
    :func:`conformer_state`."""
    params: Dict = {}
    stats: Dict = {}
    sub = prefix + "subsample."
    if sub + "conv1.weight" in sd:
        params["subsample"] = {
            f"Conv_{i}": {"kernel": _n(sd[f"{sub}conv{i}.weight"]).transpose(2, 3, 1, 0),
                          "bias": _n(sd[f"{sub}conv{i}.bias"])} for i in (0, 1)}
    else:
        params["subsample"] = {"Conv_0": {
            "kernel": _n(sd[sub + "conv.weight"]).transpose(2, 1, 0),
            "bias": _n(sd[sub + "conv.bias"])}}
    params["subsample"]["Dense_0"] = _dense_tree(sd, sub + "out.")
    for i in range(_count(sd, prefix + "blocks.")):
        params[f"block_{i}"], stats[f"block_{i}"] = block_variables(sd, f"{prefix}blocks.{i}.")
    return params, stats


def wavlm_layer_variables(sd: Mapping, prefix: str) -> Dict:
    """One ``WavLMEncoderLayer`` of a state_dict → its JAX params."""
    attn = {proj: _dense_tree(sd, f"{prefix}self_attn.{proj}.")
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj")}
    if prefix + "self_attn.relative_attention_bias" in sd:
        attn["relative_attention_bias"] = _n(sd[prefix + "self_attn.relative_attention_bias"])
    if prefix + "self_attn.grep_a" in sd:
        attn["grep_linear"] = _dense_tree(sd, prefix + "self_attn.grep_linear.")
        attn["grep_a"] = _n(sd[prefix + "self_attn.grep_a"])
    params = {"self_attn": attn}
    for ln in ("self_attn_layer_norm", "final_layer_norm"):
        params[ln] = _norm_tree(sd, f"{prefix}{ln}.")
    for fc in ("fc1", "fc2"):
        params[fc] = _dense_tree(sd, f"{prefix}{fc}.")
    return params


def wavlm_variables(sd: Mapping, prefix: str = "") -> Dict:
    """``WavLM`` entries of a state_dict → the JAX ``WavLM`` params
    (unrolled ``layers_i``): the inverse of :func:`wavlm_state`."""
    fe = prefix + "feature_extractor."
    names = sorted({k[len(fe):].split(".")[0] for k in sd if k.startswith(fe)})
    extractor = {}
    for name in names:
        if name.startswith("conv_"):
            extractor[name] = {"kernel": _n(sd[f"{fe}{name}.weight"]).transpose(2, 1, 0)}
            if f"{fe}{name}.bias" in sd:
                extractor[name]["bias"] = _n(sd[f"{fe}{name}.bias"])
        else:
            extractor[name] = _norm_tree(sd, f"{fe}{name}.")
    params = {
        "feature_extractor": extractor,
        "layer_norm": _norm_tree(sd, prefix + "layer_norm."),
        "mask_emb": _n(sd[prefix + "mask_emb"]),
        "pos_conv": {leaf: _n(sd[f"{prefix}pos_conv.{leaf}"])
                     for leaf in ("weight_v", "weight_g", "bias")},
        "encoder_layer_norm": _norm_tree(sd, prefix + "encoder_layer_norm."),
    }
    if prefix + "post_extract_proj.weight" in sd:
        params["post_extract_proj"] = _dense_tree(sd, prefix + "post_extract_proj.")
    for i in range(_count(sd, prefix + "layers.")):
        params[f"layers_{i}"] = wavlm_layer_variables(sd, f"{prefix}layers.{i}.")
    return params


def ssl_featurizer_variables(sd: Mapping, prefix: str = "") -> Dict:
    """``SSLFeaturizerModel`` (or ``WavLMModel``) entries of a state_dict →
    its JAX params: the inverse of :func:`ssl_featurizer_state`."""
    (upstream,) = [k for k in SSL_UPSTREAMS
                   if any(n.startswith(f"{prefix}{k}.") for n in sd)]
    params = {upstream: wavlm_variables(sd, f"{prefix}{upstream}.")}
    if prefix + "featurizer.layer_weights" in sd:
        params["featurizer"] = {"layer_weights": _n(sd[prefix + "featurizer.layer_weights"])}
    return params


def lid_variables(sd: Mapping) -> Dict[str, Dict]:
    """``MutiLangModel`` state_dict → ``{"params", "batch_stats"}`` of the JAX
    ``MutiLangModel`` (unrolled encoder blocks or layers, heads stacked on a
    leading language axis): the inverse of :func:`lid_state`."""
    if "featurizer.subsample.out.weight" in sd:
        feat_p, feat_s = conformer_variables(sd, "featurizer.")
    else:  # an SSL featurizer: no BatchNorm
        feat_p, feat_s = ssl_featurizer_variables(sd, "featurizer."), None
    heads_p, heads_s = [], []
    for lang in range(_count(sd, "heads.heads.")):
        prefix = f"heads.heads.{lang}."
        p, s = {}, {}
        for j in range(_count(sd, prefix + "blocks.")):
            p[f"block_{j}"], s[f"block_{j}"] = block_variables(sd, f"{prefix}blocks.{j}.")
        for j in range(_count(sd, prefix + "rnns.")):
            _spec_variables(("lstm", tuple((c,) for c in _cells(2 * j)), f"{prefix}rnns.{j}."),
                            sd, p)
        p["Dense_0"] = _dense_tree(sd, prefix + "out.")
        heads_p.append(p)
        heads_s.append(s)
    stats = {} if feat_s is None else {"featurizer": feat_s}
    if heads_s[0]:  # Conformer heads' BatchNorm statistics
        stats["heads"] = {"heads": _stack(heads_s)}
    return {
        "params": {
            "featurizer": feat_p,
            "heads": {"heads": _stack(heads_p)},
            "discriminator": {"Dense_0": _dense_tree(sd, "discriminator.fc1."),
                              "Dense_1": _dense_tree(sd, "discriminator.fc2.")},
        },
        "batch_stats": stats,
    }


# ---------------------------------------------------------------------------
# The cross-entropy classifier zoo, both directions
# ---------------------------------------------------------------------------

# flax's automatic module names → the port's attributes
ZOO_NAMES = {"Conv_0": "conv", "BatchNorm_0": "bn", "Dense_0": "fc", "ResNet_0": "resnet"}
ZOO_FLAX_NAMES = {v: k for k, v in ZOO_NAMES.items()}


def _kernel_to_weight(kernel: np.ndarray) -> np.ndarray:
    """Dense (in, out), Conv1d (k, in, out) or Conv2d (kh, kw, in, out) →
    the port's (out, in[, k[, kw]])."""
    return kernel.transpose({2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[kernel.ndim])


def _weight_to_kernel(weight: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_kernel_to_weight`."""
    return weight.transpose({2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}[weight.ndim])


def classifier_state(params: Mapping, batch_stats: Mapping, prefix: str = "") -> StateDict:
    """A JAX classifier-zoo module's variables (``LidClassifier`` or any
    module under it) → the port module's state_dict entries under
    ``prefix``."""
    sd: StateDict = {}
    for key in sorted(set(params) | set(batch_stats)):
        p, s = params.get(key, {}), batch_stats.get(key, {})
        if not isinstance(p, Mapping):  # MHASTP's att_w_i / att_b_i
            sd[prefix + key] = _a(p)
            continue
        name = prefix + ZOO_NAMES.get(key, key) + "."
        if "kernel" in p:
            sd[name + "weight"] = _kernel_to_weight(_a(p["kernel"]))
            if "bias" in p:
                sd[name + "bias"] = _a(p["bias"])
        elif "mean" in s:
            if "scale" in p:
                sd[name + "weight"] = _a(p["scale"])
            if "bias" in p:
                sd[name + "bias"] = _a(p["bias"])
            sd[name + "running_mean"] = _a(s["mean"])
            sd[name + "running_var"] = _a(s["var"])
        else:
            sd.update(classifier_state(p, s, name))
    return sd


def _insert(tree: Dict, path, value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def classifier_variables(sd: Mapping, prefix: str = ""):
    """The port's classifier-zoo entries of a state_dict under ``prefix`` →
    (params, batch_stats) of the JAX module: the inverse of
    :func:`classifier_state`."""
    leaves: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in sd.items():
        if key.startswith(prefix):
            module, _, leaf = key[len(prefix):].rpartition(".")
            leaves.setdefault(module, {})[leaf] = _n(value)
    params: Dict = {}
    stats: Dict = {}
    for module, own in leaves.items():
        path = [ZOO_FLAX_NAMES.get(part, part) for part in module.split(".") if part]
        if "running_mean" in own:
            _insert(stats, path, {"mean": own["running_mean"], "var": own["running_var"]})
            norm = {k: own[v] for k, v in (("scale", "weight"), ("bias", "bias")) if v in own}
            if norm:
                _insert(params, path, norm)
        elif "weight" in own:
            node = {"kernel": _weight_to_kernel(own["weight"])}
            if "bias" in own:
                node["bias"] = own["bias"]
            _insert(params, path, node)
        else:  # MHASTP's att_w_i / att_b_i
            for leaf, value in own.items():
                _insert(params, path + [leaf], value)
    return params, stats


def lid_ce_state(variables: Mapping) -> StateDict:
    """JAX ``LidCrossEntropyTask`` variables (a ``LidClassifier``, or a
    ``PretrainLidClassifier`` with ``upstream`` and ``classifier``) → the
    state_dict of the port task's model."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    if "upstream" not in params:
        return classifier_state(params, stats)
    sd = ssl_featurizer_state(params["upstream"], "upstream.")
    sd.update(classifier_state(params["classifier"], stats.get("classifier", {}),
                               "classifier."))
    return sd


def lid_ce_variables(sd: Mapping) -> Dict[str, Dict]:
    """The port task's model state_dict → ``{"params", "batch_stats"}`` of
    the JAX ``LidCrossEntropyTask``: the inverse of :func:`lid_ce_state`."""
    if not any(k.startswith("upstream.") for k in sd):
        params, stats = classifier_variables(sd)
        return {"params": params, "batch_stats": stats}
    params, stats = classifier_variables(sd, "classifier.")
    return {"params": {"upstream": ssl_featurizer_variables(sd, "upstream."),
                       "classifier": params},
            "batch_stats": {"classifier": stats} if stats else {}}


def load_into(module: torch.nn.Module, state: StateDict) -> None:
    """Copy a converted state into ``module`` (strict: every key and shape
    must match)."""
    module.load_state_dict(
        {k: torch.tensor(v) for k, v in state.items()},
        strict=True,
    )


# ---------------------------------------------------------------------------
# flax's bidirectional OptimizedLSTMCell, the SE models and the bilstm heads
# ---------------------------------------------------------------------------

LSTM_GATES = ("i", "f", "g", "o")  # flax's and torch's order of the stacked gates


def lstm_state(cell: Mapping, prefix: str) -> StateDict:
    """One flax ``OptimizedLSTMCell`` (input kernels ``ii/if/ig/io`` (D, H),
    recurrent kernels ``hi/hf/hg/ho`` (H, H) with biases) → a
    ``models/rnn.LSTMDirection`` (``weight_ih`` (4H, D), ``weight_hh``
    (4H, H), ``bias`` (4H,))."""
    return {
        prefix + "weight_ih": np.concatenate([_a(cell["i" + g]["kernel"]).T for g in LSTM_GATES]),
        prefix + "weight_hh": np.concatenate([_a(cell["h" + g]["kernel"]).T for g in LSTM_GATES]),
        prefix + "bias": np.concatenate([_a(cell["h" + g]["bias"]) for g in LSTM_GATES]),
    }


def lstm_variables(sd: Mapping, prefix: str) -> Dict:
    """The inverse of :func:`lstm_state`."""
    w_ih, w_hh, bias = (_n(sd[prefix + k]) for k in ("weight_ih", "weight_hh", "bias"))
    h = w_hh.shape[1]
    cell = {}
    for j, g in enumerate(LSTM_GATES):
        rows = slice(j * h, (j + 1) * h)
        cell["i" + g] = {"kernel": w_ih[rows].T}
        cell["h" + g] = {"kernel": w_hh[rows].T, "bias": bias[rows]}
    return cell


def _cells(first: int):
    """The flax names of a bidirectional LSTM's two cells (forward first):
    flax names the cells after the module that builds them, in order."""
    return (f"OptimizedLSTMCell_{first}", f"OptimizedLSTMCell_{first + 1}")


def _dprnn_specs(n_blocks: int) -> list:
    specs = [("conv", ("encoder",), "encoder."), ("convT", ("decoder",), "decoder."),
             ("dense", ("mask_proj",), "mask_proj.")]
    for i in range(n_blocks):
        src, dst = (f"dp_{i}",), f"blocks.{i}."
        for j, part in enumerate(("intra", "inter")):
            specs += [("lstm", tuple(src + (c,) for c in _cells(2 * j)), f"{dst}{part}_rnn."),
                      ("dense", src + (f"{part}_proj",), f"{dst}{part}_proj."),
                      ("norm", src + (f"{part}_ln",), f"{dst}{part}_ln.")]
    return specs


def _bf_specs(src: tuple, dst: str, n_layers: int, use_tac: bool) -> list:
    d = src + ("dprnn",)
    specs = [("dense", src + (name,), f"{dst}{name}.") for name in ("bottleneck", "out", "gate")]
    specs += [("prelu", d + ("PReLU_0",), f"{dst}dprnn.act."),
              ("dense", d + ("output",), f"{dst}dprnn.output.")]
    for i in range(n_layers):
        for part in ("row", "col"):
            lstm = d + (f"{part}_{i}",)
            specs += [("lstm", tuple(lstm + (c,) for c in _cells(0)), f"{dst}dprnn.{part}.{i}.rnn."),
                      ("dense", lstm + ("proj",), f"{dst}dprnn.{part}.{i}.proj."),
                      ("gln", d + (f"{part}_norm_{i}",), f"{dst}dprnn.{part}_norm.{i}.", 4)]
        if use_tac:
            tac, tdst = d + (f"tac_{i}",), f"{dst}dprnn.tac.{i}."
            for j, name in enumerate(("transform", "average", "concat")):
                specs += [("dense", tac + (name,), f"{tdst}{name}."),
                          ("prelu", tac + (f"PReLU_{j}",), f"{tdst}{name}_act.")]
            specs.append(("gln", tac + ("norm",), f"{tdst}norm.", 4))
    return specs


def _fasnet_specs(stages, n_layers: int, use_tac: bool) -> list:
    specs = [("dense", ("encoder",), "encoder."), ("gln", ("enc_norm",), "enc_norm.", 3)]
    for stage in stages:
        specs += _bf_specs((stage,), f"{stage}.", n_layers, use_tac)
    return specs


def _se_specs(kind: str, n: int, use_tac: bool = True) -> list:
    if kind == "dprnn":
        return _dprnn_specs(n)
    return _fasnet_specs(("bf",) if kind == "fasnet_tac" else ("ref_bf", "other_bf"), n, use_tac)


def _get(tree: Mapping, path):
    for part in path:
        tree = tree[part]
    return tree


def _spec_state(spec, params: Mapping) -> StateDict:
    kind, path, prefix = spec[:3]
    if kind == "lstm":
        return {**lstm_state(_get(params, path[0]), prefix + "fwd."),
                **lstm_state(_get(params, path[1]), prefix + "bwd.")}
    p = _get(params, path)
    if kind == "dense":
        return _dense(p, prefix)
    if kind == "norm":
        return _norm(p, prefix)
    if kind == "prelu":
        return {prefix + "negative_slope": _a(p["negative_slope"])}
    if kind == "gln":
        return {prefix + "weight": _a(p["scale"]).reshape(-1),
                prefix + "bias": _a(p["bias"]).reshape(-1)}
    kernel = _a(p["kernel"])
    # conv (k, in, out) → (out, in, k); flax's ConvTranspose (k, in, out) does
    # not flip its taps, F.conv_transpose1d does: (in, out, k) reversed
    weight = kernel.transpose(2, 1, 0) if kind == "conv" else kernel.transpose(1, 2, 0)[..., ::-1]
    return {prefix + "weight": np.ascontiguousarray(weight), prefix + "bias": _a(p["bias"])}


def _spec_variables(spec, sd: Mapping, params: Dict) -> None:
    kind, path, prefix = spec[:3]
    if kind == "lstm":
        _insert(params, path[0], lstm_variables(sd, prefix + "fwd."))
        _insert(params, path[1], lstm_variables(sd, prefix + "bwd."))
        return
    if kind == "dense":
        node = _dense_tree(sd, prefix)
    elif kind == "norm":
        node = _norm_tree(sd, prefix)
    elif kind == "prelu":
        node = {"negative_slope": _n(sd[prefix + "negative_slope"])}
    elif kind == "gln":
        shape = (1, -1) + (1,) * (spec[3] - 2)
        node = {"scale": _n(sd[prefix + "weight"]).reshape(shape),
                "bias": _n(sd[prefix + "bias"]).reshape(shape)}
    else:
        weight = _n(sd[prefix + "weight"])
        kernel = weight.transpose(2, 1, 0) if kind == "conv" else weight[..., ::-1].transpose(2, 0, 1)
        node = {"kernel": np.ascontiguousarray(kernel), "bias": _n(sd[prefix + "bias"])}
    _insert(params, path, node)


def se_kind(params: Mapping) -> str:
    """The SE model a flax params tree holds: ``dprnn``, ``fasnet_tac`` or
    ``fasnet_origin``."""
    if "decoder" in params:
        return "dprnn"
    return "fasnet_tac" if "bf" in params else "fasnet_origin"


def se_state(variables: Mapping) -> StateDict:
    """JAX ``DPRNNEnhancer``, ``FaSNetTAC`` or ``FaSNetOrigin`` variables →
    the port model's state_dict."""
    params = variables["params"]
    kind = se_kind(params)
    if kind == "dprnn":
        specs = _se_specs(kind, sum(1 for k in params if k.startswith("dp_")))
    else:
        dprnn = params["bf" if kind == "fasnet_tac" else "ref_bf"]["dprnn"]
        specs = _se_specs(kind, sum(1 for k in dprnn if k.startswith("col_norm_")),
                          "tac_0" in dprnn)
    sd: StateDict = {}
    for spec in specs:
        sd.update(_spec_state(spec, params))
    return sd


def se_variables(sd: Mapping) -> Dict[str, Dict]:
    """The port SE model's state_dict → ``{"params"}`` of the JAX model: the
    inverse of :func:`se_state`."""
    if "decoder.weight" in sd:
        specs = _se_specs("dprnn", _count(sd, "blocks."))
    else:
        kind = "fasnet_tac" if "bf.out.weight" in sd else "fasnet_origin"
        stage = "bf." if kind == "fasnet_tac" else "ref_bf."
        specs = _se_specs(kind, _count(sd, stage + "dprnn.row."),
                          any(k.startswith(stage + "dprnn.tac.") for k in sd))
    params: Dict = {}
    for spec in specs:
        _spec_variables(spec, sd, params)
    return {"params": params}


# ---------------------------------------------------------------------------
# flax's GRUCell, and the secondary tasks' model zoo (models/extras.py)
# ---------------------------------------------------------------------------

GRU_GATES = ("r", "z", "n")  # flax's and torch's order of the stacked gates


def gru_state(cell: Mapping, prefix: str) -> StateDict:
    """One flax ``GRUCell`` (input kernels ``ir/iz/in`` (D, H) with biases,
    recurrent kernels ``hr/hz`` (H, H) without and ``hn`` with one) → a
    ``models/rnn.GRUDirection`` (``weight_ih`` (3H, D), ``weight_hh`` (3H, H),
    ``bias_ih`` (3H,), ``bias_hn`` (H,))."""
    return {
        prefix + "weight_ih": np.concatenate([_a(cell["i" + g]["kernel"]).T for g in GRU_GATES]),
        prefix + "weight_hh": np.concatenate([_a(cell["h" + g]["kernel"]).T for g in GRU_GATES]),
        prefix + "bias_ih": np.concatenate([_a(cell["i" + g]["bias"]) for g in GRU_GATES]),
        prefix + "bias_hn": _a(cell["hn"]["bias"]),
    }


def gru_variables(sd: Mapping, prefix: str) -> Dict:
    """The inverse of :func:`gru_state`."""
    w_ih, w_hh, b_ih = (_n(sd[prefix + k]) for k in ("weight_ih", "weight_hh", "bias_ih"))
    h = w_hh.shape[1]
    cell = {}
    for j, g in enumerate(GRU_GATES):
        rows = slice(j * h, (j + 1) * h)
        cell["i" + g] = {"kernel": w_ih[rows].T, "bias": b_ih[rows]}
        cell["h" + g] = {"kernel": w_hh[rows].T}
    cell["hn"]["bias"] = _n(sd[prefix + "bias_hn"])
    return cell


def _extras_specs(model: torch.nn.Module) -> list:
    """(kind, flax path, port prefix) of every leaf group of a
    ``models/extras.py`` model.  flax names the cells that ``nn.RNN`` wraps
    after their class, at the level of the module that builds them
    (``OptimizedLSTMCell_j``, ``GRUCell_0``), and unnamed Dense / Conv
    layers in the order they are built."""
    from speechlid_tpu_torch.models import extras as mx

    def dense(flax: str, port: str):
        return ("dense", (flax,), port + ".")

    if isinstance(model, mx.BaseCNN):
        return [("conv", ("Conv_0",), "conv1."), ("conv", ("Conv_1",), "conv2."),
                dense("Dense_0", "fc1"), dense("Dense_1", "fc2")]
    if isinstance(model, mx.LSTMLM):
        specs = [("embed", ("Embed_0",), "embed.")]
        for i in range(len(model.rnn)):
            if model.bidirectional:
                specs.append(("lstm", ((f"OptimizedLSTMCell_{2 * i}",),
                                       (f"OptimizedLSTMCell_{2 * i + 1}",)), f"rnn.{i}."))
            else:
                specs.append(("lstm1", (f"OptimizedLSTMCell_{i}",), f"rnn.{i}.cell."))
        return specs + [dense("Dense_0", "out")]
    if isinstance(model, mx.ResNet1D):
        specs = [("conv", ("stem",), "stem.")]
        for i in range(len(model.blocks)):
            for part in ("bn1", "conv1", "bn2", "conv2"):
                specs.append(("bn" if part.startswith("bn") else "conv", (f"block_{i}", part),
                              f"blocks.{i}.{part}."))
        specs += [("bn", ("bn_final",), "bn_final."), ("dense", ("cls",), "cls.")]
        if model.gru is not None:
            specs.append(("gru", ("GRUCell_0",), "gru.cell."))
        if model.snr is not None:
            specs.append(("dense", ("snr",), "snr."))
        return specs
    if isinstance(model, mx.ForecastMLP):
        return [dense("Dense_0", "fc1"), dense("Dense_1", "fc2"), dense("Dense_2", "out")]
    if isinstance(model, mx.ForecastLSTM):
        return [("lstm1", (f"OptimizedLSTMCell_{i}",), f"lstm.{i}.cell.")
                for i in range(len(model.lstm))] + [dense("Dense_0", "out")]
    if isinstance(model, mx.ForecastCnnLSTM):
        return [("conv", ("Conv_0",), "conv1."), ("conv", ("Conv_1",), "conv2."),
                ("lstm1", ("OptimizedLSTMCell_0",), "lstm.cell."), dense("Dense_0", "out")]
    if isinstance(model, mx.ForecastTCN):
        specs = []
        for i, block in enumerate(model.tcn):
            specs += [("conv", (f"tcn_{i}", "conv1"), f"tcn.{i}.conv1."),
                      ("conv", (f"tcn_{i}", "conv2"), f"tcn.{i}.conv2.")]
            if block.proj is not None:
                specs.append(("dense", (f"tcn_{i}", "proj"), f"tcn.{i}.proj."))
        return specs + [dense("Dense_0", "out")]
    if isinstance(model, mx.ForecastTransformer):
        n = len(model.layers)
        specs = [dense("Dense_0", "proj"), ("param", ("pos_emb",), "pos_emb")]
        for i in range(n):
            pre = f"layers.{i}."
            specs += [("norm", (f"ln1_{i}",), pre + "ln1."), ("attn", (f"attn_{i}",), pre + "attn."),
                      ("norm", (f"ln2_{i}",), pre + "ln2."),
                      dense(f"Dense_{1 + 2 * i}", pre + "ff1"),
                      dense(f"Dense_{2 + 2 * i}", pre + "ff2")]
        return specs + [dense(f"Dense_{2 * n + 1}", "out")]
    raise TypeError(f"not a model of models/extras.py: {type(model).__name__}")


ATTN_PROJECTIONS = ("query", "key", "value")


def _extras_leaf_state(kind: str, path, prefix: str, params: Mapping,
                       stats: Mapping) -> StateDict:
    if kind == "lstm":
        return {**lstm_state(_get(params, path[0]), prefix + "fwd."),
                **lstm_state(_get(params, path[1]), prefix + "bwd.")}
    p = _get(params, path)
    if kind == "lstm1":
        return lstm_state(p, prefix)
    if kind == "gru":
        return gru_state(p, prefix)
    if kind == "dense":
        return _dense(p, prefix)
    if kind == "norm":
        return _norm(p, prefix)
    if kind == "embed":
        return {prefix + "weight": _a(p["embedding"])}
    if kind == "param":
        return {prefix: _a(p)}
    if kind == "conv":
        return {prefix + "weight": np.ascontiguousarray(_kernel_to_weight(_a(p["kernel"]))),
                prefix + "bias": _a(p["bias"])}
    if kind == "bn":
        s = _get(stats, path)
        return {**_norm(p, prefix), prefix + "running_mean": _a(s["mean"]),
                prefix + "running_var": _a(s["var"])}
    # attn: DenseGeneral q/k/v (d, heads, d/heads) and out (heads, d/heads, d)
    sd: StateDict = {}
    for name in ATTN_PROJECTIONS:
        kernel = _a(p[name]["kernel"])
        sd[f"{prefix}{name}.weight"] = kernel.reshape(kernel.shape[0], -1).T
        sd[f"{prefix}{name}.bias"] = _a(p[name]["bias"]).reshape(-1)
    kernel = _a(p["out"]["kernel"])
    sd[prefix + "out.weight"] = kernel.reshape(-1, kernel.shape[-1]).T
    sd[prefix + "out.bias"] = _a(p["out"]["bias"])
    return sd


def _extras_leaf_variables(kind: str, path, prefix: str, sd: Mapping, params: Dict,
                           stats: Dict, heads: int = 0) -> None:
    if kind == "lstm":
        _insert(params, path[0], lstm_variables(sd, prefix + "fwd."))
        _insert(params, path[1], lstm_variables(sd, prefix + "bwd."))
        return
    if kind == "lstm1":
        node = lstm_variables(sd, prefix)
    elif kind == "gru":
        node = gru_variables(sd, prefix)
    elif kind == "dense":
        node = _dense_tree(sd, prefix)
    elif kind == "norm":
        node = _norm_tree(sd, prefix)
    elif kind == "embed":
        node = {"embedding": _n(sd[prefix + "weight"])}
    elif kind == "param":
        node = _n(sd[prefix])
    elif kind == "conv":
        node = {"kernel": np.ascontiguousarray(_weight_to_kernel(_n(sd[prefix + "weight"]))),
                "bias": _n(sd[prefix + "bias"])}
    elif kind == "bn":
        node = _norm_tree(sd, prefix)
        _insert(stats, path, {"mean": _n(sd[prefix + "running_mean"]),
                              "var": _n(sd[prefix + "running_var"])})
    else:  # attn
        node = {}
        for name in ATTN_PROJECTIONS:
            weight = _n(sd[f"{prefix}{name}.weight"])  # (heads·hd, d)
            d = weight.shape[1]
            node[name] = {"kernel": weight.T.reshape(d, heads, -1),
                          "bias": _n(sd[f"{prefix}{name}.bias"]).reshape(heads, -1)}
        weight = _n(sd[prefix + "out.weight"])  # (d, heads·hd)
        node["out"] = {"kernel": weight.T.reshape(heads, -1, weight.shape[0]),
                       "bias": _n(sd[prefix + "out.bias"])}
    _insert(params, path, node)


def extras_state(variables: Mapping, model: torch.nn.Module) -> StateDict:
    """JAX ``models/extras.py`` variables (``params`` and, for ``ResNet1D``,
    ``batch_stats``) → the state_dict of the port's ``model`` of the same
    kind and shape."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    for kind, path, prefix in _extras_specs(model):
        sd.update(_extras_leaf_state(kind, path, prefix, params, stats))
    return sd


def extras_variables(sd: Mapping, model: torch.nn.Module) -> Dict[str, Dict]:
    """The port ``model``'s state_dict → ``{"params"[, "batch_stats"]}`` of
    the JAX model: the inverse of :func:`extras_state`."""
    params: Dict = {}
    stats: Dict = {}
    for kind, path, prefix in _extras_specs(model):
        heads = 0
        if kind == "attn":
            heads = model.get_submodule(prefix.rstrip(".")).heads
        _extras_leaf_variables(kind, path, prefix, sd, params, stats, heads)
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


# ---------------------------------------------------------------------------
# SELDNet (models/seldnet.py)
# ---------------------------------------------------------------------------


def _seldnet_specs(model: torch.nn.Module) -> list:
    """(kind, flax path, port prefix) of every leaf group of a
    ``models/seldnet.SELDNet``.  flax names the GRU cells that
    ``nn.Bidirectional(nn.RNN(…), nn.RNN(…))`` wraps at SELDNet's level, in
    the order they are built: layer i's forward cell ``GRUCell_{2i}``, its
    backward cell ``GRUCell_{2i+1}``."""
    specs = []
    for i in range(len(model.convs)):
        specs += [("conv", (f"conv_{i}",), f"convs.{i}."), ("bn", (f"bn_{i}",), f"bns.{i}.")]
    for i in range(len(model.rnns)):
        specs += [("gru", (f"GRUCell_{2 * i}",), f"rnns.{i}.fwd."),
                  ("gru", (f"GRUCell_{2 * i + 1}",), f"rnns.{i}.bwd.")]
    for head in ("sed", "doa"):
        specs += [("dense", (f"{head}_fc{j}",), f"{head}.fc.{j}.")
                  for j in range(len(getattr(model, head).fc))]
        specs.append(("dense", (f"{head}_out",), f"{head}.out."))
    return specs


def seldnet_state(variables: Mapping, model: torch.nn.Module) -> StateDict:
    """JAX ``SELDNet`` variables (``params``, ``batch_stats``) → the
    state_dict of the port's ``model`` of the same preset and shape."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    for kind, path, prefix in _seldnet_specs(model):
        sd.update(_extras_leaf_state(kind, path, prefix, params, stats))
    return sd


def seldnet_variables(sd: Mapping, model: torch.nn.Module) -> Dict[str, Dict]:
    """The inverse of :func:`seldnet_state`."""
    params: Dict = {}
    stats: Dict = {}
    for kind, path, prefix in _seldnet_specs(model):
        _extras_leaf_variables(kind, path, prefix, sd, params, stats)
    return {"params": params, "batch_stats": stats}
