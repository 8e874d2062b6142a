"""Plain float32 wav2vec 2.0 encoder of the benchmark's reference, in the
layout of XLS-R and the Large models (arXiv:2006.11477, arXiv:2111.09296;
fairseq's ``Wav2Vec2Model`` with ``extractor_mode="layer_norm"`` and
``layer_norm_first=True``).

The wave normalised over its row → conv extractor (VALID strided convs with
a bias, each followed by a LayerNorm over the channels and exact GELU) →
LayerNorm → projection → [in training: time span masks set to
``mask_emb``, then channel span masks zeroed] → + weight-normed grouped
conv positional embedding (GELU) → dropout → pre-LN layers → LayerNorm.
A layer: ``x + dropout(attention(LN(x)))``, then ``x +
dropout(fc2(GELU(fc1(LN(x)))))``; the attention has biased q, k, v and out
projections, the queries scaled by d^-1/2, and no position bias.
LayerNorm eps 1e-5.  Random draws (span masks, dropout) are made in the
program's order and shapes from the generator the benchmark hands to both.

In training the parameters that the configuration's
``freeze_featurizer_epoch`` holds at its steady epoch, the conv extractor
and ``post_extract_proj``, enter detached, so no gradient reaches them, as
fairseq's fine-tuning of XLS-R freezes its feature encoder.

Departures from the paper and fairseq, each the program's:

- the wave is normalised over its whole padded row, ``(x − mean) /
  sqrt(var + 1e-5)`` with the padding in the statistics, where fairseq
  normalises each utterance before it is padded;
- padded frames are neither zeroed before the positional conv nor masked
  out of the attention (the program's ``mask_attention=False``);
- the span masks follow the program's law: floor(p·len/L + u) spans of L
  frames (at least 2 in time, none required over the channels) at uniform
  starts, overlaps allowed, time spans cut at each row's length; fairseq
  draws them with numpy by its own rules;
- the even positional kernel is padded K/2 on the left and K/2 − 1 on the
  right: the T outputs that fairseq keeps after dropping its last frame.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from reference.conformer import Params, dropout, linear
# the family interface's ``inputs`` (the normalised wave) and ``width`` are
# WavLM's
from reference.wavlm import conv_layers, inputs, ln, out_lengths, span_mask, width  # noqa: F401

NORM_EPS = 1e-5
# parameter-name parts that the task's freeze mask holds through
# ``freeze_featurizer_epoch`` in an SSL featurizer
EXTRACTOR_PARTS = (".feature_extractor.", ".post_extract_proj.")


def frozen(cfg: dict, name: str) -> bool:
    """Whether the configuration's freeze holds parameter ``name`` at its
    steady epoch."""
    return (cfg["trainer"]["steady_epoch"] <= cfg["task"]["freeze_featurizer_epoch"]
            and name.startswith("featurizer.") and any(p in name for p in EXTRACTOR_PARTS))


def layer(x, p: Params, pre: str, cfg: dict, gen: Optional[torch.Generator]):
    b, t, c = x.shape
    h = cfg["encoder_attention_heads"]
    d = c // h
    y = ln(x, p, pre + "self_attn_layer_norm")
    q = (linear(y, p, pre + "self_attn.q_proj") * d ** -0.5).view(b, t, h, d).transpose(1, 2)
    k = linear(y, p, pre + "self_attn.k_proj").view(b, t, h, d).transpose(1, 2)
    v = linear(y, p, pre + "self_attn.v_proj").view(b, t, h, d).transpose(1, 2)
    probs = dropout(torch.softmax(q @ k.transpose(-1, -2), dim=-1), cfg["attention_dropout"], gen)
    y = linear((probs @ v).transpose(1, 2).reshape(b, t, c), p, pre + "self_attn.out_proj")
    x = x + dropout(y, cfg["dropout"], gen)
    y = F.gelu(linear(ln(x, p, pre + "final_layer_norm"), p, pre + "fc1"))
    y = linear(dropout(y, cfg["activation_dropout"], gen), p, pre + "fc2")
    return x + dropout(y, cfg["dropout"], gen)


def featurize(wav, lengths, p: Params, cfg: dict, gen: Optional[torch.Generator] = None):
    """(B, T) wave → ((B, T', C), T' lengths).  ``gen`` given: training
    mode (span masks, dropout)."""
    if cfg["extractor_mode"] != "layer_norm" or not cfg["layer_norm_first"]:
        raise ValueError("the wav2vec 2.0 reference is the layer-norm extractor under "
                         "pre-LN layers (XLS-R, Large)")
    pre = "featurizer.upstream."
    if cfg["normalize"]:
        mean = wav.mean(dim=-1, keepdim=True)
        var = wav.var(dim=-1, keepdim=True, unbiased=False)
        wav = (wav - mean) / torch.sqrt(var + NORM_EPS)
    y = wav[:, None, :]
    for i, (_, _, s) in enumerate(conv_layers(cfg)):
        conv = f"{pre}feature_extractor.conv_{i}"
        y = F.conv1d(y, p[conv + ".weight"], p.get(conv + ".bias"), stride=s)
        y = F.gelu(ln(y.transpose(1, 2), p, f"{pre}feature_extractor.ln_{i}")).transpose(1, 2)
    x = linear(ln(y.transpose(1, 2), p, pre + "layer_norm"), p, pre + "post_extract_proj")
    x = dropout(x, cfg["dropout_input"], gen)
    feat_len = out_lengths(lengths, cfg)
    b, t, c = x.shape
    if gen is not None and cfg["mask_prob"] > 0:
        spans = span_mask(gen, feat_len, t, cfg["mask_prob"], cfg["mask_length"])
        x = torch.where(spans[:, :, None], p[pre + "mask_emb"], x)
    if gen is not None and cfg["mask_channel_prob"] > 0:
        channels = torch.full((b,), c, dtype=torch.long, device=x.device)
        spans = span_mask(gen, channels, c, cfg["mask_channel_prob"],
                          cfg["mask_channel_length"], min_masks=0)
        x = x.masked_fill(spans[:, None, :], 0.0)
    v, g = p[pre + "pos_conv.weight_v"], p[pre + "pos_conv.weight_g"]
    w = v / torch.sqrt(v.square().sum(dim=(0, 1), keepdim=True) + 1e-12) * g
    kpos = w.shape[-1]
    pos = F.conv1d(F.pad(x.transpose(1, 2), (kpos // 2, kpos // 2 - 1)), w,
                   p[pre + "pos_conv.bias"], groups=cfg["conv_pos_groups"])
    x = dropout(x + F.gelu(pos).transpose(1, 2), cfg["dropout"], gen)
    if gen is not None and cfg["encoder_layerdrop"] > 0:
        raise NotImplementedError("layer drop: the reference follows no such draw")
    for i in range(cfg["encoder_layers"]):
        x = layer(x, p, f"{pre}layers.{i}.", cfg, gen)
    return ln(x, p, pre + "encoder_layer_norm"), feat_len


# ------------------------------------------- the featurizer family interface

def encode(cfg: dict, p: Params, x, lengths, gen=None):
    if gen is not None:
        p = {k: (v.detach() if frozen(cfg, k) else v) for k, v in p.items()}
    return featurize(x, lengths, p, cfg["ssl_config"], gen)


def flops(cfg: dict, samples: int):
    """(products of the extractor and the encoder, frames out) for one row
    of ``samples`` valid samples: the convs, the projection, the positional
    conv, q, k, v and out, q·k and p·v, the FFN."""
    ssl = cfg["ssl_config"]
    t, cin, total = samples, 1, 0.0
    for cout, k, s in conv_layers(ssl):
        t = (t - k) // s + 1
        total += 2.0 * t * cout * cin * k
        cin = cout
    c, ffn = ssl["encoder_embed_dim"], ssl["encoder_ffn_embed_dim"]
    total += 2.0 * t * cin * c + 2.0 * t * c * (c // ssl["conv_pos_groups"]) * ssl["conv_pos"]
    layer_flops = 4 * 2.0 * t * c * c + 2 * 2.0 * t * t * c + 2 * 2.0 * t * c * ffn
    return total + ssl["encoder_layers"] * layer_flops, t
