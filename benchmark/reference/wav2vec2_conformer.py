"""Plain float32 wav2vec 2.0 Conformer encoder with relative positions of
the benchmark's reference (arXiv:2010.05171; HF's ``Wav2Vec2ConformerModel``
with ``position_embeddings_type="relative"``, the layout of
facebook/wav2vec2-conformer-rel-pos-large).

The wave normalised over its row → conv extractor (VALID strided convs with
a bias, each followed by a LayerNorm over the channels and exact GELU) →
LayerNorm → projection → [in training: time span masks set to
``mask_emb``, then channel span masks zeroed] → dropout → Conformer layers
→ LayerNorm.  No positional conv: HF builds one and never calls it.

A layer: ``x + ½·FFN(LN x)``, ``x + dropout(MHSA(LN x))``, ``x +
Conv(x)``, ``x + ½·FFN(LN x)``, then LN.  FFN: Linear → swish → dropout
(``activation_dropout``) → Linear → dropout.  Conv: LN → pointwise C → 2C
→ GLU → depthwise (k taps, 'SAME') → BatchNorm → swish → pointwise C → C,
none of them biased, → dropout.  MHSA, HF's ``_apply_relative_embeddings``
written out: per head, with the sinusoidal table PE of the relative
positions n − 1 … −(n − 1) (HF's order) and p = linear_pos(PE) (no bias),

    S = [(q + u)·kᵀ + rel_shift((q + v)·pᵀ)] / √d,

the rel-shift by HF's zero column and reshape, a softmax, dropout on the
probabilities, ·v, the out projection.  q, k, v (the program's ``to_q``
and ``to_kv``) and out have biases; u and v are ``pos_bias_u`` and
``pos_bias_v``.  LayerNorm and BatchNorm eps 1e-5.  Random draws (span
masks, dropout) are made in the program's order and shapes from the
generator the benchmark hands to both.

In training the parameters that the configuration's
``freeze_featurizer_epoch`` holds at its steady epoch, the conv extractor
and ``post_extract_proj``, enter detached (``reference/wav2vec2.frozen``),
and each layer's activations are recomputed in the backward pass
(``torch.utils.checkpoint``, the generator's draws repeated from its state
at the forward), so that 24 layers at 649 frames fit on one card beside
the program's state the check keeps; the numbers are the forward's.

Departures from HF and fairseq, each the program's:

- the wave is normalised over its whole padded row, ``(x − mean) /
  sqrt(var + 1e-5)`` with the padding in the statistics, where fairseq
  normalises each utterance before it is padded;
- padded frames are neither zeroed nor masked: they take part in the
  attention, the depthwise conv and the BatchNorm (the program's
  ``mask_attention=False``), where HF with an attention mask zeroes them
  and masks them out of the keys;
- the span masks follow the program's law: floor(p·len/L + u) spans of L
  frames (at least 2 in time, none required over the channels) at uniform
  starts, overlaps allowed, time spans cut at each row's length; fairseq
  and HF draw them with numpy by their own rules;
- the training BatchNorm normalises with the batch's statistics over every
  frame, padded ones too (biased variance); its running statistics are
  state the check does not compare.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.conformer import Params, batch_norm, dropout, linear, swish
# the family interface's ``inputs`` (the normalised wave) is WavLM's
from reference.wavlm import conv_layers, inputs, ln, out_lengths, span_mask  # noqa: F401
from reference.wav2vec2 import NORM_EPS, frozen


def relative_embeddings(t: int, dim: int) -> torch.Tensor:
    """(2t − 1, dim): HF's ``Wav2Vec2ConformerRelPositionalEmbedding`` at
    length t, the positions t − 1 … −(t − 1) in that order."""
    position = torch.arange(0, t, dtype=torch.int64).float().unsqueeze(1)
    div_term = torch.exp(torch.arange(0, dim, 2, dtype=torch.int64).float()
                         * -(math.log(10000.0) / dim))
    positive, negative = torch.zeros(t, dim), torch.zeros(t, dim)
    positive[:, 0::2] = torch.sin(position * div_term)
    positive[:, 1::2] = torch.cos(position * div_term)
    negative[:, 0::2] = torch.sin(-1 * position * div_term)
    negative[:, 1::2] = torch.cos(-1 * position * div_term)
    return torch.cat([torch.flip(positive, [0]), negative[1:]])


def rel_shift(bd: torch.Tensor) -> torch.Tensor:
    """HF's shift of (b, h, t, 2t − 1) scores over the positions t − 1 …
    −(t − 1): a zero column in front, the rows re-cut, the first t kept, so
    that (i, j) holds the score of position i − j."""
    b, h, t, w = bd.shape
    padded = torch.cat([bd.new_zeros(b, h, t, 1), bd], dim=-1).view(b, h, w + 1, t)
    return padded[:, :, 1:].view_as(bd)[:, :, :, :w // 2 + 1]


def attention(x, pe, p: Params, pre: str, heads: int, rate: float,
              gen: Optional[torch.Generator]):
    b, t, c = x.shape
    d = c // heads
    q = linear(x, p, pre + "to_q").view(b, t, heads, d)
    k, v = linear(x, p, pre + "to_kv").chunk(2, dim=-1)
    k = k.reshape(b, t, heads, d).transpose(1, 2)
    v = v.reshape(b, t, heads, d).transpose(1, 2)
    pos = F.linear(pe, p[pre + "linear_pos.weight"]).view(2 * t - 1, heads, d)
    pos = pos.permute(1, 2, 0)                                    # (h, d, 2t − 1)
    q_u = (q + p[pre + "pos_bias_u"]).transpose(1, 2)
    q_v = (q + p[pre + "pos_bias_v"]).transpose(1, 2)
    scores = (q_u @ k.transpose(-2, -1) + rel_shift(q_v @ pos)) / math.sqrt(d)
    probs = dropout(torch.softmax(scores, dim=-1), rate, gen)
    out = (probs @ v).transpose(1, 2).reshape(b, t, c)
    return linear(out, p, pre + "to_out")


def feed_forward(x, p: Params, pre: str, cfg: dict, gen):
    y = dropout(swish(linear(x, p, pre + "fc1")), cfg["activation_dropout"], gen)
    return dropout(linear(y, p, pre + "fc2"), cfg["dropout"], gen)


def conv_module(x, p: Params, pre: str, cfg: dict, gen):
    u = F.glu(linear(ln(x, p, pre + "norm"), p, pre + "pointwise_in"), dim=-1)
    w = p[pre + "depthwise.weight"]  # (k, C), the program's layout
    k, c = w.shape
    y = F.conv1d(u.transpose(1, 2), w.t()[:, None, :], padding=(k - 1) // 2,
                 groups=c).transpose(1, 2)
    y = swish(batch_norm(y, None, p, pre + "bn", gen is not None))
    return dropout(linear(y, p, pre + "pointwise_out"), cfg["dropout"], gen)


def layer(x, pe, p: Params, pre: str, cfg: dict, gen: Optional[torch.Generator]):
    x = 0.5 * feed_forward(ln(x, p, pre + "norm_ff1"), p, pre + "ff1.", cfg, gen) + x
    y = attention(ln(x, p, pre + "norm_attn"), pe, p, pre + "attn.",
                  cfg["encoder_attention_heads"], cfg["attention_dropout"], gen)
    x = dropout(y, cfg["attention_dropout"], gen) + x
    x = conv_module(x, p, pre + "conv.", cfg, gen) + x
    x = 0.5 * feed_forward(ln(x, p, pre + "norm_ff2"), p, pre + "ff2.", cfg, gen) + x
    return ln(x, p, pre + "post_norm")


def featurize(wav, lengths, p: Params, cfg: dict, gen: Optional[torch.Generator] = None):
    """(B, T) wave → ((B, T', C), T' lengths).  ``gen`` given: training
    mode (span masks, dropout, the BatchNorms' batch statistics)."""
    if cfg["extractor_mode"] != "layer_norm" or cfg.get("activation_fn", "swish") != "swish":
        raise ValueError("the wav2vec 2.0 Conformer reference is the layer-norm extractor "
                         "under swish Conformer layers")
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
    return encoder(x, p, cfg, gen), feat_len


def encoder(x, p: Params, cfg: dict, gen: Optional[torch.Generator] = None):
    """(B, T', C) → (B, T', C): dropout, the layers over the table of
    2T' − 1 positions, the final LayerNorm (HF's
    ``Wav2Vec2ConformerEncoder`` without its attention mask)."""
    pre = "featurizer.upstream."
    x = dropout(x, cfg["dropout"], gen)
    if gen is not None and cfg["encoder_layerdrop"] > 0:
        raise NotImplementedError("layer drop: the reference follows no such draw")
    pe = relative_embeddings(x.shape[1], x.shape[2]).to(x.device)
    for i in range(cfg["encoder_layers"]):
        x = recomputed(layer, x, pe, p, f"{pre}layers.{i}.", cfg, gen)
    return ln(x, p, pre + "encoder_layer_norm")


def recomputed(fn, x, pe, p: Params, pre: str, cfg: dict, gen: Optional[torch.Generator]):
    """``fn(x, pe, p, pre, cfg, gen)``, its activations dropped after the
    forward and recomputed in the backward pass when autograd records.  The
    recomputation restarts ``gen`` from its state at the forward, so it
    draws the forward's masks, and hands the generator back as it found it."""
    if gen is None or not torch.is_grad_enabled():
        return fn(x, pe, p, pre, cfg, gen)
    state, calls = gen.get_state(), []

    def run(x):
        if not calls:  # the forward
            calls.append(True)
            return fn(x, pe, p, pre, cfg, gen)
        now = gen.get_state()
        gen.set_state(state)
        try:
            return fn(x, pe, p, pre, cfg, gen)
        finally:
            gen.set_state(now)

    return checkpoint(run, x, use_reentrant=False)


# ------------------------------------------- the featurizer family interface

def encode(cfg: dict, p: Params, x, lengths, gen=None):
    if gen is not None:
        p = {k: (v.detach() if frozen(cfg, k) else v) for k, v in p.items()}
    return featurize(x, lengths, p, cfg["task"]["ssl_config"], gen)


def width(cfg: dict) -> int:
    return cfg["task"]["ssl_config"]["encoder_embed_dim"]


def flops(cfg: dict, samples: int):
    """(products of the extractor and the encoder, frames out) for one row
    of ``samples`` valid samples: the convs, the projection, and a layer's
    two FFNs, q, k, v and out, the conv module's two pointwise GEMMs and
    depthwise conv, and the attention's q'·k, q'·p and p·v (one product a
    query, key and channel each).  ``linear_pos`` over the table is left
    out: it runs once a forward for the whole batch, not a row."""
    ssl = cfg["task"]["ssl_config"]
    t, cin, total = samples, 1, 0.0
    for cout, k, s in conv_layers(ssl):
        t = (t - k) // s + 1
        total += 2.0 * t * cout * cin * k
        cin = cout
    c, ffn = ssl["encoder_embed_dim"], ssl["encoder_ffn_embed_dim"]
    total += 2.0 * t * cin * c
    layer_flops = (2 * 2 * 2.0 * t * c * ffn                 # two FFNs, two GEMMs each
                   + 4 * 2.0 * t * c * c                     # q, k, v, out
                   + 2.0 * t * c * 2 * c + 2.0 * t * c * c   # the pointwise GEMMs
                   + 2.0 * t * c * ssl["depthwise_conv_kernel_size"]
                   + 3 * 2.0 * t * t * c)                    # q'·k, q'·p, p·v
    return total + ssl["encoder_layers"] * layer_flops, t
