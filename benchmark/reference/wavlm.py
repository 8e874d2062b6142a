"""Plain float32 WavLM encoder of the benchmark's reference (Base+ layout:
post-LN layers, gated relative position bias; arXiv:2110.13900).

Conv extractor (VALID strided convs without bias, GroupNorm of one channel a
group after the first, exact GELU after each) → LayerNorm → projection →
[span masks in training] → + weight-normed grouped conv positional
embedding (GELU) → LayerNorm → dropout → layers.  A layer: attention whose
logits get the bucketed relative position bias of layer 0 (T5's
bidirectional buckets of j − i), scaled per query and head by the gate
``a·(b·grep_a − 1) + 2`` read from the layer's input, then residual +
LayerNorm, FFN (GELU), residual + LayerNorm.  LayerNorm and GroupNorm eps
1e-5.  The encoder attends over padded frames too (the program's
``mask_attention=False``).  Random draws (span masks, dropout) are made in
the program's order and shapes from the generator the benchmark hands to
both.
"""

from __future__ import annotations

import ast
import math
from typing import Optional

import torch
import torch.nn.functional as F

from reference.conformer import Params, dropout, linear

LN_EPS = 1e-5


def conv_layers(cfg: dict):
    """The extractor's (channels, kernel, stride) list from its spec string
    (a list expression of int tuples, ``+`` and ``*``)."""
    def walk(node):
        if isinstance(node, ast.Expression):
            return walk(node.body)
        if isinstance(node, (ast.List, ast.Tuple)):
            items = [walk(e) for e in node.elts]
            return tuple(items) if isinstance(node, ast.Tuple) else items
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mult)):
            left, right = walk(node.left), walk(node.right)
            return left + right if isinstance(node.op, ast.Add) else left * right
        raise ValueError(f"unsupported conv spec: {ast.dump(node)}")

    return walk(ast.parse(cfg["conv_feature_layers"], mode="eval"))


def out_lengths(lengths: torch.Tensor, cfg: dict) -> torch.Tensor:
    for _, k, s in conv_layers(cfg):
        lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
    return lengths


def ln(x, p: Params, name: str):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], LN_EPS)


def buckets(t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """(T, T) bucket of j − i: the sign in the upper half, |j − i| exact below
    a quarter of the buckets, logarithmic (float32, truncated) above."""
    pos = torch.arange(t)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    exact = half // 2
    dist = rel.abs()
    log_part = exact + (torch.log(dist.clamp(min=1).float() / exact)
                        / math.log(max_distance / exact) * (half - exact)).long()
    far = log_part.clamp(max=half - 1)
    return (rel > 0).long() * half + torch.where(dist < exact, dist, far)


def span_mask(gen, lengths, t: int, prob: float, span: int, min_masks: int = 2):
    """(B, T) spans of ``span`` frames, floor(prob·len/span + u) of them (at
    least ``min_masks``), uniform starts, cut at each row's length."""
    b = lengths.shape[0]
    dev = lengths.device
    t_eff = lengths.float()
    u = torch.rand(b, generator=gen, device=dev)
    count = torch.floor(prob * t_eff / span + u).long().clamp(min=min_masks)
    most = int(prob * t / span) + min_masks + 1
    starts = (torch.rand(b, most, generator=gen, device=dev)
              * (t_eff[:, None] - span).clamp(min=1.0)).long()
    used = torch.arange(most, device=dev)[None, :] < count[:, None]
    pos = torch.arange(t, device=dev)[None, None, :]
    hit = (pos >= starts[:, :, None]) & (pos < starts[:, :, None] + span) & used[:, :, None]
    return hit.any(dim=1) & (torch.arange(t, device=dev)[None, :] < lengths[:, None])


def layer(x, bias, p: Params, pre: str, cfg: dict, gen: Optional[torch.Generator]):
    b, t, c = x.shape
    h = cfg["encoder_attention_heads"]
    d = c // h
    q = (linear(x, p, pre + "self_attn.q_proj") * d ** -0.5).view(b, t, h, d).transpose(1, 2)
    k = linear(x, p, pre + "self_attn.k_proj").view(b, t, h, d).transpose(1, 2)
    v = linear(x, p, pre + "self_attn.v_proj").view(b, t, h, d).transpose(1, 2)
    grep = linear(x.view(b, t, h, d).transpose(1, 2), p, pre + "self_attn.grep_linear")
    gate = torch.sigmoid(grep.view(b, h, t, 2, 4).sum(-1))
    scale = gate[..., 0:1] * (gate[..., 1:2] * p[pre + "self_attn.grep_a"] - 1.0) + 2.0
    probs = torch.softmax(q @ k.transpose(-1, -2) + scale * bias[None], dim=-1)
    probs = dropout(probs, cfg["attention_dropout"], gen)
    y = linear((probs @ v).transpose(1, 2).reshape(b, t, c), p, pre + "self_attn.out_proj")
    x = ln(x + dropout(y, cfg["dropout"], gen), p, pre + "self_attn_layer_norm")
    y = dropout(F.gelu(linear(x, p, pre + "fc1")), cfg["activation_dropout"], gen)
    y = linear(y, p, pre + "fc2")
    return ln(x + dropout(y, cfg["dropout"], gen), p, pre + "final_layer_norm")


def featurize(wav, lengths, p: Params, cfg: dict, gen: Optional[torch.Generator] = None):
    """(B, T) normalised wave → ((B, T', C), T' lengths).  ``gen`` given:
    training mode (span masks, dropout)."""
    pre = "featurizer.upstream."
    y = wav[:, None, :]
    for i, (_, k, s) in enumerate(conv_layers(cfg)):
        y = F.conv1d(y, p[f"{pre}feature_extractor.conv_{i}.weight"], stride=s)
        if i == 0:
            y = F.group_norm(y, y.shape[1], p[pre + "feature_extractor.gn_0.weight"],
                             p[pre + "feature_extractor.gn_0.bias"], LN_EPS)
        y = F.gelu(y)
    y = y.transpose(1, 2)
    gm = cfg["feature_grad_mult"]
    if gm != 1.0:  # the extractor's gradient scaled by gm
        y = y.detach() * (1.0 - gm) + y * gm
    x = linear(ln(y, p, pre + "layer_norm"), p, pre + "post_extract_proj")
    x = dropout(x, cfg["dropout_input"], gen)
    feat_len = out_lengths(lengths, cfg)
    b, t, c = x.shape
    if gen is not None and cfg["mask_prob"] > 0:
        spans = span_mask(gen, feat_len, t, cfg["mask_prob"], cfg["mask_length"])
        x = torch.where(spans[:, :, None], p[pre + "mask_emb"], x)
    v, g = p[pre + "pos_conv.weight_v"], p[pre + "pos_conv.weight_g"]
    w = v / torch.sqrt(v.square().sum(dim=(0, 1), keepdim=True) + 1e-12) * g
    kpos = w.shape[-1]
    # padding K/2 on the left and K/2 − 1 on the right: the T outputs of an
    # even kernel, without the one extra the program drops
    pos = F.conv1d(F.pad(x.transpose(1, 2), (kpos // 2, kpos // 2 - 1)), w,
                   p[pre + "pos_conv.bias"], groups=cfg["conv_pos_groups"])
    x = ln(x + F.gelu(pos).transpose(1, 2), p, pre + "encoder_layer_norm")
    x = dropout(x, cfg["dropout"], gen)
    table = buckets(t, cfg["num_buckets"], cfg["max_distance"]).to(x.device)
    bias = p[pre + "layers.0.self_attn.relative_attention_bias"][table].permute(2, 0, 1)
    if gen is not None and cfg["encoder_layerdrop"] > 0:
        raise NotImplementedError("layer drop: the reference follows no such draw")
    for i in range(cfg["encoder_layers"]):
        x = layer(x, bias, p, f"{pre}layers.{i}.", cfg, gen)
    return x, feat_len


# ------------------------------------------- the featurizer family interface

def inputs(cfg: dict, wav, lengths, gens=None):
    """The normalised wave is the input; its extractor is the frontend."""
    return wav, lengths


def encode(cfg: dict, p: Params, x, lengths, gen=None):
    return featurize(x, lengths, p, cfg["ssl_config"], gen)


def width(cfg: dict) -> int:
    return cfg["ssl_config"]["encoder_embed_dim"]


def flops(cfg: dict, samples: int):
    """(products of the extractor and the encoder, frames out) for one row
    of ``samples`` valid samples: the convs, the projection, the positional
    conv, q, k, v and out, q·k and p·v, the gate, the FFN."""
    ssl = cfg["ssl_config"]
    t, cin, total = samples, 1, 0.0
    for cout, k, s in conv_layers(ssl):
        t = (t - k) // s + 1
        total += 2.0 * t * cout * cin * k
        cin = cout
    c, ffn = ssl["encoder_embed_dim"], ssl["encoder_ffn_embed_dim"]
    h = ssl["encoder_attention_heads"]
    total += 2.0 * t * cin * c + 2.0 * t * c * (c // ssl["conv_pos_groups"]) * ssl["conv_pos"]
    layer = 4 * 2.0 * t * c * c + 2 * 2.0 * t * t * c + 2 * 2.0 * t * c * ffn
    layer += 2.0 * t * h * (c // h) * 8
    return total + ssl["encoder_layers"] * layer, t
