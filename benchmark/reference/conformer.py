"""Plain float32 Conformer of the benchmark's reference: the featurizer
(×4 Conv2d subsampling, ×√d, N blocks) and the block the heads reuse.

A block is ½FF → MHSA with Shaw relative positions (the embedding of
clip(i − j, ±512) gathered as a (T, T, d) table and contracted with the
queries, not through a product with the whole table) → conv module
(LayerNorm → pointwise → GLU → padded frames zeroed → depthwise conv as a
grouped ``F.conv1d`` → BatchNorm → Swish → pointwise) → ½FF → LayerNorm.
LayerNorm eps 1e-6, BatchNorm eps 1e-5.  Training mode normalises with the
valid frames' statistics (biased variance) and moves nothing: running
statistics are state the check does not compare.  Parameters come as a
dict under the program's names (``params[prefix + "attn.to_q.weight"]``);
the benchmark makes them and hands the same to both.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from reference import frontend

LN_EPS, BN_EPS, MAX_POS = 1e-6, 1e-5, 512
_NEG = torch.finfo(torch.float32).min

Params = Dict[str, torch.Tensor]


def layer_norm(x, p: Params, name: str, eps: float = LN_EPS):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def linear(x, p: Params, name: str):
    return F.linear(x, p[name + ".weight"], p.get(name + ".bias"))


def swish(x):
    return x * torch.sigmoid(x)


def dropout(x, rate: float, gen: Optional[torch.Generator]):
    """Inverted dropout with the program's draw: one uniform per element."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def attention(x, mask, p: Params, pre: str, heads: int, dim_head: int):
    b, n, _ = x.shape
    q = linear(x, p, pre + "to_q").view(b, n, heads, dim_head).transpose(1, 2)
    k, v = linear(x, p, pre + "to_kv").chunk(2, dim=-1)
    k = k.reshape(b, n, heads, dim_head).transpose(1, 2)
    v = v.reshape(b, n, heads, dim_head).transpose(1, 2)
    scale = dim_head ** -0.5
    seq = torch.arange(n, device=x.device)
    rel = (seq[:, None] - seq[None, :]).clamp(-MAX_POS, MAX_POS) + MAX_POS
    table = p[pre + "rel_pos_emb"][rel]  # (n, n, d)
    logits = (q @ k.transpose(-1, -2) + torch.einsum("bhid,ijd->bhij", q, table)) * scale
    if mask is not None:
        logits = logits.masked_fill(~(mask[:, None, :, None] & mask[:, None, None, :]), _NEG)
    out = torch.softmax(logits, dim=-1) @ v
    return linear(out.transpose(1, 2).reshape(b, n, heads * dim_head), p, pre + "to_out")


def batch_norm(y, mask, p: Params, name: str, train: bool):
    if train:
        m = (torch.ones(y.shape[:2], device=y.device) if mask is None else mask.float())[..., None]
        n = m.sum(dim=(0, 1)).clamp_min(1.0)
        mean = (y * m).sum(dim=(0, 1)) / n
        var = (y.square() * m).sum(dim=(0, 1)) / n - mean.square()
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    return (y - mean) * torch.rsqrt(var + BN_EPS) * p[name + ".weight"] + p[name + ".bias"]


def conv_module(x, mask, p: Params, pre: str, train: bool):
    h = linear(layer_norm(x, p, pre + "norm"), p, pre + "pointwise_in")
    u = F.glu(h, dim=-1)
    if mask is not None:
        u = u.masked_fill(~mask[:, :, None], 0.0)
    w = p[pre + "depthwise.weight"]  # (k, C), the program's layout
    k, c = w.shape
    y = F.conv1d(u.transpose(1, 2), w.t()[:, None, :], p[pre + "depthwise.bias"],
                 padding=(k - 1) // 2, groups=c).transpose(1, 2)
    y = swish(batch_norm(y, mask, p, pre + "bn", train))
    return linear(y, p, pre + "pointwise_out")


def feed_forward(x, p: Params, pre: str):
    return linear(swish(linear(x, p, pre + "fc1")), p, pre + "fc2")


def block(x, mask, p: Params, pre: str, heads: int, dim_head: int, train: bool):
    x = 0.5 * feed_forward(layer_norm(x, p, pre + "norm_ff1"), p, pre + "ff1.") + x
    x = attention(layer_norm(x, p, pre + "norm_attn"), mask, p, pre + "attn.", heads,
                  dim_head) + x
    x = conv_module(x, mask, p, pre + "conv.", train) + x
    x = 0.5 * feed_forward(layer_norm(x, p, pre + "norm_ff2"), p, pre + "ff2.") + x
    return layer_norm(x, p, pre + "post_norm")


def subsampled_lengths(f_len: torch.Tensor) -> torch.Tensor:
    """Frames after two valid k3 s2 convolutions."""
    half = torch.div(f_len - 1, 2, rounding_mode="floor")
    return torch.div(half - 1, 2, rounding_mode="floor")


def survival(n_blocks: int, p_last: float) -> torch.Tensor:
    """Linear stochastic depth: block i is kept with 1 − ((i+1)/N)(1 − p)."""
    return 1.0 - (torch.arange(1, n_blocks + 1) / n_blocks) * (1.0 - p_last)


def featurize(feats, f_len, p: Params, cfg: dict, gen: Optional[torch.Generator] = None):
    """(B, F, n_mels) features → ((B, T', d), T' lengths).  ``gen`` given:
    training mode (positional dropout, stochastic depth, batch statistics),
    drawn in the program's order."""
    pre = "featurizer."
    d = cfg["encoder_dim"]
    y = F.relu(F.conv2d(feats[:, None], p[pre + "subsample.conv0.weight"],
                        p[pre + "subsample.conv0.bias"], stride=2))
    y = F.relu(F.conv2d(y, p[pre + "subsample.conv1.weight"],
                        p[pre + "subsample.conv1.bias"], stride=2))
    b, c, t, f = y.shape
    x = linear(y.permute(0, 2, 3, 1).reshape(b, t, f * c), p, pre + "subsample.out")
    x = dropout(x * math.sqrt(d), cfg["pos_dropout"], gen)
    sub_len = subsampled_lengths(f_len)
    mask = torch.arange(t, device=x.device)[None, :] < sub_len[:, None]
    n_blocks = cfg["n_blocks"]
    keep = None
    if gen is not None and cfg["use_stochastic_depth"]:
        keep = torch.rand(n_blocks, generator=gen, device=x.device) < survival(
            n_blocks, cfg["stochastic_depth_p"]).to(x.device)
    for i in range(n_blocks):
        y = block(x, mask, p, f"{pre}blocks.{i}.", cfg["heads"], cfg["dim_head"], gen is not None)
        x = y if keep is None else torch.where(keep[i], y, x)
    return x, sub_len


# ------------------------------------------- the featurizer family interface

def inputs(cfg: dict, wav, lengths, gens=None):
    """The normalised wave → (B, F, n_mels) dB mel and frame lengths, with
    time stretch and SpecAugment in training (``gens``: device and host
    generators)."""
    task = cfg["task"]
    mel = frontend.log_mel(wav, lengths, task["n_mels"], cfg["data"]["sample_rate"])
    f_len = frontend.frame_lengths(lengths)
    if gens is not None:
        device_gen, host_gen = gens
        if task["t_stretch"]:
            mel, f_len = frontend.time_stretch(host_gen, mel, f_len)
        if task["mask_times"] > 0:
            mel = frontend.spec_augment(device_gen, mel, f_len, task["mask_times"],
                                        task["f_mask"], task["t_mask_ratio"])
    return mel.transpose(1, 2), f_len


def encode(cfg: dict, p: Params, x, lengths, gen=None):
    return featurize(x, lengths, p, cfg["task"], gen)


def width(cfg: dict) -> int:
    return cfg["task"]["encoder_dim"]


def block_flops(t: int, d: int, heads: int, dim_head: int, ff_mult: int = 4,
                expansion: int = 2, kernel: int = 31) -> float:
    """Products of one block over t frames: two half-FFNs, q, kv and out,
    q·k, q·E and p·v, the conv module's two pointwise and its depthwise."""
    inner = heads * dim_head
    conv = d * expansion
    ff = 2 * (2.0 * t * d * d * ff_mult * 2)
    attn = 2.0 * t * d * inner * 3 + 2.0 * t * inner * d + 3 * 2.0 * t * t * inner
    return ff + attn + 2.0 * t * d * 2 * conv + 2.0 * t * conv * kernel + 2.0 * t * conv * d


def flops(cfg: dict, samples: int):
    """(products of the fbank (its least: :func:`frontend.least_flops`) and
    the encoder, frames out) for one row of ``samples`` valid samples."""
    task = cfg["task"]
    d, n_mels = task["encoder_dim"], task["n_mels"]
    frames = 1 + samples // frontend.HOP
    total = frontend.least_flops(frames, n_mels)
    t1, f1 = (frames - 1) // 2, (n_mels - 1) // 2
    t2, f2 = (t1 - 1) // 2, (f1 - 1) // 2
    total += 2.0 * t1 * f1 * d * 9 + 2.0 * t2 * f2 * d * d * 9 + 2.0 * t2 * f2 * d * d
    total += task["n_blocks"] * block_flops(t2, d, task["heads"], task["dim_head"])
    return total, t2
