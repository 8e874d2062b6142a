"""WavLM SSL upstream encoder (port of ``speechlid_tpu/models/wavlm.py``),
with the loader of the reference's torch checkpoints.

- 7-layer conv waveform extractor (320× down-sampling), float32 GroupNorm
  after the first conv in ``default`` mode, a LayerNorm after every conv in
  ``layer_norm`` mode, exact GELU;
- post-extract LayerNorm → 512→C projection (only where the widths differ)
  → optional span and channel masking, with a learned ``mask_emb``;
- transformer encoder: weight-normed grouped conv positional embedding
  (k = 128, 16 groups, the last frame dropped for an even k), post-LN
  (Base+) or pre-LN (``layer_norm_first``, Large) layers, and the **gated
  relative position bias**: T5 bidirectional buckets embedded per head at
  layer 0 and shared down the stack, scaled per query by
  ``gate_a·(gate_b·grep_a − 1) + 2``;
- the hidden state of every layer kept for the weighted-sum Featurizer
  (``models/wav2vec2.py``).

Activations are (B, T, C) as in the JAX package.  Parameter names follow
the flax tree (``feature_extractor.conv_0``, ``layers.3.self_attn.q_proj``,
``pos_conv.weight_v``…), so ``convert.py`` maps them leaf by leaf; the
reference's torch names load through :func:`convert_wavlm_state`.

``mask_attention=False`` (the default) is the reference's call path: the
encoder never sees the padding, so padded frames carry the extractor's
outputs of the zero-padded wave and take part in attention.  Training-time
masking and layer drop draw from ``self.generator`` (``conformer.
set_generator``), dropout from its ``Dropout`` modules' generators.

The attention is written out with ``torch.matmul`` (no fused attention):
the JAX package computes it outside any kernel, and parity is the point.

``WavLMConfig.dtype`` (``"float32"`` or ``"bfloat16"``) is the compute
dtype of the JAX config, with its float32 islands: every conv and
projection computes in it (parameters stay float32, cast per call); the
LayerNorms and the extractor's GroupNorm compute and return float32; the
attention logits are float32 (exact products of the ``dtype`` inputs,
summed in float32, as JAX's ``preferred_element_type``), the softmax
float32 and the probabilities ``dtype``.  So the Base+ encoder's residual
stream is float32 between its post-LNs.

``WavLMConfig.quant_dot`` (``"int8"``, ``"int8_ste"``; ``ops/quant.py``)
quantizes what the JAX code quantizes: ``q_proj``, ``k_proj``, ``v_proj``,
``out_proj`` and ``fc1``.  ``fc2``, ``grep_linear`` and
``post_extract_proj`` stay exact, as they do in the JAX code (whose config
comment names fc2 too).  With ``conv_extractor_impl="matmul"`` the
extractor's convs run as JAX's framed GEMM through the int8 product
(:func:`framed_conv`).
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechlid_tpu_torch.core.precision import compute_dtype
from speechlid_tpu_torch.core.profile import _time_cost_recoder
from speechlid_tpu_torch.models.conformer import Conv1d, Dropout, LayerNorm, Linear
from speechlid_tpu_torch.models.remat import remat_call
from speechlid_tpu_torch.ops.quant import Dot, quant_dot_general
from speechlid_tpu_torch.parallel.mesh import copy_to_group

LN_EPS = 1e-5  # the reference's LayerNorm/GroupNorm eps (not flax's 1e-6)
_NEG = torch.finfo(torch.float32).min
span = _time_cost_recoder.span


def _eval_conv_spec(spec: str) -> List[Tuple[int, int, int]]:
    """Evaluate conv-layer specs like ``"[(512,10,5)] + [(512,3,2)] * 4"``
    (the format a checkpoint's config holds) safely: only list and tuple
    literals of ints, ``+`` and ``*``."""

    def walk(node):
        if isinstance(node, ast.Expression):
            return walk(node.body)
        if isinstance(node, (ast.List, ast.Tuple)):
            out = [walk(e) for e in node.elts]
            return tuple(out) if isinstance(node, ast.Tuple) else out
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            return walk(node.left) + walk(node.right)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            return walk(node.left) * walk(node.right)
        raise ValueError(f"unsupported conv spec node: {ast.dump(node)}")

    return list(walk(ast.parse(spec, mode="eval")))


@dataclass(frozen=True)
class WavLMConfig:
    extractor_mode: str = "default"  # or "layer_norm"
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"
    layer_norm_first: bool = False
    conv_feature_layers: str = "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2"
    conv_bias: bool = False
    feature_grad_mult: float = 1.0
    normalize: bool = False
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    encoder_layerdrop: float = 0.0
    dropout_input: float = 0.0
    dropout_features: float = 0.0
    mask_length: int = 10
    mask_prob: float = 0.65
    mask_channel_length: int = 10
    mask_channel_prob: float = 0.0
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = False
    num_buckets: int = 320
    max_distance: int = 1280
    gru_rel_pos: bool = False
    dtype: str = "float32"  # the compute dtype: "float32" or "bfloat16"
    # the int8 projections (ops/quant.py): q/k/v/out and fc1
    quant_dot: Optional[str] = None
    # 'conv' or 'matmul': two lowerings of the same strided conv with the
    # same parameters; 'matmul' is the framed GEMM, which takes quant_dot
    conv_extractor_impl: str = "conv"

    @property
    def conv_layers(self) -> List[Tuple[int, int, int]]:
        return _eval_conv_spec(self.conv_feature_layers)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WavLMConfig":
        """Keys that are not fields are dropped (a checkpoint's config has
        many)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def conv_out_lengths(lengths: torch.Tensor,
                     conv_layers: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    for _, k, s in conv_layers:
        lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
    return lengths


def framed_conv(y: torch.Tensor, conv: Conv1d, dot: Dot) -> torch.Tensor:
    """A VALID strided conv1d as JAX's ``_FramedConv``: (B, T, Cin) →
    (B, T2, Cout), the k strided slices of ``y`` concatenated tap-major
    (a reshape when k == stride) times the weight as a (k·Cin, Cout)
    matrix, so each int8 row scale covers one k·Cin window; in the conv's
    ``compute_dtype``, its bias added after."""
    b, t, cin = y.shape
    cout, _, k = conv.weight.shape
    s = conv.stride[0]
    t2 = (t - k) // s + 1
    if k == s:
        win = y[:, : t2 * s].reshape(b, t2, k * cin)
    else:
        win = torch.cat([y[:, i : i + (t2 - 1) * s + 1 : s] for i in range(k)], dim=-1)
    d = conv.compute_dtype
    w = conv.weight.permute(0, 2, 1).reshape(cout, k * cin).to(d)  # [o, i·Cin + c]
    out = dot(win.to(d), w)
    return out if conv.bias is None else out + conv.bias.to(d)


class ConvFeatureExtractor(nn.Module):
    """Waveform (B, T) → (B, T', C): VALID strided convs, each followed by
    exact GELU; ``default`` mode normalises after conv 0 with
    GroupNorm(C groups) — per channel over the whole (padded) time axis —,
    ``layer_norm`` mode after every conv over the channels.

    The JAX package's ``conv_extractor_impl="matmul"`` frames the same conv
    as one GEMM with the same parameters and the same numbers; one conv
    serves both here, except under ``quant_dot``, where the framed GEMM
    (:func:`framed_conv`) takes the int8 product.  The convs compute in the
    config's dtype; the norms are float32 islands, so a normalised layer's
    GELU runs in float32."""

    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.mode = config.extractor_mode
        if self.mode not in ("default", "layer_norm"):
            raise ValueError(f"unknown extractor_mode {self.mode!r}")
        dtype = compute_dtype(config.dtype)
        in_dim = 1
        for i, (dim, k, stride) in enumerate(config.conv_layers):
            self.add_module(f"conv_{i}", Conv1d(in_dim, dim, k, stride=stride,
                                                bias=config.conv_bias, compute_dtype=dtype))
            if self.mode == "layer_norm":
                self.add_module(f"ln_{i}", LayerNorm(dim, eps=LN_EPS))
            elif i == 0:
                self.gn_0 = nn.GroupNorm(dim, dim, eps=LN_EPS)
            in_dim = dim
        self.n_layers = len(config.conv_layers)
        self.framed_dot = (quant_dot_general(config.quant_dot)
                           if config.conv_extractor_impl == "matmul" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x[:, None, :]  # (B, 1, T): channels first for Conv1d
        for i in range(self.n_layers):
            conv = getattr(self, f"conv_{i}")
            if self.framed_dot is None:
                y = conv(y)
            else:
                y = framed_conv(y.transpose(1, 2), conv, self.framed_dot).transpose(1, 2)
            if self.mode == "layer_norm":
                y = getattr(self, f"ln_{i}")(y.transpose(1, 2)).transpose(1, 2)
            elif i == 0:
                gn = self.gn_0
                y = F.group_norm(y.float(), gn.num_groups, gn.weight, gn.bias, gn.eps)
            y = F.gelu(y)
        return y.transpose(1, 2)  # (B, T', C)


def _relative_positions_bucket(relative_positions: torch.Tensor, num_buckets: int,
                               max_distance: int) -> torch.Tensor:
    """T5 bidirectional bucketing in float32, truncated toward zero, as the
    JAX package computes it.  The logarithm's branch is taken of
    ``max(|rel|, 1)``: at rel = 0 it is not selected, and no ``log(0)`` is
    cast to an integer."""
    nb = num_buckets // 2
    buckets = (relative_positions > 0).long() * nb
    rel = relative_positions.abs()
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        torch.log(rel.clamp(min=1).float() / max_exact)
        / math.log(max_distance / max_exact)
        * (nb - max_exact)
    ).long()
    large = large.clamp(max=nb - 1)
    return buckets + torch.where(is_small, rel, large)


@functools.lru_cache(maxsize=64)
def _bucket_table(t: int, num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """(T, T) bucket of ``rel[i, j] = j − i``, computed on the CPU (so the
    card and the CPU use the same table, bit for bit) and kept on
    ``device``; a normal tensor even when first asked for under
    ``torch.inference_mode``, so training may use it later."""
    with torch.inference_mode(False):
        pos = torch.arange(t)
        table = _relative_positions_bucket(pos[None, :] - pos[:, None], num_buckets,
                                           max_distance)
        return table.to(device)


class RelPosMultiheadAttention(nn.Module):
    """Self-attention with an optional (gated) relative position bias,
    batch-first (B, T, C).  Returns (output, the UNGATED position bias
    (H, T, T) or None), so layers after the first reuse layer 0's bias.

    Under tensor parallelism (``parallel/sharding.py``) ``num_heads`` is
    this rank's heads, ``head_index`` which of the ``num_heads_full`` they
    are: q/k/v are column-parallel, ``out_proj`` row-parallel, the bias
    table and ``grep_a`` hold these heads' columns (so the position bias
    handed on is these heads'), and ``grep_linear``, shared by the heads,
    stays whole and sums its gradient over ``tp_group``."""

    tp_group = None
    head_index: Optional[torch.Tensor] = None
    num_heads_full = 0

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 has_relative_attention_bias: bool = False, num_buckets: int = 320,
                 max_distance: int = 1280, gru_rel_pos: bool = False,
                 dtype: torch.dtype = torch.float32, quant_dot: Optional[str] = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.gru_rel_pos = gru_rel_pos
        self.dtype = dtype
        proj = dict(compute_dtype=dtype, quant_dot=quant_dot)
        self.q_proj = Linear(embed_dim, embed_dim, **proj)
        self.k_proj = Linear(embed_dim, embed_dim, **proj)
        self.v_proj = Linear(embed_dim, embed_dim, **proj)
        self.out_proj = Linear(embed_dim, embed_dim, **proj)
        self.dropout = Dropout(dropout)
        self.relative_attention_bias = None
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Parameter(torch.randn(num_buckets, num_heads))
        if gru_rel_pos:
            self.grep_linear = Linear(self.head_dim, 8, compute_dtype=dtype)
            self.grep_a = nn.Parameter(torch.ones(1, num_heads, 1, 1))

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                position_bias: Optional[torch.Tensor] = None):
        b, t, c = x.shape
        h, d = self.num_heads, self.head_dim
        q = self.q_proj(x) * d ** -0.5
        q = q.view(b, t, h, d).transpose(1, 2)
        k = self.k_proj(x).view(b, t, h, d).transpose(1, 2)
        v = self.v_proj(x).view(b, t, h, d).transpose(1, 2)

        if self.relative_attention_bias is not None and position_bias is None:
            bucket = _bucket_table(t, self.num_buckets, self.max_distance, x.device)
            position_bias = self.relative_attention_bias[bucket].permute(2, 0, 1)  # (H, T, T)

        # float32 logits of the compute-dtype q and k: their products are
        # exact in float32, summed there (JAX's preferred_element_type)
        weights = q.float() @ k.float().transpose(-1, -2)  # (B, H, T, T)
        if position_bias is not None:
            attn_bias = position_bias[None]
            if self.gru_rel_pos:
                # the gate reads the PRE-projection input, split per head;
                # the float32 grep_a promotes it to float32
                if self.tp_group is None:
                    heads = x.view(b, t, h, d)
                else:
                    heads = copy_to_group(x, self.tp_group).view(b, t, self.num_heads_full, d)
                    heads = heads[:, :, self.head_index.to(x.device)]
                grep = self.grep_linear(heads.transpose(1, 2))  # (B, H, T, 8)
                gates = torch.sigmoid(grep.view(b, h, t, 2, 4).sum(-1))
                gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
                attn_bias = (gate_a * (gate_b * self.grep_a - 1.0) + 2.0) * attn_bias
            weights = weights + attn_bias
        if padding_mask is not None:
            weights = weights.masked_fill(padding_mask[:, None, None, :], _NEG)
        shard = None if self.tp_group is None else (self.head_index, self.num_heads_full)
        probs = self.dropout(torch.softmax(weights, dim=-1).to(self.dtype), shard, dim=1)
        out = (probs @ v).transpose(1, 2).reshape(b, t, h * d)
        return self.out_proj(out), position_bias


def _ffn_act(config: WavLMConfig, y: torch.Tensor, fc1: nn.Linear) -> torch.Tensor:
    """fc1 + activation: exact GELU, or (``activation_fn="glu"``) a GLU with
    a swish gate over an fc1 of twice the width."""
    z = fc1(y)
    if config.activation_fn == "glu":
        a, g = z.chunk(2, dim=-1)
        return a * (g * torch.sigmoid(g))
    return F.gelu(z)


class WavLMEncoderLayer(nn.Module):
    """Post-LN (``layer_norm_first=False``, Base+) or pre-LN transformer
    layer; LayerNorm eps 1e-5, its output float32 in any compute dtype.
    ``hidden_shard``: the tensor-parallel slice ``(index, ffn)`` of the FFN's
    hidden features this rank holds."""

    hidden_shard: Optional[tuple] = None

    def __init__(self, config: WavLMConfig, has_relative_attention_bias: bool = False):
        super().__init__()
        c = config.encoder_embed_dim
        dtype = compute_dtype(config.dtype)
        self.layer_norm_first = config.layer_norm_first
        self.self_attn = RelPosMultiheadAttention(
            c, config.encoder_attention_heads, dropout=config.attention_dropout,
            has_relative_attention_bias=has_relative_attention_bias,
            num_buckets=config.num_buckets, max_distance=config.max_distance,
            gru_rel_pos=config.gru_rel_pos, dtype=dtype, quant_dot=config.quant_dot)
        self.self_attn_layer_norm = LayerNorm(c, eps=LN_EPS)
        ffn = config.encoder_ffn_embed_dim
        self.fc1 = Linear(c, 2 * ffn if config.activation_fn == "glu" else ffn,
                          compute_dtype=dtype, quant_dot=config.quant_dot)
        # exact under quant_dot, as the JAX layer's fc2 is
        self.fc2 = Linear(config.encoder_ffn_embed_dim, c, compute_dtype=dtype)
        self.final_layer_norm = LayerNorm(c, eps=LN_EPS)
        self.dropout = Dropout(config.dropout)
        self.activation_dropout = Dropout(config.activation_dropout)
        self.config = config

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                position_bias: Optional[torch.Tensor] = None):
        residual = x
        if self.layer_norm_first:
            y, position_bias = self.self_attn(self.self_attn_layer_norm(x), padding_mask,
                                              position_bias)
            x = residual + self.dropout(y)
            residual = x
            y = self.activation_dropout(_ffn_act(self.config, self.final_layer_norm(x), self.fc1),
                                        self.hidden_shard)
            x = residual + self.dropout(self.fc2(y))
        else:
            y, position_bias = self.self_attn(x, padding_mask, position_bias)
            x = self.self_attn_layer_norm(residual + self.dropout(y))
            residual = x
            y = self.activation_dropout(_ffn_act(self.config, x, self.fc1), self.hidden_shard)
            x = self.final_layer_norm(residual + self.dropout(self.fc2(y)))
        return x, position_bias


class _WeightNormConvPos(nn.Module):
    """Conv positional embedding, weight-normalised along the kernel axis:
    w = v / sqrt(Σ_(out, in) v² + 1e-12) · g, with ``weight_v`` (C, C/g, K),
    ``weight_g`` (1, 1, K) — the arithmetic written out, since it is not
    ``torch.nn.utils.weight_norm``'s.  Grouped conv with padding K//2, the
    last frame dropped for an even K, then exact GELU; the conv and the GELU
    in the config's dtype (the weight norm in float32)."""

    def __init__(self, config: WavLMConfig):
        super().__init__()
        c, k, g = config.encoder_embed_dim, config.conv_pos, config.conv_pos_groups
        self.kernel_size, self.groups = k, g
        self.dtype = compute_dtype(config.dtype)
        self.weight_v = nn.Parameter(torch.randn(c, c // g, k) * math.sqrt(4.0 / (k * c)))
        self.weight_g = nn.Parameter(torch.ones(1, 1, k))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        v = self.weight_v
        w = v / torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True) + 1e-12) * self.weight_g
        d = self.dtype
        y = F.conv1d(x.transpose(1, 2).to(d), w.to(d), self.bias.to(d),
                     padding=self.kernel_size // 2, groups=self.groups)
        if self.kernel_size % 2 == 0:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


def compute_mask_spans(
    generator: Optional[torch.Generator],
    batch: int,
    seq_len: int,
    mask_prob: float,
    mask_length: int,
    min_masks: int = 2,
    lengths: Optional[torch.Tensor] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """(B, T) boolean span mask, the JAX package's law: per item
    ``floor(p·T/L + u)`` spans (at least ``min_masks``; ``max_masks`` =
    ⌊p·seq_len/L⌋ + min_masks + 1 drawn, the first ``num`` kept) of length L
    at uniform starts in [0, max(T − L, 1)), overlapping allowed, cut at
    ``lengths``.  T is ``lengths`` where given, else ``seq_len``.  Draws
    from ``generator`` on ``device`` and stays there: the step does not
    wait for it."""
    if lengths is not None:
        device = lengths.device
    t_eff = (torch.full((batch,), float(seq_len), device=device) if lengths is None
             else lengths.float())
    u = torch.rand(batch, generator=generator, device=device)
    num_mask = torch.floor(mask_prob * t_eff / mask_length + u).long().clamp(min=min_masks)
    max_masks = int(mask_prob * seq_len / mask_length) + min_masks + 1
    starts = (torch.rand(batch, max_masks, generator=generator, device=device)
              * (t_eff[:, None] - mask_length).clamp(min=1.0)).long()
    active = torch.arange(max_masks, device=device)[None, :] < num_mask[:, None]
    pos = torch.arange(seq_len, device=device)[None, None, :]
    in_span = (pos >= starts[:, :, None]) & (pos < starts[:, :, None] + mask_length)
    mask = (in_span & active[:, :, None]).any(dim=1)
    if lengths is not None:
        mask = mask & (torch.arange(seq_len, device=device)[None, :] < lengths[:, None])
    return mask


class WavLM(nn.Module):
    """Full WavLM; ``forward`` is the reference's ``extract_features``:
    (B, T) wave → (last hidden state (B, T', C), frame lengths or None[,
    hidden states of every layer, input first]).  ``remat``: each encoder
    layer is rematerialized in the backward pass (``models/remat.py``, JAX's
    ``nn.remat``)."""

    def __init__(self, config: WavLMConfig, mask_attention: bool = False, remat: bool = False):
        super().__init__()
        dtype = compute_dtype(config.dtype)
        self.config = config
        self.mask_attention = mask_attention
        self.remat = remat
        self.generator: Optional[torch.Generator] = None
        c = config.encoder_embed_dim
        self.feature_extractor = ConvFeatureExtractor(config)
        embed = config.conv_layers[-1][0]
        self.layer_norm = LayerNorm(embed, eps=LN_EPS)
        self.post_extract_proj = (Linear(embed, c, compute_dtype=dtype) if embed != c
                                  else None)
        self.dropout_input = Dropout(config.dropout_input)
        self.mask_emb = nn.Parameter(torch.rand(c))
        self.pos_conv = _WeightNormConvPos(config)
        self.encoder_layer_norm = LayerNorm(c, eps=LN_EPS)
        self.dropout = Dropout(config.dropout)
        self.layers = nn.ModuleList(
            WavLMEncoderLayer(config, has_relative_attention_bias=(
                config.relative_position_embedding and i == 0))
            for i in range(config.encoder_layers))

    def feat_lengths(self, sample_lengths: torch.Tensor) -> torch.Tensor:
        return conv_out_lengths(sample_lengths, self.config.conv_layers)

    def forward(self, source: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                mask: bool = False, ret_layer_results: bool = False):
        cfg = self.config
        if cfg.normalize:
            mean = source.mean(dim=-1, keepdim=True)
            var = source.var(dim=-1, keepdim=True, unbiased=False)
            source = (source - mean) / torch.sqrt(var + 1e-5)
        with span("model.extractor"):
            features = self.feature_extractor(source)
        if cfg.feature_grad_mult == 0.0:
            features = features.detach()
        elif cfg.feature_grad_mult != 1.0:
            gm = cfg.feature_grad_mult
            features = features.detach() * (1.0 - gm) + features * gm
        features = self.layer_norm(features)

        feat_len = pad_mask = None
        if lengths is not None:
            feat_len = self.feat_lengths(lengths)
            if self.mask_attention:
                pad_mask = (torch.arange(features.shape[1], device=features.device)[None, :]
                            >= feat_len[:, None])
        if self.post_extract_proj is not None:
            features = self.post_extract_proj(features)
        x = self.dropout_input(features)
        if mask and cfg.mask_prob > 0:
            spans = compute_mask_spans(self.generator, x.shape[0], x.shape[1], cfg.mask_prob,
                                       cfg.mask_length, lengths=feat_len, device=x.device)
            x = torch.where(spans[:, :, None], self.mask_emb.to(x.dtype), x)
        if mask and cfg.mask_channel_prob > 0:
            ch = compute_mask_spans(self.generator, x.shape[0], x.shape[2],
                                    cfg.mask_channel_prob, cfg.mask_channel_length,
                                    min_masks=0, device=x.device)
            x = x.masked_fill(ch[:, None, :], 0.0)

        if pad_mask is not None:
            x = x.masked_fill(pad_mask[:, :, None], 0.0)
        x = x + self.pos_conv(x)
        if not cfg.layer_norm_first:
            x = self.encoder_layer_norm(x)
        x = self.dropout(x)

        layer_results = [x]
        position_bias = None
        drop = cfg.encoder_layerdrop > 0 and self.training
        for layer in self.layers:
            if self.remat:
                y, position_bias = remat_call(layer, x, pad_mask, position_bias)
            else:
                y, position_bias = layer(x, pad_mask, position_bias)
            if drop:  # the layer ran; keep its output or skip it
                keep = torch.rand((), generator=self.generator, device=x.device) \
                    >= cfg.encoder_layerdrop
                y = torch.where(keep, y, x)
            x = y
            layer_results.append(x)
        if cfg.layer_norm_first:
            x = self.encoder_layer_norm(x)
        if ret_layer_results:
            return x, feat_len, layer_results
        return x, feat_len


class WavLMModel(nn.Module):
    """The reference's wrapper of a pretrained upstream: (B, T) → the last
    layer (B, T', C), or every hidden state (L+1, B, T', C); masking only in
    training mode."""

    def __init__(self, config: WavLMConfig, remat: bool = False):
        super().__init__()
        self.config = config
        self.wavlm = WavLM(config, remat=remat)

    def subsampled_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return conv_out_lengths(lengths, self.config.conv_layers)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                only_last: bool = True) -> torch.Tensor:
        out = self.wavlm(x, lengths, mask=self.training, ret_layer_results=not only_last)
        if only_last:
            return out[0]
        return torch.stack(out[2], dim=0)


# ---------------------------------------------------------------------------
# the reference's torch checkpoints
# ---------------------------------------------------------------------------


def convert_wavlm_state(torch_state: Dict[str, Any], cfg: WavLMConfig,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference WavLM ``state_dict`` → the ``state_dict`` of :class:`WavLM`
    (keys under ``prefix``).  The same keys as the JAX package's
    ``convert_wavlm_state`` read: the pos conv under either spelling
    (``parametrizations.weight.original0/1`` or ``weight_g/_v``);
    ``post_extract_proj``, ``mask_emb``, ``relative_attention_bias`` and the
    ``grep_*`` gate only where the checkpoint has them; other keys ignored."""
    sd = {k: torch.as_tensor(v).detach().float().clone() for k, v in torch_state.items()}
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, key: str) -> None:
        out[prefix + name] = sd[key]

    for i, _ in enumerate(cfg.conv_layers):
        src = f"feature_extractor.conv_layers.{i}."
        put(f"feature_extractor.conv_{i}.weight", src + "0.weight")
        if cfg.conv_bias:
            put(f"feature_extractor.conv_{i}.bias", src + "0.bias")
        if cfg.extractor_mode == "layer_norm":
            put(f"feature_extractor.ln_{i}.weight", src + "2.1.weight")
            put(f"feature_extractor.ln_{i}.bias", src + "2.1.bias")
        elif i == 0:
            put("feature_extractor.gn_0.weight", src + "2.weight")
            put("feature_extractor.gn_0.bias", src + "2.bias")
    put("layer_norm.weight", "layer_norm.weight")
    put("layer_norm.bias", "layer_norm.bias")
    if "post_extract_proj.weight" in sd:
        put("post_extract_proj.weight", "post_extract_proj.weight")
        put("post_extract_proj.bias", "post_extract_proj.bias")
    if "mask_emb" in sd:
        put("mask_emb", "mask_emb")
    pc = "encoder.pos_conv.0."
    if pc + "parametrizations.weight.original0" in sd:
        put("pos_conv.weight_g", pc + "parametrizations.weight.original0")
        put("pos_conv.weight_v", pc + "parametrizations.weight.original1")
    else:
        put("pos_conv.weight_g", pc + "weight_g")
        put("pos_conv.weight_v", pc + "weight_v")
    put("pos_conv.bias", pc + "bias")
    put("encoder_layer_norm.weight", "encoder.layer_norm.weight")
    put("encoder_layer_norm.bias", "encoder.layer_norm.bias")
    for i in range(cfg.encoder_layers):
        src, dst = f"encoder.layers.{i}.", f"layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            for leaf in ("weight", "bias"):
                put(f"{dst}self_attn.{proj}.{leaf}", f"{src}self_attn.{proj}.{leaf}")
        if src + "self_attn.relative_attention_bias.weight" in sd:
            put(dst + "self_attn.relative_attention_bias",
                src + "self_attn.relative_attention_bias.weight")
        if src + "self_attn.grep_linear.weight" in sd:
            put(dst + "self_attn.grep_linear.weight", src + "self_attn.grep_linear.weight")
            put(dst + "self_attn.grep_linear.bias", src + "self_attn.grep_linear.bias")
            put(dst + "self_attn.grep_a", src + "self_attn.grep_a")
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            put(f"{dst}{ln}.weight", f"{src}{ln}.weight")
            put(f"{dst}{ln}.bias", f"{src}{ln}.bias")
        for fc in ("fc1", "fc2"):
            put(f"{dst}{fc}.weight", f"{src}{fc}.weight")
            put(f"{dst}{fc}.bias", f"{src}{fc}.bias")
    return out


def load_wavlm_checkpoint(pt_path: str) -> Tuple[Dict[str, torch.Tensor], WavLMConfig]:
    """A reference WavLM ``.pt`` (a torch pickle with ``cfg`` and ``model``)
    → (``state_dict`` of :class:`WavLM`, its config)."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    cfg = WavLMConfig.from_dict(ckpt["cfg"])
    return convert_wavlm_state(ckpt["model"], cfg), cfg
