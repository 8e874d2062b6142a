"""wav2vec 2.0 upstreams and the s3prl-style Featurizer (port of
``speechlid_tpu/models/wav2vec2.py``).

The inference path of fairseq's ``Wav2Vec2Model`` is WavLM without the
gated relative position bias, so the encoder is :class:`WavLM` with
``relative_position_embedding=False``: one implementation, two
checkpoints.  The quantizer and contrastive heads exist only for
pre-training; the fairseq loader drops them.

:class:`Wav2Vec2Conformer` is the wav2vec 2.0 Conformer with relative
positions (arXiv:2010.05171; HF's ``Wav2Vec2ConformerModel``,
``position_embeddings_type="relative"``): WavLM's front end
(:class:`~speechlid_tpu_torch.models.wavlm.SSLFrontEnd`) under Conformer
layers (``models/conformer.ConformerBlock`` with Transformer-XL attention)
and a final LayerNorm; no positional conv (HF builds one and never calls
it).  It has no JAX counterpart and no checkpoint loader.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from speechlid_tpu_torch.core.precision import compute_dtype
from speechlid_tpu_torch.core.profile import _time_cost_recoder
from speechlid_tpu_torch.models.conformer import ConformerBlock, Dropout, sinusoidal_table
from speechlid_tpu_torch.models.remat import remat_call
from speechlid_tpu_torch.models.wavlm import (
    LN_EPS,
    LayerNorm,
    SSLFrontEnd,
    WavLM,
    WavLMConfig,
    conv_out_lengths,
    convert_wavlm_state,
)


def wav2vec2_config(
    encoder_layers: int = 12,
    encoder_embed_dim: int = 768,
    encoder_ffn_embed_dim: int = 3072,
    encoder_attention_heads: int = 12,
    extractor_mode: str = "default",  # 'layer_norm' for large/XLSR
    layer_norm_first: bool = False,
    conv_feature_layers: str = "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2",
    conv_bias: bool = False,
    normalize: bool = False,
    **overrides: Any,
) -> WavLMConfig:
    return WavLMConfig(
        extractor_mode=extractor_mode,
        encoder_layers=encoder_layers,
        encoder_embed_dim=encoder_embed_dim,
        encoder_ffn_embed_dim=encoder_ffn_embed_dim,
        encoder_attention_heads=encoder_attention_heads,
        layer_norm_first=layer_norm_first,
        conv_feature_layers=conv_feature_layers,
        conv_bias=conv_bias,
        normalize=normalize,
        relative_position_embedding=False,
        gru_rel_pos=False,
        **overrides,
    )


@dataclass(frozen=True)
class Wav2Vec2ConformerConfig(WavLMConfig):
    """The wav2vec 2.0 Conformer's config: WavLM's fields for the front end
    and the widths (``encoder_ffn_embed_dim`` the FFNs' hidden width), the
    depthwise kernel's taps, and the defaults of the published Large (24 ×
    1024, 16 heads, FFN 4096, swish, a layer-norm extractor with conv
    biases).  ``dropout`` takes HF's ``hidden_dropout`` and
    ``conformer_conv_dropout``, ``activation_dropout`` the FFNs' hidden
    dropout, ``attention_dropout`` the probabilities' and the attention
    output's.  The positional conv's fields go unused."""

    extractor_mode: str = "layer_norm"
    encoder_layers: int = 24
    encoder_embed_dim: int = 1024
    encoder_ffn_embed_dim: int = 4096
    encoder_attention_heads: int = 16
    activation_fn: str = "swish"
    layer_norm_first: bool = True
    conv_bias: bool = True
    depthwise_conv_kernel_size: int = 31


def wav2vec2_conformer_config(**conf: Any) -> Wav2Vec2ConformerConfig:
    """The config from an ``ssl_config`` dict; keys that are not fields are
    dropped, as :meth:`WavLMConfig.from_dict` drops them."""
    cfg = Wav2Vec2ConformerConfig.from_dict(conf)
    if cfg.activation_fn != "swish" or not cfg.layer_norm_first:
        raise ValueError("the wav2vec 2.0 Conformer's layers are swish FFNs around pre-LN "
                         f"blocks; got activation_fn={cfg.activation_fn!r}, "
                         f"layer_norm_first={cfg.layer_norm_first}")
    return cfg


class Wav2Vec2Conformer(SSLFrontEnd):
    """(B, T) wave → (last hidden state (B, T', C), frame lengths or None[,
    hidden states of every layer, input first]): :meth:`SSLFrontEnd.front`,
    then (span ``model.encoder``) dropout, ``layers`` (each a
    :class:`ConformerBlock`: ½FFN, XL attention over the shared sinusoidal
    table of 2T' − 1 positions, a bias-free conv module of expansion 1 at
    C channels, ½FFN, LayerNorm; every LayerNorm eps 1e-5) and
    ``encoder_layer_norm``.  Padding follows ``mask_attention``: by default
    no mask reaches the attention or the conv module (the BatchNorm's
    statistics take every frame)."""

    def __init__(self, config: Wav2Vec2ConformerConfig, mask_attention: bool = False,
                 remat: bool = False):
        super().__init__(config, mask_attention, remat)
        c, h = config.encoder_embed_dim, config.encoder_attention_heads
        self.dropout = Dropout(config.dropout)
        self.layers = nn.ModuleList(
            ConformerBlock(c, dim_head=c // h, heads=h,
                           ff_mult=config.encoder_ffn_embed_dim // c,
                           conv_expansion_factor=1,
                           conv_kernel_size=config.depthwise_conv_kernel_size,
                           attn_dropout=config.attention_dropout, ff_dropout=config.dropout,
                           conv_dropout=config.dropout, dtype=compute_dtype(config.dtype),
                           quant_dot=config.quant_dot, attention="xl", ln_eps=LN_EPS,
                           conv_bias=False, ff_hidden_dropout=config.activation_dropout)
            for _ in range(config.encoder_layers))
        self.encoder_layer_norm = LayerNorm(c, eps=LN_EPS)

    def forward(self, source: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                mask: bool = False, ret_layer_results: bool = False):
        x, feat_len, pad_mask = self.front(source, lengths, mask)
        valid = None if pad_mask is None else ~pad_mask
        with _time_cost_recoder.span("model.encoder"):
            x = self.dropout(x)
            pe = sinusoidal_table(x.shape[1], x.shape[2], x.device)
            layer_results = [x]
            for layer in self.layers:
                y = remat_call(layer, x, valid, pe) if self.remat else layer(x, valid, pe)
                x = self.layer_drop(x, y)
                layer_results.append(x)
            x = self.encoder_layer_norm(x)
        if ret_layer_results:
            return x, feat_len, layer_results
        return x, feat_len


class Wav2Vec2(nn.Module):
    """The wav2vec2 encoder: :class:`WavLM` under the name ``encoder``."""

    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.config = config
        self.encoder = WavLM(config)

    def feat_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return conv_out_lengths(lengths, self.config.conv_layers)

    def forward(self, x, lengths=None, mask=False, ret_layer_results=False):
        return self.encoder(x, lengths, mask=mask, ret_layer_results=ret_layer_results)


class Featurizer(nn.Module):
    """Softmax-weighted sum of the hidden states (``layer_weights``, zeros at
    init, so a plain mean at first), or the last one
    (``feature_selection="last_hidden_state"``, no parameter).  The sum is
    float32 for bfloat16 states, as JAX's ``tensordot`` of the float32
    weights promotes them."""

    def __init__(self, num_layers: int, feature_selection: str = "hidden_states"):
        super().__init__()
        self.feature_selection = feature_selection
        self.layer_weights = None
        if feature_selection != "last_hidden_state":
            self.layer_weights = nn.Parameter(torch.zeros(num_layers))

    def forward(self, layer_feats: torch.Tensor) -> torch.Tensor:  # (L, B, T, C)
        if self.layer_weights is None:
            return layer_feats[-1]
        norm = torch.softmax(self.layer_weights, dim=0)
        feats = layer_feats.to(torch.promote_types(norm.dtype, layer_feats.dtype))
        return torch.tensordot(norm, feats, dims=([0], [0]))


class SSLFeaturizerModel(nn.Module):
    """Upstream (WavLM or wav2vec2, or the wav2vec 2.0 Conformer for a
    :class:`Wav2Vec2ConformerConfig`) + Featurizer: (B, T) normalised wave →
    (B, T', C).  Span masking runs in training mode (the JAX module's
    ``mask=not deterministic``); ``remat`` rematerializes each encoder
    layer in the backward pass (:class:`WavLM`)."""

    def __init__(self, config: WavLMConfig, feature_selection: str = "last_hidden_state",
                 mask_attention: bool = False, remat: bool = False):
        super().__init__()
        self.config = config
        self.feature_selection = feature_selection
        upstream = Wav2Vec2Conformer if isinstance(config, Wav2Vec2ConformerConfig) else WavLM
        self.upstream = upstream(config, mask_attention=mask_attention, remat=remat)
        if feature_selection != "last_hidden_state":
            self.featurizer = Featurizer(config.encoder_layers + 1, feature_selection)

    def subsampled_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        return conv_out_lengths(lengths, self.config.conv_layers)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.feature_selection == "last_hidden_state":
            return self.upstream(x, lengths, mask=self.training)[0]
        _, _, layers = self.upstream(x, lengths, mask=self.training, ret_layer_results=True)
        return self.featurizer(torch.stack(layers, dim=0))


# ---------------------------------------------------------------------------
# fairseq checkpoints
# ---------------------------------------------------------------------------

_DROP_PREFIXES = ("quantizer.", "project_q.", "final_proj.", "target_glu.")


def convert_fairseq_wav2vec2_state(torch_state: Dict[str, Any], cfg: WavLMConfig,
                                   prefix: str = "") -> Dict[str, torch.Tensor]:
    """A fairseq ``Wav2Vec2Model`` ``state_dict`` → the ``state_dict`` of
    :class:`WavLM`: fairseq and WavLM share the inference path's names; the
    pre-training heads are dropped."""
    state = {k: v for k, v in torch_state.items()
             if not any(k.startswith(p) for p in _DROP_PREFIXES)}
    return convert_wavlm_state(state, cfg, prefix)


def load_fairseq_wav2vec2_checkpoint(pt_path: str) -> Tuple[Dict[str, torch.Tensor], WavLMConfig]:
    """A fairseq wav2vec2 ``.pt`` → (``state_dict`` of :class:`WavLM`,
    config), without fairseq.  The config is ``cfg`` or ``args`` (a dict or
    a namespace), or its ``model`` entry where it has one."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    args = ckpt.get("cfg") or ckpt.get("args")
    if isinstance(args, dict) and "model" in args:
        args = args["model"]
    elif hasattr(args, "model"):
        args = args.model
    if not isinstance(args, dict):
        args = vars(args)
    cfg = wav2vec2_config(
        encoder_layers=args.get("encoder_layers", 12),
        encoder_embed_dim=args.get("encoder_embed_dim", 768),
        encoder_ffn_embed_dim=args.get("encoder_ffn_embed_dim", 3072),
        encoder_attention_heads=args.get("encoder_attention_heads", 12),
        extractor_mode=args.get("extractor_mode", "default"),
        layer_norm_first=args.get("layer_norm_first", False),
        conv_feature_layers=args.get(
            "conv_feature_layers", "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2"),
        conv_bias=args.get("conv_bias", False),
        normalize=args.get("normalize", False),
    )
    return convert_fairseq_wav2vec2_state(ckpt["model"], cfg), cfg
