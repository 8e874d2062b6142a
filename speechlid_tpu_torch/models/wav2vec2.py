"""wav2vec 2.0 upstream and the s3prl-style Featurizer (port of
``speechlid_tpu/models/wav2vec2.py``).

The inference path of fairseq's ``Wav2Vec2Model`` is WavLM without the
gated relative position bias, so the encoder is :class:`WavLM` with
``relative_position_embedding=False``: one implementation, two
checkpoints.  The quantizer and contrastive heads exist only for
pre-training; the fairseq loader drops them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from speechlid_tpu_torch.models.wavlm import (
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
    """Upstream (WavLM or wav2vec2) + Featurizer: (B, T) normalised wave →
    (B, T', C).  Span masking runs in training mode (the JAX module's
    ``mask=not deterministic``); ``remat`` rematerializes each encoder
    layer in the backward pass (:class:`WavLM`)."""

    def __init__(self, config: WavLMConfig, feature_selection: str = "last_hidden_state",
                 mask_attention: bool = False, remat: bool = False):
        super().__init__()
        self.config = config
        self.feature_selection = feature_selection
        self.upstream = WavLM(config, mask_attention=mask_attention, remat=remat)
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
