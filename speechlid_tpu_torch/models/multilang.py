"""Per-language CTC heads and language discriminator (port of
``speechlid_tpu/models/multilang.py``): Conformer heads or BiLSTM heads.

The JAX package stacks the L heads' weights on a leading language axis and
runs them under ``nn.vmap``.  Here ``MultiLangHeadStack.heads[l]`` is head
``l`` (the same language order, axis 0 of every stacked JAX leaf), each head
runs in turn, and the logits stack to (L, B, T, V_max+1) as in JAX: vocab
sizes padded to V_max+1, padded ids masked to ``finfo(float32).min``, the
blank at index V_max for every language.  Each head's ConformerBlock runs
its own depthwise kernel launch.

``dtype`` (``"float32"`` or ``"bfloat16"``) is the heads' compute dtype,
as the JAX package's ``MutiLangModel(dtype=...)``: each head's block and
its ``Linear(V+1)`` compute in it, and the vocab mask promotes the logits
to float32 (JAX's float32 fill value does), so the logits, the scores and
the losses are float32 in either.  The discriminator computes in float32.

Training runs one head, the batch's own (``only=``): the JAX task computes
every head under ``vmap`` but takes the loss from the own head and commits
only the own head's BatchNorm statistics, so loss, gradients and state are
the same and two head passes are saved.  The other languages' rows of the
returned logits are then absent: the result is (1, B, T, V_max+1).

``quant_dot`` (``ops/quant.py``) reaches a Conformer head's blocks and its
``Linear(V+1)``, as in JAX; a BiLSTM head's ``Linear`` and the
discriminator stay exact, as they do there.

``head_type="bilstm"`` builds ``BiLSTMLinearHead``s: flax's bidirectional
``OptimizedLSTMCell`` (``models/rnn.py``, hidden ``linear_dim // 2`` a
direction) over the valid frames (packed by ``lengths``), dropout, then
``Linear(V+1)``.  flax's cell has no ``dtype`` there, so the recurrence is
float32 in a bfloat16 task too and only the last ``Linear`` computes in
``dtype``.  Padded frames come out as zeros where flax leaves values;
everything downstream (CTC, the scores) reads the valid frames only.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechlid_tpu_torch.core.precision import compute_dtype
from speechlid_tpu_torch.models.conformer import ConformerBlock, Dropout, Linear
from speechlid_tpu_torch.models.rnn import BiLSTM

_NEG = torch.finfo(torch.float32).min


class ConformerLinearHead(nn.Module):
    """N ConformerBlocks → dropout → Linear(V+1)."""

    def __init__(self, vocab_size: int, linear_dim: int = 768, num_layers: int = 1,
                 dim_head: int = 32, num_head: int = 8, use_double_swish: bool = False,
                 dropout: float = 0.0, dtype: Union[str, torch.dtype] = torch.float32,
                 quant_dot: Optional[str] = None):
        super().__init__()
        dtype = compute_dtype(dtype)
        self.dropout = Dropout(dropout)
        self.blocks = nn.ModuleList(
            ConformerBlock(linear_dim, dim_head=dim_head, heads=num_head,
                           use_double_swish=use_double_swish, dtype=dtype, quant_dot=quant_dot)
            for _ in range(num_layers)
        )
        self.out = Linear(linear_dim, vocab_size + 1, compute_dtype=dtype, quant_dot=quant_dot)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, mask)
        return self.out(self.dropout(x))


class BiLSTMLinearHead(nn.Module):
    """N bidirectional LSTMs (hidden ``linear_dim // 2`` a direction) →
    dropout → Linear(V+1)."""

    def __init__(self, vocab_size: int, linear_dim: int = 768, num_layers: int = 1,
                 dropout: float = 0.0, dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        hidden = linear_dim // 2
        self.dropout = Dropout(dropout)
        self.rnns = nn.ModuleList(
            BiLSTM(linear_dim if i == 0 else 2 * hidden, hidden) for i in range(num_layers))
        self.out = Linear(2 * hidden, vocab_size + 1, compute_dtype=compute_dtype(dtype))

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        for rnn in self.rnns:
            x = rnn(x, lengths)
        return self.out(self.dropout(x))


class MultiLangHeadStack(nn.Module):
    """(B, T, D) → float32 logits (L, B, T, V_max+1), padded vocab ids
    masked; with ``only=l`` just head l, (1, B, T, V_max+1)."""

    def __init__(self, vocab_sizes: Sequence[int], linear_dim: int = 768,
                 num_layers: int = 1, dim_head: int = 32, num_head: int = 8,
                 use_double_swish: bool = False, dropout: float = 0.0,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 head_type: str = "conformer_linear", quant_dot: Optional[str] = None):
        super().__init__()
        if head_type not in ("conformer_linear", "bilstm"):
            raise ValueError(f"unknown head_type: {head_type}")
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.vocab_max = max(self.vocab_sizes)
        self.head_type = head_type
        self.heads = nn.ModuleList(
            BiLSTMLinearHead(self.vocab_max, linear_dim, num_layers, dropout, dtype)
            if head_type == "bilstm" else
            ConformerLinearHead(self.vocab_max, linear_dim, num_layers, dim_head,
                                num_head, use_double_swish, dropout, dtype, quant_dot)
            for _ in self.vocab_sizes
        )
        ids = torch.arange(self.vocab_max + 1)
        sizes = torch.tensor(self.vocab_sizes)[:, None]
        valid = (ids[None, :] < sizes) | (ids[None, :] == self.vocab_max)  # chars ∪ blank
        self.register_buffer("vocab_valid", valid[:, None, None, :], persistent=False)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                only: Optional[int] = None) -> torch.Tensor:
        # what a head takes besides x: the lengths (packed LSTMs) or the padding mask
        valid = lengths
        if self.head_type != "bilstm" and lengths is not None:
            valid = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
        if only is not None:
            logits = self.heads[only](x, valid)[None].float()
            return logits.masked_fill(~self.vocab_valid[only : only + 1], _NEG)
        logits = torch.stack([head(x, valid) for head in self.heads]).float()
        return logits.masked_fill(~self.vocab_valid, _NEG)


def lang_confidence_scores(
    logits: torch.Tensor,  # (L, B, T, V+1), blank last
    vocab_sizes: torch.Tensor,  # (L,) true sizes
    lengths: Optional[torch.Tensor] = None,  # (B,) valid frames
    corrected: bool = False,
) -> torch.Tensor:
    """Confidence per (utterance, language), (B, L): over frames whose
    argmax is not blank, the mean max log-softmax normalised by ln(V_l), or
    the quadratic vocab-size-corrected variant (``corrected=True``).

    A head that decodes every frame as blank has no evidence and gets the
    worst score: -2.0 (below the reachable ≈ -1.1), or conf 0 for the
    corrected variant — the JAX package's deviation from the reference's
    0/0, kept here."""
    lp = F.log_softmax(logits.float(), dim=-1)
    max_value, argmax = lp.max(dim=-1)  # (L, B, T)
    blank = logits.shape[-1] - 1
    nonblank = argmax != blank
    if lengths is not None:
        frame_ok = torch.arange(logits.shape[2], device=logits.device)[None, :] < lengths[:, None]
        nonblank = nonblank & frame_ok[None, :, :]
    cnt = nonblank.sum(dim=-1).float()  # (L, B)
    total = torch.where(nonblank, max_value, torch.zeros_like(max_value)).sum(dim=-1)
    v = vocab_sizes.float()[:, None]
    has_evidence = cnt > 0
    if not corrected:
        score = torch.where(has_evidence, total / (cnt * torch.log(v) + 1e-5),
                            torch.full_like(total, -2.0))
    else:
        nb = vocab_sizes.max().float() + 1
        conf = torch.where(has_evidence, torch.exp(total / (cnt + 1e-5)),
                           torch.zeros_like(total))
        a = (nb - v - 1.0) / nb
        b = (1.0 + v) / nb
        score = a * conf ** 2 + b * conf
    return score.t()  # (B, L)


class LangDiscriminatorMLP(nn.Module):
    """2-layer MLP refining the (detached) confidence vector."""

    def __init__(self, n_lang: int, hidden_dim: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(n_lang, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, n_lang)

    def forward(self, scores: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(scores.detach())))


class MutiLangModel(nn.Module):
    """Featurizer + per-language CTC heads + discriminator.

    ``featurizer`` maps (feats, lengths) → (B, T', D) and has
    ``subsampled_lengths``.  ``forward`` returns (logits (L, B, T', V+1),
    feat_lengths), or with ``only=l`` head l's logits alone as (1, B, T',
    V+1); :meth:`infer` the all-language scoring dict."""

    def __init__(self, featurizer: nn.Module, vocab_sizes: Sequence[int],
                 linear_dim: int = 768, num_layers: int = 1, dim_head: int = 32,
                 num_head: int = 8, use_double_swish: bool = False, disc_hidden: int = 128,
                 dropout: float = 0.0, dtype: Union[str, torch.dtype] = torch.float32,
                 head_type: str = "conformer_linear", quant_dot: Optional[str] = None):
        super().__init__()
        self.featurizer = featurizer
        self.heads = MultiLangHeadStack(vocab_sizes, linear_dim, num_layers, dim_head,
                                        num_head, use_double_swish, dropout, dtype, head_type,
                                        quant_dot)
        self.discriminator = LangDiscriminatorMLP(len(vocab_sizes), disc_hidden)
        self.register_buffer("vocab_sizes", torch.tensor(tuple(vocab_sizes)),
                             persistent=False)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                only: Optional[int] = None):
        feats = self.featurizer(x, lengths)
        feat_lengths = None if lengths is None else self.featurizer.subsampled_lengths(lengths)
        return self.heads(feats, feat_lengths, only), feat_lengths

    def infer(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        """All-language inference: logits, feat_lengths, confidence scores,
        MLP scores and the predicted language (argmax of the scores)."""
        logits, feat_lengths = self(x, lengths)
        scores = lang_confidence_scores(logits, self.vocab_sizes, feat_lengths)
        return {
            "logits": logits,
            "feat_lengths": feat_lengths,
            "scores": scores,
            "mlp_scores": self.discriminator(scores),
            "pred_lang": scores.argmax(dim=-1),
        }
