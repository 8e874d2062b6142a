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

:func:`convert_joint_wavlm_lid_state` reads the reference's joint WavLM LID
model (``WavLMMutiLangModel``'s state dict) into this package's joint task
with a WavLM featurizer, as the JAX package's converter of the same name
reads it into flax.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from speechlid_tpu_torch.core.precision import compute_dtype
from speechlid_tpu_torch.core.profile import _time_cost_recoder
from speechlid_tpu_torch.models.conformer import ConformerBlock, Dropout, Linear
from speechlid_tpu_torch.models.rnn import BiLSTM
from speechlid_tpu_torch.models.wavlm import WavLMConfig, convert_wavlm_state
from speechlid_tpu_torch.parallel.mesh import copy_to_group, gather_from_group

_NEG = torch.finfo(torch.float32).min
span = _time_cost_recoder.span


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
    masked; with ``only=l`` just head l, (1, B, T, V_max+1).

    Expert parallelism (``parallel/sharding.py``, :meth:`set_experts`): a
    rank of the model group holds the heads ``l`` whose ``l // per`` is its
    model index; the others' slots are empty.  The input goes through
    ``copy_to_group``, so the encoder's gradient sums the ranks' heads'.
    All heads: each rank runs its own and the logits are gathered over the
    group to (L, B, T, V_max+1), the same on every rank.  ``only=l`` on a
    rank that does not own head l gives zeros (1, B, T, V_max+1) joined to
    the graph, so the rank's backward joins the group's collectives.  In
    training a rank draws the dropout masks of the heads it skips, so every
    rank's generator stays where one process's is."""

    expert_group = None
    experts_per_rank = 0

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
        self.draw = (dropout, self.heads[0].out.in_features)  # a head's dropout: p, width
        self.generator: Optional[torch.Generator] = None
        ids = torch.arange(self.vocab_max + 1)
        sizes = torch.tensor(self.vocab_sizes)[:, None]
        valid = (ids[None, :] < sizes) | (ids[None, :] == self.vocab_max)  # chars ∪ blank
        self.register_buffer("vocab_valid", valid[:, None, None, :], persistent=False)

    def set_experts(self, group, per: int) -> None:
        """Expert parallelism over ``group``: ``per`` heads a rank."""
        self.expert_group, self.experts_per_rank = group, per

    def owns(self, lang: int) -> bool:
        return self.expert_group is None or lang // self.experts_per_rank == \
            self.expert_group.index

    def _skip(self, x: torch.Tensor) -> None:
        """Draw what a skipped head's dropout would draw."""
        p, width = self.draw
        if self.training and p > 0.0:
            torch.rand((x.shape[0], x.shape[1], width), generator=self.generator,
                       device=x.device)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                only: Optional[int] = None) -> torch.Tensor:
        # what a head takes besides x: the lengths (packed LSTMs) or the padding mask
        valid = lengths
        if self.head_type != "bilstm" and lengths is not None:
            valid = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
        if self.expert_group is not None:
            x = copy_to_group(x, self.expert_group)
        if only is not None:
            if not self.owns(only):
                self._skip(x)
                zeros = x.new_zeros((1, x.shape[0], x.shape[1], self.vocab_max + 1),
                                    dtype=torch.float32)
                return zeros + 0.0 * x.sum()
            logits = self.heads[only](x, valid)[None].float()
            return logits.masked_fill(~self.vocab_valid[only : only + 1], _NEG)
        outs = []
        for lang, head in enumerate(self.heads):
            if self.owns(lang):
                outs.append(head(x, valid).float())
            else:
                self._skip(x)
        logits = torch.stack(outs)
        if self.expert_group is not None:
            logits = gather_from_group(logits, self.expert_group, 0)
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
        with span("model.featurizer"):
            feats = self.featurizer(x, lengths)
            feat_lengths = None if lengths is None else self.featurizer.subsampled_lengths(lengths)
        with span("model.heads"):
            return self.heads(feats, feat_lengths, only), feat_lengths

    def infer(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        """All-language inference: logits, feat_lengths, confidence scores,
        MLP scores and the predicted language (argmax of the scores)."""
        logits, feat_lengths = self(x, lengths)
        with span("model.scores"):
            scores = lang_confidence_scores(logits, self.vocab_sizes, feat_lengths)
            return {
                "logits": logits,
                "feat_lengths": feat_lengths,
                "scores": scores,
                "mlp_scores": self.discriminator(scores),
                "pred_lang": scores.argmax(dim=-1),
            }


# ---------------------------------------------------------------------------
# the reference's joint WavLM LID checkpoint
# ---------------------------------------------------------------------------

# a reference ConformerBlock's leaves (lid/conformer.py, under its
# PreNorm/Scale wrappers) → this package's ConformerBlock's, torch to torch
_REFERENCE_BLOCK = {
    "ff1.fn.norm": "norm_ff1", "ff1.fn.fn.net.0": "ff1.fc1", "ff1.fn.fn.net.3": "ff1.fc2",
    "attn.norm": "norm_attn", "attn.fn.to_q": "attn.to_q", "attn.fn.to_kv": "attn.to_kv",
    "attn.fn.to_out": "attn.to_out", "conv.net.0": "conv.norm", "conv.net.5": "conv.bn",
    "ff2.fn.norm": "norm_ff2", "ff2.fn.fn.net.0": "ff2.fc1", "ff2.fn.fn.net.3": "ff2.fc2",
    "post_norm": "post_norm",
}
_BLOCK_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _convert_reference_block(sd: Dict[str, np.ndarray], src: str, dst: str
                             ) -> Dict[str, np.ndarray]:
    """One reference ``ConformerBlock`` under ``src`` → this package's under
    ``dst``: Linears and norms leaf for leaf, the pointwise Conv1d (O, I, 1)
    → (O, I), the depthwise (C, 1, K) → the (K, C) the kernel takes."""
    out = {}
    for ref, ours in _REFERENCE_BLOCK.items():
        for leaf in _BLOCK_LEAVES:
            if f"{src}{ref}.{leaf}" in sd:
                out[f"{dst}{ours}.{leaf}"] = sd[f"{src}{ref}.{leaf}"]
    out[dst + "attn.rel_pos_emb"] = sd[src + "attn.fn.rel_pos_emb.weight"]
    for ref, ours in (("conv.net.2", "conv.pointwise_in"), ("conv.net.7", "conv.pointwise_out")):
        out[f"{dst}{ours}.weight"] = sd[f"{src}{ref}.weight"][:, :, 0]
        out[f"{dst}{ours}.bias"] = sd[f"{src}{ref}.bias"]
    out[dst + "conv.depthwise.weight"] = np.ascontiguousarray(
        sd[src + "conv.net.4.conv.weight"][:, 0, :].T)
    out[dst + "conv.depthwise.bias"] = sd[src + "conv.net.4.conv.bias"]
    return out


def convert_reference_heads(sd: Dict[str, np.ndarray], langs: Sequence[str],
                            lang2vocab: Dict[str, int], head_layers: int = 1
                            ) -> Dict[str, np.ndarray]:
    """The reference's per-language ``ConformerLinear`` heads
    (``model.last_projects.<lang>``) and language discriminator → this
    package's ``heads.heads.<l>`` and ``discriminator`` leaves (the JAX
    package's ``_convert_stacked_heads`` / ``_convert_discriminator``).
    Each ``Linear(D, V_l + 1)`` (blank at V_l) becomes the (V_max + 1)-row
    output every head has: character rows keep their index, the blank row
    goes to the shared last index V_max, the padded rows are zeros.  Every
    head layer reads the reference's one ``block``, as the JAX converter
    does."""
    vmax = max(lang2vocab[lg] for lg in langs)
    out: Dict[str, np.ndarray] = {}
    for li, lg in enumerate(langs):
        src, dst = f"model.last_projects.{lg}.", f"heads.heads.{li}."
        for i in range(head_layers):
            out.update(_convert_reference_block(sd, src + "block.", f"{dst}blocks.{i}."))
        w, b = sd[src + "linear.weight"], sd[src + "linear.bias"]  # (V_l + 1, D)
        v_l = w.shape[0] - 1
        weight = np.zeros((vmax + 1, w.shape[1]), np.float32)
        bias = np.zeros((vmax + 1,), np.float32)
        weight[:v_l], weight[vmax] = w[:v_l], w[v_l]
        bias[:v_l], bias[vmax] = b[:v_l], b[v_l]
        out[dst + "out.weight"], out[dst + "out.bias"] = weight, bias
    for ref, ours in (("0", "fc1"), ("2", "fc2")):
        for leaf in ("weight", "bias"):
            out[f"discriminator.{ours}.{leaf}"] = sd[f"lang_discriminator.linear.{ref}.{leaf}"]
    return out


def convert_joint_wavlm_lid_state(torch_state: Dict[str, Any], langs: Sequence[str],
                                  lang2vocab: Dict[str, int], wavlm_cfg: WavLMConfig,
                                  head_layers: int = 1) -> Dict[str, np.ndarray]:
    """The reference's ``WavLMMutiLangModel`` state dict (tensors or numpy)
    → the state dict of this package's ``MutiLangModel`` with a WavLM
    featurizer (``LidASRTask(featurizer="wavlm",
    feature_selection="last_hidden_state")``, the reference's
    ``only_last=True`` path): the upstream under ``featurizer.upstream.``
    through :func:`models.wavlm.convert_wavlm_state`, the heads and the
    discriminator through :func:`convert_reference_heads`.  → numpy float32
    arrays (the WavLM trunk has no BatchNorm)."""
    sd = {k: np.array(torch.as_tensor(v).detach().float().cpu().numpy())
          for k, v in torch_state.items()}
    prefix = "model.featurizer.model."
    upstream = convert_wavlm_state({k[len(prefix):]: v for k, v in sd.items()
                                    if k.startswith(prefix)}, wavlm_cfg,
                                   prefix="featurizer.upstream.")
    out = {k: v.numpy() for k, v in upstream.items()}
    out.update(convert_reference_heads(sd, langs, lang2vocab, head_layers))
    return out
