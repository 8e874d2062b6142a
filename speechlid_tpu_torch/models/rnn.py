"""The recurrent layers of the JAX package: flax's
``nn.Bidirectional(nn.RNN(nn.OptimizedLSTMCell(H)), nn.RNN(nn.OptimizedLSTMCell(H)))``
of the speech-enhancement models, the ``bilstm`` heads and the
bidirectional ``LSTMLM`` (:class:`BiLSTM`), one ``nn.RNN(nn.OptimizedLSTMCell(H))``
direction of the LM and forecasting models (:class:`LSTM`), over
``torch.lstm``, one ``nn.RNN(nn.GRUCell(H))`` direction of ``ResNet1D``'s
head (:class:`GRU`) and SELDNet's ``nn.Bidirectional(nn.RNN(nn.GRUCell(H)),
nn.RNN(nn.GRUCell(H)))`` (:class:`BiGRU`) over ``torch.gru`` (cuDNN on the
card for all of them).

flax's cell keeps eight leaves a direction: input kernels ``ii/if/ig/io``
(D, H) without a bias and recurrent kernels ``hi/hf/hg/ho`` (H, H) with one.
The gate order i, f, g, o and the gate functions (σ, σ, tanh, σ) are
torch's, so a direction here holds ``weight_ih`` (4H, D) = the input
kernels transposed and stacked, ``weight_hh`` (4H, H) likewise, and one
``bias`` (4H,) = the recurrent biases; torch's second bias (``b_ih``) is a
zero buffer, not a parameter.  The forward direction comes first in the
output's last axis, as in both libraries.  The carry starts at zeros.

With ``lengths`` (B,) the sequences run packed: each direction sees only
its first ``lengths[b]`` frames (the backward direction starts at the last
valid frame), as flax's ``seq_lengths`` does, and padded frames come out
as zeros where flax leaves non-zero values; callers read the valid frames
only.  Without ``lengths`` every frame is valid (the SE models run over
their own zero padding, as the JAX models do).

A single direction (:class:`LSTM`, :class:`GRU`) runs over every frame, as
flax's ``nn.RNN`` does: its outputs at the valid frames do not depend on the
padding behind them, and at padded frames they are flax's values too.

flax's ``GRUCell`` keeps input kernels ``ir/iz/in`` (D, H) with biases and
recurrent kernels ``hr/hz`` (H, H) without one and ``hn`` with one, and
computes ``r = σ(ir·x + hr·h)``, ``z = σ(iz·x + hz·h)``,
``n = tanh(in·x + r ⊙ hn·h)``, ``h' = (1 − z) ⊙ n + z ⊙ h``: torch's gate order
r, z, n and its formula, with ``b_ih`` the three input biases and ``b_hh``
= ``[0, 0, b_hn]``.  So a :class:`GRUDirection` holds ``weight_ih`` (3H, D),
``weight_hh`` (3H, H), ``bias_ih`` (3H,) and ``bias_hn`` (H,), and the two
zero blocks of ``b_hh`` are a buffer.  :class:`BiGRU` packs two of them as
:class:`BiLSTM` packs its LSTM: flax's backward direction reads the
reversed sequence and its outputs come back in the input's order, behind
the forward direction's in the last axis, which is ``torch.gru``'s
bidirectional layout.  It runs over every frame (SELDNet has no lengths).

The recurrence computes in its parameters' dtype (float32) whatever the
input's: flax's cell is built without a ``dtype`` in every JAX model that
uses it, so it promotes a bfloat16 input to its float32 parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence, pad_packed_sequence


class LSTMDirection(nn.Module):
    """One direction's parameters, in torch's stacked-gate layout."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        # torch.nn.LSTM's constructor draw; init_like_flax_ draws flax's
        bound = hidden ** -0.5
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, input_size).uniform_(-bound, bound))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))
        self.register_buffer("bias_ih", torch.zeros(4 * hidden), persistent=False)

    def flat_weights(self):
        return [self.weight_ih, self.weight_hh, self.bias_ih, self.bias]


class BiLSTM(nn.Module):
    """(B, T, D) → (B, T, 2H): forward ‖ backward hidden states."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.fwd = LSTMDirection(input_size, hidden)
        self.bwd = LSTMDirection(input_size, hidden)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.to(self.fwd.weight_ih.dtype)  # a bfloat16 input promotes
        weights = self.fwd.flat_weights() + self.bwd.flat_weights()
        b, t = x.shape[0], x.shape[1]
        h0 = x.new_zeros(2, b, self.hidden)
        if lengths is None:
            out, _, _ = torch.lstm(x, (h0, h0), weights, True, 1, 0.0, self.training, True, True)
            return out
        # a sequence of no frames has no valid output; one frame keeps packing legal
        packed = pack_padded_sequence(x, lengths.detach().cpu().clamp(min=1), batch_first=True,
                                      enforce_sorted=False)
        data, _, _ = torch.lstm(packed.data, packed.batch_sizes, (h0, h0), weights, True, 1,
                                0.0, self.training, True)
        out, _ = pad_packed_sequence(
            PackedSequence(data, packed.batch_sizes, packed.sorted_indices,
                           packed.unsorted_indices),
            batch_first=True, total_length=t)
        return out


class LSTM(nn.Module):
    """(B, T, D) → (B, T, H): one forward direction over every frame."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.cell = LSTMDirection(input_size, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.cell.weight_ih.dtype)
        h0 = x.new_zeros(1, x.shape[0], self.hidden)
        out, _, _ = torch.lstm(x, (h0, h0), self.cell.flat_weights(), True, 1, 0.0,
                               self.training, False, True)
        return out


class GRUDirection(nn.Module):
    """One flax ``GRUCell``'s parameters in torch's stacked-gate layout."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        # torch.nn.GRU's constructor draw; init_like_flax_ draws flax's
        bound = hidden ** -0.5
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, input_size).uniform_(-bound, bound))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden).uniform_(-bound, bound))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.bias_hn = nn.Parameter(torch.zeros(hidden))
        self.register_buffer("bias_hrz", torch.zeros(2 * hidden), persistent=False)

    def flat_weights(self):
        return [self.weight_ih, self.weight_hh, self.bias_ih,
                torch.cat([self.bias_hrz, self.bias_hn])]


class GRU(nn.Module):
    """(B, T, D) → (B, T, H): one forward ``GRUCell`` direction over every
    frame, the carry starting at zeros."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.cell = GRUDirection(input_size, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.cell.weight_ih.dtype)
        h0 = x.new_zeros(1, x.shape[0], self.hidden)
        out, _ = torch.gru(x, h0, self.cell.flat_weights(), True, 1, 0.0, self.training,
                           False, True)
        return out


class BiGRU(nn.Module):
    """(B, T, D) → (B, T, 2H): the forward ‖ backward ``GRUCell`` states
    over every frame, each carry starting at zeros."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.fwd = GRUDirection(input_size, hidden)
        self.bwd = GRUDirection(input_size, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.fwd.weight_ih.dtype)
        h0 = x.new_zeros(2, x.shape[0], self.hidden)
        out, _ = torch.gru(x, h0, self.fwd.flat_weights() + self.bwd.flat_weights(), True, 1,
                           0.0, self.training, True, True)
        return out
