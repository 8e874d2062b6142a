"""The bidirectional LSTM of the JAX package's speech-enhancement models and
``bilstm`` heads: flax's
``nn.Bidirectional(nn.RNN(nn.OptimizedLSTMCell(H)), nn.RNN(nn.OptimizedLSTMCell(H)))``
over ``torch.lstm`` (cuDNN on the card).

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
