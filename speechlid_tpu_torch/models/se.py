"""Speech enhancement: the DPRNN-TasNet masker and SI-SNR (port of
``speechlid_tpu/models/se.py``).

A learned conv encoder → chunked dual-path (intra ‖ inter) BiLSTM with
LayerNorm → sigmoid mask → transposed-conv overlap-add decoder, waveform
in, waveform out: the ``enhance_fn`` of the eval harness and ``/se``.

Parity details:

- the pads are the JAX model's: the wave is right-padded so that the
  encoder's frames tile it exactly, the frames right-padded with zeros to
  whole chunks, and the LSTMs run over those zero frames (no packing);
- LayerNorm eps is flax's 1e-6 (``models/conformer.LayerNorm``);
- the decoder is flax's ``ConvTranspose(padding="VALID")``, which does not
  flip its kernel where ``F.conv_transpose1d`` does: ``convert`` flips the
  kernel's taps both ways, so ``decoder.weight`` is (in, out, k) with the
  taps reversed against the flax kernel (k, in, out).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechlid_tpu_torch.models.conformer import LayerNorm
from speechlid_tpu_torch.models.rnn import BiLSTM


class DualPathBlock(nn.Module):
    """Intra-chunk then inter-chunk BiLSTM, each projected back, layer
    normed and added to its input: (B, S, K, N) → (B, S, K, N)."""

    def __init__(self, dim: int, hidden: int = 64):
        super().__init__()
        self.intra_rnn = BiLSTM(dim, hidden)
        self.intra_proj = nn.Linear(2 * hidden, dim)
        self.intra_ln = LayerNorm(dim)
        self.inter_rnn = BiLSTM(dim, hidden)
        self.inter_proj = nn.Linear(2 * hidden, dim)
        self.inter_ln = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, k, n = x.shape
        # intra: along the chunk axis K, for every segment
        intra = self.intra_proj(self.intra_rnn(x.reshape(b * s, k, n)))
        x = x + self.intra_ln(intra.reshape(b, s, k, n))
        # inter: along the segment axis S, for every chunk position
        inter_in = x.permute(0, 2, 1, 3).reshape(b * k, s, n)
        inter = self.inter_ln(self.inter_proj(self.inter_rnn(inter_in)).reshape(b, k, s, n))
        return x + inter.permute(0, 2, 1, 3)


class DPRNNEnhancer(nn.Module):
    """(B, T) noisy waveform → (B, T) enhanced waveform."""

    def __init__(self, enc_dim: int = 64, win: int = 16, chunk: int = 100, n_blocks: int = 2,
                 hidden: int = 64):
        super().__init__()
        self.enc_dim, self.win, self.chunk = enc_dim, win, chunk
        self.stride = win // 2
        self.encoder = nn.Conv1d(1, enc_dim, win, stride=self.stride)
        self.blocks = nn.ModuleList(DualPathBlock(enc_dim, hidden) for _ in range(n_blocks))
        self.mask_proj = nn.Linear(enc_dim, enc_dim)
        self.decoder = nn.ConvTranspose1d(enc_dim, 1, win, stride=self.stride)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        b, t = wav.shape
        # pad so that both framing and chunking are exact
        n_frames = -(-(t - self.win) // self.stride) + 1
        pad_t = (n_frames - 1) * self.stride + self.win - t
        x = F.pad(wav, (0, pad_t))[:, None, :]
        feats = F.relu(self.encoder(x)).transpose(1, 2)  # (B, F, N)
        f = feats.shape[1]
        s = -(-f // self.chunk)
        y = F.pad(feats, (0, 0, 0, s * self.chunk - f)).reshape(b, s, self.chunk, self.enc_dim)
        for block in self.blocks:
            y = block(y)
        mask = torch.sigmoid(self.mask_proj(y)).reshape(b, s * self.chunk, self.enc_dim)[:, :f]
        out = self.decoder((feats * mask).transpose(1, 2))[:, 0]
        return out[:, :t]


def si_snr(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR (dB) per utterance, (B, T) → (B,)."""
    ref_zm = ref - ref.mean(dim=-1, keepdim=True)
    est_zm = est - est.mean(dim=-1, keepdim=True)
    proj = ((est_zm * ref_zm).sum(dim=-1, keepdim=True) * ref_zm
            / ((ref_zm ** 2).sum(dim=-1, keepdim=True) + eps))
    noise = est_zm - proj
    return 10.0 * torch.log10(((proj ** 2).sum(dim=-1) + eps) / ((noise ** 2).sum(dim=-1) + eps))
