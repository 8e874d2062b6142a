"""FaSNet-TAC and the original two-stage FaSNet: filter-and-sum networks for
multi-channel speech enhancement (port of ``speechlid_tpu/models/fasnet.py``).

The JAX package's formulation is kept where it decides the numbers:

- the sliding correlations (the cosine features and the filter-and-sum)
  are one batched FFT correlation, ``irfft(rfft(ref) · conj(rfft(kernel)))``
  (``torch.fft``, cuFFT on the card), the sliding L2 norms a clamped
  cumulative-sum difference, and the cosine is clipped to [-1, 1];
- where a window of the reference (or the target) is all zeros, as every
  window in the context padding at the edges is, the cosine is 0, the
  exact correlation's value.  The JAX package returns the FFT's rounding
  noise there, scaled by 1/eps and clipped: anything in [-1, 1], different
  on each FFT library and device, and the LSTMs carry it into every output
  sample.  The parity tests give the JAX function the same rule;
- windows are taken with ``Tensor.unfold`` and put back with ``F.fold``,
  whose backward and forward gather in a fixed order (a scatter-add such as
  ``index_add_`` sums with atomics on the card);
- a variable mic count (``num_mic``) is a channel mask and a masked mean;
- ``GlobalLayerNorm`` normalises over channels and space jointly with the
  biased variance and eps 1e-8; flax's ``nn.PReLU`` is one scalar slope,
  0.01 at init, applied where x < 0.

Tensors are laid out as in the JAX package: (B, ch, N, K, S) segments, the
Dense layers acting on the last axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from speechlid_tpu_torch.models.rnn import BiLSTM as _BiRNN

# ---------------------------------------------------------------------------
# sliding-window primitives (shared by cosine features and filter-and-sum)
# ---------------------------------------------------------------------------


def sliding_corr(ref: torch.Tensor, kernel: torch.Tensor, out_len: int) -> torch.Tensor:
    """``out[..., k] = Σ_j ref[..., k+j] · kernel[..., j]`` for ``k < out_len``
    (valid cross-correlation, ``F.conv1d`` semantics), by FFT; exact for
    ``out_len ≤ n − m + 1``.  Leading axes broadcast."""
    n = ref.shape[-1]
    rf = torch.fft.rfft(ref, n=n)
    kf = torch.fft.rfft(kernel, n=n)
    return torch.fft.irfft(rf * kf.conj(), n=n)[..., :out_len]


def sliding_sumsq(ref: torch.Tensor, m: int) -> torch.Tensor:
    """Sum of squares over every length-``m`` window: (..., n) → (..., n − m + 1)."""
    sq = torch.cumsum(ref.float() ** 2, dim=-1)
    sq = torch.cat([torch.zeros_like(sq[..., :1]), sq], dim=-1)
    # the cumsum difference can dip below zero by rounding: NaN under sqrt
    return (sq[..., m:] - sq[..., : sq.shape[-1] - m]).clamp(min=0.0)


def sliding_cosine(ref: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity of ``target`` against every window of ``ref``:
    (..., n) × (..., m) → (..., n − m + 1)."""
    m = target.shape[-1]
    num = sliding_corr(ref, target, ref.shape[-1] - m + 1)
    sumsq = sliding_sumsq(ref, m)
    t_norm = torch.linalg.vector_norm(target, dim=-1, keepdim=True)
    cos = (num / ((torch.sqrt(sumsq) + eps) * (t_norm + eps))).clamp(-1.0, 1.0)
    # an all-zero window (or target) has cosine 0, the exact correlation's
    # value; the FFT leaves rounding noise there, which the eps-guarded
    # norms amplify to anything in [-1, 1]
    return torch.where((sumsq == 0) | (t_norm == 0), torch.zeros_like(cos), cos)


def overlap_add(windows: torch.Tensor, stride: int) -> torch.Tensor:
    """(..., L, W) windows at ``stride`` → (..., (L − 1)·stride + W), summed
    where they overlap (``F.fold``)."""
    lead, (n_win, w) = windows.shape[:-2], windows.shape[-2:]
    out_t = (n_win - 1) * stride + w
    cols = windows.reshape(-1, n_win, w).transpose(1, 2)  # (N, W, L)
    out = F.fold(cols, output_size=(1, out_t), kernel_size=(1, w), stride=(1, stride))
    return out.reshape(*lead, out_t)


def _masked_mean(x: torch.Tensor, num_valid: Optional[torch.Tensor], dim: int) -> torch.Tensor:
    """Mean over ``dim``; with ``num_valid`` (B,), only the first
    ``num_valid[b]`` entries count."""
    if num_valid is None:
        return x.mean(dim=dim)
    dim = dim % x.ndim
    shape = [1] * x.ndim
    shape[dim] = x.shape[dim]
    mask = (torch.arange(x.shape[dim], device=x.device).reshape(shape)
            < num_valid.reshape([-1] + [1] * (x.ndim - 1)))
    denom = mask.sum(dim=dim).clamp(min=1)
    return torch.where(mask, x, torch.zeros_like(x)).sum(dim=dim) / denom


def split_segments(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., N, T) → 50 %-overlap segments (..., N, K, S), padded with K/2
    in front and K/2 plus the rest behind, so overlap-add inverts it."""
    t = x.shape[-1]
    stride = k // 2
    rest = (k - (stride + t % k) % k) % k
    y = F.pad(x, (stride, rest + stride))
    return y.unfold(-1, k, stride).transpose(-1, -2)  # (..., N, K, S)


def merge_segments(segs: torch.Tensor, t: int) -> torch.Tensor:
    """The inverse of :func:`split_segments`: (..., N, K, S) → (..., N, T)."""
    stride = segs.shape[-2] // 2
    full = overlap_add(segs.transpose(-1, -2), stride)
    return full[..., stride : stride + t]


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


class PReLU(nn.Module):
    """flax ``nn.PReLU``: x where x ≥ 0, else ``negative_slope · x``, one
    scalar slope (0.01 at init)."""

    def __init__(self):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope * x)


class GlobalLayerNorm(nn.Module):
    """(B, C, *spatial): normalised over C and space jointly (biased
    variance, eps 1e-8), then a per-channel scale and bias."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, x.ndim))
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, unbiased=False, keepdim=True)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return ((x - mean) * torch.rsqrt(var + self.eps) * self.weight.reshape(shape)
                + self.bias.reshape(shape))


class BiLSTM(nn.Module):
    """Bidirectional LSTM, then a Dense back to ``out``: (B, T, N) → (B, T, out)."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.rnn = _BiRNN(dim, hidden)
        self.proj = nn.Linear(2 * hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.rnn(x))


class TACLayer(nn.Module):
    """Transform-average-concatenate across channels, (B, ch, N, K, S)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        h3 = 3 * hidden
        self.transform = nn.Linear(dim, h3)
        self.transform_act = PReLU()
        self.average = nn.Linear(h3, h3)
        self.average_act = PReLU()
        self.concat = nn.Linear(2 * h3, dim)
        self.concat_act = PReLU()
        self.norm = GlobalLayerNorm(dim)

    def forward(self, x: torch.Tensor, num_mic: Optional[torch.Tensor]) -> torch.Tensor:
        b, ch, n, k, s = x.shape
        feats = x.permute(0, 3, 4, 1, 2)  # B, K, S, ch, N
        tr = self.transform_act(self.transform(feats))
        mean = self.average_act(self.average(_masked_mean(tr, num_mic, dim=3)))
        cat = torch.cat([tr, mean[:, :, :, None, :].expand_as(tr)], dim=-1)
        out = self.concat_act(self.concat(cat)).permute(0, 3, 4, 1, 2)  # B, ch, N, K, S
        out = self.norm(out.reshape(b * ch, n, k, s))
        return x + out.reshape(b, ch, n, k, s)


class DualPathTAC(nn.Module):
    """Stack of (intra-chunk BiLSTM, inter-chunk BiLSTM, TAC) layers on
    (B, ch, N, K, S) segments → (B, ch, out_dim, K, S); ``use_tac=False``
    gives the plain DPRNN of the single-channel BF module."""

    def __init__(self, dim: int, hidden: int, n_layers: int = 4, out_dim: int = 64,
                 use_tac: bool = True):
        super().__init__()
        self.row = nn.ModuleList(BiLSTM(dim, hidden, dim) for _ in range(n_layers))
        self.row_norm = nn.ModuleList(GlobalLayerNorm(dim) for _ in range(n_layers))
        self.col = nn.ModuleList(BiLSTM(dim, hidden, dim) for _ in range(n_layers))
        self.col_norm = nn.ModuleList(GlobalLayerNorm(dim) for _ in range(n_layers))
        self.tac = nn.ModuleList(TACLayer(dim, hidden) for _ in range(n_layers)) \
            if use_tac else None
        self.act = PReLU()
        self.output = nn.Linear(dim, out_dim)

    def forward(self, x: torch.Tensor, num_mic: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, ch, n, k, s = x.shape
        for i in range(len(self.row)):
            # intra-segment: sequences along K, batched over (b, ch, s)
            row_in = x.reshape(b * ch, n, k, s).permute(0, 3, 2, 1).reshape(b * ch * s, k, n)
            row = self.row[i](row_in).reshape(b * ch, s, k, n).permute(0, 3, 2, 1)
            x = x + self.row_norm[i](row).reshape(b, ch, n, k, s)
            # inter-segment: sequences along S, batched over (b, ch, k)
            col_in = x.reshape(b * ch, n, k, s).permute(0, 2, 3, 1).reshape(b * ch * k, s, n)
            col = self.col[i](col_in).reshape(b * ch, k, s, n).permute(0, 3, 1, 2)
            x = x + self.col_norm[i](col).reshape(b, ch, n, k, s)
            if self.tac is not None:
                x = self.tac[i](x, num_mic)
        out = self.output(self.act(x).permute(0, 1, 3, 4, 2))  # B, ch, K, S, out
        return out.permute(0, 1, 4, 2, 3)


class BFModule(nn.Module):
    """Bottleneck → dual-path (TAC) → gated filter head:
    (B, ch, D, L) → (B, ch, nspk, L, filter_dim)."""

    def __init__(self, in_dim: int, feature_dim: int = 64, hidden_dim: int = 128,
                 filter_dim: int = 513, n_layers: int = 4, segment_size: int = 50,
                 nspk: int = 1, use_tac: bool = True):
        super().__init__()
        self.feature_dim, self.filter_dim = feature_dim, filter_dim
        self.segment_size, self.nspk = segment_size, nspk
        self.bottleneck = nn.Linear(in_dim, feature_dim, bias=False)
        self.dprnn = DualPathTAC(feature_dim, hidden_dim, n_layers,
                                 out_dim=feature_dim * nspk, use_tac=use_tac)
        self.out = nn.Linear(feature_dim, filter_dim)
        self.gate = nn.Linear(feature_dim, filter_dim)

    def forward(self, feats: torch.Tensor, num_mic: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, ch, _, length = feats.shape
        x = self.bottleneck(feats.transpose(-1, -2)).transpose(-1, -2)  # B, ch, N, L
        out = self.dprnn(split_segments(x, self.segment_size), num_mic)
        k, s = out.shape[-2], out.shape[-1]
        out = out.reshape(b, ch * self.nspk, self.feature_dim, k, s)
        y = merge_segments(out, length).transpose(-1, -2)  # B, ch·nspk, L, N
        filt = torch.tanh(self.out(y)) * torch.sigmoid(self.gate(y))
        return filt.reshape(b, ch, self.nspk, length, self.filter_dim)


def _context_chunks(wav: torch.Tensor, w: int, c: int) -> torch.Tensor:
    """(B, nmic, T) → (B, nmic, L, 2c + w) windows at stride w/2 with c of
    context on each side (the JAX models' segmentation with context)."""
    t = wav.shape[-1]
    stride = w // 2
    rest = (w - (stride + t % w) % w) % w
    x = F.pad(wav, (stride + c, rest + stride + c))
    return x.unfold(-1, 2 * c + w, stride)


class _FaSNetBase(nn.Module):
    def __init__(self, enc_dim: int, win_len_ms: float, context_len_ms: float, sr: int):
        super().__init__()
        self.enc_dim = enc_dim
        self.window = int(sr * win_len_ms / 1000)
        self.context = int(sr * context_len_ms / 1000)
        self.filter_dim = 2 * self.context + 1
        # a full-window conv of the context chunk is a Dense on it
        self.encoder = nn.Linear(2 * self.context + self.window, enc_dim, bias=False)
        self.enc_norm = GlobalLayerNorm(enc_dim)

    def encode(self, chunks: torch.Tensor) -> torch.Tensor:
        """(..., L, 2c + w) → (..., N, L), gLN over (N, L) of each channel."""
        e = self.encoder(chunks).transpose(-1, -2)
        return self.enc_norm(e.reshape(-1, self.enc_dim, chunks.shape[-2])).reshape(e.shape)


class FaSNetTAC(_FaSNetBase):
    """Single-stage FaSNet + TAC: (B, nmic, T) (+ optional ``num_mic`` (B,)
    valid channel counts) → (B, nspk, T)."""

    def __init__(self, enc_dim: int = 64, feature_dim: int = 64, hidden_dim: int = 128,
                 n_layers: int = 4, segment_size: int = 50, nspk: int = 1,
                 win_len_ms: float = 4.0, context_len_ms: float = 16.0, sr: int = 16000):
        super().__init__(enc_dim, win_len_ms, context_len_ms, sr)
        self.bf = BFModule(enc_dim + self.filter_dim, feature_dim, hidden_dim, self.filter_dim,
                           n_layers, segment_size, nspk, use_tac=True)

    def forward(self, wav: torch.Tensor, num_mic: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = wav.shape[-1]
        w, c = self.window, self.context
        chunks = _context_chunks(wav, w, c)  # B, nmic, L, 2c+w
        enc = self.encode(chunks)  # B, nmic, N, L
        # every channel's context against the reference mic's centre frame
        cos = sliding_cosine(chunks, chunks[:, :1, :, c : c + w]).transpose(-1, -2)
        filt = self.bf(torch.cat([enc, cos], dim=2), num_mic)  # B, nmic, nspk, L, 2c+1
        # filter-and-sum: correlate each chunk with its filter
        bf_win = sliding_corr(chunks[:, :, None], filt, w)  # B, nmic, nspk, L, w
        sig = overlap_add(bf_win, w // 2)[..., w // 2 : w // 2 + t]
        return _masked_mean(sig, num_mic, dim=1)


class FaSNetOrigin(_FaSNetBase):
    """The original two-stage FaSNet: stage 1 filters the reference mic into
    a clean cue, stage 2 beamforms every other mic against it, and the
    overlap-added outputs are averaged over the valid mics.  (B, nmic, T)
    (+ optional ``num_mic``) → (B, nspk, T); the encoder and its gLN serve
    both stages."""

    def __init__(self, enc_dim: int = 64, feature_dim: int = 64, hidden_dim: int = 128,
                 n_layers: int = 6, segment_size: int = 50, nspk: int = 1,
                 win_len_ms: float = 4.0, context_len_ms: float = 16.0, sr: int = 16000):
        super().__init__(enc_dim, win_len_ms, context_len_ms, sr)
        self.nspk = nspk
        self.ref_bf = BFModule(enc_dim + self.filter_dim, feature_dim, hidden_dim,
                               self.filter_dim, n_layers, segment_size, nspk, use_tac=False)
        self.other_bf = BFModule(enc_dim + self.filter_dim, feature_dim, hidden_dim,
                                 self.filter_dim, n_layers, segment_size, 1, use_tac=False)

    def forward(self, wav: torch.Tensor, num_mic: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, nmic, t = wav.shape
        w, c, nspk = self.window, self.context, self.nspk
        chunks = _context_chunks(wav, w, c)  # B, nmic, L, 2c+w
        length = chunks.shape[-2]
        center = chunks[..., c : c + w]

        # stage 1: the other mics' centre frames slid over the reference's
        # context, averaged over the valid others
        ref_cos = sliding_cosine(chunks[:, :1], center[:, 1:])  # B, nmic-1, L, 2c+1
        n_other = None if num_mic is None else (num_mic - 1).clamp(min=1)
        ref_cos = _masked_mean(ref_cos, n_other, dim=1)  # B, L, 2c+1
        ref_feat = torch.cat([self.encode(chunks[:, 0]), ref_cos.transpose(-1, -2)],
                             dim=1)[:, None]  # B, 1, N+2c+1, L
        ref_filter = self.ref_bf(ref_feat)[:, 0]  # B, nspk, L, 2c+1
        ref_out = sliding_corr(chunks[:, :1], ref_filter, w)  # B, nspk, L, w

        # stage 2: beamform the other mics against the cue
        other_ctx = chunks[:, None, 1:]  # B, 1, nmic-1, L, 2c+w
        other_cos = sliding_cosine(other_ctx, ref_out[:, :, None])  # B, nspk, nmic-1, L, 2c+1
        other_enc = self.encode(chunks[:, 1:].reshape(b * (nmic - 1), length, 2 * c + w))
        other_enc = other_enc.reshape(b, 1, nmic - 1, self.enc_dim, length).expand(
            b, nspk, nmic - 1, self.enc_dim, length)
        other_feat = torch.cat([other_enc, other_cos.transpose(-1, -2)], dim=3)
        other_filter = self.other_bf(other_feat.reshape(
            b * nspk, nmic - 1, self.enc_dim + self.filter_dim, length))[:, :, 0]
        other_out = sliding_corr(
            other_ctx.expand(b, nspk, nmic - 1, length, 2 * c + w).reshape(
                b * nspk, nmic - 1, length, 2 * c + w),
            other_filter, w).reshape(b, nspk, nmic - 1, length, w)

        all_out = torch.cat([ref_out[:, :, None], other_out], dim=2)  # B, nspk, nmic, L, w
        sig = overlap_add(all_out, w // 2)[..., w // 2 : w // 2 + t]
        return _masked_mean(sig, num_mic, dim=2)
