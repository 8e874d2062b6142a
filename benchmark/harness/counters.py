"""The yardstick's arithmetic: the H100's peaks, the bytes and operations
each hand-kernel launch needs, and the FLOPs of a model's forward pass.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit): 67
TFLOP/s in float32 outside the tensor cores (the port runs float32 with
TF32 off), 3.35 TB/s of HBM.

A launch's least time is the larger of its bytes over the bandwidth and its
operations over the float32 rate.  Bytes count each input read once and
each output written once; operations are what the mode's arithmetic needs.
The depthwise counts are those the port's kernel table was built with
(``bound_ms``: ``glu`` at (8, 99, 288) 0.00110 ms, ``glu_bn_act`` at (32,
149, 1536) 0.0263 ms), frozen here.  The fbank's is the log-mel's least
work (an FFT a frame; 0.000918 ms at (8, 64000)), not the table's count of
the kernel's dense DFT (0.0217 ms there): a kernel that changed its
algorithm must not read above its bound.

Model FLOPs count the products a forward pass needs at each row's valid
length: linear layers, convolutions (depthwise too), the attention's two
products and its relative-position products (one per query and key), the
fbank's least work (an FFT and the mel projection's nonzeros a frame); no
elementwise work, as ``torch.utils.flop_counter`` counts them.
"""

from __future__ import annotations

from typing import Dict, Iterable

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12

DTYPE_BYTES = {0: 4, 1: 2, 2: 2}  # the kernels' dtype codes: float32, bfloat16, float16
N_FFT, HOP = 512, 160


def bound_s(n_bytes: float, flops: float) -> float:
    return max(n_bytes / PEAK_HBM_BYTES_S, flops / PEAK_FP32_FLOPS)


# --------------------------------------------------------------- launches

def depthwise_cost(mode: str, b: int, t: int, c: int, k: int, size: int = 4,
                   masked: bool = True):
    """(bytes, operations) of one depthwise launch in ``mode``."""
    m = b * t if masked else 0
    if mode == "glu_bn_act":  # read h (2C) and the mask, write y; w, bias, BN's four rows
        return size * (3 * b * t * c + k * c + c) + m + 16.0 * c, b * t * c * (2.0 * k + 12)
    if mode == "glu":  # read h and the mask, write u and y
        return size * (4 * b * t * c + k * c + c) + m, b * t * c * (2.0 * k + 4)
    if mode == "glu_dx":  # read the output gradient, h and the mask, write dh
        return size * (5 * b * t * c + k * c) + m, b * t * c * (2.0 * k + 8)
    if mode in ("plain", "plain_dx"):
        return size * (2 * b * t * c + k * c + c), 2.0 * b * t * c * k
    if mode == "bwd_w":  # read x and g; the (k + 1, C) result is negligible
        return size * 2.0 * b * t * c, 2.0 * b * t * c * k
    raise ValueError(f"unknown depthwise mode {mode!r}")


def fbank_cost(b: int, t: int, n_mels: int = 80):
    """(bytes, operations) of one log-mel launch over (B, T) samples: the
    function's least work, whatever the kernel's algorithm.  Bytes: the
    wave read, the mel written, the filterbank's nonzeros (two a bin).
    Operations: :func:`reference.frontend.least_flops` (an FFT a frame);
    the bytes set the bound."""
    from reference.frontend import least_flops

    frames = 1 + t // HOP
    bins = N_FFT // 2 + 1
    n_bytes = 4.0 * (b * t + b * frames * n_mels + 2 * bins)
    return n_bytes, b * least_flops(frames, n_mels)


# ----------------------------------------------------------------- models

def model_flops(config: dict, lengths: Iterable[int], train: bool) -> float:
    """Forward products over rows of the given valid lengths (samples), as
    ``reference/model.flops`` counts them for the configuration's
    featurizer."""
    from reference import model

    cache: Dict[int, float] = {}
    total = 0.0
    for n in lengths:
        n = int(n)
        if n not in cache:
            cache[n] = model.flops(config, n, train)
        total += cache[n]
    return total
