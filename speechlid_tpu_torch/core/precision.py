"""float32 on the card means float32.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32``), which would put the Conformer's
Conv2d subsampling and the augmentor's resample and reverb convolutions on a
10-bit mantissa, away from the JAX package's numbers.  Every place that puts
float32 work on a CUDA device calls :func:`strict_float32` first."""

from __future__ import annotations

from typing import Union

import torch


def strict_float32(device: Union[str, torch.device]) -> None:
    """Switch TF32 off for matmuls and cuDNN convolutions when ``device`` is
    a CUDA device.  The flags are process-wide; a CPU device leaves them as
    they are."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
