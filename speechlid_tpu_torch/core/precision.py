"""float32 on the card means float32; bfloat16 is asked for by name.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32``), which would put the Conformer's
Conv2d subsampling and the augmentor's resample and reverb convolutions on a
10-bit mantissa, away from the JAX package's numbers.  Every place that puts
float32 work on a CUDA device calls :func:`strict_float32` first.  It also
keeps cuBLAS from reducing a bfloat16 GEMM's partial sums in bfloat16
(``allow_bf16_reduced_precision_reduction``, on by default): a bfloat16
product sums in float32, as the JAX package's bfloat16 dots do.

A model's compute dtype (the JAX package's ``dtype`` option: ``"float32"``
or ``"bfloat16"``) becomes a ``torch.dtype`` through :func:`compute_dtype`.
Parameters stay float32 whatever it is."""

from __future__ import annotations

from typing import Union

import torch


def strict_float32(device: Union[str, torch.device]) -> None:
    """Switch TF32 off for matmuls and cuDNN convolutions, and bfloat16
    reductions of bfloat16 GEMMs, when ``device`` is a CUDA device.  The
    flags are process-wide; a CPU device leaves them as they are."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """The ``torch.dtype`` of a compute-dtype option: ``"float32"`` or
    ``"bfloat16"`` (a ``torch.dtype`` of the two passes through).  Other
    names raise ``NotImplementedError``: the port computes in those two."""
    if isinstance(dtype, torch.dtype) and dtype in COMPUTE_DTYPES.values():
        return dtype
    if dtype in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[dtype]
    raise NotImplementedError(f"compute dtype {dtype!r} is not ported: float32 or bfloat16")
