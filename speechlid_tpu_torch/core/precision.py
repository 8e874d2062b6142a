"""float32 on the card means float32; bfloat16 and float16 are asked for by
name.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32``), which would put the Conformer's
Conv2d subsampling and the augmentor's resample and reverb convolutions on a
10-bit mantissa, away from the JAX package's numbers.  Every place that puts
float32 work on a CUDA device calls :func:`strict_float32` first.  It also
keeps cuBLAS from reducing a bfloat16 or float16 GEMM's partial sums in
that type (``allow_bf16_reduced_precision_reduction`` and
``allow_fp16_reduced_precision_reduction``, on by default): a 16-bit
product sums in float32, as the JAX package's 16-bit dots do.

A model's compute dtype (the JAX package's ``dtype`` option: ``"float32"``,
``"bfloat16"`` or ``"float16"``) becomes a ``torch.dtype`` through
:func:`compute_dtype`.  Parameters stay float32 whatever it is."""

from __future__ import annotations

from typing import Union

import torch


def strict_float32(device: Union[str, torch.device]) -> None:
    """Switch TF32 off for matmuls and cuDNN convolutions, and 16-bit
    reductions of bfloat16 and float16 GEMMs, when ``device`` is a CUDA
    device.  The flags are process-wide; a CPU device leaves them as they
    are."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}


def compute_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """The ``torch.dtype`` of a compute-dtype option: ``"float32"``,
    ``"bfloat16"`` or ``"float16"`` (a ``torch.dtype`` of the three passes
    through).  Other names raise ``NotImplementedError``: the port computes
    in those three, the JAX package's float dtypes but float64."""
    if isinstance(dtype, torch.dtype) and dtype in COMPUTE_DTYPES.values():
        return dtype
    if dtype in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[dtype]
    raise NotImplementedError(
        f"compute dtype {dtype!r} is not ported: float32, bfloat16 or float16")
