"""float32 on the card means float32 (``core/precision.py``): a CUDA task or
augmentor switches TF32 off for matmuls and cuDNN convolutions, and the
16-bit reductions of bfloat16 and float16 GEMMs, whatever the entry that
builds it; a
CPU one leaves the flags alone.  On the CPU the CUDA
constructors are followed up to the point where they would meet the card,
with the precision function replaced by a recorder."""

import pytest
import torch

from speechlid_tpu_torch.core import precision
from speechlid_tpu_torch.data import augmentor
from speechlid_tpu_torch.tasks import lid_asr

HPARAMS = dict(lang2vocab={"aa": 5, "bb": 6}, lang2index={"aa": 0, "bb": 1}, n_blocks=1,
               encoder_dim=32, heads=2, dim_head=16, head_dim_head=8, head_num_head=2)


@pytest.fixture
def tf32_on():
    """The four flags on, as PyTorch's defaults have the cuDNN and the
    16-bit ones; restored after."""
    saved = _flags()
    _set_flags(True, True, True, True)
    yield
    _set_flags(*saved)


def _flags():
    matmul = torch.backends.cuda.matmul
    return (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            matmul.allow_bf16_reduced_precision_reduction,
            matmul.allow_fp16_reduced_precision_reduction)


def _set_flags(tf32, cudnn_tf32, bf16_reduction, fp16_reduction):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = bf16_reduction
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = fp16_reduction


@pytest.mark.usefixtures("tf32_on")
def test_strict_float32_switches_tf32_off_for_cuda_only():
    precision.strict_float32("cpu")
    assert _flags() == (True, True, True, True)
    precision.strict_float32(torch.device("cuda", 0))
    assert _flags() == (False, False, False, False)


@pytest.mark.usefixtures("tf32_on")
def test_cpu_task_and_augmentor_leave_the_flags_alone():
    lid_asr.LidASRTask(**HPARAMS, device="cpu")
    augmentor.WavAugmentor(speed=True)
    assert _flags() == (True, True, True, True)


@pytest.mark.parametrize("build", [
    lambda: lid_asr.LidASRTask(**HPARAMS, device="cuda"),
    lambda: augmentor.WavAugmentor(pitch=True, device="cuda"),
], ids=["LidASRTask", "WavAugmentor"])
def test_cuda_constructor_calls_strict_float32_first(build, monkeypatch):
    calls = []
    monkeypatch.setattr(lid_asr, "strict_float32", calls.append)
    monkeypatch.setattr(augmentor, "strict_float32", calls.append)
    if torch.cuda.is_available():
        build()
    else:
        with pytest.raises((AssertionError, RuntimeError)):  # no card here
            build()
    assert calls == [torch.device("cuda")]
