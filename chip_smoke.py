#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``speechlid_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout, one H100
    python3 chip_smoke.py --only cli_gate [--seed N]   # the accuracy gate alone
    python3 chip_smoke.py --only ce_asr   # the cross-entropy and ASR phases alone
    python3 chip_smoke.py --only se   # the speech enhancement and bilstm phases alone
    python3 chip_smoke.py --only quant   # the int8, SWA and Novograd phases alone
    python3 chip_smoke.py --only extras  # kaldi, the extras tasks, the sweep, the trace alone
    python3 chip_smoke.py --only dist  # data-parallel training and SELDNet alone
    python3 chip_smoke.py --only mp  # tensor, expert, pipeline, sequence parallelism alone
    python3 chip_smoke.py --only large  # WavLM-Large, remat, async checkpoints, float16 alone
    python3 chip_smoke.py --only subsample  # the Conv2d subsampling kernels alone
    python3 chip_smoke.py --only relpos_attn  # the rel-pos kernels and their two upstreams

It builds the port's CUDA kernels from ``speechlid_tpu_torch/csrc`` (into
``build/``), holds each kernel, forward and backward, and each fused mode of
the depthwise forward kernel (the conv module's GLU, mask, conv, eval
BatchNorm and activation in one launch; GLU and mask in front of the
training forward; the GLU backward behind dX) against its plain PyTorch
version on the card, runs the full-width Conformer joint-LID model through
the kernels and against the same weights on the CPU (inference, and one
deterministic training step with every parameter's gradient), serves it on
``/lid`` from a thread and posts requests to it, trains it through
``Trainer.fit`` with augmentation, checkpoints, a resume and a served
request from the trained checkpoint.  Then it drives the training CLI
(``cli.main_lid``) on the round-5 tone-code corpus, written to a temporary
directory (``cli_corpus``): at full width from
``configs/lid_supervised.yaml`` for 9 steps, a resume and a request served
from the CLI's checkpoint (``cli_flagship``), and the round-5 accuracy gate,
the 4 × 96-d round-5 config for 32 epochs, with whether the held-out
``val_acc`` reached 0.9 (``cli_gate``; ``--only cli_gate [--seed N]`` runs
it alone).  Then: a bare ``LidASRTask`` on the card switches TF32 off
itself and agrees with the CPU (``tf32_entry``); the waveform ops of the
eval and augmentation paths agree with the CPU (``eval_ops``); the eval CLI
(``cli.test_lid``) scores both CLI checkpoints clean, over the SNR × noise
grid with LM arbitration and into a CSV and a submission file
(``cli_eval_flagship``, ``cli_eval_gate``); and the training CLI trains
with the waveform augmentor, whose chain on the card agrees with the CPU's
(``cli_augment``).  Then the WavLM-Base+ joint
model (12 × 768 with the gated relative position bias, three heads of 768
whose conv modules run the depthwise kernel at C = 1536): card against CPU
in inference (``wavlm_model_card_vs_cpu``) and for one deterministic train
step (``wavlm_train_card_vs_cpu``), served on ``/lid`` (``wavlm_serve``),
and through the training CLI on ``configs/lid_wavlm.yaml`` with the Base+
``module.ssl_config`` across both freeze gates with span masking, a resume,
a served request and ``cli.test_lid`` on its checkpoint (``cli_wavlm``);
then ``configs/torch/lid_wav2vec_conformer.yaml`` at 4 layers through the
training CLI across its transformer gate, its Transformer-XL attention
counted through the rel-pos kernels (``cli_w2v2_conformer``).
Then both models in bfloat16 (``dtype="bfloat16"``; WavLM's
``ssl_config.dtype`` too): card against CPU in inference
(``bf16_model_card_vs_cpu``, ``bf16_wavlm_model_card_vs_cpu``) and for a
B = 8, 4 s step held against a float32 step on the card
(``bf16_train_card_vs_cpu``), and ``configs/lid_wavlm_bf16.yaml`` through
both CLIs (``cli_wavlm_bf16``); ``conv_fused`` holds every bfloat16 kernel
mode against its bfloat16 plain version.  Then the training CLI's two other
tasks: the cross-entropy LID classifier, every back-end on fbank (the fbank
kernel) and both SSL configs, card against CPU in inference
(``ce_model_card_vs_cpu``) and for one deterministic train step of the
x-vector and ResNet34 (``ce_train_card_vs_cpu``); ``configs/lid_cross.yaml``
through the CLI for 4 epochs, a resume and ``stage=test``, held to learn as
the JAX CLI does (``cli_cross``); ``configs/lid_cross_wavlm.yaml`` with its
frozen upstream (``cli_cross_ssl``); and ``configs/asr.yaml`` for 6 steps and
``stage=test`` with an ARPA LM, the card's greedy and LM CER equal to the
CPU's on the same checkpoint (``cli_asr``); ``--only ce_asr`` runs these
alone.  Then speech enhancement and the bilstm heads: the DPRNN, FaSNet-TAC
(4 mics, a batch of valid mic counts) and FaSNet-Origin on the card
against the CPU, the output and one train step (``se_card_vs_cpu``);
``main_extras se`` trains the DPRNN on a tones-under-noise ``.npz`` to an
SI-SNR above the noisy input's with a checkpoint (``cli_se``); the eval CLI
scores ``cli_flagship``'s checkpoint with that SE model blended in at
``--factor 0.5`` and over ``--factor-sweep 0:1:0.5``, factor 0 equal to the
run without SE (``cli_eval_se``); one server answers ``/lid`` and ``/se``
from four threads (``serve_se``); ``LidASRTask(head_type="bilstm")`` at the
flagship's width on the card against the CPU, inference and a step
(``bilstm_card_vs_cpu``); ``--only se`` runs these alone.  Then the int8
engine (``ops/quant.py``), SWA and Novograd:
every quantized Linear shape of both flagship paths, the card's codes and
``_int_mm``'s int32 sums against the CPU's and a float64 oracle, timed
against ``F.linear`` in float32 and bfloat16 (``quant_dense``); ``serve
--quant int8`` on a checkpoint of each model, its scores against the CPU's
int8 scores (``quant_serve``); ``configs/lid_wavlm_qat.yaml`` through the
training CLI at the Base+ width, and one QAT step card against CPU
(``cli_qat``); ``test_lid --quant int8`` on ``cli_flagship``'s checkpoint
(``cli_eval_quant``); the flagship through the CLI with
``trainer.use_swa=true`` (``cli_swa``: the average and the re-estimated
statistics in ``swa_final.ckpt``) and with ``module.optimizer=novograd``
(``cli_novograd``); and the launches of ``infer`` in int8 and bfloat16 +
int8 (``quant_launches``); ``--only quant`` runs these alone.  Then kaldi fbank and
``FBankLayer`` on a padded (8, 64000) batch with a row shorter than the
kaldi window, card against the CPU's float64 (``kaldi_card_vs_cpu``); every
model of ``models/extras.py`` at ``main_extras``' default widths, card
against CPU in inference and for one step, and each task's steps
launching no hand kernel (``extras_card_vs_cpu``); ``main_extras lm | rml |
spec_pred | image`` on data ``prepare_text`` and ``prepare_spectrum``
prepared, two epochs each
with the training loss falling (``cli_extras``); the port's ``sweep`` on
``configs/sweep_lid.yaml``'s bayes spec over ``main_lid`` at full width, on
manifests ``prepare_manifest`` wrote, every trial launching the kernels
(``cli_sweep``); and ``Trainer(profile_dir=…)`` writing a trace with kernel
records (``profile_trace``); ``--only extras`` runs these alone.  Then data
parallelism: two ranks of ``Trainer.fit`` on the card (processes of their
own over gloo, B = 8 × 4 s a rank) against one process on the 16-row global
batch, the first step's gradients and the state after three Adam steps,
the ranks bit-equal and each rank's launches a step, then two steps with
every random draw on (``dp_card_vs_single``); ``main_lid`` with
``trainer.data_parallel=true`` under ``python -m torch.distributed.run``
over nccl at world size 1 (``cli_dp``); and both SELDNet presets card against CPU
(``seldnet_card_vs_cpu``); ``--only dist`` runs these alone.  Then tensor,
expert, pipeline and sequence parallelism (``--only mp``).  Then
``configs/lid_extra_finetune.yaml`` at its own WavLM-Large width (24 ×
1024, heads at 1024 whose conv modules run the depthwise kernel at C =
2048) through the training CLI on a corpus that fills its train buckets
from 2 to 13 s, three epochs, a resume and ``cli.test_lid`` on the best
checkpoint, its freeze gates and launches by channel count
(``cli_wavlm_large``); ``remat`` off and on for the Large, Base+ and
flagship steps, their losses, gradients, launches and peak memory
(``remat``); how long ``last.ckpt`` of the Large task blocks the loop
with ``async_write`` off and on (``async_ckpt``); and the flagship in
float16, card against CPU in inference and for one step
(``f16_card_vs_cpu``); ``conv_fused`` holds every depthwise mode at the
Large heads' shapes and every float16 mode against plain; ``--only large``
runs these alone.  Last
it checks the launches of the models' forwards and train steps that the
kernel rows count (``quant_launches``, ``ce_launches``, the WavLM and
bfloat16 ones), shows in CUDA graph captures two device kernels a depthwise
backward and one between a conv module's two pointwise GEMMs
(``device_kernels``), and times the kernels on the card.  The fused modes
are timed against the unfused chain they replace (``chain_ms``), in turns
chain, fused, fused, chain.  Each phase prints one JSON line (the eval CLI
prints its own result lines as well); any failure raises and exits
non-zero.  The ``{"kernels": …}`` line lists every kernel and fused mode at
the shape the served or the trained path gives it, with its launches as
counted on that path (``_build.launches``), its error against its plain
version at that shape and its times beside its bound.  End-to-end rates
are the benchmark's (``benchmark/run.py``), not this script's.  The last
line is ``{"ok": true, "device": …}``.

float32 with TF32 off for matmuls and cuDNN convolutions (cuDNN would
otherwise run the Conv2d subsampling in TF32), and bfloat16 where a phase
says so, with bf16 GEMMs summing in float32.  Weights are random, from a
seeded ``torch.Generator``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from speechlid_tpu_torch.cli import (
    main_extras,
    prepare_manifest,
    prepare_spectrum,
    prepare_text,
)
from speechlid_tpu_torch.cli import sweep as sweep_cli
from speechlid_tpu_torch.cli.serve import (
    InferenceState,
    build_lid_fn,
    build_se_fn,
    make_handler,
    make_lid_fn,
)
from speechlid_tpu_torch.core.callbacks import Callback, CkptCallback, ProfileCallback
from speechlid_tpu_torch.core.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from speechlid_tpu_torch.core.precision import strict_float32
from speechlid_tpu_torch.core.trainer import Trainer
from speechlid_tpu_torch.data.augmentor import WavAugmentor
from speechlid_tpu_torch.models.batchnorm import FlaxBatchNorm
from speechlid_tpu_torch.models import extras as extras_models
from speechlid_tpu_torch.models import resnet as presnet
from speechlid_tpu_torch.models import seldnet as seldnet_models
from speechlid_tpu_torch.models.fasnet import FaSNetOrigin, FaSNetTAC
from speechlid_tpu_torch.models.init import init_like_flax_
from speechlid_tpu_torch.models.se import DPRNNEnhancer, si_snr
from speechlid_tpu_torch.models.seldnet import seldnet_augmented, seldnet_vanilla
from speechlid_tpu_torch.models.conformer import (
    ConformerConvModule,
    Conv2dSubsampling,
    DepthwiseConv1d,
    Dropout,
    FBankLayer,
    MaskedBatchNorm,
)
from speechlid_tpu_torch.ops import frontend, quant
from speechlid_tpu_torch.ops.cuda import _build, fbank_kernel
from speechlid_tpu_torch.ops.cuda.depthwise_kernel import (
    FWD_MODES,
    BatchNormStats,
    batch_norm_act_plain,
    depthwise_conv1d,
    depthwise_conv1d_bwd_w,
    depthwise_conv1d_bwd_w_plain,
    depthwise_conv1d_bwd_w_tiled_plain,
    depthwise_conv1d_dx,
    depthwise_conv1d_plain,
    fwd_blocks,
    glu_depthwise,
    glu_depthwise_bn_act,
    glu_depthwise_bn_act_plain,
    glu_depthwise_dx,
    glu_depthwise_plain,
    glu_mask_bwd_plain,
)
from speechlid_tpu_torch.ops.cuda.fbank_kernel import (
    log_mel,
    log_mel_plain,
    log_mel_tiled_plain,
)
from speechlid_tpu_torch.ops.cuda import relpos_attn_kernel
from speechlid_tpu_torch.ops.cuda.relpos_attn_kernel import (
    relpos_attn_plain,
    relpos_attn_xl,
    relpos_attn_xl_plain,
    relpos_bwd,
    relpos_fwd,
    relpos_xl_bwd,
    relpos_xl_fwd,
    xl_operands,
)
from speechlid_tpu_torch.ops.cuda.subsample_kernel import (
    out_frames,
    subsample_bwd,
    subsample_conv_plain,
    subsample_fwd,
)
from speechlid_tpu_torch.tasks.asr import ASRTask
from speechlid_tpu_torch.tasks.extras import (
    ImageClassificationTask,
    LMTask,
    RMLTask,
    SpecPredTask,
)
from speechlid_tpu_torch.tasks.lid_asr import LidASRTask
from speechlid_tpu_torch.tasks.lid_cross_entropy import LidCrossEntropyTask
from speechlid_tpu_torch.tasks.se import SETask

SR = 16000
# H100 SXM data sheet, dense, at the 700 W limit: FP32 outside the tensor
# cores, and HBM3 bandwidth.  Bounds are stated against these peaks.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12
FBANK_TOL = 1e-3  # dB, atol and rtol: the JAX package's fbank tolerance
# the kernel's mean error against the float64 sums, over the plain version's,
# both taken over every cell of every shape checked
FBANK_MEAN_ERR_OVER_PLAIN = 1.25
DW_TOL = 1e-5  # f32, atol and rtol (tests/test_pallas_depthwise.py)
DW_BF16_TOL = (0.1, 0.15)  # rtol, atol of bf16 against the f32 result
# the bf16 kernel against its bf16 plain version: both round where the JAX
# module rounds, so they differ by flips of a float32 sum's rounding: at most
# 2 bf16 ulps of the output's largest entry
DW_BF16_ULPS = 2 * 2.0 ** -8
DW_BF16_GRAD_TOL = 2e-2  # bf16 gradients: of the f32 gradient's largest entry
DW_GRAD_TOL = 1e-4  # f32 gradients, atol and rtol (tests/test_pallas_depthwise.py)
# float16 as bfloat16, with its 3 more mantissa bits: the kernel against the
# float16 plain version within 2 float16 ulps of the largest entry, against
# the float32 result and gradients at an eighth of bfloat16's bars
DW_F16_ULPS = 2 * 2.0 ** -11
DW_F16_TOL = (DW_BF16_TOL[0] / 8, DW_BF16_TOL[1] / 8)
DW_F16_GRAD_TOL = DW_BF16_GRAD_TOL / 8
MODEL_TOL = 1e-3  # card vs CPU scores: 14 + 1 float32 blocks, sums in another order

# The flagship joint-LID model (configs/lid_supervised.yaml module block,
# __graft_entry__.py): 14 × 144-d Conformer, 4 heads × 64, ×4 subsampling,
# one ConformerLinear head block per language at 144-d, 8 heads × 32.
FLAGSHIP = dict(
    lang2vocab={"lang0": 40, "lang1": 96, "lang2": 88},
    lang2index={"lang0": 0, "lang1": 1, "lang2": 2},
    n_blocks=14, encoder_dim=144, heads=4, dim_head=64, sub_sampling=4,
    head_type="conformer_linear", head_layers=1, head_dim_head=32, head_num_head=8,
)
DW_PER_FORWARD = FLAGSHIP["n_blocks"] + len(FLAGSHIP["lang2vocab"])  # 14 + 3
SERVE_SECONDS = (0.7, 1.5, 3.0, 5.0, 12.0)
SERVE_ROUNDS = 2

# Training: Adam + tristage + clip 20 as configs/lid_supervised.yaml has them,
# the schedule shortened to this run's 18 steps; SpecAugment, time stretch,
# dropout and stochastic depth on (the task's defaults plus t_stretch).
TRAIN_HPARAMS = dict(
    t_stretch=True, lr=1e-3, optimizer="adam", clip_norm=20.0, schedule="tristage",
    schedule_conf=dict(warmup_steps=3, hold_steps=9, decay_steps=6),
)
TRAIN_B, TRAIN_SECONDS, TRAIN_BATCHES, TRAIN_EPOCHS = 8, 4.0, 6, 2
TRAIN_TOL = 1e-3  # card vs CPU: the loss, and each gradient relative to its largest entry
N_BLOCKS, N_LANG = FLAGSHIP["n_blocks"], len(FLAGSHIP["lang2vocab"])
DW_PER_TRAIN_STEP = N_BLOCKS + 1  # the encoder's blocks and the batch's own head


def launch_counts(fbank: int = 0, bwd_w: int = 0, bf16: bool = False, f16: bool = False,
                  **modes: int) -> dict:
    """The launch counts of :func:`launches` for the given fbank, dW/db and
    forward-kernel launches by mode (``FWD_MODES``; absent modes are 0),
    every depthwise launch in bfloat16 with ``bf16``, in float16 with
    ``f16`` and in float32 without."""
    modes = {m: modes.get(m, 0) for m in FWD_MODES}
    total = sum(modes.values())
    return {"fbank": fbank, "depthwise": total,
            "depthwise_dx": modes["plain_dx"] + modes["glu_dx"], "depthwise_bwd_w": bwd_w,
            "depthwise_bf16": total if bf16 else 0, "depthwise_bwd_w_bf16": bwd_w if bf16 else 0,
            "depthwise_f16": total if f16 else 0, "depthwise_bwd_w_f16": bwd_w if f16 else 0,
            **{f"depthwise_{m}": n for m, n in modes.items()}}


# what one B = 1 forward and one train step are expected to launch, every
# depthwise launch in a fused mode: eval GLU + conv + BN + act in each conv
# module; in training the forward with GLU in front, dX with the GLU
# backward behind, and dW/db through the other kernel
PER_FORWARD_LAUNCHES = launch_counts(fbank=1, glu_bn_act=DW_PER_FORWARD)
TRAIN_STEP_LAUNCHES = launch_counts(fbank=1, bwd_w=DW_PER_TRAIN_STEP, glu=DW_PER_TRAIN_STEP,
                                    glu_dx=DW_PER_TRAIN_STEP)
# the WavLM joint model has no fbank and no depthwise conv in its encoder:
# one launch per head block (3 heads × 1) a forward, the own head's a step
WAVLM_PER_FORWARD_LAUNCHES = launch_counts(glu_bn_act=len(FLAGSHIP["lang2vocab"]))
WAVLM_TRAIN_STEP_LAUNCHES = launch_counts(bwd_w=1, glu=1, glu_dx=1)
SP_SEQ = 2  # the sequence-parallel frontend's seq ranks


def _sp_span(b: int, t: int) -> tuple:
    """The wave span the first of ``SP_SEQ`` seq ranks hands the fbank
    kernel (``parallel.sp_wav2mel``: its frames and a halo of 2)."""
    frames = 1 + t // 160
    return (b, min(t, (frames // SP_SEQ + 2) * 160))


# the same paths in bfloat16: every depthwise launch is the kernel's
# bfloat16 instantiation
BF16_PER_FORWARD_LAUNCHES = launch_counts(fbank=1, glu_bn_act=DW_PER_FORWARD, bf16=True)
BF16_TRAIN_STEP_LAUNCHES = launch_counts(fbank=1, bwd_w=DW_PER_TRAIN_STEP,
                                         glu=DW_PER_TRAIN_STEP, glu_dx=DW_PER_TRAIN_STEP,
                                         bf16=True)
WAVLM_BF16_PER_FORWARD_LAUNCHES = launch_counts(glu_bn_act=len(FLAGSHIP["lang2vocab"]),
                                                bf16=True)
WAVLM_BF16_TRAIN_STEP_LAUNCHES = launch_counts(bwd_w=1, glu=1, glu_dx=1, bf16=True)


def _encoder_frames(seconds: float) -> int:
    """Frames the encoder's convs see for a clip: hop-160 fbank frames, then
    two stride-2, 3-tap subsampling convs without padding."""
    t = 1 + int(seconds * SR) // 160
    for _ in range(2):
        t = (t - 3) // 2 + 1
    return t


# the encoder conv module's shape on the training path (8, 99, 288), k = 31
TRAIN_DW_SHAPE = (TRAIN_B, _encoder_frames(TRAIN_SECONDS), 2 * FLAGSHIP["encoder_dim"], 31)
SERVE_DW_SHAPE = (1, _encoder_frames(3.0), 2 * FLAGSHIP["encoder_dim"], 31)  # B=1, 3 s clip
SCORE_DW_SHAPE = (32, _encoder_frames(3.0), 2 * FLAGSHIP["encoder_dim"], 31)  # B=32 scorer
# the round-5 gate model's conv modules (4 × 96-d, batches of 8 in the 3 s
# bucket), in training and in eval
GATE_DW_SHAPE = (8, _encoder_frames(3.0), 2 * 96, 31)
# the eval CLI on the flagship checkpoint: batches of 8 val clips of the
# round-5 corpus (every one under 2 s) in lid_supervised's 2 s bucket
EVAL_SECONDS = 2.0
EVAL_DW_SHAPE = (8, _encoder_frames(EVAL_SECONDS), 2 * FLAGSHIP["encoder_dim"], 31)
# the sweep's trials (cli_sweep): the tone-code clips in lid_supervised's 2 s
# bucket at the batch size a trial draws (8 or 16), in training and eval;
# by batch size, the FBANK_SHAPES key and the conv shape
SWEEP_DW_SHAPE = (16, _encoder_frames(2.0), 2 * FLAGSHIP["encoder_dim"], 31)
# a model rank's half of the train step's channels under tensor parallelism
TP_DW_SHAPE = (TRAIN_B, _encoder_frames(TRAIN_SECONDS), FLAGSHIP["encoder_dim"], 31)
SWEEP_SHAPES = {8: ("eval", EVAL_DW_SHAPE), 16: ("cross_2s", SWEEP_DW_SHAPE)}

# The WavLM-Base+ joint model (__graft_entry__.py _flagship_wavlm, the model
# of BASELINE.json's headline): 12 layers of 768, FFN 3072, 12 heads, the
# 7-conv extractor, gated relative position bias (320 buckets, max distance
# 800), conv_pos 128 in 16 groups; three ConformerLinear heads of 768 (8
# heads × 32) as configs/lid_wavlm.yaml builds them, whose optimizer it has.
# The SSL config's own defaults stay: dropout 0.1 and span masking at 0.65
# where training runs.
WAVLM_BASE_PLUS = dict(encoder_layers=12, encoder_embed_dim=768, encoder_ffn_embed_dim=3072,
                       encoder_attention_heads=12, relative_position_embedding=True,
                       num_buckets=320, max_distance=800, gru_rel_pos=True)
WAVLM = dict(
    lang2vocab=FLAGSHIP["lang2vocab"], lang2index=FLAGSHIP["lang2index"], featurizer="wavlm",
    ssl_config=WAVLM_BASE_PLUS, feature_selection="last_hidden_state",
    head_type="conformer_linear", head_layers=1, head_dim_head=32, head_num_head=8,
    lr=5e-5, optimizer="adam", clip_norm=20.0, schedule="tristage",
    schedule_conf=dict(phase_ratio=[0.1, 0.4, 0.5], max_update=200000),
)
# one deterministic step: no dropout, span masking or layer drop
WAVLM_DETERMINISTIC = dict(WAVLM, dropout=0.0, ssl_config=dict(
    WAVLM_BASE_PLUS, dropout=0.0, attention_dropout=0.0, mask_prob=0.0, encoder_layerdrop=0.0))
WAVLM_TRAIN_B, WAVLM_TRAIN_SECONDS = 8, 4.0


def _wavlm_frames(seconds: float) -> int:
    """Frames out of the WavLM conv extractor for a clip: 3 s → 149."""
    t = int(seconds * SR)
    for _, k, s in [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2:
        t = (t - k) // s + 1
    return t


# The heads' conv modules run the depthwise kernel at C = 2 · 768: their
# pointwise GEMM makes 2 · 1536 channels, which the GLU halves.
WAVLM_DW_C = 2 * WAVLM_BASE_PLUS["encoder_embed_dim"]
WAVLM_SERVE_DW_SHAPE = (1, _wavlm_frames(3.0), WAVLM_DW_C, 31)  # a served 3 s clip
WAVLM_SCORE_DW_SHAPE = (32, _wavlm_frames(3.0), WAVLM_DW_C, 31)  # the B = 32 scorer
WAVLM_TRAIN_DW_SHAPE = (WAVLM_TRAIN_B, _wavlm_frames(WAVLM_TRAIN_SECONDS), WAVLM_DW_C, 31)
WAVLM_STEP_DW_SHAPE = (2, _wavlm_frames(2.0), WAVLM_DW_C, 31)  # the card-vs-CPU step
WAVLM_CLI_DW_SHAPE = (4, _wavlm_frames(2.0), WAVLM_DW_C, 31)  # lid_wavlm.yaml: 4 a batch, 2 s
WAVLM_BF16_CLI_DW_SHAPE = (8, _wavlm_frames(2.0), WAVLM_DW_C, 31)  # lid_wavlm_bf16.yaml: 8
# C = 768 at the same frame counts: no path gives the kernel these shapes
# (the heads' GLU gives it 1536 channels), held against plain all the same
WAVLM_HALF_C_DW_SHAPES = ((1, 149, 768, 31), (32, 149, 768, 31), (8, 199, 768, 31))

# The WavLM-Large extra-finetune (configs/lid_extra_finetune.yaml's own
# module.ssl_config: 24 × 1024, FFN 4096, 16 heads, the layer-norm
# extractor, pre-LN, wave normalisation, gated relative position bias, span
# and channel masking at 0.15; heads at 1024, batches of 2, SGD, accum_grad
# 4).  Its heads' conv modules run the depthwise kernel at C = 2 · 1024.
WAVLM_LARGE = dict(encoder_layers=24, encoder_embed_dim=1024, encoder_ffn_embed_dim=4096,
                   encoder_attention_heads=16, extractor_mode="layer_norm",
                   layer_norm_first=True, normalize=True, relative_position_embedding=True,
                   gru_rel_pos=True, mask_prob=0.15, mask_channel_prob=0.15)
LARGE_DW_C = 2 * WAVLM_LARGE["encoder_embed_dim"]
LARGE_B = 2  # the config's data.batch_size
# the config's train buckets up to its max_duration of 13 s, each of which
# the Large corpus fills (large_corpus): (2, 99 … 649, 2048)
LARGE_BUCKETS = (2.0, 4.0, 8.0, 13.0)
LARGE_TRAIN_DW_SHAPES = tuple((LARGE_B, _wavlm_frames(s), LARGE_DW_C, 31)
                              for s in LARGE_BUCKETS)
LARGE_EVAL_DW_SHAPE = (LARGE_B, _wavlm_frames(2.0), LARGE_DW_C, 31)  # val clips under 2 s
# the float16 modes are held at the flagship's train step and eval CLI shapes
F16_DW_SHAPES = (TRAIN_DW_SHAPE, EVAL_DW_SHAPE)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed ``rounds`` times between CUDA events; the median replay over
    ``reps``.  Launch gaps of the host are not in it."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def bound_ms(n_bytes: float, flops: float):
    """The least time the card could take: bytes over HBM rate or FP32
    operations over the FP32 rate, whichever is larger."""
    t_bytes = n_bytes / PEAK_HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms_in_turns(old, new):
    """(old ms, new ms) of two designs timed in one call in turns old, new,
    new, old; each the mean of its two readings."""
    a, b, c, d = device_ms(old), device_ms(new), device_ms(new), device_ms(old)
    return (a + d) / 2, (b + c) / 2


# ---------------------------------------------------------------- phases


def phase_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    path = _build.library_path()
    _build.lib()
    blocks_per_sm, clusters = fbank_kernel.kernel_occupancy(
        160, 400, fbank_kernel.n_bin_tiles(512), torch.device("cuda", 0))
    emit({
        "phase": "build", "seconds": round(time.perf_counter() - t0, 3),
        "library": str(path.relative_to(_build.BUILD_DIR.parent)),
        "ptxas": [l.strip() for l in path.with_suffix(".log").read_text().splitlines()
                  if "registers" in l or "spill" in l],
        "fbank_blocks_per_sm": blocks_per_sm,
        "fbank_resident_clusters": clusters,
        "depthwise_fwd_blocks": {f"{b}x{t}x{c}": fwd_blocks(b, t, c)
                                 for b, t, c, _ in (SERVE_DW_SHAPE, TRAIN_DW_SHAPE,
                                                    SCORE_DW_SHAPE)},
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvidia_smi": smi,
    })
    return smi


def _wav(b: int, t: int, gen: torch.Generator) -> torch.Tensor:
    return frontend.normalize_wav(torch.randn(b, t, generator=gen)).cuda()


# served, scored, long, trained and short clips, and the eval CLI's batches
# on the flagship (2 s bucket) and the gate (3 s bucket) checkpoints
FBANK_SHAPES = {"serve": (1, 3 * SR), "b32": (32, 3 * SR), "long": (1, 17 * SR),
                "train": (TRAIN_B, int(TRAIN_SECONDS * SR)), "short": (1, 300),
                "eval": (8, int(EVAL_SECONDS * SR)), "gate_eval": (8, 3 * SR),
                # lid_cross.yaml's batches of 16: the corpus's 2 s and 4 s
                # buckets, and the config's largest, 13 s
                "cross_2s": (16, 2 * SR), "cross_4s": (16, 4 * SR), "cross_13s": (16, 13 * SR),
                # a seq rank's span of the train batch (tensor-parallel slice)
                "sp_span": _sp_span(TRAIN_B, int(TRAIN_SECONDS * SR))}


def _log_mel_float64(wav: torch.Tensor) -> torch.Tensor:
    """The plain version's sums in float64 on the card (the float32 bases
    cast up): what the float32 versions' rounding is measured against."""
    n_fft, win, hop, n_mels = 512, 400, 160, 80
    frames = frontend._reflect_pad(wav.double(), n_fft // 2).unfold(-1, n_fft, hop)
    basis, fb = frontend.mel_bases(n_fft, win, n_mels, SR, wav.device)
    proj = frames @ basis.double()
    re, im = proj[..., :n_fft // 2 + 1], proj[..., n_fft // 2 + 1:]
    mel = (re * re + im * im) @ fb.double()
    return (10.0 * torch.log10(mel.clamp_min(1e-10))).transpose(1, 2)


def phase_fbank(gen: torch.Generator) -> dict:
    """The kernel against its plain version and against the emulation of
    its tiling, and kernel and plain version against the same sums in
    float64: two float32 results differ by the rounding of both, so the
    kernel is also held to be no further from the float64 result, on
    average over all shapes, than the plain version is.  Returns the error
    against plain found at each shape."""
    found = {}
    summed = {"kernel": 0.0, "plain": 0.0}  # abs error against float64, over all cells
    for name, (b, t) in FBANK_SHAPES.items():
        wav = _wav(b, t, gen)
        got = log_mel(wav)
        ref = log_mel_plain(wav)
        tiled = log_mel_tiled_plain(wav)
        exact = _log_mel_float64(wav)
        vs_exact = {"kernel": (got.double() - exact).abs(), "plain": (ref.double() - exact).abs()}
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        err_tiled = (got - tiled).abs().max().item()
        ok = (got.shape == ref.shape and bool(torch.isfinite(got).all())
              and torch.allclose(got, ref, rtol=FBANK_TOL, atol=FBANK_TOL)
              and torch.allclose(got, tiled, rtol=FBANK_TOL, atol=FBANK_TOL)
              and vs_exact["kernel"].max().item() <= FBANK_TOL)
        for which, v in vs_exact.items():
            summed[which] += v.sum().item()
        emit({"phase": "fbank_vs_plain", "shape": [b, t],
              "out": list(got.shape), "max_abs_err_db": err,
              "max_abs_err_db_vs_tiled_emulation": err_tiled,
              "max_abs_err_db_vs_float64": {k: v.max().item() for k, v in vs_exact.items()},
              "mean_abs_err_db_vs_float64": {k: v.mean().item() for k, v in vs_exact.items()},
              "tol": FBANK_TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"fbank kernel disagrees with plain at {(b, t)}")
        found[name] = err
    ratio = summed["kernel"] / summed["plain"]
    emit({"phase": "fbank_vs_float64", "shapes": len(FBANK_SHAPES),
          "mean_abs_err_kernel_over_plain": ratio, "tol": FBANK_MEAN_ERR_OVER_PLAIN,
          "ok": ratio <= FBANK_MEAN_ERR_OVER_PLAIN})
    if ratio > FBANK_MEAN_ERR_OVER_PLAIN:
        raise AssertionError("fbank kernel is further from the float64 sums than plain")
    try:  # no reflection of 256 samples without more than 256 samples
        log_mel(torch.zeros(1, 256, device="cuda"))
    except ValueError:
        return found
    raise AssertionError("log_mel took a wav no longer than its reflect padding")


DW_SHAPES = (SERVE_DW_SHAPE, (32, 74, 288, 31), (1, 7, 64, 31),
             (3, 100, 129, 15), (2, 50, 96, 4), TRAIN_DW_SHAPE, GATE_DW_SHAPE)
LARGE_BWD_W_SHAPE = (32, 300, 288, 31)  # 160 time chunks for the 8 blocks of a cluster


def phase_depthwise(gen: torch.Generator) -> dict:
    """The forward kernel against its plain version; returns the f32 error
    found at each shape."""
    found = {}
    for b, t, c, k in DW_SHAPES:
        x = torch.randn(b, t, c, generator=gen).cuda()
        w = (0.1 * torch.randn(k, c, generator=gen)).cuda()
        bias = (0.1 * torch.randn(c, generator=gen)).cuda()
        got = depthwise_conv1d(x, w, bias)
        ref = depthwise_conv1d_plain(x, w, bias)
        got16 = depthwise_conv1d(x.bfloat16(), w.bfloat16(), bias.bfloat16())
        # flipped taps and no bias, as the backward asks for dX
        got_flip = depthwise_conv1d_dx(x, w)
        ref_flip = depthwise_conv1d_plain(x, w, None, k - 1 - (k - 1) // 2, flip=True)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        err16 = (got16.float() - ref).abs().max().item()
        err_flip = (got_flip - ref_flip).abs().max().item()
        ok = (torch.allclose(got, ref, rtol=DW_TOL, atol=DW_TOL)
              and torch.allclose(got_flip, ref_flip, rtol=DW_TOL, atol=DW_TOL))
        ok16 = got16.dtype == torch.bfloat16 and torch.allclose(
            got16.float(), ref, rtol=DW_BF16_TOL[0], atol=DW_BF16_TOL[1])
        emit({"phase": "depthwise_vs_plain", "shape": [b, t, c], "k": k,
              "max_abs_err_f32": err, "max_abs_err_f32_flip_no_bias": err_flip,
              "tol_f32": DW_TOL,
              "max_abs_err_bf16_vs_f32": err16, "tol_bf16": DW_BF16_TOL,
              "ok": ok and ok16})
        if not (ok and ok16):
            raise AssertionError(f"depthwise kernel disagrees with plain at {(b, t, c, k)}")
        found[(b, t, c, k)] = err
    return found


def _dw_grads(fn, x, w, bias, g):
    """(dX, dW, db) of ``fn(x, w, bias)`` under the output gradient ``g``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, bias)]
    return torch.autograd.grad(fn(*leaves), leaves, g)


def phase_depthwise_bwd(gen: torch.Generator) -> dict:
    """The autograd Function on the card (dX through the forward kernel,
    dW and db through the reduction kernel) against autograd through the
    plain version on the card; bf16 against the f32 result, each gradient
    also relative to its own largest entry; and two runs on the same input
    give the same bits.  Returns, for each shape, the f32 errors of dX and
    of dW/db (the larger, the wrapper called directly included)."""
    found = {}
    for b, t, c, k in DW_SHAPES:
        x = torch.randn(b, t, c, generator=gen).cuda()
        w = (0.1 * torch.randn(k, c, generator=gen)).cuda()
        bias = (0.1 * torch.randn(c, generator=gen)).cuda()
        # a unit-scale gradient over B·T frames would grow the sums: keep dW near 1
        g = (torch.randn(b, t, c, generator=gen) / (b * t) ** 0.5).cuda()
        before = launches()
        got = _dw_grads(depthwise_conv1d, x, w, bias, g)
        counted = {name: n - before[name] for name, n in launches().items()}
        again = _dw_grads(depthwise_conv1d, x, w, bias, g)
        ref = _dw_grads(depthwise_conv1d_plain, x, w, bias, g)
        got16 = _dw_grads(depthwise_conv1d, x.bfloat16(), w.bfloat16(), bias.bfloat16(),
                          g.bfloat16())
        direct = depthwise_conv1d_bwd_w(x, g, k)
        direct_plain = depthwise_conv1d_bwd_w_plain(x, g, k)
        torch.cuda.synchronize()
        errs = [(a - r).abs().max().item() for a, r in zip(got, ref)]
        errs16 = [(a.float() - r).abs().max().item() for a, r in zip(got16, ref)]
        rel16 = [e / r.abs().max().item() for e, r in zip(errs16, ref)]
        direct_errs = [(a - r).abs().max().item() for a, r in zip(direct, direct_plain)]
        ok = all(torch.allclose(a, r, rtol=DW_GRAD_TOL, atol=DW_GRAD_TOL)
                 for a, r in zip(got + direct, ref + direct_plain))
        ok16 = all(a.dtype == torch.bfloat16 and torch.allclose(
            a.float(), r, rtol=DW_BF16_TOL[0], atol=DW_BF16_TOL[1]) for a, r in zip(got16, ref))
        ok16 = ok16 and max(rel16) <= DW_BF16_GRAD_TOL
        same_bits = all(torch.equal(a, b2) for a, b2 in zip(got, again))
        emit({"phase": "depthwise_bwd_vs_plain", "shape": [b, t, c], "k": k,
              "max_abs_err_f32": dict(zip(("dx", "dw", "db"), errs)), "tol_f32": DW_GRAD_TOL,
              "max_abs_err_bf16_vs_f32": dict(zip(("dx", "dw", "db"), errs16)),
              "tol_bf16": DW_BF16_TOL,
              "max_err_bf16_over_largest_f32": dict(zip(("dx", "dw", "db"), rel16)),
              "tol_bf16_over_largest": DW_BF16_GRAD_TOL,
              "max_abs_err_direct_bwd_w": dict(zip(("dw", "db"), direct_errs)),
              "launches": counted,
              "bit_equal_reruns": same_bits, "ok": ok and ok16 and same_bits})
        expect = launch_counts(plain=1, plain_dx=1, bwd_w=1)
        if not (ok and ok16 and same_bits and counted == expect):
            raise AssertionError(f"depthwise backward disagrees with plain at {(b, t, c, k)}")
        found[(b, t, c, k)] = {"dx": errs[0], "bwd_w": max(errs[1], errs[2], *direct_errs)}

    # dW/db alone where every block of a cluster walks over many chunks, and
    # against the emulation of the kernel's summation order at the train shape
    for (b, t, c, k), reference in ((LARGE_BWD_W_SHAPE, depthwise_conv1d_bwd_w_plain),
                                    (TRAIN_DW_SHAPE, depthwise_conv1d_bwd_w_tiled_plain)):
        x = torch.randn(b, t, c, generator=gen).cuda()
        g = (torch.randn(b, t, c, generator=gen) / (b * t) ** 0.5).cuda()
        got, again, ref = (depthwise_conv1d_bwd_w(x, g, k), depthwise_conv1d_bwd_w(x, g, k),
                           reference(x, g, k))
        torch.cuda.synchronize()
        errs = [(a - r).abs().max().item() for a, r in zip(got, ref)]
        ok = all(torch.allclose(a, r, rtol=DW_GRAD_TOL, atol=DW_GRAD_TOL)
                 for a, r in zip(got, ref))
        same_bits = all(torch.equal(a, b2) for a, b2 in zip(got, again))
        emit({"phase": "depthwise_bwd_w_vs_" + reference.__name__.split("bwd_w_")[1],
              "shape": [b, t, c], "k": k, "max_abs_err": dict(zip(("dw", "db"), errs)),
              "tol": DW_GRAD_TOL, "bit_equal_reruns": same_bits, "ok": ok and same_bits})
        if not (ok and same_bits):
            raise AssertionError(f"bwd_w disagrees with {reference.__name__} at {(b, t, c, k)}")

    return found


ACTS = ("swish", "double_swish")
# the served, trained and scored conv shapes, then a short clip, channels
# that take the kernel's scalar path (129) and an even kernel, the gate
# model's shape, the eval CLI's on the flagship and the sweep's; then the
# WavLM heads' shapes (served, scored, trained, the card-vs-CPU step, the
# CLI) and the same frame counts at C = 768; a tensor-parallel rank's (the
# WavLM-Large heads' shapes at C = 2048 are held in phase_large)
FUSED_SHAPES = (SERVE_DW_SHAPE, TRAIN_DW_SHAPE, SCORE_DW_SHAPE, (1, 7, 64, 31),
                (3, 100, 129, 15), (2, 50, 96, 4), GATE_DW_SHAPE, EVAL_DW_SHAPE, SWEEP_DW_SHAPE,
                WAVLM_SERVE_DW_SHAPE, WAVLM_SCORE_DW_SHAPE, WAVLM_TRAIN_DW_SHAPE,
                WAVLM_STEP_DW_SHAPE, WAVLM_CLI_DW_SHAPE, WAVLM_BF16_CLI_DW_SHAPE,
                *WAVLM_HALF_C_DW_SHAPES, TP_DW_SHAPE)


def fused_inputs(b: int, t: int, c: int, k: int, gen: torch.Generator):
    """On the card: h (B, T, 2C), a ragged padding mask (every utterance,
    the first one included, has padded frames when T > 3), conv weights and
    bias, eval BatchNorm statistics away from the identity, and an output
    gradient scaled so that dW stays near 1."""
    h = torch.randn(b, t, 2 * c, generator=gen)
    lengths = torch.tensor([t - (i + 1) * t // (2 * b + 2) for i in range(b)])
    mask = torch.arange(t)[None, :] < lengths[:, None]
    w = k ** -0.5 * torch.randn(k, c, generator=gen)
    bias = 0.05 * torch.randn(c, generator=gen)
    bn = BatchNormStats(0.2 * torch.randn(c, generator=gen), 0.5 + torch.rand(c, generator=gen),
                        1.0 + 0.1 * torch.randn(c, generator=gen),
                        0.05 * torch.randn(c, generator=gen), 1e-5)
    gy = torch.randn(b, t, c, generator=gen) / (b * t) ** 0.5
    return (h.cuda(), mask.cuda(), w.cuda(), bias.cuda(),
            BatchNormStats(*(v.cuda() for v in bn[:4]), bn.eps), gy.cuda())


def _bf16(*tensors):
    return [t.bfloat16() for t in tensors]


def _bf16_gap(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|got − ref|, that over max|ref|) of two bfloat16 results."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def phase_conv_fused(gen: torch.Generator, shapes=FUSED_SHAPES) -> dict:
    """The fused modes of the forward kernel against their plain versions
    on the card, float32 and bfloat16, Swish and DoubleSwish, with a ragged
    mask (and without one in eval): the eval call; the training forward;
    ``GluDepthwiseFn``'s dh, dW and db against autograd through the plain
    chain, bit-equal on a second run, exact zeros at padded frames, and the
    launches of one forward and backward.  In bfloat16 each mode is held
    against its bfloat16 plain version on the same inputs within 2 bf16
    ulps of the largest entry (``DW_BF16_ULPS``), and against the float32
    result at ``DW_BF16_TOL``; at ``F16_DW_SHAPES`` the float16 modes too.
    Returns the errors against plain found at each of ``shapes`` (``<mode>``
    float32, ``<mode>_bf16`` bfloat16, ``<mode>_f16`` float16)."""
    found = {}
    for b, t, c, k in shapes:
        h, mask, w, bias, bn, gy = fused_inputs(b, t, c, k, gen)
        errs, errs16, gaps16 = {}, {}, {}
        ok = True
        with torch.no_grad():
            for act in ACTS:
                for name, m in ((f"eval_{act}", mask), (f"eval_{act}_no_mask", None)):
                    got = glu_depthwise_bn_act(h, m, w, bias, bn, act)
                    ref = glu_depthwise_bn_act_plain(h, m, w, bias, bn, act)
                    errs[name] = (got - ref).abs().max().item()
                    ok &= torch.allclose(got, ref, rtol=DW_TOL, atol=DW_TOL)
                got16 = glu_depthwise_bn_act(*_bf16(h), mask, *_bf16(w, bias), bn, act)
                ref = glu_depthwise_bn_act_plain(h, mask, w, bias, bn, act)
                errs16[f"eval_{act}"] = (got16.float() - ref).abs().max().item()
                ok &= got16.dtype == torch.bfloat16 and torch.allclose(
                    got16.float(), ref, rtol=DW_BF16_TOL[0], atol=DW_BF16_TOL[1])
                gaps16[f"eval_{act}"] = _bf16_gap(got16, glu_depthwise_bn_act_plain(
                    *_bf16(h), mask, *_bf16(w, bias), bn, act))
            got = glu_depthwise(h, mask, w, bias)
            ref = glu_depthwise_plain(h, mask, w, bias)[1]
            errs["train_forward"] = (got - ref).abs().max().item()
            ok &= torch.allclose(got, ref, rtol=DW_TOL, atol=DW_TOL)
            gaps16["train_forward"] = _bf16_gap(glu_depthwise(*_bf16(h), mask, *_bf16(w, bias)),
                                                glu_depthwise_plain(*_bf16(h), mask,
                                                                    *_bf16(w, bias))[1])

        def grads(fn, *inputs):
            leaves = [v.detach().clone().requires_grad_(True) for v in inputs]
            return torch.autograd.grad(fn(leaves[0], mask, leaves[1], leaves[2]), leaves,
                                       gy.to(inputs[0].dtype))

        before = launches()
        got = grads(glu_depthwise, h, w, bias)
        counted = {name: n - before[name] for name, n in launches().items()}
        again = grads(glu_depthwise, h, w, bias)
        ref = grads(lambda *a: glu_depthwise_plain(*a)[1], h, w, bias)
        got16 = grads(glu_depthwise, *_bf16(h, w, bias))
        ref16 = grads(lambda *a: glu_depthwise_plain(*a)[1], *_bf16(h, w, bias))
        # the GLU backward's formula on the plain dX, against the kernel's epilogue
        dh_formula = glu_mask_bwd_plain(
            depthwise_conv1d_plain(gy, w, None, k - 1 - (k - 1) // 2, flip=True), h, mask)
        torch.cuda.synchronize()
        names = ("dh", "dw", "db")
        errs.update({f"grad_{n}": (a - r).abs().max().item() for n, a, r in zip(names, got, ref)})
        errs["dh_vs_glu_mask_bwd_plain"] = (got[0] - dh_formula).abs().max().item()
        rel16 = {n: (a.float() - r).abs().max().item() / r.abs().max().item()
                 for n, a, r in zip(names, got16, ref)}
        ok &= all(torch.allclose(a, r, rtol=DW_GRAD_TOL, atol=DW_GRAD_TOL)
                  for a, r in zip(got, ref))
        ok &= torch.allclose(got[0], dh_formula, rtol=DW_GRAD_TOL, atol=DW_GRAD_TOL)
        ok &= all(a.dtype == torch.bfloat16 and torch.allclose(
            a.float(), r, rtol=DW_BF16_TOL[0], atol=DW_BF16_TOL[1]) for a, r in zip(got16, ref))
        ok &= max(rel16.values()) <= DW_BF16_GRAD_TOL
        gaps16.update({f"grad_{n}": _bf16_gap(a, r) for n, a, r in zip(names, got16, ref16)})
        ok &= all(rel <= DW_BF16_ULPS for _, rel in gaps16.values())
        same_bits = all(torch.equal(a, b2) for a, b2 in zip(got, again))
        padded_zero = bool((got[0][~mask] == 0).all()) and bool((got16[0][~mask] == 0).all())
        f16 = {}
        if (b, t, c, k) in F16_DW_SHAPES:  # the float16 modes, held as the bfloat16 ones
            f16, f16_ok = _conv_fused_f16(h, mask, w, bias, bn, grads, ref)
            ok &= f16_ok
        expect = launch_counts(glu=1, glu_dx=1, bwd_w=1)
        emit({"phase": "conv_fused_vs_plain", "shape": [b, t, c], "k": k,
              "valid_frames": mask.sum(dim=1).tolist(), "max_abs_err_f32": errs,
              "tol_f32": DW_TOL, "tol_grad_f32": DW_GRAD_TOL,
              "max_abs_err_bf16_vs_f32": errs16, "tol_bf16": DW_BF16_TOL,
              "max_err_bf16_grad_over_largest_f32": rel16,
              "tol_bf16_grad_over_largest": DW_BF16_GRAD_TOL,
              "bf16_vs_bf16_plain": {n: {"max_abs_err": e, "over_largest": r}
                                     for n, (e, r) in gaps16.items()},
              "tol_bf16_vs_bf16_plain_over_largest": DW_BF16_ULPS,
              "bit_equal_reruns": same_bits, "dh_zero_at_padded_frames": padded_zero,
              "launches_forward_backward": counted, **({"f16": f16} if f16 else {}),
              "ok": bool(ok) and same_bits and padded_zero and counted == expect})
        if not (ok and same_bits and padded_zero and counted == expect):
            raise AssertionError(f"fused conv modes disagree with plain at {(b, t, c, k)}")
        found[(b, t, c, k)] = {
            "glu_bn_act": max(v for n, v in errs.items() if n.startswith("eval")),
            "glu": errs["train_forward"], "glu_dx": errs["grad_dh"],
            "bwd_w": max(errs["grad_dw"], errs["grad_db"]),
            "glu_bn_act_bf16": max(e for n, (e, _) in gaps16.items() if n.startswith("eval")),
            "glu_bf16": gaps16["train_forward"][0], "glu_dx_bf16": gaps16["grad_dh"][0],
            "bwd_w_bf16": max(gaps16["grad_dw"][0], gaps16["grad_db"][0]),
            **f16.get("errs", {})}
    return found


def _conv_fused_f16(h, mask, w, bias, bn, grads, ref32) -> tuple:
    """The float16 instantiations of every fused mode at one shape: each
    against its float16 plain version on the same inputs within
    ``DW_F16_ULPS`` of the largest entry, against the float32 result at
    ``DW_F16_TOL`` and the float32 gradients ``ref32`` within
    ``DW_F16_GRAD_TOL`` of their largest entry, dh exactly 0 at padded
    frames; a rerun bit-equal.  ``grads(fn, *inputs)`` is
    :func:`phase_conv_fused`'s gradient of the training mode.  → (the
    report with ``errs``, the errors against plain by ``<mode>_f16``, and
    whether all held)."""
    h16, w16, b16 = h.half(), w.half(), bias.half()
    gaps, vs32, ok = {}, {}, True
    with torch.no_grad():
        for act in ACTS:
            got = glu_depthwise_bn_act(h16, mask, w16, b16, bn, act)
            ref = glu_depthwise_bn_act_plain(h, mask, w, bias, bn, act)
            vs32[f"eval_{act}"] = (got.float() - ref).abs().max().item()
            ok &= got.dtype == torch.float16 and torch.allclose(
                got.float(), ref, rtol=DW_F16_TOL[0], atol=DW_F16_TOL[1])
            gaps[f"eval_{act}"] = _bf16_gap(got, glu_depthwise_bn_act_plain(
                h16, mask, w16, b16, bn, act))
        got = glu_depthwise(h16, mask, w16, b16)
        vs32["train_forward"] = (got.float() - glu_depthwise_plain(h, mask, w, bias)[1]
                                 ).abs().max().item()
        gaps["train_forward"] = _bf16_gap(got, glu_depthwise_plain(h16, mask, w16, b16)[1])
    names = ("dh", "dw", "db")
    got = grads(glu_depthwise, h16, w16, b16)
    again = grads(glu_depthwise, h16, w16, b16)
    plain = grads(lambda *a: glu_depthwise_plain(*a)[1], h16, w16, b16)
    rel32 = {n: (a.float() - r).abs().max().item() / r.abs().max().item()
             for n, a, r in zip(names, got, ref32)}
    gaps.update({f"grad_{n}": _bf16_gap(a, r) for n, a, r in zip(names, got, plain)})
    ok &= all(a.dtype == torch.float16 for a in got)
    ok &= max(rel32.values()) <= DW_F16_GRAD_TOL
    ok &= all(rel <= DW_F16_ULPS for _, rel in gaps.values())
    ok &= all(torch.equal(a, b) for a, b in zip(got, again))
    ok &= bool((got[0][~mask] == 0).all())
    errs = {"glu_bn_act_f16": max(e for n, (e, _) in gaps.items() if n.startswith("eval")),
            "glu_f16": gaps["train_forward"][0], "glu_dx_f16": gaps["grad_dh"][0],
            "bwd_w_f16": max(gaps["grad_dw"][0], gaps["grad_db"][0])}
    report = {"f16_vs_f16_plain": {n: {"max_abs_err": e, "over_largest": r}
                                   for n, (e, r) in gaps.items()},
              "tol_f16_vs_f16_plain_over_largest": DW_F16_ULPS,
              "max_abs_err_f16_vs_f32": vs32, "tol_f16": DW_F16_TOL,
              "max_err_f16_grad_over_largest_f32": rel32,
              "tol_f16_grad_over_largest": DW_F16_GRAD_TOL, "errs": errs}
    return report, bool(ok)


def init_random_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights at the scale of a trained model, and BatchNorm
    running statistics away from the identity (mean ≠ 0, var ≠ 1)."""
    with torch.no_grad():
        for module in model.modules():
            for name, p in module.named_parameters(recurse=False):
                r = torch.randn(p.shape, generator=gen)
                if name == "weight" and isinstance(module, (torch.nn.LayerNorm, MaskedBatchNorm)):
                    p.copy_(1.0 + 0.1 * r)
                elif name == "rel_pos_emb":
                    p.copy_(r)
                elif name == "weight" and isinstance(module, DepthwiseConv1d):
                    p.copy_(r * p.shape[0] ** -0.5)  # (k, C): fan-in k
                elif p.dim() >= 2:  # Linear (out, in), Conv2d (out, in, kh, kw)
                    p.copy_(r * p[0].numel() ** -0.5)
                else:
                    p.copy_(0.05 * r)
            if isinstance(module, MaskedBatchNorm):
                module.running_mean.copy_(0.2 * torch.randn(module.running_mean.shape, generator=gen))
                module.running_var.copy_(0.5 + torch.rand(module.running_var.shape, generator=gen))


def clear_launches(*families: str) -> None:
    """Clear the counts of ``_build.launches`` whose entry points start with
    one of ``families``."""
    for key in [k for k in _build.launches if k.entry.startswith(families)]:
        del _build.launches[key]


def reset_launches() -> None:
    """Clear the fbank and depthwise counts (the subsampling's and the
    rel-pos attention's are cleared by the phases that read them)."""
    clear_launches("fbank", "depthwise")


def launches() -> dict:
    """The fbank and depthwise counts of ``_build.launches``; ``depthwise``
    holds every launch of the forward kernel, ``depthwise_dx`` the flipped
    ones among them, ``depthwise_bf16`` and ``depthwise_f16`` its bfloat16
    and float16 ones, and ``depthwise_<mode>`` each mode's (``FWD_MODES``);
    ``depthwise_bwd_w_bf16`` and ``depthwise_bwd_w_f16`` the 16-bit dW/db
    launches."""
    modes = {m: _build.launched(mode=m) for m in FWD_MODES}
    by_dtype = {d: sum(_build.launched(mode=m, dtype=d) for m in FWD_MODES)
                for d in (torch.bfloat16, torch.float16)}
    return {"fbank": _build.launched(entry="fbank_log_mel_f32"),
            "depthwise": sum(modes.values()),
            "depthwise_dx": modes["plain_dx"] + modes["glu_dx"],
            "depthwise_bwd_w": _build.launched(mode="bwd_w"),
            "depthwise_bf16": by_dtype[torch.bfloat16],
            "depthwise_bwd_w_bf16": _build.launched(mode="bwd_w", dtype=torch.bfloat16),
            "depthwise_f16": by_dtype[torch.float16],
            "depthwise_bwd_w_f16": _build.launched(mode="bwd_w", dtype=torch.float16),
            **{f"depthwise_{m}": n for m, n in modes.items()}}


def infer_card_vs_cpu(task: LidASRTask, cpu: LidASRTask, wavs: torch.Tensor,
                      lengths: torch.Tensor) -> tuple:
    """``infer`` of ``task`` on the card (after one call that sets cuBLAS
    and cuDNN up) and of ``cpu``, which holds the same state_dict, on the
    same batch; → (the card's outputs on the host, the CPU's, the launches
    of the card's second call, the errors of the logits (where not masked),
    scores and MLP scores)."""
    infer = task.infer_fn()
    infer(wavs, lengths)
    torch.cuda.synchronize()
    reset_launches()
    out = infer(wavs, lengths)
    torch.cuda.synchronize()
    per_forward = launches()
    ref = cpu.infer_fn()(wavs, lengths)
    got = {k: v.cpu() for k, v in out.items()}
    live = ref["logits"] > torch.finfo(torch.float32).min
    errs = {"max_abs_err_logits": (got["logits"][live] - ref["logits"][live]).abs().max().item(),
            "max_abs_err_scores": (got["scores"] - ref["scores"]).abs().max().item(),
            "max_abs_err_mlp_scores":
                (got["mlp_scores"] - ref["mlp_scores"]).abs().max().item()}
    return got, ref, per_forward, errs


def phase_model(gen: torch.Generator) -> LidASRTask:
    """The full-width flagship on the card (kernels) against the same
    state_dict on the CPU (plain versions), on ragged 3 s clips."""
    task = LidASRTask(**FLAGSHIP, device="cuda")
    init_random_(task.model, gen)
    cpu_task = LidASRTask(**FLAGSHIP, device="cpu")
    cpu_task.model.load_state_dict(task.model.state_dict())
    wavs = 0.1 * torch.randn(2, 3 * SR, generator=gen)
    lengths = torch.tensor([3 * SR, 40000])
    got, ref, per_forward, errs = infer_card_vs_cpu(task, cpu_task, wavs, lengths)
    neg = torch.finfo(torch.float32).min
    score_err = errs["max_abs_err_scores"]
    report = {
        "phase": "model_card_vs_cpu", "config": "flagship 14x144, heads 3x(40,96,88)",
        "batch": [2, 3 * SR], "lengths": lengths.tolist(),
        "params": sum(p.numel() for p in task.model.parameters()),
        "logits_shape": list(got["logits"].shape), **errs,
        "scores": got["scores"].tolist(), "pred_lang": got["pred_lang"].tolist(),
        "pred_lang_cpu": ref["pred_lang"].tolist(), "tol": MODEL_TOL,
        "launches_per_forward": per_forward,
    }
    emit(report)
    checks = {
        "finite": bool(torch.isfinite(got["logits"]).all() and torch.isfinite(got["scores"]).all()
                       and torch.isfinite(got["mlp_scores"]).all()),
        "scores": score_err <= MODEL_TOL,
        "masked_slots": bool(torch.equal(got["logits"] == neg, ref["logits"] == neg)),
        "pred_lang": torch.equal(got["pred_lang"], ref["pred_lang"]),
        "launches": per_forward == PER_FORWARD_LAUNCHES,
    }
    if not all(checks.values()):
        raise AssertionError(f"full model on the card failed: {checks}")
    return task


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        if resp.status != 200:
            raise AssertionError(f"GET {url}: {resp.status}")
        return json.loads(resp.read())


def phase_serve(task: LidASRTask, gen: torch.Generator, per_forward: dict = PER_FORWARD_LAUNCHES,
                name: str = "serve") -> dict:
    """The main path: /lid served from a thread, requests of several
    lengths; launch counts are read around exactly these requests, each
    request's expected to be ``per_forward``."""
    state = InferenceState(make_lid_fn(task), task.index2lang)
    state.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    wavs = [(0.1 * torch.randn(int(s * SR), generator=gen)).numpy() for s in SERVE_SECONDS]
    answers = []
    try:
        torch.cuda.synchronize()
        reset_launches()
        for _ in range(SERVE_ROUNDS):
            for wav in wavs:
                req = urllib.request.Request(url + "/lid", data=wav.tobytes(), method="POST")
                with urllib.request.urlopen(req, timeout=120) as resp:
                    status, body = resp.status, json.loads(resp.read())
                answers.append((wav, status, body))
        served = launches()
        health = _get(url + "/healthz")
        stats = _get(url + "/stats")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    n_req = len(answers)
    lid_fn = make_lid_fn(task)
    worst = 0.0
    for wav, status, body in answers:
        if status != 200 or set(body) != {"lang", "scores"} or len(body["scores"]) != 3:
            raise AssertionError(f"bad /lid answer: {status} {body}")
        padded, n = state.pad(wav)
        direct = lid_fn(padded, n)[0]
        got = np.array([body["scores"][task.index2lang[i]] for i in range(3)], np.float32)
        worst = max(worst, float(np.abs(got - direct).max()))
    report = {
        "phase": name, "requests": n_req, "seconds": list(SERVE_SECONDS),
        "rounds": SERVE_ROUNDS, "launches": served,
        "max_abs_diff_vs_direct_infer": worst,
        "healthz": health, "stats": stats,
        "langs": [body["lang"] for _, _, body in answers[:len(wavs)]],
    }
    emit(report)
    ok = (worst == 0.0 and health == {"status": "ok"} and not thread.is_alive()
          and served == {k: n * n_req for k, n in per_forward.items()})
    if not ok:
        raise AssertionError(f"{name} phase failed")
    return report


def synthetic_batch(rng: np.random.RandomState, lang: int, b: int, seconds: float) -> dict:
    """One language-homogeneous batch in the feeder's layout: ragged clips
    in the ``seconds`` bucket, label lengths 5–30."""
    t = int(seconds * SR)
    vocab = list(FLAGSHIP["lang2vocab"].values())[lang]
    text_lengths = rng.randint(5, 31, b).astype(np.int32)
    return {
        "wavs": (0.1 * rng.randn(b, t)).astype(np.float32),
        "wav_lengths": rng.randint(t // 2, t + 1, b).astype(np.int32),
        "texts": rng.randint(0, vocab, (b, 30)).astype(np.int32),
        "text_lengths": text_lengths,
        "langs": np.full(b, lang, np.int32),
        "n_valid": np.int32(0),
    }


def pin_subsampling_relus(card_sub, cpu_sub) -> dict:
    """Make the CPU side's Conv2d subsampling take each ReLU decision from
    the card's forward: hooks record which units are positive, conv1's from
    the input of the card's Linear (the kernel's or the chain's output),
    conv0's from the card's conv0 where the chain ran it, else from the
    card's plain conv0 over the same input (float32, TF32 off: the
    kernel's decisions but for a unit within rounding of 0); the CPU's
    subsampling (the same convs and Linear as ``Conv2dSubsampling.forward``)
    multiplies by those masks in place of its ReLUs.  Returns the hooks and,
    filled in by the CPU's forward, how many units of each ReLU the CPU's
    own rounding would have decided otherwise."""
    masks, differ = {}, {"conv0": 0, "conv1": 0}

    def record_input(mod, args):
        masks["x"] = args[0].detach()

    def record_conv0(mod, args, out):
        masks["conv0"] = (out > 0).cpu()

    def record_conv1(mod, args):
        b, t, _ = args[0].shape
        y = args[0].detach().reshape(b, t, -1, card_sub.conv1.out_channels)
        masks["conv1"] = (y > 0).permute(0, 3, 1, 2).cpu()

    hooks = [card_sub.register_forward_pre_hook(record_input),
             card_sub.conv0.register_forward_hook(record_conv0),
             card_sub.out.register_forward_pre_hook(record_conv1)]

    def forward(x):
        if "conv0" not in masks:  # the kernel ran conv0
            with torch.no_grad():
                z = F.conv2d(masks["x"][:, None], card_sub.conv0.weight, card_sub.conv0.bias,
                             stride=2)
            masks["conv0"] = (z > 0).cpu()
        m0, m1 = (masks[k].to(x.device) for k in ("conv0", "conv1"))
        z0 = cpu_sub.conv0(x[:, None])
        differ["conv0"] += int(((z0 > 0) != m0).sum())
        z1 = cpu_sub.conv1(z0 * m0)
        differ["conv1"] += int(((z1 > 0) != m1).sum())
        y = (z1 * m1).permute(0, 2, 3, 1)
        b, t, f, c = y.shape
        return cpu_sub.out(y.reshape(b, t, f * c))

    cpu_sub.forward = forward
    return {"hooks": hooks, "differ": differ}


MIN_LEAF = 1000  # entries of a leaf held alone in a bfloat16 step's check


def step_card_vs_cpu(card: LidASRTask, cpu: LidASRTask, batch: dict, zero_grad_leaves=(),
                     after_card=None, reference: LidASRTask = None, tol: float = 0.0) -> dict:
    """One deterministic train step of ``card`` and of ``cpu`` (the same
    state_dict) on ``batch``: the loss of each, the launches of the card's
    step, and the worst gradient's distance between the two over its own
    largest entry.  Leaves named with a suffix of
    ``zero_grad_leaves`` have a true gradient of 0, so both sides hold
    rounding noise there: the noise is held against the largest gradient of
    all.  ``after_card`` runs after the card's step.

    With ``reference`` (the float32 task of the same weights, on the card)
    its step runs too, and each side's distance from its gradients is
    measured in relative L2 norm: bfloat16 rounding moves every leaf on
    either side, and a leaf whose sum cancels moves far, so the card is
    held to be as close to float32 as the CPU: over every gradient no
    further than twice the CPU's distance plus 1e-3 (``rel_l2_*``), and in
    each leaf of at least ``MIN_LEAF`` entries (not a zero-gradient one) no
    further than ``tol`` or three times the CPU's distance, whichever is
    larger (``max_card_over_bar``; a smaller leaf's norm is the noise of a
    few sums and counts in the whole).  The leaves where either distance,
    or the card's max-abs distance from the CPU, passes ``tol`` are
    reported (``leaves_over_tol``)."""
    results = {}
    runs = (("card", card), ("cpu", cpu)) + ((("float32", reference),) if reference else ())
    for name, task in runs:
        task.set_generators(torch.Generator(task.device).manual_seed(0),
                            torch.Generator().manual_seed(0))
        task.model.train()
        torch.cuda.synchronize()
        reset_launches()
        loss, _ = task.train_loop(task.place_batch(batch))
        loss.backward()
        if name == "card" and after_card is not None:
            after_card()
        results[name] = (loss.item(), launches(),
                         {k: p.grad.cpu() for k, p in task.model.named_parameters()
                          if p.grad is not None})
    (loss_card, counted, grads_card), (loss_cpu, _, grads_cpu) = results["card"], results["cpu"]
    largest = max(float(g.abs().max()) for g in grads_cpu.values())

    def distance(name, a, b):
        if name.endswith(tuple(zero_grad_leaves)):
            return max(float(a.abs().max()), float(b.abs().max())) / largest
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6 * largest)

    def rel_l2(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

    worst, worst_name, over_bar, far = 0.0, "", 0.0, {}
    for name, g_cpu in grads_cpu.items():
        err = distance(name, grads_card[name], g_cpu)
        if err > worst:
            worst, worst_name = err, name
        if reference is not None and not name.endswith(tuple(zero_grad_leaves)):
            g32 = results["float32"][2][name]
            own_cpu, own_card = rel_l2(g_cpu, g32), rel_l2(grads_card[name], g32)
            if max(own_cpu, own_card, err) > tol:
                far[name] = {"max_abs_card_vs_cpu": err, "rel_l2_cpu_vs_float32": own_cpu,
                             "rel_l2_card_vs_float32": own_card, "entries": g_cpu.numel()}
            if g_cpu.numel() >= MIN_LEAF:
                over_bar = max(over_bar, own_card / max(tol, 3 * own_cpu))
    out = {"loss_card": loss_card, "loss_cpu": loss_cpu,
           "rel_err_loss": abs(loss_card - loss_cpu) / max(abs(loss_cpu), 1.0),
           "gradients": len(grads_cpu), "same_leaves": set(grads_card) == set(grads_cpu),
           "max_rel_err_gradient": worst, "worst_gradient": worst_name,
           "largest_gradient_entry": largest, "launches_per_train_step": counted}
    if reference is not None:
        flat = {side: torch.cat([g.flatten() for _, g in sorted(grads.items())])
                for side, grads in (("card", grads_card), ("cpu", grads_cpu),
                                    ("float32", results["float32"][2]))}
        out.update({"loss_float32": results["float32"][0], "max_card_over_bar": over_bar,
                    "rel_l2_card_vs_cpu": rel_l2(flat["card"], flat["cpu"]),
                    "rel_l2_card_vs_float32": rel_l2(flat["card"], flat["float32"]),
                    "rel_l2_cpu_vs_float32": rel_l2(flat["cpu"], flat["float32"]),
                    "leaves_over_tol": far})
    return out


# one deterministic Conformer step: no dropout, stochastic depth or augmentation
CONFORMER_DETERMINISTIC = dict(FLAGSHIP, dropout=0.0, pos_dropout=0.0,
                               use_stochastic_depth=False, mask_times=0, t_stretch=False)


def conformer_step_card_vs_cpu(hp: dict, gen: torch.Generator, batch: dict,
                               tol: float = 0.0, pin_reference: bool = False) -> dict:
    """:func:`step_card_vs_cpu` of the Conformer task ``hp`` with random
    weights, the CPU side given the card's features and the card's
    subsampling ReLU decisions (:func:`phase_train_card_vs_cpu` says why);
    the depthwise bias's true gradient is zero (a train-mode BatchNorm
    follows).  With ``tol``, a bfloat16 ``hp``'s leaves are held as
    :func:`step_card_vs_cpu` holds them against a float32 reference; with
    ``pin_reference`` that reference takes the card's ReLU decisions too,
    so that the distances from it measure rounding alone (float16: the
    float32 step decides hundreds of subsampling units otherwise, and each
    flipped unit moves every gradient by more than float16's rounding,
    ``scripts/f16_step_precision.py``)."""
    card, cpu = LidASRTask(**hp, device="cuda"), LidASRTask(**hp, device="cpu")
    init_random_(card.model, gen)
    cpu.model.load_state_dict(card.model.state_dict())
    reference = None
    if tol:
        reference = LidASRTask(**as_float32(hp), device="cuda")
        reference.model.load_state_dict(card.model.state_dict())
    placed = card.place_batch(batch)
    feats, f_len = card._features(placed["wavs"].float(), placed["wav_lengths"])
    own_feats, _ = cpu._features(torch.from_numpy(batch["wavs"]),
                                 torch.from_numpy(batch["wav_lengths"]))
    feats_diff = (feats.cpu() - own_feats).abs().max().item()
    cpu._features = lambda wavs, wav_lengths, augment=False: (feats.cpu(), f_len.cpu())
    pinned = pin_subsampling_relus(card.model.featurizer.subsample, cpu.model.featurizer.subsample)
    hooks = list(pinned["hooks"])
    if pin_reference:
        reference_pinned = pin_subsampling_relus(card.model.featurizer.subsample,
                                                 reference.model.featurizer.subsample)
        hooks += reference_pinned["hooks"]
    step = step_card_vs_cpu(card, cpu, batch, ("depthwise.bias",),
                            after_card=lambda: [hook.remove() for hook in hooks],
                            reference=reference, tol=tol)
    if pin_reference:
        step["reference_subsampling_relus"] = "the card's"
        step["reference_relu_units_decided_otherwise"] = reference_pinned["differ"]
    return {"cpu_features": "the card's", "max_abs_diff_features_db": feats_diff,
            "cpu_subsampling_relus": "the card's",
            "relu_units_decided_otherwise": pinned["differ"], **step}


def phase_train_card_vs_cpu(gen: torch.Generator) -> None:
    """One deterministic train step (no dropout, stochastic depth or
    augmentation) at full width on the card (kernels) and on the CPU (plain
    versions) from the same state_dict: the loss and every gradient.

    The CPU side is given the features the card computed.  The frontend has
    no parameters, so no gradient depends on how it is differentiated, and
    the fbank kernel is held against its plain version at this path's shape
    in ``phase_fbank``.  With features of its own the CPU side would start
    from a mel that differs in rounding (reported here as
    ``max_abs_diff_features_db``), and the subsampling's ReLUs turn such a
    difference, when it flips one unit, into a jump of a percent in single
    gradients (a conv bias): then the check reads the random draw and not
    the kernels behind the frontend.  The same holds inside the
    subsampling: cuDNN's convolutions and the CPU's round differently, and
    one unit whose pre-activation lies within that rounding of 0 takes its
    ReLU one way on the card and the other on the CPU (4.6 % on
    ``subsample.conv1.bias`` with one draw of the weights).  So the CPU side
    takes the card's ReLU decisions there (:func:`pin_subsampling_relus`),
    and the units it would have decided otherwise are counted and reported
    (``relu_units_decided_otherwise``)."""
    batch = synthetic_batch(np.random.RandomState(1), lang=1, b=2, seconds=3.0)
    step = conformer_step_card_vs_cpu(CONFORMER_DETERMINISTIC, gen, batch)
    emit({"phase": "train_card_vs_cpu", "batch": [2, 3 * SR], "tol": TRAIN_TOL, **step})
    ok = (step["same_leaves"] and abs(step["loss_card"] - step["loss_cpu"]) <= TRAIN_TOL
          and step["max_rel_err_gradient"] <= TRAIN_TOL
          and step["launches_per_train_step"] == TRAIN_STEP_LAUNCHES)
    if not ok:
        raise AssertionError("train step on the card disagrees with the CPU")


# the Conv2d subsampling at the benchmark's batches (fbank frames): a served
# 3 s clip, the B = 512 scorer at 3 s, the B = 128 trainer at 13 s
SUBSAMPLE_SHAPES = {"serving": (1, 301), "scoring": (512, 301), "training": (128, 1301)}
# relative to the largest entry, float32 sums in another order than cuDNN's: the
# forward's 1296-term sums, the gradients' over up to a million positions
# (DW_GRAD_TOL's bar)
SUBSAMPLE_TOL = 1e-5
SUBSAMPLE_GRAD_TOL = 1e-4


def events_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps`` calls, the
    median of ``rounds`` (no graph: autograd calls run in it; at
    milliseconds a call the host's gaps are far below the work)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def subsample_flops(b: int, t: int, backward: bool = False) -> float:
    """The products of the subsampling's convolutions over (B, T, 80): conv1
    and conv0 forward; backward, conv1's two gradients and conv0's weight
    gradient (x takes none)."""
    t0, t1 = out_frames(t)
    conv1 = 2.0 * b * t1 * 19 * 144 * 9 * 144
    conv0 = 2.0 * b * t0 * 39 * 144 * 9
    return 2 * conv1 + conv0 if backward else conv1 + conv0


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _grid(shape, gen: torch.Generator, top: int, scale: float) -> torch.Tensor:
    """Integers in [-top, top] times ``scale`` (a power of two), on the card."""
    return (torch.randint(-top, top + 1, shape, generator=gen) * scale).float().cuda()


def subsample_errors(x, w, dy) -> tuple:
    """The kernels' relative errors against the plain version (autograd
    through cuDNN's convolutions, TF32 off) on x, the weights w (conv0's,
    its bias, conv1's, its bias) and the output gradient dy: (forward,
    {gradient: error}, conv1 units whose ReLU the two decide otherwise)."""
    y = subsample_fwd(x, *w)
    grads = subsample_bwd(x, w[0], w[1], w[2], y, dy)
    params = [p.clone().requires_grad_() for p in w]
    ref_y = subsample_conv_plain(x, *params)
    ref_grads = torch.autograd.grad(ref_y, params, dy)
    flips = int(((y > 0) != (ref_y > 0)).sum())
    return (_rel_err(y, ref_y.detach()),
            {n: _rel_err(g, r) for n, g, r in zip(("dw0", "db0", "dw1", "db1"), grads, ref_grads)},
            flips)


def _subsample_launches() -> tuple:
    return _build.launched(entry="subsample_fwd"), _build.launched(entry="subsample_bwd")


def phase_subsample(gen: torch.Generator) -> list:
    """The subsampling kernels against their plain version (cuDNN, TF32 off)
    at the benchmark's shapes, forward and backward, each timed beside the
    plain version and the chain the port ran before them (``library_ms``:
    conv0, ReLU, conv1, ReLU and the permute copy, never called by the
    port); then the flagship's scoring forward and training step counted
    through them (one forward launch a batch, three backward launches a
    step), the step against the CPU's.  Returns the kernel rows.

    The check runs on inputs of a grid where every product and every sum of
    the forward, and of dA0, is exact in float32 (x, conv0's weights, conv1's
    and the output gradient small integers times powers of two): both sides
    then take every ReLU decision alike, and what differs is the order of
    the weight gradients' long sums.  On the random inputs the rows are
    timed with, a unit within rounding of 0 can take its ReLU one way in the
    kernel and the other in cuDNN, and one such unit moves a bias gradient
    by about 1e-3 of its size: those errors and the units are reported."""
    sub = Conv2dSubsampling(80, 144).cuda()
    init_random_(sub, gen)
    w = [p.detach() for p in (sub.conv0.weight, sub.conv0.bias, sub.conv1.weight,
                               sub.conv1.bias)]
    params = [p.clone().requires_grad_() for p in w]
    rows, ok = [], True
    for shape_name, (b, t) in SUBSAMPLE_SHAPES.items():
        t0, t1 = out_frames(t)
        grid_w = [_grid((144, 1, 3, 3), gen, 8, 2 ** -3), _grid((144,), gen, 8, 2 ** -5),
                  _grid((144, 144, 3, 3), gen, 8, 2 ** -6), _grid((144,), gen, 8, 2 ** -11)]
        grid_fwd, grid_bwd, grid_flips = subsample_errors(
            _grid((b, t, 80), gen, 4, 2 ** -2), grid_w, _grid((b, t1, 19, 144), gen, 8, 2 ** -4))
        x = torch.randn(b, t, 80, generator=gen).cuda()
        dy = torch.randn((b, t1, 19, 144), generator=gen).cuda()
        rand_fwd, rand_bwd, rand_flips = subsample_errors(x, w, dy)
        clear_launches("subsample")
        with torch.no_grad():
            module_y = sub(x)  # the module's forward: the kernel's launch
        fwd_launches = _build.launched(entry="subsample_fwd")
        y = subsample_fwd(x, *w)
        clear_launches("subsample")
        grads = subsample_bwd(x, w[0], w[1], w[2], y, dy)
        bwd_launches = _build.launched(entry="subsample_bwd")
        again = subsample_bwd(x, w[0], w[1], w[2], y, dy)
        same_bits = all(torch.equal(g, h) for g, h in zip(grads, again))
        ref_y = subsample_conv_plain(x, *params)
        lib_y = subsample_conv_plain(x, *params).contiguous()
        with torch.no_grad():
            module_ref = sub.out(ref_y.detach().reshape(b, t1, 19 * 144))
        timed = {
            "forward": (lambda: subsample_fwd(x, *w),
                        lambda: subsample_conv_plain(x, *w),
                        lambda: subsample_conv_plain(x, *w).contiguous(),
                        subsample_flops(b, t), fwd_launches, grid_fwd, rand_fwd),
            "backward": (lambda: subsample_bwd(x, w[0], w[1], w[2], y, dy),
                         lambda: torch.autograd.grad(ref_y, params, dy, retain_graph=True),
                         lambda: torch.autograd.grad(lib_y, params, dy, retain_graph=True),
                         subsample_flops(b, t, True), bwd_launches, max(grid_bwd.values()),
                         max(rand_bwd.values())),
        }
        for direction, (kernel, plain, library, flops, launched, err, rand_err) in timed.items():
            with torch.no_grad() if direction == "forward" else contextlib.nullcontext():
                k_ms, p_ms, l_ms = events_ms(kernel), events_ms(plain), events_ms(library)
            b_ms, b_by = bound_ms(0.0, flops)
            rows.append({
                "name": f"subsample_{direction}", "route": "cuda",
                "source": "speechlid_tpu_torch/csrc/subsample.cu", "replaces": "none (XLA conv)",
                "shape": f"{shape_name} x ({b}, {t}, 80) -> y1 ({b}, {t1}, 19, 144); "
                         f"a0 ({b}, {t0}, 39, 144) not stored",
                "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                "library_call": "F.conv2d, relu, F.conv2d, relu, permute copy (cuDNN, no TF32)",
                "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
                "share_of_fp32_peak": b_ms / k_ms, "launches": launched,
                "max_rel_err_vs_plain": err, "random_inputs_max_rel_err": rand_err,
                "random_inputs_conv1_relus_decided_otherwise": rand_flips,
                **({"grad_rel_err": grid_bwd, "random_inputs_grad_rel_err": rand_bwd,
                    "same_bits_twice": same_bits}
                   if direction == "backward" else
                   {"module_max_rel_err": _rel_err(module_y, module_ref)}),
            })
            ok = ok and err <= (SUBSAMPLE_TOL if direction == "forward" else SUBSAMPLE_GRAD_TOL)
        ok = ok and fwd_launches == 1 and bwd_launches == 3 and same_bits and grid_flips == 0
        del ref_y, lib_y, grads, again, module_y, module_ref, y, dy, x
        torch.cuda.empty_cache()
    # the flagship's scoring forward and training step through the kernels
    clear_launches("subsample")
    phase_model(gen)
    scoring = _subsample_launches()
    clear_launches("subsample")
    phase_train_card_vs_cpu(gen)
    training = _subsample_launches()
    report = {"phase": "subsample", "tol": SUBSAMPLE_TOL, "grad_tol": SUBSAMPLE_GRAD_TOL,
              "rows": rows,
              "flagship_scoring_launches": {"infer_calls": 2, "fwd": scoring[0],
                                            "bwd": scoring[1]},
              "flagship_train_step_launches": {"fwd": training[0], "bwd": training[1]}}
    emit(report)
    # phase_model calls infer twice (set-up, then the counted call)
    ok = ok and scoring == (2, 0) and training == (1, 3)
    if not ok:
        raise AssertionError("the subsampling kernels disagree with their plain version or "
                             "the flagship's steps did not go through them")
    return rows


# (b, h, n, d) of the rel-pos attention kernels: the flagship's scoring
# encoder block, its training encoder block and own head (13 s, unstretched),
# the WavLM heads' scoring and the SSL heads' 13 s training, where
# |i − j| > 512 and the clip is live; then the rows' lengths as the
# benchmark's mixes draw them: scoring 10 % of rows in [n/3, n] (crop3s),
# training every row in [8n/13, n] (bucket13s)
RELPOS_SHAPES = {"scoring encoder": (512, 4, 74, 64), "training encoder": (128, 4, 324, 64),
                 "training head": (128, 8, 324, 32), "WavLM scoring heads": (32, 8, 149, 32),
                 "SSL training head": (8, 8, 649, 32)}
RELPOS_LENGTHS = {"scoring": (0.1, 1 / 3), "training": (1.0, 8 / 13)}  # (share drawn, lowest)
RELPOS_P = 512
RELPOS_TOL = 1e-5  # kernel vs plain, relative to each output's largest entry


def relpos_flops(b: int, h: int, n: int, d: int) -> float:
    """The forward's products as ``harness/counters.py`` counts them: q·kᵀ,
    one relative-position product a query and key, p·v."""
    return 3 * 2.0 * b * h * n * n * d


def _relpos_inputs(b, h, n, d, lengths_of, gen):
    q = torch.randn(b, n, h * d, generator=gen).cuda()
    kv = torch.randn(b, n, 2 * h * d, generator=gen).cuda()
    table = torch.randn(2 * RELPOS_P + 1, d, generator=gen).cuda()
    dout = torch.randn(b, n, h * d, generator=gen).cuda()
    share, lowest = RELPOS_LENGTHS[lengths_of]
    lengths = torch.full((b,), n)
    drawn = max(1, int(share * b))
    lengths[:drawn] = torch.randint(int(lowest * n), n + 1, (drawn,), generator=gen)
    lengths[0], lengths[-1] = n, 1  # one whole utterance, one fully padded past its first frame
    mask = (torch.arange(n)[None, :] < lengths[:, None]).cuda()
    return q, kv, table, mask, dout


def _relpos_launches() -> tuple:
    return _build.launched(entry="relpos_attn_fwd"), _build.launched(entry="relpos_attn_bwd")


# (b, h, n, d) of the Transformer-XL instantiation: wav2vec2_conformer_large.
# train_bucket13s's 24 layers (13 s, P = n − 1, no mask: mask_attention=False)
RELPOS_XL_SHAPE = (8, 16, 649, 64)


def relpos_xl_rows(gen: torch.Generator) -> tuple:
    """The XL instantiation at the cell's shape against HF's chain
    (``relpos_attn_xl_plain``) under autograd, every input's gradient (q,
    kv, the heads' table, u and v through ``xl_operands``): without a mask
    (the cell's call, timed) and with the training mix's lengths and one
    utterance padded past its first frame (``mask_attention=True``); each
    kernel call twice (the same bits), the calls' peak memory, times beside
    the FFMA bound and the chain.  → (rows, ok)."""
    b, h, n, d = RELPOS_XL_SHAPE
    p = n - 1
    rows, ok = [], True
    for masked in (False, True):
        q, kv, _, mask, dout = _relpos_inputs(b, h, n, d, "training", gen)
        mask = mask if masked else None
        pos = torch.randn(h, 2 * p + 1, d, generator=gen).cuda()
        u, v = (0.5 * torch.randn(h, d, generator=gen)).cuda(), \
            (0.5 * torch.randn(h, d, generator=gen)).cuda()
        q_u, beta = xl_operands(q, pos, u, v)
        clear_launches("relpos_attn_xl")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        o, lse = relpos_xl_fwd(q_u, kv, pos, beta, mask, h)
        torch.cuda.synchronize()
        fwd_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        grads = relpos_xl_bwd(q_u, kv, pos, beta, mask, o, lse, dout, h)
        torch.cuda.synchronize()
        bwd_peak = torch.cuda.max_memory_allocated() - base
        launched = (_build.launched(entry="relpos_attn_xl_fwd"),
                    _build.launched(entry="relpos_attn_xl_bwd"))
        o2, lse2 = relpos_xl_fwd(q_u, kv, pos, beta, mask, h)
        again = relpos_xl_bwd(q_u, kv, pos, beta, mask, o2, lse2, dout, h)
        same_bits = torch.equal(o, o2) and all(torch.equal(g, r) for g, r in zip(grads, again))
        leaves = [x.clone().requires_grad_() for x in (q, kv, pos, u, v)]
        got = relpos_attn_xl(*leaves, mask, h)
        got_grads = torch.autograd.grad(got, leaves, dout)
        ref = relpos_attn_xl_plain(*leaves, mask, h)
        ref_grads = torch.autograd.grad(ref, leaves, dout, retain_graph=True)
        errs = {"o": _rel_err(got.detach(), ref.detach()),
                **{k: _rel_err(g, r) for k, g, r in zip(("dq", "dkv", "dpos", "du", "dv"),
                                                        got_grads, ref_grads)}}
        ok = ok and launched == (1, 4) and same_bits and max(errs.values()) <= RELPOS_TOL
        if not masked:
            with torch.no_grad():
                fwd_ms = events_ms(lambda: relpos_xl_fwd(q_u, kv, pos, beta, mask, h))
                chain_fwd_ms = events_ms(lambda: relpos_attn_xl_plain(q, kv, pos, u, v, mask, h))
            bwd_ms = events_ms(lambda: relpos_xl_bwd(q_u, kv, pos, beta, mask, o, lse, dout, h))
            chain_bwd_ms = events_ms(lambda: torch.autograd.grad(ref, leaves, dout,
                                                                 retain_graph=True))
            flops = relpos_flops(b, h, n, d)
            for direction, ms, chain_ms, fl, peak in (
                    ("forward", fwd_ms, chain_fwd_ms, flops, fwd_peak),
                    ("backward", bwd_ms, chain_bwd_ms, 2 * flops, bwd_peak)):
                b_ms, b_by = bound_ms(0.0, fl)
                rows.append({
                    "name": f"relpos_attn_xl_{direction}", "route": "cuda",
                    "source": "speechlid_tpu_torch/csrc/relpos_attn.cu (XL)",
                    "replaces": "none (HF's chain: q+u, q+v products, rel-shift, softmax)",
                    "shape": f"(b, h, n, d) = {RELPOS_XL_SHAPE}, P = n - 1, no mask",
                    "ms": ms, "chain_ms": chain_ms, "plain_ms": chain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "flops": fl,
                    "share_of_fp32_peak": b_ms / ms, "launches": launched[direction != "forward"],
                    "peak_bytes": peak, "heads_per_block": 1,
                    "bhnn_float32_bytes": 4 * b * h * n * n})
        rows[-1].setdefault("checks", {})["masked" if masked else "unmasked"] = {
            "max_rel_err_vs_plain": errs, "same_bits_twice": same_bits}
        del q, kv, pos, u, v, q_u, beta, o, lse, grads, again, o2, lse2, got, got_grads
        del ref, ref_grads, leaves
        torch.cuda.empty_cache()
    return rows, ok


# The wav2vec 2.0 Conformer Large joint model (configs/torch/
# lid_wav2vec_conformer.yaml's module block) at its published widths with 4
# of its 24 layers; for the card-vs-CPU step no dropout, span masks or layer
# drop.  Its attention is the kernels' Transformer-XL form at d = 64.
W2V2_CONFORMER_LAYERS = 4
W2V2_CONFORMER = dict(
    lang2vocab=FLAGSHIP["lang2vocab"], lang2index=FLAGSHIP["lang2index"],
    featurizer="wav2vec2_conformer", feature_selection="last_hidden_state",
    ssl_config=dict(encoder_layers=W2V2_CONFORMER_LAYERS, normalize=True, dropout=0.0,
                    attention_dropout=0.0, mask_prob=0.0, encoder_layerdrop=0.0),
    head_type="conformer_linear", head_layers=1, head_dim_head=32, head_num_head=8,
    dropout=0.0)


def _relpos_launches_by_form() -> dict:
    return {"xl_fwd": _build.launched(entry="relpos_attn_xl_fwd"),
            "xl_bwd": _build.launched(entry="relpos_attn_xl_bwd"),
            "shaw_fwd": _build.launched(entry="relpos_attn_fwd"),
            "shaw_bwd": _build.launched(entry="relpos_attn_bwd")}


def w2v2_conformer_card_vs_cpu(gen: torch.Generator) -> tuple:
    """The wav2vec 2.0 Conformer upstream on the main path:
    ``LidASRTask(featurizer="wav2vec2_conformer")`` (:data:`W2V2_CONFORMER`)
    with random weights (``pos_bias_u`` and ``pos_bias_v`` away from 0) on
    the card (kernels) and the same state_dict on the CPU (HF's rel-shift
    chain): two ``infer`` calls on rows of 4 and 3 s (the scores within
    ``MODEL_TOL``, ``pred_lang`` equal), then one train step (the loss and
    every gradient within ``TRAIN_TOL``); the rel-pos launches of each, the
    counts cleared just before: in scoring one XL forward a layer and one
    Shaw forward a head, a call; in the step one XL forward and four
    backward a layer, one Shaw forward and three backward (the own head).
    → (report, ok)."""
    card = LidASRTask(**W2V2_CONFORMER, device="cuda")
    init_random_(card.model, gen)
    cpu = LidASRTask(**W2V2_CONFORMER, device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    wavs = 0.1 * torch.randn(2, 4 * SR, generator=gen)
    lengths = torch.tensor([4 * SR, 3 * SR])
    clear_launches("relpos")
    got, ref, _, errs = infer_card_vs_cpu(card, cpu, wavs, lengths)
    scoring = _relpos_launches_by_form()
    clear_launches("relpos")
    batch = synthetic_batch(np.random.RandomState(3), lang=1, b=2, seconds=4.0)
    step = step_card_vs_cpu(card, cpu, batch, ("depthwise.bias",))
    training = _relpos_launches_by_form()
    layers = W2V2_CONFORMER_LAYERS
    checks = {
        "scores": errs["max_abs_err_scores"] <= MODEL_TOL,
        "pred_lang": torch.equal(got["pred_lang"], ref["pred_lang"]),
        "step": (step["same_leaves"] and step["rel_err_loss"] <= TRAIN_TOL
                 and step["max_rel_err_gradient"] <= TRAIN_TOL),
        "xl_leaves_compared": all(  # u, v and linear_pos take gradients, compared above
            any(n.endswith(leaf) and p.grad is not None for n, p in card.model.named_parameters())
            for leaf in ("pos_bias_u", "pos_bias_v", "linear_pos.weight")),
        "scoring_launches": scoring == {"xl_fwd": 2 * layers, "xl_bwd": 0,
                                        "shaw_fwd": 2 * N_LANG, "shaw_bwd": 0},
        "train_step_launches": training == {"xl_fwd": layers, "xl_bwd": 4 * layers,
                                            "shaw_fwd": 1, "shaw_bwd": 3},
    }
    report = {"config": f"wav2vec 2.0 Conformer Large widths, {layers} of 24 layers, "
                        "heads 3x(40,96,88) at 1024",
              "params": sum(p.numel() for p in card.model.parameters()),
              "infer_calls": 2, **errs, "scoring_launches": scoring,
              "train_step": {k: v for k, v in step.items() if k != "launches_per_train_step"},
              "train_step_launches": training, "checks": checks}
    del card, cpu
    torch.cuda.empty_cache()
    return report, all(checks.values())


W2V2_CONFORMER_CLI_FACTOR = 0.05  # the recipe's 72 batches of 4 an epoch cut to 3


def phase_cli_w2v2_conformer(root: str, corpus: str) -> dict:
    """The training CLI on ``configs/torch/lid_wav2vec_conformer.yaml`` at
    :data:`W2V2_CONFORMER_LAYERS` layers on the corpus (without the recipe's
    ``wav_augment``, which the CLI refuses as the JAX CLI does): three
    epochs of 3 steps, each followed by an eval of the val clips; epochs 0
    and 1 hold the layers frozen (``freeze_transformer_epoch`` 1), epoch 2
    trains them.  The gradient reaches the attention in every epoch (the
    front end's LayerNorm and ``mask_emb`` train throughout), so the XL
    launches of the run (counts cleared just before) are one forward a layer
    for every train step and eval batch and four backward a layer for every
    step.  Losses and the eval losses must be finite."""
    exp = os.path.join(root, "w2v2_conformer")
    layers = W2V2_CONFORMER_LAYERS
    clear_launches("relpos")
    recorder = run_cli(_cli_args("configs", "torch/lid_wav2vec_conformer",
                                 _langs_override(corpus), f"exp_dir={exp}",
                                 f"module.ssl_config.encoder_layers={layers}",
                                 "data.wav_augment=null", "trainer.total_epoch=3",
                                 f"trainer.train_data_factor={W2V2_CONFORMER_CLI_FACTOR}",
                                 "trainer.progress_bar=false"))
    launched = _relpos_launches_by_form()
    steps = [e["steps"] for e in recorder.epochs]
    batches = [e["batches"] for e in recorder.evals]
    lines = _metrics_lines(os.path.join(exp, "metrics.jsonl"))
    losses = [r["loss"] for r in lines if "loss" in r]
    val = [r["avg_val_loss"] for r in lines if "avg_val_loss" in r]
    report = {"phase": "cli_w2v2_conformer", "layers": layers, "steps": steps,
              "eval_batches": batches, "relpos_launches": launched,
              "loss_first_last": [losses[0], losses[-1]] if losses else None,
              "avg_val_loss": val}
    emit(report)
    ok = (len(steps) == 3 and len(batches) == 3 and all(steps) and losses
          and all(np.isfinite(losses)) and len(val) == 3 and all(np.isfinite(val))
          and launched["xl_fwd"] == layers * (sum(steps) + sum(batches))
          and launched["xl_bwd"] == 4 * layers * sum(steps))
    if not ok:
        raise AssertionError("the wav2vec 2.0 Conformer recipe did not train through the CLI "
                             "on the XL kernels")
    return report


def phase_relpos_attn(gen: torch.Generator, flagship_launches=None) -> list:
    """The rel-pos attention kernels against their plain version (the chain
    the port ran before them: q·Eᵀ over the whole table, a gather, the
    (b, h, n, n) passes) at the benchmark's shapes with ragged masks,
    forward and backward, each twice (the same bits), the calls' peak
    memory (the forward's beside one (b, h, n, n) float32 tensor, the
    backward's against its outputs and partials), and times beside the
    FFMA bound, the chain and one library yardstick (``library_ms``:
    ``F.scaled_dot_product_attention`` with the pair mask and no relative
    positions, never called by the port); then the flagship's scoring
    forward (two ``infer`` calls of ``phase_model``) and training step
    (``phase_train_card_vs_cpu``) counted through them, run here or, in the
    whole script, counted where it ran them (``flagship_launches``: the
    (forward, backward) launches of each); then the XL form at the wav2vec
    2.0 Conformer cell's shape (:func:`relpos_xl_rows`) and that upstream's
    scoring and training step through it (:func:`w2v2_conformer_card_vs_cpu`).
    Returns the kernel rows."""
    rows, ok = [], True
    for shape_name, (b, h, n, d) in RELPOS_SHAPES.items():
        q, kv, table, mask, dout = _relpos_inputs(
            b, h, n, d, "training" if "training" in shape_name else "scoring", gen)
        args = (table, mask, h, RELPOS_P)
        clear_launches("relpos")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        o, lse = relpos_fwd(q, kv, *args)
        torch.cuda.synchronize()
        fwd_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        grads = relpos_bwd(q, kv, table, mask, o, lse, dout, h, RELPOS_P)
        torch.cuda.synchronize()
        bwd_peak = torch.cuda.max_memory_allocated() - base
        launched = _relpos_launches()
        o2, lse2 = relpos_fwd(q, kv, *args)
        again = relpos_bwd(q, kv, table, mask, o2, lse2, dout, h, RELPOS_P)
        same_bits = torch.equal(o, o2) and all(torch.equal(g, r) for g, r in zip(grads, again))
        leaves = [x.clone().requires_grad_() for x in (q, kv, table)]
        ref = relpos_attn_plain(*leaves, mask, h, RELPOS_P)
        ref_grads = torch.autograd.grad(ref, leaves, dout, retain_graph=True)
        errs = {"o": _rel_err(o, ref.detach()),
                **{n_: _rel_err(g, r) for n_, g, r in zip(("dq", "dkv", "dtable"), grads,
                                                         ref_grads)}}
        qh = q.view(b, n, h, d).transpose(1, 2)
        kh, vh = (x.reshape(b, n, h, d).transpose(1, 2) for x in kv.chunk(2, dim=-1))
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        lib = [x.clone().requires_grad_() for x in (qh, kh, vh)]
        lib_o = F.scaled_dot_product_attention(*lib, attn_mask=pair)
        with torch.no_grad():
            fwd_ms = events_ms(lambda: relpos_fwd(q, kv, *args))
            chain_fwd_ms = events_ms(lambda: relpos_attn_plain(q, kv, *args))
            lib_fwd_ms = events_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                          attn_mask=pair))
        bwd_ms = events_ms(lambda: relpos_bwd(q, kv, table, mask, o, lse, dout, h, RELPOS_P))
        chain_bwd_ms = events_ms(lambda: torch.autograd.grad(ref, leaves, dout,
                                                             retain_graph=True))
        lib_bwd_ms = events_ms(lambda: torch.autograd.grad(lib_o, lib, dout.view(
            b, n, h, d).transpose(1, 2), retain_graph=True))
        flops = relpos_flops(b, h, n, d)
        nn_bytes = 4 * b * h * n * n
        # what the backward allocates beside the forward's o and lse: dq, dkv,
        # dtable, dQ's partials (a key tile each) and dE's (a block each)
        np_ = relpos_attn_kernel.tiles(n) * relpos_attn_kernel.TILE
        part_bytes = 4 * sum(math.prod(shape) for shape in relpos_attn_kernel.bwd_partials(
            b, h, n, d))
        bwd_bytes = 4 * (2 * q.numel() + b * h * np_ + kv.numel() + table.numel()) + part_bytes
        for direction, ms, chain_ms, lib_ms, fl, peak, err in (
                ("forward", fwd_ms, chain_fwd_ms, lib_fwd_ms, flops, fwd_peak, errs["o"]),
                ("backward", bwd_ms, chain_bwd_ms, lib_bwd_ms, 2 * flops, bwd_peak,
                 max(errs["dq"], errs["dkv"], errs["dtable"]))):
            b_ms, b_by = bound_ms(0.0, fl)
            rows.append({
                "name": f"relpos_attn_{direction}", "route": "cuda",
                "source": "speechlid_tpu_torch/csrc/relpos_attn.cu",
                "replaces": "none (XLA: q·Eᵀ, gather, softmax)",
                "shape": f"{shape_name} (b, h, n, d) = ({b}, {h}, {n}, {d}), P = {RELPOS_P}, "
                         f"the cell's lengths",
                "ms": ms, "chain_ms": chain_ms, "library_ms": lib_ms,
                "library_call": "F.scaled_dot_product_attention(q, k, v, attn_mask=pair), "
                                "float32, no relative positions",
                "bound_ms": b_ms, "bound_by": b_by, "flops": fl,
                "share_of_fp32_peak": b_ms / ms,
                "launches": launched[0] if direction == "forward" else launched[1],
                "max_rel_err_vs_plain": err,
                "peak_bytes": peak, "bhnn_float32_bytes": nn_bytes,
                **({"bwd_allocated_bytes": bwd_bytes, "bwd_partial_bytes": part_bytes}
                   if direction == "backward" else {}),
                **({"grad_rel_err": {k: v for k, v in errs.items() if k != "o"},
                    "same_bits_twice": same_bits} if direction == "backward" else {}),
            })
            ok = ok and err <= RELPOS_TOL
        # the forward holds o and lse alone; the backward its outputs and
        # partials (the allocator rounds each tensor up to 2 MB)
        ok = (ok and launched == (1, 3) and same_bits and fwd_peak < nn_bytes
              and bwd_peak <= bwd_bytes + 16 * 2 ** 20)
        del q, kv, table, mask, dout, o, lse, grads, again, o2, lse2, ref, ref_grads, lib, lib_o
        torch.cuda.empty_cache()
    # the flagship's scoring forward and training step through the kernels
    if flagship_launches is None:
        clear_launches("relpos")
        phase_model(gen)
        scoring = _relpos_launches()
        clear_launches("relpos")
        phase_train_card_vs_cpu(gen)
        flagship_launches = (scoring, _relpos_launches())
    xl_rows, xl_ok = relpos_xl_rows(gen)
    rows += xl_rows
    w2v2_conformer, w2v2_conformer_ok = w2v2_conformer_card_vs_cpu(gen)
    ok = ok and xl_ok and w2v2_conformer_ok
    scoring, training = flagship_launches
    blocks = N_BLOCKS + N_LANG  # the encoder's and every head's, a forward
    report = {"phase": "relpos_attn", "tol": RELPOS_TOL, "rows": rows,
              "flagship_scoring_launches": {"infer_calls": 2, "fwd": scoring[0],
                                            "bwd": scoring[1]},
              "flagship_train_step_launches": {"fwd": training[0], "bwd": training[1]},
              "w2v2_conformer_card_vs_cpu": w2v2_conformer}
    emit(report)
    # phase_model calls infer twice; a train step runs the encoder and the own head
    ok = ok and scoring == (2 * blocks, 0) and training == (N_BLOCKS + 1, 3 * (N_BLOCKS + 1))
    if not ok:
        raise AssertionError("the rel-pos attention kernels (Shaw's or the XL form) disagree "
                             "with their plain version, differ between two runs, or the "
                             "flagship's or the wav2vec 2.0 Conformer's steps did not go "
                             "through them")
    return rows


class _StepLosses(Callback):
    """Records each step's loss and each eval's metrics, and counts the
    kernels' launches of the train epochs apart from those of the eval
    passes (a wrapper counts when the host makes the launch, so a train
    epoch's launches are all counted when its last step returns)."""

    def __init__(self):
        super().__init__()
        self.losses, self.evals = [], []
        self.train_launches = dict.fromkeys(launches(), 0)
        self.eval_launches = dict.fromkeys(launches(), 0)
        self._mark = None

    def _add_since_mark(self, into: dict) -> None:
        now = launches()
        for name in into:
            into[name] += now[name] - self._mark[name]
        self._mark = now

    def before_train_epoch(self, epoch):
        self._mark = launches()

    def after_train_loop(self, step, metrics):
        self.losses.append(metrics["loss"])

    def after_train_epoch(self, epoch, metrics):
        self._add_since_mark(self.train_launches)

    def after_eval_epoch(self, epoch, metrics):
        self._add_since_mark(self.eval_launches)
        self.evals.append(metrics)


def phase_train(gen: torch.Generator):
    """The training main path: ``Trainer.fit`` on the full-width flagship
    with everything random on, checkpoints, a resume and a served request
    from the trained checkpoint.  Launch counts are read around the fit."""
    hp = dict(FLAGSHIP, **TRAIN_HPARAMS)
    rng = np.random.RandomState(0)
    train = [synthetic_batch(rng, i % N_LANG, TRAIN_B, TRAIN_SECONDS)
             for i in range(TRAIN_BATCHES)]
    val = [synthetic_batch(rng, lang, TRAIN_B, TRAIN_SECONDS) for lang in range(N_LANG)]
    task = LidASRTask(**hp, device="cuda")
    init_random_(task.model, gen)
    task.init_parameters = lambda generator: None  # keep init_random_'s weights
    rec = _StepLosses()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(total_epoch=TRAIN_EPOCHS, use_progress_bar=False, seed=0,
                          callbacks=[rec, CkptCallback(ckpt_dir)])
        torch.cuda.synchronize()
        reset_launches()
        trainer.fit(task, train, val)
        counted = launches()
        last = f"{ckpt_dir}/last.ckpt"

        resumed_task = LidASRTask(**hp, device="cuda")
        resumed_rec = _StepLosses()
        resumed = Trainer(total_epoch=TRAIN_EPOCHS + 1, use_progress_bar=False, seed=0,
                          callbacks=[resumed_rec], checkpoint_path=last)
        resumed.fit(resumed_task, train, val)
        lid_fn, index2lang = build_lid_fn(last)
        state = InferenceState(lid_fn, index2lang)
        scores = lid_fn(*state.pad(train[0]["wavs"][0][:3 * SR]))

    n_steps, n_evals = TRAIN_EPOCHS * TRAIN_BATCHES, TRAIN_EPOCHS * len(val)
    per_train_step = {k: v / n_steps for k, v in rec.train_launches.items()}
    per_eval_batch = {k: v / n_evals for k, v in rec.eval_launches.items()}
    epoch_loss = [float(np.mean(rec.losses[i * TRAIN_BATCHES:(i + 1) * TRAIN_BATCHES]))
                  for i in range(TRAIN_EPOCHS)]
    last_eval = rec.evals[-1]
    emit({
        "phase": "train", "epochs": TRAIN_EPOCHS, "batches": TRAIN_BATCHES,
        "batch": [TRAIN_B, int(TRAIN_SECONDS * SR)],
        "losses": rec.losses, "epoch_loss": epoch_loss, "evals": rec.evals,
        "launches": counted, "launches_train_steps": rec.train_launches,
        "launches_eval_batches": rec.eval_launches,
        "launches_per_train_step": per_train_step,
        "launches_per_train_step_expected": TRAIN_STEP_LAUNCHES,
        "launches_per_eval_batch": per_eval_batch,
        "resumed": {"start_epoch": resumed.start_epoch, "global_step": resumed.global_step,
                    "losses": resumed_rec.losses},
        "served_from_trained_ckpt": scores.tolist(),
    })
    checks = {
        "finite_losses": bool(np.isfinite(rec.losses + resumed_rec.losses).all()),
        "loss_falls": epoch_loss[-1] < epoch_loss[0],
        "launches": (per_train_step == TRAIN_STEP_LAUNCHES
                     and per_eval_batch == PER_FORWARD_LAUNCHES
                     and counted == {k: rec.train_launches[k] + rec.eval_launches[k]
                                     for k in counted}),
        "eval_metrics": all(np.isfinite(last_eval[k]) for k in ("val_acc", "eer", "cavg",
                                                                  "avg_val_loss")),
        "resume": (resumed.start_epoch == TRAIN_EPOCHS
                   and resumed.global_step == (TRAIN_EPOCHS + 1) * TRAIN_BATCHES
                   and len(resumed_rec.losses) == TRAIN_BATCHES),
        "served": scores.shape == (1, N_LANG) and bool(np.isfinite(scores).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"training phase failed: {checks}")
    return rec.train_launches, (trainer, train)


# ------------------------------------------------------------ the CLI


# the round-5 trained-LID corpus (scripts/trained_lid_artifact.py:115 sizes,
# scripts/synth_corpus.py:119-120 seeds) and the gate's bar
CORPUS_TRAIN, CORPUS_VAL = 96, 24
GATE_EPOCHS = 32
GATE_ACC = 0.9
# Whether one run reaches GATE_ACC is a draw: the best val_acc of the JAX
# CLI over seeds 0-3 on the CPU (scripts/jax_gate_seeds.py) and of the port
# over seeds 0-7 on the H100 (--only cli_gate --seed N, and this script at
# seed 0) spreads over 0.78-0.93, with about one run in four at 0.9 or
# above, and the card's training is not bit-stable from run to run (seed 0
# read 0.875 and 0.833 in one call).  So the bar is reported, and the phase
# fails when the run did not learn: the best val_acc below LEARNED_ACC
# (chance is 1/3; 0.6 is 4.8 standard deviations above it for 72 clips, and
# below every run of either implementation) or the best val_wer above
# LEARNED_WER (every run reached 0.051 or less).
LEARNED_ACC = 0.6
LEARNED_WER = 0.2
# round 5's held-out val accuracy by epoch (the JAX CLI on one TPU v5 lite
# chip, docs/runs/TRAINED_LID_r5.md): the trajectory the gate is read against
ROUND5_VAL_ACC = {4: 0.306, 8: 0.625, 12: 0.889, 16: 0.931}
# what the JAX CLI's metrics.jsonl lines hold (tests/test_torch_cli.py holds
# the port's lines to the JAX CLI's)
CLI_EVAL_KEYS = {"avg_val_loss", "val_acc", "val_wer", "eer", "cavg", "eer_true", "cavg_true"}
CLI_TRAIN_KEYS = ({"loss"}, {"lr"}, {"avg_train_loss"})
# batches an epoch: 3 languages × 96 clips in language-homogeneous batches
# of 8 (the batch size of both configs) are 36; the flagship's factor leaves 9
CLI_EPOCH_STEPS = N_LANG * -(-CORPUS_TRAIN // 8)
FLAGSHIP_DATA_FACTOR = 0.25
FLAGSHIP_STEPS = int(CLI_EPOCH_STEPS * FLAGSHIP_DATA_FACTOR)


def gate_config_text(corpus_root: str) -> str:
    """The round-5 trained-LID config (scripts/trained_lid_artifact.py:56-90,
    its values verbatim) over the corpus at ``corpus_root``, with
    ``total_epoch`` raised to 32: 36 steps an epoch, an eval every 4."""
    langs = "\n".join(
        f"    - manifest: {corpus_root}/{lang}/train.txt\n"
        f"      val_manifest: {corpus_root}/{lang}/val.txt"
        for lang in sorted(os.listdir(corpus_root))
        if os.path.exists(os.path.join(corpus_root, lang, "train.txt"))
    )
    return f"""model_name: trained_lid
experiment_name: trained_lid_r5
stage: train
trainer:
  total_epoch: {GATE_EPOCHS}
  progress_bar: false
  save_topk: 1
  eval_interval: 4
module:
  task: lid_asr
  n_blocks: 4
  encoder_dim: 96
  heads: 4
  dim_head: 24
  sub_sampling: 4
  head_dim_head: 16
  head_num_head: 4
  mask_times: 1
  dropout: 0.05
  pos_dropout: 0.0
  use_stochastic_depth: false
  remat: true
  lr: 2.0e-3
  schedule: null
data:
  source: xf
  sample_rate: {SR}
  batch_size: 8
  max_duration: 3.0
  max_duration_eval: 3.0
  max_text_len: 16
  buckets_s: [3.0]
  langs:
{langs}
"""


def _synth_corpus():
    """``scripts/synth_corpus.py`` as a module (it imports the JAX package
    only inside the functions that write wavs, which this script never
    calls)."""
    spec = importlib.util.spec_from_file_location(
        "synth_corpus", Path(__file__).resolve().parent / "scripts" / "synth_corpus.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    return synth


def phase_cli_corpus(root: str) -> str:
    """Write the round-5 tone-code corpus under ``root``: 3 languages × 96
    train / 24 val clips, each language's train and val split from the seeds
    ``make_corpus`` uses, built from ``synth_utterance`` and ``make_text``
    and written with the port's ``write_wav`` (``make_corpus`` itself writes
    with the JAX package's)."""
    from speechlid_tpu_torch.data.audio_io import write_wav

    synth = _synth_corpus()
    t0 = time.perf_counter()
    corpus = os.path.join(root, "corpus")
    seconds = []
    for li, lang in enumerate(sorted(synth.LANG_CHARS)):
        wav_dir = os.path.join(corpus, lang, "wav", "train")
        os.makedirs(wav_dir)
        for split, n, seed in (("train", CORPUS_TRAIN, 100 + li), ("val", CORPUS_VAL, 200 + li)):
            rng = np.random.RandomState(seed)
            lines = []
            for i in range(n):
                text = synth.make_text(lang, rng)
                wav = synth.synth_utterance(lang, text, rng)
                write_wav(os.path.join(wav_dir, f"{split}{i}.wav"), wav, synth.SR)
                lines.append(f"{split}{i}.wav\t{text}")
                seconds.append(len(wav) / synth.SR)
            with open(os.path.join(corpus, lang, f"{split}.txt"), "w") as f:
                f.write("\n".join(lines))
    emit({"phase": "cli_corpus", "seconds": time.perf_counter() - t0,
          "langs": sorted(synth.LANG_CHARS), "train_per_lang": CORPUS_TRAIN,
          "val_per_lang": CORPUS_VAL, "clips": len(seconds),
          "clip_seconds": [min(seconds), max(seconds)], "audio_seconds": sum(seconds)})
    return corpus


class _CliRecorder(ProfileCallback):
    """The CLI's own ``ProfileCallback``, recording as well, per train epoch:
    the steps and the kernels' launches; per eval epoch the batches and the
    launches.  ``chip_smoke`` puts it in ``cli.main_lid``'s namespace for
    the CLI runs, so the CLI builds it in place of ``ProfileCallback``."""

    runs: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.epochs, self.evals = [], []
        _CliRecorder.runs.append(self)

    def before_train_epoch(self, epoch):
        self._step0, self._mark = self.trainer.global_step, launches()
        self._eval_batches = 0

    def after_train_epoch(self, epoch, metrics):
        now = launches()
        self.epochs.append({"epoch": epoch, "steps": self.trainer.global_step - self._step0,
                            "launches": {k: now[k] - self._mark[k] for k in now}})
        self._mark = now
        super().after_train_epoch(epoch, metrics)

    def after_eval_loop(self, metrics):
        self._eval_batches += 1

    def after_eval_epoch(self, epoch, metrics):
        now = launches()
        self.evals.append({"epoch": epoch, "batches": self._eval_batches,
                           "launches": {k: now[k] - self._mark[k] for k in now}})


def run_cli(args: list, recorder_class: type = None) -> _CliRecorder:
    """``cli.main_lid.main(args)`` in this process, with :class:`_CliRecorder`
    (or its subclass ``recorder_class``) as its ``ProfileCallback``; → the
    recorder."""
    from speechlid_tpu_torch.cli import main_lid

    saved = main_lid.ProfileCallback
    main_lid.ProfileCallback = recorder_class or _CliRecorder
    _CliRecorder.runs.clear()
    try:
        main_lid.main(args)
    finally:
        main_lid.ProfileCallback = saved
    torch.cuda.synchronize()
    (recorder,) = _CliRecorder.runs
    return recorder


def _per_step(recorder) -> tuple:
    """(launches per train step, per eval batch), each a dict when every
    epoch of the run gives the same, else the list of what they gave."""
    train = [{k: n / e["steps"] for k, n in e["launches"].items()} for e in recorder.epochs]
    evals = [{k: n / e["batches"] for k, n in e["launches"].items()} for e in recorder.evals]
    return tuple(x[0] if x and all(y == x[0] for y in x) else x for x in (train, evals))


def _metrics_lines(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _cli_args(config_dir: str, name: str, *overrides: str) -> list:
    return ["--config-dir", config_dir, "--config-name", name, *overrides]


def _langs_override(corpus: str) -> str:
    """The ``data.langs=[…]`` override that points a config at the corpus."""
    return "data.langs=[" + ", ".join(
        f"{{manifest: {corpus}/{lang}/train.txt, val_manifest: {corpus}/{lang}/val.txt}}"
        for lang in sorted(os.listdir(corpus))) + "]"


def phase_cli_flagship(root: str, corpus: str) -> dict:
    """The port's training CLI at full width: ``configs/lid_supervised.yaml``
    (the 14 × 144-d flagship with time stretch, SpecAugment, dropout and
    stochastic depth) on the corpus, one epoch cut to 9 steps, then a resume
    for one more, each followed by an eval over the 72 val clips; the
    launches per train step and per eval batch, the metrics lines, the
    checkpoint, and one ``/lid`` answer from it.  Launch counts are set to 0
    just before each run and read just after."""
    exp = os.path.join(root, "flagship")
    base = [_langs_override(corpus), f"exp_dir={exp}", "trainer.progress_bar=false",
            f"trainer.train_data_factor={FLAGSHIP_DATA_FACTOR}"]
    last = os.path.join(exp, "ckpt", "last.ckpt")
    runs, counted = {}, {}
    for name, extra in (("fit", ["trainer.total_epoch=1"]),
                        ("resume", ["trainer.total_epoch=2", f"trainer.resume_from={last}"])):
        torch.cuda.synchronize()
        reset_launches()
        runs[name] = run_cli(_cli_args("configs", "lid_supervised", *base, *extra))
        counted[name] = launches()
    lines = _metrics_lines(os.path.join(exp, "metrics.jsonl"))
    evals = [line for line in lines if CLI_EVAL_KEYS <= set(line)]
    train_kinds = {frozenset(set(line) - {"step", "ts"}) for line in lines
                   if "run" not in line and not CLI_EVAL_KEYS & set(line)}
    ckpt_meta = load_checkpoint(last)["meta"]
    lid_fn, index2lang = build_lid_fn(last)
    state = InferenceState(lid_fn, index2lang)
    from speechlid_tpu_torch.data.audio_io import read_wav

    wav, _ = read_wav(os.path.join(corpus, "bb", "wav", "train", "val0.wav"))
    answer = state.lid(wav)
    report = {"phase": "cli_flagship", "config": "configs/lid_supervised.yaml (14 x 144-d)",
              "steps_per_epoch": FLAGSHIP_STEPS, "runs": {}, "launches": counted,
              "evals": evals, "metrics_line_kinds": sorted(sorted(k) for k in train_kinds),
              "ckpt_files": sorted(os.listdir(os.path.join(exp, "ckpt"))),
              "ckpt_meta": {k: ckpt_meta[k] for k in ("epoch", "global_step")},
              "served_from_cli_ckpt": answer}
    checks = {}
    for name, recorder in runs.items():
        per_step, per_eval = _per_step(recorder)
        report["runs"][name] = {"epochs": recorder.epochs,
                                "eval_batches": [e["batches"] for e in recorder.evals],
                                "launches_per_train_step": per_step,
                                "launches_per_eval_batch": per_eval}
        checks[f"{name}_launches"] = (per_step == TRAIN_STEP_LAUNCHES
                                      and per_eval == PER_FORWARD_LAUNCHES)
        checks[f"{name}_steps"] = [e["steps"] for e in recorder.epochs] == [FLAGSHIP_STEPS]
    emit(report)
    checks.update({
        "eval_lines": len(evals) == 2 and all(np.isfinite(e["avg_val_loss"]) for e in evals),
        "train_lines": train_kinds == set(map(frozenset, CLI_TRAIN_KEYS)),
        "ckpt": ckpt_meta["epoch"] == 1 and ckpt_meta["global_step"] == 2 * FLAGSHIP_STEPS,
        "resumed_at_epoch_1": [e["epoch"] for e in runs["resume"].epochs] == [1],
        "served": set(answer) == {"lang", "scores"} and len(answer["scores"]) == N_LANG
        and all(np.isfinite(v) for v in answer["scores"].values()),
    })
    if not all(checks.values()):
        raise AssertionError(f"CLI flagship phase failed: {checks}")
    return {k: counted["fit"][k] + counted["resume"][k] for k in counted["fit"]}, report


def phase_cli_gate(root: str, corpus: str, smi: str, overrides=()) -> dict:
    """The round-5 accuracy gate through the CLI: the round-5 config (4 ×
    96-d) on the round-5 corpus for 32 epochs.  Reports whether the best
    held-out ``val_acc`` reaches the bar of 0.9 (``bar_met``) and fails when
    the run did not learn (see ``LEARNED_ACC``), or when its evaluations,
    steps or launches are not the expected ones.  Reports the whole eval
    trajectory beside round 5's and the launches per train step and per
    eval batch.  ``overrides`` are
    further ``key=value`` arguments of the CLI (none for the gate itself)."""
    conf_dir = os.path.join(root, "conf")
    os.makedirs(conf_dir)
    with open(os.path.join(conf_dir, "gate.yaml"), "w") as f:
        f.write(gate_config_text(corpus))
    exp = os.path.join(root, "gate")
    torch.cuda.synchronize()
    reset_launches()
    recorder = run_cli(_cli_args(conf_dir, "gate", f"exp_dir={exp}", *overrides))
    counted = launches()
    lines = _metrics_lines(os.path.join(exp, "metrics.jsonl"))
    steps_per_epoch = recorder.epochs[0]["steps"]
    trajectory = [{"epoch": line["step"] // steps_per_epoch, "step": line["step"],
                   **{k: line[k] for k in ("val_acc", "avg_val_loss", "val_wer", "eer_true",
                                           "cavg_true")}}
                  for line in lines if CLI_EVAL_KEYS <= set(line)]
    best = max(t["val_acc"] for t in trajectory)
    first = next((t["epoch"] for t in trajectory if t["val_acc"] >= GATE_ACC), None)
    steps = sum(e["steps"] for e in recorder.epochs)
    per_step, per_eval = _per_step(recorder)
    n_blocks = 4  # the round-5 config's
    # its remat: true rematerializes each encoder block, whose conv module
    # runs its training forward again in the backward (the head's is not)
    want_step = launch_counts(fbank=1, bwd_w=n_blocks + 1, glu=2 * n_blocks + 1,
                              glu_dx=n_blocks + 1)
    want_eval = launch_counts(fbank=1, glu_bn_act=n_blocks + N_LANG)
    report = {
        "phase": "cli_gate", "config": "scripts/trained_lid_artifact.py:56-90, total_epoch 32",
        "overrides": list(overrides),
        "nvidia_smi": smi, "bar": GATE_ACC, "bar_met": best >= GATE_ACC,
        "learned_floor": {"val_acc": LEARNED_ACC, "val_wer": LEARNED_WER},
        "best_val_acc": best, "first_epoch_at_bar": first, "trajectory": trajectory,
        "round5_val_acc_jax_cli": ROUND5_VAL_ACC,
        "epochs": GATE_EPOCHS, "steps": steps, "steps_per_epoch": steps_per_epoch,
        "launches": counted, "launches_per_train_step": per_step,
        "launches_per_eval_batch": per_eval,
    }
    emit(report)
    checks = {"learned": best >= LEARNED_ACC
              and min(t["val_wer"] for t in trajectory) <= LEARNED_WER,
              "evals": len(trajectory) == GATE_EPOCHS // 4,
              "steps": steps == GATE_EPOCHS * steps_per_epoch == GATE_EPOCHS * CLI_EPOCH_STEPS,
              "launches": per_step == want_step and per_eval == want_eval}
    if not all(checks.values()):
        raise AssertionError(f"CLI gate phase failed: {checks}")
    return report


# ------------------------------------------- eval CLI and augmentation


def _tf32() -> tuple:
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def phase_tf32_entry(gen: torch.Generator) -> dict:
    """A bare ``LidASRTask(device="cuda")``, built outside any trainer or
    server with both TF32 flags at PyTorch's default (on), switches them
    off itself, and its ``infer_fn`` agrees with the CPU from the same
    weights.  The flags are put back as they were."""
    saved = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        task = LidASRTask(**FLAGSHIP, device="cuda")
        flags = _tf32()
        init_random_(task.model, gen)
        cpu_task = LidASRTask(**FLAGSHIP, device="cpu")
        cpu_task.model.load_state_dict(task.model.state_dict())
        wavs = 0.1 * torch.randn(4, 3 * SR, generator=gen)
        lengths = torch.tensor([3 * SR, 40000, 24000, 12000])
        got = {k: v.cpu() for k, v in task.infer_fn()(wavs, lengths).items()}
        ref = cpu_task.infer_fn()(wavs, lengths)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    err = (got["scores"] - ref["scores"]).abs().max().item()
    report = {"phase": "tf32_entry", "flags_after_task": flags, "flags_restored": _tf32(),
              "max_abs_err_scores": err, "tol": MODEL_TOL,
              "pred_lang": got["pred_lang"].tolist(), "pred_lang_cpu": ref["pred_lang"].tolist()}
    emit(report)
    checks = {"tf32_off": flags == (False, False), "scores": err <= MODEL_TOL,
              "pred_lang": torch.equal(got["pred_lang"], ref["pred_lang"]),
              "restored": _tf32() == saved}
    if not all(checks.values()):
        raise AssertionError(f"tf32_entry failed: {checks}")
    return report


EVAL_OPS_TOL = 1e-4  # card vs CPU, absolute, on wavs of unit scale: convolutions in another order
MIX_REL_TOL = 1e-5  # card vs CPU, relative to the largest sample
MIX_SNR_DB_TOL = 0.01


def phase_eval_ops(gen: torch.Generator) -> dict:
    """The waveform ops of the eval and augmentation paths on the card
    against the CPU, at the augmentor's batch (8, 64000): ``mix_at_snr``
    (and the SNR it reaches), ``resample`` / ``speed_perturb``,
    ``pitch_shift`` and ``fir_reverb`` with a 2048-tap RIR."""
    from speechlid_tpu_torch.ops import augment, resample

    x = frontend.normalize_wav(torch.randn(8, 4 * SR, generator=gen))
    noise = torch.randn(8, 4 * SR, generator=gen)
    lengths = torch.tensor([4 * SR, 60000, 52000, 48000, 40000, 32000, 24000, 16000])
    xc, nc, lc = x.cuda(), noise.cuda(), lengths.cuda()
    mix = {}
    for snr in (0.0, 5.0, 10.0, 15.0):
        got = augment.mix_at_snr(xc, nc, snr, lc).cpu()
        want = augment.mix_at_snr(x, noise, snr, lengths)
        added = got - x
        achieved = [10 * np.log10((x[i, :n] ** 2).mean().item() / (added[i, :n] ** 2).mean().item())
                    for i, n in enumerate(lengths.tolist())]
        mix[snr] = {"max_rel_err": ((got - want).abs().max() / want.abs().max()).item(),
                    "snr_db_worst_miss": max(abs(a - snr) for a in achieved)}
    rir = augment.synthetic_rir(torch.Generator().manual_seed(1), SR)
    ops = {
        "resample_16000_to_22050": lambda v: resample.resample(v, 16000, 22050),
        "speed_perturb_0.9": lambda v: resample.speed_perturb(v, SR, 0.9, v.shape[-1]),
        "speed_perturb_1.1": lambda v: resample.speed_perturb(v, SR, 1.1, v.shape[-1]),
        "pitch_shift_-80": lambda v: augment.pitch_shift(v, SR, -80.0),
        "pitch_shift_20": lambda v: augment.pitch_shift(v, SR, 20.0),
        "fir_reverb_2048": lambda v: augment.fir_reverb(v, rir.to(v.device)),
    }
    errs = {name: (fn(xc).cpu() - fn(x)).abs().max().item() for name, fn in ops.items()}
    report = {"phase": "eval_ops", "shape": list(x.shape), "mix_at_snr": mix,
              "max_abs_err": errs, "tol": EVAL_OPS_TOL, "mix_rel_tol": MIX_REL_TOL,
              "mix_snr_db_tol": MIX_SNR_DB_TOL, "tf32": _tf32()}
    emit(report)
    checks = {"mix": all(m["max_rel_err"] <= MIX_REL_TOL and m["snr_db_worst_miss"] <= MIX_SNR_DB_TOL
                         for m in mix.values()),
              "ops": all(e <= EVAL_OPS_TOL for e in errs.values())}
    if not all(checks.values()):
        raise AssertionError(f"eval_ops failed: {checks}")
    return report


# the eval grid: clean, then three noises (factory2 is not written, so the
# sweep skips it) at 0, 5, 10 and 15 dB; 9 batches of 8 of the 72 val clips
EVAL_CELLS = 1 + 3 * 4
EVAL_BATCHES = N_LANG * -(-CORPUS_VAL // 8)
KENLM_THRESHOLD = 0.15


def phase_eval_inputs(root: str) -> tuple:
    """The noise recordings of ``scripts/synth_corpus.py`` ``write_noises``
    (its arrays' recipe, seed 7, 4 s, written with the port's ``write_wav``:
    ``write_noises`` writes with the JAX package's) and its per-language
    word-unigram ARPAs (``write_lms``).  → (noise dir, LM dir)."""
    from speechlid_tpu_torch.data.audio_io import write_wav

    synth = _synth_corpus()
    rng = np.random.RandomState(7)
    t = np.arange(SR * 4) / SR
    white = rng.randn(len(t)) * 0.3
    babble = sum(
        np.sin(2 * np.pi * f * t + rng.rand() * 6.28) * (0.5 + 0.5 * np.sin(2 * np.pi * r * t))
        for f, r in [(170, 2.3), (220, 3.1), (310, 1.7), (450, 2.9)]
    ) * 0.15 + 0.05 * rng.randn(len(t))
    factory = (0.4 * np.sin(2 * np.pi * 50 * t) + 0.25 * np.sin(2 * np.pi * 120 * t)
               + 0.2 * rng.randn(len(t)))
    noise_dir, lm_dir = os.path.join(root, "noise"), os.path.join(root, "lms")
    os.makedirs(noise_dir)
    for name, wav in (("white", white), ("babble", babble), ("factory1", factory)):
        write_wav(os.path.join(noise_dir, f"{name}.wav"), wav.astype(np.float32), SR)
    synth.write_lms(lm_dir)
    return noise_dir, lm_dir


def run_test_lid(args: list) -> tuple:
    """``cli.test_lid.main(args)`` in this process, its launches counted
    from 0, and the shapes the kernels were called at: the fbank kernel's
    wav (B, T) and each conv module's (B, T, C, k); → (its result, the
    launches, {"fbank": shapes, "glu_bn_act": shapes})."""
    from speechlid_tpu_torch.cli import test_lid

    shapes = {"fbank": set(), "glu_bn_act": set()}
    wav2mel = frontend.wav2mel  # hands its wav to the fbank kernel as it is

    def wav2mel_seen(wav, *args, **kwargs):
        shapes["fbank"].add(tuple(wav.shape))
        return wav2mel(wav, *args, **kwargs)

    def conv_seen(module, inputs, output):
        if isinstance(module, ConformerConvModule):
            k, c = module.depthwise.weight.shape
            shapes["glu_bn_act"].add((*inputs[0].shape[:2], c, k))

    frontend.wav2mel = wav2mel_seen
    hook = torch.nn.modules.module.register_module_forward_hook(conv_seen)
    try:
        torch.cuda.synchronize()
        reset_launches()
        result = test_lid.main(args)
        torch.cuda.synchronize()
    finally:
        frontend.wav2mel = wav2mel
        hook.remove()
    return result, launches(), shapes


def _cell(row: dict, noise: str = "clean", snr=None) -> dict:
    """A sweep row, or one cell's result with its ``noise`` and ``snr``."""
    return {"noise": row.get("noise", noise), "snr": row.get("snr", snr),
            **{k: row[k] for k in ("acc", "eer", "cavg", "eer_true", "cavg_true", "cer",
                                   "lm_arbitrated", "n_utts")},
            "ms_per_utt": row["avg_time_s"] * 1e3}


def phase_cli_eval(name: str, root: str, ckpt: str, config: list, logged_val_acc: float,
                   n_blocks: int, shapes: dict, inputs: tuple, smi: str,
                   single_cell: bool) -> dict:
    """The port's eval CLI (``cli.test_lid.main``) on a checkpoint the
    training CLI wrote: (a) a clean run without LMs gives the ``val_acc``
    the training CLI logged for it on the same 72 clips; (b) ``--sweep``
    with the LMs at ``--kenlm-threshold`` 0.15 and the three noises gives
    13 rows of 72 utterances; (c) each eval batch launches the fbank kernel
    once and the fused eval conv kernel in every encoder and head block;
    (d, ``single_cell``) one noisy cell with ``--csv`` and ``--submission``
    writes 72 records and 72 lines; (e) the kernels ran at ``shapes``
    alone ({"fbank": (B, T), "glu_bn_act": (B, T, C, k)}), shapes at which
    the earlier phases held them against their plain versions."""
    noise_dir, lm_dir = inputs
    out_dir = os.path.join(root, f"eval_{name}")
    os.makedirs(out_dir)
    want_batch = launch_counts(fbank=1, glu_bn_act=n_blocks + N_LANG)
    base = ["--ckpt", ckpt, *config]
    clean, clean_launches, clean_shapes = run_test_lid(base)
    rows, sweep_launches, sweep_shapes = run_test_lid(
        base + ["--sweep", "--lm-dir", lm_dir, "--kenlm-threshold", str(KENLM_THRESHOLD),
                "--noise-dir", noise_dir, "--csv", os.path.join(out_dir, "sweep.jsonl")])
    per_batch = {k: v / (EVAL_CELLS * EVAL_BATCHES) for k, v in sweep_launches.items()}
    report = {
        "phase": f"cli_eval_{name}", "nvidia_smi": smi, "checkpoint": os.path.relpath(ckpt, root),
        "clean": _cell(clean), "logged_val_acc": logged_val_acc,
        "clean_launches_per_batch": {k: v / EVAL_BATCHES for k, v in clean_launches.items()},
        "kenlm_threshold": KENLM_THRESHOLD, "sweep": [_cell(r) for r in rows],
        "sweep_launches": sweep_launches,
        "sweep_launches_per_batch": per_batch, "batches_per_cell": EVAL_BATCHES,
        "kernel_shapes": {k: sorted(v) for k, v in sweep_shapes.items()},
    }
    checks = {
        "a_clean_acc": clean["acc"] == logged_val_acc and clean["n_utts"] == N_LANG * CORPUS_VAL,
        "b_sweep": (len(rows) == EVAL_CELLS
                    and all(r["n_utts"] == N_LANG * CORPUS_VAL for r in rows)
                    and [r["noise"] for r in rows] == ["clean"] + [
                        n for n in ("white", "factory1", "babble") for _ in range(4)]
                    and all(np.isfinite(r[k]) for r in rows for k in ("eer", "cavg", "cer"))),
        "c_launches": (per_batch == want_batch
                       and {k: v / EVAL_BATCHES for k, v in clean_launches.items()} == want_batch),
        "e_shapes": ({k: {v} for k, v in shapes.items()} == clean_shapes == sweep_shapes
                     and shapes["fbank"] in FBANK_SHAPES.values()
                     and shapes["glu_bn_act"] in FUSED_SHAPES),
    }
    if single_cell:
        csv_path, sub_path = os.path.join(out_dir, "cell.csv"), os.path.join(out_dir, "cell.sub")
        cell, _, _ = run_test_lid(base + ["--snr", "5", "--noise", "babble", "--noise-dir",
                                          noise_dir, "--lm-dir", lm_dir, "--kenlm-threshold",
                                          str(KENLM_THRESHOLD), "--csv", csv_path,
                                          "--submission", sub_path])
        with open(csv_path) as f:
            n_records = len(f.read().strip().splitlines()) - 1  # a header line
        with open(sub_path) as f:
            n_lines = len(f.read().strip().splitlines())
        report.update(single_cell=_cell(cell, "babble", 5.0), csv_records=n_records,
                      submission_lines=n_lines)
        checks["d_files"] = n_records == n_lines == N_LANG * CORPUS_VAL
    report["checks"] = checks
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"cli_eval_{name} failed: {checks}")
    return report


AUGMENT_CONF = "data.wav_augment={speed: true, pitch: true, reverb: true}"
AUGMENT_EPOCHS = 3
AUGMENT_VARIANTS = {"speed": (0.9, 0, False), "pitch": (1.0, 40, False),
                    "reverb": (1.0, 0, True)}  # (speed, cents, reverb)


def augmentor_card_vs_cpu() -> dict:
    """``WavAugmentor(device="cuda")``, the chain ``data.wav_augment={device:
    cuda}`` runs, once for each variant at (8, 64000), dither and
    preemphasis on, untimed: its output stays on the card with the batch's
    shape, is finite, and is held against the CPU augmentor's on the same
    draw (the card's dithered wavs and room impulse response, replayed from
    its generator's state, stand in for the CPU's draws)."""
    from speechlid_tpu_torch.data import augmentor

    card, cpu = WavAugmentor(sample_rate=SR, device="cuda"), WavAugmentor(sample_rate=SR)
    wavs = torch.from_numpy((0.1 * np.random.RandomState(0).randn(8, 4 * SR)).astype(np.float32))
    dither, synthetic_rir = augmentor.dither, augmentor.synthetic_rir
    errs, on_card = {}, {}
    for name, variant in AUGMENT_VARIANTS.items():
        replay = torch.Generator(device="cuda")
        replay.set_state(card.generator.get_state())
        got = card.apply(wavs.cuda(), *variant)
        on_card[name] = (got.is_cuda and got.shape == wavs.shape
                         and bool(torch.isfinite(got).all()))
        dithered = dither(replay, wavs.cuda()).cpu()
        rir = synthetic_rir(replay, SR, rt60=0.3).cpu()
        augmentor.dither = lambda *args, **kwargs: dithered
        augmentor.synthetic_rir = lambda *args, **kwargs: rir
        try:
            want = cpu.apply(wavs, *variant)
        finally:
            augmentor.dither, augmentor.synthetic_rir = dither, synthetic_rir
        errs[name] = (got.cpu() - want).abs().max().item()
    checks = {"on_card": all(on_card.values()),
              "vs_cpu": all(e <= EVAL_OPS_TOL for e in errs.values())}
    return {"shape": list(wavs.shape), "max_abs_err_vs_cpu": errs, "tol": EVAL_OPS_TOL,
            "checks": checks}


class _AugmentorRecorder(WavAugmentor):
    """The CLI's ``WavAugmentor``, counting its calls.  ``run_cli_feeders``
    puts it in ``cli.main_lid``'s namespace, so the CLI builds it."""

    built: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = 0
        _AugmentorRecorder.built.append(self)

    def __call__(self, wavs, lengths):
        self.calls += 1
        return super().__call__(wavs, lengths)


def run_cli_feeders(args: list) -> tuple:
    """:func:`run_cli` with :class:`_AugmentorRecorder` as the CLI's
    ``WavAugmentor`` and each feeder the CLI builds recorded with the
    batches it assembled; → (the recorder, the augmentors built, [(train,
    feeder, batches assembled)])."""
    from speechlid_tpu_torch.cli import main_lid

    saved = main_lid.WavAugmentor, main_lid.build_feeder
    feeders = []

    def build_feeder(conf, dataset, seed=0, train=True):
        feeder = saved[1](conf, dataset, seed=seed, train=train)
        entry = [train, feeder, 0]
        assemble = feeder._assemble

        def assemble_counted(idxs):
            entry[2] += 1
            return assemble(idxs)

        feeder._assemble = assemble_counted
        feeders.append(entry)
        return feeder

    main_lid.WavAugmentor, main_lid.build_feeder = _AugmentorRecorder, build_feeder
    _AugmentorRecorder.built.clear()
    before = set(threading.enumerate())
    try:
        recorder = run_cli(args)
    finally:
        main_lid.WavAugmentor, main_lid.build_feeder = saved
    # an epoch cut short leaves its prefetch thread to finish the batch it
    # is assembling: wait for it before the counts are read
    for thread in set(threading.enumerate()) - before:
        if thread.name.endswith("(worker)"):
            thread.join(timeout=30)
    return recorder, list(_AugmentorRecorder.built), feeders


def phase_cli_augment(root: str, corpus: str) -> dict:
    """The training CLI at full width (``configs/lid_supervised.yaml``, 9
    steps an epoch, 3 epochs) without and with ``data.wav_augment={speed:
    true, pitch: true, reverb: true}`` at its default ``device: cpu``: one
    plain run, then one augmented run.  Checks: every epoch takes its
    9 steps; a train step launches what it does without augmentation (the
    augmentor runs on the host); an augmented run builds one augmentor, for
    the train feeder, which calls it once for every batch it assembles, and
    the eval feeder has none; a plain run builds none.  Then the augmentor
    on the card against the CPU's (:func:`augmentor_card_vs_cpu`)."""
    runs, checks = [], {}
    for i, augment in enumerate((False, True)):
        exp = os.path.join(root, f"augment{i}")
        torch.cuda.synchronize()
        reset_launches()
        recorder, built, feeders = run_cli_feeders(_cli_args(
            "configs", "lid_supervised", _langs_override(corpus), f"exp_dir={exp}",
            "trainer.progress_bar=false", f"trainer.train_data_factor={FLAGSHIP_DATA_FACTOR}",
            f"trainer.total_epoch={AUGMENT_EPOCHS}", *([AUGMENT_CONF] if augment else [])))
        per_step, per_eval = _per_step(recorder)
        kind = "augment" if augment else "plain"
        (train, train_feeder, assembled), (eval_train, eval_feeder, _) = feeders
        calls = [aug.calls for aug in built]
        runs.append({"kind": kind, "epoch_steps": [e["steps"] for e in recorder.epochs],
                     "augmentor_calls": calls, "train_batches_assembled": assembled,
                     "launches_per_train_step": per_step, "launches_per_eval_batch": per_eval})
        checks[f"{i}_{kind}_steps"] = ([e["steps"] for e in recorder.epochs]
                                       == [FLAGSHIP_STEPS] * AUGMENT_EPOCHS)
        checks[f"{i}_{kind}_launches"] = (per_step == TRAIN_STEP_LAUNCHES
                                          and per_eval == PER_FORWARD_LAUNCHES)
        checks[f"{i}_{kind}_feeders"] = train and not eval_train and eval_feeder.augmentor is None
        if augment:
            checks[f"{i}_augmentor"] = (len(built) == 1 and train_feeder.augmentor is built[0]
                                        and calls[0] == assembled
                                        and assembled >= FLAGSHIP_STEPS * AUGMENT_EPOCHS)
        else:
            checks[f"{i}_no_augmentor"] = not built and train_feeder.augmentor is None
    card = augmentor_card_vs_cpu()
    checks.update({f"augmentor_{k}": v for k, v in card.pop("checks").items()})
    report = {"phase": "cli_augment", "order": [r["kind"] for r in runs], "runs": runs,
              "augmentor_card_vs_cpu": card, "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"cli_augment failed: {checks}")
    return report


# CUgraphNodeType: the nodes that run work on the card
_GRAPH_DEVICE_NODES = {0: "kernel", 1: "memcpy", 2: "memset"}


class _KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _cu(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} returned CUresult {rc}")


def _graph_device_work(fn) -> list:
    """The device work one ``fn()`` enqueues, in the order it runs: one
    entry a kernel (its mangled name), memcpy or memset, read from the nodes
    of a CUDA graph captured around the call (after one warm-up call on the
    capture's side stream).  A capture records every launch on its stream
    and nothing else, where a ``torch.profiler`` trace late in a long
    process can drop kernel records."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes, handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _cu(cu.cuGraphGetNodes, handle, nodes, ctypes.byref(n))
    e = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetEdges, handle, None, None, ctypes.byref(e))
    src, dst = (ctypes.c_void_p * e.value)(), (ctypes.c_void_p * e.value)()
    if e.value:  # libcuda refuses arrays for a graph of no edges
        _cu(cu.cuGraphGetEdges, handle, src, dst, ctypes.byref(e))
    index = {node: i for i, node in enumerate(nodes)}
    preds = [0] * n.value
    succs = [[] for _ in range(n.value)]
    for a, b in zip(src, dst):
        succs[index[a]].append(index[b])
        preds[index[b]] += 1
    ready, order = [i for i in range(n.value) if not preds[i]], []
    while ready:  # one stream's capture is a chain; this reads its order
        i = ready.pop(0)
        order.append(i)
        for j in succs[i]:
            preds[j] -= 1
            if not preds[j]:
                ready.append(j)
    work = []
    for i in order:
        kind = ctypes.c_int(-1)
        _cu(cu.cuGraphNodeGetType, ctypes.c_void_p(nodes[i]), ctypes.byref(kind))
        if kind.value not in _GRAPH_DEVICE_NODES:
            continue
        if kind.value:
            work.append(_GRAPH_DEVICE_NODES[kind.value])
            continue
        params = _KernelNodeParams()
        _cu(cu.cuGraphKernelNodeGetParams_v2, ctypes.c_void_p(nodes[i]), ctypes.byref(params))
        name = ctypes.c_char_p()
        if params.func:
            _cu(cu.cuFuncGetName, ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            _cu(cu.cuKernelGetName, ctypes.byref(name), ctypes.c_void_p(params.kern))
        work.append(name.value.decode())
    del graph
    return work


def _backward_kernels(fn, leaves, g, what: str) -> dict:
    """One backward of ``fn()``, read from a CUDA graph of the forward and
    its backward less the forward's own: two device kernels (dX, dW/db) and
    nothing else."""
    forward = _graph_device_work(fn)
    both = _graph_device_work(lambda: torch.autograd.grad(fn(), leaves, g))
    backward = both[len(forward):]
    report = {"device_kernels": len(backward), "expected": 2, "kernel_names": backward,
              "forward": forward, "counted_by": "cuda_graph_capture"}
    if both[:len(forward)] != forward or len(backward) != 2:
        raise AssertionError(f"one {what} backward ran {report}")
    return report


def backward_device_kernels(gen: torch.Generator) -> dict:
    """One backward of each autograd Function at the train shape: the plain
    conv's (``DepthwiseConv1dFn``) and the conv module's training op
    (``GluDepthwiseFn``: dh with the GLU backward, dW/db on the saved u)."""
    b, t, c, k = TRAIN_DW_SHAPE
    leaves = [torch.randn(*shape, generator=gen).cuda().requires_grad_(True)
              for shape in ((b, t, c), (k, c), (c,))]
    g = torch.randn(b, t, c, generator=gen).cuda()
    h, mask, w, bias, _, gy = fused_inputs(b, t, c, k, gen)
    fused = [v.requires_grad_(True) for v in (h, w, bias)]
    return {"shape": [b, t, c], "k": k,
            "depthwise_conv1d": _backward_kernels(lambda: depthwise_conv1d(*leaves), leaves, g,
                                                  "depthwise"),
            "glu_depthwise": _backward_kernels(
                lambda: glu_depthwise(fused[0], mask, fused[1], fused[2]), fused, gy,
                "glu_depthwise")}


def glu_mask_chain(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The GLU and padding mask as the conv module ran them before the
    fusion, in PyTorch."""
    a, g = h.chunk(2, dim=-1)
    return (a * torch.sigmoid(g)).masked_fill(~mask[:, :, None], 0.0)


def conv_module_device_kernels(task: LidASRTask, gen: torch.Generator) -> dict:
    """One eval ``ConformerConvModule.forward`` of the flagship's first
    block with a ragged mask at the served shape, and its two pointwise
    GEMMs (with the LayerNorm in front) alone, each read from a CUDA graph
    capture (:func:`_graph_device_work`): exactly one
    device kernel, the depthwise kernel, runs between them.  Also counts the
    device kernels of the unfused chain that ran there before (GLU and mask,
    the plain-mode kernel, BatchNorm and act in PyTorch)."""
    conv = task.model.featurizer.blocks[0].conv
    b, t = SERVE_DW_SHAPE[:2]
    x = torch.randn(b, t, FLAGSHIP["encoder_dim"], generator=gen).cuda()
    mask = (torch.arange(t) < t - 9)[None].cuda()
    conv.eval()
    with torch.no_grad():
        whole = _graph_device_work(lambda: conv(x, mask))
        front = _graph_device_work(lambda: conv.pointwise_in(conv.norm(x)))
        y = torch.randn(b, t, conv.pointwise_out.in_features, generator=gen).cuda()
        back = _graph_device_work(lambda: conv.pointwise_out(y))
        h = conv.pointwise_in(conv.norm(x))
        w, bias = conv.depthwise.weight, conv.depthwise.bias
        chain = _graph_device_work(lambda: batch_norm_act_plain(
            depthwise_conv1d(glu_mask_chain(h, mask), w, bias), conv.bn.eval_stats(),
            conv.act_name))
    n_front, n_back = len(front), len(back)
    between = whole[n_front:len(whole) - n_back]
    report = {"shape": [b, t, FLAGSHIP["encoder_dim"]], "device_kernels": len(whole),
              "before": n_front, "after": n_back, "between": between,
              "sequence": whole, "expected_between": 1,
              "unfused_chain_device_kernels": len(chain), "unfused_chain": chain,
              "counted_by": "cuda_graph_capture"}
    ok = (len(whole) == n_front + 1 + n_back and len(between) == 1
          and "depthwise" in between[0]
          and whole[:n_front] == front and whole[len(whole) - n_back:] == back)
    if not ok:
        raise AssertionError(f"an eval conv module runs {report}")
    return report


# phase_conv_fused's error keys by dtype: "<mode>", "<mode>_bf16", "<mode>_f16"
ERR_KEYS = {torch.float32: "", torch.bfloat16: "_bf16", torch.float16: "_f16"}
CONFORMER_EVAL_ROWS = (("depthwise_conv1d_fwd[glu_bn_act]", SERVE_DW_SHAPE),
                       ("depthwise_conv1d_fwd[glu_bn_act]@b32", SCORE_DW_SHAPE),
                       ("depthwise_conv1d_fwd[glu_bn_act]@eval", EVAL_DW_SHAPE))


def fused_kernel_rows(gen: torch.Generator, errs: dict, counts: dict,
                      eval_rows=CONFORMER_EVAL_ROWS, train_shape=TRAIN_DW_SHAPE,
                      train_suffix: str = "@train", dtype: torch.dtype = torch.float32) -> list:
    """The ``kernels`` line's rows of the fused modes where a path calls
    them: eval at the ``eval_rows`` shapes (by default the served, the
    scored and the eval CLI's), the training forward and dX with the GLU
    backward at ``train_shape``.  Each is timed against the
    unfused chain the conv module ran before (PyTorch GLU and mask, the
    plain-mode kernel, PyTorch BatchNorm and act) in turns chain, fused,
    fused, chain; against its plain version; and against a composite of
    library calls.  ``counts`` holds each row's launches on its path.  In
    ``dtype`` bfloat16 h, the output, u, the gradients, the weights and
    the bias are bfloat16 (2 bytes in the bounds), BatchNorm's statistics
    float32, and the error is against the bfloat16 plain version."""
    rows = []
    size = torch.finfo(dtype).bits // 8  # bytes of an activation, a weight
    err_key = ERR_KEYS[dtype]
    type_name = str(dtype).replace("torch.", "")

    def inputs(shape):
        h, mask, w, bias, bn, gy = fused_inputs(*shape, gen)
        return (h.to(dtype), mask, w.to(dtype), bias.to(dtype), bn, gy.to(dtype))

    def row(name, mode, shape, fused, chain, plain, library, library_call, n_bytes, flops,
            what):
        b, t, c, k = shape
        with torch.no_grad():
            lib_err = (library().float() - fused().float()).abs().max().item()
            chain_ms, k_ms = device_ms_in_turns(chain, fused)
            b_ms, b_by = bound_ms(n_bytes, flops)
            return {
                "name": name, "route": "cuda", "source": "speechlid_tpu_torch/csrc/depthwise.cu",
                "replaces": "speechlid_tpu/ops/pallas/depthwise_kernel.py:122",
                "mode": mode, "launches": counts[name][0], **counts[name][1],
                "max_abs_err": errs[shape][mode + err_key], "ms": k_ms, "kernel_ms": k_ms,
                "chain_ms": chain_ms, "plain_ms": device_ms(plain),
                "library_ms": device_ms(library), "library_call": library_call,
                "library_max_abs_err": lib_err,
                "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
                "shape": f"h ({b}, {t}, {2 * c}) {type_name}, mask ({b}, {t}), w ({k}, {c}): "
                         f"{what}",
                "blocks": fwd_blocks(b, t, c), "flops": flops, "bytes": n_bytes,
            }

    def conv_library(u, w, bias, k):  # F.conv1d(groups=C) on the (B, C, T) view
        c = w.shape[1]
        return F.conv1d(u.transpose(1, 2), w.t().unsqueeze(1), bias, padding=(k - 1) // 2,
                        groups=c)

    for name, shape in eval_rows:
        b, t, c, k = shape
        h, mask, w, bias, bn, _ = inputs(shape)

        def library():  # row() calls it in this iteration
            u = F.glu(h, dim=-1).masked_fill(~mask[:, :, None], 0.0)
            y = F.batch_norm(conv_library(u, w, bias, k), bn.mean, bn.var, bn.weight, bn.bias,
                             training=False, eps=bn.eps)
            return F.silu(y).transpose(1, 2)

        rows.append(row(
            name, "glu_bn_act", shape,
            lambda: glu_depthwise_bn_act(h, mask, w, bias, bn, "swish"),
            lambda: batch_norm_act_plain(depthwise_conv1d(glu_mask_chain(h, mask), w, bias), bn,
                                         "swish"),
            lambda: glu_depthwise_bn_act_plain(h, mask, w, bias, bn, "swish"),
            library, "composite: F.glu -> masked_fill -> F.conv1d(groups=C) -> "
                     "F.batch_norm(eval) -> F.silu",
            # read h and the mask, write y; weights, bias and BatchNorm's four (C,) rows
            size * (3 * b * t * c + k * c + c) + b * t + 4.0 * 4 * c,
            # 2k per output for the taps, about 12 for GLU, BatchNorm and Swish
            b * t * c * (2.0 * k + 12), "eval GLU + mask + conv + BN + Swish"))

    b, t, c, k = train_shape
    h, mask, w, bias, _, gy = inputs(train_shape)
    rows.append(row(
        "depthwise_conv1d_fwd[glu]" + train_suffix, "glu", train_shape,
        lambda: glu_depthwise(h, mask, w, bias),
        lambda: depthwise_conv1d(glu_mask_chain(h, mask), w, bias),
        lambda: glu_depthwise_plain(h, mask, w, bias)[1],
        lambda: conv_library(F.glu(h, dim=-1).masked_fill(~mask[:, :, None], 0.0), w, bias,
                             k).transpose(1, 2),
        "composite: F.glu -> masked_fill -> F.conv1d(groups=C)",
        # read h and the mask, write u and y
        size * (4 * b * t * c + k * c + c) + b * t, b * t * c * (2.0 * k + 4),
        "training GLU + mask + conv + bias, u written"))

    keep = ~mask[:, :, None]
    a, g = h.chunk(2, dim=-1)
    s = torch.sigmoid(g)  # saved by the parent's forward

    def dx_chain():  # the parent's backward of GLU and mask behind the dX launch
        du = depthwise_conv1d_dx(gy, w).masked_fill(keep, 0.0)
        return torch.cat([du * s, torch.ops.aten.sigmoid_backward(du * a, s)], dim=-1)

    def dx_library():
        du = torch.nn.grad.conv1d_input((b, c, t), w.t().unsqueeze(1).contiguous(),
                                        gy.transpose(1, 2), padding=(k - 1) // 2, groups=c)
        return torch.ops.aten.glu_backward(du.transpose(1, 2).masked_fill(keep, 0.0), h, -1)

    rows.append(row(
        "depthwise_conv1d_fwd[glu_dx]" + train_suffix, "glu_dx", train_shape,
        lambda: glu_depthwise_dx(gy, w, h, mask), dx_chain,
        lambda: glu_mask_bwd_plain(
            depthwise_conv1d_plain(gy, w, None, k - 1 - (k - 1) // 2, flip=True), h, mask),
        dx_library, "composite: torch.nn.grad.conv1d_input(groups=C) -> masked_fill -> "
                    "aten.glu_backward",
        # read the output gradient, h and the mask, write dh
        size * (5 * b * t * c + k * c) + b * t, b * t * c * (2.0 * k + 8),
        "dX (flipped taps) + GLU backward, dh written"))
    return rows


def fbank_row(name: str, shape_key: str, gen: torch.Generator, errs: dict, count: int,
              extra: dict) -> dict:
    """The ``kernels`` line's row of the fbank kernel at ``FBANK_SHAPES[shape_key]``:
    its error against plain there (``errs["fbank"]``, from :func:`phase_fbank`),
    kernel, plain and ``torch.stft`` composite times, its bound, and ``count``
    launches on the path it names (``extra``)."""
    n_fft, win, hop, n_mels = 512, 400, 160, 80
    bins = n_fft // 2 + 1
    window = torch.hann_window(win, device="cuda")
    fb = frontend.mel_bases(n_fft, win, n_mels, SR, "cuda")[1]
    nb, nt = FBANK_SHAPES[shape_key]
    wav = _wav(nb, nt, gen)
    n_frames = 1 + nt // hop

    def stft_composite():  # one torch.stft plus the mel projection and log
        spec = torch.stft(wav, n_fft, hop, win, window, center=True, pad_mode="reflect",
                          return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2  # (B, bins, F)
        return 10.0 * torch.log10(
            (power.transpose(1, 2) @ fb).clamp_min(1e-10)).transpose(1, 2)

    lib_err = (stft_composite() - log_mel(wav)).abs().max().item()
    flops = nb * (2.0 * n_frames * win * 2 * bins + 2.0 * n_frames * bins * n_mels)
    n_bytes = 4.0 * (wav.numel() + win * 2 * bins + bins * n_mels + nb * n_frames * n_mels)
    b_ms, b_by = bound_ms(n_bytes, flops)
    k_ms = device_ms(lambda: log_mel(wav))
    return {
        "name": name, "route": "cuda",
        "source": "speechlid_tpu_torch/csrc/fbank.cu",
        "replaces": "speechlid_tpu/ops/pallas/fbank_kernel.py:87",
        "launches": count, **extra,
        "max_abs_err": errs["fbank"][shape_key], "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": device_ms(lambda: log_mel_plain(wav)),
        "library_ms": device_ms(stft_composite),
        "library_call": "composite: torch.stft -> |.|^2 -> @ mel fb -> 10 log10",
        "library_max_abs_err_db": lib_err,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "shape": f"wav ({nb}, {nt}) f32 -> ({nb}, {n_mels}, {n_frames})",
        "flops": flops, "bytes": n_bytes,
        "ms_includes": "the wrapper call: one cluster kernel, no pad kernel",
    }


INFER_CALLS = 10  # forwards a launch count is taken over


def counted_calls(fn, calls: int) -> dict:
    """:func:`launches` over ``calls`` calls of ``fn``."""
    reset_launches()
    for _ in range(calls):
        fn()
    return launches()


def infer_launches(task: LidASRTask, gen: torch.Generator, per_forward: dict,
                   what: str) -> dict:
    """The launches of ``INFER_CALLS`` calls of ``task``'s ``infer`` on 3 s
    clips at B = 1 and at B = 32, each held to ``per_forward`` a call;
    → {"b1": …, "b32": …}."""
    infer, out = task.infer_fn(), {}
    for batch in (1, 32):
        wavs = 0.1 * torch.randn(batch, 3 * SR, generator=gen)
        out[f"b{batch}"] = counted = counted_calls(
            lambda: infer(wavs, torch.full((batch,), 3 * SR)), INFER_CALLS)
        if counted != {k: n * INFER_CALLS for k, n in per_forward.items()}:
            raise AssertionError(f"{what} infer at B = {batch}: launches {counted}")
    return out


def train_launches(trainer: Trainer, batches: list, steps: int, per_step: dict,
                   what: str) -> dict:
    """The launches of ``steps`` train steps of ``trainer`` on ``batches`` in
    turn, held to ``per_step`` a step, with finite losses."""
    losses = []
    counted = counted_calls(lambda: losses.append(float(
        trainer.train_step(batches[len(losses) % len(batches)])["loss"])), steps)
    if counted != {k: n * steps for k, n in per_step.items()} or not np.isfinite(losses).all():
        raise AssertionError(f"{what} train step: launches {counted}, losses {losses}")
    return counted


def flagship_kernel_rows(task: LidASRTask, gen: torch.Generator, errs: dict, served: dict,
                         serve_report: dict, trained: dict, training, cli: dict,
                         cli_eval: dict) -> list:
    """Kernel, plain and library times at the main paths' shapes (serving:
    B = 1, 3 s clip; training: B = 8, 4 s clips; the eval CLI: B = 8, 2 s
    clips) and their bounds, with the launches of a train step and of
    ``INFER_CALLS`` forwards at B = 1 and B = 32 checked; then one backward
    of each depthwise autograd Function and one eval conv module, read from
    CUDA graph captures.  ``cli`` holds the launches of the CLI flagship
    phase, which each row also reports (``launches_cli``) for the counter it
    counts, and ``cli_eval`` the report of ``cli_eval_flagship``, whose
    sweep's launches the ``@eval`` rows count.  Returns the rows of the
    ``kernels`` line."""
    n_req = serve_report["requests"]
    n_steps = TRAIN_EPOCHS * TRAIN_BATCHES
    kernels = []

    # training: a step at B = 8, 4 s clips, its launches and the shape its
    # encoder convs see
    trainer, train_batches = training
    seen = []
    conv = trainer.module.model.featurizer.blocks[0].conv
    k_conv = conv.depthwise.weight.shape[0]
    hook = conv.pointwise_in.register_forward_hook(  # h (B, T, 2C) into the fused call
        lambda mod, args, out: seen.append((*out.shape[:2], out.shape[2] // 2, k_conv)))
    train_launches(trainer, train_batches, len(train_batches), TRAIN_STEP_LAUNCHES, "flagship")
    hook.remove()
    if set(seen) != {TRAIN_DW_SHAPE}:
        raise AssertionError(f"train step: encoder conv shapes {set(seen)}")
    b32 = infer_launches(task, gen, PER_FORWARD_LAUNCHES, "flagship")["b32"]

    # kernel 1: fbank where the paths call it: a served 3 s clip, a train
    # batch of 8 × 4 s, a scored batch of 32 × 3 s
    def fbank_entry(name, shape_key, count, extra):
        return fbank_row(name, shape_key, gen, errs, count, extra)

    kernels.append(fbank_entry("fbank_log_mel", "serve", served["fbank"], {
        "launches_per_request": served["fbank"] / n_req,
        "launches_train_path": trained["fbank"],
        "launches_per_train_step": trained["fbank"] / n_steps}))
    kernels.append(fbank_entry("fbank_log_mel@train", "train", trained["fbank"], {
        "launches_per_train_step": trained["fbank"] / n_steps,
        "launches_counted_on": "the train steps of Trainer.fit"}))
    kernels.append(fbank_entry("fbank_log_mel@b32", "b32", b32["fbank"], {
        "launches_per_batch": b32["fbank"] / INFER_CALLS,
        "launches_counted_on": "the counted infer calls at B = 32 on 3 s clips"}))
    eval_counted_on = (f"the eval CLI's --sweep on the flagship checkpoint: {EVAL_CELLS} "
                       f"cells x {EVAL_BATCHES} batches")
    eval_launches = cli_eval["sweep_launches"]
    kernels.append(fbank_entry("fbank_log_mel@eval", "eval", eval_launches["fbank"], {
        "launches_per_eval_batch": cli_eval["sweep_launches_per_batch"]["fbank"],
        "launches_counted_on": eval_counted_on}))

    # kernel 2: depthwise at the encoder's 3 s shape (1, 74, 288), k = 31
    b, t, c, k = SERVE_DW_SHAPE
    x = torch.randn(b, t, c, generator=gen).cuda()
    w = (k ** -0.5 * torch.randn(k, c, generator=gen)).cuda()
    bias = (0.05 * torch.randn(c, generator=gen)).cuda()
    w_conv = w.t().unsqueeze(1).contiguous()  # (C, 1, k) for F.conv1d

    def conv1d_library(inp):
        return F.conv1d(inp.transpose(1, 2), w_conv, bias, padding=(k - 1) // 2,
                        groups=c).transpose(1, 2)

    # Every launch on the paths is in a fused mode (their rows follow); the
    # plain-mode rows count this kernel's launches on their path in any
    # mode, and in plain mode apart
    train_fwd = trained["depthwise"] - trained["depthwise_dx"]
    fwd_rates = {"launches_are": "this kernel's, any mode",
                 "launches_per_request": served["depthwise"] / n_req,
                 "launches_per_train_step": train_fwd / n_steps,
                 "launches_in_this_mode": {"serve": served["depthwise_plain"],
                                           "train": trained["depthwise_plain"]}}

    def depthwise_entry(name, shape, count, inp, err):
        """The forward kernel's plain-mode entry at ``inp``'s shape;
        ``count`` is its launches on the main path that has this shape."""
        nb, nt = inp.shape[:2]
        flops = 2.0 * nb * nt * c * k
        n_bytes = 4.0 * (2 * nb * nt * c + k * c + c)
        b_ms, b_by = bound_ms(n_bytes, flops)
        lib_err = (conv1d_library(inp) - depthwise_conv1d(inp, w, bias)).abs().max().item()
        k_ms = device_ms(lambda: depthwise_conv1d(inp, w, bias))
        return {
            "name": name, "route": "cuda",
            "source": "speechlid_tpu_torch/csrc/depthwise.cu",
            "replaces": "speechlid_tpu/ops/pallas/depthwise_kernel.py:122",
            "launches": count, **fwd_rates,
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": device_ms(lambda: depthwise_conv1d_plain(inp, w, bias)),
            "library_ms": device_ms(lambda: conv1d_library(inp)),
            "library_call": "F.conv1d(groups=C) on the (B, C, T) view",
            "library_max_abs_err": lib_err,
            "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
            "shape": shape, "flops": flops, "bytes": n_bytes,
        }

    kernels.append(depthwise_entry(
        "depthwise_conv1d_fwd", "x (1, 74, 288) f32, w (31, 288)", served["depthwise"], x,
        errs["depthwise"][SERVE_DW_SHAPE]))

    # the same kernel at the train step's encoder shape (8, 99, 288): the
    # forward, and dX as the backward calls it (flipped taps, zero bias)
    tb, tt = TRAIN_DW_SHAPE[:2]
    xt = torch.randn(tb, tt, c, generator=gen).cuda()
    gt = (torch.randn(tb, tt, c, generator=gen) / (tb * tt) ** 0.5).cuda()
    pad_dx = k - 1 - (k - 1) // 2
    kernels.append(depthwise_entry(
        "depthwise_conv1d_fwd@train", "x (8, 99, 288) f32, w (31, 288)", train_fwd, xt,
        errs["depthwise"][TRAIN_DW_SHAPE]))

    def conv1d_input_library():
        return torch.nn.grad.conv1d_input((tb, c, tt), w_conv, gt.transpose(1, 2),
                                          padding=(k - 1) // 2, groups=c).transpose(1, 2)

    dx_lib_err = (conv1d_input_library() - depthwise_conv1d_dx(gt, w)).abs().max().item()
    flops = 2.0 * tb * tt * c * k
    n_bytes = 4.0 * (2 * tb * tt * c + k * c + c)
    b_ms, b_by = bound_ms(n_bytes, flops)
    k_ms = device_ms(lambda: depthwise_conv1d_dx(gt, w))
    kernels.append({
        "name": "depthwise_conv1d_dx", "route": "cuda",
        "source": "speechlid_tpu_torch/csrc/depthwise.cu",
        "replaces": "speechlid_tpu/ops/pallas/depthwise_kernel.py:77",
        "launches": trained["depthwise_dx"], "launches_are": "this kernel's flipped, any mode",
        "launches_per_train_step": trained["depthwise_dx"] / n_steps,
        "launches_per_request": served["depthwise_dx"] / n_req,
        "launches_in_this_mode": {"serve": served["depthwise_plain_dx"],
                                  "train": trained["depthwise_plain_dx"]},
        "max_abs_err": errs["depthwise_bwd"][TRAIN_DW_SHAPE]["dx"],
        "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": device_ms(lambda: depthwise_conv1d_plain(gt, w, None, pad_dx, flip=True)),
        "library_ms": device_ms(conv1d_input_library),
        "library_call": "torch.nn.grad.conv1d_input(groups=C) on the (B, C, T) view",
        "library_max_abs_err": dx_lib_err,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "shape": "g (8, 99, 288) f32, w (31, 288) read flipped, no bias",
        "flops": flops, "bytes": n_bytes,
        "ms_includes": "the wrapper call DepthwiseConv1dFn's backward makes",
    })

    # kernel 3: the weight/bias gradient at the train step's encoder shape
    x_conv, g_conv = xt.transpose(1, 2), gt.transpose(1, 2)

    def conv1d_weight_library():
        dw = torch.nn.grad.conv1d_weight(x_conv, (c, 1, k), g_conv, padding=(k - 1) // 2,
                                         groups=c)
        return dw[:, 0, :].t(), gt.sum(dim=(0, 1))

    got_dw, got_db = depthwise_conv1d_bwd_w(xt, gt, k)
    lib_dw, lib_db = conv1d_weight_library()
    lib_err = max((got_dw - lib_dw).abs().max().item(), (got_db - lib_db).abs().max().item())
    n_bytes = 4.0 * 2 * tb * tt * c  # x and g read once; the (k+1, C) result is 0.5 % of that
    b_ms, b_by = bound_ms(n_bytes, flops)
    k_ms = device_ms(lambda: depthwise_conv1d_bwd_w(xt, gt, k))
    lb, lt, lc, _ = LARGE_BWD_W_SHAPE
    xl = torch.randn(lb, lt, lc, generator=gen).cuda()
    gl = torch.randn(lb, lt, lc, generator=gen).cuda()
    xl_conv, gl_conv = xl.transpose(1, 2), gl.transpose(1, 2)

    def conv1d_weight_library_large():
        dw = torch.nn.grad.conv1d_weight(xl_conv, (lc, 1, k), gl_conv, padding=(k - 1) // 2,
                                         groups=lc)
        return dw[:, 0, :].t(), gl.sum(dim=(0, 1))

    large_ms = device_ms(lambda: depthwise_conv1d_bwd_w(xl, gl, k))
    kernels.append({
        "name": "depthwise_conv1d_bwd_w", "route": "cuda",
        "source": "speechlid_tpu_torch/csrc/depthwise.cu",
        "replaces": "speechlid_tpu/ops/pallas/depthwise_kernel.py:78",
        "launches": trained["depthwise_bwd_w"],
        "launches_per_train_step": trained["depthwise_bwd_w"] / n_steps,
        "launches_per_request": served["depthwise_bwd_w"] / n_req,
        "max_abs_err": errs["depthwise_bwd"][TRAIN_DW_SHAPE]["bwd_w"],
        "ms": k_ms, "kernel_ms": k_ms,
        "ms_at_32x300x288": large_ms,
        "plain_ms_at_32x300x288": device_ms(lambda: depthwise_conv1d_bwd_w_plain(xl, gl, k)),
        "library_ms_at_32x300x288": device_ms(conv1d_weight_library_large),
        "bound_ms_at_32x300x288": bound_ms(4.0 * 2 * xl.numel(), 2.0 * xl.numel() * k)[0],
        "plain_ms": device_ms(lambda: depthwise_conv1d_bwd_w_plain(xt, gt, k)),
        "library_ms": device_ms(conv1d_weight_library),
        "library_call": "torch.nn.grad.conv1d_weight(groups=C) + g.sum((0, 1))",
        "library_max_abs_err": lib_err,
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "shape": "x, g (8, 99, 288) f32 -> dw (31, 288), db (288,)",
        "flops": flops, "bytes": n_bytes,
        "ms_includes": "the wrapper call: one cluster kernel, no scratch",
    })

    # the fused modes where the paths call them, with their launches there
    kernels.extend(fused_kernel_rows(gen, errs["conv_fused"], {
        "depthwise_conv1d_fwd[glu_bn_act]": (served["depthwise_glu_bn_act"], {
            "launches_per_request": served["depthwise_glu_bn_act"] / n_req}),
        "depthwise_conv1d_fwd[glu_bn_act]@b32": (b32["depthwise_glu_bn_act"], {
            "launches_per_batch": b32["depthwise_glu_bn_act"] / INFER_CALLS,
            "launches_counted_on": "the counted infer calls at B = 32 on 3 s clips"}),
        "depthwise_conv1d_fwd[glu_bn_act]@eval": (eval_launches["depthwise_glu_bn_act"], {
            "launches_per_eval_batch":
                cli_eval["sweep_launches_per_batch"]["depthwise_glu_bn_act"],
            "launches_counted_on": eval_counted_on}),
        "depthwise_conv1d_fwd[glu]@train": (trained["depthwise_glu"], {
            "launches_per_train_step": trained["depthwise_glu"] / n_steps}),
        "depthwise_conv1d_fwd[glu_dx]@train": (trained["depthwise_glu_dx"], {
            "launches_per_train_step": trained["depthwise_glu_dx"] / n_steps}),
    }))
    def counted(name: str, counts: dict):
        """The count of ``counts`` (:func:`launches`) for a row's kernel."""
        if name.startswith("fbank_log_mel"):
            return counts["fbank"]
        if name.startswith("depthwise_conv1d_fwd["):
            return counts["depthwise_" + name[len("depthwise_conv1d_fwd["):].split("]")[0]]
        if name.startswith("depthwise_conv1d_fwd"):  # the kernel's launches in any mode
            return counts["depthwise"] - counts["depthwise_dx"]
        return counts[name.replace("_conv1d", "")]

    for entry in kernels:
        name = entry["name"]
        entry["launches_cli"] = counted(name, cli)
        if not (entry["launches"] > 0 and entry["launches_cli"] > 0):
            raise AssertionError(f"{name} was not launched on its main path")

    emit({"phase": "device_kernels", "depthwise_backward": backward_device_kernels(gen),
          "conv_module_eval": conv_module_device_kernels(task, gen)})
    return kernels


# ------------------------------------------------ the WavLM-Base+ joint model


def init_wavlm_(task: LidASRTask, gen: torch.Generator) -> None:
    """The task's own fresh draw (flax's initializers) from a seed taken
    from ``gen``, then the heads' BatchNorm running statistics away from the
    identity (mean ≠ 0, var ≠ 1)."""
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    task.init_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for module in task.model.modules():
            if isinstance(module, MaskedBatchNorm):
                module.running_mean.copy_(0.2 * torch.randn(module.running_mean.shape,
                                                            generator=gen))
                module.running_var.copy_(0.5 + torch.rand(module.running_var.shape,
                                                          generator=gen))


def phase_wavlm_model(gen: torch.Generator) -> LidASRTask:
    """The full-width WavLM-Base+ joint model on the card against the same
    state_dict on the CPU, on a ragged batch of a 3 s and a 2 s clip:
    scores within 1e-3, ``pred_lang`` equal, and the launches of one
    forward (the fused eval conv in each head, no fbank)."""
    task = LidASRTask(**WAVLM, device="cuda")
    init_wavlm_(task, gen)
    cpu_task = LidASRTask(**WAVLM, device="cpu")
    cpu_task.model.load_state_dict(task.model.state_dict())
    wavs = 0.1 * torch.randn(2, 3 * SR, generator=gen)
    lengths = torch.tensor([3 * SR, 2 * SR])
    got, ref, per_forward, errs = infer_card_vs_cpu(task, cpu_task, wavs, lengths)
    neg = torch.finfo(torch.float32).min
    score_err = errs["max_abs_err_scores"]
    emit({
        "phase": "wavlm_model_card_vs_cpu",
        "config": "WavLM-Base+ 12x768 (gated rel-pos 320/800) + heads 3x(40,96,88) at 768",
        "batch": [2, 3 * SR], "lengths": lengths.tolist(),
        "params": sum(p.numel() for p in task.model.parameters()),
        "logits_shape": list(got["logits"].shape),
        "feat_lengths": got["feat_lengths"].tolist(), **errs,
        "scores": got["scores"].tolist(), "pred_lang": got["pred_lang"].tolist(),
        "pred_lang_cpu": ref["pred_lang"].tolist(), "tol": MODEL_TOL,
        "launches_per_forward": per_forward,
    })
    checks = {
        "finite": bool(torch.isfinite(got["logits"]).all() and torch.isfinite(got["scores"]).all()
                       and torch.isfinite(got["mlp_scores"]).all()),
        "feat_lengths": got["feat_lengths"].tolist() == [_wavlm_frames(3.0), _wavlm_frames(2.0)],
        "scores": score_err <= MODEL_TOL,
        "masked_slots": bool(torch.equal(got["logits"] == neg, ref["logits"] == neg)),
        "pred_lang": torch.equal(got["pred_lang"], ref["pred_lang"]),
        "launches": per_forward == WAVLM_PER_FORWARD_LAUNCHES,
    }
    if not all(checks.values()):
        raise AssertionError(f"the WavLM model on the card failed: {checks}")
    return task


def phase_wavlm_train_card_vs_cpu(gen: torch.Generator) -> None:
    """One deterministic full-width WavLM train step (no dropout, span
    masking or layer drop) at B = 2 on 2 s clips, on the card and on the
    CPU from the same state_dict: the loss within 1e-3 of its size, every
    gradient within 1e-3 of its largest entry, and the launches of the
    step.  Two leaves have a true gradient of zero, so both sides hold
    rounding noise there, held against the largest gradient instead: the
    heads' depthwise bias (a train-mode BatchNorm follows) and ``k_proj``'s
    bias (the softmax cancels it)."""
    card = LidASRTask(**WAVLM_DETERMINISTIC, device="cuda")
    cpu = LidASRTask(**WAVLM_DETERMINISTIC, device="cpu")
    init_wavlm_(card, gen)
    cpu.model.load_state_dict(card.model.state_dict())
    batch = synthetic_batch(np.random.RandomState(2), lang=1, b=2, seconds=2.0)
    step = step_card_vs_cpu(card, cpu, batch, ("depthwise.bias", "k_proj.bias"))
    emit({"phase": "wavlm_train_card_vs_cpu", "batch": [2, 2 * SR], "tol": TRAIN_TOL, **step})
    ok = (step["same_leaves"] and step["rel_err_loss"] <= TRAIN_TOL
          and step["max_rel_err_gradient"] <= TRAIN_TOL
          and step["launches_per_train_step"] == WAVLM_TRAIN_STEP_LAUNCHES)
    if not ok:
        raise AssertionError("the WavLM train step on the card disagrees with the CPU")


# lid_wavlm.yaml's batches of 4 give 3 × 24 steps an epoch on the corpus; the
# factor cuts an epoch to 3 steps, and four epochs cross both freeze gates
WAVLM_DATA_FACTOR = 0.05
WAVLM_CLI_STEPS = int(N_LANG * CORPUS_TRAIN // 4 * WAVLM_DATA_FACTOR)
WAVLM_EVAL_BATCHES = N_LANG * CORPUS_VAL // 4


def ssl_config_override(conf: dict) -> str:
    """``module.ssl_config={…}``: the override that sets ``conf`` in the CLI."""
    def value(v):
        return str(v).lower() if isinstance(v, bool) else f'"{v}"' if isinstance(v, str) else v
    return "module.ssl_config={" + ", ".join(f"{k}: {value(v)}" for k, v in conf.items()) + "}"


WAVLM_SSL_OVERRIDE = ssl_config_override(WAVLM_BASE_PLUS)
# the parts of the SSL featurizer lid_wavlm.yaml's gates freeze by epoch
# (freeze_featurizer_epoch 1, freeze_transformer_epoch 0; lid_wavlm_bf16.yaml's too)
WAVLM_FROZEN = {0: {"feature_extractor", "post_extract_proj", "layers", "pos_conv",
                    "encoder_layer_norm"},
                1: {"feature_extractor", "post_extract_proj"}, 2: set(), 3: set()}
# cli_wavlm: lid_wavlm.yaml in float32
WAVLM_CLI = dict(name="cli_wavlm", config="lid_wavlm", ssl_override=WAVLM_SSL_OVERRIDE,
                 data_factor=WAVLM_DATA_FACTOR, steps=WAVLM_CLI_STEPS,
                 eval_batches=WAVLM_EVAL_BATCHES, shape=WAVLM_CLI_DW_SHAPE,
                 per_step=WAVLM_TRAIN_STEP_LAUNCHES, per_eval=WAVLM_PER_FORWARD_LAUNCHES)
# cli_wavlm_bf16: lid_wavlm_bf16.yaml (module.dtype bfloat16, batches of 8, so
# 3 × 12 steps an epoch, cut to 3) with the Base+ ssl_config and its dtype
# bfloat16: the config's module.dtype alone would leave the encoder float32
WAVLM_BF16_CLI = dict(
    name="cli_wavlm_bf16", config="lid_wavlm_bf16",
    ssl_override=ssl_config_override(dict(WAVLM_BASE_PLUS, dtype="bfloat16")),
    data_factor=0.1, steps=int(N_LANG * CORPUS_TRAIN // 8 * 0.1),
    eval_batches=N_LANG * CORPUS_VAL // 8, shape=WAVLM_BF16_CLI_DW_SHAPE,
    per_step=WAVLM_BF16_TRAIN_STEP_LAUNCHES, per_eval=WAVLM_BF16_PER_FORWARD_LAUNCHES,
    resume=False)  # cli_wavlm holds the resume


def phase_cli_wavlm(root: str, corpus: str, smi: str, run: dict = WAVLM_CLI) -> dict:
    """The training CLI on ``configs/lid_wavlm.yaml`` (``run``: or another
    WavLM config, with its steps, shapes and launches) with
    ``module.ssl_config`` set to the Base+ shape (``run["ssl_override"]``;
    none: the config's own), on the corpus: three epochs of 3 steps (span
    masking on; the config's gates freeze the extractor through epoch 1 and
    the transformer through epoch 0), then a resume for a fourth (unless
    ``run["resume"]`` is false), each epoch followed by an eval of the val
    clips; the frozen parts by epoch, the launches per train step and eval
    batch (and by channel count) and the conv shapes (``run["shape"]``, or
    ``run["train_shapes"]`` and ``run["eval_shape"]``); the checkpoint
    files after each run; one ``/lid`` answer from its checkpoint through
    ``build_lid_fn``; and ``cli.test_lid`` clean on ``last.ckpt`` (with
    ``run["test_best"]`` the best top-k file), whose ``acc`` must be the
    ``val_acc`` the training CLI logged at that checkpoint's epoch.  Launch
    counts are set to 0 just before each run and read just after; →
    their sums over the runs, by channel count under ``"widths"``."""
    from speechlid_tpu_torch.cli import main_lid
    from speechlid_tpu_torch.data.audio_io import read_wav

    exp = os.path.join(root, run["name"])
    base = [_langs_override(corpus), f"exp_dir={exp}", "trainer.progress_bar=false",
            *([f"trainer.train_data_factor={run['data_factor']}"] if "data_factor" in run else []),
            *([run["ssl_override"]] if run.get("ssl_override") else [])]
    last = os.path.join(exp, "ckpt", "last.ckpt")
    train_shapes = set(run.get("train_shapes", [run.get("shape")]))
    eval_shape = run.get("eval_shape", run.get("shape"))
    frozen, shapes = {}, set()
    build_task = main_lid.build_task

    def recording_build_task(conf, data, device="cuda"):
        task = build_task(conf, data, device)
        before = task.before_train_loop

        def record(epoch):
            before(epoch)
            frozen[epoch] = sorted({n.split(".")[2] for n, p in task.model.named_parameters()
                                    if not p.requires_grad})
        task.before_train_loop = record
        return task

    def conv_seen(module, args, output):
        if isinstance(module, ConformerConvModule):
            k, c = module.depthwise.weight.shape
            shapes.add((*args[0].shape[:2], c, k))

    runs, counted, widths, files = {}, {}, {}, {}
    main_lid.build_task = recording_build_task
    hook = torch.nn.modules.module.register_module_forward_hook(conv_seen)
    try:
        legs = [("fit", ["trainer.total_epoch=3"])]
        if run.get("resume", True):
            legs.append(("resume", ["trainer.total_epoch=4", f"trainer.resume_from={last}"]))
        for name, extra in legs:
            torch.cuda.synchronize()
            reset_launches()
            runs[name] = run_cli(_cli_args("configs", run["config"], *base, *extra))
            counted[name], widths[name] = launches(), width_launches()
            files[name] = sorted(os.listdir(os.path.dirname(last)))
    finally:
        main_lid.build_task = build_task
        hook.remove()
    lines = _metrics_lines(os.path.join(exp, "metrics.jsonl"))
    evals = [line for line in lines if CLI_EVAL_KEYS <= set(line)]
    ckpt = load_checkpoint(last)
    ckpt_meta, ckpt_hparams = ckpt["meta"], ckpt["hyper_parameters"]
    del ckpt
    tested, tested_epoch = last, ckpt_meta["epoch"]
    if run.get("test_best"):  # the top-k file of the lowest avg_val_loss, as its name holds it
        best = min((f for f in files[list(files)[-1]] if f.startswith("epoch_")),
                   key=lambda f: float(f[:-5].rsplit("_", 1)[1]))
        tested, tested_epoch = os.path.join(os.path.dirname(last), best), int(best.split("_")[1])
    lid_fn, index2lang = build_lid_fn(last)
    state = InferenceState(lid_fn, index2lang)
    wav, _ = read_wav(os.path.join(corpus, "bb", "wav", "train", "val0.wav"))
    reset_launches()
    answer = state.lid(wav)
    served = launches()
    del lid_fn, state
    clean, clean_launches, clean_shapes = run_test_lid(
        ["--ckpt", tested, *_cli_args("configs", run["config"], _langs_override(corpus),
                                      *([run["ssl_override"]] if run.get("ssl_override")
                                        else []))])
    report = {"phase": run["name"], "nvidia_smi": smi,
              "config": run.get("describe", f"configs/{run['config']}.yaml, "
                                            "module.ssl_config WavLM-Base+"),
              "dtype": ckpt_hparams["dtype"],
              "ssl_dtype": ckpt_hparams["ssl_config"].get("dtype", "float32"),
              "steps_per_epoch": run["steps"], "frozen_by_epoch": frozen, "runs": {},
              "launches": counted, "launches_by_width": widths, "evals": evals,
              "conv_shapes": sorted(shapes), "ckpt_files": files,
              "ckpt_meta": {k: ckpt_meta[k] for k in ("epoch", "global_step")},
              "test_lid_ckpt": os.path.basename(tested),
              "served_from_cli_ckpt": answer, "served_launches": served,
              "test_lid_clean": _cell(clean),
              "test_lid_launches_per_batch": {k: v / run["eval_batches"]
                                              for k, v in clean_launches.items()},
              "test_lid_conv_shapes": sorted(clean_shapes["glu_bn_act"])}
    checks = {}
    for name, recorder in runs.items():
        per_step, per_eval = _per_step(recorder)
        report["runs"][name] = {"epochs": recorder.epochs,
                                "eval_batches": [e["batches"] for e in recorder.evals],
                                "launches_per_train_step": per_step,
                                "launches_per_eval_batch": per_eval}
        checks[f"{name}_launches"] = (per_step == run["per_step"]
                                      and per_eval == run["per_eval"])
        checks[f"{name}_steps"] = all(e["steps"] == run["steps"] for e in recorder.epochs)
        checks[f"{name}_evals"] = [e["batches"] for e in recorder.evals] == \
            [run["eval_batches"]] * len(recorder.epochs)
    n_epochs = 3 + len(runs) - 1
    n_lang = run.get("n_lang", N_LANG)
    checks.update({
        "frozen": {e: set(v) for e, v in frozen.items()} == {
            e: v for e, v in WAVLM_FROZEN.items() if e < n_epochs},
        "conv_shapes": shapes == train_shapes | {eval_shape} and clean_shapes["glu_bn_act"] == {
            eval_shape} and not clean_shapes["fbank"],
        "eval_lines": len(evals) == n_epochs
        and all(np.isfinite(e["avg_val_loss"]) for e in evals),
        "ckpt": ckpt_meta["epoch"] == n_epochs - 1
        and ckpt_meta["global_step"] == n_epochs * run["steps"],
        "ckpt_files": all(f == "last.ckpt" or f.startswith("epoch_") for f in files["fit"])
        # last.ckpt and the top-k files (save_topk: 3 in every WavLM config)
        and len(files[list(files)[-1]]) == min(n_epochs, 3) + 1,
        "served": set(answer) == {"lang", "scores"} and len(answer["scores"]) == n_lang
        and all(np.isfinite(v) for v in answer["scores"].values())
        and served == run["per_eval"],
        "test_lid_acc": clean["acc"] == evals[tested_epoch]["val_acc"]
        and clean["n_utts"] == n_lang * run.get("val_per_lang", CORPUS_VAL),
        "test_lid_launches": report["test_lid_launches_per_batch"] == run["per_eval"],
    })
    report["checks"] = checks
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"CLI phase {run['name']} failed: {checks}")
    out = {k: sum(c[k] for c in counted.values()) for k in counted["fit"]}
    out["widths"] = {k: sum(w.get(k, 0) for w in widths.values())
                     for k in set().union(*widths.values())}
    return out


def _wavlm_batches(seed: int, n: int) -> list:
    rng = np.random.RandomState(seed)
    return [synthetic_batch(rng, i % N_LANG, WAVLM_TRAIN_B, WAVLM_TRAIN_SECONDS)
            for i in range(n)]


WAVLM_TRAIN_STEPS = 9  # train steps the WavLM rows' launches are counted over


def phase_wavlm_launches(task: LidASRTask, gen: torch.Generator) -> dict:
    """The launches of the WavLM joint model, checked: ``infer`` on 3 s
    clips at B = 1 and B = 32, and ``WAVLM_TRAIN_STEPS`` train steps at
    B = 8 on 4 s clips with dropout and span masking on.  The model's
    weights then train on: nothing after reads them."""
    out = infer_launches(task, gen, WAVLM_PER_FORWARD_LAUNCHES, "WavLM")
    task.init_parameters = lambda generator: None  # train on from these weights
    trainer = Trainer(total_epoch=1, use_progress_bar=False, seed=0)
    trainer.trainer_prepare(task)
    out["train"] = train_launches(trainer, _wavlm_batches(3, 3), WAVLM_TRAIN_STEPS,
                                  WAVLM_TRAIN_STEP_LAUNCHES, "WavLM")
    return out


def bwd_w_row(gen: torch.Generator, errs: dict, shape: tuple, name: str, counted: dict,
              n_steps: int, dtype: torch.dtype = torch.float32) -> dict:
    """The ``kernels`` line's row of ``depthwise_conv1d_bwd_w`` at a train
    step's ``shape`` in ``dtype``: the saved u and the output gradient,
    with the launches ``counted`` over ``n_steps`` steps of its path."""
    b, t, c, k = shape
    h, mask, _, _, _, gy = fused_inputs(b, t, c, k, gen)
    u, gy = glu_mask_chain(h, mask).contiguous().to(dtype), gy.to(dtype)

    def conv1d_weight_library():
        dw = torch.nn.grad.conv1d_weight(u.transpose(1, 2), (c, 1, k), gy.transpose(1, 2),
                                         padding=(k - 1) // 2, groups=c)
        return dw[:, 0, :].t(), gy.sum(dim=(0, 1))

    got_dw, got_db = depthwise_conv1d_bwd_w(u, gy, k)
    lib_dw, lib_db = conv1d_weight_library()
    size = torch.finfo(dtype).bits // 8
    flops, n_bytes = 2.0 * b * t * c * k, size * 2.0 * b * t * c
    b_ms, b_by = bound_ms(n_bytes, flops)
    k_ms = device_ms(lambda: depthwise_conv1d_bwd_w(u, gy, k))
    return {
        "name": name, "route": "cuda", "source": "speechlid_tpu_torch/csrc/depthwise.cu",
        "replaces": "speechlid_tpu/ops/pallas/depthwise_kernel.py:78",
        "launches": counted["depthwise_bwd_w"],
        "launches_per_train_step": counted["depthwise_bwd_w"] / n_steps,
        "max_abs_err": errs[shape]["bwd_w" + ERR_KEYS[dtype]],
        "ms": k_ms, "kernel_ms": k_ms,
        "plain_ms": device_ms(lambda: depthwise_conv1d_bwd_w_plain(u, gy, k)),
        "library_ms": device_ms(conv1d_weight_library),
        "library_call": "torch.nn.grad.conv1d_weight(groups=C) + g.sum((0, 1))",
        "library_max_abs_err": max((got_dw - lib_dw).abs().max().item(),
                                   (got_db - lib_db).abs().max().item()),
        "bound_ms": b_ms, "bound_us": b_ms * 1e3, "bound_by": b_by,
        "shape": f"u, g ({b}, {t}, {c}) {str(dtype).replace('torch.', '')} -> dw ({k}, {c}), "
                 f"db ({c},)",
        "flops": flops, "bytes": n_bytes,
    }


def wavlm_kernel_rows(gen: torch.Generator, errs: dict, counts: dict, serve_report: dict,
                      cli: dict) -> list:
    """The ``kernels`` line's rows of the depthwise kernel at the WavLM
    heads' shapes: eval at the served and the scored shape, the training
    forward, dX with the GLU backward and dW/db at the train step's, each
    with its launches on its path (``counts``: :func:`phase_wavlm_launches`)
    and on the CLI run."""
    n_req = serve_report["requests"]
    served = serve_report["launches"]
    n_steps = WAVLM_TRAIN_STEPS
    rows = fused_kernel_rows(gen, errs["conv_fused"], {
        "depthwise_conv1d_fwd[glu_bn_act]@wavlm": (served["depthwise_glu_bn_act"], {
            "launches_per_request": served["depthwise_glu_bn_act"] / n_req,
            "launches_counted_on": "the WavLM /lid requests"}),
        "depthwise_conv1d_fwd[glu_bn_act]@wavlm_b32": (counts["b32"]["depthwise_glu_bn_act"], {
            "launches_per_batch": counts["b32"]["depthwise_glu_bn_act"] / INFER_CALLS,
            "launches_counted_on": "the counted WavLM infer calls at B = 32 on 3 s clips"}),
        "depthwise_conv1d_fwd[glu]@wavlm_train": (counts["train"]["depthwise_glu"], {
            "launches_per_train_step": counts["train"]["depthwise_glu"] / n_steps}),
        "depthwise_conv1d_fwd[glu_dx]@wavlm_train": (counts["train"]["depthwise_glu_dx"], {
            "launches_per_train_step": counts["train"]["depthwise_glu_dx"] / n_steps}),
    }, eval_rows=(("depthwise_conv1d_fwd[glu_bn_act]@wavlm", WAVLM_SERVE_DW_SHAPE),
                  ("depthwise_conv1d_fwd[glu_bn_act]@wavlm_b32", WAVLM_SCORE_DW_SHAPE)),
        train_shape=WAVLM_TRAIN_DW_SHAPE, train_suffix="@wavlm_train")

    rows.append(bwd_w_row(gen, errs["conv_fused"], WAVLM_TRAIN_DW_SHAPE,
                          "depthwise_conv1d_bwd_w@wavlm_train", counts["train"], n_steps))
    for row in rows:
        mode = row["name"].split("[")[1].split("]")[0] if "[" in row["name"] else "bwd_w"
        row["launches_cli"] = cli["depthwise_" + mode]
        row["launches_cli_are"] = "the cli_wavlm runs (lid_wavlm.yaml, 4 x 2 s clips)"
        if not (row["launches"] > 0 and row["launches_cli"] > 0):
            raise AssertionError(f"{row['name']} was not launched on its WavLM path")
    return rows


# ------------------------------------------------ bfloat16 compute


# card against CPU in bfloat16: both sides round to bfloat16 at the same
# points but sum their GEMMs and convolutions in other orders, so a score or
# a gradient moves by a few bfloat16 roundings
BF16_SCORE_TOL = 2e-2  # scores, of the largest score
BF16_LOSS_TOL = 1e-2  # the train step's loss, of its size
BF16_GRAD_TOL = 5e-2  # each gradient, of its largest entry
WAVLM_BASE_PLUS_BF16 = dict(WAVLM_BASE_PLUS, dtype="bfloat16")
# the two models with dtype="bfloat16" (WavLM: ssl_config's dtype too, which
# the task's dtype does not reach), and what one forward and one train
# step of each launch
BF16_MODELS = {
    "conformer": dict(hp=dict(FLAGSHIP, dtype="bfloat16"),
                      deterministic=dict(CONFORMER_DETERMINISTIC, dtype="bfloat16"),
                      train_hp=dict(FLAGSHIP, **TRAIN_HPARAMS),
                      per_forward=BF16_PER_FORWARD_LAUNCHES,
                      per_step=BF16_TRAIN_STEP_LAUNCHES,
                      config="flagship 14x144, heads 3x(40,96,88), dtype bfloat16"),
    "wavlm": dict(hp=dict(WAVLM, dtype="bfloat16", ssl_config=WAVLM_BASE_PLUS_BF16),
                  deterministic=dict(WAVLM_DETERMINISTIC, dtype="bfloat16", ssl_config=dict(
                      WAVLM_DETERMINISTIC["ssl_config"], dtype="bfloat16")),
                  train_hp=WAVLM, per_forward=WAVLM_BF16_PER_FORWARD_LAUNCHES,
                  per_step=WAVLM_BF16_TRAIN_STEP_LAUNCHES,
                  config="WavLM-Base+ 12x768 + heads 3x(40,96,88) at 768, dtype and "
                         "ssl_config.dtype bfloat16"),
}


def init_model_(model: str, task: LidASRTask, gen: torch.Generator) -> None:
    """The random weights each model's float32 phases draw."""
    if model == "conformer":
        init_random_(task.model, gen)
    else:
        init_wavlm_(task, gen)


def as_float32(hp: dict) -> dict:
    """The same task options with every compute dtype float32."""
    out = dict(hp, dtype="float32")
    if "ssl_config" in hp:
        out["ssl_config"] = dict(hp["ssl_config"], dtype="float32")
    return out


def phase_bf16_model(gen: torch.Generator, model: str) -> None:
    """The full-width model in bfloat16 on the card (the depthwise kernel's
    bfloat16 instantiation) against the same state_dict in bfloat16 on the
    CPU (its plain versions), on a ragged batch of a 3 s and a 2 s clip:
    float32 logits on both sides, scores within ``BF16_SCORE_TOL`` of the
    largest score, ``pred_lang`` equal where the CPU's margin between the
    two best languages exceeds twice the scores' distance, and the launches
    of one forward, every depthwise launch in bfloat16."""
    spec = BF16_MODELS[model]
    task = LidASRTask(**spec["hp"], device="cuda")
    init_model_(model, task, gen)
    cpu = LidASRTask(**spec["hp"], device="cpu")
    cpu.model.load_state_dict(task.model.state_dict())
    wavs = 0.1 * torch.randn(2, 3 * SR, generator=gen)
    lengths = torch.tensor([3 * SR, 2 * SR])
    got, ref, per_forward, errs = infer_card_vs_cpu(task, cpu, wavs, lengths)
    neg = torch.finfo(torch.float32).min
    live = ref["logits"] > neg
    largest = ref["scores"].abs().max().item()
    score_err = errs["max_abs_err_scores"]
    top2 = ref["scores"].sort(dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * score_err
    name = "bf16_model_card_vs_cpu" if model == "conformer" else "bf16_wavlm_model_card_vs_cpu"
    emit({
        "phase": name, "config": spec["config"], "batch": [2, 3 * SR],
        "lengths": lengths.tolist(), "logits_dtype": str(got["logits"].dtype), **errs,
        "largest_score": largest, "rel_err_scores": score_err / largest,
        "tol_of_largest_score": BF16_SCORE_TOL,
        "scores": got["scores"].tolist(), "scores_cpu": ref["scores"].tolist(),
        "pred_lang": got["pred_lang"].tolist(), "pred_lang_cpu": ref["pred_lang"].tolist(),
        "pred_lang_compared": clear.tolist(), "cpu_depth": "full", "launches_per_forward": per_forward,
    })
    checks = {
        "finite": bool(torch.isfinite(got["logits"][live]).all()
                       and torch.isfinite(got["scores"]).all()),
        "float32_logits": got["logits"].dtype == ref["logits"].dtype == torch.float32,
        "scores": score_err <= BF16_SCORE_TOL * largest,
        "masked_slots": bool(torch.equal(got["logits"] == neg, ref["logits"] == neg)),
        "pred_lang": torch.equal(got["pred_lang"][clear], ref["pred_lang"][clear]),
        "launches": per_forward == spec["per_forward"],
    }
    if not all(checks.values()):
        raise AssertionError(f"{name} failed: {checks}")


def phase_bf16_train_card_vs_cpu(gen: torch.Generator) -> None:
    """One deterministic B = 8, 4 s train step of each model in bfloat16 on
    the card and on the CPU from the same state_dict, and in float32 on the
    card (:func:`step_card_vs_cpu`; the Conformer's CPU side takes the
    card's features and subsampling ReLU decisions): the loss within
    ``BF16_LOSS_TOL`` of its size, and the launches of the step.  The
    gradients: bfloat16's rounding moves both sides' away from the float32
    gradients of the same step by as much as they differ from each other
    (tens of percent of a leaf whose sum cancels), so what the card must
    show is that it computes them as exactly as the CPU's plain path, in
    relative L2 norm: over every gradient no further from float32 than
    twice the CPU's distance plus 1e-3, and in each leaf of at least
    ``MIN_LEAF`` entries no further than ``BF16_GRAD_TOL`` or three times
    the CPU's distance.  The leaves where a distance passes
    ``BF16_GRAD_TOL`` are reported."""
    for model, spec in BF16_MODELS.items():
        batch = synthetic_batch(np.random.RandomState(4), lang=1, b=8, seconds=4.0)
        if model == "conformer":
            step = conformer_step_card_vs_cpu(spec["deterministic"], gen, batch, BF16_GRAD_TOL)
        else:
            card = LidASRTask(**spec["deterministic"], device="cuda")
            cpu = LidASRTask(**spec["deterministic"], device="cpu")
            reference = LidASRTask(**as_float32(spec["deterministic"]), device="cuda")
            init_wavlm_(card, gen)
            cpu.model.load_state_dict(card.model.state_dict())
            reference.model.load_state_dict(card.model.state_dict())
            step = step_card_vs_cpu(card, cpu, batch, ("depthwise.bias", "k_proj.bias"),
                                    reference=reference, tol=BF16_GRAD_TOL)
        emit({"phase": "bf16_train_card_vs_cpu", "model": model, "batch": [8, 4 * SR],
              "tol_loss": BF16_LOSS_TOL, "tol_gradient": BF16_GRAD_TOL, **step})
        ok = (step["same_leaves"] and step["rel_err_loss"] <= BF16_LOSS_TOL
              and step["max_card_over_bar"] <= 1.0
              and step["rel_l2_card_vs_float32"] <= 2 * step["rel_l2_cpu_vs_float32"] + 1e-3
              and step["launches_per_train_step"] == spec["per_step"])
        if not ok:
            raise AssertionError(f"the bf16 {model} train step on the card disagrees with the CPU")


BF16_TRAIN_STEPS = 6  # train steps the bfloat16 rows' launches are counted over


def phase_bf16_launches(gen: torch.Generator) -> dict:
    """Each model in bfloat16: the launches of ``INFER_CALLS`` calls of
    ``infer`` on 3 s clips at B = 1 and B = 32, of 10 ``/lid`` requests and
    of ``BF16_TRAIN_STEPS`` B = 8, 4 s train steps with everything random on
    (finite losses), checked (the float32 models' are the flagship's and
    WavLM's phases).  Returns, per model, the launches."""
    out = {}
    for model, spec in BF16_MODELS.items():
        task = LidASRTask(**dict(spec["train_hp"], dtype="bfloat16", **(
            {"ssl_config": WAVLM_BASE_PLUS_BF16} if model == "wavlm" else {})), device="cuda")
        init_model_(model, task, gen)
        out[model] = counts = infer_launches(task, gen, spec["per_forward"], f"bf16 {model}")
        report = phase_serve(task, gen, spec["per_forward"], f"bf16_serve_{model}")
        counts["serve"], counts["requests"] = report["launches"], report["requests"]
        task.init_parameters = lambda generator: None  # train on from these weights
        trainer = Trainer(total_epoch=1, use_progress_bar=False, seed=0)
        trainer.trainer_prepare(task)
        rng = np.random.RandomState(5)
        batches = [synthetic_batch(rng, i % N_LANG, TRAIN_B, TRAIN_SECONDS) for i in range(3)]
        counts["train"] = train_launches(trainer, batches, BF16_TRAIN_STEPS, spec["per_step"],
                                         f"bf16 {model}")
        del task, trainer
        gc.collect()
        torch.cuda.empty_cache()
    return out


def bf16_kernel_rows(gen: torch.Generator, errs: dict, launched: dict, cli: dict) -> list:
    """The ``kernels`` line's bfloat16 rows: the depthwise kernel's bfloat16
    modes at the shapes the bfloat16 paths give it, with their launches
    there (``launched``: :func:`phase_bf16_launches`; WavLM rows also on the
    ``cli_wavlm_bf16`` run)."""
    rows = []
    for model, eval_rows, train_shape in (
            ("conformer", (("depthwise_conv1d_fwd[glu_bn_act]@bf16", SERVE_DW_SHAPE),
                           ("depthwise_conv1d_fwd[glu_bn_act]@bf16_b32", SCORE_DW_SHAPE)),
             TRAIN_DW_SHAPE),
            ("wavlm", (("depthwise_conv1d_fwd[glu_bn_act]@wavlm_bf16", WAVLM_SERVE_DW_SHAPE),
                       ("depthwise_conv1d_fwd[glu_bn_act]@wavlm_bf16_b32", WAVLM_SCORE_DW_SHAPE)),
             WAVLM_TRAIN_DW_SHAPE)):
        counts = launched[model]
        n_req, n_steps = counts["requests"], BF16_TRAIN_STEPS
        suffix = "@bf16" if model == "conformer" else "@wavlm_bf16"
        model_rows = fused_kernel_rows(gen, errs["conv_fused"], {
            eval_rows[0][0]: (counts["serve"]["depthwise_glu_bn_act"], {
                "launches_per_request": counts["serve"]["depthwise_glu_bn_act"] / n_req,
                "launches_counted_on": f"the bfloat16 {model} /lid requests"}),
            eval_rows[1][0]: (counts["b32"]["depthwise_glu_bn_act"], {
                "launches_per_batch": counts["b32"]["depthwise_glu_bn_act"] / INFER_CALLS,
                "launches_counted_on": f"the counted bfloat16 {model} infer calls at B = 32"}),
            f"depthwise_conv1d_fwd[glu]{suffix}_train": (counts["train"]["depthwise_glu"], {
                "launches_per_train_step": counts["train"]["depthwise_glu"] / n_steps}),
            f"depthwise_conv1d_fwd[glu_dx]{suffix}_train": (counts["train"]["depthwise_glu_dx"], {
                "launches_per_train_step": counts["train"]["depthwise_glu_dx"] / n_steps}),
        }, eval_rows=eval_rows, train_shape=train_shape, train_suffix=f"{suffix}_train",
            dtype=torch.bfloat16)
        model_rows.append(bwd_w_row(gen, errs["conv_fused"], train_shape,
                                    f"depthwise_conv1d_bwd_w{suffix}_train", counts["train"],
                                    n_steps, torch.bfloat16))
        for row in model_rows:
            if model == "wavlm":
                mode = row["name"].split("[")[1].split("]")[0] if "[" in row["name"] else "bwd_w"
                row["launches_cli"] = cli["depthwise_" + mode]
                row["launches_cli_are"] = ("the cli_wavlm_bf16 runs (lid_wavlm_bf16.yaml, "
                                           "8 x 2 s clips)")
            if not row["launches"] > 0:
                raise AssertionError(f"{row['name']} was not launched on its bfloat16 path")
        rows += model_rows
    return rows


# ----------------------------------- cross-entropy LID and standalone CTC ASR

CE_BACKENDS = ("xvector", "linear", "resnet2", "resnet34", "resnet101", "xvector2")
CE_SSL_CONFIGS = ("lid_cross_wavlm", "lid_cross_wav2vec")
CE_CLASSES = 3
CE_TOL = 1e-3  # card vs CPU logits, of the CPU's largest entry; the loss, gradients, statistics
CE_B, CE_SECONDS = 4, 4.0  # the card-vs-CPU forward: a ragged batch of 4 s clips
CE_TRAIN_B = 8  # the card-vs-CPU train step, 4 s clips
CE_E2E_B = 16  # lid_cross.yaml's batch size: the counted train steps and the 13 s eval
CE_TRAIN_BACKENDS = ("xvector", "resnet34")
# lid_cross.yaml on the round-5 corpus: 3 languages x 96 clips in
# language-homogeneous batches of 16 are 18 steps an epoch, 24 val clips a
# language 6 eval batches (two of 16, the second padded)
CROSS_BATCH = 16
CROSS_EPOCH_STEPS = N_LANG * -(-CORPUS_TRAIN // CROSS_BATCH)
CROSS_EVAL_BATCHES = N_LANG * -(-CORPUS_VAL // CROSS_BATCH)
CROSS_EPOCHS = 4  # then a resume for a fifth
# The JAX CLI on the CPU with the same config, corpus, epochs and overrides
# (scripts/jax_cross_seeds.py, seeds 0-3) read held-out val_acc 0.33-0.67
# after epoch 1, 0.67-1.0 after epoch 2 and 1.0 from epoch 3 on in every
# seed (PERF.md §6).  The port's run must reach CROSS_LEARNED_ACC at
# its best over its 5 epochs: 7 of the 72 clips may be wrong where every
# JAX seed had none wrong for 3 epochs running, so a draw does not fail it.
CROSS_LEARNED_ACC = 0.9
# lid_cross_wavlm.yaml through the CLI: batches of 8, 3 steps an epoch (a
# tenth of 36), 9 eval batches of the 72 val clips
CROSS_SSL_DATA_FACTOR = 0.1
CROSS_SSL_STEPS = int(N_LANG * CORPUS_TRAIN // 8 * CROSS_SSL_DATA_FACTOR)
CROSS_SSL_EVAL_BATCHES = N_LANG * CORPUS_VAL // 8
# asr.yaml (14 x 144 Conformer, one CTC head) on one language of the corpus:
# batches of 8, 6 steps (half of an epoch of 12), 3 eval batches
ASR_LANG = "aa"
ASR_DATA_FACTOR = 0.5
ASR_STEPS = int(CORPUS_TRAIN // 8 * ASR_DATA_FACTOR)
ASR_EVAL_BATCHES = CORPUS_VAL // 8
ASR_DW = N_BLOCKS + 1  # the encoder's blocks and the one head
ASR_STEP_LAUNCHES = launch_counts(fbank=1, bwd_w=ASR_DW, glu=ASR_DW, glu_dx=ASR_DW)
ASR_EVAL_LAUNCHES = launch_counts(fbank=1, glu_bn_act=ASR_DW)
CE_FBANK_LAUNCHES = launch_counts(fbank=1)  # a train step or an eval batch on fbank
NO_LAUNCHES = launch_counts()  # the SSL path: no fbank, no depthwise conv


def config_module(name: str, *overrides: str) -> dict:
    """The ``module`` block of ``configs/<name>.yaml`` as the CLI's
    ``build_task`` passes it (``task`` taken out)."""
    from speechlid_tpu_torch.core.config import load_config

    module = load_config("configs", name, list(overrides)).module.to_dict()
    module.pop("task")
    return module


def ce_model_configs() -> list:
    """(name, hyper-parameters) of every cross-entropy model the phase
    drives: each back-end on fbank (``lid_cross.yaml``), and the two SSL
    configs as written (WavLM-Base+ shape with ``last_hidden_state``,
    wav2vec2-Base with ``hidden_states``)."""
    fbank = config_module("lid_cross")
    models = [(f"fbank/{b}", dict(fbank, backend=b, num_classes=CE_CLASSES))
              for b in CE_BACKENDS]
    return models + [(name, dict(config_module(name), num_classes=CE_CLASSES))
                     for name in CE_SSL_CONFIGS]


def init_ce_(task: LidCrossEntropyTask, gen: torch.Generator) -> None:
    """flax-like seeded weights (``init_parameters``), then every BatchNorm's
    scale, bias and running statistics away from the identity."""
    task.init_parameters(gen)
    with torch.no_grad():
        for m in task.model.modules():
            if isinstance(m, FlaxBatchNorm):
                n = m.running_mean.shape
                m.running_mean.copy_(0.2 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                if m.weight is not None:
                    m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                    m.bias.copy_(0.05 * torch.randn(n, generator=gen))


def ce_pair(hp: dict, gen: torch.Generator) -> tuple:
    card = LidCrossEntropyTask(**hp, device="cuda")
    init_ce_(card, gen)
    cpu = LidCrossEntropyTask(**hp, device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    return card, cpu


@torch.no_grad()
def ce_logits(task: LidCrossEntropyTask, wavs: torch.Tensor, lengths: torch.Tensor):
    """Eval logits of the task's model through its frontend."""
    task.model.eval()
    feats, f_len = task._model_inputs(wavs.to(task.device), lengths.to(task.device))
    return task.model(feats, f_len)


def ce_batch(rng: np.random.RandomState, b: int, seconds: float) -> dict:
    """A host batch in the feeder's layout: ragged clips in the ``seconds``
    bucket, mixed labels."""
    t = int(seconds * SR)
    return {"wavs": (0.1 * rng.randn(b, t)).astype(np.float32),
            "wav_lengths": rng.randint(t // 3, t + 1, b).astype(np.int32),
            "langs": rng.randint(0, CE_CLASSES, b).astype(np.int32), "n_valid": np.int32(0)}


def phase_ce_model_card_vs_cpu(gen: torch.Generator) -> None:
    """``LidCrossEntropyTask`` for every back-end on fbank (the fbank kernel
    on the card) and for both SSL configs, each at full width with seeded
    weights, on the card against the same state_dict on the CPU on a ragged
    batch of 4 s clips: logits within ``CE_TOL`` of the CPU's largest entry,
    the same argmax, and the launches of one forward."""
    t = int(CE_SECONDS * SR)
    wavs = 0.1 * torch.randn(CE_B, t, generator=gen)
    lengths = torch.tensor([t, t - 12000, t - 27000, t - 43000])
    rows, ok = {}, True
    for name, hp in ce_model_configs():
        card, cpu = ce_pair(hp, gen)
        ce_logits(card, wavs, lengths)
        torch.cuda.synchronize()
        reset_launches()
        got = ce_logits(card, wavs, lengths)
        torch.cuda.synchronize()
        counted = launches()
        ref = ce_logits(cpu, wavs, lengths)
        got = got.cpu()
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        want = CE_FBANK_LAUNCHES if name.startswith("fbank/") else NO_LAUNCHES
        row = {"params": sum(p.numel() for p in card.model.parameters()),
               "max_abs_err_over_largest": err, "argmax": got.argmax(-1).tolist(),
               "argmax_cpu": ref.argmax(-1).tolist(),
               "launches_per_forward": {k: v for k, v in counted.items() if v}}
        row["ok"] = (bool(torch.isfinite(got).all()) and err <= CE_TOL
                     and row["argmax"] == row["argmax_cpu"] and counted == want)
        ok &= row["ok"]
        rows[name] = row
        del card, cpu
        torch.cuda.empty_cache()
    emit({"phase": "ce_model_card_vs_cpu", "batch": [CE_B, t], "lengths": lengths.tolist(),
          "classes": CE_CLASSES, "tol": CE_TOL, "models": rows, "ok": ok})
    if not ok:
        raise AssertionError("a cross-entropy model on the card disagrees with the CPU")


def _ce_cpu_step(task: LidCrossEntropyTask, feats: torch.Tensor, f_len: torch.Tensor,
                 langs: torch.Tensor, dtype: torch.dtype) -> tuple:
    """One train-mode forward and backward of the CPU task's model on the
    given features: (loss, gradients, BatchNorm running statistics)."""
    task.model.train()
    logits = task.model(feats.cpu().to(dtype), f_len.cpu())
    loss = F.cross_entropy(logits, langs)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in task.model.named_parameters()}
    stats = {k: v.clone() for k, v in task.model.state_dict().items() if "running_" in k}
    return loss.item(), grads, stats


def pin_resnet_relus(on: bool, masks: list, differ: dict = None, module=presnet):
    """Point ``module.relu`` (``models/resnet.relu`` by default: every ReLU
    of the ResNet, in the forward's order; ``models/extras.relu`` for the
    extras zoo) at a recorder of each decision into ``masks``, or with
    ``differ`` at a replayer of the recorded decisions that counts in
    ``differ["units"]`` the units it decides otherwise; ``on=False`` puts
    ``torch.relu`` back."""
    if not on:
        module.relu = torch.relu
        return
    if differ is None:
        def record(x):
            y = torch.relu(x)
            masks.append((y > 0).cpu())
            return y
        module.relu = record
        return
    calls = iter(range(len(masks)))

    def replay(x):
        keep = masks[next(calls)]
        differ["units"] += int(((x > 0) != keep).sum())
        return x * keep.to(x.dtype)
    module.relu = replay


def phase_ce_train_card_vs_cpu(gen: torch.Generator) -> None:
    """One deterministic train step (dropout off on both sides, SpecAugment
    off) of the x-vector and the ResNet34 back-ends at full width, B = 8,
    4 s clips, on the card (the task's ``train_loop``: the fbank kernel,
    cuDNN) and on the CPU from the same state_dict: the loss, every
    gradient and the updated running statistics within ``CE_TOL``.

    The CPU side is given the card's features, as ``train_card_vs_cpu``
    gives its Conformer (the frontend has no parameters; the kernel is held
    against plain at this shape in ``phase_fbank``).  Inside the ResNet,
    cuDNN's convolutions and the CPU's round differently, and a ReLU unit
    whose input lies within that rounding of 0 goes one way on the card and
    the other on the CPU; through the train-mode BatchNorms of a batch of 8
    such flips move a third of the gradients by 1–3 % of their largest
    entry, on either float32 side against float64 (the first run of this
    phase).  So the CPU side takes the card's 34 ReLU decisions
    (:func:`pin_resnet_relus`), and the units it would have decided
    otherwise are counted (``relu_units_decided_otherwise``), as
    ``train_card_vs_cpu`` pins its subsampling's.  A leaf whose
    card-vs-CPU distance still passes ``CE_TOL`` is held instead to be no
    further from the CPU's float64 step (same decisions) than the CPU's
    float32 step is (twice that distance plus 1e-4, both over the float64
    leaf's largest entry); such leaves are listed
    (``leaves_on_float64_bar``).  MHASTP's last biases ``att_b_1`` have a
    true gradient of zero (they shift a softmax over time): both sides hold
    rounding noise there, held to ``CE_TOL`` of the largest gradient of
    all."""
    rng = np.random.RandomState(11)
    rows, ok = {}, True
    for backend in CE_TRAIN_BACKENDS:
        hp = dict(config_module("lid_cross"), backend=backend, num_classes=CE_CLASSES,
                  mask_times=0)
        card, cpu = ce_pair(hp, gen)
        cpu64 = LidCrossEntropyTask(**hp, device="cpu")
        cpu64.model.load_state_dict(card.model.state_dict())
        cpu64.model.double()
        for task in (card, cpu, cpu64):
            for m in task.model.modules():
                if isinstance(m, Dropout):
                    m.p = 0.0
        batch = ce_batch(rng, CE_TRAIN_B, CE_SECONDS)
        placed = card.place_batch(batch)
        feats, f_len = card._model_inputs(placed["wavs"], placed["wav_lengths"])
        card.set_generators(torch.Generator("cuda").manual_seed(0),
                            torch.Generator().manual_seed(0))
        card.model.train()
        resnet = backend.startswith("resnet")
        masks, differ = [], {"units": 0}
        pin_resnet_relus(resnet, masks)
        try:
            torch.cuda.synchronize()
            reset_launches()
            loss, _ = card.train_loop(placed)
            loss.backward()
            torch.cuda.synchronize()
            counted = launches()
            pin_resnet_relus(resnet, masks, differ)
            langs = torch.from_numpy(batch["langs"]).long()
            loss_cpu, g_cpu, s_cpu = _ce_cpu_step(cpu, feats, f_len, langs, torch.float32)
        finally:
            pin_resnet_relus(False, masks)
        loss_card = loss.item()
        g_card = {k: p.grad.cpu() for k, p in card.model.named_parameters()}
        s_card = {k: v.cpu() for k, v in card.model.state_dict().items() if "running_" in k}
        largest = max(float(g.abs().max()) for g in g_cpu.values())

        def rel(a, b):
            return float((a.double() - b.double()).abs().max() / b.double().abs().max()
                         .clamp_min(1e-30))

        errs = {name: (max(float(g_card[name].abs().max()), float(gc.abs().max())) / largest
                       if name.endswith("att_b_1") else rel(g_card[name], gc))
                for name, gc in g_cpu.items()}
        loss_64, g_64 = None, {}
        if max(errs.values()) > CE_TOL:  # the float64 step, for the leaves that need it
            try:
                pin_resnet_relus(resnet, masks, {"units": 0})
                loss_64, g_64, _ = _ce_cpu_step(cpu64, feats, f_len, langs, torch.float64)
            finally:
                pin_resnet_relus(False, masks)
        worst_name = max(errs, key=errs.get)
        worst, on_float64, over = errs[worst_name], {}, []
        for name, gc in g_cpu.items():
            err = errs[name]
            if err > CE_TOL:
                d_card, d_cpu = rel(g_card[name], g_64[name]), rel(gc, g_64[name])
                on_float64[name] = {"card_vs_cpu": err, "card_vs_float64": d_card,
                                    "cpu_vs_float64": d_cpu}
                if d_card > 2 * d_cpu + 1e-4:
                    over.append(name)
        stats_err = max((rel(s_card[k], v) for k, v in s_cpu.items()), default=0.0)
        row = {"params": sum(p.numel() for p in card.model.parameters()),
               "loss_card": loss_card, "loss_cpu": loss_cpu, "loss_float64": loss_64,
               "rel_err_loss": abs(loss_card - loss_cpu) / max(abs(loss_cpu), 1.0),
               "gradients": len(g_cpu), "max_rel_err_gradient": worst,
               "worst_gradient": worst_name, "relu_calls_pinned": len(masks),
               "relu_units_decided_otherwise": differ["units"],
               "leaves_on_float64_bar": on_float64,
               "leaves_over_float64_bar": over, "max_rel_err_running_stats": stats_err,
               "launches_per_train_step": {k: v for k, v in counted.items() if v}}
        row["ok"] = (set(g_card) == set(g_cpu) and row["rel_err_loss"] <= CE_TOL and not over
                     and stats_err <= CE_TOL and counted == CE_FBANK_LAUNCHES
                     and bool(np.isfinite(loss_card) and np.isfinite(loss_cpu)))
        ok &= row["ok"]
        rows[backend] = row
        del card, cpu, cpu64
        torch.cuda.empty_cache()
    emit({"phase": "ce_train_card_vs_cpu", "batch": [CE_TRAIN_B, int(CE_SECONDS * SR)],
          "dropout": 0.0, "cpu_features": "the card's", "tol": CE_TOL, "backends": rows,
          "ok": ok})
    if not ok:
        raise AssertionError("a cross-entropy train step on the card disagrees with the CPU")


def _count_fbank_shapes() -> tuple:
    """Wrap ``frontend.wav2mel`` (which hands its wav to the fbank kernel as
    it is) to count the (B, T) shapes it is called at; → (the counts, a
    function that unwraps it)."""
    wav2mel, shapes = frontend.wav2mel, {}

    def wav2mel_seen(wav, *args, **kwargs):
        key = tuple(wav.shape)
        shapes[key] = shapes.get(key, 0) + 1
        return wav2mel(wav, *args, **kwargs)

    frontend.wav2mel = wav2mel_seen
    return shapes, lambda: setattr(frontend, "wav2mel", wav2mel)


def _lr_by_epoch(lines: list, steps: list) -> list:
    """The ``lr`` line each train epoch ended with."""
    lrs = {line["step"]: line["lr"] for line in lines if "lr" in line}
    return [lrs.get(step) for step in steps]


def phase_cli_cross(root: str, corpus: str, smi: str) -> dict:
    """The training CLI on ``configs/lid_cross.yaml`` as written (the
    x-vector back-end at 512 wide on 80 mels, batch 16, buckets 2/4/8/13 s,
    Adam at 1e-3, the plateau lr on the eval loss) over the corpus: 4 epochs,
    then a resume for a fifth, each followed by an eval over the 72 val
    clips; then ``stage=test`` on the checkpoint.  Reports per epoch the
    seconds, ``get_batch``, ``val_acc``, ``eer``, ``cavg`` and the lr; the
    fbank launches a step and an eval batch, and the shapes the kernel was
    called at.  Fails below ``CROSS_LEARNED_ACC`` at the best epoch, or
    when steps, launches, checkpoint or the test's ``val_acc`` are not the
    expected ones.  Launch counts are set to 0 just before each run and
    read just after."""
    exp = os.path.join(root, "cross")
    base = [_langs_override(corpus), "trainer.progress_bar=false"]
    last = os.path.join(exp, "ckpt", "last.ckpt")
    runs, counted = {}, {}
    shapes, unwrap = _count_fbank_shapes()
    try:
        for name, extra in (
                ("fit", [f"exp_dir={exp}", f"trainer.total_epoch={CROSS_EPOCHS}"]),
                ("resume", [f"exp_dir={exp}", f"trainer.total_epoch={CROSS_EPOCHS + 1}",
                            f"trainer.resume_from={last}"]),
                ("test", [f"exp_dir={os.path.join(root, 'cross_test')}", "stage=test",
                          f"trainer.resume_from={last}"])):
            torch.cuda.synchronize()
            reset_launches()
            runs[name] = run_cli(_cli_args("configs", "lid_cross", *base, *extra))
            counted[name] = launches()
    finally:
        unwrap()
    lines = _metrics_lines(os.path.join(exp, "metrics.jsonl"))
    evals = [line for line in lines if "val_acc" in line]
    test = _metrics_lines(os.path.join(root, "cross_test", "metrics.jsonl"))[-1]
    epochs = runs["fit"].epochs + runs["resume"].epochs
    steps = [e["steps"] for e in epochs]
    lrs = _lr_by_epoch(lines, [int(n) for n in np.cumsum(steps)])
    per_epoch = [{"epoch": e["epoch"], "steps": e["steps"], "lr": lr,
                  **{k: ev[k] for k in ("val_acc", "eer", "cavg", "avg_val_loss")}}
                 for e, ev, lr in zip(epochs, evals, lrs)]
    best = max(e["val_acc"] for e in evals)
    ckpt_meta = load_checkpoint(last)["meta"]
    report = {"phase": "cli_cross", "nvidia_smi": smi,
              "config": "configs/lid_cross.yaml (x-vector, 80 mels, batch 16, plateau lr)",
              "per_epoch": per_epoch, "best_val_acc": best, "learned_floor": CROSS_LEARNED_ACC,
              "test": {k: test[k] for k in ("val_acc", "eer", "cavg", "avg_val_loss")},
              "launches": counted, "fbank_shapes": {str(k): v for k, v in shapes.items()},
              "ckpt_meta": {k: ckpt_meta[k] for k in ("epoch", "global_step")}, "runs": {}}
    checks = {}
    for name, recorder in runs.items():
        per_step, per_eval = _per_step(recorder)
        report["runs"][name] = {"eval_batches":
                                [e["batches"] for e in recorder.evals],
                                "launches_per_train_step": per_step,
                                "launches_per_eval_batch": per_eval}
        if name != "test":
            checks[f"{name}_launches"] = (per_step == CE_FBANK_LAUNCHES
                                          and per_eval == CE_FBANK_LAUNCHES)
            checks[f"{name}_evals"] = [e["batches"] for e in recorder.evals] == \
                [CROSS_EVAL_BATCHES] * len(recorder.epochs)
    checks.update({
        "learned": best >= CROSS_LEARNED_ACC,
        "steps": steps == [CROSS_EPOCH_STEPS] * (CROSS_EPOCHS + 1),
        "eval_lines": len(evals) == CROSS_EPOCHS + 1
        and all(np.isfinite(e["avg_val_loss"]) and np.isfinite(e["eer"]) for e in evals),
        "lr_lines": all(lr is not None for lr in lrs),
        "resumed_at_last_epoch": [e["epoch"] for e in runs["resume"].epochs] == [CROSS_EPOCHS],
        "ckpt": ckpt_meta["epoch"] == CROSS_EPOCHS
        and ckpt_meta["global_step"] == (CROSS_EPOCHS + 1) * CROSS_EPOCH_STEPS,
        "test_val_acc": test["val_acc"] == evals[-1]["val_acc"],
        "test_launches": counted["test"] == {
            k: v * CROSS_EVAL_BATCHES for k, v in CE_FBANK_LAUNCHES.items()},
        "fbank_shapes": {b for b, _ in shapes} == {CROSS_BATCH}
        and sum(shapes.values()) == sum(c["fbank"] for c in counted.values()),
    })
    report["checks"] = checks
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"CLI cross-entropy phase failed: {checks}")
    return report


def phase_cli_cross_ssl(root: str, corpus: str, smi: str) -> dict:
    """The training CLI on ``configs/lid_cross_wavlm.yaml`` as written
    (WavLM-Base+ shape, ``last_hidden_state``, ``freeze_upstream``, span and
    channel masking at 0.15, the x-vector back-end at 768 wide) over the
    corpus: an epoch of 3 steps, then a resume for a second, each followed
    by an eval of the 72 val clips.  With ``freeze_upstream`` every upstream
    weight of the checkpoint is bit-equal to the fresh draw of the
    trainer's seed, and every classifier weight has moved.  No kernel
    launches on this path."""
    exp = os.path.join(root, "cross_ssl")
    base = [_langs_override(corpus), f"exp_dir={exp}", "trainer.progress_bar=false",
            f"trainer.train_data_factor={CROSS_SSL_DATA_FACTOR}"]
    last = os.path.join(exp, "ckpt", "last.ckpt")
    runs, counted = {}, {}
    for name, extra in (("fit", ["trainer.total_epoch=1"]),
                        ("resume", ["trainer.total_epoch=2", f"trainer.resume_from={last}"])):
        torch.cuda.synchronize()
        reset_launches()
        runs[name] = run_cli(_cli_args("configs", "lid_cross_wavlm", *base, *extra))
        counted[name] = launches()
    ckpt = load_checkpoint(last)
    trained = ckpt["state"]["model"]
    fresh = LidCrossEntropyTask(**ckpt["hyper_parameters"], device="cpu")
    fresh.init_parameters(torch.Generator().manual_seed(0 + 2))  # the trainer's seed + 2
    drawn = fresh.model.state_dict()
    upstream = [k for k in drawn if k.startswith("upstream.")]
    classifier = [k for k, _ in fresh.model.named_parameters() if k.startswith("classifier.")]
    changed_upstream = [k for k in upstream if not torch.equal(trained[k].cpu(), drawn[k])]
    unmoved = [k for k in classifier if torch.equal(trained[k].cpu(), drawn[k])]
    lines = _metrics_lines(os.path.join(exp, "metrics.jsonl"))
    evals = [line for line in lines if "val_acc" in line]
    report = {"phase": "cli_cross_ssl", "nvidia_smi": smi,
              "config": "configs/lid_cross_wavlm.yaml (WavLM-Base+ shape, freeze_upstream)",
              "params": sum(v.numel() for v in drawn.values()),
              "upstream_leaves": len(upstream), "upstream_leaves_changed": changed_upstream,
              "classifier_leaves": len(classifier), "classifier_leaves_unmoved": unmoved,
              "evals": evals, "launches": counted,
              "ckpt_meta": {k: ckpt["meta"][k] for k in ("epoch", "global_step")}, "runs": {}}
    checks = {}
    for name, recorder in runs.items():
        per_step, per_eval = _per_step(recorder)
        report["runs"][name] = {"epochs": recorder.epochs,
                                "eval_batches": [e["batches"] for e in recorder.evals]}
        checks[f"{name}_steps"] = [e["steps"] for e in recorder.epochs] == [CROSS_SSL_STEPS]
        checks[f"{name}_evals"] = [e["batches"] for e in recorder.evals] == \
            [CROSS_SSL_EVAL_BATCHES]
        checks[f"{name}_launches"] = per_step == NO_LAUNCHES and per_eval == NO_LAUNCHES
    checks.update({
        "upstream_frozen": bool(upstream) and not changed_upstream,
        "classifier_moved": bool(classifier) and not unmoved,
        "eval_lines": len(evals) == 2 and all(np.isfinite(e["avg_val_loss"]) for e in evals),
        "ckpt": ckpt["meta"]["epoch"] == 1 and ckpt["meta"]["global_step"] == 2 * CROSS_SSL_STEPS,
    })
    report["checks"] = checks
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"CLI cross-entropy SSL phase failed: {checks}")
    return report


def phase_cli_asr(root: str, corpus: str, lm_dir: str, smi: str) -> dict:
    """The training CLI on ``configs/asr.yaml`` as written (14 × 144
    Conformer, one CTC head, Adam with the tristage schedule) on one
    language of the corpus: 6 steps, an eval of its 24 val clips; then
    ``stage=test`` on the checkpoint with ``module.lm_path`` that language's
    ARPA (``synth_corpus.write_lms``): the greedy CER (``val_wer``, the
    config's ``use_cer``) and ``test_cer_lm``.  The same checkpoint's
    ``test_loop_end`` on the CPU over the same batches must give the same
    greedy and LM CER.  The launches a step and an eval batch, and the conv
    shapes, are counted on the path."""
    from speechlid_tpu_torch.cli import main_lid
    from speechlid_tpu_torch.core.config import load_config
    from speechlid_tpu_torch.core.trainer import _to_host

    langs = (f"data.langs=[{{manifest: {corpus}/{ASR_LANG}/train.txt, "
             f"val_manifest: {corpus}/{ASR_LANG}/val.txt}}]")
    exp = os.path.join(root, "asr")
    last = os.path.join(exp, "ckpt", "last.ckpt")
    arpa = os.path.join(lm_dir, f"{ASR_LANG}.arpa")
    runs, counted, conv_shapes = {}, {}, {}

    def conv_seen(module, args, output):
        if isinstance(module, ConformerConvModule):
            k, c = module.depthwise.weight.shape
            key = str((*args[0].shape[:2], c, k))
            conv_shapes[key] = conv_shapes.get(key, 0) + 1

    hook = torch.nn.modules.module.register_module_forward_hook(conv_seen)
    try:
        for name, extra in (
                ("fit", [f"exp_dir={exp}", "trainer.total_epoch=1",
                         f"trainer.train_data_factor={ASR_DATA_FACTOR}"]),
                ("test", [f"exp_dir={os.path.join(root, 'asr_test')}", "stage=test",
                          f"trainer.resume_from={last}", f"module.lm_path={arpa}"])):
            torch.cuda.synchronize()
            reset_launches()
            runs[name] = run_cli(_cli_args("configs", "asr", langs, "trainer.progress_bar=false",
                                           *extra))
            counted[name] = launches()
    finally:
        hook.remove()
    evals = [line for line in _metrics_lines(os.path.join(exp, "metrics.jsonl"))
             if "val_wer" in line]
    test = _metrics_lines(os.path.join(root, "asr_test", "metrics.jsonl"))[-1]
    # the same checkpoint on the CPU, over the val feeder's batches
    conf = load_config("configs", "asr", [langs, f"module.lm_path={arpa}"])
    data = main_lid.build_data(conf)
    feeder = main_lid.build_feeder(conf, data["val_dataset"], seed=conf.get("seed", 0),
                                   train=False)
    cpu_task, _ = ASRTask.resume_from_checkpoint(last, device="cpu", lm_path=arpa)
    cpu_task.model.eval()
    cpu = cpu_task.test_loop_end([_to_host(cpu_task.val_loop(cpu_task.place_batch(b)))
                                  for b in feeder])
    per_step, per_eval = _per_step(runs["fit"])
    report = {"phase": "cli_asr", "nvidia_smi": smi,
              "config": f"configs/asr.yaml (14 x 144-d, one CTC head), language {ASR_LANG}, "
                        f"beam search with {ASR_LANG}.arpa",
              "steps": [e["steps"] for e in runs["fit"].epochs],
              "val_cer": evals[-1]["val_wer"] if evals else None,
              "test": {k: test.get(k) for k in ("val_wer", "test_cer_lm", "avg_val_loss")},
              "cpu_test": {k: cpu.get(k) for k in ("val_wer", "test_cer_lm", "avg_val_loss")},
              "launches": counted,
              "launches_per_train_step": per_step, "launches_per_eval_batch": per_eval,
              "conv_shapes": conv_shapes}
    checks = {
        "steps": report["steps"] == [ASR_STEPS],
        "launches": per_step == ASR_STEP_LAUNCHES and per_eval == ASR_EVAL_LAUNCHES,
        "test_launches": counted["test"] == {k: v * ASR_EVAL_BATCHES
                                             for k, v in ASR_EVAL_LAUNCHES.items()},
        "eval_line": len(evals) == 1 and bool(np.isfinite(evals[0]["avg_val_loss"])),
        "test_greedy_is_the_eval": test["val_wer"] == evals[-1]["val_wer"],
        "test_cer_lm": "test_cer_lm" in test and bool(np.isfinite(test["test_cer_lm"])),
        "cpu_same_cer": cpu["val_wer"] == test["val_wer"]
        and cpu.get("test_cer_lm") == test.get("test_cer_lm"),
    }
    report["checks"] = checks
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"CLI ASR phase failed: {checks}")
    return report


def phase_ce_launches(gen: torch.Generator) -> dict:
    """The launches of the cross-entropy task on the card, checked: train
    steps of the x-vector and the ResNet34 back-ends at B = 16 on 4 s clips
    (Adam, the trainer's step; finite losses), and five x-vector eval
    batches at (16, 13 s), the largest bucket of ``lid_cross.yaml``, whose
    fbank launches the kernels line counts."""
    rng = np.random.RandomState(12)
    out = {}
    for backend in CE_TRAIN_BACKENDS:
        task = LidCrossEntropyTask(**dict(config_module("lid_cross"), backend=backend,
                                          num_classes=CE_CLASSES), device="cuda")
        trainer = Trainer(total_epoch=1, use_progress_bar=False, seed=0)
        trainer.trainer_prepare(task)
        task.before_train_loop(0)
        batches = [ce_batch(rng, CE_E2E_B, CE_SECONDS) for _ in range(3)]
        train_launches(trainer, batches, len(batches), CE_FBANK_LAUNCHES, backend)
        if backend == "xvector":
            task.model.eval()
            batch = task.place_batch(ce_batch(rng, CE_E2E_B, 13.0))
            evals = 5
            counted = counted_calls(lambda: task.val_loop(batch), evals)
            out["eval_b16_13s_xvector"] = {"batches": evals,
                                           "launches": {k: v for k, v in counted.items() if v}}
            if counted != {k: v * evals for k, v in CE_FBANK_LAUNCHES.items()}:
                raise AssertionError(f"x-vector eval at 13 s: launches {counted}")
        del task, trainer
        torch.cuda.empty_cache()
    emit({"phase": "ce_launches", **out})
    return out


def phase_ce_asr(gen: torch.Generator, root: str, corpus: str, lm_dir: str, smi: str) -> tuple:
    """The cross-entropy and ASR phases in order; → (``cli_cross``'s report,
    ``cli_asr``'s)."""
    phase_ce_model_card_vs_cpu(gen)
    phase_ce_train_card_vs_cpu(gen)
    cross = phase_cli_cross(root, corpus, smi)
    phase_cli_cross_ssl(root, corpus, smi)
    return cross, phase_cli_asr(root, corpus, lm_dir, smi)


def ce_asr_kernel_rows(gen: torch.Generator, errs: dict, cross: dict, ce: dict,
                       asr: dict) -> list:
    """The ``kernels`` line's rows of the cross-entropy and ASR paths: the
    fbank kernel at the CLI's two buckets (16 × 2 s and 16 × 4 s, launches
    counted on ``cli_cross``) and at the largest bucket of ``lid_cross.yaml``
    (16 × 13 s, launches counted on ``ce_launches``' eval batches); the
    depthwise modes at the ASR path's 2 s shape with the launches of
    ``cli_asr``."""
    total = sum(c["fbank"] for c in cross["launches"].values())
    on_cross = "cli_cross: lid_cross.yaml, 5 epochs of 18 steps and 6 eval batches, stage=test"
    rows = [fbank_row(f"fbank_log_mel@cross_{key[6:]}", key, gen, errs, total, {
        "launches_counted_on": on_cross,
        "launches_at_this_shape": cross["fbank_shapes"].get(str(FBANK_SHAPES[key]), 0),
        "launches_per_train_step": 1, "launches_per_eval_batch": 1})
        for key in ("cross_2s", "cross_4s")]
    evals = ce["eval_b16_13s_xvector"]
    rows.append(fbank_row("fbank_log_mel@cross_13s", "cross_13s", gen, errs,
                          evals["launches"]["fbank"], {
                              "launches_counted_on": "ce_launches: x-vector val_loop at "
                                                     "(16, 13 s)",
                              "launches_per_eval_batch": 1}))
    fit, test = asr["launches"]["fit"], asr["launches"]["test"]
    on_asr = (f"cli_asr: asr.yaml, {ASR_STEPS} steps, {ASR_EVAL_BATCHES} eval batches, "
              "stage=test")
    extra = {"launches_counted_on": on_asr, "conv_shapes_seen": asr["conv_shapes"]}
    rows += fused_kernel_rows(gen, errs["conv_fused"], {
        "depthwise_conv1d_fwd[glu_bn_act]@asr": (
            fit["depthwise_glu_bn_act"] + test["depthwise_glu_bn_act"],
            dict(extra, launches_per_eval_batch=ASR_DW)),
        "depthwise_conv1d_fwd[glu]@asr": (fit["depthwise_glu"], dict(
            extra, launches_per_train_step=ASR_DW)),
        "depthwise_conv1d_fwd[glu_dx]@asr": (fit["depthwise_glu_dx"], dict(
            extra, launches_per_train_step=ASR_DW)),
    }, eval_rows=(("depthwise_conv1d_fwd[glu_bn_act]@asr", EVAL_DW_SHAPE),),
        train_shape=EVAL_DW_SHAPE, train_suffix="@asr")
    row = bwd_w_row(gen, errs["conv_fused"], EVAL_DW_SHAPE, "depthwise_conv1d_bwd_w@asr", fit,
                    ASR_STEPS)
    row.update(extra)
    rows.append(row)
    return rows


# ------------------------------------------------ speech enhancement and bilstm heads
#
# The SE task's three models at the repository's widths: the DPRNN at
# SETask's defaults (what main_extras se trains: 64-d encoder, 16-sample
# windows, chunks of 100, 2 blocks, hidden 64) and FaSNet-TAC and
# FaSNet-Origin at their class defaults (the reference's FaSNet_TAC width:
# 64 / 64 / 128, 4 or 6 layers, segments of 50, 4 ms windows with 16 ms of
# context, 513-tap filters).  They run no hand kernel: cuDNN's LSTMs, cuFFT
# and cuBLAS.  The eval CLI scores the enhanced and blended batches through
# both kernels, and the bilstm joint model runs the encoder's.

SE_MODELS = ("dprnn", "fasnet_tac", "fasnet_origin")
SE_B, SE_SECONDS, SE_MICS = 4, 4.0, 4
SE_NUM_MIC = (4, 3, 2, 4)  # FaSNet-TAC's batch of valid mic counts
SE_TOL = 1e-3  # card vs CPU: the output of its largest entry, the loss, each gradient of its leaf's
# a gradient leaf past SE_TOL, card (cuDNN's float32 LSTM) against the CPU's
# float64 step in relative L2: up to 3.5e-3 seen, and TF32 in cuDNN misses it
SE_CUDNN_TOL = 1e-2
SE_ZERO_GRAD_LEAVES = {"dprnn": ("decoder.bias",)}  # SI-SNR removes the mean: true gradient 0
CLI_SE_CLIPS, CLI_SE_SECONDS, CLI_SE_EPOCHS, CLI_SE_BATCH, CLI_SE_LR = 80, 1.0, 10, 8, 2e-3
SE_FACTOR_SWEEP = "0:1:0.5"
BILSTM = dict(FLAGSHIP, head_type="bilstm")
BILSTM_PER_FORWARD_LAUNCHES = launch_counts(fbank=1, glu_bn_act=N_BLOCKS)  # no conv in the heads
BILSTM_TRAIN_STEP_LAUNCHES = launch_counts(fbank=1, bwd_w=N_BLOCKS, glu=N_BLOCKS, glu_dx=N_BLOCKS)


def se_tones(rng: np.random.RandomState, n: int, t: int, mics: int = 0) -> tuple:
    """(noisy, clean) float32: each clip a sum of two tones under white
    noise at about 1 dB, as the JAX SE tests make them.  With ``mics``,
    noisy is (n, mics, t): mic m hears the clean wave m samples late with
    noise of its own."""
    time_s = np.arange(t) / SR
    f = rng.uniform(150, 900, (n, 2))
    clean = 0.35 * (np.sin(2 * np.pi * f[:, :1] * time_s) + np.sin(2 * np.pi * f[:, 1:] * time_s))
    if not mics:
        return (clean + 0.3 * rng.randn(n, t)).astype(np.float32), clean.astype(np.float32)
    noisy = np.stack([np.roll(clean, m, axis=-1) for m in range(mics)], axis=1)
    return (noisy + 0.3 * rng.randn(n, mics, t)).astype(np.float32), clean.astype(np.float32)


def se_model(kind: str) -> torch.nn.Module:
    """One of ``SE_MODELS`` at its width (on the CPU)."""
    return {"dprnn": DPRNNEnhancer, "fasnet_tac": FaSNetTAC, "fasnet_origin": FaSNetOrigin}[kind]()


def init_se_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """flax's initial distributions (``init_like_flax_``), then every bias,
    norm and slope moved off its constant by N(0, 0.05²)."""
    init_like_flax_(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() <= 1:
                p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.device))


def se_forward(kind: str, model: torch.nn.Module, noisy: torch.Tensor, num_mic=None):
    """→ (B, T): the DPRNN's output, or a FaSNet's first speaker."""
    return model(noisy) if kind == "dprnn" else model(noisy, num_mic)[:, 0]


def _se_step_grads(kind: str, model: torch.nn.Module, noisy, clean, num_mic,
                   dtype: torch.dtype = torch.float32) -> dict:
    """The gradients of :func:`phase_se_card_vs_cpu`'s step on a copy of
    ``model`` (whose own gradients stay) in ``dtype``, on its device."""
    import copy

    model = copy.deepcopy(model).to(dtype=dtype).train()
    for m in model.modules():  # the DPRNN's flax-semantics LayerNorms
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    model.zero_grad()
    dev = next(model.parameters()).device
    nm = None if num_mic is None else num_mic.to(dev)
    est = se_forward(kind, model, torch.from_numpy(noisy).to(dev, dtype), nm)
    (-si_snr(est, torch.from_numpy(clean).to(dev, dtype)).mean()).backward()
    return {n: p.grad.cpu().double() for n, p in model.named_parameters()}


def phase_se_card_vs_cpu(gen: torch.Generator) -> dict:
    """Each SE model on the card against the same weights on the CPU, on
    B = 4 clips of 4 s (FaSNet: 4 mics, FaSNet-TAC with a batch of valid
    mic counts): the output, and one train step's SI-SNR loss and every
    gradient, within ``SE_TOL``.  The recurrences run 100-step (DPRNN) or
    50- and 81-step (FaSNet) chunks in cuDNN and on the CPU in another
    order of sums; the errors seen stand beside the bars in the line.

    cuDNN's float32 LSTM (TF32 off) is less exact than the CPU's and
    PyTorch's own CUDA LSTM: one FaSNet BiLSTM's output lies 5.7e-6 from
    float64, theirs 1.7e-7 and 1.8e-7, on NVIDIA H100 80GB HBM3
    (``scripts/fasnet_lstm_precision.py``).  FaSNet's deep stacks at random
    weights, where SI-SNR's gradient is ill-conditioned (the estimate is
    nearly orthogonal to the clean wave), carry that to about 2e-3 of a
    gradient leaf, while the CPU's float32 step lies up to 7.3e-4 from
    float64 in some draws.  So a gradient leaf past ``SE_TOL`` from the CPU
    is held instead to the CPU's float64 step, in relative L2 norm, within
    ``SE_CUDNN_TOL`` or three times the CPU's float32 distance
    (``leaves_held_to_float64``, max-abs distances reported beside).  Up to
    3.5e-3 was seen there; with TF32 on in cuDNN (one BiLSTM 3.7e-4 from
    float64) the phase fails."""
    rng = np.random.RandomState(11)
    t = int(SE_SECONDS * SR)
    report, ok = {}, True
    for kind in SE_MODELS:
        card = se_model(kind).cuda()
        init_se_(card, gen)
        cpu = se_model(kind)
        cpu.load_state_dict(card.state_dict())
        noisy, clean = se_tones(rng, SE_B, t, 0 if kind == "dprnn" else SE_MICS)
        num_mic = torch.tensor(SE_NUM_MIC) if kind == "fasnet_tac" else None
        sides = {}
        for side, model, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
            model.train()  # cuDNN's LSTM keeps what its backward needs in training mode only
            x, c = torch.from_numpy(noisy).to(dev), torch.from_numpy(clean).to(dev)
            nm = None if num_mic is None else num_mic.to(dev)
            est = se_forward(kind, model, x, nm)
            loss = -si_snr(est, c).mean()
            loss.backward()
            sides[side] = (est.detach().cpu(), loss.item(),
                           {n: p.grad.cpu() for n, p in model.named_parameters()})
        (est_card, loss_card, g_card), (est_cpu, loss_cpu, g_cpu) = sides["card"], sides["cpu"]
        largest = max(float(g.abs().max()) for g in g_cpu.values())
        zero = SE_ZERO_GRAD_LEAVES.get(kind, ())
        worst, worst_name, over, zero_ok = 0.0, "", {}, True
        for name, g in g_cpu.items():
            if name in zero:  # rounding noise on both sides, held to the largest gradient
                err = max(float(g.abs().max()), float(g_card[name].abs().max())) / largest
                zero_ok &= err <= SE_TOL
            else:
                err = float((g_card[name] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                if err > SE_TOL:
                    over[name] = err
            if err > worst:
                worst, worst_name = err, name
        held_to_float64 = {}
        if over:  # held to the CPU's float64 step instead
            g64 = _se_step_grads(kind, cpu, noisy, clean, num_mic, torch.float64)
            for name in over:
                ref = g64[name]
                scale, norm = max(float(ref.abs().max()), 1e-30), max(float(ref.norm()), 1e-30)
                d = {side: g[name].double() - ref for side, g in (("card", g_card), ("cpu", g_cpu))}
                l2 = {side: float(v.norm()) / norm for side, v in d.items()}
                held_to_float64[name] = {
                    "card_vs_cpu": over[name],
                    **{f"max_abs_{side}_vs_float64": float(v.abs().max()) / scale
                       for side, v in d.items()},
                    **{f"rel_l2_{side}_vs_float64": v for side, v in l2.items()},
                    "bar": max(SE_CUDNN_TOL, 3 * l2["cpu"])}
        grads_ok = zero_ok and all(v["rel_l2_card_vs_float64"] <= v["bar"]
                                   for v in held_to_float64.values())
        worst64 = max((v["rel_l2_card_vs_float64"] for v in held_to_float64.values()),
                      default=None)
        out_err = float((est_card - est_cpu).abs().max()) / float(est_cpu.abs().max())
        loss_err = abs(loss_card - loss_cpu) / max(abs(loss_cpu), 1.0)
        report[kind] = {
            "input": list(noisy.shape), "num_mic": None if num_mic is None else list(SE_NUM_MIC),
            "params": sum(p.numel() for p in card.parameters()),
            "max_err_output_over_largest": out_err, "loss_card": loss_card,
            "loss_cpu": loss_cpu, "rel_err_loss": loss_err, "gradients": len(g_cpu),
            "max_rel_err_gradient": worst, "worst_gradient": worst_name,
            "zero_gradient_leaves": list(zero), "leaves_held_to_float64": held_to_float64,
            "max_rel_l2_card_vs_float64": worst64, "finite": bool(torch.isfinite(est_card).all()),
        }
        ok &= (out_err <= SE_TOL and loss_err <= SE_TOL and grads_ok
               and report[kind]["finite"] and set(g_card) == set(g_cpu))
        del card, cpu
    emit({"phase": "se_card_vs_cpu", "tol": SE_TOL, "tol_cudnn_vs_float64": SE_CUDNN_TOL,
          "seconds": SE_SECONDS, **report})
    if not ok:
        raise AssertionError("an SE model on the card disagrees with the CPU")
    return report


def phase_cli_se(root: str, smi: str) -> dict:
    """``main_extras se`` trains the DPRNN at SETask's defaults on a
    noisy/clean ``.npz`` this phase writes (80 one-second clips: 72 train,
    8 validate) for 10 epochs with a checkpoint; the validation clips'
    SI-SNR after enhancement must exceed the noisy input's.  The SE model
    launches no hand kernel."""
    from speechlid_tpu_torch.cli import main_extras

    noisy, clean = se_tones(np.random.RandomState(12), CLI_SE_CLIPS, int(CLI_SE_SECONDS * SR))
    exp = os.path.join(root, "se")
    os.makedirs(exp)
    data = os.path.join(exp, "pairs.npz")
    np.savez(data, noisy=noisy, clean=clean)
    torch.cuda.synchronize()
    reset_launches()
    trainer = main_extras.main(["se", "--data", data, "--epochs", str(CLI_SE_EPOCHS),
                                "--batch-size", str(CLI_SE_BATCH), "--lr", str(CLI_SE_LR),
                                "--no-progress", "--ckpt-dir", os.path.join(exp, "ckpt")])
    counted = launches()
    ckpt = os.path.join(exp, "ckpt", "last.ckpt")
    task, meta = SETask.resume_from_checkpoint(ckpt)
    split = int(CLI_SE_CLIPS * 0.9)
    with torch.no_grad():
        val_noisy = torch.from_numpy(noisy[split:]).cuda()
        val_clean = torch.from_numpy(clean[split:]).cuda()
        enhanced = si_snr(task._apply(val_noisy), val_clean).mean().item()
        before = si_snr(val_noisy, val_clean).mean().item()
    report = {"phase": "cli_se", "nvidia_smi": smi, "clips": CLI_SE_CLIPS,
              "clip_seconds": CLI_SE_SECONDS, "train_clips": split, "epochs": CLI_SE_EPOCHS,
              "batch": CLI_SE_BATCH, "lr": CLI_SE_LR, "steps": trainer.global_step,
              "val_si_snr_noisy_db": before, "val_si_snr_enhanced_db": enhanced,
              "ckpt_files": sorted(os.listdir(os.path.join(exp, "ckpt"))),
              "ckpt_epoch": meta["meta"].get("epoch"), "launches": counted,
              "hyper_parameters": task.hyper_parameters}
    emit(report)
    checks = {"learned": enhanced > before, "ckpt": os.path.exists(ckpt),
              "steps": trainer.global_step == CLI_SE_EPOCHS * -(-split // CLI_SE_BATCH),
              "no_hand_kernel": counted == launch_counts()}
    if not all(checks.values()):
        raise AssertionError(f"cli_se failed: {checks}")
    report["ckpt"] = ckpt
    return report


def phase_cli_eval_se(root: str, corpus: str, lid_ckpt: str, se_ckpt: str, inputs: tuple,
                      smi: str) -> dict:
    """``cli.test_lid`` on ``cli_flagship``'s checkpoint with ``--se-ckpt``
    from ``cli_se`` at one noise cell (white, 5 dB): without SE, at
    ``--factor 0.5``, and with ``--factor-sweep 0:1:0.5``.  Factor 0 scores
    as the run without SE (the sweep's first cell draws the same noise; a
    later cell draws on from the noise bank's generator, as in the JAX
    CLI); every eval batch launches the fbank kernel once and
    the fused eval conv kernel in each of the 14 encoder and 3 head blocks,
    at the shapes ``phase_fbank`` and ``phase_conv_fused`` hold against
    plain; the enhancement runs once for each utterance of a blended cell."""
    noise_dir, _ = inputs
    base = ["--ckpt", lid_ckpt, *_cli_args("configs", "lid_supervised", _langs_override(corpus)),
            "--snr", "5", "--noise", "white", "--noise-dir", noise_dir]
    want_batch = launch_counts(fbank=1, glu_bn_act=N_BLOCKS + N_LANG)
    want_shapes = {"fbank": {FBANK_SHAPES["eval"]}, "glu_bn_act": {EVAL_DW_SHAPE}}
    plain, plain_launches, plain_shapes = run_test_lid(base)
    half, half_launches, half_shapes = run_test_lid(
        base + ["--se-ckpt", se_ckpt, "--factor", "0.5"])
    rows, sweep_launches, sweep_shapes = run_test_lid(
        base + ["--se-ckpt", se_ckpt, "--factor-sweep", SE_FACTOR_SWEEP,
                "--csv", os.path.join(root, "se", "factor_sweep.jsonl")])
    n_utts = N_LANG * CORPUS_VAL
    keys = ("acc", "eer", "cavg", "eer_true", "cavg_true", "cer", "n_utts")
    per_batch = {name: {k: v / (cells * EVAL_BATCHES) for k, v in counted.items()}
                 for name, counted, cells in (("plain", plain_launches, 1),
                                              ("factor_0.5", half_launches, 1),
                                              ("sweep", sweep_launches, len(rows)))}
    report = {
        "phase": "cli_eval_se", "nvidia_smi": smi, "cell": "white, 5 dB",
        "no_se": _cell(plain, "white", 5.0), "factor_0.5": _cell(half, "white", 5.0),
        "sweep": [dict(_cell(r), factor=r["factor"]) for r in rows],
        "launches": {"no_se": plain_launches, "factor_0.5": half_launches,
                     "sweep": sweep_launches},
        "launches_per_eval_batch": per_batch, "batches_per_cell": EVAL_BATCHES,
        "kernel_shapes": {k: sorted(v) for k, v in sweep_shapes.items()},
    }
    checks = {
        "factors": [r["factor"] for r in rows] == [0.0, 0.5, 1.0],
        "factor_0_is_no_se": all(rows[0][k] == plain[k] for k in keys),
        "n_utts": all(r["n_utts"] == n_utts for r in (plain, half, *rows)),
        "finite": all(np.isfinite(r[k]) for r in (plain, half, *rows) for k in keys),
        "launches": all(v == want_batch for v in per_batch.values()),
        "shapes": plain_shapes == half_shapes == sweep_shapes == want_shapes,
    }
    report["checks"] = checks
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"cli_eval_se failed: {checks}")
    return report


def phase_serve_se(lid_ckpt: str, se_ckpt: str, gen: torch.Generator) -> dict:
    """One server with both checkpoints answers ``/lid`` and ``/se`` from
    four client threads at once: every ``/se`` answer has the request's
    length and equals the enhance hook on the request padded to its bucket
    (dither included) and trimmed; every ``/lid`` answer equals the direct
    call; the hand kernels launch for the ``/lid`` requests alone."""
    from concurrent.futures import ThreadPoolExecutor

    lid_fn, index2lang = build_lid_fn(lid_ckpt)
    se_fn = build_se_fn(se_ckpt)
    state = InferenceState(lid_fn, index2lang, se_fn=se_fn)
    state.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    wavs = [(0.1 * torch.randn(int(s * SR), generator=gen)).numpy() for s in SERVE_SECONDS]
    jobs = [(path, wav) for _ in range(SERVE_ROUNDS) for wav in wavs for path in ("/lid", "/se")]

    def post(job):
        path, wav = job
        req = urllib.request.Request(url + path, data=wav.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            body = resp.read()
        return path, wav, resp.status, body

    try:
        torch.cuda.synchronize()
        reset_launches()
        with ThreadPoolExecutor(max_workers=4) as pool:
            answers = list(pool.map(post, jobs))
        served = launches()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    worst_se, worst_lid, lengths_ok = 0.0, 0.0, True
    for path, wav, status, body in answers:
        if status != 200:
            raise AssertionError(f"{path}: status {status}")
        padded, n = state.pad(wav)
        if path == "/se":
            out = np.frombuffer(body, np.float32)
            lengths_ok &= out.shape == wav.shape
            direct = np.asarray(se_fn(padded[0]), np.float32)[:n]
            worst_se = max(worst_se, float(np.abs(out - direct).max()))
        else:
            scores = json.loads(body)["scores"]
            got = np.array([scores[index2lang[i]] for i in range(N_LANG)], np.float32)
            worst_lid = max(worst_lid, float(np.abs(got - lid_fn(padded, n)[0]).max()))
    n_lid = sum(path == "/lid" for path, *_ in answers)
    report = {"phase": "serve_se", "requests": {"/lid": n_lid, "/se": len(answers) - n_lid},
              "client_threads": 4, "seconds": list(SERVE_SECONDS),
              "max_abs_diff_se_vs_direct": worst_se, "max_abs_diff_lid_vs_direct": worst_lid,
              "launches": served}
    emit(report)
    ok = (lengths_ok and worst_se == 0.0 and worst_lid == 0.0 and not thread.is_alive()
          and served == {k: v * n_lid for k, v in PER_FORWARD_LAUNCHES.items()})
    if not ok:
        raise AssertionError("serve_se failed")
    return report


def phase_bilstm_card_vs_cpu(gen: torch.Generator) -> dict:
    """``LidASRTask(head_type="bilstm")`` at the flagship's width (14 ×
    144-d Conformer; per language a bidirectional LSTM of 72 a direction
    and a Linear) on ragged B = 8, 4 s clips: ``infer`` on the card against
    the CPU (the packed LSTMs leave zeros at padded frames on both), and
    one deterministic train step with the CPU given the card's features and
    subsampling ReLU decisions (``pin_subsampling_relus``).  The heads have
    no conv module: 14 conv kernels a forward, 14 of each training mode a
    step."""
    task = LidASRTask(**BILSTM, device="cuda")
    init_random_(task.model, gen)
    cpu = LidASRTask(**BILSTM, device="cpu")
    cpu.model.load_state_dict(task.model.state_dict())
    batch = synthetic_batch(np.random.RandomState(2), lang=1, b=TRAIN_B, seconds=TRAIN_SECONDS)
    wavs, lengths = torch.from_numpy(batch["wavs"]), torch.from_numpy(batch["wav_lengths"])
    got, ref, per_forward, errs = infer_card_vs_cpu(task, cpu, wavs, lengths)
    del task, cpu
    step = conformer_step_card_vs_cpu(dict(CONFORMER_DETERMINISTIC, head_type="bilstm"), gen,
                                      batch)
    report = {"phase": "bilstm_card_vs_cpu", "config": "flagship 14x144, bilstm heads 3x72x2",
              "batch": [TRAIN_B, int(TRAIN_SECONDS * SR)], "lengths": lengths.tolist(),
              **errs, "pred_lang": got["pred_lang"].tolist(),
              "pred_lang_cpu": ref["pred_lang"].tolist(), "tol": MODEL_TOL,
              "launches_per_forward": per_forward, "train_tol": TRAIN_TOL, "step": step}
    emit(report)
    checks = {
        "scores": errs["max_abs_err_scores"] <= MODEL_TOL,
        "pred_lang": torch.equal(got["pred_lang"], ref["pred_lang"]),
        "finite": bool(torch.isfinite(got["scores"]).all()),
        "forward_launches": per_forward == BILSTM_PER_FORWARD_LAUNCHES,
        "step": (step["same_leaves"] and abs(step["loss_card"] - step["loss_cpu"]) <= TRAIN_TOL
                 and step["max_rel_err_gradient"] <= TRAIN_TOL),
        "step_launches": step["launches_per_train_step"] == BILSTM_TRAIN_STEP_LAUNCHES,
    }
    if not all(checks.values()):
        raise AssertionError(f"bilstm_card_vs_cpu failed: {checks}")
    return report


def phase_se(gen: torch.Generator, root: str, corpus: str, inputs: tuple, smi: str) -> tuple:
    """The SE and bilstm phases in order, on ``cli_flagship``'s checkpoint;
    → (``cli_eval_se``'s report, ``bilstm_card_vs_cpu``'s)."""
    lid_ckpt = os.path.join(root, "flagship", "ckpt", "last.ckpt")
    phase_se_card_vs_cpu(gen)
    se_ckpt = phase_cli_se(root, smi)["ckpt"]
    eval_se = phase_cli_eval_se(root, corpus, lid_ckpt, se_ckpt, inputs, smi)
    phase_serve_se(lid_ckpt, se_ckpt, gen)
    return eval_se, phase_bilstm_card_vs_cpu(gen)


def se_bilstm_kernel_rows(gen: torch.Generator, errs: dict, eval_se: dict,
                          bilstm: dict) -> list:
    """The ``kernels`` line's rows of the SE eval path (the eval CLI's
    batches after the blend, launches counted on ``cli_eval_se``'s three
    runs) and of the bilstm joint model (launches counted on
    ``bilstm_card_vs_cpu``'s forward and step), at the shapes they ran."""
    total = {k: sum(c[k] for c in eval_se["launches"].values())
             for k in eval_se["launches"]["no_se"]}
    on_eval = ("cli_eval_se: lid_supervised.yaml checkpoint, white 5 dB, no SE, --factor 0.5 "
               f"and --factor-sweep {SE_FACTOR_SWEEP}: 5 cells of {EVAL_BATCHES} batches")
    rows = [fbank_row("fbank_log_mel@eval_se", "eval", gen, errs, total["fbank"], {
        "launches_counted_on": on_eval, "launches_per_eval_batch": 1})]
    forward, step = bilstm["launches_per_forward"], bilstm["step"]["launches_per_train_step"]
    on_bilstm = "bilstm_card_vs_cpu: one infer and one train step at (8, 4 s)"
    rows.append(fbank_row("fbank_log_mel@bilstm", "train", gen, errs,
                          forward["fbank"] + step["fbank"], {
                              "launches_counted_on": on_bilstm,
                              "launches_per_forward": 1, "launches_per_train_step": 1}))
    rows += fused_kernel_rows(gen, errs["conv_fused"], {
        "depthwise_conv1d_fwd[glu_bn_act]@eval_se": (total["depthwise_glu_bn_act"], {
            "launches_counted_on": on_eval, "launches_per_eval_batch": N_BLOCKS + N_LANG}),
        "depthwise_conv1d_fwd[glu_bn_act]@bilstm": (forward["depthwise_glu_bn_act"], {
            "launches_counted_on": on_bilstm, "launches_per_forward": N_BLOCKS}),
        "depthwise_conv1d_fwd[glu]@bilstm": (step["depthwise_glu"], {
            "launches_counted_on": on_bilstm, "launches_per_train_step": N_BLOCKS}),
        "depthwise_conv1d_fwd[glu_dx]@bilstm": (step["depthwise_glu_dx"], {
            "launches_counted_on": on_bilstm, "launches_per_train_step": N_BLOCKS}),
    }, eval_rows=(("depthwise_conv1d_fwd[glu_bn_act]@eval_se", EVAL_DW_SHAPE),
                  ("depthwise_conv1d_fwd[glu_bn_act]@bilstm", TRAIN_DW_SHAPE)),
        train_shape=TRAIN_DW_SHAPE, train_suffix="@bilstm")
    row = bwd_w_row(gen, errs["conv_fused"], TRAIN_DW_SHAPE, "depthwise_conv1d_bwd_w@bilstm",
                    step, 1)
    row["launches_counted_on"] = on_bilstm
    rows.append(row)
    return rows


# --------------------------------------------- the int8 engine, SWA and Novograd
# The int8 W8A8 engine (ops/quant.py) is torch._int_mm (cuBLASLt) between a
# quantize and a rescale in PyTorch: the JAX package computes it in XLA, in
# no Pallas kernel, so it has no hand kernel of its own.  Its paths run both
# hand kernels: the Conformer's fbank and conv modules, the WavLM heads'
# conv modules (bfloat16 under the QAT config).  SWA and Novograd train the
# flagship through the CLI, which runs the kernels' training modes.

INT8_PEAK_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate, at 700 W
# the rescale float(out32) · (row · col): three float32 roundings of half an
# ulp each (out32 passes 2^24 at K = 3072) against its float64 value
RESCALE_ULPS = 1.5
V_OUT = max(FLAGSHIP["lang2vocab"].values()) + 1  # a head's Linear(V + 1)
# every quantized Linear shape (K → N) of the two flagship paths, the
# projections that share one named together
QUANT_DENSE_SHAPES = {
    "conformer": ((144, 576, "FFN fc1, conv pointwise_in"), (576, 144, "FFN fc2"),
                  (144, 256, "to_q"), (144, 512, "to_kv"), (256, 144, "to_out"),
                  (288, 144, "conv pointwise_out"), (144, V_OUT, "head out")),
    "wavlm": ((768, 768, "q/k/v/out_proj"), (768, 3072, "fc1; head FFN fc1, pointwise_in"),
              (3072, 768, "head FFN fc2"), (768, 256, "head to_q"), (768, 512, "head to_kv"),
              (256, 768, "head to_out"), (1536, 768, "head pointwise_out"),
              (768, V_OUT, "head out")),
    # the framed extractor GEMMs (k · Cin → 512) of conv_extractor_impl="matmul"
    "wavlm_extractor": ((10, 512, "conv_0 (10, 5) framed"),
                        (1536, 512, "conv_1..4 (3, 2) framed"),
                        (1024, 512, "conv_5..6 (2, 2) framed")),
}


def _extractor_frames(seconds: float) -> list:
    """Frames out of each layer of the WavLM extractor for a clip."""
    t, out = int(seconds * SR), []
    for _, k, s in [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2:
        t = (t - k) // s + 1
        out.append(t)
    return out


# rows of each shape: a B = 1 request of 0.7 s, and B = 32 clips of 3 s
QUANT_DENSE_ROWS = {
    "conformer": (_encoder_frames(0.7), 32 * _encoder_frames(3.0)),
    "wavlm": (_wavlm_frames(0.7), 32 * _wavlm_frames(3.0)),
    "wavlm_extractor": {10: (_extractor_frames(0.7)[0], 32 * _extractor_frames(3.0)[0]),
                        1536: (_extractor_frames(0.7)[1], 32 * _extractor_frames(3.0)[1]),
                        1024: (_extractor_frames(0.7)[5], 32 * _extractor_frames(3.0)[5])},
}
# shapes given to torch._int_mm unpadded, to find what it refuses on the card
INT_MM_PROBES = ((16, 16, 16), (17, 16, 16), (24, 16, 16), (33, 16, 16), (17, 10, 16),
                 (17, 12, 16), (17, 16, 97), (17, 16, 12), (1, 768, 768), (2368, 144, 576))

QUANT_MODELS = {
    "conformer": dict(hp=FLAGSHIP, per_forward=PER_FORWARD_LAUNCHES, base_tol=MODEL_TOL,
                      config="flagship 14x144, heads 3x(40,96,88), float32"),
    "wavlm_bf16": dict(hp=dict(WAVLM, dtype="bfloat16", ssl_config=WAVLM_BASE_PLUS_BF16),
                       per_forward=WAVLM_BF16_PER_FORWARD_LAUNCHES, base_tol=BF16_SCORE_TOL,
                       config="WavLM-Base+ 12x768 + heads 3x(40,96,88) at 768, bfloat16"),
}
# card against CPU int8 scores: the bar is the larger of the model's own
# card-vs-CPU bar (exact engine) and QUANT_SPREAD times the CPU's own int8
# spread, its scores moved by a one-ulp nudge of the request's wave (a code
# at a rounding boundary flips on an ulp upstream, and a flipped code moves
# its output by a step of its scale: the tests measured the port against
# JAX at 0.85-1.0 times JAX's own one-ulp flips, tests/test_torch_quant_task.py)
QUANT_SPREAD = 3.0
QUANT_SETTINGS = ("int8", "bfloat16+int8")  # the launches only phase_quant_launches checks
# the QAT config at the Base+ width: 2 epochs (the first with the encoder
# frozen, its freeze gates at 0) of 3 steps of 8 clips, each with an eval
QAT_DATA_FACTOR = 0.1
QAT_STEPS = int(N_LANG * CORPUS_TRAIN // 8 * QAT_DATA_FACTOR)
QAT_FROZEN = {0: {"feature_extractor", "post_extract_proj", "layers", "pos_conv",
                  "encoder_layer_norm"}, 1: set()}
QAT_STEP_HP = dict(WAVLM_DETERMINISTIC, dtype="bfloat16", quant_dot="int8_ste",
                   ssl_conv_impl="matmul")
# SWA: the flagship through the CLI for 4 epochs of 9 steps; int(4 · 0.7) = 2,
# so epochs 2 and 3 are averaged; then BatchNorm passes over the 36 train
# batches until 0.9^seed < 5e-3: two passes
SWA_EPOCHS, SWA_START = 4, 2
SWA_BN_BATCHES = 2 * CLI_EPOCH_STEPS
SWA_BN_LAUNCHES = launch_counts(fbank=1, glu=DW_PER_TRAIN_STEP)  # a train-mode forward
NOVOGRAD_EPOCHS = 3


class CountIntMM:
    """Counts the ``torch._int_mm`` calls made inside the ``with`` block
    (``ops/quant.py`` looks it up at every call)."""

    def __enter__(self):
        self.calls, self._int_mm = 0, torch._int_mm

        def counted(*args, **kwargs):
            self.calls += 1
            return self._int_mm(*args, **kwargs)

        torch._int_mm = counted
        return self

    def __exit__(self, *exc):
        torch._int_mm = self._int_mm


def int_mm_per_forward(model: torch.nn.Module, heads: int = None) -> int:
    """``_int_mm`` calls of one forward of ``model``: its int8 Linears (of
    the featurizer and of ``heads`` heads, all by default) and its framed
    extractor layers."""
    from speechlid_tpu_torch.models.conformer import Linear

    n = 0
    for name, m in model.named_modules():
        if isinstance(m, Linear) and m.dot is not None:
            head = name.split(".")[2] if name.startswith("heads.heads.") else None
            n += head is None or heads is None or int(head) < heads
        n += getattr(m, "framed_dot", None) is not None and m.n_layers
    return n


def quant_dense_case(x: torch.Tensor, w: torch.Tensor, timed: bool) -> dict:
    """One quantized product on the card: codes against the CPU's on the
    same float input, ``_int_mm``'s int32 sums against the float64 oracle,
    the output against the exact rescale of those sums; with ``timed`` the
    times of it, of ``F.linear`` in float32 and bfloat16, and its split."""
    row, col = quant.scales(x), quant.scales(w)
    xq, wq = quant.quantize(x, row), quant.quantize(w, col)
    xc, wc = x.cpu(), w.cpu()
    codes_equal = (torch.equal(xq.cpu(), quant.quantize(xc, quant.scales(xc)))
                   and torch.equal(wq.cpu(), quant.quantize(wc, quant.scales(wc))))
    out32 = quant.int8_matmul(xq, wq)
    int32_equal = torch.equal(out32, quant.int8_matmul_reference(xq, wq))
    y = quant.int8_dot(x, w)
    exact = out32.double() * (row.double() * col.double()[:, 0])
    ulps = ((y.double() - exact).abs() / torch.finfo(torch.float32).eps
            / exact.abs().clamp_min(torch.finfo(torch.float32).tiny)).max().item()
    out = {"codes_equal_cpu": codes_equal, "int32_equal_reference": int32_equal,
           "max_rescale_error_ulps": ulps, "equal_reference_dot": torch.equal(
               y, quant.int8_linear_reference(x, w))}
    if timed:
        (m, k), n = x.shape, w.shape[0]
        xb, wb = x.bfloat16(), w.bfloat16()
        col_row = col[:, 0]
        b_ms, b_by = bound_ms(4.0 * (m * k + n * k + m * n), 0.0)
        ops_ms = 2.0 * m * k * n / INT8_PEAK_OPS * 1e3
        out.update({
            "ms_f32_linear": device_ms(lambda: F.linear(x, w)),
            "ms_bf16_linear": device_ms(lambda: F.linear(xb, wb)),
            "ms_int8": device_ms(lambda: quant.int8_dot(x, w)),
            "ms_int8_bf16": device_ms(lambda: quant.int8_dot(xb, wb)),
            "ms_quantize": device_ms(lambda: (quant.quantize(x, quant.scales(x)),
                                              quant.quantize(w, quant.scales(w)))),
            "ms_int_mm": device_ms(lambda: quant.int8_matmul(xq, wq)),
            "ms_rescale": device_ms(lambda: out32.float() * (row * col_row)),
            "bound_ms_int8": max(b_ms, ops_ms),
            "bound_by_int8": b_by if b_ms >= ops_ms else "operations"})
    return out


def int_mm_limits() -> dict:
    """What ``torch._int_mm`` takes on the card unpadded: (rows, K, N) →
    "ok" or its error's first line; both weight layouts at one shape."""
    out = {}
    for m, k, n in INT_MM_PROBES:
        a = torch.ones(m, k, dtype=torch.int8, device="cuda")
        for layout, b in (("column-major", torch.ones(n, k, dtype=torch.int8,
                                                      device="cuda").t()),
                          ("row-major", torch.ones(k, n, dtype=torch.int8, device="cuda"))):
            if layout == "row-major" and (m, k, n) != (17, 16, 16):
                continue
            try:
                got = torch._int_mm(a, b)
                torch.cuda.synchronize()
                out[f"{m}x{k}x{n} {layout}"] = "ok" if int(got[0, 0]) == k else "wrong"
            except RuntimeError as e:
                out[f"{m}x{k}x{n} {layout}"] = str(e).splitlines()[0][:160]
    return out


def phase_quant_dense(gen: torch.Generator, smi: str) -> dict:
    """Every quantized Linear shape of the two flagship paths (and the
    framed extractor's), at the rows of a B = 1 request of 0.7 s and of
    B = 32 clips of 3 s: the card's codes equal the CPU's, ``_int_mm``'s
    int32 sums equal the float64 oracle's bit for bit, the output lies
    within the rescale's rounding (``RESCALE_ULPS``) and equals the
    oracle's product;
    at B = 32 the times against ``F.linear`` in float32 and bfloat16, and
    the quantize / ``_int_mm`` / rescale split (B = 1 is checked, not timed:
    its times were launch-bound noise).  Also what ``_int_mm`` refuses
    unpadded."""
    strict_float32(torch.device("cuda"))
    cases, ok = [], True
    for path, shapes in QUANT_DENSE_SHAPES.items():
        for k, n, what in shapes:
            rows = (QUANT_DENSE_ROWS[path][k] if path == "wavlm_extractor"
                    else QUANT_DENSE_ROWS[path])
            w = (k ** -0.5 * torch.randn(n, k, generator=gen)).cuda()
            for i, m in enumerate(rows):
                x = torch.randn(m, k, generator=gen).cuda()
                case = {"path": path, "layers": what, "m": m, "k": k, "n": n,
                        "padded_to": list(quant.int_mm_shape(m, k, n)),
                        **quant_dense_case(x, w, timed=i == 1)}
                ok &= (case["codes_equal_cpu"] and case["int32_equal_reference"]
                       and case["max_rescale_error_ulps"] <= RESCALE_ULPS
                       and case["equal_reference_dot"])
                cases.append(case)
                del x
            torch.cuda.empty_cache()
    limits = int_mm_limits()
    report = {"phase": "quant_dense", "nvidia_smi": smi, "cases": cases,
              "int_mm_unpadded": limits, "ok": bool(ok)}
    emit(report)
    if not ok:
        raise AssertionError("the int8 products on the card disagree with their oracles")
    return report


def _serve_cli(argv: list) -> tuple:
    """``cli.serve.main(argv)`` in a thread, as a user starts it; → (its
    URL, the server, the thread) once it listens (after its warm-up)."""
    from speechlid_tpu_torch.cli import serve as serve_cli

    servers = []

    class Listening(ThreadingHTTPServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            servers.append(self)

    thread = threading.Thread(target=serve_cli.main, args=(argv,), daemon=True)
    serve_cli.ThreadingHTTPServer = Listening
    try:
        thread.start()
        deadline = time.monotonic() + 600
        while not servers and thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        serve_cli.ThreadingHTTPServer = ThreadingHTTPServer
    if not servers:
        raise AssertionError(f"serve {' '.join(argv)} did not start")
    return f"http://127.0.0.1:{servers[0].server_address[1]}", servers[0], thread


def phase_quant_serve(root: str, gen: torch.Generator, smi: str) -> dict:
    """``serve --quant int8`` (``cli.serve.main`` in a thread) on a
    checkpoint of each model with seeded random weights: the 10 ``/lid``
    requests of ``serve``; the launches and ``_int_mm`` calls of exactly
    those requests; ``/stats`` naming the engine; the card's int8 scores
    against the CPU's int8 scores on the same padded requests, within the
    larger of the model's card-vs-CPU bar and ``QUANT_SPREAD`` times the
    CPU's one-ulp spread; and the card's int8 scores against its exact
    ones of the same weights (their distance and ``pred_lang``
    agreement)."""
    out = {}
    for model, spec in QUANT_MODELS.items():
        task = LidASRTask(**spec["hp"], device="cuda")
        init_model_("conformer" if model == "conformer" else "wavlm", task, gen)
        ckpt = os.path.join(root, f"quant_{model}.ckpt")
        save_checkpoint(ckpt, {"model": task.model.state_dict()},
                        {"hyper_parameters": task.hyper_parameters})
        exact_fn = make_lid_fn(task)
        url, server, thread = _serve_cli(["--ckpt", ckpt, "--quant", "int8", "--port", "0"])
        wavs = [(0.1 * torch.randn(int(s * SR), generator=gen)).numpy() for s in SERVE_SECONDS]
        answers = []
        try:
            torch.cuda.synchronize()
            reset_launches()
            with CountIntMM() as mm:
                for _ in range(SERVE_ROUNDS):
                    for i, wav in enumerate(wavs):
                        req = urllib.request.Request(url + "/lid", data=wav.tobytes(),
                                                     method="POST")
                        with urllib.request.urlopen(req, timeout=300) as resp:
                            answers.append((i, json.loads(resp.read())))
            served = launches()
            stats = _get(url + "/stats")
        finally:
            server.shutdown()
            thread.join(timeout=60)
        cpu_fn, index2lang = build_lid_fn(ckpt, "cpu", "int8")
        pad = InferenceState(None, index2lang).pad
        per_wav = []
        for wav in wavs:
            padded, n = pad(wav)
            nudged, _ = pad(np.nextafter(wav, np.float32(np.inf)).astype(np.float32))
            per_wav.append({"cpu": cpu_fn(padded, n)[0], "cpu_nudged": cpu_fn(nudged, n)[0],
                            "card_exact": exact_fn(padded, n)[0]})
        langs = [index2lang[i] for i in range(N_LANG)]
        card = [np.array([body["scores"][lang] for lang in langs]) for _, body in answers]
        largest = max(float(np.abs(p["cpu"]).max()) for p in per_wav)
        spread = max(float(np.abs(p["cpu"] - p["cpu_nudged"]).max()) for p in per_wav)
        base = spec["base_tol"] * (largest if model != "conformer" else 1.0)
        bar = max(base, QUANT_SPREAD * spread)
        err = max(float(np.abs(c - per_wav[i]["cpu"]).max())
                  for c, (i, _) in zip(card, answers))
        to_exact = max(float(np.abs(c - per_wav[i]["card_exact"]).max())
                       for c, (i, _) in zip(card, answers))
        agree = [int(np.argmax(c)) == int(np.argmax(per_wav[i]["card_exact"]))
                 for c, (i, _) in zip(card, answers)]
        n_req = len(answers)
        mm_per_forward = int_mm_per_forward(build_int8_model(spec["hp"]))
        report = {
            "phase": f"quant_serve_{model}", "nvidia_smi": smi, "config": spec["config"],
            "argv": "serve --ckpt ... --quant int8", "requests": n_req,
            "seconds": list(SERVE_SECONDS), "launches": served, "int_mm_calls": mm.calls,
            "int_mm_per_request": mm.calls / n_req, "int_mm_per_forward": mm_per_forward,
            "stats_engine": stats.get("engine"), "stats": stats,
            "max_abs_err_scores_vs_cpu_int8": err, "largest_score": largest,
            "cpu_one_ulp_spread": spread, "bar": bar, "bar_rule": (
                f"max({spec['base_tol']}{' x largest' if model != 'conformer' else ''}, "
                f"{QUANT_SPREAD} x cpu_one_ulp_spread)"),
            "max_abs_diff_int8_vs_exact_on_card": to_exact,
            "pred_lang_agree_int8_vs_exact": sum(agree) / len(agree),
            "scores_card_int8": [c.tolist() for c in card[:len(wavs)]],
            "scores_card_exact": [p["card_exact"].tolist() for p in per_wav],
        }
        emit(report)
        checks = {
            "answers": all(set(b) == {"lang", "scores"} for _, b in answers)
            and all(np.isfinite(c).all() for c in card),
            "repeatable": all(np.array_equal(card[j], card[j + len(wavs)])
                              for j in range(len(wavs))),
            "scores_vs_cpu": err <= bar,
            "launches": served == {k: v * n_req for k, v in spec["per_forward"].items()},
            "int_mm": mm.calls == mm_per_forward * n_req,
            "engine": stats.get("engine") == "int8" and not thread.is_alive(),
        }
        if not all(checks.values()):
            raise AssertionError(f"quant_serve_{model} failed: {checks}")
        out[model] = report
        del task
        gc.collect()
        torch.cuda.empty_cache()
    return out


def build_int8_model(hp: dict) -> torch.nn.Module:
    """The model of ``hp`` under ``quant_dot="int8"`` on the CPU (its
    structure only: for counting its int8 products)."""
    return LidASRTask(**dict(hp, quant_dot="int8"), device="cpu").model


def _setting_hp(model: str, setting: str) -> dict:
    hp = dict(FLAGSHIP if model == "conformer" else WAVLM)
    if setting.startswith("bfloat16"):
        hp["dtype"] = "bfloat16"
        if model == "wavlm":
            hp["ssl_config"] = WAVLM_BASE_PLUS_BF16
    if setting.endswith("int8"):
        hp["quant_dot"] = "int8"
    return hp


def phase_quant_launches(gen: torch.Generator) -> None:
    """The launches of ``INFER_CALLS`` calls of ``infer`` on 3 s clips at
    B = 1 and B = 32, both models, in the int8 and bfloat16 + int8 settings
    (the float32 model's weights; int8 as ``serve --quant int8`` builds it
    from a checkpoint, so WavLM's extractor stays the conv), checked.  The
    float32 and bfloat16 settings' launches are checked by
    :func:`flagship_kernel_rows`, :func:`phase_wavlm_launches` and
    :func:`phase_bf16_launches`."""
    counts = {}
    for model in ("conformer", "wavlm"):
        weights = LidASRTask(**_setting_hp(model, "float32"), device="cuda")
        init_model_(model, weights, gen)
        for s in QUANT_SETTINGS:
            task = LidASRTask(**_setting_hp(model, s), device="cuda")
            task.model.load_state_dict(weights.model.state_dict())
            expect = {("conformer", "int8"): PER_FORWARD_LAUNCHES,
                      ("wavlm", "int8"): WAVLM_PER_FORWARD_LAUNCHES,
                      ("conformer", "bfloat16+int8"): BF16_PER_FORWARD_LAUNCHES,
                      ("wavlm", "bfloat16+int8"): WAVLM_BF16_PER_FORWARD_LAUNCHES}[model, s]
            counts[f"{model} {s}"] = infer_launches(task, gen, expect, f"{model} {s}")
            del task
        del weights
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "quant_launches", "settings": list(QUANT_SETTINGS), "launches": counts})


def phase_cli_qat(root: str, corpus: str, smi: str) -> dict:
    """The training CLI on ``configs/lid_wavlm_qat.yaml`` (bfloat16 heads,
    ``int8_ste``, the framed extractor) with ``module.ssl_config`` at the
    Base+ shape, on the corpus: two epochs of 3 steps (the first with the
    encoder frozen by the config's gates at 0), each with an eval of the 72
    val clips; the launches per train step and eval batch, every depthwise
    launch in bfloat16, the conv shapes, the ``_int_mm`` calls of every
    step and eval batch (the encoder's, the framed extractor's and the
    heads' int8 products), finite losses.  Then one deterministic QAT step
    (B = 2, 2 s) on the card against the same step on the CPU and a
    float32 ``int8_ste`` step on the card: the bfloat16 step's bars
    (:func:`phase_bf16_train_card_vs_cpu`)."""
    from speechlid_tpu_torch.cli import main_lid

    exp = os.path.join(root, "qat")
    args = _cli_args("configs", "lid_wavlm_qat", _langs_override(corpus), f"exp_dir={exp}",
                     "trainer.progress_bar=false", f"trainer.train_data_factor={QAT_DATA_FACTOR}",
                     "trainer.total_epoch=2", WAVLM_SSL_OVERRIDE)
    frozen, shapes, built = {}, set(), []
    build_task = main_lid.build_task

    def recording_build_task(conf, data, device="cuda"):
        task = build_task(conf, data, device)
        built.append(task)
        before = task.before_train_loop

        def record(epoch):
            before(epoch)
            frozen[epoch] = sorted({n.split(".")[2] for n, p in task.model.named_parameters()
                                    if not p.requires_grad})
        task.before_train_loop = record
        return task

    def conv_seen(module, inputs, output):
        if isinstance(module, ConformerConvModule):
            k, c = module.depthwise.weight.shape
            shapes.add((*inputs[0].shape[:2], c, k))

    main_lid.build_task = recording_build_task
    hook = torch.nn.modules.module.register_module_forward_hook(conv_seen)
    try:
        torch.cuda.synchronize()
        reset_launches()
        with CountIntMM() as mm:
            recorder = run_cli(args)
        counted = launches()
    finally:
        main_lid.build_task = build_task
        hook.remove()
    (task,) = built
    per_step, per_eval = _per_step(recorder)
    steps = sum(e["steps"] for e in recorder.epochs)
    evals = sum(e["batches"] for e in recorder.evals)
    mm_train = int_mm_per_forward(task.model, heads=1)  # the batch's own head
    mm_eval = int_mm_per_forward(task.model)
    lines = _metrics_lines(os.path.join(exp, "metrics.jsonl"))
    losses = [line["loss"] for line in lines if "loss" in line]
    eval_lines = [line for line in lines if CLI_EVAL_KEYS <= set(line)]

    card = LidASRTask(**QAT_STEP_HP, device="cuda")
    cpu = LidASRTask(**QAT_STEP_HP, device="cpu")
    reference = LidASRTask(**as_float32(QAT_STEP_HP), device="cuda")
    init_wavlm_(card, torch.Generator().manual_seed(11))
    cpu.model.load_state_dict(card.model.state_dict())
    reference.model.load_state_dict(card.model.state_dict())
    batch = synthetic_batch(np.random.RandomState(6), lang=1, b=2, seconds=2.0)
    step = step_card_vs_cpu(card, cpu, batch, ("depthwise.bias", "k_proj.bias"),
                            reference=reference, tol=BF16_GRAD_TOL)
    report = {
        "phase": "cli_qat", "nvidia_smi": smi,
        "config": "configs/lid_wavlm_qat.yaml, module.ssl_config WavLM-Base+",
        "epochs": recorder.epochs, "eval_batches": [e["batches"] for e in recorder.evals],
        "frozen_by_epoch": frozen,
        "launches": counted, "launches_per_train_step": per_step,
        "launches_per_eval_batch": per_eval, "conv_shapes": sorted(shapes),
        "int_mm_calls": mm.calls, "int_mm_per_train_forward": mm_train,
        "int_mm_per_eval_forward": mm_eval, "losses": losses, "evals": eval_lines,
        "step_card_vs_cpu": {"batch": [2, 2 * SR], "tol_loss": BF16_LOSS_TOL,
                             "tol_gradient": BF16_GRAD_TOL, **step}}
    emit(report)
    checks = {
        "steps": [e["steps"] for e in recorder.epochs] == [QAT_STEPS] * 2,
        "evals": len(eval_lines) == 2 and all(np.isfinite(e["avg_val_loss"]) for e in eval_lines),
        "losses": len(losses) > 0 and bool(np.isfinite(losses).all()),
        "frozen": {e: set(v) for e, v in frozen.items()} == QAT_FROZEN,
        "launches": per_step == WAVLM_BF16_TRAIN_STEP_LAUNCHES
        and per_eval == WAVLM_BF16_PER_FORWARD_LAUNCHES,
        "conv_shapes": shapes == {WAVLM_BF16_CLI_DW_SHAPE},
        "int_mm": mm.calls == steps * mm_train + evals * mm_eval and mm_train > 0,
        "step": step["same_leaves"] and step["rel_err_loss"] <= BF16_LOSS_TOL
        and step["max_card_over_bar"] <= 1.0
        and step["rel_l2_card_vs_float32"] <= 2 * step["rel_l2_cpu_vs_float32"] + 1e-3
        and step["launches_per_train_step"] == WAVLM_BF16_TRAIN_STEP_LAUNCHES,
    }
    if not all(checks.values()):
        raise AssertionError(f"cli_qat failed: {checks}")
    report["_counted"] = counted
    return report


def phase_cli_eval_quant(root: str, corpus: str, ckpt: str, smi: str) -> dict:
    """``test_lid --quant int8`` on ``cli_flagship``'s checkpoint, clean,
    beside the same run without ``--quant``: both score the 72 val clips,
    each eval batch launches the fbank kernel once and the fused eval conv
    kernel in every block, the int8 run makes every block's and head's
    ``_int_mm`` calls, at the eval shapes held against plain."""
    base = ["--ckpt", ckpt, *_cli_args("configs", "lid_supervised", _langs_override(corpus))]
    exact, exact_launches, _ = run_test_lid(base)
    with CountIntMM() as mm:
        quant_run, counted, shapes = run_test_lid(base + ["--quant", "int8"])
    want = launch_counts(fbank=1, glu_bn_act=DW_PER_FORWARD)
    mm_per_batch = int_mm_per_forward(build_int8_model(FLAGSHIP))
    report = {"phase": "cli_eval_quant", "nvidia_smi": smi,
              "checkpoint": os.path.relpath(ckpt, root), "exact": _cell(exact),
              "int8": _cell(quant_run),
              "launches_per_batch": {k: v / EVAL_BATCHES for k, v in counted.items()},
              "int_mm_calls": mm.calls, "int_mm_per_batch": mm.calls / EVAL_BATCHES,
              "kernel_shapes": {k: sorted(v) for k, v in shapes.items()}, "_counted": counted}
    emit({k: v for k, v in report.items() if not k.startswith("_")})
    checks = {
        "utts": exact["n_utts"] == quant_run["n_utts"] == N_LANG * CORPUS_VAL,
        "finite": all(np.isfinite(quant_run[k]) for k in ("eer", "cavg", "cer")),
        "launches": {k: v / EVAL_BATCHES for k, v in counted.items()} == want
        and {k: v / EVAL_BATCHES for k, v in exact_launches.items()} == want,
        "int_mm": mm.calls == mm_per_batch * EVAL_BATCHES,
        "shapes": shapes == {"fbank": {FBANK_SHAPES["eval"]}, "glu_bn_act": {EVAL_DW_SHAPE}},
    }
    if not all(checks.values()):
        raise AssertionError(f"cli_eval_quant failed: {checks}")
    return report


class _SnapshotRecorder(_CliRecorder):
    """:class:`_CliRecorder` that also keeps, after each train epoch, the
    model's parameters and buffers on the host, and the optimizer's name
    and second-moment keys."""

    def after_train_epoch(self, epoch, metrics):
        self.epochs_state = getattr(self, "epochs_state", [])
        self.epochs_state.append({k: v.detach().cpu().clone()
                                  for k, v in self.trainer.module.model.state_dict().items()})
        opt = self.trainer.optimizer
        self.optimizer_info = {"name": opt.name, "tensors": len(opt.names),
                               "second_moments": len(getattr(opt, "nu_names", opt.names))}
        super().after_train_epoch(epoch, metrics)


def _run_flagship_cli(root: str, corpus: str, name: str, *overrides: str) -> tuple:
    """``lid_supervised.yaml`` (the flagship) through the CLI on the corpus
    with 9 steps an epoch, the launches counted from 0; → (recorder,
    launches, metrics lines, experiment dir)."""
    exp = os.path.join(root, name)
    args = _cli_args("configs", "lid_supervised", _langs_override(corpus), f"exp_dir={exp}",
                     "trainer.progress_bar=false",
                     f"trainer.train_data_factor={FLAGSHIP_DATA_FACTOR}", *overrides)
    torch.cuda.synchronize()
    reset_launches()
    recorder = run_cli(args, _SnapshotRecorder)
    return recorder, launches(), _metrics_lines(os.path.join(exp, "metrics.jsonl")), exp


def phase_cli_swa(root: str, corpus: str, smi: str) -> dict:
    """``main_lid`` on the flagship with ``trainer.use_swa=true`` for 4
    epochs: ``swa_final.ckpt`` exists, its parameters are the mean of
    epochs 2 and 3's, its BatchNorm running statistics were re-estimated
    (apart from the last epoch's), and the launches: per train step and
    eval batch as ``cli_flagship``'s, and the re-estimation's 72
    train-mode forwards (two passes over the 36 train batches)."""
    recorder, counted, lines, exp = _run_flagship_cli(
        root, corpus, "swa", f"trainer.total_epoch={SWA_EPOCHS}", "trainer.use_swa=true")
    swa = torch.load(os.path.join(exp, "ckpt", "swa_final.ckpt"), map_location="cpu",
                     weights_only=True)["state"]
    p2, p3 = recorder.epochs_state[SWA_START], recorder.epochs_state[SWA_START + 1]
    params = list(swa["swa"]["params"])
    mean_err = max(float((swa["model"][n] - (p2[n] + p3[n]) / 2).abs().max()
                         / max(float(p3[n].abs().max()), 1e-30)) for n in params)
    stats = [n for n in p3 if n.endswith(("running_mean", "running_var"))]
    moved = max(float((swa["model"][n] - p3[n]).abs().max()) for n in stats)
    per_step, per_eval = _per_step(recorder)
    in_epochs = {k: sum(e["launches"][k] for e in recorder.epochs + recorder.evals)
                 for k in counted}
    bn = {k: counted[k] - in_epochs[k] for k in counted}
    report = {"phase": "cli_swa", "nvidia_smi": smi,
              "swa_count": swa["swa"]["count"], "max_rel_err_params_vs_mean_of_epochs_2_3":
              mean_err, "max_abs_running_stat_moved_by_reestimation": moved,
              "launches": counted, "launches_per_train_step": per_step,
              "launches_per_eval_batch": per_eval, "launches_bn_reestimation": bn,
              "_counted": counted}
    emit({k: v for k, v in report.items() if not k.startswith("_")})
    checks = {
        "epochs": [e["steps"] for e in recorder.epochs] == [FLAGSHIP_STEPS] * SWA_EPOCHS,
        "count": swa["swa"]["count"] == SWA_EPOCHS - SWA_START,
        "mean": mean_err <= 1e-5, "reestimated": moved > 1e-4,
        "launches": per_step == TRAIN_STEP_LAUNCHES and per_eval == PER_FORWARD_LAUNCHES,
        "bn_launches": bn == {k: v * SWA_BN_BATCHES for k, v in SWA_BN_LAUNCHES.items()},
        "lines": all(np.isfinite(line["loss"]) for line in lines if "loss" in line),
    }
    if not all(checks.values()):
        raise AssertionError(f"cli_swa failed: {checks}")
    return report


def phase_cli_novograd(root: str, corpus: str, smi: str) -> dict:
    """``main_lid`` on the flagship with ``module.optimizer=novograd`` (and
    a constant lr: the config's tristage warm-up would hold the lr near 0
    over these steps) for 3 epochs of 9 steps: the optimizer is Novograd
    with one second moment a flax leaf (the heads' stacked), the mean train
    loss drops from the first epoch to the last, and the launches per step
    and eval batch are ``cli_flagship``'s."""
    recorder, counted, lines, _ = _run_flagship_cli(
        root, corpus, "novograd", f"trainer.total_epoch={NOVOGRAD_EPOCHS}",
        "module.optimizer=novograd", "module.schedule=null")
    epoch_loss = [line["avg_train_loss"] for line in lines if "avg_train_loss" in line]
    per_step, per_eval = _per_step(recorder)
    report = {"phase": "cli_novograd", "nvidia_smi": smi,
              "avg_train_loss_by_epoch": epoch_loss, "optimizer": recorder.optimizer_info,
              "launches": counted, "launches_per_train_step": per_step,
              "launches_per_eval_batch": per_eval, "_counted": counted}
    emit({k: v for k, v in report.items() if not k.startswith("_")})
    info = recorder.optimizer_info
    checks = {
        "novograd": info["name"] == "novograd" and info["second_moments"] < info["tensors"],
        "loss_drops": len(epoch_loss) == NOVOGRAD_EPOCHS and epoch_loss[-1] < epoch_loss[0],
        "launches": per_step == TRAIN_STEP_LAUNCHES and per_eval == PER_FORWARD_LAUNCHES,
    }
    if not all(checks.values()):
        raise AssertionError(f"cli_novograd failed: {checks}")
    return report


def phase_quant(gen: torch.Generator, root: str, corpus: str, smi: str) -> dict:
    """The int8, SWA and Novograd phases in order, on ``cli_flagship``'s
    checkpoint; → their reports."""
    return {"dense": phase_quant_dense(gen, smi), "serve": phase_quant_serve(root, gen, smi),
            "qat": phase_cli_qat(root, corpus, smi),
            "eval": phase_cli_eval_quant(root, corpus, os.path.join(
                root, "flagship", "ckpt", "last.ckpt"), smi),
            "swa": phase_cli_swa(root, corpus, smi),
            "novograd": phase_cli_novograd(root, corpus, smi)}


def quant_kernel_rows(gen: torch.Generator, errs: dict, reports: dict) -> list:
    """The ``kernels`` line's rows of the paths this section drives, with
    the launches counted on them: int8 serving (the Conformer's fbank and
    eval conv; the bfloat16 WavLM heads' eval conv), the int8 eval CLI, the
    QAT CLI (bfloat16 heads at C = 1536: training forward, dX, dW/db) and
    the SWA and Novograd CLI runs (float32 C = 288, their shape in the
    unstretched 2 s bucket)."""
    serve_c = reports["serve"]["conformer"]["launches"]
    serve_w = reports["serve"]["wavlm_bf16"]["launches"]
    evalq, qat = reports["eval"]["_counted"], reports["qat"]["_counted"]
    cli = {k: reports["swa"]["_counted"][k] + reports["novograd"]["_counted"][k]
           for k in evalq}
    on_serve = "quant_serve: serve --quant int8, 10 /lid requests"
    on_eval = f"cli_eval_quant: test_lid --quant int8, {EVAL_BATCHES} batches"
    on_cli = ("cli_swa and cli_novograd: lid_supervised.yaml, train steps, evals and SWA's "
              "BatchNorm passes")
    on_qat = "cli_qat: lid_wavlm_qat.yaml, Base+ ssl_config, 2 epochs and evals"
    rows = [fbank_row("fbank_log_mel@quant_serve", "serve", gen, errs, serve_c["fbank"],
                      {"launches_counted_on": on_serve, "launches_per_request": 1}),
            fbank_row("fbank_log_mel@eval_quant", "eval", gen, errs, evalq["fbank"],
                      {"launches_counted_on": on_eval, "launches_per_eval_batch": 1}),
            fbank_row("fbank_log_mel@swa_novograd", "eval", gen, errs, cli["fbank"],
                      {"launches_counted_on": on_cli})]
    rows += fused_kernel_rows(gen, errs["conv_fused"], {
        "depthwise_conv1d_fwd[glu_bn_act]@quant_serve": (serve_c["depthwise_glu_bn_act"], {
            "launches_counted_on": on_serve, "launches_per_request": DW_PER_FORWARD}),
        "depthwise_conv1d_fwd[glu_bn_act]@eval_quant": (evalq["depthwise_glu_bn_act"], {
            "launches_counted_on": on_eval, "launches_per_eval_batch": DW_PER_FORWARD}),
        "depthwise_conv1d_fwd[glu_bn_act]@swa_novograd_eval": (cli["depthwise_glu_bn_act"], {
            "launches_counted_on": on_cli, "launches_per_eval_batch": DW_PER_FORWARD}),
        "depthwise_conv1d_fwd[glu]@swa_novograd": (cli["depthwise_glu"], {
            "launches_counted_on": on_cli}),
        "depthwise_conv1d_fwd[glu_dx]@swa_novograd": (cli["depthwise_glu_dx"], {
            "launches_counted_on": on_cli}),
    }, eval_rows=(("depthwise_conv1d_fwd[glu_bn_act]@quant_serve", SERVE_DW_SHAPE),
                  ("depthwise_conv1d_fwd[glu_bn_act]@eval_quant", EVAL_DW_SHAPE),
                  ("depthwise_conv1d_fwd[glu_bn_act]@swa_novograd_eval", EVAL_DW_SHAPE)),
        train_shape=EVAL_DW_SHAPE, train_suffix="@swa_novograd")
    row = bwd_w_row(gen, errs["conv_fused"], EVAL_DW_SHAPE, "depthwise_conv1d_bwd_w@swa_novograd",
                    cli, 1)
    row.pop("launches_per_train_step")
    row["launches_counted_on"] = on_cli
    rows.append(row)
    rows += fused_kernel_rows(gen, errs["conv_fused"], {
        "depthwise_conv1d_fwd[glu_bn_act]@quant_serve_wavlm_bf16": (
            serve_w["depthwise_glu_bn_act"], {"launches_counted_on": on_serve,
                                              "launches_per_request": N_LANG}),
        "depthwise_conv1d_fwd[glu_bn_act]@qat_eval": (qat["depthwise_glu_bn_act"], {
            "launches_counted_on": on_qat, "launches_per_eval_batch": N_LANG}),
        "depthwise_conv1d_fwd[glu]@qat": (qat["depthwise_glu"], {
            "launches_counted_on": on_qat, "launches_per_train_step": 1}),
        "depthwise_conv1d_fwd[glu_dx]@qat": (qat["depthwise_glu_dx"], {
            "launches_counted_on": on_qat, "launches_per_train_step": 1}),
    }, eval_rows=(("depthwise_conv1d_fwd[glu_bn_act]@quant_serve_wavlm_bf16",
                   WAVLM_SERVE_DW_SHAPE),
                  ("depthwise_conv1d_fwd[glu_bn_act]@qat_eval", WAVLM_BF16_CLI_DW_SHAPE)),
        train_shape=WAVLM_BF16_CLI_DW_SHAPE, train_suffix="@qat", dtype=torch.bfloat16)
    row = bwd_w_row(gen, errs["conv_fused"], WAVLM_BF16_CLI_DW_SHAPE,
                    "depthwise_conv1d_bwd_w@qat", qat, QAT_STEPS * 2, torch.bfloat16)
    row["launches_counted_on"] = on_qat
    rows.append(row)
    for row in rows:
        if not row["launches"] > 0:
            raise AssertionError(f"{row['name']} was not launched on its path")
    return rows


# ------------------------ kaldi fbank, FBankLayer, the extras tasks, the sweep and the trace

KALDI_LENGTHS = (64000, 61000, 52000, 40000, 33000, 20000, 8000, 300)  # 300: no kaldi frame
KALDI_SHAPE = (len(KALDI_LENGTHS), 4 * SR)  # (8, 64000)
# kaldi's natural-log mel on the card against the CPU's float64 on valid
# frames: within KALDI_TOL, or KALDI_SPREAD times the CPU's own float32
# distance (low-energy bins are ill-conditioned in float32: the CPU tests
# saw JAX's float32 up to 1.5e-4 and the port's up to 2.6e-4 from float64)
KALDI_TOL, KALDI_FFT_TOL, KALDI_SPREAD = 1e-4, 1e-3, 2.0
FBANK_LAYER_CALLS = 2  # one eval and one training forward of FBankLayer
# the extras models at main_extras' default widths, B = 32
EXTRAS_B = 32
LM_VOCAB, LM_T = 10000, 128  # a word vocabulary cut to 10k; --max-len 128
RML_T, RML_CLASSES = 128, 11  # RadioML 2016.10a: 2 x 128 IQ, 11 modulations
SPEC_D, SPEC_WIN = 64, 32  # SpecPredTask's feat_dim and --win-len defaults
EXTRAS_TOL = 1e-3  # card vs CPU: the output and each gradient of its leaf's largest entry
EXTRAS_CUDNN_TOL = 1e-2  # a leaf past EXTRAS_TOL: to the CPU's float64 step, as se_card_vs_cpu
EXTRAS_MODELS = {
    # name: (model, input kind, the task and its keyword arguments for the counted steps)
    "base_cnn": (lambda: extras_models.BaseCNN(10), "image",
                 (ImageClassificationTask, dict(num_classes=10))),
    "lstm_lm": (lambda: extras_models.LSTMLM(LM_VOCAB, 128, 256), "ids",
                (LMTask, dict(vocab_size=LM_VOCAB))),
    "resnet1d": (lambda: extras_models.ResNet1D(RML_CLASSES, 32, 16, 6), "iq",
                 (RMLTask, dict(n_classes=RML_CLASSES))),
    "resnet1d_rnn_snr": (lambda: extras_models.ResNet1D(RML_CLASSES, 32, 16, 6, use_rnn=True,
                                                        use_snr_head=True), "iq",
                         (RMLTask, dict(n_classes=RML_CLASSES, use_rnn=True,
                                        use_snr_info=True))),
    **{name: (lambda name=name: extras_models.FORECAST_MODELS[name](
        out_dim=SPEC_D, in_dim=SPEC_D, win_len=SPEC_WIN),
              "window", (SpecPredTask, dict(model_name=name, feat_dim=SPEC_D,
                                            win_len=SPEC_WIN)))
       for name in ("mlp", "lstm", "cnn_lstm", "causal_conv", "transformer")},
}
EXTRAS_EPOCHS = 2
# the sweep: configs/sweep_lid.yaml's method and parameters on lid_supervised
# at full width, cut to 3 trials (2 random), one epoch each, on 3 languages of
# 10 tone-code clips (8 train, 2 dev: one eval batch a language)
SWEEP_TRIALS, SWEEP_STARTUP, SWEEP_CLIPS, SWEEP_DEV_RATIO = 3, 2, 10, 0.2


def _kaldi_batch(gen: torch.Generator) -> tuple:
    lengths = torch.tensor(KALDI_LENGTHS)
    wav = frontend.normalize_wav(0.1 * torch.randn(*KALDI_SHAPE, generator=gen), lengths)
    return wav, lengths


def phase_kaldi_card_vs_cpu(gen: torch.Generator, smi: str) -> dict:
    """Kaldi fbank (plain PyTorch on every device, as XLA in the JAX package)
    and ``FBankLayer`` (the fbank kernel) on a padded (8, 64000) batch whose
    last row has 300 samples, fewer than kaldi's 400-sample window:
    ``kaldi_fbank`` (``dft_conv`` and ``fft``), ``wav2mel(use_kaldi=True)`` and
    ``fused_frontend(use_kaldi=True)`` on the card against the CPU's float64
    on valid frames; the snip-edges frame counts exact (0 for the short
    row); ``FBankLayer`` in eval, and in training with the same stretch
    generator state on both sides and the card's SpecAugment spans handed to
    the CPU, against the CPU within ``FBANK_TOL``; its fbank launches
    counted; the kaldi frontend timed against the fbank kernel."""
    from speechlid_tpu_torch.ops import specaugment

    wav, lengths = _kaldi_batch(gen)
    card_wav, card_len = wav.cuda(), lengths.cuda()
    f_len = frontend.frame_lengths(lengths, 160, center=False, win_length=400)
    exact = frontend.kaldi_fbank(wav.double())
    valid = (torch.arange(exact.shape[1])[None, :] < f_len[:, None])[..., None]

    def dist(x) -> float:
        return float(((x.cpu().double() - exact).abs() * valid).max())

    own = dist(frontend.kaldi_fbank(wav))
    errs = {m: dist(frontend.kaldi_fbank(card_wav, method=m)) for m in ("dft_conv", "fft")}
    bars = {"dft_conv": max(KALDI_TOL, KALDI_SPREAD * own),
            "fft": max(KALDI_FFT_TOL, KALDI_SPREAD * own)}
    w2m = frontend.wav2mel(card_wav, use_kaldi=True)
    feats, fused_len = frontend.fused_frontend(card_wav, card_len, use_kaldi=True,
                                               normalize=False)
    checks = {
        **{f"kaldi_{m}": errs[m] <= bars[m] for m in errs},
        "wav2mel_is_kaldi_transposed": torch.equal(w2m.transpose(1, 2),
                                                   frontend.kaldi_fbank(card_wav)),
        "fused_frontend": dist(feats) <= bars["dft_conv"],
        "frame_lengths": torch.equal(fused_len.cpu(), f_len) and int(f_len[-1]) == 0
        and torch.equal(frontend.frame_lengths(card_len, 160, center=False).cpu(), f_len),
    }
    # FBankLayer: eval, then training (time stretch and SpecAugment)
    layer = FBankLayer(t_stretch=True)
    spans = []
    draw = specaugment.draw_axis_spans

    def recording(*args, **kwargs):
        out = draw(*args, **kwargs)
        spans.append(out)
        return out

    torch.cuda.synchronize()
    reset_launches()
    eval_card = layer.eval()(card_wav, card_len)
    specaugment.draw_axis_spans = recording
    try:
        train_card = layer.train()(card_wav, card_len, torch.Generator("cuda").manual_seed(3),
                                   torch.Generator().manual_seed(4))
        torch.cuda.synchronize()
        counted = launches()
        specaugment.draw_axis_spans = lambda *a, **k: tuple(x.cpu() for x in spans.pop(0))
        train_cpu = layer(wav, lengths, torch.Generator().manual_seed(3),
                          torch.Generator().manual_seed(4))
    finally:
        specaugment.draw_axis_spans = draw
    eval_cpu = layer.eval()(wav, lengths)
    layer_errs = {}
    for name, card, cpu in (("eval", eval_card, eval_cpu), ("train", train_card, train_cpu)):
        (fc, lc), (fp, lp) = card, cpu
        frames = (torch.arange(fp.shape[1])[None, :] < lp[:, None])[..., None]
        gap = ((fc.cpu() - fp).abs() - FBANK_TOL * fp.abs()) * frames
        layer_errs[name] = float(((fc.cpu() - fp).abs() * frames).max())
        checks[f"fbank_layer_{name}"] = (torch.equal(lc.cpu(), lp) and fc.shape == fp.shape
                                         and float(gap.max()) <= FBANK_TOL)
    checks["fbank_layer_launches"] = counted == launch_counts(fbank=FBANK_LAYER_CALLS)
    checks["spans_replayed"] = not spans
    times = {"kaldi_dft_conv_ms": device_ms(lambda: frontend.kaldi_fbank(card_wav)),
             "kaldi_fft_ms": device_ms(lambda: frontend.kaldi_fbank(card_wav, method="fft")),
             "fbank_kernel_ms": device_ms(lambda: log_mel(card_wav)),
             "wav2mel_fbank_ms": device_ms(lambda: frontend.wav2mel(card_wav, lengths=card_len)),
             "fbank_layer_eval_ms": device_ms(lambda: layer.eval()(card_wav, card_len))}
    report = {"phase": "kaldi_card_vs_cpu", "nvidia_smi": smi, "shape": list(KALDI_SHAPE),
              "lengths": list(KALDI_LENGTHS), "kaldi_frames": f_len.tolist(),
              "max_abs_err_vs_float64": errs, "cpu_float32_vs_float64": own, "bars": bars,
              "fbank_layer_max_abs_err_db": layer_errs, "fbank_layer_tol": FBANK_TOL,
              "fbank_layer_launches": counted["fbank"], "times": times, "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"kaldi_card_vs_cpu failed: {checks}")
    return report


def _extras_inputs(kind: str, rng: np.random.RandomState) -> tuple:
    b = EXTRAS_B
    if kind == "image":
        return (torch.from_numpy(rng.rand(b, 8, 8, 1).astype(np.float32)),)
    if kind == "ids":
        lengths = np.sort(rng.randint(8, LM_T + 1, b))[::-1].copy()
        lengths[0] = LM_T
        ids = rng.randint(0, LM_VOCAB, (b, LM_T))
        ids[np.arange(LM_T)[None, :] >= lengths[:, None]] = 0
        return torch.from_numpy(ids), torch.from_numpy(lengths)
    if kind == "iq":
        return (torch.from_numpy(rng.randn(b, RML_T, 2).astype(np.float32)),)
    return (torch.from_numpy(rng.randn(b, SPEC_WIN, SPEC_D).astype(np.float32)),)


def _outs(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


def _extras_grads(model, inputs, cots, dtype) -> tuple:
    """(outputs, {name: gradient}) of Σ out·cot in training mode, on the
    model's device, in ``dtype``."""
    dev = next(model.parameters()).device
    args = [x.to(dev) if not x.is_floating_point() else x.to(dev, dtype) for x in inputs]
    model.train().zero_grad()
    outs = _outs(model(*args))
    sum((o * c.to(dev, dtype)).sum() for o, c in zip(outs, cots)).backward()
    return ([o.detach().cpu().double() for o in outs],
            {n: p.grad.cpu().double() for n, p in model.named_parameters()})


def _extras_zero_grad(name: str, model) -> set:
    """The leaves whose true gradient is 0: ResNet1D's conv biases reach the
    loss only through train-mode BatchNorms (tests/test_torch_extras_models.py);
    the Transformer's key bias adds q·b to every logit of a query's row,
    which the softmax removes."""
    if name.startswith("resnet1d"):
        return {"stem.bias"} | {f"blocks.{i}.conv{j}.bias" for i in range(len(model.blocks))
                                for j in (1, 2)}
    if name == "transformer":
        return {f"layers.{i}.attn.key.bias" for i in range(len(model.layers))}
    return set()


def _extras_step_launches(name: str) -> dict:
    """The hand-kernel launches of two train steps of the model's task on
    the card at B = 32 (forward, backward, Adam with the clip)."""
    _, kind, (task_cls, kwargs) = EXTRAS_MODELS[name]
    task = task_cls(**kwargs, device="cuda")
    trainer = Trainer(total_epoch=1, use_progress_bar=False, device="cuda")
    trainer.trainer_prepare(task)
    rng = np.random.RandomState(5)
    inputs = _extras_inputs(kind, rng)
    if kind == "image":
        batch = (inputs[0].numpy(), rng.randint(0, 10, EXTRAS_B))
    elif kind == "ids":
        batch = {"ids": inputs[0].numpy(), "lengths": inputs[1].numpy()}
    elif kind == "iq":
        batch = {"iq": inputs[0].numpy(), "label": rng.randint(0, RML_CLASSES, EXTRAS_B),
                 "snr": rng.uniform(-10, 18, EXTRAS_B).astype(np.float32)}
    else:
        batch = {"x": inputs[0].numpy(), "y": rng.randn(EXTRAS_B, SPEC_D).astype(np.float32)}
    return counted_calls(lambda: float(trainer.train_step(batch)["loss"]), 2)


def phase_extras_card_vs_cpu(gen: torch.Generator, smi: str) -> dict:
    """Every model of ``models/extras.py`` at ``main_extras``' default widths
    (B = 32): the card against the same weights on the CPU (flax's fresh
    draw, converted state loaded on both sides), the eval forward and one
    training step's gradients of Σ out·c (dropout off on both sides, the
    card's ReLU decisions handed to the CPU: a unit within rounding of 0
    flips otherwise, and a flip moved ResNet1D's gradients by 1–7 %),
    within ``EXTRAS_TOL`` of the CPU leaf's largest entry.  A leaf past it (cuDNN's
    float32 LSTM and GRU are less exact than the CPU's, ROADMAP §3) is held
    to the CPU's float64 step in relative L2, within ``EXTRAS_CUDNN_TOL`` or
    three times the CPU's float32 distance, as ``se_card_vs_cpu``; the
    readings are printed.  Then each task's train steps on the card launch
    no hand kernel."""
    rng = np.random.RandomState(21)
    report, ok = {}, True
    for name, (make, kind, _) in EXTRAS_MODELS.items():
        card = make().cuda()
        init_like_flax_(card, gen)
        cpu = make()
        cpu.load_state_dict(card.state_dict())
        cpu64 = make().double()
        cpu64.load_state_dict(card.state_dict())
        for m in (*card.modules(), *cpu.modules(), *cpu64.modules()):
            if isinstance(m, Dropout):
                m.p = 0.0
        inputs = _extras_inputs(kind, rng)
        with torch.no_grad():
            eval_card = _outs(card.eval()(*[x.cuda() for x in inputs]))
            eval_cpu = _outs(cpu.eval()(*inputs))
        fwd_err = max(float((c.cpu() - p).abs().max()) / float(p.abs().max())
                      for c, p in zip(eval_card, eval_cpu))
        cots = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)) for o in eval_cpu]
        # the card's ReLU decisions, handed to both CPU steps (as ce_train_card_vs_cpu)
        masks, flipped = [], {}
        pin_resnet_relus(True, masks, module=extras_models)
        try:
            out_card, g_card = _extras_grads(card, inputs, cots, torch.float32)
            runs = {}
            for side, model, dtype in (("cpu", cpu, torch.float32),
                                       ("cpu_float64", cpu64, torch.float64)):
                differ = {"units": 0}
                pin_resnet_relus(True, masks, differ, module=extras_models)
                runs[side] = _extras_grads(model, inputs, cots, dtype)
                flipped[side] = differ["units"]
        finally:
            pin_resnet_relus(False, masks, module=extras_models)
        (out_cpu, g_cpu), (out64, g64) = runs["cpu"], runs["cpu_float64"]
        train_err = max(float((c - p).abs().max()) / float(p.abs().max())
                        for c, p in zip(out_card, out_cpu))
        zero = _extras_zero_grad(name, card)
        largest = max(float(g.abs().max()) for g in g_cpu.values())
        worst, held, leaves_ok = 0.0, {}, True
        for leaf, g in g_cpu.items():
            if leaf in zero:
                err = max(float(g.abs().max()), float(g_card[leaf].abs().max())) / largest
                leaves_ok &= err <= EXTRAS_TOL
                continue
            err = float((g_card[leaf] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            worst = max(worst, err)
            if err > EXTRAS_TOL:
                ref = g64[leaf]
                norm = max(float(ref.norm()), 1e-30)
                l2 = {side: float((gs[leaf] - ref).norm()) / norm
                      for side, gs in (("card", g_card), ("cpu", g_cpu))}
                bar = max(EXTRAS_CUDNN_TOL, 3 * l2["cpu"])
                held[leaf] = {"card_vs_cpu": err, **{f"rel_l2_{k}_vs_float64": v
                                                      for k, v in l2.items()}, "bar": bar}
                leaves_ok &= l2["card"] <= bar
        stats_err = 0.0
        for (key, a), (_, b) in zip(card.state_dict().items(), cpu.state_dict().items()):
            if key.endswith(("running_mean", "running_var")):
                stats_err = max(stats_err, float((a.cpu() - b).abs().max())
                                / max(float(b.abs().max()), 1e-30))
        out64_err = max(float((c - p).abs().max()) / float(p.abs().max())
                        for c, p in zip(out_card, out64))
        step_launches = _extras_step_launches(name)
        report[name] = {
            "input": [list(x.shape) for x in inputs],
            "params": sum(p.numel() for p in card.parameters()),
            "max_err_eval_over_largest": fwd_err, "max_err_train_out_over_largest": train_err,
            "train_out_card_vs_float64": out64_err, "max_rel_err_gradient": worst,
            "gradients": len(g_cpu), "zero_gradient_leaves": sorted(zero),
            "relus": sum(int(m.numel()) for m in masks), "relus_pinned_that_differed": flipped,
            "leaves_held_to_float64": held, "max_rel_err_bn_stats": stats_err,
            "train_step_launches": step_launches}
        ok &= (fwd_err <= EXTRAS_TOL and (train_err <= EXTRAS_TOL or out64_err <= EXTRAS_TOL)
               and leaves_ok and stats_err <= EXTRAS_TOL and set(g_card) == set(g_cpu)
               and step_launches == launch_counts())
        del card, cpu, cpu64
    emit({"phase": "extras_card_vs_cpu", "nvidia_smi": smi, "tol": EXTRAS_TOL,
          "tol_cudnn_vs_float64": EXTRAS_CUDNN_TOL, "batch": EXTRAS_B, **report})
    if not ok:
        raise AssertionError("an extras model on the card disagrees with the CPU")
    return report


class _EpochLosses(Callback):
    """Each train epoch's ``avg_train_loss`` and steps."""

    def __init__(self):
        super().__init__()
        self.losses, self.steps = [], []
        self._start = 0

    def before_train_epoch(self, epoch):
        self._start = self.trainer.global_step

    def after_train_epoch(self, epoch, metrics):
        self.losses.append(float(metrics["avg_train_loss"]))
        self.steps.append(self.trainer.global_step - self._start)


def _markov_text(path: str, n: int, rng: np.random.RandomState) -> None:
    """A wikitext-style file of ``n`` sentences from a first-order Markov
    chain over 400 words (each word has 4 likely successors), with headers
    and blank lines: text an LSTM LM can learn in an epoch or two."""
    words = [f"w{i}" for i in range(400)]
    nexts = rng.randint(0, len(words), (len(words), 4))
    lines = [" = Corpus = ", ""]
    for i in range(n):
        w = rng.randint(len(words))
        sentence = []
        for _ in range(rng.randint(6, 20)):
            sentence.append(words[w])
            w = nexts[w, rng.randint(4)] if rng.rand() < 0.9 else rng.randint(len(words))
        lines.append(" ".join(sentence))
        if i % 100 == 99:
            lines += ["", f" = Section {i} = ", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _rml_npz(path: str, n: int, rng: np.random.RandomState) -> None:
    """``n`` IQ frames (2 × 128) of 11 classes, a carrier per class with its
    own frequency and phase step, under noise at an SNR in [-4, 18] dB."""
    t = np.arange(RML_T)
    label = rng.randint(0, RML_CLASSES, n)
    snr = rng.choice(np.arange(-4, 20, 2), n).astype(np.float32)
    freq = 0.02 + 0.03 * label
    step = np.pi / 2 * (label % 3)
    phase = 2 * np.pi * freq[:, None] * t[None, :] + step[:, None] * (t[None, :] // 16)
    amp = 10.0 ** (snr[:, None] / 20.0)
    iq = np.stack([amp * np.cos(phase), amp * np.sin(phase)], axis=-1)
    iq += rng.randn(*iq.shape)
    np.savez(path, iq=(iq / amp.max()).astype(np.float32), label=label, snr=snr)


def _spectrum_jsonl(path: str, rows: int, rng: np.random.RandomState) -> None:
    """A spectrum monitor's dump: ``rows`` records of 64 dB levels with a
    date, a few carriers drifting slowly over a noise floor."""
    bins = np.arange(SPEC_D)
    with open(path, "w") as f:
        for i in range(rows):
            level = -100.0 + 3.0 * rng.randn(SPEC_D)
            for c, (center, period) in enumerate(((10, 200), (30, 90), (50, 333))):
                pos = center + 4 * np.sin(2 * np.pi * i / period)
                level += (40 - 8 * c) * np.exp(-0.5 * ((bins - pos) / 1.5) ** 2)
            f.write(json.dumps({"data": np.round(level).astype(int).tolist(),
                                "date": f"t{i:05d}"}) + "\n")


def _digits_like(n: int, rng: np.random.RandomState) -> tuple:
    """Seeded 8 × 8 × 1 images of 10 classes: a class pattern plus noise."""
    patterns = rng.rand(10, 8, 8, 1).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)
    x = np.clip(patterns[y] + 0.3 * rng.randn(n, 8, 8, 1), 0, 1).astype(np.float32)
    return x, y


def phase_cli_extras(root: str, smi: str) -> dict:
    """``main_extras`` on the card, each for two epochs with ``--ckpt-dir``:
    ``lm`` on a text corpus ``prepare_text`` prepared from generated
    sentences, ``rml`` (``--use-rnn --use-snr``) on a generated IQ ``.npz``
    with ``snr``, ``spec_pred`` (``--model lstm``) on a ``.npy`` that
    ``prepare_spectrum convert`` packed from a generated ``.jsonl``, and
    ``image`` on scikit-learn's digits where it imports (else
    ``ImageClassificationTask`` through ``Trainer.fit`` on seeded 8 × 8 × 1
    arrays after ``main_extras image`` raised ``ImportError``, and the line
    says which ran).  The second epoch's mean train
    loss must be below the first's, and the checkpoint must rebuild the
    task.  None of these paths launches a hand kernel."""
    rng = np.random.RandomState(31)
    exp = os.path.join(root, "extras")
    raw, text = os.path.join(exp, "raw"), os.path.join(exp, "text")
    os.makedirs(raw)
    _markov_text(os.path.join(raw, "wiki.train.raw"), 1500, rng)
    _markov_text(os.path.join(raw, "wiki.valid.raw"), 100, rng)
    prepare_text.main(["--root", raw, "--out", text])
    _rml_npz(os.path.join(exp, "rml.npz"), 1600, rng)
    _spectrum_jsonl(os.path.join(exp, "spec.jsonl"), 1200, rng)
    prepare_spectrum.main(["convert", os.path.join(exp, "spec.jsonl"),
                           os.path.join(exp, "spec.npy")])
    try:
        import sklearn  # noqa: F401
        image = ["image"]
    except ImportError:
        image = None
    runs = {"lm": (["lm", "--data", os.path.join(text, "train.txt")], LMTask),
            "rml": (["rml", "--data", os.path.join(exp, "rml.npz"), "--use-rnn", "--use-snr"],
                    RMLTask),
            "spec_pred": (["spec_pred", "--data", os.path.join(exp, "spec.npy"),
                           "--model", "lstm"], SpecPredTask)}
    if image:
        runs["image"] = (image, ImageClassificationTask)
    saved = main_extras._trainer
    report, checks = {"phase": "cli_extras", "nvidia_smi": smi, "epochs": EXTRAS_EPOCHS,
                      "image_ran": "main_extras image (scikit-learn digits)" if image else
                      "ImageClassificationTask via Trainer.fit on seeded 8x8x1 arrays "
                      "(no scikit-learn)"}, {}
    for name, (argv, task_cls) in runs.items():
        recorder = _EpochLosses()

        def recording_trainer(args, **kw):
            trainer = saved(args, **kw)
            trainer.callbacks.append(recorder)
            return trainer

        ckpt = os.path.join(exp, name)
        main_extras._trainer = recording_trainer
        torch.cuda.synchronize()
        reset_launches()
        try:
            trainer = main_extras.main([*argv, "--epochs", str(EXTRAS_EPOCHS), "--no-progress",
                                        "--ckpt-dir", ckpt])
        finally:
            main_extras._trainer = saved
        torch.cuda.synchronize()
        counted = launches()
        task, _ = task_cls.resume_from_checkpoint(os.path.join(ckpt, "last.ckpt"))
        same = all(torch.equal(p, task.model.state_dict()[k])
                   for k, p in trainer.module.model.state_dict().items())
        report[name] = {"steps_per_epoch": recorder.steps,
                        "avg_train_loss": recorder.losses, "launches": counted,
                        "hyper_parameters": task.hyper_parameters}
        checks[name] = (len(recorder.losses) == EXTRAS_EPOCHS
                        and recorder.losses[1] < recorder.losses[0] and same
                        and counted == launch_counts())
    if not image:  # main_extras image raises there, as the JAX CLI does
        try:
            main_extras.main(["image", "--epochs", "1", "--no-progress"])
            checks["image_raises_without_sklearn"] = False
        except ImportError:
            checks["image_raises_without_sklearn"] = True
        x, y = _digits_like(1800, rng)
        recorder = _EpochLosses()
        task = ImageClassificationTask(num_classes=10)
        trainer = Trainer(total_epoch=EXTRAS_EPOCHS, use_progress_bar=False, callbacks=[recorder])
        trainer.fit(task, [(x[i:i + 32], y[i:i + 32]) for i in range(0, 1620, 32)],
                    [(x[i:i + 32], y[i:i + 32]) for i in range(1620, 1800, 32)])
        report["image"] = {"steps_per_epoch": recorder.steps, "avg_train_loss": recorder.losses}
        checks["image"] = recorder.losses[1] < recorder.losses[0]
    report["checks"] = checks
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"cli_extras failed: {checks}")
    return report


def _sweep_corpus(root: str) -> str:
    """A LibriSpeech-layout tree of the tone-code languages
    (``<lang>/<speaker>/<chapter>/<utt>.wav`` and ``<speaker>-<chapter>.trans.txt``),
    ``SWEEP_CLIPS`` clips a language."""
    from speechlid_tpu_torch.data.audio_io import write_wav

    synth = _synth_corpus()
    tree = os.path.join(root, "librispeech")
    for li, lang in enumerate(sorted(synth.LANG_CHARS)):
        chapter = os.path.join(tree, lang, "19", "198")
        os.makedirs(chapter)
        rng = np.random.RandomState(300 + li)
        lines = []
        for i in range(SWEEP_CLIPS):
            text = synth.make_text(lang, rng)
            utt = f"19-198-{i:04d}"
            write_wav(os.path.join(chapter, f"{utt}.wav"), synth.synth_utterance(lang, text, rng),
                      synth.SR)
            lines.append(f"{utt} {text}")
        with open(os.path.join(chapter, "19-198.trans.txt"), "w") as f:
            f.write("\n".join(lines))
    return tree


def phase_cli_sweep(root: str, smi: str) -> dict:
    """``prepare_manifest`` builds the manifests of a LibriSpeech-layout tree;
    the port's ``sweep`` runs ``configs/sweep_lid.yaml``'s bayes spec (lr,
    dropout, ``n_blocks`` ∈ {8, 14}, ``batch_size`` ∈ {8, 16}) on
    ``lid_supervised`` at full width through ``main_lid`` on the card, cut to
    ``SWEEP_TRIALS`` trials (``SWEEP_STARTUP`` random) of one epoch.  Checks:
    every trial returns a value; ``results.jsonl`` holds the trials; the
    third trial's suggestion is what ``TPESampler`` on the CPU suggests from
    the same seed and history; every trial launches ``fbank_log_mel`` and
    the training and eval depthwise modes.  Each trial's launches are
    counted apart (``main_lid.main`` wrapped: counts set to 0 before, read
    after)."""
    import random

    from speechlid_tpu_torch.cli import main_lid
    from speechlid_tpu_torch.core.config import safe_load

    tree = _sweep_corpus(root)
    manifests = os.path.join(root, "sweep_manifests")
    prepare_manifest.main(["--root", tree, "--out", manifests,
                           "--dev-ratio", str(SWEEP_DEV_RATIO)])
    langs = ", ".join(
        "{manifest: %s, val_manifest: %s}" % (os.path.join(manifests, lang, "train.txt"),
                                            os.path.join(manifests, lang, "dev.txt"))
        for lang in sorted(os.listdir(manifests)))
    with open("configs/sweep_lid.yaml") as f:
        body = f.read()
    spec = safe_load(body)
    body = (body.replace(f"trials: {spec['trials']}", f"trials: {SWEEP_TRIALS}")
            .replace(f"n_startup: {spec['n_startup']}", f"n_startup: {SWEEP_STARTUP}")
            .replace("trainer.total_epoch=10", "trainer.total_epoch=1")
            .replace("  - trainer.progress_bar=false",
                     f'  - trainer.progress_bar=false\n  - "data.langs=[{langs}]"'))
    spec_path = os.path.join(root, "sweep_lid_cut.yaml")
    with open(spec_path, "w") as f:
        f.write(body)
    cut = safe_load(body)
    out = os.path.join(root, "sweep")
    trials, train_main = [], main_lid.main
    fbank_shapes, conv_shapes = set(), set()
    wav2mel = frontend.wav2mel  # hands its wav to the fbank kernel as it is

    def counted_main(argv):
        sampled = dict(a.split("=", 1) for a in argv if a.split("=")[0] in cut["parameters"])
        torch.cuda.synchronize()
        reset_launches()
        fbank_shapes.clear()
        conv_shapes.clear()
        try:
            train_main(argv)
        finally:
            torch.cuda.synchronize()
            trials.append({"launches": launches(),
                           "sampled": sampled, "fbank_shapes": sorted(fbank_shapes),
                           "conv_shapes": sorted(conv_shapes)})

    def wav2mel_seen(wav, *args, **kwargs):
        fbank_shapes.add(tuple(wav.shape))
        return wav2mel(wav, *args, **kwargs)

    def conv_seen(module, inputs, output):
        if isinstance(module, ConformerConvModule):
            k, c = module.depthwise.weight.shape
            conv_shapes.add((*inputs[0].shape[:2], c, k))

    main_lid.main, frontend.wav2mel = counted_main, wav2mel_seen
    hook = torch.nn.modules.module.register_module_forward_hook(conv_seen)
    t0 = time.perf_counter()
    try:
        results = sweep_cli.main([spec_path, "--out", out])
    finally:
        main_lid.main, frontend.wav2mel = train_main, wav2mel
        hook.remove()
    seconds = time.perf_counter() - t0
    with open(os.path.join(out, "results.jsonl")) as f:
        written = [json.loads(line) for line in f]
    metric = cut["metric"]["name"]
    by_trial = sorted(written, key=lambda r: r["trial"])
    sampler = sweep_cli.TPESampler(cut["parameters"], random.Random(cut.get("seed", 0)),
                                   n_startup=int(cut["n_startup"]),
                                   gamma=float(cut.get("gamma", 0.25)))
    replay = [sampler.suggest(by_trial[:i], metric, cut["metric"]["goal"])
              for i in range(SWEEP_TRIALS)]
    suggested = [{k: r[k] for k in cut["parameters"]} for r in by_trial]
    dw_modes = ("depthwise_glu", "depthwise_glu_dx", "depthwise_bwd_w", "depthwise_glu_bn_act")
    checks = {
        "trials": len(results) == SWEEP_TRIALS == len(trials),
        "every_value": all(r[metric] is not None and np.isfinite(r[metric]) for r in results),
        "results_jsonl": len(written) == SWEEP_TRIALS,
        "third_is_cpu_tpe": replay[2] == suggested[2],
        "replayed_trials": replay == suggested,
        "kernels_every_trial": all(t["launches"]["fbank"] > 0
                                   and all(t["launches"][m] > 0 for m in dw_modes)
                                   for t in trials),
        "kernel_shapes": all(
            t["fbank_shapes"] == [FBANK_SHAPES[SWEEP_SHAPES[int(t["sampled"]["data.batch_size"])][0]]]
            and t["conv_shapes"] == [SWEEP_SHAPES[int(t["sampled"]["data.batch_size"])][1]]
            for t in trials),
    }
    report = {"phase": "cli_sweep", "nvidia_smi": smi, "seconds": seconds,
              "spec": {k: cut[k] for k in ("method", "trials", "n_startup", "metric",
                                          "parameters")},
              "reduced": [f"trials {spec['trials']} -> {SWEEP_TRIALS}",
                          f"n_startup {spec['n_startup']} -> {SWEEP_STARTUP}",
                          "trainer.total_epoch 10 -> 1",
                          f"corpus: 3 languages x {SWEEP_CLIPS} tone-code clips, dev ratio "
                          f"{SWEEP_DEV_RATIO}: one eval batch a language"],
              "results": by_trial, "trials": trials, "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"cli_sweep failed: {checks}")
    return report


def profile_child(trace_dir: str) -> None:
    """The ``profile_trace`` phase's own process: ``Trainer.fit`` of the
    flagship task for one epoch of 3 train steps (B = 8, 4 s) with
    ``profile_dir`` set."""
    strict_float32(torch.device("cuda"))
    task = LidASRTask(**FLAGSHIP, **TRAIN_HPARAMS, device="cuda")
    rng = np.random.RandomState(41)
    batches = [synthetic_batch(rng, i % N_LANG, TRAIN_B, TRAIN_SECONDS) for i in range(3)]
    Trainer(total_epoch=1, use_progress_bar=False, profile_dir=trace_dir,
            device="cuda").fit(task, batches)


def phase_profile_trace(root: str, smi: str) -> dict:
    """``Trainer(profile_dir=…)`` in a process of its own: one trace file for
    the one profiled epoch, holding at least one ``fbank_log_mel`` and one
    depthwise kernel record.  The counts are a report (the profiler drops
    records late in a long process, ROADMAP §3)."""
    trace_dir = os.path.join(root, "trace")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.profile_child({trace_dir!r})"],
        cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if child.returncode != 0:
        print(child.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"profile_trace's process failed ({child.returncode})")
    files = sorted(os.listdir(trace_dir))
    counts, n_kernels = {"fbank_log_mel": 0, "depthwise": 0}, 0
    for name in files:
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("cat") != "kernel":
                continue
            n_kernels += 1
            for key in counts:
                counts[key] += key in e.get("name", "")
    checks = {"one_file_per_epoch": files == ["epoch_0.pt.trace.json"],
              "fbank_record": counts["fbank_log_mel"] >= 1, "depthwise_record": counts["depthwise"] >= 1}
    report = {"phase": "profile_trace", "nvidia_smi": smi, "seconds": seconds, "files": files,
              "bytes": [os.path.getsize(os.path.join(trace_dir, n)) for n in files],
              "kernel_records": n_kernels, "records": counts,
              "records_are": "a report: torch.profiler may drop records", "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"profile_trace failed: {checks}")
    return report


def phase_extras(gen: torch.Generator, root: str, smi: str) -> dict:
    """This slice's phases in order; → their reports."""
    return {"kaldi": phase_kaldi_card_vs_cpu(gen, smi),
            "models": phase_extras_card_vs_cpu(gen, smi),
            "cli": phase_cli_extras(root, smi), "sweep": phase_cli_sweep(root, smi),
            "trace": phase_profile_trace(root, smi)}


def extras_kernel_rows(gen: torch.Generator, errs: dict, reports: dict) -> list:
    """The ``kernels`` line's rows of this slice's paths: ``FBankLayer`` at
    (8, 64000), and every kernel the sweep's trials launched, at the shapes
    of each batch size the trials drew (``SWEEP_SHAPES``), with the launches
    of the trials of that batch size."""
    rows = [fbank_row("fbank_log_mel@fbank_layer", "train", gen, errs,
                      reports["kaldi"]["fbank_layer_launches"],
                      {"launches_counted_on": "kaldi_card_vs_cpu: FBankLayer eval and training",
                       "launches_per_forward": 1})]
    trials = reports["sweep"]["trials"]
    for b in sorted({int(t["sampled"]["data.batch_size"]) for t in trials}):
        mine = [t for t in trials if int(t["sampled"]["data.batch_size"]) == b]
        counts = {k: sum(t["launches"][k] for t in mine) for k in mine[0]["launches"]}
        on = (f"cli_sweep: the {len(mine)} of {len(trials)} trials of lid_supervised at "
              f"data.batch_size={b}, their train steps and evals")
        fbank_key, dw_shape = SWEEP_SHAPES[b]
        suffix = f"@cli_sweep_b{b}"
        rows.append(fbank_row("fbank_log_mel" + suffix, fbank_key, gen, errs, counts["fbank"],
                              {"launches_counted_on": on}))
        rows += fused_kernel_rows(gen, errs["conv_fused"], {
            f"depthwise_conv1d_fwd[glu_bn_act]{suffix}_eval": (
                counts["depthwise_glu_bn_act"], {"launches_counted_on": on}),
            f"depthwise_conv1d_fwd[glu]{suffix}": (counts["depthwise_glu"], {
                "launches_counted_on": on}),
            f"depthwise_conv1d_fwd[glu_dx]{suffix}": (counts["depthwise_glu_dx"], {
                "launches_counted_on": on}),
        }, eval_rows=((f"depthwise_conv1d_fwd[glu_bn_act]{suffix}_eval", dw_shape),),
            train_shape=dw_shape, train_suffix=suffix)
        row = bwd_w_row(gen, errs["conv_fused"], dw_shape, "depthwise_conv1d_bwd_w" + suffix,
                        counts, 1)
        row.pop("launches_per_train_step")
        row["launches_counted_on"] = on
        rows.append(row)
    for row in rows:
        if not row["launches"] > 0:
            raise AssertionError(f"{row['name']} was not launched on its path")
    return rows


# ---------------------------------------------------------------------------
# data-parallel training and SELDNet
# ---------------------------------------------------------------------------

DP_WORLD = 2  # ranks, both on cuda:0 over gloo (nccl refuses two ranks on one card)
DP_B, DP_SECONDS = TRAIN_B, TRAIN_SECONDS  # per rank: the flagship's (8, 64000) train batch
DP_STEPS, DP_RANDOM_STEPS = 3, 2
RANK_TIMEOUT_S = 180  # the groups': a hung collective fails the phase
# the flagship with Adam + tristage + clip 20 (TRAIN_HPARAMS), deterministic,
# then with dropout, stochastic depth, SpecAugment and time stretch on
DP_OPTIM = {k: v for k, v in TRAIN_HPARAMS.items() if k != "t_stretch"}
DP_HP = dict(CONFORMER_DETERMINISTIC, **DP_OPTIM)
DP_RANDOM_HP = dict(FLAGSHIP, **TRAIN_HPARAMS)
# one process on the 16-row global batch against rank 0: the first step's
# gradients (rank 0's after the all-reduce) within TRAIN_TOL of each leaf's
# largest entry, the flagship's card-against-CPU step bar (a depthwise bias,
# true gradient 0 before a train-mode BatchNorm, against the largest of all);
# and the parameters and statistics after the steps within TRAIN_TOL of the
# leaf's largest entry, as tests/test_torch_trainer.py holds the CPU
# trainers under Adam: a depthwise bias and the BatchNorm running means that
# carry it within 2 Σ lr, and in any other leaf at most 1 % of the elements
# past the bar, they too within 2 Σ lr.  Adam moves an element by at most
# Σ lr over the steps, so two runs that take a gradient of rounding size
# with opposite signs (the card's CTC and gather backwards sum with atomics,
# ROADMAP §3) part by at most 2 Σ lr there
DP_BAND_LEAVES = ("depthwise.bias", "bn.running_mean")
SELD_B, SELD_T = 16, 128
SELD_PRESETS = {"vanilla": (seldnet_vanilla, 8), "augmented": (seldnet_augmented, 4)}


class _LossRecorder(Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def after_train_loop(self, step, metrics):
        self.losses.append(metrics["loss"])


def width_launches() -> dict:
    """The depthwise counts of ``_build.launches`` by mode and channel count
    C (``"glu@144"``, ``"glu_dx@144"``, ``"bwd_w@144"``)."""
    widths = collections.Counter()
    for key, n in _build.launches.items():
        if key.entry.startswith("depthwise"):
            widths[f"{key.mode}@{key.width}"] += n
    return dict(widths)


class _CountedTrainer(Trainer):
    """``Trainer`` that reads the launch counters, also by channel count,
    around each train step, and keeps the gradients the optimizer's first
    step takes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.step_launches, self.step_widths, self.first_grads = [], [], None

    def trainer_prepare(self, module):
        super().trainer_prepare(module)
        step = self.optimizer.step

        def recorded_step():
            if self.first_grads is None:  # whole, gathered over a layout's model group
                grads = {n: p.grad.detach() for n, p in module.model.named_parameters()
                         if p.grad is not None}
                if self.layout is not None:
                    grads = self.layout.full_state(grads, params_only=True)
                self.first_grads = {n: g.cpu().clone() for n, g in grads.items()}
            step()

        self.optimizer.step = recorded_step

    def train_step(self, batch):
        reset_launches()
        out = super().train_step(batch)
        self.step_launches.append(launches())
        self.step_widths.append(width_launches())
        return out


def _dp_fit(hp: dict, state: dict, batches: list, mesh=None, rules=None, val=None,
            epochs: int = 1, callbacks=(), after=None) -> dict:
    """``Trainer.fit`` of the flagship task ``hp`` from ``state`` on
    ``batches`` (over ``mesh``, laid out by ``rules``); → the final state on
    the host (whole: gathered over a layout's model group), the first
    step's gradients, the step losses, each step's launches and stretch
    rates, and ``after(task)`` where given."""
    from speechlid_tpu_torch import convert
    from speechlid_tpu_torch.ops import specaugment

    task = LidASRTask(**hp, device="cuda")
    task.model.load_state_dict(state)
    task.init_parameters = lambda generator: None  # keep the weights it was given
    rates, draw = [], specaugment.draw_stretch_rate

    def recorded_draw(*args, **kwargs):
        rates.append(float(draw(*args, **kwargs)))
        return rates[-1]

    losses = _LossRecorder()
    trainer = _CountedTrainer(total_epoch=epochs, use_progress_bar=False, device="cuda",
                              callbacks=[losses, *callbacks], mesh=mesh, param_rules=rules)
    specaugment.draw_stretch_rate = recorded_draw
    try:
        trainer.fit(task, batches, val)
    finally:
        specaugment.draw_stretch_rate = draw
    opt = trainer.optimizer
    out = {"state": {k: v.cpu() for k, v in convert.full_state(task.model).items()},
           "first_grads": trainer.first_grads, "losses": losses.losses,
           "step_launches": trainer.step_launches,
           "step_widths": trainer.step_widths, "stretch_rates": rates,
           "lr_sum": sum(opt.lr_at(i) for i in range(opt.count))}
    if after is not None:
        out["after"] = after(task)
    return out


def _rank_job_dp(inputs: dict, rank: int, world: int) -> dict:
    """A rank of ``dp_card_vs_single``: its rows of every global batch,
    trained deterministically, then with randomness on."""
    from speechlid_tpu_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh()
    mine = [shard_batch(mesh, b) for b in inputs["batches"]]
    return {"deterministic": _dp_fit(DP_HP, inputs["state"], mine[:DP_STEPS], mesh),
            "random": _dp_fit(DP_RANDOM_HP, inputs["state"], mine[DP_STEPS:], mesh)}


def rank_child(root: str, job: str, rank: int, world: int) -> None:
    """A rank of a multi-rank phase: joins the gloo group on cuda:0 (nccl
    takes no two ranks on one card), runs ``RANK_JOBS[job]`` and writes what
    it saw to ``<root>/rank<r>.pt``."""
    from datetime import timedelta

    from speechlid_tpu_torch.parallel import initialize_multihost, shutdown

    strict_float32(torch.device("cuda"))
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    initialize_multihost(f"file://{os.path.join(root, 'pg')}", world, rank, device="cuda:0",
                         backend="gloo", timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        out = RANK_JOBS[job](inputs, rank, world)
    finally:
        shutdown()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


def run_ranks(job: str, inputs: dict, world: int, local=None) -> tuple:
    """``world`` ranks of ``job``, each a process of its own on cuda:0, while
    ``local()`` (the one-process run it is held to) runs here.  → (the
    ranks' outputs, ``local()``'s)."""
    with tempfile.TemporaryDirectory() as root:
        torch.save(inputs, os.path.join(root, "inputs.pt"))
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.rank_child({root!r}, {job!r}, {r}, {world})"],
            cwd=str(Path(__file__).resolve().parent), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        try:
            mine = local() if local is not None else None
            outs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                print(out[-4000:], file=sys.stderr)
                raise AssertionError(f"{job}: rank {r} failed ({p.returncode})")
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    return ranks, mine


def bit_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _dp_grads_close(got: dict, want: dict) -> dict:
    """The first step's gradients as ``step_card_vs_cpu`` holds them: each
    leaf's worst distance over its largest entry, a depthwise bias's over
    the largest entry of all."""
    largest = max(float(g.abs().max()) for g in want.values())
    worst, worst_name = 0.0, ""
    for name, w in want.items():
        diff = float((got[name] - w).abs().max())
        err = diff / largest if name.endswith("depthwise.bias") else \
            diff / max(float(w.abs().max()), 1e-6 * largest)
        if err > worst:
            worst, worst_name = err, name
    same = set(got) == set(want)
    return {"max_rel_err_gradient": worst, "worst_gradient": worst_name, "same_leaves": same,
            "ok": worst <= TRAIN_TOL and same}


def _dp_close(got: dict, want: dict, lr_sum: float) -> dict:
    """Each leaf of ``got`` against ``want`` as ``DP_BAND_LEAVES`` says: the
    worst distance over the leaf's largest entry outside the band leaves,
    the largest absolute difference, the elements past the bar, and whether
    all holds."""
    band = 2.0 * lr_sum
    worst, worst_name, largest_diff, past, ok = 0.0, "", 0.0, {}, True
    for name, w in want.items():
        if not w.is_floating_point():
            continue
        bar = TRAIN_TOL * max(float(w.abs().max()), 1e-12)
        diff = (got[name] - w).abs()
        largest_diff = max(largest_diff, float(diff.max()))
        if name.endswith(DP_BAND_LEAVES):
            ok &= float(diff.max()) <= band + bar
            continue
        err = float(diff.max()) / max(float(w.abs().max()), 1e-12)
        if err > worst:
            worst, worst_name = err, name
        n_past = int((diff > bar).sum())
        if n_past:
            past[name] = n_past
            ok &= n_past <= max(1, int(0.01 * w.numel())) and float(diff.max()) <= band + bar
    return {"max_rel_err": worst, "worst_leaf": worst_name, "max_abs_diff": largest_diff,
            "band_2_lr_sum": band, "elements_past_bar": past, "ok": ok}


def phase_dp_card_vs_single(gen: torch.Generator, smi: str) -> dict:
    """Data-parallel training at the flagship's width: two ranks on the card
    (processes of their own over gloo, each B = 8 ragged 4 s clips a step)
    against one process on the card that takes the 16-row global batch in
    the same row order, for ``DP_STEPS`` deterministic Adam steps: the
    ranks' parameters and statistics bit-equal, the first step's gradients
    and rank 0's state after the steps within the step bar of the single
    process's (``_dp_grads_close``, ``_dp_close``), the step losses' mean over
    the ranks within ``TRAIN_TOL`` of the single process's, and every rank's
    launches a step exactly ``TRAIN_STEP_LAUNCHES`` (read from the launch
    counters around each step).  Then ``DP_RANDOM_STEPS`` steps with dropout,
    stochastic depth, SpecAugment and time stretch on: the ranks stay
    bit-equal, they draw the same stretch rates, the losses are finite."""
    rng = np.random.RandomState(61)
    n_batches = DP_STEPS + DP_RANDOM_STEPS
    batches = [synthetic_batch(rng, i % N_LANG, DP_WORLD * DP_B, DP_SECONDS)
               for i in range(n_batches)]
    init = LidASRTask(**DP_HP, device="cuda")
    init_random_(init.model, gen)
    state = {k: v.cpu() for k, v in init.model.state_dict().items()}
    del init
    ranks, single = run_ranks("dp", {"state": state, "batches": batches}, DP_WORLD,
                              lambda: _dp_fit(DP_HP, state, batches[:DP_STEPS]))
    det = [r["deterministic"] for r in ranks]
    rnd = [r["random"] for r in ranks]
    close = _dp_close(det[0]["state"], single["state"], single["lr_sum"])
    grads = _dp_grads_close(det[0]["first_grads"], single["first_grads"])
    loss_gap = max(abs(float(np.mean([d["losses"][i] for d in det])) - single["losses"][i])
                   for i in range(DP_STEPS))
    counted = {k: sum(s[k] for d in det for s in d["step_launches"])
               for k in TRAIN_STEP_LAUNCHES}
    checks = {
        "ranks_bit_equal": bit_equal(det[0]["state"], det[1]["state"]),
        "first_step_gradients": grads["ok"],
        "vs_single_process": close["ok"],
        "losses": loss_gap <= TRAIN_TOL,
        "steps": all(len(d["step_launches"]) == DP_STEPS for d in det),
        "launches_per_rank_step": all(s == TRAIN_STEP_LAUNCHES for d in det
                                      for s in d["step_launches"]),
        "random_ranks_bit_equal": bit_equal(rnd[0]["state"], rnd[1]["state"]),
        "random_stretch_rates_agree": rnd[0]["stretch_rates"] == rnd[1]["stretch_rates"]
        and len(rnd[0]["stretch_rates"]) == DP_RANDOM_STEPS,
        "random_losses_finite": all(np.isfinite(x) for r in rnd for x in r["losses"]),
        "random_launches": all(s["fbank"] == 1 and s["depthwise_bwd_w"] == DW_PER_TRAIN_STEP
                               for r in rnd for s in r["step_launches"]),
    }
    report = {"phase": "dp_card_vs_single", "nvidia_smi": smi, "world": DP_WORLD,
              "backend": "gloo, both ranks on cuda:0",
              "batch_per_rank": [DP_B, int(DP_SECONDS * SR)], "steps": DP_STEPS, "tol": TRAIN_TOL,
              "single_losses": single["losses"], "rank_losses": [d["losses"] for d in det],
              "max_loss_gap": loss_gap, **{k: v for k, v in grads.items() if k != "ok"},
              **{k: v for k, v in close.items() if k != "ok"},
              "lr_sum": single["lr_sum"], "launches_per_rank_step": det[0]["step_launches"][0],
              "launches": counted, "random_stretch_rates": [r["stretch_rates"] for r in rnd],
              "random_losses": [r["losses"] for r in rnd], "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"dp_card_vs_single failed: {checks}")
    return report


def phase_cli_dp(root: str, corpus: str, smi: str) -> dict:
    """``main_lid`` with ``trainer.data_parallel=true`` at world size 1 over
    nccl, launched by ``python -m torch.distributed.run --standalone
    --nproc-per-node 1`` on the corpus, 2 epochs of ``FLAGSHIP_STEPS`` steps
    at full width: it trains and validates (EER, Cavg and accuracy logged),
    and rank 0 writes the checkpoint, with one device generator."""
    exp = os.path.join(root, "cli_dp_data_parallel")
    child = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "speechlid_tpu_torch.cli.main_lid",
         *_cli_args("configs", "lid_supervised", _langs_override(corpus),
                    "trainer.progress_bar=false", "trainer.total_epoch=2",
                    f"trainer.train_data_factor={FLAGSHIP_DATA_FACTOR}", f"exp_dir={exp}",
                    "trainer.data_parallel=true")],
        cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        print(child.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"cli_dp's data_parallel run failed ({child.returncode})")
    evals = [line for line in _metrics_lines(os.path.join(exp, "metrics.jsonl"))
             if CLI_EVAL_KEYS <= set(line)]
    state = load_checkpoint(os.path.join(exp, "ckpt", "last.ckpt"))["state"]
    checks = {
        "validated": len(evals) == 2 and all(
            np.isfinite(e[k]) for e in evals for k in ("avg_val_loss", "val_acc")),
        "eer_cavg_acc_logged": all({"eer", "cavg", "val_acc"} <= set(e) for e in evals),
        "rank0_ckpt": len(state["device_generators"]) == 1,
    }
    report = {"phase": "cli_dp", "nvidia_smi": smi,
              "launcher": "python -m torch.distributed.run --standalone --nproc-per-node 1",
              "backend": "nccl", "config": "configs/lid_supervised.yaml (14 x 144-d)",
              "steps_per_epoch": FLAGSHIP_STEPS, "evals": evals, "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"cli_dp failed: {checks}")
    return report


def phase_seldnet_card_vs_cpu(gen: torch.Generator, smi: str) -> dict:
    """Both SELDNet presets at their JAX defaults (freq 256; 8 and 4 input
    channels), B = 16, 128 frames: the card against the same weights on the
    CPU (flax's fresh draw), the eval forward, the train-mode forward and
    the gradients of Σ sed·c₁ + Σ doa·c₂ (a check's loss) with dropout off
    and the card's ReLU decisions handed to the CPU, held as
    ``extras_card_vs_cpu`` holds cuDNN's recurrences: within ``EXTRAS_TOL``
    of the CPU leaf's largest entry, or a leaf past it within
    ``EXTRAS_CUDNN_TOL`` (or three times the CPU's distance) of the CPU's
    float64 step in relative L2.  The conv biases feed train-mode
    BatchNorms (true gradient 0): held against the largest gradient."""
    report, ok = {}, True
    for name, (make, channels) in SELD_PRESETS.items():
        card = make().cuda()
        init_like_flax_(card, gen)
        cpu, cpu64 = make(), make().double()
        cpu.load_state_dict(card.state_dict())
        cpu64.load_state_dict(card.state_dict())
        for m in (*card.modules(), *cpu.modules(), *cpu64.modules()):
            if isinstance(m, Dropout):
                m.p = 0.0
        rng = np.random.RandomState(71)
        x = torch.from_numpy(rng.randn(SELD_B, channels, 256, SELD_T).astype(np.float32))
        with torch.no_grad():
            eval_card = _outs(card.eval()(x.cuda()))
            eval_cpu = _outs(cpu.eval()(x))
        fwd_err = max(float((c.cpu() - p).abs().max()) / float(p.abs().max())
                      for c, p in zip(eval_card, eval_cpu))
        cots = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)) for o in eval_cpu]
        masks, flipped = [], {}
        pin_resnet_relus(True, masks, module=seldnet_models)
        try:
            out_card, g_card = _extras_grads(card, [x], cots, torch.float32)
            runs = {}
            for side, model, dtype in (("cpu", cpu, torch.float32),
                                       ("cpu_float64", cpu64, torch.float64)):
                differ = {"units": 0}
                pin_resnet_relus(True, masks, differ, module=seldnet_models)
                runs[side] = _extras_grads(model, [x], cots, dtype)
                flipped[side] = differ["units"]
        finally:
            pin_resnet_relus(False, masks, module=seldnet_models)
        (out_cpu, g_cpu), (_, g64) = runs["cpu"], runs["cpu_float64"]
        train_err = max(float((c - p).abs().max()) / float(p.abs().max())
                        for c, p in zip(out_card, out_cpu))
        zero = {f"convs.{i}.bias" for i in range(len(card.convs))}
        largest = max(float(g.abs().max()) for g in g_cpu.values())
        worst, held, leaves_ok = 0.0, {}, True
        for leaf, g in g_cpu.items():
            if leaf in zero:
                leaves_ok &= max(float(g.abs().max()),
                                 float(g_card[leaf].abs().max())) / largest <= EXTRAS_TOL
                continue
            err = float((g_card[leaf] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            worst = max(worst, err)
            if err > EXTRAS_TOL:
                ref = g64[leaf]
                norm = max(float(ref.norm()), 1e-30)
                l2 = {side: float((gs[leaf] - ref).norm()) / norm
                      for side, gs in (("card", g_card), ("cpu", g_cpu))}
                bar = max(EXTRAS_CUDNN_TOL, 3 * l2["cpu"])
                held[leaf] = {"card_vs_cpu": err, **{f"rel_l2_{k}_vs_float64": v
                                                      for k, v in l2.items()}, "bar": bar}
                leaves_ok &= l2["card"] <= bar
        stats_err = max(float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                        for (k, a), (_, b) in zip(card.state_dict().items(),
                                                  cpu.state_dict().items())
                        if k.endswith(("running_mean", "running_var")))
        report[name] = {
            "input": [SELD_B, channels, 256, SELD_T],
            "params": sum(p.numel() for p in card.parameters()),
            "max_err_eval_over_largest": fwd_err, "max_err_train_out_over_largest": train_err,
            "max_rel_err_gradient": worst, "gradients": len(g_cpu),
            "zero_gradient_leaves": sorted(zero), "relus": sum(int(m.numel()) for m in masks),
            "relus_pinned_that_differed": flipped, "leaves_held_to_float64": held,
            "max_rel_err_bn_stats": stats_err}
        ok &= (fwd_err <= EXTRAS_TOL and train_err <= EXTRAS_TOL and leaves_ok
               and stats_err <= EXTRAS_TOL and set(g_card) == set(g_cpu))
        del card, cpu, cpu64
    emit({"phase": "seldnet_card_vs_cpu", "nvidia_smi": smi, "tol": EXTRAS_TOL,
          "tol_cudnn_vs_float64": EXTRAS_CUDNN_TOL, "batch": SELD_B, **report})
    if not ok:
        raise AssertionError("a SELDNet preset on the card disagrees with the CPU")
    return report


def phase_dist(gen: torch.Generator, root: str, corpus: str, smi: str) -> dict:
    """This slice's phases in order; → their reports."""
    return {"dp": phase_dp_card_vs_single(gen, smi), "cli": phase_cli_dp(root, corpus, smi),
            "seldnet": phase_seldnet_card_vs_cpu(gen, smi)}


def dist_kernel_rows(gen: torch.Generator, errs: dict, reports: dict) -> list:
    """The ``kernels`` line's rows of the data-parallel path: every kernel a
    rank's train step launches, at its (8, 64000) / (8, 99, 288) shapes, with
    the launches of both ranks' ``DP_STEPS`` deterministic steps in
    ``dp_card_vs_single``."""
    dp = reports["dp"]
    counts = dp["launches"]
    on = (f"dp_card_vs_single: {DP_WORLD} ranks x {DP_STEPS} deterministic train steps of "
          f"B = {DP_B} a rank")
    n_steps = DP_WORLD * DP_STEPS
    rows = [fbank_row("fbank_log_mel@dp", "train", gen, errs, counts["fbank"],
                      {"launches_counted_on": on,
                       "launches_per_rank_step": counts["fbank"] / n_steps})]
    rows += fused_kernel_rows(gen, errs["conv_fused"], {
        "depthwise_conv1d_fwd[glu]@dp": (counts["depthwise_glu"], {
            "launches_counted_on": on,
            "launches_per_rank_step": counts["depthwise_glu"] / n_steps}),
        "depthwise_conv1d_fwd[glu_dx]@dp": (counts["depthwise_glu_dx"], {
            "launches_counted_on": on,
            "launches_per_rank_step": counts["depthwise_glu_dx"] / n_steps}),
    }, eval_rows=(), train_shape=TRAIN_DW_SHAPE, train_suffix="@dp")
    row = bwd_w_row(gen, errs["conv_fused"], TRAIN_DW_SHAPE, "depthwise_conv1d_bwd_w@dp",
                    counts, n_steps)
    row["launches_per_rank_step"] = row.pop("launches_per_train_step")
    row["launches_counted_on"] = on
    rows.append(row)
    for row in rows:
        if not row["launches"] > 0:
            raise AssertionError(f"{row['name']} was not launched on its path")
    return rows


# ---------------------------------------------------------------------------
# tensor, expert, pipeline and sequence parallelism
# ---------------------------------------------------------------------------

# __graft_entry__._flagship(n_lang=4): the flagship with a fourth head, so
# that its four languages split two heads a rank over a model axis of 2
MP_FLAGSHIP = dict(FLAGSHIP, lang2vocab={"lang0": 40, "lang1": 96, "lang2": 88, "lang3": 64},
                   lang2index={"lang0": 0, "lang1": 1, "lang2": 2, "lang3": 3})
MP_HP = dict(MP_FLAGSHIP, dropout=0.0, pos_dropout=0.0, use_stochastic_depth=False,
             mask_times=0, t_stretch=False, **DP_OPTIM)
MP_RANDOM_HP = dict(MP_FLAGSHIP, **TRAIN_HPARAMS)  # every draw on
MP_MODEL = 2  # the model axis
TP_STEPS, TP_RANDOM_STEPS = 3, 2
DP_TP_WORLD = 4  # data 2 × model 2
DP_TP_BLOCKS = 4  # its encoder's depth, cut from 14 for the script's time (full width)
DP_TP_HP = dict(MP_HP, n_blocks=DP_TP_BLOCKS)
PP_STAGES, PP_MICROBATCHES = 4, (4, 8)
PP_FWD_TOL, PP_GRAD_TOL = 2e-5, 5e-5  # tests/test_pipeline.py's bars, atol and rtol
# tests/test_multihost.py's bar for a sharded run's losses (and a restored
# one's): after an Adam step the states part within Adam's band, so the
# losses that read them are held relative to their size (near 250)
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-5
CLI_TP_LOSS_RTOL = 1e-4
MP_ENCODER_C = FLAGSHIP["encoder_dim"]  # a model rank's conv channels: 288 over 2


def _mp_rules():
    from speechlid_tpu_torch.parallel import CONFORMER_TP_RULES, EP_RULES

    return EP_RULES + CONFORMER_TP_RULES


def mp_batch(rng: np.random.RandomState, lang: int, b: int, seconds: float) -> dict:
    """:func:`synthetic_batch` over the four-language flagship's vocabularies."""
    batch = synthetic_batch(rng, 0, b, seconds)
    vocab = list(MP_FLAGSHIP["lang2vocab"].values())[lang]
    batch["texts"] = rng.randint(0, vocab, batch["texts"].shape).astype(np.int32)
    batch["langs"] = np.full(b, lang, np.int32)
    return batch


def _random_state(hp: dict, gen: torch.Generator) -> dict:
    init = LidASRTask(**hp, device="cuda")
    init_random_(init.model, gen)
    return {k: v.cpu() for k, v in init.model.state_dict().items()}


def _local_replicated(model: torch.nn.Module) -> dict:
    """This rank's tensors that its layout holds whole."""
    layout = getattr(model, "layout", None)
    pieces = layout.pieces if layout is not None else {}
    return {k: v.cpu() for k, v in model.state_dict().items() if k not in pieces}


def _tp_eval(task: LidASRTask) -> dict:
    """One eval forward of every head (after a warm-up): its launches, also
    by channel count, the scores, and this rank's replicated tensors."""
    batch = mp_batch(np.random.RandomState(67), 0, TRAIN_B, TRAIN_SECONDS)
    wavs, lengths = torch.from_numpy(batch["wavs"]), torch.from_numpy(batch["wav_lengths"])
    infer = task.infer_fn()
    infer(wavs, lengths)
    torch.cuda.synchronize()
    reset_launches()
    out = infer(wavs, lengths)
    torch.cuda.synchronize()
    return {"launches": launches(), "widths": width_launches(),
            "scores": out["scores"].cpu(), "replicated": _local_replicated(task.model)}


def _replicated_after(task: LidASRTask) -> dict:
    return {"replicated": _local_replicated(task.model)}


def _mp_job_tp(inputs: dict, rank: int, world: int) -> dict:
    from speechlid_tpu_torch.parallel import make_mesh

    mesh = make_mesh(model=world)
    batches = inputs["batches"]
    return {"deterministic": _dp_fit(MP_HP, inputs["state"], batches[:TP_STEPS], mesh,
                                     rules=_mp_rules(), after=_tp_eval),
            "random": _dp_fit(MP_RANDOM_HP, inputs["state"], batches[TP_STEPS:], mesh,
                              rules=_mp_rules(), after=_replicated_after),
            "model_index": mesh.index("model")}


def _mp_job_dp_tp(inputs: dict, rank: int, world: int) -> dict:
    from speechlid_tpu_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(model=MP_MODEL)
    mine = lambda batches: [shard_batch(mesh, b) for b in batches]  # noqa: E731
    fit = _dp_fit(DP_TP_HP, inputs["state"], mine(inputs["train"]), mesh, rules=_mp_rules(),
                  val=mine(inputs["val"]), epochs=2, after=_replicated_after,
                  callbacks=(CkptCallback(inputs["ckpt_dir"], save_topk=3),))
    return {"fit": fit, "index": {"data": mesh.index("data"), "model": mesh.index("model")}}


def _mp_job_cli(inputs: dict, rank: int, world: int) -> dict:
    from speechlid_tpu_torch.cli import main_lid

    main_lid.main(inputs["args"])
    return {}


def _pp_block(state: dict = None) -> torch.nn.Module:
    """A flagship encoder block on the card in eval mode (BatchNorm on its
    running statistics, as JAX's pipeline trains it), holding ``state``."""
    from speechlid_tpu_torch.models.conformer import ConformerBlock

    block = ConformerBlock(FLAGSHIP["encoder_dim"], dim_head=FLAGSHIP["dim_head"],
                           heads=FLAGSHIP["heads"]).cuda()
    if state is not None:
        block.load_state_dict(state)
    return block.eval()


def _mp_job_pp(inputs: dict, rank: int, world: int) -> dict:
    from speechlid_tpu_torch.parallel import make_mesh, pipeline_apply

    mesh = make_mesh(stage=world)
    s = mesh.index("stage")
    block = _pp_block(inputs["states"][s])
    x = inputs["x"].cuda()
    out = {"stage": s}
    for key, m in (("warmup", PP_MICROBATCHES[0]),) + tuple(zip(PP_MICROBATCHES,
                                                                PP_MICROBATCHES)):
        block.zero_grad()
        torch.cuda.synchronize()
        reset_launches()
        y = pipeline_apply(block, x, mesh, n_microbatch=m)
        (y ** 2).mean().backward()
        torch.cuda.synchronize()
        out[key] = {"launches": launches(),
                    "y": y.detach().cpu(),
                    "grads": {n: p.grad.cpu() for n, p in block.named_parameters()}}
    out["sp"] = _sp_mel(make_mesh(data=world // SP_SEQ, seq=SP_SEQ), inputs)
    return out


def _sp_mel(mesh, inputs: dict) -> dict:
    """``sp_wav2mel`` of the whole wave over ``mesh``'s seq axis, gathered,
    with the fbank kernel's launches (its wrapper's count) and the span each
    read."""
    from speechlid_tpu_torch.parallel import gather_time, sp_wav2mel

    spans, real = [], fbank_kernel.log_mel

    def seen(wav, *args, **kwargs):
        spans.append(list(wav.shape))
        return real(wav, *args, **kwargs)

    wavs, lengths = inputs["wavs"].cuda(), inputs["lengths"].cuda()
    fbank_kernel.log_mel = seen
    try:
        sp_wav2mel(wavs, lengths, mesh)  # a warm-up
        spans.clear()
        torch.cuda.synchronize()
        reset_launches()
        local = sp_wav2mel(wavs, lengths, mesh)
        torch.cuda.synchronize()
        fbank_launches = launches()["fbank"]
    finally:
        fbank_kernel.log_mel = real
    full = gather_time(local, mesh, time_dim=2, size=1 + wavs.shape[1] // 160)
    return {"mel": full.cpu(), "local": list(local.shape), "spans": spans,
            "fbank_launches": fbank_launches}


RANK_JOBS = {"dp": _rank_job_dp, "tp": _mp_job_tp, "dp_tp": _mp_job_dp_tp, "cli": _mp_job_cli,
             "pp": _mp_job_pp}


def _owner(lang: int) -> int:
    return lang // (len(MP_FLAGSHIP["lang2vocab"]) // MP_MODEL)


def _tp_step_expect(owner: bool) -> tuple:
    """A model rank's launches a train step, in all and by channel count:
    the encoder's 14 blocks at C = 144, and the own head's block at 288 on
    the rank that owns it."""
    n = N_BLOCKS + int(owner)
    widths = {f"{k}@{MP_ENCODER_C}": N_BLOCKS for k in ("glu", "glu_dx", "bwd_w")}
    if owner:
        widths.update({f"{k}@{2 * MP_ENCODER_C}": 1 for k in ("glu", "glu_dx", "bwd_w")})
    return launch_counts(fbank=1, glu=n, glu_dx=n, bwd_w=n), widths



def phase_tp_card_vs_single(gen: torch.Generator, smi: str) -> dict:
    """Tensor and expert parallelism at the flagship's width: two ranks on
    the card (data 1 × model 2, ``EP_RULES + CONFORMER_TP_RULES``), the
    four-language flagship of ``__graft_entry__._flagship(n_lang=4)`` (two
    heads a rank), B = 8 ragged 4 s clips a step, against one process on
    the card on the same batches: ``TP_STEPS`` deterministic Adam steps,
    the first step's gradients and the state after them within the
    flagship's step bar (``_dp_grads_close``, ``_dp_close``), the losses
    within ``LOSS_RTOL`` / ``LOSS_ATOL``; each rank's launches and conv widths a step
    exact (``_tp_step_expect``); an eval forward of every head (14 conv
    launches at C = 144 and 2 at 288 a rank) whose scores are within
    ``MODEL_TOL`` of one process's; then ``TP_RANDOM_STEPS`` steps with every
    draw on, held to one process at the same seed by the same bars (the
    ranks draw one process's masks).  The two ranks' replicated tensors are
    bit-equal, and so are the whole states they gather."""
    rng = np.random.RandomState(71)
    n_lang = len(MP_FLAGSHIP["lang2vocab"])
    batches = [mp_batch(rng, i % n_lang, TRAIN_B, TRAIN_SECONDS)
               for i in range(TP_STEPS + TP_RANDOM_STEPS)]
    state = _random_state(MP_HP, gen)
    ranks, single = run_ranks(
        "tp", {"state": state, "batches": batches}, MP_MODEL,
        lambda: {"deterministic": _dp_fit(MP_HP, state, batches[:TP_STEPS], after=_tp_eval),
                 "random": _dp_fit(MP_RANDOM_HP, state, batches[TP_STEPS:])})
    det = [r["deterministic"] for r in ranks]
    rnd = [r["random"] for r in ranks]
    one_det, one_rnd = single["deterministic"], single["random"]
    langs = [int(b["langs"][0]) for b in batches]
    steps_ok = True
    for r, fit in zip(ranks, det):
        for lang, launched, widths in zip(langs, fit["step_launches"], fit["step_widths"]):
            want_l, want_w = _tp_step_expect(_owner(lang) == r["model_index"])
            steps_ok &= launched == want_l and widths == want_w
    ev = [d["after"] for d in det]
    eval_widths = {f"glu_bn_act@{MP_ENCODER_C}": N_BLOCKS,
                   f"glu_bn_act@{2 * MP_ENCODER_C}": n_lang // MP_MODEL}
    score_gap = max(float((e["scores"] - one_det["after"]["scores"]).abs().max()) for e in ev)
    score_scale = float(one_det["after"]["scores"].abs().max())
    close = _dp_close(det[0]["state"], one_det["state"], one_det["lr_sum"])
    grads = _dp_grads_close(det[0]["first_grads"], one_det["first_grads"])
    rclose = _dp_close(rnd[0]["state"], one_rnd["state"], one_rnd["lr_sum"])
    rgrads = _dp_grads_close(rnd[0]["first_grads"], one_rnd["first_grads"])
    loss_gap = max(abs(a - b) for d in det for a, b in zip(d["losses"], one_det["losses"]))
    rloss_gap = max(abs(a - b) for d in rnd for a, b in zip(d["losses"], one_rnd["losses"]))
    close_losses = lambda fits, one: all(  # noqa: E731
        np.allclose(f["losses"], one["losses"], rtol=LOSS_RTOL, atol=LOSS_ATOL) for f in fits)
    checks = {
        "whole_states_bit_equal": bit_equal(det[0]["state"], det[1]["state"])
        and bit_equal(rnd[0]["state"], rnd[1]["state"]),
        "replicated_bit_equal": bit_equal(ev[0]["replicated"], ev[1]["replicated"])
        and bit_equal(rnd[0]["after"]["replicated"], rnd[1]["after"]["replicated"]),
        "first_step_gradients": grads["ok"], "vs_single_process": close["ok"],
        "losses": close_losses(det, one_det),
        "launches_and_widths_per_rank_step": steps_ok,
        "eval_launches": all(e["launches"] == launch_counts(
            fbank=1, glu_bn_act=N_BLOCKS + n_lang // MP_MODEL) and e["widths"] == eval_widths
            for e in ev),
        "eval_scores": score_gap <= MODEL_TOL * max(score_scale, 1.0),
        "random_first_step_gradients": rgrads["ok"], "random_vs_single_process": rclose["ok"],
        "random_losses": close_losses(rnd, one_rnd)
        and all(np.isfinite(x) for d in rnd for x in d["losses"]),
        "random_stretch_rates": all(d["stretch_rates"] == one_rnd["stretch_rates"] for d in rnd),
    }
    report = {"phase": "tp_card_vs_single", "nvidia_smi": smi, "mesh": {"data": 1, "model": 2},
              "backend": "gloo, both ranks on cuda:0", "model": "14 x 144, 4 heads of 144",
              "batch": [TRAIN_B, int(TRAIN_SECONDS * SR)], "steps": TP_STEPS,
              "random_steps": TP_RANDOM_STEPS, "tol": TRAIN_TOL,
              "loss_tol": [LOSS_RTOL, LOSS_ATOL],
              "langs": langs, "single_losses": one_det["losses"],
              "rank_losses": [d["losses"] for d in det], "max_loss_gap": loss_gap,
              **{k: v for k, v in grads.items() if k != "ok"},
              **{k: v for k, v in close.items() if k != "ok"},
              "random": {"max_loss_gap": rloss_gap, "single_losses": one_rnd["losses"],
                         **{k: v for k, v in rgrads.items() if k != "ok"},
                         **{k: v for k, v in rclose.items() if k != "ok"}},
              "step_launches": [d["step_launches"] for d in det],
              "step_widths": [d["step_widths"] for d in det],
              "eval_launches": [e["launches"] for e in ev], "eval_widths": [e["widths"] for e in ev],
              "eval_max_score_gap": score_gap, "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"tp_card_vs_single failed: {checks}")
    return report


def phase_dp_tp_card(gen: torch.Generator, smi: str) -> dict:
    """Data × tensor × expert parallelism: four ranks on the card (data 2 ×
    model 2, full width, ``DP_TP_BLOCKS`` encoder blocks), each data index
    8 of the 16 rows of every batch, two epochs of two Adam steps with a
    validation and a checkpoint after each, against one process on the
    16-row batches: the first step's gradients within the step bar, the
    losses of the first epoch within ``LOSS_RTOL`` / ``LOSS_ATOL``, the
    first epoch's checkpoint within the step bar of one process's state (it
    holds the whole state, written by rank 0); the four ranks' whole states
    bit-equal and a model group's replicated tensors bit-equal.  One process
    resumes the first epoch's checkpoint and takes the second epoch: its
    losses within the same bar of the four ranks'."""
    rng = np.random.RandomState(73)
    train = [mp_batch(rng, lang, 2 * TRAIN_B, TRAIN_SECONDS) for lang in (1, 2)]
    val = [mp_batch(rng, 3, 2 * TRAIN_B, TRAIN_SECONDS)]
    state = _random_state(DP_TP_HP, gen)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ranks, single = run_ranks(
            "dp_tp", {"state": state, "train": train, "val": val, "ckpt_dir": ckpt_dir},
            DP_TP_WORLD, lambda: _dp_fit(DP_TP_HP, state, train))
        (first,) = [f for f in os.listdir(ckpt_dir) if f.startswith("epoch_0_")]
        saved = load_checkpoint(os.path.join(ckpt_dir, first))["state"]
        task = LidASRTask(**DP_TP_HP, device="cuda")
        losses = _LossRecorder()
        resumed = Trainer(total_epoch=2, use_progress_bar=False, device="cuda",
                          callbacks=[losses], checkpoint_path=os.path.join(ckpt_dir, first))
        resumed.fit(task, train, val)
    fits = [r["fit"] for r in ranks]
    ckpt_state = {k: v.cpu() for k, v in saved["model"].items()}
    close = _dp_close(ckpt_state, single["state"], single["lr_sum"])
    grads = _dp_grads_close(fits[0]["first_grads"], single["first_grads"])
    loss_gap = max(abs(a - b) for f in fits for a, b in zip(f["losses"][:2], single["losses"]))
    by_model = {}
    for r, f in zip(ranks, fits):
        by_model.setdefault(r["index"]["data"], []).append(f["after"]["replicated"])
    checks = {
        "whole_states_bit_equal": all(bit_equal(f["state"], fits[0]["state"]) for f in fits),
        "model_group_replicated_bit_equal": all(bit_equal(a, b) for a, b in by_model.values()),
        "first_step_gradients": grads["ok"], "checkpoint_vs_single_process": close["ok"],
        "losses": all(np.allclose(f["losses"][:2], single["losses"], rtol=LOSS_RTOL,
                                  atol=LOSS_ATOL) for f in fits),
        "checkpoint_whole": ckpt_state.keys() == state.keys(),
        "resumed_losses": bool(np.allclose(losses.losses, fits[0]["losses"][2:],
                                           rtol=LOSS_RTOL, atol=LOSS_ATOL))
        and len(losses.losses) == 2 and resumed.start_epoch == 1,
    }
    report = {"phase": "dp_tp_card", "nvidia_smi": smi, "mesh": {"data": 2, "model": 2},
              "backend": "gloo, four ranks on cuda:0",
              "model": f"{DP_TP_BLOCKS} x 144 (depth cut from 14), 4 heads of 144",
              "global_batch": [2 * TRAIN_B, int(TRAIN_SECONDS * SR)],
              "single_losses": single["losses"], "rank_losses": [f["losses"] for f in fits],
              "resumed_losses": losses.losses, "max_loss_gap": loss_gap,
              **{k: v for k, v in grads.items() if k != "ok"},
              **{k: v for k, v in close.items() if k != "ok"},
              "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"dp_tp_card failed: {checks}")
    return report


def phase_cli_tp(root: str, corpus: str, smi: str) -> dict:
    """``main_lid`` with ``trainer.model_parallel=2`` (``lid_supervised``:
    three languages, so the heads stay whole) on the corpus for one epoch of
    ``FLAGSHIP_STEPS`` steps, two processes that join a gloo group on
    cuda:0 before they call ``main_lid.main``: it trains and validates (EER,
    Cavg and accuracy logged), rank 0 writes the checkpoint, and that
    checkpoint's validation loss in one process is the logged one within
    ``CLI_TP_LOSS_RTOL``."""
    from speechlid_tpu_torch.cli import main_lid
    from speechlid_tpu_torch.core.config import load_config

    exp = os.path.join(root, "cli_tp")
    overrides = [_langs_override(corpus), "trainer.progress_bar=false",
                 "trainer.total_epoch=1", f"trainer.train_data_factor={FLAGSHIP_DATA_FACTOR}",
                 f"exp_dir={exp}", "trainer.model_parallel=2"]
    run_ranks("cli", {"args": _cli_args("configs", "lid_supervised", *overrides)}, MP_MODEL)
    evals = [line for line in _metrics_lines(os.path.join(exp, "metrics.jsonl"))
             if CLI_EVAL_KEYS <= set(line)]
    ckpt = os.path.join(exp, "ckpt", "last.ckpt")
    conf = load_config("configs", "lid_supervised", overrides)
    data = main_lid.build_data(conf)
    task = main_lid.build_task(conf, data, device="cuda")
    trainer = Trainer(use_progress_bar=False, device="cuda", checkpoint_path=ckpt)
    trainer.trainer_prepare(task)
    again = trainer._run_eval_epoch(main_lid.build_feeder(conf, data["val_dataset"],
                                                          seed=conf.get("seed", 0), train=False))
    logged = evals[-1]["avg_val_loss"] if evals else float("nan")
    gap = abs(again["avg_val_loss"] - logged)
    saved = load_checkpoint(ckpt)["state"]
    checks = {
        "validated": len(evals) == 1 and all(np.isfinite(evals[0][k])
                                             for k in ("avg_val_loss", "val_acc")),
        "eer_cavg_acc_logged": all({"eer", "cavg", "val_acc"} <= set(e) for e in evals),
        "rank0_ckpt": len(saved["device_generators"]) == MP_MODEL
        and saved["model"].keys() == task.model.state_dict().keys(),
        "one_process_val_loss": gap <= CLI_TP_LOSS_RTOL * max(abs(logged), 1.0),
    }
    report = {"phase": "cli_tp", "nvidia_smi": smi, "config": "configs/lid_supervised.yaml",
              "overrides": ["trainer.model_parallel=2", f"train_data_factor "
                            f"{FLAGSHIP_DATA_FACTOR}", "1 epoch"],
              "steps": FLAGSHIP_STEPS, "evals": evals,
              "one_process_avg_val_loss": again["avg_val_loss"], "val_loss_gap": gap,
              "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"cli_tp failed: {checks}")
    return report


def phase_pp_card(gen: torch.Generator, smi: str) -> dict:
    """Pipeline parallelism at the flagship's width: a 4-stage
    ``ConformerBlock(144, heads 4 × 64)`` trunk in eval mode (BatchNorm on
    random running statistics), one stage a rank on the card (data 1 ×
    stage 4), on x (8, 99, 144) with M = 4 and M = 8, against the sequential
    trunk in one process: the output within 2e-5 and each stage's parameter
    gradients of mean(y²) within 5e-5 (atol and rtol); each stage launches
    ``glu``, ``glu_dx`` and ``bwd_w`` once a microbatch.  Then the same
    ranks as data 2 × seq ``SP_SEQ``: ``sp_wav2mel`` at (8, 64000),
    gathered, against the one-process mel within ``FBANK_TOL``, with the
    span each rank's one fbank launch read."""
    states = []
    for _ in range(PP_STAGES):
        block = _pp_block()
        init_random_(block, gen)
        states.append({k: v.cpu() for k, v in block.state_dict().items()})
    x = torch.randn(TRAIN_B, _encoder_frames(TRAIN_SECONDS), FLAGSHIP["encoder_dim"],
                    generator=gen)

    b, t = TRAIN_B, int(TRAIN_SECONDS * SR)
    wavs = 0.1 * torch.randn(b, t, generator=gen)
    lengths = torch.tensor([t - i * 1000 for i in range(b)])

    def sequential():
        blocks = [_pp_block(s) for s in states]
        y = x.cuda()
        for block in blocks:
            y = block(y)
        (y ** 2).mean().backward()
        w, n = wavs.cuda(), lengths.cuda()
        return {"y": y.detach().cpu(),
                "grads": [{n: p.grad.cpu() for n, p in b.named_parameters()} for b in blocks],
                "mel": frontend.wav2mel(frontend.normalize_wav(w, n), lengths=n).cpu()}

    ranks, one = run_ranks("pp", {"states": states, "x": x, "wavs": wavs,
                               "lengths": lengths}, PP_STAGES, sequential)
    worst_y, worst_g, fwd_ok, grad_ok, launches_ok = 0.0, 0.0, True, True, True
    for out in ranks:
        for m in PP_MICROBATCHES:
            got = out[m]
            worst_y = max(worst_y, float((got["y"] - one["y"]).abs().max()))
            fwd_ok &= torch.allclose(got["y"], one["y"], rtol=PP_FWD_TOL, atol=PP_FWD_TOL)
            for n, g in got["grads"].items():
                want = one["grads"][out["stage"]][n]
                worst_g = max(worst_g, float((g - want).abs().max()))
                grad_ok &= torch.allclose(g, want, rtol=PP_GRAD_TOL, atol=PP_GRAD_TOL)
            launches_ok &= got["launches"] == launch_counts(glu=m, glu_dx=m, bwd_w=m)
    sp = [o["sp"] for o in ranks]
    sp_err = max(float((r["mel"] - one["mel"]).abs().max()) for r in sp)
    checks = {"forward": fwd_ok, "gradients": grad_ok, "launches_per_stage": launches_ok,
              "stages": sorted(o["stage"] for o in ranks) == list(range(PP_STAGES)),
              "sp_mel": all(torch.allclose(r["mel"], one["mel"], rtol=FBANK_TOL, atol=FBANK_TOL)
                            for r in sp),
              "sp_one_fbank_launch_a_rank": all(r["fbank_launches"] == 1 for r in sp),
              "sp_spans": all(r["spans"] == [list(FBANK_SHAPES["sp_span"])] for r in sp)}
    report = {"phase": "pp_card", "nvidia_smi": smi, "mesh": {"data": 1, "stage": PP_STAGES},
              "backend": "gloo, four ranks on cuda:0", "x": list(x.shape),
              "microbatches": list(PP_MICROBATCHES), "tol": [PP_FWD_TOL, PP_GRAD_TOL],
              "max_abs_err_y": worst_y, "max_abs_err_grad": worst_g,
              "launches": {m: [o[m]["launches"] for o in ranks] for m in PP_MICROBATCHES},
              "sp_mesh": {"data": PP_STAGES // SP_SEQ, "seq": SP_SEQ}, "sp_wav": [b, t],
              "sp_max_abs_err_db": sp_err, "sp_tol_db": FBANK_TOL,
              "sp_local_mel": [r["local"] for r in sp], "sp_fbank_spans": [r["spans"] for r in sp],
              "sp_fbank_launches": [r["fbank_launches"] for r in sp],
              "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"pp_card failed: {checks}")
    return report


def phase_dryrun_card(smi: str) -> dict:
    """``parallel.dryrun.dryrun_multichip(4, "cuda")``: the tiny flagship's
    step on 1 × 2 × 2 data × seq × model and the 4-stage trunk on 1 × 4,
    each held to one process (``sp_wav2mel`` at the flagship's shape runs
    in ``pp_card``)."""
    from speechlid_tpu_torch.parallel.dryrun import dryrun_multichip

    dry = dryrun_multichip(4, "cuda")
    checks = {"dryrun": all(dry["checks"].values())}
    report = {"phase": "dryrun_card", "nvidia_smi": smi, "dryrun": dry, "checks": checks}
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"dryrun_card failed: {checks}")
    return report


def phase_mp(gen: torch.Generator, root: str, corpus: str, smi: str) -> dict:
    """This slice's phases in order; → their reports."""
    return {"tp": phase_tp_card_vs_single(gen, smi), "dp_tp": phase_dp_tp_card(gen, smi),
            "cli": phase_cli_tp(root, corpus, smi), "pp": phase_pp_card(gen, smi),
            "dryrun": phase_dryrun_card(smi)}


def mp_kernel_rows(gen: torch.Generator, errs: dict, reports: dict) -> list:
    """The ``kernels`` line's rows of the model-parallel paths: the conv
    kernel's modes at a model rank's C = 144 (the train step's ``glu``,
    ``glu_dx`` and ``bwd_w``, the eval forward's ``glu_bn_act``, with the
    launches the wrappers counted at that width over both ranks in
    ``tp_card_vs_single``), and the fbank kernel on a seq rank's wave span
    in ``pp_card`` (every rank's launches, as its wrapper counted them)."""
    tp = reports["tp"]
    n_steps = MP_MODEL * TP_STEPS
    at = {k: sum(w.get(f"{k}@{MP_ENCODER_C}", 0) for r in tp["step_widths"] for w in r)
          for k in ("glu", "glu_dx", "bwd_w")}
    evaluated = sum(w.get(f"glu_bn_act@{MP_ENCODER_C}", 0) for w in tp["eval_widths"])
    on = (f"tp_card_vs_single: {MP_MODEL} model ranks x {TP_STEPS} deterministic train steps "
          f"of B = {TRAIN_B}, launches at C = {MP_ENCODER_C}")
    per = {k: {"launches_counted_on": on, "launches_per_rank_step": n / n_steps}
           for k, n in at.items()}
    rows = fused_kernel_rows(gen, errs["conv_fused"], {
        "depthwise_conv1d_fwd[glu_bn_act]@tp": (evaluated, {
            "launches_counted_on": f"tp_card_vs_single: one eval forward on each of "
                                   f"{MP_MODEL} model ranks, launches at C = {MP_ENCODER_C}"}),
        "depthwise_conv1d_fwd[glu]@tp": (at["glu"], per["glu"]),
        "depthwise_conv1d_fwd[glu_dx]@tp": (at["glu_dx"], per["glu_dx"]),
    }, eval_rows=(("depthwise_conv1d_fwd[glu_bn_act]@tp", TP_DW_SHAPE),),
        train_shape=TP_DW_SHAPE, train_suffix="@tp")
    row = bwd_w_row(gen, errs["conv_fused"], TP_DW_SHAPE, "depthwise_conv1d_bwd_w@tp",
                    {"depthwise_bwd_w": at["bwd_w"]}, n_steps)
    row["launches_per_rank_step"] = row.pop("launches_per_train_step")
    row["launches_counted_on"] = on
    rows.append(row)
    sp = reports["pp"]
    rows.append(fbank_row("fbank_log_mel@sp", "sp_span", gen, errs,
                          sum(sp["sp_fbank_launches"]), {
        "launches_counted_on": f"pp_card: sp_wav2mel of ({TRAIN_B}, {int(TRAIN_SECONDS * SR)}) "
                               f"on data {PP_STAGES // SP_SEQ} x seq {SP_SEQ} ranks",
        "spans": sp["sp_fbank_spans"]}))
    for row in rows:
        if not row["launches"] > 0:
            raise AssertionError(f"{row['name']} was not launched on its path")
    return rows


# ------------------------------------------------ the WavLM-Large extra-finetune, remat,
# async checkpoint writes and float16

LARGE_LANGS = ("aa", "bb")
LARGE_TRAIN_CLIPS = 2  # a language's clips in each train bucket: one batch of LARGE_B
LARGE_VAL_CLIPS = 2  # a language's val clips, 1.5 s: one eval batch in the 2 s bucket
LARGE_STEPS = len(LARGE_LANGS) * len(LARGE_BUCKETS) * LARGE_TRAIN_CLIPS // LARGE_B
LARGE_EVAL_BATCHES = len(LARGE_LANGS) * LARGE_VAL_CLIPS // LARGE_B
# a micro-batch trains the own head's conv module at C = 2048; an eval batch
# runs every head's
LARGE_TRAIN_STEP_LAUNCHES = launch_counts(bwd_w=1, glu=1, glu_dx=1)
LARGE_PER_EVAL_LAUNCHES = launch_counts(glu_bn_act=len(LARGE_LANGS))
LARGE_CLI = dict(
    name="cli_wavlm_large", config="lid_extra_finetune",
    describe="configs/lid_extra_finetune.yaml at its own width (WavLM-Large 24x1024, "
             "layer-norm extractor, pre-LN, hidden_states, SGD, accum_grad 4), seeded random "
             "weights, two languages of tones",
    steps=LARGE_STEPS, eval_batches=LARGE_EVAL_BATCHES, train_shapes=LARGE_TRAIN_DW_SHAPES,
    eval_shape=LARGE_EVAL_DW_SHAPE, per_step=LARGE_TRAIN_STEP_LAUNCHES,
    per_eval=LARGE_PER_EVAL_LAUNCHES, n_lang=len(LARGE_LANGS), val_per_lang=LARGE_VAL_CLIPS,
    test_best=True)
# the Large task for the remat and checkpoint phases: the config's module
# block over the flagship's three languages
LARGE_HP = dict(
    lang2vocab=FLAGSHIP["lang2vocab"], lang2index=FLAGSHIP["lang2index"], featurizer="wavlm",
    ssl_config=WAVLM_LARGE, feature_selection="hidden_states", head_type="conformer_linear",
    head_layers=1, head_dim_head=32, head_num_head=8, dropout=0.1, lr=1e-4, optimizer="sgd",
    schedule="tristage", schedule_conf=dict(phase_ratio=[0.1, 0.4, 0.5], max_update=100000),
    clip_norm=20.0)
# remat off and on, every random draw on (dropout, span and channel masks,
# stochastic depth, SpecAugment, stretch), the generators seeded alike: the
# step of each model at its path's batch, and what it launches; with remat a
# Conformer block's conv module runs its training forward again in the
# backward, the WavLM heads are not rematerialized
REMAT_MODELS = {
    "large": dict(hp=LARGE_HP, b=LARGE_B, seconds=13.0, per_step=WAVLM_TRAIN_STEP_LAUNCHES,
                  remat_per_step=WAVLM_TRAIN_STEP_LAUNCHES),
    "base_plus": dict(hp=WAVLM, b=8, seconds=4.0, per_step=WAVLM_TRAIN_STEP_LAUNCHES,
                      remat_per_step=WAVLM_TRAIN_STEP_LAUNCHES),
    "flagship": dict(hp=dict(FLAGSHIP, **TRAIN_HPARAMS), b=8, seconds=4.0,
                     per_step=TRAIN_STEP_LAUNCHES,
                     remat_per_step=launch_counts(fbank=1, bwd_w=DW_PER_TRAIN_STEP,
                                                  glu=DW_PER_TRAIN_STEP + N_BLOCKS,
                                                  glu_dx=DW_PER_TRAIN_STEP)),
}
REMAT_STEPS = 3  # steps of a turn, after one more
REMAT_TURNS = (False, True, True, False)
# card against CPU in float16, as bfloat16 (BF16_*) with 3 more mantissa bits
F16_SCORE_TOL = 5e-3  # scores, of the largest score
F16_LOSS_TOL = 2e-3  # the train step's loss, of its size
F16_GRAD_TOL = 1e-2  # each gradient's relative L2 distance, as BF16_GRAD_TOL
F16_HP = dict(FLAGSHIP, dtype="float16")
F16_PER_FORWARD_LAUNCHES = launch_counts(fbank=1, glu_bn_act=DW_PER_FORWARD, f16=True)
# the float16 step's clips, 2 s: the eval CLI's conv shape (8, 49, 288); the
# CPU's float16 step on 4 s clips took 27.5 s of the script's time limit
F16_TRAIN_SECONDS = 2.0
F16_TRAIN_STEP_LAUNCHES = launch_counts(fbank=1, bwd_w=DW_PER_TRAIN_STEP, glu=DW_PER_TRAIN_STEP,
                                        glu_dx=DW_PER_TRAIN_STEP, f16=True)


def large_corpus(root: str) -> str:
    """Two languages of tones under noise for the Large run, each clip
    0.25 s under its bucket: per language ``LARGE_TRAIN_CLIPS`` train clips
    in each of ``LARGE_BUCKETS`` (a batch of 2 in each) and
    ``LARGE_VAL_CLIPS`` val clips of 1.5 s; texts of the language's own
    four letters, longer for longer clips."""
    from speechlid_tpu_torch.data.audio_io import write_wav

    corpus = os.path.join(root, "large_corpus")
    rng = np.random.RandomState(7)
    seconds = {"train": [s - 0.25 for s in LARGE_BUCKETS for _ in range(LARGE_TRAIN_CLIPS)],
               "val": [1.5] * LARGE_VAL_CLIPS}
    for li, lang in enumerate(LARGE_LANGS):
        wav_dir = os.path.join(corpus, lang, "wav", "train")
        os.makedirs(wav_dir)
        letters = list("abcd" if li == 0 else "efgh")
        for split, durations in seconds.items():
            lines = []
            for i, sec in enumerate(durations):
                n = int(sec * SR)
                tone = np.sin(2 * np.pi * (180 + 150 * li + 25 * i) * np.arange(n) / SR)
                write_wav(os.path.join(wav_dir, f"{split}{i}.wav"),
                          (0.3 * tone + 0.01 * rng.randn(n)).astype(np.float32), SR)
                words = ("".join(rng.choice(letters, 3)) for _ in range(2 + int(sec)))
                lines.append(f"{split}{i}.wav\t{' '.join(words)}")
            with open(os.path.join(corpus, lang, f"{split}.txt"), "w") as f:
                f.write("\n".join(lines))
    return corpus


def _remat_owner(task: LidASRTask):
    """The module whose ``remat`` switch covers the task's encoder."""
    featurizer = task.model.featurizer
    return featurizer if task.featurizer_kind == "conformer" else featurizer.upstream


def phase_remat(gen: torch.Generator, smi: str) -> tuple:
    """``remat`` off and on for each of ``REMAT_MODELS`` (WavLM-Large at
    (2, 13 s), WavLM-Base+ and the Conformer flagship at (8, 4 s)), one
    model each with seeded random weights and the switch flipped on it.
    One step each way from generators seeded alike: the loss within
    ``TRAIN_TOL`` of its size and every gradient within ``TRAIN_TOL`` of its
    largest entry (the leaves whose true gradient is 0 of the largest
    gradient of all) — the card's backward sums with atomics in no fixed
    order, so the two are not bit-equal here as they are on the CPU — and
    the launches of each step (counted from 0 just before it).  Then the
    peak ``torch.cuda.max_memory_allocated`` of a forward and backward, in
    turns off, on, on, off (``REMAT_STEPS`` steps a turn).  → (the reports,
    the Large task)."""
    reports, large = {}, None
    for name, spec in REMAT_MODELS.items():
        task = LidASRTask(**spec["hp"], device="cuda")
        init_model_("conformer" if name == "flagship" else "wavlm", task, gen)
        owner = _remat_owner(task)
        batch = synthetic_batch(np.random.RandomState(5), lang=1, b=spec["b"],
                                seconds=spec["seconds"])
        placed = task.place_batch(batch)
        task.model.train()

        def step(remat: bool) -> torch.Tensor:
            owner.remat = remat
            task.set_generators(torch.Generator(task.device).manual_seed(0),
                                torch.Generator().manual_seed(0))
            task.model.zero_grad(set_to_none=True)
            loss, _ = task.train_loop(placed)
            loss.backward()
            return loss

        runs = {}
        for remat in (False, True):
            torch.cuda.synchronize()
            reset_launches()
            loss = step(remat).item()
            runs[remat] = (loss, launches(), {n: p.grad.clone() for n, p in
                                              task.model.named_parameters() if p.grad is not None})
        (loss_off, counted_off, grads_off), (loss_on, counted_on, grads_on) = runs[False], runs[True]
        largest = max(float(g.abs().max()) for g in grads_off.values())
        worst, worst_name = 0.0, ""
        for n, g in grads_off.items():
            if n.endswith(("depthwise.bias", "k_proj.bias")):  # true gradient 0
                err = float((grads_on[n] - g).abs().max()) / largest
            else:
                err = float((grads_on[n] - g).abs().max()) / max(float(g.abs().max()),
                                                                  1e-6 * largest)
            if err > worst:
                worst, worst_name = err, n
        same_leaves = set(grads_off) == set(grads_on)
        del runs, grads_off, grads_on
        task.model.zero_grad(set_to_none=True)
        peak, base = {False: [], True: []}, {False: [], True: []}
        for remat in REMAT_TURNS:
            step(remat)
            task.model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            base[remat].append(torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            for _ in range(REMAT_STEPS):
                step(remat)
            torch.cuda.synchronize()
            peak[remat].append(torch.cuda.max_memory_allocated())
        task.model.zero_grad(set_to_none=True)
        gib = 2.0 ** 30
        report = {
            "phase": "remat", "model": name, "nvidia_smi": smi,
            "batch": [spec["b"], spec["seconds"]], "loss_off": loss_off, "loss_on": loss_on,
            "rel_err_loss": abs(loss_on - loss_off) / max(abs(loss_off), 1.0),
            "max_rel_err_gradient": worst, "worst_gradient": worst_name, "tol": TRAIN_TOL,
            "launches_off": counted_off, "launches_on": counted_on,
            "peak_gib": {"off": [p / gib for p in peak[False]],
                         "on": [p / gib for p in peak[True]]},
            "before_step_gib": {"off": [b / gib for b in base[False]],
                                "on": [b / gib for b in base[True]]},
            "turns": ["on" if r else "off" for r in REMAT_TURNS], "steps_a_turn": REMAT_STEPS,
            "measured": "one forward and backward (no optimizer step), peak of "
                        "torch.cuda.max_memory_allocated after zero_grad(set_to_none)",
        }
        checks = {"same_leaves": same_leaves, "loss": report["rel_err_loss"] <= TRAIN_TOL,
                  "gradients": worst <= TRAIN_TOL,
                  "launches_off": counted_off == spec["per_step"],
                  "launches_on": counted_on == spec["remat_per_step"],
                  "less_memory": max(peak[True]) < min(peak[False])}
        report["checks"] = checks
        emit(report)
        if not all(checks.values()):
            raise AssertionError(f"remat on the {name} step failed: {checks}")
        reports[name] = report
        if name == "large":
            owner.remat = False
            large = task
        del task, placed
        gc.collect()
        torch.cuda.empty_cache()
    return reports, large


def phase_async_ckpt(task: LidASRTask, root: str, smi: str) -> dict:
    """How long the train loop is blocked by ``CkptCallback`` writing
    ``last.ckpt`` of the WavLM-Large task (its trainer's whole state: model,
    SGD, generators), with ``async_write`` off and on, in turns off, on,
    on, off: the callback's wall time (the state gathered and, off, written;
    on, copied to fresh host memory while a thread serializes and writes),
    and on, the time until the write has landed.  Right after each call a
    parameter moves in place, as the next optimizer step would: the file
    holds its value from before the call both ways."""
    task.init_parameters = lambda generator: None  # keep the weights it has
    trainer = Trainer(total_epoch=1, device=task.device, use_progress_bar=False)
    trainer.trainer_prepare(task)
    name, param = next(iter(task.model.named_parameters()))
    blocked, landed, kept, sizes = {False: [], True: []}, [], [], []
    for i, async_write in enumerate((False, True, True, False)):
        cb = CkptCallback(os.path.join(root, "async_ckpt", str(i)), async_write=async_write)
        cb.add_trainer(trainer)
        before = param.detach().cpu().clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cb.after_eval_epoch(0, {"avg_val_loss": float("nan")})  # last.ckpt alone
        blocked[async_write].append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            param.add_(1.0)  # the next step, in place, while the write may be in flight
        wait_for_checkpoints()
        if async_write:
            landed.append((time.perf_counter() - t0) * 1e3)
        path = os.path.join(cb.ckpt_path, "last.ckpt")
        saved = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
        kept.append(torch.equal(saved["state"]["model"][name], before))
        sizes.append(os.path.getsize(path))
        del saved
        os.remove(path)
        with torch.no_grad():
            param.sub_(1.0)
    del trainer
    report = {"phase": "async_ckpt", "nvidia_smi": smi,
              "model": "WavLM-Large joint task (3 heads at 1024), SGD",
              "params": sum(p.numel() for p in task.model.parameters()),
              "file_bytes": sizes, "blocked_ms": {"off": blocked[False], "on": blocked[True]},
              "write_landed_ms_on": landed, "turns": ["off", "on", "on", "off"],
              "pre_step_values_kept": kept}
    checks = {"kept": all(kept), "faster": max(blocked[True]) < min(blocked[False])}
    report["checks"] = checks
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"async checkpoint writes failed: {checks}")
    return report


def phase_f16_card_vs_cpu(gen: torch.Generator, smi: str) -> dict:
    """The flagship with ``dtype="float16"`` on the card (the depthwise
    kernel's float16 instantiations) against the same state_dict in
    float16 on the CPU: inference at B = 8 on ragged 2 s clips (the eval
    CLI's conv shape), scores within ``F16_SCORE_TOL`` of the largest,
    ``pred_lang`` equal where the CPU's margin is clear of twice the
    scores' distance, every depthwise launch in float16; and one
    deterministic B = 8, 2 s train step held as
    :func:`phase_bf16_train_card_vs_cpu` holds bfloat16's against a float32
    step on the card, at ``F16_LOSS_TOL`` and ``F16_GRAD_TOL``, that step
    taking the card's subsampling ReLU decisions too.  → the launches of
    the forward and of the step."""
    task = LidASRTask(**F16_HP, device="cuda")
    init_random_(task.model, gen)
    cpu = LidASRTask(**F16_HP, device="cpu")
    cpu.model.load_state_dict(task.model.state_dict())
    wavs = 0.1 * torch.randn(8, 2 * SR, generator=gen)
    lengths = torch.tensor([2 * SR - i * SR // 8 for i in range(8)])
    got, ref, per_forward, errs = infer_card_vs_cpu(task, cpu, wavs, lengths)
    neg = torch.finfo(torch.float32).min
    largest = ref["scores"].abs().max().item()
    score_err = errs["max_abs_err_scores"]
    top2 = ref["scores"].sort(dim=-1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * score_err
    batch = synthetic_batch(np.random.RandomState(4), lang=1, b=8, seconds=F16_TRAIN_SECONDS)
    step = conformer_step_card_vs_cpu(dict(CONFORMER_DETERMINISTIC, dtype="float16"), gen, batch,
                                      F16_GRAD_TOL, pin_reference=True)
    report = {"phase": "f16_card_vs_cpu", "nvidia_smi": smi,
              "config": "flagship 14x144, heads 3x(40,96,88), dtype float16",
              "infer_batch": [8, 2 * SR], "lengths": lengths.tolist(), **errs,
              "rel_err_scores": score_err / largest, "tol_of_largest_score": F16_SCORE_TOL,
              "pred_lang_compared": clear.tolist(), "launches_per_forward": per_forward,
              "train_batch": [8, int(F16_TRAIN_SECONDS * SR)], "tol_loss": F16_LOSS_TOL,
              "tol_gradient": F16_GRAD_TOL, **step}
    checks = {
        "finite": bool(torch.isfinite(got["scores"]).all()
                       and torch.isfinite(got["logits"][ref["logits"] > neg]).all()),
        "float32_logits": got["logits"].dtype == torch.float32,
        "scores": score_err <= F16_SCORE_TOL * largest,
        "pred_lang": torch.equal(got["pred_lang"][clear], ref["pred_lang"][clear]),
        "launches_forward": per_forward == F16_PER_FORWARD_LAUNCHES,
        "step": (step["same_leaves"] and step["rel_err_loss"] <= F16_LOSS_TOL
                 and step["max_card_over_bar"] <= 1.0
                 and step["rel_l2_card_vs_float32"] <= 2 * step["rel_l2_cpu_vs_float32"] + 1e-3),
        "launches_step": step["launches_per_train_step"] == F16_TRAIN_STEP_LAUNCHES,
    }
    report["checks"] = checks
    emit(report)
    if not all(checks.values()):
        raise AssertionError(f"the float16 flagship on the card disagrees with the CPU: {checks}")
    return {"per_forward": per_forward, "per_step": step["launches_per_train_step"]}


def phase_large(gen: torch.Generator, root: str, smi: str) -> dict:
    """This slice's phases in order: ``conv_fused`` at the WavLM-Large
    heads' shapes (here, so that the phases before draw from ``gen`` what
    they drew before this slice), the Large corpus, ``cli_wavlm_large``,
    ``remat``, ``async_ckpt`` and ``f16_card_vs_cpu``; → their reports."""
    conv_fused = phase_conv_fused(gen, LARGE_TRAIN_DW_SHAPES)
    t0 = time.perf_counter()
    cli = phase_cli_wavlm(root, large_corpus(root), smi, LARGE_CLI)
    t1 = time.perf_counter()
    remat, large = phase_remat(gen, smi)
    t2 = time.perf_counter()
    ckpt = phase_async_ckpt(large, root, smi)
    del large
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    f16 = phase_f16_card_vs_cpu(gen, smi)
    emit({"phase": "large_seconds", "cli_wavlm_large": t1 - t0, "remat": t2 - t1,
          "async_ckpt": t3 - t2, "f16_card_vs_cpu": time.perf_counter() - t3})
    return {"conv_fused": conv_fused, "cli": cli, "remat": remat, "async_ckpt": ckpt,
            "f16": f16}


def large_kernel_rows(gen: torch.Generator, errs: dict, reports: dict) -> list:
    """The ``kernels`` line's rows of this slice: the depthwise kernel at the
    WavLM-Large heads' C = 2048 (eval at the eval bucket's shape, the
    training forward, dX with the GLU backward and dW/db at the 13 s
    bucket's), their launches the wrappers' own counts at C = 2048 over
    ``cli_wavlm_large``'s runs (every bucket); and its float16
    instantiations at the flagship's (8, 49, 288) (2 s clips), their
    launches those of ``f16_card_vs_cpu``'s forward and step."""
    widths, c = reports["cli"]["widths"], LARGE_DW_C
    on_cli = "cli_wavlm_large's fit and resume, every bucket (2, 99 … 649, 2048)"
    rows = fused_kernel_rows(gen, reports["conv_fused"], {
        "depthwise_conv1d_fwd[glu_bn_act]@large_eval": (widths[f"glu_bn_act@{c}"], {
            "launches_counted_on": "cli_wavlm_large's eval batches"}),
        "depthwise_conv1d_fwd[glu]@large_train": (widths[f"glu@{c}"], {
            "launches_counted_on": on_cli}),
        "depthwise_conv1d_fwd[glu_dx]@large_train": (widths[f"glu_dx@{c}"], {
            "launches_counted_on": on_cli}),
    }, eval_rows=(("depthwise_conv1d_fwd[glu_bn_act]@large_eval", LARGE_EVAL_DW_SHAPE),),
        train_shape=LARGE_TRAIN_DW_SHAPES[-1], train_suffix="@large_train")
    n_steps = LARGE_STEPS * 4  # three epochs and the resumed fourth
    rows.append(bwd_w_row(gen, reports["conv_fused"], LARGE_TRAIN_DW_SHAPES[-1],
                          "depthwise_conv1d_bwd_w@large_train",
                          {"depthwise_bwd_w": widths[f"bwd_w@{c}"]}, n_steps))
    per_forward, per_step = reports["f16"]["per_forward"], reports["f16"]["per_step"]
    rows += fused_kernel_rows(gen, errs["conv_fused"], {
        "depthwise_conv1d_fwd[glu_bn_act]@f16_eval": (per_forward["depthwise_glu_bn_act"], {
            "launches_counted_on": "one float16 flagship forward at B = 8 on 2 s clips"}),
        "depthwise_conv1d_fwd[glu]@f16_train": (per_step["depthwise_glu"], {
            "launches_counted_on": "one float16 flagship train step at B = 8 x 2 s"}),
        "depthwise_conv1d_fwd[glu_dx]@f16_train": (per_step["depthwise_glu_dx"], {
            "launches_counted_on": "one float16 flagship train step at B = 8 x 2 s"}),
    }, eval_rows=(("depthwise_conv1d_fwd[glu_bn_act]@f16_eval", EVAL_DW_SHAPE),),
        train_shape=EVAL_DW_SHAPE, train_suffix="@f16_train", dtype=torch.float16)
    rows.append(bwd_w_row(gen, errs["conv_fused"], EVAL_DW_SHAPE,
                          "depthwise_conv1d_bwd_w@f16_train", per_step, 1, dtype=torch.float16))
    for row in rows:
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on its path")
    return rows


def _only_cli_gate(run) -> None:
    phase_cli_gate(run.root, run.corpus, run.smi, [f"seed={run.seed}"])


def _only_ce_asr(run) -> list:
    cross, asr = phase_ce_asr(run.gen, run.root, run.corpus, phase_eval_inputs(run.root)[1],
                              run.smi)
    return ce_asr_kernel_rows(run.gen, run.errs, cross, phase_ce_launches(run.gen), asr)


def _only_se(run) -> list:
    eval_se, bilstm = phase_se(run.gen, run.root, run.corpus, phase_eval_inputs(run.root),
                               run.smi)
    return se_bilstm_kernel_rows(run.gen, run.errs, eval_se, bilstm)


def _only_quant(run) -> list:
    reports = phase_quant(run.gen, run.root, run.corpus, run.smi)
    phase_quant_launches(run.gen)
    return quant_kernel_rows(run.gen, run.errs, reports)


def _only_relpos_attn(run) -> list:
    rows = phase_relpos_attn(run.gen)
    phase_cli_w2v2_conformer(run.root, run.corpus)
    return rows


# --only name → (fbank and conv_fused first, the corpus, cli_flagship's
# checkpoint, then the phases: a function of the run → the kernels line's
# rows, or None for no such line)
ONLY = {
    "cli_gate": (False, True, False, _only_cli_gate),
    "ce_asr": (True, True, False, _only_ce_asr),
    "se": (True, True, True, _only_se),
    "quant": (True, True, True, _only_quant),
    "extras": (True, False, False, lambda run: extras_kernel_rows(
        run.gen, run.errs, phase_extras(run.gen, run.root, run.smi))),
    "dist": (True, True, False, lambda run: dist_kernel_rows(
        run.gen, run.errs, phase_dist(run.gen, run.root, run.corpus, run.smi))),
    "mp": (True, True, False, lambda run: mp_kernel_rows(
        run.gen, run.errs, phase_mp(run.gen, run.root, run.corpus, run.smi))),
    "large": (True, False, False, lambda run: large_kernel_rows(
        run.gen, run.errs, phase_large(run.gen, run.root, run.smi))),
    "subsample": (False, False, False, lambda run: phase_subsample(run.gen)),
    "relpos_attn": (False, True, False, _only_relpos_attn),
}


def run_only(name: str, gen: torch.Generator, smi: str, seed: int) -> None:
    """The phases of ``--only name`` (:data:`ONLY`) after the build."""
    checks, needs_corpus, needs_flagship, phases = ONLY[name]
    errs = {"fbank": phase_fbank(gen), "conv_fused": phase_conv_fused(gen)} if checks else {}
    with tempfile.TemporaryDirectory() as root:
        os.environ["SPEECHLID_CACHE_DIR"] = os.path.join(root, "cache")  # manifest scans
        corpus = phase_cli_corpus(root) if needs_corpus else None
        if needs_flagship:
            phase_cli_flagship(root, corpus)
        rows = phases(types.SimpleNamespace(gen=gen, errs=errs, root=root, corpus=corpus,
                                            smi=smi, seed=seed))
    if rows is not None:
        emit({"kernels": rows})


def run_all(gen: torch.Generator, smi: str) -> None:
    """Every phase, then the kernels line."""
    errs = {"fbank": phase_fbank(gen), "depthwise": phase_depthwise(gen),
            "depthwise_bwd": phase_depthwise_bwd(gen), "conv_fused": phase_conv_fused(gen)}
    clear_launches("relpos")
    task = phase_model(gen)
    relpos_scoring = _relpos_launches()
    serve_report = phase_serve(task, gen)
    served = serve_report["launches"]
    clear_launches("relpos")
    phase_train_card_vs_cpu(gen)
    relpos_flagship = (relpos_scoring, _relpos_launches())
    trained, training = phase_train(gen)
    with tempfile.TemporaryDirectory() as root:
        os.environ["SPEECHLID_CACHE_DIR"] = os.path.join(root, "cache")  # manifest scans
        corpus = phase_cli_corpus(root)
        cli, cli_report = phase_cli_flagship(root, corpus)
        gate_report = phase_cli_gate(root, corpus, smi)
        phase_tf32_entry(gen)
        phase_eval_ops(gen)
        inputs = phase_eval_inputs(root)
        flagship_eval = phase_cli_eval(
            "flagship", root, os.path.join(root, "flagship", "ckpt", "last.ckpt"),
            _cli_args("configs", "lid_supervised", _langs_override(corpus)),
            cli_report["evals"][-1]["val_acc"], N_BLOCKS,
            {"fbank": FBANK_SHAPES["eval"], "glu_bn_act": EVAL_DW_SHAPE}, inputs, smi,
            single_cell=True)
        phase_cli_eval(
            "gate", root, os.path.join(root, "gate", "ckpt", "last.ckpt"),
            _cli_args(os.path.join(root, "conf"), "gate"),
            gate_report["trajectory"][-1]["val_acc"], 4,
            {"fbank": FBANK_SHAPES["gate_eval"], "glu_bn_act": GATE_DW_SHAPE}, inputs, smi,
            single_cell=False)
        phase_cli_augment(root, corpus)
        wavlm_task = phase_wavlm_model(gen)
        wavlm_serve = phase_serve(wavlm_task, gen, WAVLM_PER_FORWARD_LAUNCHES, "wavlm_serve")
        phase_wavlm_train_card_vs_cpu(gen)
        wavlm_cli = phase_cli_wavlm(root, corpus, smi)
        phase_cli_w2v2_conformer(root, corpus)
        phase_bf16_model(gen, "conformer")
        phase_bf16_model(gen, "wavlm")
        phase_bf16_train_card_vs_cpu(gen)
        bf16_cli = phase_cli_wavlm(root, corpus, smi, WAVLM_BF16_CLI)
        cross_cli, asr_cli = phase_ce_asr(gen, root, corpus, inputs[1], smi)
        eval_se, bilstm = phase_se(gen, root, corpus, inputs, smi)
        quant_reports = phase_quant(gen, root, corpus, smi)
        extras_reports = phase_extras(gen, root, smi)
        dist_reports = phase_dist(gen, root, corpus, smi)
        mp_reports = phase_mp(gen, root, corpus, smi)
        large_reports = phase_large(gen, root, smi)
    phase_quant_launches(gen)
    ce_launched = phase_ce_launches(gen)
    bf16_launched = phase_bf16_launches(gen)
    wavlm_launched = phase_wavlm_launches(wavlm_task, gen)
    kernels = flagship_kernel_rows(task, gen, errs, served, serve_report, trained, training, cli,
                                   flagship_eval)
    kernels += wavlm_kernel_rows(gen, errs, wavlm_launched, wavlm_serve, wavlm_cli)
    kernels += bf16_kernel_rows(gen, errs, bf16_launched, bf16_cli)
    kernels += ce_asr_kernel_rows(gen, errs, cross_cli, ce_launched, asr_cli)
    kernels += se_bilstm_kernel_rows(gen, errs, eval_se, bilstm)
    kernels += quant_kernel_rows(gen, errs, quant_reports)
    kernels += extras_kernel_rows(gen, errs, extras_reports)
    kernels += dist_kernel_rows(gen, errs, dist_reports)
    kernels += mp_kernel_rows(gen, errs, mp_reports)
    kernels += large_kernel_rows(gen, errs, large_reports)
    kernels += phase_subsample(gen)
    kernels += phase_relpos_attn(gen, relpos_flagship)
    emit({"kernels": kernels})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port on one card.")
    parser.add_argument("--only", choices=tuple(ONLY),
                        help="run this phase alone, after the build and the corpus "
                             "(ce_asr: the cross-entropy and ASR phases; se: the speech "
                             "enhancement and bilstm phases on cli_flagship's checkpoint; "
                             "quant: the int8, SWA and Novograd phases, on it too; "
                             "extras: kaldi fbank, FBankLayer, the extras tasks, the sweep "
                             "and the trainer's trace; "
                             "dist: data-parallel training on two ranks and through the CLI, "
                             "and SELDNet; "
                             "mp: tensor, expert, pipeline and sequence parallelism, the "
                             "model-parallel CLI and the dryrun; "
                             "large: the WavLM-Large extra-finetune through the CLI, remat, "
                             "async checkpoint writes and float16; "
                             "subsample: the Conv2d subsampling kernels, and the flagship's "
                             "scoring forward and training step through them; "
                             "relpos_attn: the rel-pos attention kernels, Shaw's and the "
                             "Transformer-XL form, the flagship's and the wav2vec 2.0 "
                             "Conformer's scoring forward and training step through them, "
                             "and the latter's recipe through the CLI; "
                             "each with the kernel checks and rows they need)")
    parser.add_argument("--seed", type=int, default=0,
                        help="the CLI's seed for --only cli_gate (the gate's own is 0)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    gen = torch.Generator().manual_seed(0)
    smi = phase_build()
    if args.only:
        run_only(args.only, gen, smi, args.seed)
    else:
        run_all(gen, smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
