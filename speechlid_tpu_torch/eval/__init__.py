"""Noise-robustness evaluation (port of ``speechlid_tpu/eval``): the
evaluator with its noise bank and LM arbitration, and the SNR × noise and
blend-factor sweeps."""

from speechlid_tpu_torch.eval.harness import LidEvaluator, NoiseBank
from speechlid_tpu_torch.eval.sweep import run_factor_sweep, run_sweep
