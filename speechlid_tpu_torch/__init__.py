"""speechlid_tpu_torch — the PyTorch/CUDA port of ``speechlid_tpu``.

The JAX package beside it is the reference: each module here has a
counterpart of the same name there, and the tests under
``tests/test_torch_*.py`` hold the two against each other on the CPU.  This
package imports ``torch``, numpy and the standard library only — never JAX,
flax or anything under ``speechlid_tpu``.

The TPU's Pallas kernels become CUDA C++ kernels written for Hopper
(``csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at first use and loaded
with ``ctypes``, see ``ops/cuda/_build.py``).  Each kernel keeps a plain
PyTorch version beside it; a wrapper takes that version only for a tensor
on the CPU, and on a CUDA tensor launches the kernel or raises.

Layout (the slices ported so far: Conformer joint-LID ``/lid`` serving,
joint LID+ASR training of the same model through its CLI with waveform
augmentation, and its offline evaluation under noise):

- ``ops``     — frontend (normalize, preemphasis, log-mel, time stretch,
  SpecAugment), waveform augmentation and resampling, CTC, and the kernels
  (fbank; depthwise conv forward, dX and dW/db)
- ``models``  — Conformer encoder, per-language heads, discriminator, in eval
  and training mode
- ``tasks``   — ``LidASRTask``: training, validation and inference
- ``metrics`` — EER, Cavg, CER/WER on the host
- ``convert`` — flax variables ↔ ``state_dict``
- ``core``    — ``Trainer``, ``TaskModule``, optimizer and schedules,
  callbacks, loggers, seeding, float32 precision on the card, the build of
  the host C++ libraries, and checkpoints (the port's own, and reading the
  JAX package's without JAX)
- ``data``    — manifests, tokenizer, sampler, bucketed feeder, audio I/O and
  the train-time waveform augmentor
- ``eval``    — the noisy evaluator (noise bank, LM arbitration) and its sweeps
- ``decode``  — the native CTC beam search and n-gram LM (``csrc/ctc_decoder``)
- ``cli``     — the ``/lid`` HTTP server, the training CLI and the eval CLI
"""
