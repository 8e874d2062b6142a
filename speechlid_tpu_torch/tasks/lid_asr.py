"""Joint LID + per-language CTC-ASR task, inference (port of
``speechlid_tpu/tasks/lid_asr.py``).

Builds the same model from the same hyper-parameter names as the JAX
``LidASRTask`` (so a JAX checkpoint's ``hyper_parameters`` construct it),
for the Conformer featurizer: eval frontend → ``ConformerModel`` →
``MutiLangModel.infer``.  Training hooks (CTC loss, freeze gates, metrics)
and the SSL featurizers are not ported yet; hyper-parameters that only they
read are accepted and ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from speechlid_tpu_torch.models.conformer import ConformerModel
from speechlid_tpu_torch.models.multilang import MutiLangModel
from speechlid_tpu_torch.ops.frontend import fused_frontend


class LidASRTask:
    def __init__(
        self,
        lang2vocab: Dict[str, int],
        lang2index: Dict[str, int],
        featurizer: str = "conformer",
        n_blocks: int = 14,
        encoder_dim: int = 144,
        heads: int = 4,
        dim_head: int = 64,
        sub_sampling: int = 4,
        head_type: str = "conformer_linear",
        head_layers: int = 1,
        head_dim_head: int = 32,
        head_num_head: int = 8,
        double_swish: bool = False,
        sample_rate: int = 16000,
        n_mels: int = 80,
        dtype: str = "float32",
        quant_dot: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
        **training_only: Any,
    ) -> None:
        if featurizer != "conformer":
            raise NotImplementedError(f"featurizer {featurizer!r} is not ported yet")
        if head_type != "conformer_linear":
            raise NotImplementedError(f"head_type {head_type!r} is not ported yet")
        if dtype != "float32" or quant_dot:
            raise NotImplementedError("only float32 inference is ported yet")
        self.lang2vocab = dict(lang2vocab)
        self.lang2index = dict(lang2index)
        self.index2lang = {v: k for k, v in self.lang2index.items()}
        ordered = sorted(self.lang2index, key=self.lang2index.get)
        self.vocab_sizes = tuple(self.lang2vocab[lang] for lang in ordered)
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.device = torch.device(device)
        featurizer_module = ConformerModel(
            n_blocks=n_blocks, n_mels=n_mels, encoder_dim=encoder_dim, heads=heads,
            dim_head=dim_head, sub_sampling=sub_sampling, use_double_swish=double_swish,
        )
        self.model = MutiLangModel(
            featurizer_module, self.vocab_sizes, linear_dim=encoder_dim,
            num_layers=head_layers, dim_head=head_dim_head, num_head=head_num_head,
            use_double_swish=double_swish,
        ).to(self.device).eval()

    def _features(self, wavs: torch.Tensor, wav_lengths: Optional[torch.Tensor]):
        return fused_frontend(wavs, wav_lengths, sample_rate=self.sample_rate,
                              n_mels=self.n_mels)  # ((B, F, n_mels), frame lengths)

    def infer_fn(self):
        """``fn(wavs (B, T), wav_lengths (B,)) → infer dict`` on the task's
        device (inputs are moved there)."""

        @torch.inference_mode()
        def fn(wavs: torch.Tensor, wav_lengths: Optional[torch.Tensor] = None):
            wavs = wavs.to(self.device, torch.float32)
            if wav_lengths is not None:
                wav_lengths = wav_lengths.to(self.device)
            feats, f_len = self._features(wavs, wav_lengths)
            return self.model.infer(feats, f_len)

        return fn
