"""Speech enhancement task (port of ``speechlid_tpu/tasks/se.py``): an SI-SNR
(or L1) trainer for the DPRNN masker or FaSNet-TAC, whose trained model
plugs into the LID eval harness and the server as a per-utterance
``enhance_fn``.

Builds the same model from the same hyper-parameter names as the JAX
``SETask``, so either package's checkpoint ``hyper_parameters`` construct
it, and :meth:`SETask.resume_from_checkpoint` loads either package's
weights (a JAX checkpoint through ``convert.se_state``).  Like the JAX task
it accepts, and ignores, unknown keyword arguments; an unknown
``model_type`` raises here, where the JAX task builds the DPRNN for it.

The task's contract is (B, T) → (B, T) for both models: FaSNet takes
(B, nmic, T), so a 2-D batch gains the mic axis going in and loses the
speaker axis coming out.  Adam with a global-norm clip of 5.0 and no
schedule.  The models have no dropout or other draw.  The enhance hook
runs on the task's device (the JAX package pins it to its CPU backend, a
workaround for its TPU runtime).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Union

import numpy as np
import torch

from speechlid_tpu_torch.core.module import TaskModule
from speechlid_tpu_torch.core.optim import make_optimizer
from speechlid_tpu_torch.core.precision import strict_float32
from speechlid_tpu_torch.models.fasnet import FaSNetTAC
from speechlid_tpu_torch.models.init import init_like_flax_
from speechlid_tpu_torch.models.se import DPRNNEnhancer, si_snr

MODEL_TYPES = ("dprnn", "fasnet_tac")


class SETask(TaskModule):
    def __init__(self, enc_dim: int = 64, win: int = 16, chunk: int = 100, n_blocks: int = 2,
                 hidden: int = 64, model_type: str = "dprnn", loss_type: str = "si_snr",
                 lr: float = 1e-3, optimizer: str = "adam",
                 device: Union[str, torch.device] = "cuda", **kw: Any):
        super().__init__()
        if model_type not in MODEL_TYPES:
            raise ValueError(f"unknown SE model_type: {model_type} (one of {MODEL_TYPES})")
        self.save_hyper_parameters(
            enc_dim=enc_dim, win=win, chunk=chunk, n_blocks=n_blocks, hidden=hidden,
            model_type=model_type, loss_type=loss_type, lr=lr, optimizer=optimizer,
        )
        self.lr = lr
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.model_type = model_type
        self.device = torch.device(device)
        strict_float32(self.device)  # cuDNN's LSTMs and convolutions: before the card
        if model_type == "fasnet_tac":
            model = FaSNetTAC(enc_dim=enc_dim, feature_dim=enc_dim, hidden_dim=hidden,
                              n_layers=n_blocks, segment_size=chunk, nspk=1)
        else:
            model = DPRNNEnhancer(enc_dim=enc_dim, win=win, chunk=chunk, n_blocks=n_blocks,
                                  hidden=hidden)
        self.model = model.to(self.device).eval()

    # ----------------------------------------------------------------- setup
    def set_generators(self, device_generator: torch.Generator,
                       host_generator: torch.Generator) -> None:
        """The models draw nothing while they run."""

    def init_parameters(self, generator: torch.Generator) -> None:
        init_like_flax_(self.model, generator)

    def config_optim(self):
        return make_optimizer(self.model.named_parameters(), self.optimizer, lr=self.lr,
                              clip_norm=5.0)

    @classmethod
    def resume_from_checkpoint(cls, ckpt_path: str, **override):
        """Rebuild from the saved hyper-parameters and load the weights of a
        checkpoint of either package.  Returns (task, checkpoint)."""
        from speechlid_tpu_torch import convert
        from speechlid_tpu_torch.core.checkpoint import load_checkpoint

        ckpt = load_checkpoint(ckpt_path)
        task = cls(**dict(ckpt["hyper_parameters"], **override))
        if "state" in ckpt:
            task.model.load_state_dict(ckpt["state"]["model"])
        else:
            convert.load_into(task.model, convert.se_state({"params": ckpt["params"]}))
        return task, ckpt

    # ----------------------------------------------------------- device loops
    def _apply(self, noisy: torch.Tensor) -> torch.Tensor:
        if self.model_type == "fasnet_tac":
            if noisy.ndim == 2:
                noisy = noisy[:, None, :]
            return self.model(noisy)[:, 0]
        return self.model(noisy)

    def _loss(self, est: torch.Tensor, clean: torch.Tensor) -> torch.Tensor:
        if self.loss_type == "l1":
            return (est - clean).abs().mean()
        return -si_snr(est, clean).mean()

    def train_loop(self, batch: Dict[str, torch.Tensor]):
        est = self._apply(batch["noisy"])
        loss = self._loss(est, batch["clean"])
        return loss, {"si_snr": si_snr(est.detach(), batch["clean"]).mean()}

    @torch.no_grad()
    def val_loop(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        est = self._apply(batch["noisy"])
        return {"loss": self._loss(est, batch["clean"]),
                "si_snr": si_snr(est, batch["clean"]).mean()}

    # ---------------------------------------------------------------- infer
    def make_enhance_fn(self) -> Callable[[np.ndarray], np.ndarray]:
        """→ ``enhance(wav (T,)) → (T,)``, numpy in and out, for
        ``eval.LidEvaluator`` and the server; it runs on the task's device,
        in eval mode."""

        @torch.inference_mode()
        def enhance(wav: np.ndarray) -> np.ndarray:
            self.model.eval()
            x = torch.as_tensor(np.asarray(wav, np.float32))[None].to(self.device)
            return self._apply(x)[0].float().cpu().numpy()

        return enhance
