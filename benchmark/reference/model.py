"""The joint LID + CTC-ASR model of the benchmark's reference: featurizer
(``conformer`` or ``wavlm``) → one ConformerLinear head a language (a
Conformer block, dropout in training, a Linear to V_max + 1 ids with the
blank last; a language's ids past its vocabulary masked to float32's
lowest) → confidence scores, or the CTC loss of the batch's own head.

A configuration file of the benchmark says which featurizer and widths;
the parameters come as a dict under the program's names.  Nothing here
imports the program.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from reference import conformer, frontend
from reference.conformer import Params

_NEG = torch.finfo(torch.float32).min


def vocab_sizes(cfg: dict) -> List[int]:
    return [int(v) for v in cfg["langs"].values()]


def family(cfg: dict):
    """The featurizer's module, ``reference/<featurizer>.py``: its
    ``inputs``, ``encode``, ``width`` and ``flops``."""
    return importlib.import_module(f"reference.{cfg['task']['featurizer']}")


def model_inputs(cfg: dict, wavs: torch.Tensor, lengths: torch.Tensor,
                 gens: Optional[Tuple[torch.Generator, torch.Generator]] = None):
    """The normalised wave through the featurizer's own frontend."""
    return family(cfg).inputs(cfg, frontend.normalize_wav(wavs, lengths), lengths, gens)


def featurize(cfg: dict, p: Params, x, lengths, gen=None):
    return family(cfg).encode(cfg, p, x, lengths, gen)


def head(cfg: dict, p: Params, lang: int, x, lengths, gen=None) -> torch.Tensor:
    """Head ``lang``'s float32 logits (B, T, V_max + 1), its padded ids
    masked."""
    task = cfg["task"]
    sizes = vocab_sizes(cfg)
    mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
    pre = f"heads.heads.{lang}."
    for i in range(task["head_layers"]):
        x = conformer.block(x, mask, p, f"{pre}blocks.{i}.", task["head_num_head"],
                            task["head_dim_head"], gen is not None)
    logits = conformer.linear(conformer.dropout(x, task["dropout"], gen), p, pre + "out")
    ids = torch.arange(logits.shape[-1], device=x.device)
    valid = (ids < sizes[lang]) | (ids == max(sizes))
    return logits.masked_fill(~valid, _NEG)


def logits_all(cfg: dict, p: Params, wavs, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval: (L, B, T', V_max + 1) logits of every head and the T' lengths."""
    x, f_len = model_inputs(cfg, wavs, lengths)
    feats, sub_len = featurize(cfg, p, x, f_len)
    return torch.stack([head(cfg, p, lang, feats, sub_len)
                        for lang in range(len(vocab_sizes(cfg)))]), sub_len


def scores(logits: torch.Tensor, sizes, lengths, nonblank: Optional[torch.Tensor] = None):
    """(B, L) confidences: over a head's valid frames whose argmax is not the
    blank, the mean best log-probability over ln V; -2 where there are none.
    ``nonblank`` (L, B, T) replaces the frames' own argmax decision: the
    check hands in the program's, so that a near tie decided the other way
    by rounding is judged as a token, not as a score."""
    lp = F.log_softmax(logits, dim=-1)
    best, arg = lp.max(dim=-1)
    blank = logits.shape[-1] - 1
    frame_ok = torch.arange(logits.shape[2], device=logits.device)[None, :] < lengths[:, None]
    chosen = (arg != blank) if nonblank is None else nonblank
    chosen = chosen & frame_ok[None]
    count = chosen.sum(dim=-1).float()
    total = torch.where(chosen, best, 0.0).sum(dim=-1)
    v = torch.tensor(sizes, dtype=torch.float32, device=logits.device)[:, None]
    out = torch.where(count > 0, total / (count * torch.log(v) + 1e-5), -2.0)
    return out.t()


def ctc_loss(logits, texts, feat_lens, text_lens) -> torch.Tensor:
    """The batch mean of each utterance's CTC negative log-likelihood (not
    divided by its label length), blank last, infeasible alignments 0."""
    lp = F.log_softmax(logits, dim=-1)
    nll = F.ctc_loss(lp.transpose(0, 1), texts.long(), feat_lens.long(), text_lens.long(),
                     blank=logits.shape[-1] - 1, reduction="none", zero_infinity=True)
    return nll.mean()


def train_loss(cfg: dict, p: Params, batch: Dict[str, torch.Tensor],
               gens: Tuple[torch.Generator, torch.Generator]) -> torch.Tensor:
    """A training batch's loss: the frontend with its augmentation, the
    featurizer and the batch's own head in training mode, drawing from
    ``gens`` (device generator, host generator) in the program's order."""
    lang = int(batch["langs"][0])
    x, f_len = model_inputs(cfg, batch["wavs"], batch["wav_lengths"], gens)
    feats, sub_len = featurize(cfg, p, x, f_len, gens[0])
    logits = head(cfg, p, lang, feats, sub_len, gens[0])
    return ctc_loss(logits, batch["texts"], sub_len, batch["text_lengths"])


def tristage(step: int, lr: float, phase_ratio, max_update: int,
             init_scale: float = 0.01, final_scale: float = 0.01) -> float:
    """Linear warm-up from init_scale·lr, hold, exponential decay to
    final_scale·lr, then flat."""
    warm, hold, decay = (int(max_update * r) for r in phase_ratio)
    if step < warm:
        return init_scale * lr + (lr - init_scale * lr) / warm * step
    if step < warm + hold:
        return lr
    if step <= warm + hold + decay:
        return lr * math.exp(math.log(final_scale) / decay * (step - warm - hold))
    return final_scale * lr


class Adam:
    """Clip by the global norm (scale clip / norm when the norm is at least
    clip) → Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
    correction by the step count) → the tristage rate read at the count
    before the step.  Parameters without a gradient take zeros."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict[str, torch.Tensor], task: dict):
        self.params = params
        self.task = task
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        conf = self.task["schedule_conf"]
        lr = tristage(self.count, float(self.task["lr"]), conf["phase_ratio"],
                      conf["max_update"])
        self.count += 1
        grads = {k: (torch.zeros_like(v) if v.grad is None else v.grad)
                 for k, v in self.params.items()}
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        clip = float(self.task["clip_norm"])
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        c = self.count
        for k, v in self.params.items():
            g = grads[k] * scale
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.nu[k] / (1.0 - self.b2 ** c)).sqrt_().add_(self.eps)
            v.addcdiv_(self.mu[k], denom, value=-lr / (1.0 - self.b1 ** c))
            v.grad = None


def flops(cfg: dict, samples: int, train: bool) -> float:
    """Products of a forward pass over one row of ``samples`` valid samples:
    the featurizer, then in training the batch's own head, in scoring every
    head and the discriminator (Linear(L, 128), Linear(128, L))."""
    task = cfg["task"]
    n_lang = len(cfg["langs"])
    vmax = max(cfg["langs"].values()) + 1
    total, t = family(cfg).flops(cfg, samples)
    d = family(cfg).width(cfg)
    head = task["head_layers"] * conformer.block_flops(
        t, d, task["head_num_head"], task["head_dim_head"]) + 2.0 * t * d * vmax
    if train:
        return total + head
    return total + n_lang * head + 2.0 * (n_lang * 128 + 128 * n_lang)
