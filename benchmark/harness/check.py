"""What decides ``correct``: the program's outputs from the timed path
against the plain reference (``benchmark/reference``), on weights the
benchmark makes again from the seed.

Scoring (a sample of the window's batches, drawn from the seed, the
longest bucket in it):

- ``lp_err``: the widest gap between the program's and the reference's
  log-probabilities, over every head, valid frame and valid id;
- ``token_gap``: the widest gap by which the id the program puts first at a
  valid frame lies below the reference's best there (a near tie decided
  the other way by rounding reads about 0);
- ``score_err``: the widest gap between the program's confidence scores
  and the reference's, the reference counting the frames the program's own
  logits call non-blank.

Training, twice: the set-up's first three optimizer steps from the
seed's weights, which went through the window's own loop and feed; and one
optimizer step of the window, drawn from the seed after the loader has
wrapped into its second cycle, which the reference follows from the
program's own state before it (parameters, Adam's moments and count, the
generators' states), since nothing else can reach that point:

- ``loss_gap``: the widest relative gap between the program's and the
  reference's loss of each batch;
- ``grad_gap``: over the parameters, the widest gap between the norms of
  the first step's gradient as the optimizer got it (Adam's first moment
  after the step less b1 times before it, over 1 − b1), against the
  reference's norm of that leaf or the median leaf's, whichever is larger;
- ``change_gap``: the same for the norm of each parameter's change over
  the steps, over the leaves whose reference gradient reaches a
  thousandth of the median leaf's in some step (a key's bias under
  softmax moves under Adam by round-off alone).

The window's step reads as ``w_loss_gap``, ``w_grad_gap`` and
``w_change_gap``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch

from reference import model as ref

B1 = 0.9


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products with TF32 off (the configuration), or on (the
    control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ scoring

@torch.no_grad()
def reference_logits(cfg: dict, params, batch: dict, rows: int = 32):
    """The reference's (L, B, T', V) logits and T' lengths, ``rows`` rows at
    a time."""
    outs, lens = [], []
    n = batch["wavs"].shape[0]
    for i in range(0, n, rows):
        logits, length = ref.logits_all(cfg, params, batch["wavs"][i:i + rows],
                                        batch["wav_lengths"][i:i + rows])
        outs.append(logits)
        lens.append(length)
    return torch.cat(outs, dim=1), torch.cat(lens)


@torch.no_grad()
def score_readings(cfg: dict, logits, feat_lengths, scores, ref_logits, ref_lengths
                   ) -> Dict[str, float]:
    """The three scoring numbers of one batch: ``logits`` (L, B, T, V),
    ``feat_lengths`` (B,) and ``scores`` (B, L) are the program's."""
    if not torch.equal(feat_lengths.cpu().long(), ref_lengths.cpu().long()):
        return {"lp_err": float("inf"), "token_gap": float("inf"), "score_err": float("inf")}
    sizes = ref.vocab_sizes(cfg)
    vmax = max(sizes)
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp_ref = torch.log_softmax(ref_logits.float(), dim=-1)
    t = logits.shape[2]
    frames = torch.arange(t, device=lp.device)[None, :] < ref_lengths.to(lp.device)[:, None]
    ids = torch.arange(logits.shape[-1], device=lp.device)
    valid_ids = (ids[None, :] < torch.tensor(sizes, device=lp.device)[:, None]) | (ids == vmax)
    cell = frames[None, :, :, None] & valid_ids[:, None, None, :]
    lp_err = torch.where(cell, (lp - lp_ref).abs(), 0.0).amax()
    arg = lp.argmax(dim=-1)
    gap = lp_ref.amax(dim=-1) - lp_ref.gather(-1, arg[..., None])[..., 0]
    token_gap = torch.where(frames[None], gap, 0.0).amax()
    nonblank = arg != logits.shape[-1] - 1
    want = ref.scores(ref_logits.float(), sizes, ref_lengths.to(lp.device), nonblank)
    score_err = (scores.to(want.device).float() - want).abs().amax()
    if not torch.isfinite(scores).all():
        score_err = torch.tensor(float("inf"))
    return {"lp_err": float(lp_err), "token_gap": float(token_gap),
            "score_err": float(score_err)}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, float("-inf")), v)
    return out


# ----------------------------------------------------------------- training

def reference_steps(cfg: dict, params: Dict[str, torch.Tensor], param_names: List[str],
                    batches: List[dict], seed: int, steps: int, half_batch: bool = False,
                    state: Optional[dict] = None) -> dict:
    """The reference's ``steps`` optimizer steps over ``batches``
    (``accum_grad`` a step) from ``params``, drawing from generators seeded
    as the trainer seeds its own (device ``seed``, host ``seed + 1``), or
    from a state the program was in: ``state`` gives Adam's ``mu``, ``nu``
    and ``count`` and the generators' states ``gens``.  ``half_batch``
    plants the fault of a loss over the first half of each batch.  →
    per-batch losses, per-leaf norms of the first step's clipped gradient
    and of the change, per-leaf largest gradient norm of any step."""
    device = next(iter(params.values())).device
    accum = int(cfg["trainer"]["accum_grad"])
    leaves = {k: params[k].detach().clone().requires_grad_(True) for k in param_names}
    p = dict(params)
    p.update(leaves)
    start = {k: v.detach().clone() for k, v in leaves.items()}
    opt = ref.Adam(leaves, cfg["task"])
    gens = (torch.Generator(device=device).manual_seed(seed),
            torch.Generator().manual_seed(seed + 1))
    if state is not None:
        opt.count = int(state["count"])
        for k in leaves:
            opt.mu[k].copy_(state["mu"][k])
            opt.nu[k].copy_(state["nu"][k])
        gens[0].set_state(state["gens"][0])
        gens[1].set_state(state["gens"][1])
    mu0 = {k: m.clone() for k, m in opt.mu.items()}
    losses, grad_max, first = [], {k: 0.0 for k in leaves}, {}
    for step in range(steps):
        for micro in range(accum):
            batch = {k: v.to(device) for k, v in batches[step * accum + micro].items()}
            if half_batch:
                half = batch["wavs"].shape[0] // 2
                batch = {k: v[:half] for k, v in batch.items()}
            loss = ref.train_loss(cfg, p, batch, gens)
            losses.append(float(loss.detach()))
            (loss / accum).backward()
        for k, v in leaves.items():
            if v.grad is not None:
                grad_max[k] = max(grad_max[k], float(v.grad.norm()))
        opt.step()
        if step == 0:
            first = first_gradient(mu0, opt.mu)
            del mu0
    change = {k: float((v.detach() - start[k]).norm()) for k, v in leaves.items()}
    return {"losses": losses, "grad1": first, "change": change, "grad_max": grad_max}


def first_gradient(mu0: Dict[str, torch.Tensor], mu1: Dict[str, torch.Tensor]
                   ) -> Dict[str, float]:
    """Each leaf's norm of the gradient Adam took in a step, from its first
    moment before and after: (mu1 − b1·mu0) / (1 − b1)."""
    return {k: float((mu1[k] - B1 * mu0[k]).norm()) / (1.0 - B1) for k in mu1}


def _median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2] if values else 0.0


def leaf_gaps(prog: Dict[str, float], want: Dict[str, float], keys) -> List[tuple]:
    """(gap, leaf) widest first: |prog − want| of a leaf over the larger of
    its ``want`` and the median leaf's, the median over the leaves the step
    reached."""
    keys = list(keys)
    scale = _median(want[k] for k in keys if want[k] > 0.0)
    return sorted(((abs(prog[k] - want[k]) / max(want[k], scale, 1e-30), k) for k in keys),
                  reverse=True)


def moved(want: dict) -> List[str]:
    """The leaves whose reference gradient reaches a thousandth of the
    median leaf's in some step."""
    g_med = _median(g for g in want["grad_max"].values() if g > 0.0)
    return [k for k, g in want["grad_max"].items() if g >= 1e-3 * g_med]


def train_readings(prog: Optional[dict], want: dict, prefix: str = "") -> Dict[str, float]:
    """The three training numbers, each named ``prefix`` + its name; all
    infinite where the program has no reading (``prog`` None) or too few
    finite losses."""
    names = [prefix + k for k in ("loss_gap", "grad_gap", "change_gap")]
    n = len(want["losses"])
    if (prog is None or len(prog["losses"]) < n
            or not all(math.isfinite(x) for x in prog["losses"][:n])):
        return dict.fromkeys(names, float("inf"))
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"][:n], want["losses"]))
    grad_gap = leaf_gaps(prog["grad1"], want["grad1"], want["grad1"])[0][0]
    change_gap = leaf_gaps(prog["change"], want["change"], moved(want))[0][0]
    return dict(zip(names, (float(loss_gap), float(grad_gap), float(change_gap))))
