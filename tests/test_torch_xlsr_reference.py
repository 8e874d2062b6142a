"""XLS-R 300M's layout in the port, held to the benchmark's plain float32
reference (``benchmark/reference/wav2vec2.py``) on the CPU at tiny widths.

The port's ``LidASRTask(featurizer="wav2vec2")`` is built from
``benchmark/configs/xlsr_300m.json`` with its widths cut (pre-LN layers, a
layer-norm extractor with conv biases, the wave normalised, time and
channel span masks, the recipe's freeze at its steady epoch), both sides
take the benchmark's seeded weights, and the test compares scoring
log-probabilities, one training micro-batch's loss, every leaf's gradient
(the frozen extractor's absent in the port, none or zero in the reference)
and one Adam step's change.  Two planted faults must fail: the reference
run post-LN, and the port's extractor left trainable.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import program, weights  # noqa: E402
from reference import model as ref  # noqa: E402
from reference import wav2vec2 as ref_w2v  # noqa: E402
from reference.wavlm import ln  # noqa: E402
from tests.torch_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

SEED = 2 ** 31 + 2121
TRAINER_SEED = 77
B, T = 3, 8000
LENGTHS = [8000, 6500, 5200]

# Tolerances, each with its reason.  Both sides compute in float32 on the
# CPU from the same weights and the same draws, so they differ by the order
# of summation alone (the port's conv and Linear modules against
# F.conv1d / F.linear on detached copies, its LayerNorm class against
# F.layer_norm).  Over twelve draws of the weights and the trainer's seed
# the readings were at most 5.7e-6, 9.7e-8, 2.7e-4 and 9.4e-3 in turn.
LP_TOL = 1e-4       # log-probabilities: values up to ~10 in float32, two encoders deep
LOSS_TOL = 1e-5     # relative: one CTC loss of ~100 summed over frames
GRAD_TOL = 2e-3     # a leaf's gradient gap over max(its norm, the median leaf's): the
                    # gradients reach ~100 an element, so float32 leaves ~1e-4 of a leaf
CHANGE_TOL = 5e-2   # an element's Adam change gap over the step's lr, where both sides
                    # decide the gradient's sign (most elements: DECIDED) and beyond one
                    # ulp of the parameter; eps (1e-8) sets the step of the smallest
                    # clipped gradients, whose rounding it weighs
DECIDED = 0.9


def tiny_config() -> dict:
    with open(BENCH / "configs" / "xlsr_300m.json") as f:
        cfg = json.load(f)
    cfg["ssl_config"].update(
        encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
        encoder_attention_heads=4, conv_feature_layers="[(16,10,5)] + [(16,3,2)] * 2",
        conv_pos=16, conv_pos_groups=4,
        # at 32 channels the recipe's 0.15 may draw no channel span: draw some
        mask_prob=0.4, mask_channel_prob=0.4)
    cfg["task"].update(head_dim_head=4, head_num_head=2)
    return cfg


def batch_of(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    wavs = (0.1 * rng.randn(B, T)).astype(np.float32)
    lengths = np.array(LENGTHS, np.int64)
    wavs[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
    return {"wavs": wavs, "wav_lengths": lengths,
            "texts": rng.randint(0, 40, (B, 5)).astype(np.int64),
            "text_lengths": np.array([5, 4, 3], np.int64),
            "langs": np.full(B, 1, np.int64)}


def post_ln_layer(x, p, pre, cfg, gen):
    """The planted fault: the layer's LayerNorms after its residual sums
    (the Base layout), in the reference only."""
    b, t, c = x.shape
    h = cfg["encoder_attention_heads"]
    d = c // h
    lin = ref.conformer.linear
    q = (lin(x, p, pre + "self_attn.q_proj") * d ** -0.5).view(b, t, h, d).transpose(1, 2)
    k = lin(x, p, pre + "self_attn.k_proj").view(b, t, h, d).transpose(1, 2)
    v = lin(x, p, pre + "self_attn.v_proj").view(b, t, h, d).transpose(1, 2)
    probs = ref.conformer.dropout(torch.softmax(q @ k.transpose(-1, -2), dim=-1),
                                  cfg["attention_dropout"], gen)
    y = lin((probs @ v).transpose(1, 2).reshape(b, t, c), p, pre + "self_attn.out_proj")
    x = ln(x + ref.conformer.dropout(y, cfg["dropout"], gen), p, pre + "self_attn_layer_norm")
    y = lin(torch.nn.functional.gelu(lin(x, p, pre + "fc1")), p, pre + "fc2")
    return ln(x + ref.conformer.dropout(y, cfg["dropout"], gen), p, pre + "final_layer_norm")


def _median(values):
    values = sorted(values)
    return values[len(values) // 2]


def readings() -> dict:
    """The gaps between the port and the reference: scoring
    log-probabilities, a micro-batch's loss, each leaf's gradient and
    Adam change; ``leaked``: frozen leaves with a gradient on either side."""
    cfg = tiny_config()
    task = program.build_task(cfg, "cpu")
    trainer = program.build_trainer(cfg, TRAINER_SEED, "cpu", [])
    trainer.trainer_prepare(task)
    shapes = program.load_weights(task, SEED, "cpu")
    names = [n for n, _ in task.model.named_parameters()]
    host = batch_of()
    batch = {k: torch.as_tensor(v) for k, v in host.items()}
    out = {}

    # scoring: every head's log-probabilities at the valid frames and ids
    got = task.infer_fn()(batch["wavs"], batch["wav_lengths"])
    with torch.no_grad():
        want, want_len = ref.logits_all(cfg, weights.make_weights(shapes, SEED, "cpu"),
                                        batch["wavs"], batch["wav_lengths"])
    assert torch.equal(got["feat_lengths"], want_len)
    sizes = ref.vocab_sizes(cfg)
    ids = torch.arange(want.shape[-1])
    valid_ids = (ids[None, :] < torch.tensor(sizes)[:, None]) | (ids == max(sizes))
    frames = torch.arange(want.shape[2])[None, :] < want_len[:, None]
    cell = valid_ids[:, None, None, :] & frames[None, :, :, None]
    gap = (torch.log_softmax(got["logits"], -1) - torch.log_softmax(want, -1)).abs()
    out["lp_err"] = float(torch.where(cell, gap, 0.0).max())

    # one training micro-batch and one Adam step at the steady epoch
    task.before_train_loop(cfg["trainer"]["steady_epoch"])
    task.model.train()
    loss, _ = task.train_loop(task.place_batch(host))
    loss.backward()
    params = dict(task.model.named_parameters())
    grads = {n: (None if params[n].grad is None else params[n].grad.clone()) for n in names}
    start = {n: params[n].detach().clone() for n in names}
    trainer.optimizer.step()
    change = {n: params[n].detach() - start[n] for n in names}

    p = weights.make_weights(shapes, SEED, "cpu")
    leaves = {n: p[n].clone().requires_grad_(True) for n in names}
    p.update(leaves)
    gens = (torch.Generator().manual_seed(TRAINER_SEED),
            torch.Generator().manual_seed(TRAINER_SEED + 1))
    want_loss = ref.train_loss(cfg, p, batch, gens)
    want_loss.backward()
    want_grads = {n: leaves[n].grad for n in names}
    ref_start = {n: v.detach().clone() for n, v in leaves.items()}
    ref.Adam(leaves, cfg["task"]).step()
    want_change = {n: leaves[n].detach() - ref_start[n] for n in names}

    out["loss_gap"] = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    frozen = [n for n in names if ref_w2v.frozen(cfg, n)]
    out["frozen"] = len(frozen)
    out["leaked"] = sum(grads[n] is not None or (want_grads[n] is not None
                                                 and bool(want_grads[n].any()))
                        for n in frozen)
    trained = [n for n in names if n not in frozen and want_grads[n] is not None]
    norms = {n: float(want_grads[n].norm()) for n in trained}
    scale = _median(v for v in norms.values() if v > 0.0)
    out["grad_gap"] = max(
        float(torch.inf) if grads[n] is None
        else float((grads[n] - want_grads[n]).norm()) / max(norms[n], scale)
        for n in trained)
    # the change where both sides decide the gradient's sign: Adam's first
    # step moves an element by about lr·sign(g), so an element whose
    # gradient lies within the two sides' gap may move either way; less the
    # one ulp of the parameter by which the two roundings of p + Δ may differ
    conf = cfg["task"]["schedule_conf"]
    lr = ref.tristage(0, float(cfg["task"]["lr"]), conf["phase_ratio"], conf["max_update"])
    gaps, decided, elements = [], 0, 0
    for n in trained:
        if norms[n] < 1e-3 * scale:  # rounding noise alone (a key's bias under softmax)
            continue
        sure = want_grads[n].abs() > 10.0 * (grads[n] - want_grads[n]).abs()
        decided += int(sure.sum())
        elements += sure.numel()
        ulp = start[n].abs().nextafter(torch.tensor(float("inf"))) - start[n].abs()
        gap = ((change[n] - want_change[n]).abs() - ulp).clamp(min=0.0)
        gaps.append(float(torch.where(sure, gap, 0.0).max()))
    out["change_gap"] = max(gaps) / lr
    out["decided"] = decided / elements
    return out


def test_port_agrees_with_the_reference():
    r = readings()
    assert r["frozen"] > 0 and r["leaked"] == 0, r
    assert r["lp_err"] <= LP_TOL, r
    assert r["loss_gap"] <= LOSS_TOL, r
    assert r["grad_gap"] <= GRAD_TOL, r
    assert r["change_gap"] <= CHANGE_TOL and r["decided"] >= DECIDED, r


def test_post_ln_reference_is_caught(monkeypatch):
    monkeypatch.setattr(ref_w2v, "layer", post_ln_layer)
    r = readings()
    assert r["lp_err"] > LP_TOL and r["loss_gap"] > LOSS_TOL and r["grad_gap"] > GRAD_TOL, r


def test_trainable_extractor_is_caught(monkeypatch):
    from speechlid_tpu_torch.tasks import lid_asr

    monkeypatch.setattr(lid_asr, "SSL_EXTRACTOR_PARTS", ())
    r = readings()
    assert r["leaked"] == r["frozen"] > 0, r
