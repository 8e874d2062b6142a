"""How far the SE models' float32 LSTMs lie from float64 on the card, and where.

    python3 scripts/fasnet_lstm_precision.py     # from the root of a checkout, one CUDA card

TF32 stays off (``core/precision.strict_float32``) except where a line says
TF32 on.  ``torch.backends.cudnn.flags()`` would switch it on inside its
block (its ``allow_tf32`` defaults to True), so the cuDNN-off runs here pass
``allow_tf32=False`` to it.

- One SI-SNR step of ``FaSNetOrigin()`` at its class defaults (4 mics,
  B = 4, 4 s of tones under noise, ``chip_smoke.init_se_`` weights) in
  float32 against the same step in float64 on the card, in relative L2 norm
  per gradient leaf (median, largest, every leaf together): on the card as
  it runs (cuDNN's LSTM), with TF32 on, on the CPU, and on the card with
  one part in float64 or switched: the FFT correlations, the global layer
  norms, the LSTMs, and cuDNN off (PyTorch's own CUDA LSTM).
- One FaSNet BiLSTM alone (D 64, H 128) at FaSNet-TAC's and FaSNet-Origin's
  batches at B = 4, 4 s: its output and gradients in float32 against
  float64 in relative L2, on cuDNN (as ``models/rnn.BiLSTM`` calls it, and
  through ``torch.nn.LSTM`` with its weights in one flat buffer), on cuDNN
  with TF32 on, on PyTorch's own CUDA LSTM and on the CPU; the ms of a
  forward and backward on cuDNN and on PyTorch's own (CUDA events, median of
  20); and the output's error against the sequence's length.
- Each SE model's train step (B = 4 × 4 s) and forward (1 × 4 s) in ms on
  cuDNN's LSTM against PyTorch's own (CUDA events, median of 10).

Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as c  # noqa: E402
import speechlid_tpu_torch.models.fasnet as pf  # noqa: E402
from speechlid_tpu_torch.core.precision import strict_float32  # noqa: E402
from speechlid_tpu_torch.models import rnn  # noqa: E402
from speechlid_tpu_torch.models.init import init_like_flax_  # noqa: E402
from speechlid_tpu_torch.models.se import si_snr  # noqa: E402

# FaSNet's BiLSTM batches at B = 4, 4 s: FaSNet-TAC's 4 mics, and
# FaSNet-Origin's reference stage (1 mic)
SHAPES = {"tac_intra": (1296, 50), "tac_inter": (800, 81),
          "origin_ref_intra": (324, 50), "origin_ref_inter": (200, 81)}
LENGTHS = (1, 5, 50)


def cudnn_off():
    """PyTorch's own CUDA LSTM, TF32 still off."""
    return torch.backends.cudnn.flags(enabled=False, allow_tf32=False)


class tf32_on:
    """TF32 on for cuDNN inside the block."""

    def __enter__(self):
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = False


def median_ms(fn, n=20, warmup=5):
    times = []
    for i in range(n + warmup):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(s.elapsed_time(e))
    return sorted(times)[len(times) // 2]


# ----------------------------------------------------------- FaSNet-Origin step
def grads(model, noisy, clean, device, dtype):
    m = copy.deepcopy(model).to(device, dtype).train()
    x = torch.from_numpy(noisy).to(device, dtype)
    y = torch.from_numpy(clean).to(device, dtype)
    loss = -si_snr(m(x)[:, 0], y).mean()
    loss.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    return loss.item(), {n: p.grad.detach().double().cpu() for n, p in m.named_parameters()}


def distance(got, ref):
    per_leaf = sorted(float((got[n] - r).norm() / r.norm().clamp_min(1e-30))
                      for n, r in ref.items())
    flat = [torch.cat([g[n].flatten() for n in ref]) for g in (got, ref)]
    return {"median": per_leaf[len(per_leaf) // 2], "max": per_leaf[-1],
            "all_leaves": float((flat[0] - flat[1]).norm() / flat[1].norm())}


def fasnet_origin_step():
    model = pf.FaSNetOrigin()
    c.init_se_(model, torch.Generator().manual_seed(5))
    noisy, clean = c.se_tones(np.random.RandomState(11), 4, 64000, 4)
    loss64, g64 = grads(model, noisy, clean, "cuda", torch.float64)
    out = {"loss_float64": loss64}

    def card(label):
        out[label] = distance(grads(model, noisy, clean, "cuda", torch.float32)[1], g64)

    card("card_float32")
    with tf32_on():
        card("card_float32_tf32_on")
    t0 = time.perf_counter()
    out["cpu_float32"] = distance(grads(model, noisy, clean, "cpu", torch.float32)[1], g64)
    out["cpu_seconds"] = time.perf_counter() - t0
    corr = pf.sliding_corr
    pf.sliding_corr = lambda ref, k, n: corr(ref.double(), k.double(), n).to(ref.dtype)
    card("card_float32_fft_in_float64")
    pf.sliding_corr = corr
    gln = pf.GlobalLayerNorm.forward
    pf.GlobalLayerNorm.forward = lambda self, x: gln(self, x.double()).to(x.dtype)
    card("card_float32_gln_in_float64")
    pf.GlobalLayerNorm.forward = gln
    lstm = rnn.BiLSTM.forward

    def lstm64(self, x, lengths=None):
        w = [t.double() for t in self.fwd.flat_weights() + self.bwd.flat_weights()]
        h0 = x.new_zeros(2, x.shape[0], self.hidden, dtype=torch.float64)
        return torch.lstm(x.double(), (h0, h0), w, True, 1, 0.0, self.training, True,
                          True)[0].to(x.dtype)

    rnn.BiLSTM.forward = lstm64
    card("card_float32_lstm_in_float64")
    rnn.BiLSTM.forward = lstm
    with cudnn_off():
        card("card_float32_cudnn_off")
    return out


# ------------------------------------------------------------- one BiLSTM alone
def lstm_fwd_bwd(x, weights, dy, hidden):
    """One BiLSTM forward and backward, ``torch.lstm`` as ``rnn.BiLSTM``
    calls it → {"out", "dx", "w_ih", "w_hh", "b"}."""
    x = x.detach().clone().requires_grad_(True)
    w = [t.detach().clone().requires_grad_(True) for t in weights]
    h0 = x.new_zeros(2, x.shape[0], hidden)
    y = torch.lstm(x, (h0, h0), w, True, 1, 0.0, True, True, True)[0]
    (y * dy).sum().backward()
    return {"out": y, "dx": x.grad, "w_ih": torch.cat([w[0].grad, w[4].grad]),
            "w_hh": torch.cat([w[1].grad, w[5].grad]), "b": torch.cat([w[3].grad, w[7].grad])}


def flat_fwd_bwd(x, weights, dy, hidden):
    """The same through ``torch.nn.LSTM``, its weights in one flat buffer."""
    m = torch.nn.LSTM(x.shape[-1], hidden, batch_first=True, bidirectional=True).to(x)
    params = [m.weight_ih_l0, m.weight_hh_l0, m.bias_ih_l0, m.bias_hh_l0,
              m.weight_ih_l0_reverse, m.weight_hh_l0_reverse, m.bias_ih_l0_reverse,
              m.bias_hh_l0_reverse]
    with torch.no_grad():
        for p, w in zip(params, weights):
            p.copy_(w)
    m.flatten_parameters()
    x = x.detach().clone().requires_grad_(True)
    y = m(x)[0]
    (y * dy).sum().backward()
    return {"out": y, "dx": x.grad, "w_ih": torch.cat([params[0].grad, params[4].grad]),
            "w_hh": torch.cat([params[1].grad, params[5].grad]),
            "b": torch.cat([params[3].grad, params[7].grad])}


def rel(got, ref):
    return {k: float((got[k].detach().double().cpu() - r.detach().double().cpu()).norm()
                     / r.detach().double().cpu().norm()) for k, r in ref.items()}


def lstm_inputs(b, t, dtype=torch.float64, device="cuda"):
    m = rnn.BiLSTM(64, 128)
    init_like_flax_(m, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(b, t, 64, generator=gen, dtype=torch.float64)
    dy = torch.randn(b, t, 256, generator=gen, dtype=torch.float64)
    w = [p.detach().double() for p in m.fwd.flat_weights() + m.bwd.flat_weights()]
    return x.to(device, dtype), [p.to(device, dtype) for p in w], dy.to(device, dtype), 128


def one_lstm():
    res = {}
    for name, (b, t) in SHAPES.items():
        ref = lstm_fwd_bwd(*lstm_inputs(b, t))
        args = lstm_inputs(b, t, torch.float32)
        r = {"cudnn_float32": rel(lstm_fwd_bwd(*args), ref),
             "cudnn_float32_flat_weights": rel(flat_fwd_bwd(*args), ref)}
        with tf32_on():
            r["cudnn_float32_tf32_on"] = rel(lstm_fwd_bwd(*args), ref)
        with cudnn_off():
            r["native_float32"] = rel(lstm_fwd_bwd(*args), ref)
        r["cpu_float32"] = rel(lstm_fwd_bwd(*lstm_inputs(b, t, torch.float32, "cpu")), ref)
        r["cudnn_ms"] = median_ms(lambda: lstm_fwd_bwd(*args))
        with cudnn_off():
            r["native_ms"] = median_ms(lambda: lstm_fwd_bwd(*args))
        res[name] = r
    by_length = {}
    for t in LENGTHS:
        ref = lstm_fwd_bwd(*lstm_inputs(1296, t))["out"]
        args = lstm_inputs(1296, t, torch.float32)
        by_length[t] = {"cudnn_float32": rel({"out": lstm_fwd_bwd(*args)["out"]}, {"out": ref})}
        with cudnn_off():
            by_length[t]["native_float32"] = rel({"out": lstm_fwd_bwd(*args)["out"]},
                                                 {"out": ref})
    res["out_by_length_at_1296"] = by_length
    return res


# ---------------------------------------------------------------- model times
def model_ms():
    res = {}
    for kind in ("dprnn", "fasnet_tac", "fasnet_origin"):
        model = c.se_model(kind).cuda().train()
        c.init_se_(model, torch.Generator().manual_seed(5))
        mics = 0 if kind == "dprnn" else 4
        noisy, clean = (torch.from_numpy(a).cuda()
                        for a in c.se_tones(np.random.RandomState(11), 4, 64000, mics))

        def step():
            model.zero_grad()
            (-si_snr(c.se_forward(kind, model, noisy), clean).mean()).backward()

        def forward():
            with torch.no_grad():
                c.se_forward(kind, model, noisy[:1])

        r = {"step_ms_cudnn": median_ms(step, 10, 3), "forward_ms_cudnn": median_ms(forward, 10, 3)}
        with cudnn_off():
            r["step_ms_native"] = median_ms(step, 10, 3)
            r["forward_ms_native"] = median_ms(forward, 10, 3)
        res[kind] = r
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("fasnet_lstm_precision: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    strict_float32("cuda")
    out = {"torch": torch.__version__, "cudnn": torch.backends.cudnn.version(),
           "fasnet_origin_step": fasnet_origin_step(), "one_lstm": one_lstm(),
           "model_ms": model_ms()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
