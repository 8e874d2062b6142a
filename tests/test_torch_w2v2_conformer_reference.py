"""The wav2vec 2.0 Conformer (rel-pos) in the port, held to the benchmark's
plain float32 reference (``benchmark/reference/wav2vec2_conformer.py``) on
the CPU at tiny widths, and the reference held to ``transformers``'
``Wav2Vec2ConformerEncoder``.

The port's ``LidASRTask(featurizer="wav2vec2_conformer")`` is built from
``benchmark/configs/wav2vec2_conformer_large.json`` with its widths cut (2
layers, head widths 32 and 64; the layer-norm extractor with conv biases,
the wave normalised, time and channel span masks, the recipe's freeze at
its steady epoch), both sides take the benchmark's seeded weights, and the
test compares scoring log-probabilities, one training micro-batch's loss,
every leaf's gradient (``pos_bias_u``, ``pos_bias_v`` and ``linear_pos``
among them; the frozen extractor's absent in the port, none or zero in the
reference) and one Adam step's change.  Three planted faults in the
reference must fail: u and v swapped, the rel-shift's sign flipped (the
score of j − i at (i, j)), and a positional conv added in front of the
layers.  The recipe ``configs/torch/lid_wav2vec_conformer.yaml`` builds the task
through the port's CLI.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import program, weights  # noqa: E402
from reference import model as ref  # noqa: E402
from reference import wav2vec2_conformer as ref_w2c  # noqa: E402
from reference.wav2vec2 import frozen  # noqa: E402
from tests.torch_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

SEED = 2 ** 31 + 2525
TRAINER_SEED = 91
B, T = 3, 8000
LENGTHS = [8000, 6500, 5200]
WIDTHS = {32: 64, 64: 128}  # head width → encoder width, two heads

# Tolerances, each with its reason.  Both sides compute in float32 on the
# CPU from the same weights and the same draws, so they differ by the order
# of summation alone: the port's XL attention is the kernels' Shaw-form
# rewrite ((q + u)·(k + p) + β) against HF's two products and rel-shift,
# its conv module the depthwise kernel's plain version against a grouped
# F.conv1d, its LayerNorm class against F.layer_norm.  Over eight draws of
# the weights and the trainer's seed at each head width the readings were
# at most 3.8e-6, 1.7e-7, 4.1e-4 and 2.3e-2 in turn (decided ≥ 0.99).
LP_TOL = 1e-4       # log-probabilities: values up to ~10 in float32, two encoders deep
LOSS_TOL = 1e-5     # relative: one CTC loss of ~100 summed over frames
GRAD_TOL = 2e-3     # a leaf's gradient gap over max(its norm, the median leaf's)
CHANGE_TOL = 5e-2   # an element's Adam change gap over the step's lr, where both sides
                    # decide the gradient's sign (most elements: DECIDED) and beyond one
                    # ulp of the parameter, as tests/test_torch_xlsr_reference.py weighs it
DECIDED = 0.9
# the reference against transformers' encoder, both float32 on the CPU
# from the same weights, eval mode: HF's BatchNorm1d and nn.LayerNorm
# against the reference's BatchNorm and F.layer_norm arithmetic, Conv1d
# GEMMs against F.linear: rounding alone, at most 3.4e-7 of the largest
# output over four draws at each head width
HF_TOL = 1e-5


def tiny_config(d: int) -> dict:
    with open(BENCH / "configs" / "wav2vec2_conformer_large.json") as f:
        cfg = json.load(f)
    c = WIDTHS[d]
    cfg["task"]["ssl_config"].update(
        encoder_layers=2, encoder_embed_dim=c, encoder_ffn_embed_dim=2 * c,
        encoder_attention_heads=2, depthwise_conv_kernel_size=7,
        conv_feature_layers="[(16,10,5)] + [(16,3,2)] * 2",
        # at these widths the recipe's 0.15 may draw no channel span: draw some
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


def _median(values):
    values = sorted(values)
    return values[len(values) // 2]


def readings(d: int, seed: int = SEED, trainer_seed: int = TRAINER_SEED, swap_uv=False) -> dict:
    """The gaps between the port and the reference: scoring
    log-probabilities, a micro-batch's loss, each leaf's gradient and Adam
    change; ``leaked``: frozen leaves with a gradient on either side.
    ``swap_uv``: the reference takes each layer's u and v swapped."""
    cfg = tiny_config(d)
    task = program.build_task(cfg, "cpu")
    trainer = program.build_trainer(cfg, trainer_seed, "cpu", [])
    trainer.trainer_prepare(task)
    shapes = program.load_weights(task, seed, "cpu")
    names = [n for n, _ in task.model.named_parameters()]
    host = batch_of()
    batch = {k: torch.as_tensor(v) for k, v in host.items()}
    out = {}

    def reference_weights():
        p = weights.make_weights(shapes, seed, "cpu")
        if swap_uv:
            for n in [n for n in p if n.endswith("pos_bias_u")]:
                v = n[:-1] + "v"
                p[n], p[v] = p[v], p[n]
        return p

    # scoring: every head's log-probabilities at the valid frames and ids
    got = task.infer_fn()(batch["wavs"], batch["wav_lengths"])
    with torch.no_grad():
        want, want_len = ref.logits_all(cfg, reference_weights(), batch["wavs"],
                                        batch["wav_lengths"])
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

    p = reference_weights()
    leaves = {n: p[n].clone().requires_grad_(True) for n in names}
    p.update(leaves)
    gens = (torch.Generator().manual_seed(trainer_seed),
            torch.Generator().manual_seed(trainer_seed + 1))
    want_loss = ref.train_loss(cfg, p, batch, gens)
    want_loss.backward()
    want_grads = {n: leaves[n].grad for n in names}
    ref_start = {n: v.detach().clone() for n, v in leaves.items()}
    ref.Adam(leaves, cfg["task"]).step()
    want_change = {n: leaves[n].detach() - ref_start[n] for n in names}

    out["loss_gap"] = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    frozen_leaves = [n for n in names if frozen(cfg, n)]
    out["frozen"] = len(frozen_leaves)
    out["leaked"] = sum(grads[n] is not None or (want_grads[n] is not None
                                                 and bool(want_grads[n].any()))
                        for n in frozen_leaves)
    trained = [n for n in names if n not in frozen_leaves and want_grads[n] is not None]
    out["xl_leaves"] = sum(n.endswith(("pos_bias_u", "pos_bias_v", "linear_pos.weight"))
                           for n in trained)
    norms = {n: float(want_grads[n].norm()) for n in trained}
    scale = _median(v for v in norms.values() if v > 0.0)
    out["grad_gap"] = max(
        float(torch.inf) if grads[n] is None
        else float((grads[n] - want_grads[n]).norm()) / max(norms[n], scale)
        for n in trained)
    # the change where both sides decide the gradient's sign (see
    # tests/test_torch_xlsr_reference.py), less one ulp of the parameter
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


@pytest.mark.parametrize("d", [32, 64])
def test_port_agrees_with_the_reference(d):
    r = readings(d)
    assert r["frozen"] > 0 and r["leaked"] == 0, r
    assert r["xl_leaves"] == 3 * 2, r  # u, v and linear_pos of both layers train
    assert r["lp_err"] <= LP_TOL, r
    assert r["loss_gap"] <= LOSS_TOL, r
    assert r["grad_gap"] <= GRAD_TOL, r
    assert r["change_gap"] <= CHANGE_TOL and r["decided"] >= DECIDED, r


def flipped_shift(bd):
    """The planted fault: the rel-shift of the positions reversed, so (i, j)
    holds the score of j − i."""
    return REL_SHIFT(bd.flip(-1))


REL_SHIFT = ref_w2c.rel_shift
ENCODER = ref_w2c.encoder


def with_pos_conv(x, p, cfg, gen=None):
    """The planted fault: a grouped positional conv (k = 16, GELU) added in
    front of the layers, as wav2vec 2.0's Transformer encoder has it."""
    c = x.shape[-1]
    w = 0.1 * torch.randn(c, c // 4, 16, generator=torch.Generator().manual_seed(5))
    pos = F.conv1d(F.pad(x.transpose(1, 2), (8, 7)), w, groups=4)
    return ENCODER(x + F.gelu(pos).transpose(1, 2), p, cfg, gen)


@pytest.mark.parametrize("fault", ["swap_uv", "rel_shift", "pos_conv"])
def test_planted_faults_are_caught(fault, monkeypatch):
    if fault == "rel_shift":
        monkeypatch.setattr(ref_w2c, "rel_shift", flipped_shift)
    if fault == "pos_conv":
        monkeypatch.setattr(ref_w2c, "encoder", with_pos_conv)
    r = readings(64, swap_uv=fault == "swap_uv")
    assert r["lp_err"] > LP_TOL and r["loss_gap"] > LOSS_TOL and r["grad_gap"] > GRAD_TOL, r


def test_recipe_builds_the_task_through_the_cli():
    """``configs/torch/lid_wav2vec_conformer.yaml`` builds this upstream through
    the port's CLI at tiny widths: XL attention, bias-free conv modules at
    expansion 1, the recipe's freeze gates over its names."""
    from speechlid_tpu_torch.cli import main_lid
    from speechlid_tpu_torch.core.config import load_config
    from speechlid_tpu_torch.models.conformer import RelPosXLAttention
    from speechlid_tpu_torch.models.wav2vec2 import Wav2Vec2Conformer

    conf = load_config("configs", "torch/lid_wav2vec_conformer", [
        "module.ssl_config.encoder_layers=1", "module.ssl_config.encoder_embed_dim=64",
        "module.ssl_config.encoder_ffn_embed_dim=128",
        "module.ssl_config.encoder_attention_heads=2"])
    data = {"lang2vocab": {"fa": 8, "sw": 9}, "lang2index": {"fa": 0, "sw": 1},
            "tokenizers": {}}
    task = main_lid.build_task(conf, data, device="cpu")
    upstream = task.model.featurizer.upstream
    assert isinstance(upstream, Wav2Vec2Conformer)
    block = upstream.layers[0]
    assert isinstance(block.attn, RelPosXLAttention) and block.attn.dim_head == 32
    assert block.conv.depthwise.weight.shape == (31, 64)
    assert "bias" not in dict(block.conv.named_parameters(recurse=True)).keys() - {"bn.bias"}
    assert not any("pos_conv" in n for n, _ in task.model.named_parameters())
    names = [n for n, _ in task.model.named_parameters()]
    assert any(task.frozen(n, 1) for n in names if ".layers." in n)
    assert not any(task.frozen(n, 2) for n in names if ".layers." in n)
    assert all(task.frozen(n, 2) for n in names if ".feature_extractor." in n)


def hf_conformer():
    """transformers' wav2vec 2.0 Conformer module, or a skip where it is not
    installed.  A stand-in ``torchaudio`` without ``__spec__``, which other
    test files put in ``sys.modules`` (``speechlid_tpu.compat.refstubs``),
    is hidden while transformers probes for the package: its probe raises
    on one."""
    stub = sys.modules.get("torchaudio")
    hide = stub is not None and getattr(stub, "__spec__", None) is None
    if hide:
        del sys.modules["torchaudio"]
    try:
        return pytest.importorskip(
            "transformers.models.wav2vec2_conformer.modeling_wav2vec2_conformer")
    finally:
        if hide:
            sys.modules["torchaudio"] = stub


def hf_encoder(cfg: dict, p: dict):
    """transformers' ``Wav2Vec2ConformerEncoder`` at the tiny config, its
    leaves from the reference's weights (k and v the halves of ``to_kv``;
    the 1-tap convs' kernels the Linear weights; the depthwise kernel
    transposed), in eval mode."""
    conformer = hf_conformer()
    from transformers import Wav2Vec2ConformerConfig

    ssl = cfg["task"]["ssl_config"]
    c = ssl["encoder_embed_dim"]
    hf_cfg = Wav2Vec2ConformerConfig(
        hidden_size=c, num_hidden_layers=ssl["encoder_layers"],
        num_attention_heads=ssl["encoder_attention_heads"],
        intermediate_size=ssl["encoder_ffn_embed_dim"], hidden_act="swish",
        conv_depthwise_kernel_size=ssl["depthwise_conv_kernel_size"],
        position_embeddings_type="relative", layer_norm_eps=1e-5,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)
    enc = conformer.Wav2Vec2ConformerEncoder(hf_cfg).eval()
    pre = "featurizer.upstream."
    state = {"layer_norm.weight": p[pre + "encoder_layer_norm.weight"],
             "layer_norm.bias": p[pre + "encoder_layer_norm.bias"]}
    pairs = {"ffn1_layer_norm": "norm_ff1", "self_attn_layer_norm": "norm_attn",
             "conv_module.layer_norm": "conv.norm", "ffn2_layer_norm": "norm_ff2",
             "final_layer_norm": "post_norm", "ffn1.intermediate_dense": "ff1.fc1",
             "ffn1.output_dense": "ff1.fc2", "ffn2.intermediate_dense": "ff2.fc1",
             "ffn2.output_dense": "ff2.fc2", "self_attn.linear_q": "attn.to_q",
             "self_attn.linear_out": "attn.to_out"}
    for i in range(ssl["encoder_layers"]):
        src, dst = f"{pre}layers.{i}.", f"layers.{i}."
        for hf, ours in pairs.items():
            for leaf in ("weight", "bias"):
                state[f"{dst}{hf}.{leaf}"] = p[f"{src}{ours}.{leaf}"]
        for leaf in ("weight", "bias"):
            k, v = p[f"{src}attn.to_kv.{leaf}"].chunk(2, dim=0)
            state[f"{dst}self_attn.linear_k.{leaf}"] = k
            state[f"{dst}self_attn.linear_v.{leaf}"] = v
        state[f"{dst}self_attn.linear_pos.weight"] = p[f"{src}attn.linear_pos.weight"]
        state[f"{dst}self_attn.pos_bias_u"] = p[f"{src}attn.pos_bias_u"]
        state[f"{dst}self_attn.pos_bias_v"] = p[f"{src}attn.pos_bias_v"]
        state[f"{dst}conv_module.pointwise_conv1.weight"] = \
            p[f"{src}conv.pointwise_in.weight"][:, :, None]
        state[f"{dst}conv_module.pointwise_conv2.weight"] = \
            p[f"{src}conv.pointwise_out.weight"][:, :, None]
        state[f"{dst}conv_module.depthwise_conv.weight"] = \
            p[f"{src}conv.depthwise.weight"].t()[:, None, :]
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            state[f"{dst}conv_module.batch_norm.{leaf}"] = p[f"{src}conv.bn.{leaf}"]
    missing, _ = enc.load_state_dict(state, strict=False)
    assert all(n.startswith("pos_conv_embed.") or n.endswith("num_batches_tracked")
               for n in missing), missing
    return enc


@pytest.mark.parametrize("d", [32, 64])
def test_reference_agrees_with_transformers(d):
    """The reference's encoder (dropout, layers, final LayerNorm) against
    HF's at unpadded rows in eval mode, on the benchmark's seeded weights."""
    cfg = tiny_config(d)
    task = program.build_task(cfg, "cpu")
    shapes = [(n, s) for n, s in weights.float_entries(task.model)]
    p = weights.make_weights(shapes, SEED, "cpu")
    enc = hf_encoder(cfg, p)
    x = torch.randn(2, 37, WIDTHS[d], generator=torch.Generator().manual_seed(d))
    with torch.no_grad():
        want = enc(x.clone()).last_hidden_state
        got = ref_w2c.encoder(x, p, cfg["task"]["ssl_config"])
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= HF_TOL, err


def test_sinusoidal_table_is_hfs_reversed():
    """Row r + n − 1 holds the embedding of distance r: HF's table (n − 1
    first) read backwards, bit for bit, cached per length."""
    hf = hf_conformer()
    from transformers import Wav2Vec2ConformerConfig

    from speechlid_tpu_torch.models.conformer import sinusoidal_table

    emb = hf.Wav2Vec2ConformerRelPositionalEmbedding(
        Wav2Vec2ConformerConfig(hidden_size=64, max_source_positions=700))
    for n in (1, 37, 649):
        want = emb(torch.zeros(1, n, 64))[0]
        got = sinusoidal_table(n, 64, torch.device("cpu"))
        assert torch.equal(got, want.flip(0)), n
        assert got is sinusoidal_table(n, 64, torch.device("cpu"))


def test_remat_leaves_the_step_unchanged():
    """``remat``: each Conformer layer recomputed in the backward pass, its
    dropout and BatchNorm statistics as in the forward, so one training
    micro-batch gives the same loss and gradients bit for bit."""
    cfg = tiny_config(32)
    out = []
    for remat in (False, True):
        cfg["task"]["remat"] = remat
        task = program.build_task(cfg, "cpu")
        task.set_generators(torch.Generator().manual_seed(TRAINER_SEED),
                            torch.Generator().manual_seed(TRAINER_SEED + 1))
        program.load_weights(task, SEED, "cpu")
        assert task.model.featurizer.upstream.remat is remat
        task.before_train_loop(cfg["trainer"]["steady_epoch"])
        task.model.train()
        loss, _ = task.train_loop(task.place_batch(batch_of()))
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in task.model.named_parameters()
                                    if p.grad is not None}))
    (loss0, grads0), (loss1, grads1) = out
    assert torch.equal(loss0, loss1) and grads0.keys() == grads1.keys()
    assert all(torch.equal(grads0[n], grads1[n]) for n in grads0)
