"""Parameter layouts over the model axis: tensor (tp) and expert (ep)
parallelism (port of ``speechlid_tpu/parallel/sharding.py``).

The JAX package maps each flax leaf path to a ``PartitionSpec`` by the
first rule that matches and whose axes divide the leaf; GSPMD then places
every collective, so the sharded program computes the unsharded function.
Here the same rules, over the same flax paths (the names ``convert.py``
maps to this package's modules), decide leaf by leaf, and
:func:`make_param_sharder` turns the decision into Megatron-style modules
that hold this rank's slices, in place:

- a kernel split on its output dim (``ff*/Dense_0``, ``attn/to_q``,
  ``attn/to_kv``, ``conv/Dense_0``, WavLM's ``q/k/v_proj`` and ``fc1``) is
  a column-parallel :class:`models.conformer.Linear` (its bias sliced
  alike; the input through ``copy_to_group``); one split on its input dim
  (``ff*/Dense_1``, ``attn/to_out``, ``conv/Dense_1``, ``out_proj``,
  ``fc2``) a row-parallel one (an all-reduce of the partial products, the
  bias added once after it);
- stacked language heads split on their leading axis (``EP_RULES``) are
  owned whole, head l by model index ``l // (L / model)``.

Where the port's placement differs from JAX's, the value does not:

- a contiguous split of ``conv/Dense_0`` (the GLU's value and gate halves)
  or ``attn/to_kv`` (k then v) would hand one half to each rank; each half
  is sliced on its own, so a rank holds ``[value_c | gate_c]`` for its
  channels and ``[k_h | v_h]`` for its heads;
- the leaves that are per channel or per head inside a split module are
  held sliced where JAX replicates them: the depthwise kernel and bias and
  the BatchNorm (statistics too) of the conv module; the q/k/v biases,
  ``relative_attention_bias`` and ``grep_a`` of WavLM's attention;
- a module is split only whole: where JAX would split one of its kernels
  but not the other, or mid-head (heads or GLU channels that ``model`` does
  not divide), it stays replicated;
- heads whose number ``model`` does not divide fall through ``EP_RULES`` to
  the tp rules in JAX, which split a stacked (L, in, out) kernel's ``in``
  axis; here they stay replicated.

:func:`describe_shardings` prints JAX's ``path shape -> spec`` lines for the
layout the port holds.  Shared leaves used inside a split module
(``rel_pos_emb``, ``grep_linear``) stay replicated and sum their gradient
over the model group (``copy_to_group``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from speechlid_tpu_torch.parallel.mesh import Group, Mesh, all_reduce_

Spec = Tuple[Optional[str], ...]
Rule = Tuple[str, Spec]

# Megatron-style rules for the Conformer blocks (flax paths, JAX's naming)
CONFORMER_TP_RULES: List[Rule] = [
    # feed-forward: expand on output dim, contract on input dim
    (r".*ff\d/Dense_0/kernel$", (None, "model")),
    (r".*ff\d/Dense_0/bias$", ("model",)),
    (r".*ff\d/Dense_1/kernel$", ("model", None)),
    # attention: q/kv projections split heads (output dim), out-proj input
    (r".*attn/to_q/kernel$", (None, "model")),
    (r".*attn/to_kv/kernel$", (None, "model")),
    (r".*attn/to_out/kernel$", ("model", None)),
    # conv module pointwise expand / contract
    (r".*conv/Dense_0/kernel$", (None, "model")),
    (r".*conv/Dense_0/bias$", ("model",)),
    (r".*conv/Dense_1/kernel$", ("model", None)),
]

# WavLM / wav2vec2 encoder layers
WAVLM_TP_RULES: List[Rule] = [
    (r".*self_attn/q_proj/kernel$", (None, "model")),
    (r".*self_attn/k_proj/kernel$", (None, "model")),
    (r".*self_attn/v_proj/kernel$", (None, "model")),
    (r".*self_attn/out_proj/kernel$", ("model", None)),
    (r".*/fc1/kernel$", (None, "model")),
    (r".*/fc1/bias$", ("model",)),
    (r".*/fc2/kernel$", ("model", None)),
]

# expert-parallel: the stacked per-language heads
EP_RULES: List[Rule] = [
    (r"^heads/.*", ("model",)),
    (r".*/heads/.*", ("model",)),
]

COLUMN, ROW = (None, "model"), ("model", None)


def format_spec(spec: Spec) -> str:
    """``PartitionSpec``'s own text: ``PartitionSpec(None, 'model')``."""
    inner = ", ".join("None" if a is None else repr(a) for a in spec)
    return f"PartitionSpec({inner}{',' if len(spec) == 1 else ''})"


def _divisible(shape: Sequence[int], spec: Spec, mesh: Mesh) -> bool:
    for dim, axis in zip(shape, spec):
        if axis is not None and dim % mesh.shape.get(axis, 1) != 0:
            return False
    return len(spec) <= len(shape)


def jax_spec(path: str, shape: Sequence[int], rules, mesh: Mesh) -> Optional[Spec]:
    """The spec the JAX sharder gives the leaf at ``path``: the first rule
    that matches and whose axes divide ``shape``; ``None``: replicated."""
    for pat, spec in rules:
        if re.match(pat, path) and _divisible(shape, spec, mesh):
            return tuple(spec)
    return None


# ---------------------------------------------------------------------------
# the layout: which slice of each full tensor this rank holds
# ---------------------------------------------------------------------------


@dataclass
class Piece:
    """A tensor of the full model that is not replicated: sliced along
    ``dim`` (this rank holds positions ``index``), or, with ``owner`` set,
    held whole by that model index alone."""

    full_shape: Tuple[int, ...]
    dtype: torch.dtype
    is_param: bool
    dim: Optional[int] = None
    index: Optional[torch.Tensor] = None
    owner: Optional[int] = None
    flax: Optional[Tuple[str, Tuple[int, ...], Spec]] = None  # (path, shape, spec) reported


class Layout:
    """What :func:`make_param_sharder` did to a model: ``pieces`` by state
    dict name (in the full model's order), over ``group`` (the model
    group).  It converts between the full (unsharded) state and this
    rank's: :meth:`full_state` gathers (a collective over the model group),
    :meth:`local_state` slices."""

    def __init__(self, group: Group, device: torch.device):
        self.group = group
        self.device = device
        self.pieces: Dict[str, Piece] = {}
        self.replicated: List[Tuple[str, Tuple[int, ...], Spec]] = []  # JAX-split, held whole
        self.expert_leaves: List[Tuple[str, Tuple[int, ...], Spec]] = []  # the stacked heads

    def local_names(self) -> set:
        return {n for n, p in self.pieces.items()
                if p.owner is None or p.owner == self.group.index}

    @torch.no_grad()
    def full_state(self, tensors: Dict[str, torch.Tensor], params_only: bool = False
                   ) -> Dict[str, torch.Tensor]:
        """``tensors`` (this rank's, by state dict name; a model's state
        dict, a parameter-keyed optimizer moment, or gradients) → the full
        tensors, the same on every rank of the model group.  Names outside
        the layout pass through; a name no rank of the group holds in
        ``tensors`` (a gradient not taken) stays out.  ``params_only``: the
        layout's buffers are not in ``tensors``."""
        out = {k: v for k, v in tensors.items() if k not in self.pieces}
        for name, piece in self.pieces.items():
            if params_only and not piece.is_param:
                continue
            local = tensors.get(name)
            device = local.device if local is not None else self.device
            dtype = local.dtype if local is not None else piece.dtype
            # the tensor's elements, then whether this rank held it
            flat = torch.zeros(int(np.prod(piece.full_shape)) + 1, dtype=dtype, device=device)
            full = flat[:-1].view(piece.full_shape)
            if local is not None:
                flat[-1] = 1
                if piece.owner is None:
                    full.index_copy_(piece.dim, piece.index.to(device), local.to(dtype))
                elif piece.owner == self.group.index:
                    full.copy_(local)
            all_reduce_(flat, self.group)
            if flat[-1].item():
                out[name] = full
        return out

    def local_state(self, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full tensors → the ones this rank holds, sliced as it holds them."""
        out = {}
        for name, t in full.items():
            piece = self.pieces.get(name)
            if piece is None:
                out[name] = t
            elif piece.owner is None:
                out[name] = t.index_select(piece.dim, piece.index.to(t.device))
            elif piece.owner == self.group.index:
                out[name] = t
        return out


# ---------------------------------------------------------------------------
# the sharder
# ---------------------------------------------------------------------------


def _flax_prefix(name: str) -> str:
    """A module's state dict prefix → its flax path (unrolled layout):
    ``featurizer.blocks.3.ff1`` → ``featurizer/block_3/ff1``,
    ``heads.heads.2.blocks.0`` → ``heads/heads/block_0`` (the stack)."""
    name = re.sub(r"heads\.heads\.\d+", "heads.heads", name)
    name = re.sub(r"(^|\.)blocks\.(\d+)", r"\1block_\2", name)
    name = re.sub(r"(^|\.)layers\.(\d+)", r"\1layers_\2", name)
    return name.replace(".", "/")


def _chunk(n: int, parts: int, i: int) -> torch.Tensor:
    return torch.arange(i * n // parts, (i + 1) * n // parts)


def _paired(n: int, parts: int, i: int) -> torch.Tensor:
    """Rank i's share of each of two halves of length n, ``[a_i | b_i]``."""
    own = _chunk(n, parts, i)
    return torch.cat([own, n + own])


class _Sharder:
    def __init__(self, mesh: Mesh, rules, model: nn.Module):
        self.mesh, self.rules, self.model = mesh, list(rules), model
        self.group = mesh.group("model")
        self.m, self.i = mesh.model, mesh.index("model")
        device = next(model.parameters()).device
        self.layout = Layout(self.group, device)
        self.full = dict(model.state_dict(keep_vars=True))
        self.params = {n for n, _ in model.named_parameters()}

    def spec(self, path: str, shape) -> Optional[Spec]:
        return jax_spec(path, tuple(shape), self.rules, self.mesh)

    def kernel_spec(self, flax: str, linear: nn.Module) -> Optional[Spec]:
        """The JAX spec of a Dense's (in, out) kernel at ``flax``."""
        return self.spec(flax + "/kernel", (linear.in_features, linear.out_features))

    def slice(self, module: nn.Module, prefix: str, attr: str, dim: int, index: torch.Tensor,
              flax: Optional[Tuple[str, Tuple[int, ...], Spec]] = None) -> None:
        """Keep positions ``index`` along ``dim`` of ``module.attr``."""
        name = f"{prefix}.{attr}" if prefix else attr
        t = getattr(module, attr)
        local = t.detach().index_select(dim, index.to(t.device)).clone()
        if isinstance(t, nn.Parameter):
            new = nn.Parameter(local, requires_grad=t.requires_grad)
            new.sharded_over = self.group
            setattr(module, attr, new)
        else:
            module._buffers[attr] = local
        self.layout.pieces[name] = Piece(tuple(t.shape), t.dtype, name in self.params, dim,
                                         index.clone(), flax=flax)

    def linear(self, module: nn.Module, prefix: str, mode: str, index: torch.Tensor,
               flax: str) -> None:
        """A column- (``"col"``) or row-parallel (``"row"``) Linear keeping
        ``index`` of its output or input features."""
        kshape = (module.in_features, module.out_features)
        dim = 0 if mode == "col" else 1
        self.slice(module, prefix, "weight", dim, index,
                   (flax + "/kernel", kshape, COLUMN if mode == "col" else ROW))
        if module.bias is not None and mode == "col":
            self.slice(module, prefix, "bias", 0, index,
                       (flax + "/bias", (module.out_features,), ("model",)))
        if mode == "col":
            module.out_features = len(index)
        else:
            module.in_features = len(index)
        module.tp, module.tp_group = mode, self.group

    def note_replicated(self, flax: str, shape) -> None:
        """A leaf JAX would split that the port holds whole."""
        spec = self.spec(flax, shape)
        if spec is not None:
            self.layout.replicated.append((flax, tuple(shape), spec))

    # -- the modules ------------------------------------------------------

    def feed_forward(self, ff, prefix: str) -> None:
        flax = _flax_prefix(prefix)
        s0 = self.kernel_spec(flax + "/Dense_0", ff.fc1)
        s1 = self.kernel_spec(flax + "/Dense_1", ff.fc2)
        if s0 != COLUMN or s1 != ROW:
            self._note_linears(flax, {"Dense_0": ff.fc1, "Dense_1": ff.fc2})
            return
        hid = ff.fc1.out_features
        index = _chunk(hid, self.m, self.i)
        self.linear(ff.fc1, prefix + ".fc1", "col", index, flax + "/Dense_0")
        self.linear(ff.fc2, prefix + ".fc2", "row", index, flax + "/Dense_1")
        ff.hidden_shard = (index, hid)

    def conformer_attention(self, attn, prefix: str) -> None:
        flax = _flax_prefix(prefix)
        specs = [self.kernel_spec(f"{flax}/{n}", getattr(attn, n))
                 for n in ("to_q", "to_kv", "to_out")]
        if specs != [COLUMN, COLUMN, ROW] or attn.heads % self.m:
            self._note_linears(flax, {n: getattr(attn, n) for n in ("to_q", "to_kv", "to_out")})
            return
        d, h = attn.dim_head, attn.heads
        heads = _chunk(h, self.m, self.i)
        q = (heads[:, None] * d + torch.arange(d)).reshape(-1)
        self.linear(attn.to_q, prefix + ".to_q", "col", q, flax + "/to_q")
        self.linear(attn.to_kv, prefix + ".to_kv", "col", torch.cat([q, h * d + q]),
                    flax + "/to_kv")
        self.linear(attn.to_out, prefix + ".to_out", "row", q, flax + "/to_out")
        attn.heads = len(heads)
        attn.tp_group = self.group

    def conv_module(self, conv, prefix: str) -> None:
        flax = _flax_prefix(prefix)
        s0 = self.kernel_spec(flax + "/Dense_0", conv.pointwise_in)
        s1 = self.kernel_spec(flax + "/Dense_1", conv.pointwise_out)
        inner = conv.pointwise_out.in_features
        if s0 != COLUMN or s1 != ROW or inner % self.m:
            self._note_linears(flax, {"Dense_0": conv.pointwise_in,
                                      "Dense_1": conv.pointwise_out})
            return
        own = _chunk(inner, self.m, self.i)
        self.linear(conv.pointwise_in, prefix + ".pointwise_in", "col",
                    _paired(inner, self.m, self.i), flax + "/Dense_0")
        self.linear(conv.pointwise_out, prefix + ".pointwise_out", "row", own, flax + "/Dense_1")
        k = conv.depthwise.weight.shape[0]
        self.slice(conv.depthwise, prefix + ".depthwise", "weight", 1, own,
                   (flax + "/depthwise/kernel", (k, 1, inner), (None, None, "model")))
        self.slice(conv.depthwise, prefix + ".depthwise", "bias", 0, own,
                   (flax + "/depthwise/bias", (inner,), ("model",)))
        for attr, leaf in (("weight", "scale"), ("bias", "bias"), ("running_mean", None),
                           ("running_var", None)):
            report = None if leaf is None else (f"{flax}/bn/{leaf}", (inner,), ("model",))
            self.slice(conv.bn, prefix + ".bn", attr, 0, own, report)

    def wavlm_attention(self, attn, prefix: str) -> None:
        flax = _flax_prefix(prefix)
        names = ("q_proj", "k_proj", "v_proj", "out_proj")
        specs = [self.kernel_spec(f"{flax}/{n}", getattr(attn, n)) for n in names]
        if specs != [COLUMN, COLUMN, COLUMN, ROW] or attn.num_heads % self.m:
            self._note_linears(flax, {n: getattr(attn, n) for n in names})
            return
        d, h = attn.head_dim, attn.num_heads
        heads = _chunk(h, self.m, self.i)
        q = (heads[:, None] * d + torch.arange(d)).reshape(-1)
        for n in names:
            self.linear(getattr(attn, n), f"{prefix}.{n}", "row" if n == "out_proj" else "col",
                        q, f"{flax}/{n}")
        if attn.relative_attention_bias is not None:
            nb = attn.relative_attention_bias.shape[0]
            self.slice(attn, prefix, "relative_attention_bias", 1, heads,
                       (flax + "/relative_attention_bias", (nb, h), (None, "model")))
        if attn.gru_rel_pos:
            self.slice(attn, prefix, "grep_a", 1, heads,
                       (flax + "/grep_a", (1, h, 1, 1), (None, "model", None, None)))
            attn.grep_linear.tp, attn.grep_linear.tp_group = "shared", self.group
        attn.head_index, attn.num_heads_full = heads, h
        attn.num_heads = len(heads)
        attn.tp_group = self.group

    def wavlm_ffn(self, layer, prefix: str) -> None:
        flax = _flax_prefix(prefix)
        s1 = self.kernel_spec(flax + "/fc1", layer.fc1)
        s2 = self.kernel_spec(flax + "/fc2", layer.fc2)
        ffn = layer.fc2.in_features
        if s1 != COLUMN or s2 != ROW or ffn % self.m:
            self._note_linears(flax, {"fc1": layer.fc1, "fc2": layer.fc2})
            return
        own = _chunk(ffn, self.m, self.i)
        glu = layer.fc1.out_features == 2 * ffn
        self.linear(layer.fc1, prefix + ".fc1", "col",
                    _paired(ffn, self.m, self.i) if glu else own, flax + "/fc1")
        self.linear(layer.fc2, prefix + ".fc2", "row", own, flax + "/fc2")
        layer.hidden_shard = (own, ffn)

    def heads(self, stack, prefix: str) -> None:
        """ep: each rank keeps the heads it owns; replicated where JAX's
        language split does not apply."""
        n = len(stack.heads)
        leaves = self._head_leaves(prefix, n)
        spec = self.spec("heads/heads/Dense_0/kernel", dict(leaves)["heads/heads/Dense_0/kernel"])
        if spec != ("model",):
            for path, shape in leaves:
                self.note_replicated(path, shape)
            return
        per = n // self.m
        for name, t in self.full.items():
            if name.startswith(prefix + ".heads."):
                lang = int(name[len(prefix) + 7:].split(".")[0])
                self.layout.pieces[name] = Piece(tuple(t.shape), t.dtype, name in self.params,
                                                 owner=lang // per)
        self.layout.expert_leaves = [(path, shape, ("model",)) for path, shape in leaves]
        for lang in range(n):
            if lang // per == self.i:
                for p in stack.heads[lang].parameters():
                    p.sharded_over = self.group
            else:
                stack.heads[lang] = _Absent()
        stack.set_experts(self.group, per)

    def _head_leaves(self, prefix: str, n: int) -> List[Tuple[str, Tuple[int, ...]]]:
        """The stacked heads' flax parameter leaves and shapes (L, ...), as
        ``convert.lid_variables`` lays them out."""
        from speechlid_tpu_torch import convert

        sd = {k[len(prefix) + 1:]: v for k, v in self.full.items()
              if k.startswith(prefix + ".heads.0.")}
        head = "heads.0."
        tree = {}
        for j in range(convert._count(sd, head + "blocks.")):
            tree[f"block_{j}"], _ = convert.block_variables(sd, f"{head}blocks.{j}.")
        for j in range(convert._count(sd, head + "rnns.")):
            convert._spec_variables(("lstm", tuple((c,) for c in convert._cells(2 * j)),
                                     f"{head}rnns.{j}."), sd, tree)
        tree["Dense_0"] = convert._dense_tree(sd, head + "out.")
        return [(path, (n,) + shape) for path, shape in _leaves(tree, "heads/heads")]

    def _note_linears(self, flax: str, linears: Dict[str, nn.Module]) -> None:
        for n, lin in linears.items():
            self.note_replicated(f"{flax}/{n}/kernel", (lin.in_features, lin.out_features))
            if lin.bias is not None:
                self.note_replicated(f"{flax}/{n}/bias", (lin.out_features,))


class _Absent(nn.Module):
    """The slot of a language head that another rank of the model group
    owns (ep)."""


def _leaves(tree, prefix: str):
    for key in sorted(tree):
        value, path = tree[key], f"{prefix}/{key}"
        if hasattr(value, "keys"):
            yield from _leaves(value, path)
        else:
            yield path, tuple(value.shape)


def make_param_sharder(mesh: Mesh, rules: Sequence[Rule]) -> Callable[[nn.Module], Layout]:
    """→ ``fn(model)``: lays ``model`` out over ``mesh``'s model axis in
    place, every leaf as the JAX sharder decides it (the first matching
    rule whose axes divide the leaf; replicated otherwise), and returns the
    :class:`Layout`, also kept as ``model.layout``.  Every rank of the model
    group calls it on the same full model.  A mesh without a model axis (or
    ``model == 1``) leaves the model as it is."""
    from speechlid_tpu_torch.models.conformer import (
        ConformerConvModule,
        FeedForward,
        RelPosAttention,
    )
    from speechlid_tpu_torch.models.multilang import MultiLangHeadStack
    from speechlid_tpu_torch.models.wavlm import RelPosMultiheadAttention, WavLMEncoderLayer

    def shard(model: nn.Module) -> Layout:
        sharder = _Sharder(mesh, rules, model)
        if mesh.model > 1:
            stacks = [(p, m) for p, m in model.named_modules() if isinstance(m, MultiLangHeadStack)]
            for prefix, stack in stacks:
                sharder.heads(stack, prefix)
            kinds = ((FeedForward, sharder.feed_forward),
                     (RelPosAttention, sharder.conformer_attention),
                     (ConformerConvModule, sharder.conv_module),
                     (RelPosMultiheadAttention, sharder.wavlm_attention),
                     (WavLMEncoderLayer, sharder.wavlm_ffn))
            for prefix, module in list(model.named_modules()):
                # a head's blocks follow its stack: owned whole, or replicated
                if any(prefix.startswith(p + ".") for p, _ in stacks):
                    continue
                for kind, lay_out in kinds:
                    if isinstance(module, kind):
                        lay_out(module, prefix)
        model.layout = sharder.layout
        return sharder.layout

    return shard


def describe_shardings(model: nn.Module, max_items: int = 0) -> List[str]:
    """JAX's report, ``path shape -> spec`` for every split leaf, of the
    layout ``model`` holds (flax paths and full shapes; the stacked heads'
    parameter leaves once each).  A model never laid out: ``[]``."""
    layout = getattr(model, "layout", None)
    if layout is None:
        return []
    leaves = [p.flax for p in layout.pieces.values() if p.flax is not None]
    leaves += layout.expert_leaves
    lines = [f"{path} {shape} -> {format_spec(spec)}" for path, shape, spec in leaves]
    return lines[:max_items] if max_items else lines
