"""The port's classifier zoo (``models/{batchnorm,pooling,xvector,resnet,
classifier}.py``) against the JAX package's modules on the CPU, weights
carried across by ``convert.classifier_state``.

Tolerances: every forward, the mutated ``batch_stats`` and every gradient
(the parameters' and the input's) within 1e-4 of the JAX leaf's largest
entry.  The BatchNorm, the pooling layers and a Bottleneck block are held
against the JAX modules in float32; each back-end's eval logits too
(``LidClassifier``).  The back-ends' forwards, statistics and gradients are
held against the JAX module run in float64 (``jax.enable_x64``), the port
in float32: JAX's own float32 train-mode gradients lie up to 1.2e-2 of a
leaf's largest entry from its float64 run (ResNet18, ``layer4_0/conv1``),
its jitted eval gradient 1.06e-4 (ResNet18's stem), its ResNet34 train
forward 1.6e-4, where the port's float32 lies within 8.4e-5 of the float64
run, so JAX in float32 is no oracle there.  Two leaves have a true
gradient of zero (``ZERO_GRAD_LEAVES``).  The JAX side runs as its own
tests run it on the CPU, jitted, its BatchNorm statistics randomised so
that eval mode is not the identity.
The inputs are ragged: the last row's 6 frames are fewer than either
TDNN's receptive field (9 and 15 frames), so its valid length is ≤ 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn
from speechlid_tpu.models import classifier as jclassifier
from speechlid_tpu.models import pooling as jpooling
from speechlid_tpu.models import resnet as jresnet
from speechlid_tpu.models import xvector as jxvector
from speechlid_tpu_torch import convert
from speechlid_tpu_torch.models import classifier as pclassifier
from speechlid_tpu_torch.models import pooling as ppooling
from speechlid_tpu_torch.models import resnet as presnet
from speechlid_tpu_torch.models import xvector as pxvector
from speechlid_tpu_torch.models.batchnorm import FlaxBatchNorm
from tests.torch_parity import one_thread, random_batch_stats, tree_leaves_with_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
B, T, F = 3, 60, 16
LENGTHS = np.array([60, 41, 6], np.int32)


def inputs(seed=0, shape=(B, T, F)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def jax_variables(module, *args, **kwargs):
    """numpy variables of ``module.init``, BatchNorm statistics randomised."""
    variables = module.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                            *args, **kwargs)
    if "batch_stats" in variables:
        return random_batch_stats(variables, 0)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def cotangents(outs, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randn(*np.shape(o)).astype(np.float32) for o in outs]


def _outs(out):
    return list(out) if isinstance(out, tuple) else [out]


def run_jax(module, variables, args, train_kwargs, mutable):
    """(outputs, mutated batch_stats, gradients of Σ out·cot: the
    parameters' with the input's under ``"input"``)."""
    stats = variables.get("batch_stats", {})

    def f(params, x):
        v = {"params": params, "batch_stats": stats} if stats else {"params": params}
        if mutable:
            out, mut = module.apply(v, x, *args[1:], **train_kwargs, mutable=["batch_stats"])
        else:
            out, mut = module.apply(v, x, *args[1:], **train_kwargs), {}
        outs = _outs(out)
        cots = cotangents(outs)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, mut)

    (_, (outs, mut)), (grads, g_x) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, variables.get("params", {})), jnp.asarray(args[0]))
    grads = dict(jax.tree_util.tree_map(np.asarray, grads), input=np.asarray(g_x))
    return [np.asarray(o) for o in outs], jax.tree_util.tree_map(np.asarray, dict(mut)), grads


def run_port(module, args, train):
    """(outputs, state_dict after the forward, gradients of Σ out·cot: the
    parameters' as a state_dict, the input's apart)."""
    module.train(train)
    x = torch.from_numpy(args[0]).requires_grad_(True)
    outs = _outs(module(x, *[torch.from_numpy(a) for a in args[1:]]))
    cots = cotangents(outs)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    state = {k: v.detach().clone() for k, v in module.state_dict().items()}
    grads = dict(state)
    for name, p in module.named_parameters():
        grads[name] = p.grad.clone()
    module.zero_grad()
    return [o.detach().numpy() for o in outs], state, (grads, x.grad.numpy())


# leaves whose true gradient is zero (a bias that shifts a softmax over time
# by a constant): both sides hold rounding noise, held to the same share of
# the largest gradient of all
ZERO_GRAD_LEAVES = ("linear2/bias", "att_b_1")


def assert_grads_close(port_grads, want, tol):
    """The port's (state_dict, input gradient) against JAX's gradients."""
    sd, g_x = port_grads
    got = dict(convert.classifier_variables(sd)[0], input=g_x)
    largest = max(float(np.abs(w).max()) for _, w in tree_leaves_with_names(want))
    a, b = tree_leaves_with_names(got), tree_leaves_with_names(want)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        if name.endswith(ZERO_GRAD_LEAVES):
            assert max(np.abs(x).max(), np.abs(y).max()) <= tol * largest, name
            continue
        scale = max(float(np.abs(y).max()), 1e-6)
        np.testing.assert_allclose(x, y, rtol=0, atol=tol * scale, err_msg=f"gradient {name}")


def assert_leaves_close(got, want, tol, what):
    a, b = tree_leaves_with_names(got), tree_leaves_with_names(want)
    assert [n for n, _ in a] == [n for n, _ in b], what
    for (name, x), (_, y) in zip(a, b):
        scale = max(float(np.abs(y).max()), 1e-6)
        np.testing.assert_allclose(x, y, rtol=0, atol=tol * scale, err_msg=f"{what} {name}")


def assert_outs_close(got, want, tol):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * float(np.abs(w).max()))


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


def run_jax_float64(module, variables, args, train_kwargs, mutable):
    """:func:`run_jax` of the same module in float64, the results float32."""
    with jax.enable_x64(True):
        out = run_jax(module, _float64(variables), _float64(list(args)), train_kwargs, mutable)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def check_module(jmodule, pmodule, args, train, jax_train_kwargs, tol=TOL, float64=False):
    """Forward, mutated statistics (train) and gradients of the two
    modules, the port loaded with the JAX module's converted variables; with
    ``float64`` against the JAX module run in float64."""
    variables = jax_variables(jmodule, *args)
    convert.load_into(pmodule, convert.classifier_state(variables.get("params", {}),
                                                        variables.get("batch_stats", {})))
    has_stats = "batch_stats" in variables
    run = run_jax_float64 if float64 else run_jax
    want, mut, jgrads = run(jmodule, variables, args, jax_train_kwargs, train and has_stats)
    got, state, pgrads = run_port(pmodule, args, train)
    assert_outs_close(got, want, tol)
    assert_grads_close(pgrads, jgrads, tol)
    if train and has_stats:
        assert_leaves_close(convert.classifier_variables(state)[1], mut["batch_stats"], tol,
                            "batch_stats")
    return pmodule


# ------------------------------------------------------------- BatchNorm

BN_CASES = {
    # (input shape, feature axis, use_scale/use_bias, train)
    "train_btc": ((4, 9, 6), -1, True, True),
    "train_b1_affine_free": ((1, 256), -1, False, True),
    "eval_btc": ((4, 9, 6), -1, True, False),
    "train_nhwc_as_nchw": ((2, 5, 7, 6), 1, True, True),
}


@pytest.mark.parametrize("case", BN_CASES)
def test_flax_batch_norm(case):
    """The flax BatchNorm alone: the biased running variance, the one-pass
    variance, momentum 0.9, and a batch of one row (which torch's
    ``BatchNorm1d`` refuses in training)."""
    shape, dim, affine, train = BN_CASES[case]
    x = 3.0 + inputs(1, shape)  # an offset mean: the one-pass variance's weak spot
    jbn = nn.BatchNorm(momentum=0.9, use_running_average=not train, use_bias=affine,
                       use_scale=affine)
    # flax normalises the last axis: the NCHW case feeds it the NHWC layout
    x_flax = np.moveaxis(x, 1, -1) if dim == 1 else x
    variables = jax_variables(jbn, x_flax)
    if affine:
        rng = np.random.RandomState(3)
        variables["params"] = {k: (1.0 + 0.3 * rng.randn(*np.shape(v))).astype(np.float32)
                               for k, v in variables["params"].items()}
    pbn = FlaxBatchNorm(shape[dim], use_scale=affine, use_bias=affine, dim=dim)
    sd = {"running_mean": variables["batch_stats"]["mean"],
          "running_var": variables["batch_stats"]["var"]}
    if affine:
        sd.update(weight=variables["params"]["scale"], bias=variables["params"]["bias"])
    convert.load_into(pbn, sd)
    stats = variables["batch_stats"]
    cot = cotangents([x])[0]

    def f(params, xx):
        out = jbn.apply({"params": params, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return jnp.sum(out[0] * np.moveaxis(cot, 1, -1) if dim == 1 else out[0] * cot), out

    (_, (want, mut)), (g_params, g_x) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables.get("params", {}), jnp.asarray(x_flax))
    want, g_x = np.asarray(want), np.asarray(g_x)
    if dim == 1:
        want, g_x = np.moveaxis(want, -1, 1), np.moveaxis(g_x, -1, 1)
    pbn.train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pbn(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(xt.grad.numpy(), g_x, rtol=0,
                               atol=TOL * max(float(np.abs(g_x).max()), 1e-6))
    if affine:
        for ours, theirs in (("weight", "scale"), ("bias", "bias")):
            w = np.asarray(g_params[theirs])
            np.testing.assert_allclose(getattr(pbn, ours).grad.numpy(), w, rtol=0,
                                       atol=TOL * float(np.abs(w).max()), err_msg=ours)
    new = mut["batch_stats"] if train else stats
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        w = np.asarray(new[theirs])
        np.testing.assert_allclose(getattr(pbn, ours).numpy(), w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()), err_msg=ours)
    if train:  # biased: the batch's own variance, not n/(n-1) of it
        axes = tuple(a for a in range(x.ndim) if a != dim % x.ndim)
        biased = x.astype(np.float64).var(axis=axes)
        old = np.asarray(stats["var"], np.float64)
        np.testing.assert_allclose(pbn.running_var.numpy(), 0.9 * old + 0.1 * biased,
                                   rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------- pooling

POOLINGS = {
    "TAP": (jpooling.TAP, {}),
    "TSDP": (jpooling.TSDP, {}),
    "TSTP": (jpooling.TSTP, {}),
    "ASTP": (jpooling.ASTP, {"bottleneck_dim": 8}),
    "ASTP_global_context": (jpooling.ASTP, {"bottleneck_dim": 8, "global_context_att": True}),
    "MHASTP": (jpooling.MHASTP, {"head_num": 4, "bottleneck_dim": 8}),
    "MHASTP_d_s": (jpooling.MHASTP, {"head_num": 4, "d_s": 2, "bottleneck_dim": 8}),
    "MQMHASTP": (jpooling.MQMHASTP, {"head_num": 4, "bottleneck_dim": 8}),
}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("kind", POOLINGS)
def test_pooling(kind, masked):
    """Every pooling layer, its output and its gradients; masked with a row
    that has no valid frame."""
    cls, kwargs = POOLINGS[kind]
    x = inputs(2, (3, 12, 16))
    mask = np.arange(12)[None, :] < np.array([12, 5, 0])[:, None]
    args = (x, mask) if masked else (x,)
    pmodule = ppooling.make_pooling(cls.__name__, 16, **kwargs)
    check_module(cls(**kwargs), pmodule, args, False, {})
    assert pmodule(torch.from_numpy(x)).shape[-1] == ppooling.pooling_out_dim(cls.__name__, 16)


# ------------------------------------------------------------- back-ends

BACKENDS = {
    # name: (JAX module, port module, the JAX call's train kwarg)
    "TDNNXVector": (lambda: jclassifier.TDNNXVector(3, F),
                    lambda: pclassifier.TDNNXVector(3, F), "deterministic"),
    "LinearModel": (lambda: jclassifier.LinearModel(3), lambda: pclassifier.LinearModel(3, F),
                    "deterministic"),
    "XVEC": (lambda: jxvector.XVEC(feat_dim=F, embed_dim=32),
             lambda: pxvector.XVEC(feat_dim=F, embed_dim=32), "train"),
    "ResNet18": (lambda: jresnet.ResNet18(F, 32, "MQMHASTP"),
                 lambda: presnet.ResNet18(F, 32, "MQMHASTP"), "train"),
    "ResNet34": (lambda: jresnet.ResNet34(F, 32, "TSTP"),
                 lambda: presnet.ResNet34(F, 32, "TSTP"), "train"),
}


def _train_kwargs(kwarg, train):
    return {kwarg: (not train) if kwarg == "deterministic" else train}


@pytest.mark.parametrize("name", BACKENDS)
def test_backend_eval_forward_and_gradients(name):
    jmake, pmake, kwarg = BACKENDS[name]
    check_module(jmake(), pmake(), (inputs(), LENGTHS), False, _train_kwargs(kwarg, False),
                 float64=True)


@pytest.mark.parametrize("name", ["LinearModel", "XVEC", "ResNet18", "ResNet34"])
def test_backend_train_forward_stats_and_gradients(name):
    """Train mode: the batch statistics normalise, and the mutated running
    statistics and the gradients follow.  ``TDNNXVector`` has
    dropout 0.2, drawn from each package's own generator: its eval-mode
    gradients are held above, its dropout by the task tests."""
    jmake, pmake, kwarg = BACKENDS[name]
    check_module(jmake(), pmake(), (inputs(), LENGTHS), True, _train_kwargs(kwarg, True),
                 float64=True)


def test_bottleneck_block_train():
    """One stride-2 Bottleneck with a projection shortcut, NHWC in JAX and
    NCHW in the port."""
    class NHWCBottleneck(presnet.Bottleneck):
        def forward(self, x):
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    check_module(jresnet.Bottleneck(planes=8, stride=2), NHWCBottleneck(16, 8, 2),
                 (inputs(4, (2, 9, 7, 16)),), True, {"train": True})


def test_lid_classifier_backends_match_jax():
    """``LidClassifier`` dispatches every back-end as the JAX one does (eval
    logits; ``resnet101`` in its own test)."""
    for backend in ("xvector", "linear", "resnet", "xvector2"):
        jm = jclassifier.LidClassifier(backend=backend, num_classes=3, feat_dim=F)
        variables = jax_variables(jm, inputs(), LENGTHS)
        pm = pclassifier.LidClassifier(backend, 3, F)
        convert.load_into(pm, convert.classifier_state(variables["params"],
                                                       variables.get("batch_stats", {})))
        want = np.asarray(jm.apply(variables, inputs(), LENGTHS))
        got = pm.eval()(torch.from_numpy(inputs()), torch.from_numpy(LENGTHS)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()),
                                   err_msg=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        pclassifier.LidClassifier("lstm")


def test_resnet101_parameter_tree_matches_jax():
    """``resnet101`` at the config's 80 mels: the port's parameters and
    statistics, carried to flax names, have the names and shapes of
    ``jax.eval_shape`` of the JAX init (nothing is compiled)."""
    jm = jclassifier.LidClassifier(backend="resnet101", num_classes=3, feat_dim=80)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 40, 80)),
                                            jnp.array([40, 30])))
    params, stats = convert.classifier_variables(
        pclassifier.LidClassifier("resnet101", 3, 80).state_dict())
    for got, want in ((params, shapes["params"]), (stats, shapes["batch_stats"])):
        a = {n: v.shape for n, v in tree_leaves_with_names(got)}
        b = {"/".join(p.key for p in path): tuple(leaf.shape)
             for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
        assert a == b
