"""CvT's path in the port against ``vit_tpu`` in f32 on the CPU: TF-SAME
padding, the conv-hybrid layers (``ChannelLayerNorm``, the grouped conv, the
depthwise + BatchNorm + pointwise projection in eval and in train mode, with
the running statistics after a train-mode call), and a small CvT (64 px,
stage dims 32/48/64, depths 1/1/1, heads 1/2/2) converted from Flax with
random ``batch_stats``: eval logits through the plain path and through the
flash route (the gate opened on the CPU, where the flash op runs its plain
version), and one SGD step of ``make_train_step`` against
``make_bn_train_step``'s inner step: loss, every gradient, the updated
parameters and ``batch_stats``.  Within 1e-4, the port's bar against
``vit_tpu``.  The JAX side runs jitted, once per module.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vit_tpu.layers.common import ChannelLayerNorm as JaxChannelLayerNorm  # noqa: E402
from vit_tpu.layers.common import GroupedConv as JaxGroupedConv  # noqa: E402
from vit_tpu.models import cvt as jax_cvt  # noqa: E402
from vit_tpu.ops.patchify import _same_pads  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import CvT, cast_params, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers.common import ChannelLayerNorm, GroupedConv  # noqa: E402
from vit_tpu_torch.models.cvt import CvTDepthWiseConv2d  # noqa: E402
from vit_tpu_torch.ops import attention  # noqa: E402
from vit_tpu_torch.ops.patchify import conv2d_same, same_pads  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

TOL = 1e-4
SMALL = dict(num_classes=10, s1_emb_dim=32, s2_emb_dim=48, s3_emb_dim=64, s1_depth=1,
             s2_depth=1, s3_depth=1, s1_heads=1, s2_heads=2, s3_heads=2)
SIZE = 64  # stage 1: 16x16 queries, 8x8 keys; stage 2: 8x8, 4x4; stage 3: 4x4, 2x2
LR = 0.1


def _f32(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _maxdiff(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _perturb(tree, rng, names, scale=0.1):
    """A copy of ``tree`` with noise added to the leaves named ``names``."""
    return {k: _perturb(v, rng, names, scale) if isinstance(v, dict)
            else (v + _f32(rng, *v.shape, scale=scale) if k in names else v)
            for k, v in tree.items()}


def _variables(module, x, rng, **kw):
    """Flax variables of ``module`` at input ``x`` as NumPy, with the norms'
    parameters moved off their init and random running statistics, so that
    the conversion matters."""
    v = jax.tree.map(np.asarray, jax.jit(lambda a: module.init(jax.random.PRNGKey(0), a,
                                                               **kw))(jnp.asarray(x)))
    v = {key: dict(val) for key, val in v.items()}
    v["params"] = _perturb(v["params"], rng, ("g", "b", "scale", "bias"))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), v["batch_stats"])
    return v


@pytest.mark.parametrize("size,kernel,stride", [
    (224, 7, 4), (384, 7, 4), (56, 3, 2), (96, 3, 2), (28, 3, 1), (7, 3, 2), (14, 3, 2),
    (5, 1, 1), (3, 7, 4),
])
def test_same_pads_match_jax(size, kernel, stride):
    assert same_pads(size, kernel, stride) == _same_pads(size, kernel, stride)


@pytest.mark.parametrize("size,kernel,stride,groups", [
    (32, 7, 4, 1),   # the stage-1 embedding's (1, 2)
    (8, 3, 2, 1),    # a stage-2/3 embedding on an even map: (0, 1)
    (8, 3, 2, 6),    # a k/v depthwise projection: (0, 1)
    (9, 3, 1, 6),    # stride 1: (1, 1)
])
def test_conv2d_same_matches_flax_same(size, kernel, stride, groups):
    """TF-SAME against Flax's ``padding="SAME"``; where the pads are
    asymmetric, PyTorch's symmetric ``padding=k // 2`` gives the same shape and
    other numbers."""
    rng = np.random.default_rng(size + kernel)
    cin, cout = 6, 6 if groups > 1 else 5
    x = _f32(rng, 2, size, size, cin)
    kern, bias = _f32(rng, kernel, kernel, cin // groups, cout), _f32(rng, cout)
    conv = fnn.Conv(cout, (kernel, kernel), strides=stride, padding="SAME",
                    feature_group_count=groups)
    want = conv.apply({"params": {"kernel": kern, "bias": bias}}, jnp.asarray(x))
    w = torch.from_numpy(kern.transpose(3, 2, 0, 1).copy())
    got = conv2d_same(torch.from_numpy(x), w, torch.from_numpy(bias), stride, groups)
    assert got.shape == want.shape and _maxdiff(got, want) <= TOL
    sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, torch.from_numpy(bias), stride,
                   kernel // 2, 1, groups).permute(0, 2, 3, 1)
    lo, hi = same_pads(size, kernel, stride)
    assert sym.shape == got.shape
    assert (_maxdiff(sym, want) > 1e-2) == (lo != hi)


def test_channel_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = _f32(rng, 2, 5, 7, 24, shift=0.3)
    norm = JaxChannelLayerNorm(24)
    v = _variables(norm, x, rng)
    port = ChannelLayerNorm(24, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert _maxdiff(port(torch.from_numpy(x)).detach(), norm.apply(v, jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("size,stride,use_bias", [(8, 2, False), (9, 1, True)])
def test_grouped_conv_matches_jax(size, stride, use_bias):
    rng = np.random.default_rng(size)
    x = _f32(rng, 2, size, size, 12)
    conv = JaxGroupedConv(12, (3, 3), strides=stride, use_bias=use_bias)
    v = _variables(conv, x, rng)
    port = GroupedConv(12, 3, stride, use_bias, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert _maxdiff(port(torch.from_numpy(x)).detach(), conv.apply(v, jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("training", [False, True])
def test_depthwise_projection_matches_jax(training):
    """Eval mode normalises with the converted running statistics; train mode
    with the batch's, and updates the running ones as Flax does: momentum 0.9
    and the *biased* batch variance (``nn.BatchNorm2d`` would take the
    unbiased one, 1/63 larger here)."""
    rng = np.random.default_rng(7)
    x = _f32(rng, 4, 4, 4, 16, scale=2.0, shift=0.5)
    proj = jax_cvt.CvTDepthWiseConv2d(16, 24, 3, stride=2, use_bias=False)
    v = _variables(proj, x, rng)
    if training:
        want, new = proj.apply(v, jnp.asarray(x), training=True, mutable=["batch_stats"])
        new_stats = {"params": v["params"], "batch_stats": jax.tree.map(np.asarray,
                                                                        new["batch_stats"])}
    else:
        want = proj.apply(v, jnp.asarray(x))
    port = CvTDepthWiseConv2d(16, 24, 3, 2, use_bias=False, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    port.train(training)
    assert _maxdiff(port(torch.from_numpy(x)).detach(), want) <= TOL
    if training:
        want_state = state_dict_from_flax(new_stats)
        for key in ("bn.running_mean", "bn.running_var"):
            assert _maxdiff(port.state_dict()[key], want_state[key]) <= 1e-6, key


@pytest.fixture(scope="module")
def jax_cvt_run():
    """The Flax CvT at SMALL, its variables (perturbed norms, random
    ``batch_stats``), a batch, its eval logits, and one SGD step of
    ``make_bn_train_step``'s inner step with its loss gradient."""
    rng = np.random.default_rng(0)
    img = _f32(rng, 2, SIZE, SIZE, 3, shift=0.2)
    labels = np.array([3, 7], np.int32)
    model = jax_cvt.CvT(**SMALL)
    v = _variables(model, img, rng)
    logits = jax.jit(model.apply)(v, jnp.asarray(img))

    def apply_fn(params, stats, images, rng_key):
        out, new = model.apply({"params": params, "batch_stats": stats}, images,
                               training=True, mutable=["batch_stats"])
        return out, new["batch_stats"]

    tx = optax.sgd(LR)
    step, _ = jax_train.make_bn_train_step(apply_fn, tx, mesh=None)
    state = jax_train.create_bn_train_state(v["params"], v["batch_stats"], tx)
    new_state, metrics = jax.jit(step)(state, jnp.asarray(img), jnp.asarray(labels),
                                       jax.random.PRNGKey(1))
    # The step's gradient: its update over the learning rate.
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR, v["params"],
                         new_state.params)
    updated = {"params": jax.tree.map(np.asarray, new_state.params),
               "batch_stats": jax.tree.map(np.asarray, new_state.model_state)}
    return dict(variables=v, img=img, labels=labels, logits=np.asarray(logits),
                loss=float(metrics["loss"]), grads=state_dict_from_flax(grads),
                updated=state_dict_from_flax(updated))


def _open_flash_gate(monkeypatch, calls):
    """Let f32 CPU calls at n >= 64 through the flash tier (stages 1 and 2 of
    SMALL), counting them; the op then runs its plain version."""
    monkeypatch.setattr(attention, "flash_tensor", lambda t: True)
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 64)
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, f=attention.flash_attention: calls.append(a[0].shape) or f(*a))


def _port(run, **kw):
    model = CvT(**SMALL, device="cpu", **kw)
    model.load_state_dict(state_dict_from_flax(run["variables"]), strict=True)
    return model


@pytest.mark.parametrize("route", ["plain", "flash"])
def test_cvt_eval_logits_match_jax(jax_cvt_run, monkeypatch, route):
    calls = []
    if route == "flash":
        _open_flash_gate(monkeypatch, calls)
    model = _port(jax_cvt_run).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(jax_cvt_run["img"]))
    assert len(calls) == (2 if route == "flash" else 0)
    assert _maxdiff(logits, jax_cvt_run["logits"]) <= TOL


@pytest.mark.parametrize("route", ["plain", "flash"])
def test_cvt_train_step_matches_jax_bn_step(jax_cvt_run, monkeypatch, route):
    """One SGD step in training mode: the loss, every parameter's gradient,
    the updated parameters and the updated running statistics."""
    calls = []
    if route == "flash":
        _open_flash_gate(monkeypatch, calls)
    model = _port(jax_cvt_run)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = float(step(torch.from_numpy(jax_cvt_run["img"]),
                      torch.from_numpy(jax_cvt_run["labels"]).long())["loss"])
    assert len(calls) == (2 if route == "flash" else 0)
    assert abs(loss - jax_cvt_run["loss"]) <= TOL
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jax_cvt_run["grads"])
    diffs = {k: _maxdiff(grads[k], jax_cvt_run["grads"][k]) for k in grads}
    assert max(diffs.values()) <= TOL, diffs
    state = model.state_dict()
    assert set(state) == set(jax_cvt_run["updated"])
    diffs = {k: _maxdiff(state[k], v) for k, v in jax_cvt_run["updated"].items()}
    assert max(diffs.values()) <= TOL, diffs
    assert any("running_var" in k for k in diffs)


def test_accum_steps_on_a_batchnorm_model_raises():
    model = CvT(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="BatchNorm"):
        make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR), accum_steps=2)
    make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR), accum_steps=1)


def test_converter_carries_the_cvt_tree(jax_cvt_run):
    """Leaf for leaf: Conv kernels HWIO → OIHW, the depthwise ones (kh, kw,
    1, C) → (C, 1, kh, kw), 1x1 convs (1, 1, in, out) → (out, in, 1, 1),
    ChannelLayerNorm's g/b (1, 1, 1, C) → (C,), BatchNorm's scale and
    batch_stats, the per-stage layers, and the head."""
    v = jax_cvt_run["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    state = _port(jax_cvt_run).state_dict()
    assert len(state) == len(flat)
    hwio = (3, 2, 0, 1)
    layer = "s2_transformer/attn_0"
    names = {
        "params/s1_emb/kernel": ("s1_emb.weight", hwio),
        "params/s3_norm/g": ("s3_norm.g", None),
        f"params/{layer}/to_kv/depthwise/kernel": (
            "s2_transformer.layers.0.attn.to_kv.depthwise.weight", hwio),
        f"params/{layer}/to_q/pointwise/kernel": (
            "s2_transformer.layers.0.attn.to_q.pointwise.weight", hwio),
        f"params/{layer}/to_q/bn/scale": ("s2_transformer.layers.0.attn.to_q.bn.weight", None),
        f"batch_stats/{layer}/to_kv/bn/var": (
            "s2_transformer.layers.0.attn.to_kv.bn.running_var", None),
        f"params/{layer}/to_out/kernel": ("s2_transformer.layers.0.attn.to_out.0.weight", hwio),
        "params/s1_transformer/mlp_fc2_0/bias": ("s1_transformer.layers.0.mlp_fc2.bias", None),
        "params/s1_transformer/attn_norm_0/b": ("s1_transformer.layers.0.attn_norm.b", None),
        "params/head/kernel": ("head.weight", (1, 0)),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path].reshape(state[key].shape)
        assert state[key].shape == want.shape and np.array_equal(state[key].numpy(), want), path
    assert state["s1_norm.g"].shape == (32,)


def test_cast_params_keeps_the_running_statistics_f32():
    model = cast_params(CvT(**SMALL, device="cpu"), torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    stats = [b for name, b in model.named_buffers() if "running" in name]
    assert stats and all(b.dtype == torch.float32 for b in stats)
    with torch.no_grad():
        assert model.eval()(torch.randn(2, SIZE, SIZE, 3)).dtype == torch.bfloat16
