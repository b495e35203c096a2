"""MobileViT in the port against ``vit_tpu`` in f32 on the CPU, on the same
weights converted from Flax (every parameter and batch statistic drawn with
numpy from a seed; every BatchNorm's scale, bias and statistics nonzero).

The pieces: ``ConvNxNBN``; ``MV2Block`` at stride 1 and 2, expansion 1 and
4, with and without the residual (and the fourth stem block's form, declared
``(dim_in, dim_out)`` with an input of another width); ``MobileViTBlock``,
its unfold/fold round trip included; each in eval and in training mode (the
output, and the running statistics after the call).  The whole model with
narrow channels and depths (1, 1, 1), batch 2: eval logits at 64 px and
non-square at (64, 96) with patches of (2, 3) (the last trunk map is 2 x 3,
so (2, 2) patches do not divide it in either package), and one SGD step of
``make_train_step`` against the inner step of ``vit_tpu``'s
``make_bn_train_step``: the loss, every gradient, the updated parameters and
running statistics.  Within 1e-4, the port's bar against ``vit_tpu``.  Then
the converter leaf for leaf, the earlier models' trees (PiT, NesT,
ScalableViT) converting to the port's keys as before, and the constructor's
checks.
"""

import numpy as np
import pytest
import torch
from einops import rearrange

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vit_tpu.models import mobile_vit as jax_mvit  # noqa: E402
from vit_tpu.models import nest as jax_nest  # noqa: E402
from vit_tpu.models import pit as jax_pit  # noqa: E402
from vit_tpu.models import scalable_vit as jax_scalable  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import MobileViT, NesT, PiT, ScalableViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.models import mobile_vit  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402
from vit_tpu_torch.tokenizers import ConvNxNBN  # noqa: E402

TOL = 1e-4
SMALL = dict(image_size=(64, 64), dims=(16, 24, 32),
             channels=(8, 12, 16, 16, 24, 24, 32, 32, 40, 40, 64), num_classes=10,
             depths=(1, 1, 1))
LR = 0.1


def _maxdiff(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _random_variables(model, x, rng, **kw):
    """Flax variables of ``model`` on the shapes its init gives (traced, not
    run), every leaf drawn from ``rng``: the norms' scales around 1 and
    their biases around 0, the kernels scaled by their fan-in, the cls token
    and position embeddings at unit scale, the running means around 0 and
    the variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a, **kw),
                            jnp.asarray(x))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name in ("scale", "g"):
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name in ("bias", "b", "mean"):
            return (0.1 * draw).astype(np.float32)
        if name in ("cls_token", "pos_embedding", "pos_emb"):
            return draw.astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {k: dict(v) for k, v in variables.items()}


def _convert(variables):
    """:func:`state_dict_from_flax` of a submodule's tree, converted where
    the model holds it (under a parent module: at the top the converter
    reads ``attn_norm_{i}`` … as the small-dataset ViT's layers)."""
    nested = {col: {"m": tree} for col, tree in variables.items()}
    return {k.removeprefix("m."): t for k, t in state_dict_from_flax(nested).items()}


def _check_module(module, port, x, rng, training):
    """``port`` (a fresh module) loaded strictly from ``module``'s drawn
    variables, then held against it on ``x`` in one mode: the output, and
    in training mode every running statistic after the call."""
    v = _random_variables(module, x, rng)
    port.load_state_dict(_convert(v), strict=True)
    port.train(training)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if training:
        want, new = module.apply(v, jnp.asarray(x), training=True, mutable=["batch_stats"])
        stats = _convert({"params": v["params"],
                          "batch_stats": jax.tree.map(np.asarray, new["batch_stats"])})
        keys = [k for k in stats if "running" in k]
        assert keys
        for key in keys:
            assert _maxdiff(port.state_dict()[key], stats[key]) <= 1e-6, key
    else:
        want = module.apply(v, jnp.asarray(x))
    assert got.shape == want.shape and _maxdiff(got, want) <= TOL
    return got


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("kernel,stride,side", [(3, 2, 16), (3, 1, 9), (1, 1, 8)])
def test_conv_nxn_bn_matches_jax(kernel, stride, side, training):
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.standard_normal((2, side, side, 6)).astype(np.float32)
    _check_module(jax_mvit.ConvNxNBN(12, kernel, stride), ConvNxNBN(12, kernel, stride,
                                                                    in_channels=6, device="cpu"),
                  x, rng, training)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("dim_in,dim_out,stride,expansion,width", [
    (8, 8, 1, 4, 8),     # the residual
    (8, 12, 1, 4, 8),    # no residual: the widths differ
    (8, 12, 2, 4, 8),    # stride 2
    (8, 8, 1, 1, 8),     # expansion 1 (no expansion convolution), the residual
    (8, 12, 2, 1, 8),    # expansion 1 at stride 2
    (8, 12, 1, 4, 12),   # declared (8, 12), taking 12 channels: the fourth stem block
])
def test_mv2_block_matches_jax(dim_in, dim_out, stride, expansion, width, training):
    rng = np.random.default_rng(dim_out + stride + expansion + width)
    x = rng.standard_normal((2, 9, 9, width)).astype(np.float32)
    port = mobile_vit.MV2Block(dim_in, dim_out, stride, expansion, in_channels=width,
                               device="cpu")
    assert port.use_res == (stride == 1 and dim_in == dim_out)
    got = _check_module(jax_mvit.MV2Block(dim_in, dim_out, stride, expansion), port, x, rng,
                        training)
    assert got.shape == (2, 5 if stride == 2 else 9, 5 if stride == 2 else 9, dim_out)


@pytest.mark.parametrize("patch", [(2, 2), (2, 3)])
def test_unfold_and_fold_are_the_rearranges(patch):
    """:func:`unfold_patches` is ``b (h ph) (w pw) d -> b (ph pw) (h w) d``
    and :func:`fold_patches` its exact inverse."""
    ph, pw = patch
    x = torch.randn(2, 4 * ph, 3 * pw, 5)
    tokens = mobile_vit.unfold_patches(x, ph, pw)
    want = rearrange(x.numpy(), "b (h ph) (w pw) d -> b (ph pw) (h w) d", ph=ph, pw=pw)
    assert tokens.shape == (2, ph * pw, 12, 5) and np.array_equal(tokens.numpy(), want)
    assert torch.equal(mobile_vit.fold_patches(tokens, 4 * ph, 3 * pw, ph, pw), x)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("patch,width", [((2, 2), 12), ((2, 3), 8)])
def test_mobile_vit_block_matches_jax(patch, width, training):
    """Depth 2, dim 16 (4 heads of 8), channel 12, over an 8 x 6 map; the
    input 12 wide or, as a trunk's when ``ch[4] != ch[5]``, 8 wide."""
    rng = np.random.default_rng(width + patch[1])
    x = rng.standard_normal((2, 8, 6, width)).astype(np.float32)
    port = mobile_vit.MobileViTBlock(16, 2, 12, 3, patch, 32, in_channels=width, device="cpu")
    got = _check_module(jax_mvit.MobileViTBlock(16, 2, 12, 3, patch, 32), port, x, rng,
                        training)
    assert got.shape == (2, 8, 6, 12)


@pytest.fixture(scope="module")
def jax_runs():
    """The Flax MobileViT at SMALL and its drawn variables, a batch, its eval
    logits and one SGD step of ``make_bn_train_step``'s inner step; the
    non-square model's variables and logits."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 7], np.int32)
    model = jax_mvit.MobileViT(**SMALL)
    v = _random_variables(model, img, rng)
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
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR, v["params"],
                         new_state.params)
    updated = {"params": jax.tree.map(np.asarray, new_state.params),
               "batch_stats": jax.tree.map(np.asarray, new_state.model_state)}
    wide = jax_mvit.MobileViT(**NON_SQUARE)
    wide_img = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    wv = _random_variables(wide, wide_img, rng)
    return dict(variables=v, img=img, labels=labels, logits=np.asarray(logits),
                loss=float(metrics["loss"]), grads=state_dict_from_flax(grads),
                updated=state_dict_from_flax(updated), wide_variables=wv, wide_img=wide_img,
                wide_logits=np.asarray(jax.jit(wide.apply)(wv, jnp.asarray(wide_img))))


NON_SQUARE = dict(SMALL, image_size=(64, 96), patch_size=(2, 3))


def _port(variables, cfg=SMALL):
    model = MobileViT(**cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


@pytest.mark.parametrize("shape", ["square", "non-square"])
def test_eval_logits_match_jax(jax_runs, shape):
    square = shape == "square"
    model = _port(jax_runs["variables" if square else "wide_variables"],
                  SMALL if square else NON_SQUARE).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(jax_runs["img" if square else "wide_img"]))
    assert logits.shape == (2, 10)
    assert _maxdiff(logits, jax_runs["logits" if square else "wide_logits"]) <= TOL


def test_train_step_matches_jax_bn_step(jax_runs):
    """One SGD step in training mode: the loss, every parameter's gradient,
    the updated parameters and the updated running statistics."""
    model = _port(jax_runs["variables"])
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = float(step(torch.from_numpy(jax_runs["img"]),
                      torch.from_numpy(jax_runs["labels"]).long())["loss"])
    assert abs(loss - jax_runs["loss"]) <= TOL
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jax_runs["grads"])
    diffs = {k: _maxdiff(grads[k], jax_runs["grads"][k]) for k in grads}
    assert max(diffs.values()) <= TOL, diffs
    state = model.state_dict()
    assert set(state) == set(jax_runs["updated"])
    diffs = {k: _maxdiff(state[k], v) for k, v in jax_runs["updated"].items()}
    assert max(diffs.values()) <= TOL, diffs
    assert sum("running_var" in k for k in diffs) == 1 + 4 * 3 + 3 * 3 + 3 * 4 + 1


def test_converter_carries_the_mobile_vit_tree(jax_runs):
    """Leaf for leaf, loaded strictly: HWIO kernels → OIHW (the depthwise
    (3, 3, 1, C) → (C, 1, 3, 3)), Dense kernels transposed, ``to_out`` as
    ``to_out.0``, the per-layer names inside ``trunk_attn_{i}`` as they are
    (no ``layers.{j}``), BatchNorm ``scale`` → ``weight`` and its
    ``batch_stats``, LayerNorm ``scale`` → ``weight``, and the head."""
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    model = MobileViT(**SMALL, device="cpu")
    state = model.state_dict()
    converted = state_dict_from_flax(v)
    assert set(converted) == set(state) and len(state) == len(flat)
    assert not any(".layers." in k for k in converted)
    hwio, dense = (3, 2, 0, 1), (1, 0)
    names = {
        "params/conv1/conv/kernel": ("conv1.conv.weight", hwio),
        "params/conv1/bn/scale": ("conv1.bn.weight", None),
        "batch_stats/stem_3/dw_bn/mean": ("stem_3.dw_bn.running_mean", None),
        "params/stem_0/dw/kernel": ("stem_0.dw.weight", hwio),
        "params/trunk_conv_1/pw_linear/kernel": ("trunk_conv_1.pw_linear.weight", hwio),
        "params/trunk_attn_0/attn_norm_0/scale": ("trunk_attn_0.attn_norm_0.weight", None),
        "params/trunk_attn_2/attn_0/to_qkv/kernel": ("trunk_attn_2.attn_0.to_qkv.weight", dense),
        "params/trunk_attn_1/attn_0/to_out/kernel": ("trunk_attn_1.attn_0.to_out.0.weight",
                                                     dense),
        "params/trunk_attn_1/mlp_fc1_0/kernel": ("trunk_attn_1.mlp_fc1_0.weight", dense),
        "params/trunk_attn_2/mlp_fc2_0/bias": ("trunk_attn_2.mlp_fc2_0.bias", None),
        "params/trunk_attn_0/conv4/conv/kernel": ("trunk_attn_0.conv4.conv.weight", hwio),
        "batch_stats/to_logits_conv/bn/var": ("to_logits_conv.bn.running_var", None),
        "params/head/kernel": ("head.weight", dense),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path]
        got = converted[key].numpy()
        assert got.shape == state[key].shape == want.shape and np.array_equal(got, want), path
    assert converted["stem_0.dw.weight"].shape == (32, 1, 3, 3)
    assert "head.bias" not in converted


EARLIER = {
    "PiT": (jax_pit.PiT, PiT, dict(image_size=32, patch_size=4, num_classes=4, dim=16,
                                   depth=(1, 1), heads=2, mlp_dim=32), 32),
    "NesT": (jax_nest.NesT, NesT, dict(image_size=32, patch_size=4, num_classes=4, dim=32,
                                       heads=1, num_hierarchies=2, block_repeats=(1, 1)), 32),
    "ScalableViT": (jax_scalable.ScalableViT, ScalableViT,
                    dict(num_classes=4, dim=16, heads=(1, 2), depth=(1, 1),
                         reduction_factor=(2, 1), window_size=(4, None)), 32),
}
# A few keys of each tree as the converter made them before LeViT and MobileViT.
EARLIER_KEYS = {
    "PiT": {"transformer_0.layers.0.attn.to_out.0.weight", "pool_0.downsample_grouped.weight",
            "transformer_1.layers.0.mlp_norm.bias"},
    "NesT": {"transformer_0.attn_0.to_qkv.weight", "transformer_1.mlp_fc2_0.bias",
             "transformer_0.pos_emb"},
    "ScalableViT": {"stage_0.layers.0.ssa.to_out.0.weight", "stage_1.layers.0.iwsa_norm.g",
                    "stage_0.layers.0.ff1.fc1.weight"},
}


@pytest.mark.parametrize("name", EARLIER)
def test_converter_keeps_the_earlier_trees(name):
    """PiT's stages as stacks (``layers.{j}``), NesT's ``transformer_{idx}``
    and ScalableViT's ``stage_{s}`` per-layer rule convert to the keys they
    did: the port's ``state_dict`` keys, loaded strictly."""
    jax_cls, port_cls, cfg, side = EARLIER[name]
    img = np.zeros((1, side, side, 3), np.float32)
    converted = state_dict_from_flax(_random_variables(jax_cls(**cfg), img,
                                                       np.random.default_rng(3)))
    model = port_cls(**cfg, device="cpu")
    assert set(converted) == set(model.state_dict())
    assert EARLIER_KEYS[name] <= set(converted)
    model.load_state_dict(converted, strict=True)


def test_constructor_checks_and_device():
    """``vit_tpu``'s asserts (``mobile_vit.py:178-183``, ``:58``), ValueErrors
    here, and the card as the default device."""
    with pytest.raises(ValueError, match="dims must be a tuple of 3"):
        MobileViT(**dict(SMALL, dims=(16, 24)), device="cpu")
    with pytest.raises(ValueError, match="depths must be a tuple of 3"):
        MobileViT(**dict(SMALL, depths=(1, 1)), device="cpu")
    with pytest.raises(ValueError, match="divisible by the patch size"):
        MobileViT(**dict(SMALL, image_size=(64, 63)), device="cpu")
    with pytest.raises(ValueError, match="stride"):
        mobile_vit.MV2Block(8, 8, 3, device="cpu")
    model = MobileViT(**SMALL, device="cpu")
    assert model.head.bias is None and model.stem_3.use_res and not model.stem_1.use_res
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in MobileViT(**SMALL).parameters())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MobileViT(**SMALL)
