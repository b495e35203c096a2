"""LeViT in the port against ``vit_tpu`` in f32 on the CPU, on the same weights
converted from Flax (every parameter and batch statistic drawn with numpy
from a seed).

Every BatchNorm gets a drawn, nonzero scale and bias and drawn running
statistics.  ``to_out_bn`` starts at γ = 0 in both packages, which would make
every attention add exactly 0 and give q, k, v and the position bias a zero
gradient: with the drawn γ the attention is compared for real.

The pieces: ``hard_swish`` and ``cast_tuple``; the position-bias index
against the one ``vit_tpu``'s attention feeds its ``nn.Embed``, bit for bit,
at fs 4, 7 and 14, with and without downsampling; ``LeViTAttention`` in eval
and training mode (output and running statistics), downsampling at an odd
map (7 → 4) and an even one (8 → 4), and not downsampling.  The whole model
at 112 px (fs 7 → 4 → 2; dims (32, 48, 64), heads (2, 3, 4), dim_key and
dim_value 16, depth 1), batch 2: eval logits, the distillation head's pair,
and one SGD step of ``make_train_step`` against the inner step of
``vit_tpu``'s ``make_bn_train_step``: the loss, every gradient, the updated
parameters and running statistics.  Within 1e-4, the port's bar against
``vit_tpu``; each gradient within 1e-4 of max(1, its largest entry), as
they reach 4 here (:func:`_grad_diff`).  Then the converter leaf for leaf
and the constructor's checks.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vit_tpu.models import levit as jax_levit  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import LeViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.models import levit  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

TOL = 1e-4
SMALL = dict(image_size=112, num_classes=10, dim=(32, 48, 64), depth=1, heads=(2, 3, 4),
             mlp_mult=2, dim_key=16, dim_value=16)
LR = 0.1
BATCH = 2


def _maxdiff(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _random_variables(model, x, rng, **kw):
    """Flax variables of ``model`` on the shapes its init gives (traced, not
    run), every leaf drawn from ``rng``: the norms' scales around 1 and
    their biases around 0, the kernels scaled by their fan-in, the position
    tables at 0.5, the running means around 0 and the variances in [0.5,
    1.5]."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a, **kw),
                            jnp.asarray(x))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * draw).astype(np.float32)
        if name == "embedding":
            return (0.5 * draw).astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {k: dict(v) for k, v in variables.items()}


def _grad_diff(got, want):
    """A gradient's max|diff| over its own scale, ``max(1, max|want|)``: at
    this depth, with BatchNorm normalising over 8 rows at stage 3 in
    training, gradients reach 4, and two f32 summation orders part by a
    share of that, not by an absolute amount (``vit_tpu`` in f32 is as far
    from a float64 run of itself as the port is)."""
    return _maxdiff(got, want) / max(1.0, float(np.max(np.abs(np.asarray(want)))))


def _port_apply(module, x, training):
    module.train(training)
    with torch.no_grad():
        return module(torch.from_numpy(x))


def test_hard_swish_and_cast_tuple():
    x = np.linspace(-5.0, 5.0, 101, dtype=np.float32)
    want = np.asarray(jax_levit.hard_swish(jnp.asarray(x)))
    assert _maxdiff(levit.hard_swish(torch.from_numpy(x)), want) <= 1e-6
    for val, length in ((3, 3), ((1, 2), 3), ((1, 2, 3), 3), ((1, 2, 3, 4), 3), ((5,), 2)):
        assert levit.cast_tuple(val, length) == jax_levit.cast_tuple(val, length)


@pytest.mark.parametrize("downsample", [False, True])
@pytest.mark.parametrize("fmap_size", [4, 7, 14])
def test_position_indices_match_jax(monkeypatch, fmap_size, downsample):
    """The index ``vit_tpu``'s attention hands its ``nn.Embed``, recorded at
    init, against :func:`levit.position_indices`, bit for bit."""
    seen = []

    class Recorder(fnn.Embed):
        def __call__(self, inputs):
            seen.append(np.asarray(inputs))
            return super().__call__(inputs)

    monkeypatch.setattr(jax_levit.nn, "Embed", Recorder)
    module = jax_levit.LeViTAttention(8, fmap_size, heads=1, dim_key=4, dim_value=4,
                                      downsample=downsample)
    module.init(jax.random.PRNGKey(0), jnp.zeros((1, fmap_size, fmap_size, 8)))
    got = levit.position_indices(fmap_size, downsample)
    side = -(-fmap_size // 2) if downsample else fmap_size
    assert got.shape == (side * side, fmap_size * fmap_size)
    assert len(seen) == 1 and np.array_equal(seen[0], got)  # JAX's int32, the port's int64
    assert got.max() < fmap_size * fmap_size


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("fmap_size,downsample,dim_out", [(7, True, 24), (8, True, 24),
                                                          (7, False, None)])
def test_attention_matches_jax(fmap_size, downsample, dim_out, training):
    """``LeViTAttention`` (3 heads, dim_key 8, dim_value 12, dim 16): the
    output, and in training mode the four BatchNorms' running statistics
    after the call.  The q projection's stride-2 1x1 convolution takes the
    map 7 → 4 and 8 → 4."""
    rng = np.random.default_rng(fmap_size + 10 * downsample)
    x = rng.standard_normal((2, fmap_size, fmap_size, 16)).astype(np.float32)
    module = jax_levit.LeViTAttention(16, fmap_size, heads=3, dim_key=8, dim_value=12,
                                      dim_out=dim_out, downsample=downsample)
    v = _random_variables(module, x, rng)
    port = levit.LeViTAttention(16, fmap_size, 3, 8, 12, dim_out=dim_out,
                                downsample=downsample, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert float(port.to_out_bn.weight.detach().abs().min()) > 0
    if training:
        want, new = module.apply(v, jnp.asarray(x), training=True, mutable=["batch_stats"])
    else:
        want = module.apply(v, jnp.asarray(x))
    got = _port_apply(port, x, training)
    side = -(-fmap_size // 2) if downsample else fmap_size
    assert got.shape == (2, side, side, dim_out or 16)
    assert _maxdiff(got, want) <= TOL
    if training:
        stats = state_dict_from_flax({"params": v["params"],
                                      "batch_stats": jax.tree.map(np.asarray,
                                                                  new["batch_stats"])})
        keys = [k for k in stats if "running" in k]
        assert len(keys) == 8
        for key in keys:
            assert _maxdiff(port.state_dict()[key], stats[key]) <= 1e-6, key


@pytest.fixture(scope="module")
def jax_runs():
    """The Flax LeViT at SMALL and its drawn variables, a batch, its eval
    logits and one SGD step of ``make_bn_train_step``'s inner step; the
    distillable LeViT's variables and its eval pair."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((BATCH, 112, 112, 3)).astype(np.float32)
    labels = np.arange(BATCH, dtype=np.int32) * 3 % 10
    model = jax_levit.LeViT(**SMALL)
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
    distill = jax_levit.LeViT(**SMALL, num_distill_classes=6)
    dv = _random_variables(distill, img, rng)
    pair = jax.jit(distill.apply)(dv, jnp.asarray(img))
    return dict(variables=v, img=img, labels=labels, logits=np.asarray(logits),
                loss=float(metrics["loss"]), grads=state_dict_from_flax(grads),
                updated=state_dict_from_flax(updated), distill_variables=dv,
                pair=tuple(np.asarray(t) for t in pair))


def _port(variables, **kw):
    model = LeViT(**SMALL, device="cpu", **kw)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def test_eval_logits_match_jax(jax_runs):
    model = _port(jax_runs["variables"]).eval()
    assert all(float(model.get_submodule(f"{s}.attn_0.to_out_bn").weight.detach().abs().min()) > 0
               for s in ("stage_0", "shrink_0", "stage_1", "shrink_1", "stage_2"))
    with torch.no_grad():
        logits = model(torch.from_numpy(jax_runs["img"]))
    assert logits.shape == (2, 10)
    assert _maxdiff(logits, jax_runs["logits"]) <= TOL


def test_distillation_head_pair_matches_jax(jax_runs):
    model = _port(jax_runs["distill_variables"], num_distill_classes=6).eval()
    with torch.no_grad():
        out, distill = model(torch.from_numpy(jax_runs["img"]))
    want_out, want_distill = jax_runs["pair"]
    assert out.shape == (2, 10) and distill.shape == (2, 6)
    assert _maxdiff(out, want_out) <= TOL and _maxdiff(distill, want_distill) <= TOL


def test_train_step_matches_jax_bn_step(jax_runs):
    """One SGD step in training mode: the loss, every parameter's gradient
    (q, k, v and the position tables' nonzero; each within 1e-4 of its own
    scale, :func:`_grad_diff`), the updated parameters and the updated
    running statistics."""
    model = _port(jax_runs["variables"])
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = float(step(torch.from_numpy(jax_runs["img"]),
                      torch.from_numpy(jax_runs["labels"]).long())["loss"])
    assert abs(loss - jax_runs["loss"]) <= TOL
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jax_runs["grads"])
    for k in grads:
        if "pos_bias" in k or any(f".to_{p}." in k for p in "qkv"):
            assert float(grads[k].abs().max()) > 0, k
    diffs = {k: _grad_diff(grads[k], jax_runs["grads"][k]) for k in grads}
    assert max(diffs.values()) <= TOL, diffs
    state = model.state_dict()
    assert set(state) == set(jax_runs["updated"])
    diffs = {k: _maxdiff(state[k], v) for k, v in jax_runs["updated"].items()}
    assert max(diffs.values()) <= TOL, diffs
    assert sum("running_var" in k for k in diffs) == 5 * 4  # 4 BatchNorms an attention


def test_converter_carries_the_levit_tree(jax_runs):
    """Leaf for leaf, loaded strictly: the stem's HWIO kernels → OIHW, the
    1x1 projections (1, 1, in, out) → (out, in, 1, 1), ``to_out`` as
    ``to_out.0``, BatchNorm ``scale`` → ``weight`` and its ``batch_stats``,
    ``pos_bias/embedding`` → ``pos_bias.weight`` as it is (fs², heads), the
    MLP's convolutions and the heads."""
    v = jax_runs["distill_variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    model = LeViT(**SMALL, num_distill_classes=6, device="cpu")
    state = model.state_dict()
    converted = state_dict_from_flax(v)
    assert set(converted) == set(state) and len(state) == len(flat)
    model.load_state_dict(converted, strict=True)
    hwio, dense = (3, 2, 0, 1), (1, 0)
    names = {
        "params/conv_embedding_0/kernel": ("conv_embedding_0.weight", hwio),
        "params/conv_embedding_3/bias": ("conv_embedding_3.bias", None),
        "params/stage_0/attn_0/to_q/kernel": ("stage_0.attn_0.to_q.weight", hwio),
        "params/shrink_1/attn_0/to_v/kernel": ("shrink_1.attn_0.to_v.weight", hwio),
        "params/stage_1/attn_0/to_k_bn/scale": ("stage_1.attn_0.to_k_bn.weight", None),
        "batch_stats/shrink_0/attn_0/to_q_bn/mean": ("shrink_0.attn_0.to_q_bn.running_mean",
                                                     None),
        "batch_stats/stage_2/attn_0/to_out_bn/var": ("stage_2.attn_0.to_out_bn.running_var",
                                                     None),
        "params/shrink_0/attn_0/pos_bias/embedding": ("shrink_0.attn_0.pos_bias.weight", None),
        "params/stage_2/attn_0/to_out/kernel": ("stage_2.attn_0.to_out.0.weight", hwio),
        "params/stage_2/attn_0/to_out/bias": ("stage_2.attn_0.to_out.0.bias", None),
        "params/stage_1/mlp_0/fc1/kernel": ("stage_1.mlp_0.fc1.weight", hwio),
        "params/mlp_head/kernel": ("mlp_head.weight", dense),
        "params/distill_head/bias": ("distill_head.bias", None),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path]
        got = converted[key].numpy()
        assert got.shape == state[key].shape == want.shape and np.array_equal(got, want), path
    assert converted["shrink_0.attn_0.pos_bias.weight"].shape == (49, 4)
    assert converted["stage_1.attn_0.pos_bias.weight"].shape == (16, 3)


def test_constructor_checks_and_device():
    """``vit_tpu``'s assert (``levit.py:196-198``, a ValueError here), the
    shrink's heads x 2 and dim_out, the map sizes, γ = 0 of ``to_out_bn`` at
    init, and the card as the default device."""
    with pytest.raises(ValueError, match="designated number of stages"):
        LeViT(**dict(SMALL, dim=(32, 48, 64, 80)), device="cpu")
    model = LeViT(**SMALL, device="cpu")
    shrink = model.shrink_0.attn_0
    assert shrink.heads == 4 and shrink.pos_bias.weight.shape == (49, 4)
    assert shrink.to_out[0].weight.shape[0] == 48 and not model.shrink_0.attn_residual
    assert model.stage_1.attn_0.pos_indices.shape == (16, 16)
    assert all(float(m.weight.detach().abs().max()) == 0 for name, m in model.named_modules()
               if name.endswith("to_out_bn"))
    assert "stage_0.attn_0.pos_indices" not in model.state_dict()
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in LeViT(**SMALL).parameters())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LeViT(**SMALL)
