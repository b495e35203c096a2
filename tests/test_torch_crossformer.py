"""CrossFormer in the port against ``vit_tpu`` in f32 on the CPU, on the same
weights converted from Flax (every parameter drawn with numpy from a seed).

The config is ``tests/unit/test_windowed_fused.py``'s tiny one (dims 32, 64,
96, 128, depth 1 each, global windows 4, 2, 2, 1, local windows 4, kernels
(2, 4) at strides 4, 2, 2, 2, dim_head 32) on 128 x 128 images, batch 2.
The short windows hold 16 tokens at every stage; the long ones 16 at stage 1
and 4, 4 and 1 after it, which ``vit_tpu``'s ``n < 8`` gate sends to the
plain modules.  Two routes:

- ``never``: ``fused_attention="never", fused_mlp="never"`` on both sides;
- ``kernels``: the port's kernel routes with the 16-bit CUDA gates opened on
  the CPU (``kernel_activation`` patched in ``vit_tpu_torch.layers.common``),
  where each op runs its plain version, against ``vit_tpu``'s
  ``fused_attention="interpret", fused_mlp="interpret"`` (its Pallas kernels
  in interpret mode).  The calls into the ops are counted: 5 biased
  attention blocks (4 short, stage 1's long) and 8 fused MLPs a forward.

Eval logits, and one SGD step of ``make_train_step`` against ``vit_tpu``'s
``make_train_step`` (its inner step, jitted): the loss, every parameter's
gradient (the dynamic position bias MLPs' included: on the kernel route
theirs comes back through the block's dbias) and the updated parameters,
within 1e-4, the port's bar against ``vit_tpu``.  Then the converter leaf
for leaf, ``CrossEmbedLayer``'s three forms against ``vit_tpu``'s, the folds
and the position index against ``vit_tpu``'s arithmetic, the window rule and
the gates, and a fold cut into launches of at most ``MAX_WINDOW_GROUPS``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from einops import rearrange  # noqa: E402

from vit_tpu.models import crossformer as jax_cf  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import CrossFormer, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.models import crossformer  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402
from vit_tpu_torch.tokenizers import CrossEmbedLayer  # noqa: E402

TOL = 1e-4
SMALL = dict(dim=(32, 64, 96, 128), depth=(1, 1, 1, 1), global_window_size=(4, 2, 2, 1),
             local_window_size=4, cross_embed_kernel_sizes=((2, 4),) * 4,
             cross_embed_strides=(4, 2, 2, 2), num_classes=6)
SIZE = 128
LR = 0.1
ROUTES = {"never": dict(fused_attention="never", fused_mlp="never"),
          "kernels": dict(fused_attention="interpret", fused_mlp="interpret")}
PER_FORWARD = {"fused_attention_block_bias": 5, "fused_mlp": 8}


def _maxdiff(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _random_variables(model, img, rng):
    """Flax variables of ``model`` on the shapes its init gives (traced, not
    run), every leaf drawn from ``rng``: the norms' scales around 1, their
    shifts and the biases around 0, the kernels scaled by their fan-in."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a), jnp.asarray(img))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name in ("g", "scale"):
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name in ("b", "bias"):
            return (0.1 * draw).astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_runs():
    """Per route: the Flax model's eval logits and one SGD step (loss,
    gradient, updated parameters), on one set of variables."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.array([3, 5], np.int32)
    v = _random_variables(jax_cf.CrossFormer(**SMALL, **ROUTES["never"]), img, rng)
    runs = {}
    for route, kw in ROUTES.items():
        model = jax_cf.CrossFormer(**SMALL, **kw)
        tx = optax.sgd(LR)
        step, _ = jax_train.make_train_step(
            lambda p, images, rng_key, m=model: m.apply({"params": p}, images, training=True),
            tx, mesh=None)
        state = jax_train.create_train_state(v["params"], tx)
        new_state, metrics = jax.jit(step)(state, jnp.asarray(img), jnp.asarray(labels),
                                           jax.random.PRNGKey(1))
        grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR, v["params"],
                             new_state.params)
        runs[route] = dict(logits=np.asarray(jax.jit(model.apply)(v, jnp.asarray(img))),
                           loss=float(metrics["loss"]), grads=state_dict_from_flax(grads),
                           updated=state_dict_from_flax(jax.tree.map(np.asarray,
                                                                     new_state.params)))
    return dict(variables=v, img=img, labels=labels, runs=runs)


def _open_kernel_gates(monkeypatch, calls):
    """Let the f32 CPU tensors through every kernel gate, and count the calls
    into the ops (which then run their plain versions)."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    for module, name in ((crossformer, "fused_attention_block_bias"), (common, "fused_mlp")):
        monkeypatch.setattr(module, name, lambda *a, f=getattr(module, name), name=name:
                            calls.append(name) or f(*a))


def _port(variables, route, monkeypatch, calls):
    if route == "kernels":
        _open_kernel_gates(monkeypatch, calls)
    model = CrossFormer(**SMALL, device="cpu", **({} if route == "kernels" else ROUTES["never"]))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def _counts(calls):
    return {n: calls.count(n) for n in set(calls)}


@pytest.mark.parametrize("route", ROUTES)
def test_eval_logits_match_jax(jax_runs, monkeypatch, route):
    calls = []
    model = _port(jax_runs["variables"], route, monkeypatch, calls).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(jax_runs["img"]))
    assert _counts(calls) == (PER_FORWARD if route == "kernels" else {})
    assert _maxdiff(logits, jax_runs["runs"][route]["logits"]) <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_matches_jax(jax_runs, monkeypatch, route):
    """One SGD step: the loss, every parameter's gradient (the stems' merged
    convolutions and the dynamic position bias MLPs included) and the updated
    parameters."""
    calls = []
    model = _port(jax_runs["variables"], route, monkeypatch, calls)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = float(step(torch.from_numpy(jax_runs["img"]),
                      torch.from_numpy(jax_runs["labels"]).long())["loss"])
    want = jax_runs["runs"][route]
    assert _counts(calls) == (PER_FORWARD if route == "kernels" else {})
    assert abs(loss - want["loss"]) <= TOL
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want["grads"])
    # The DPB's weights get a gradient wherever a window holds more than one
    # token (stage 4's long one holds one); its out.bias shifts whole softmax
    # rows, and gets none.
    dpb = [k for k in grads if ".dpb." in k]
    assert len(dpb) == 8 * 14 and all(float(grads[k].abs().max()) > 0 for k in dpb
                                      if k.endswith("weight") and "long_attn_3" not in k)
    diffs = {k: _maxdiff(grads[k], want["grads"][k]) for k in grads}
    assert max(diffs.values()) <= TOL, diffs
    state = model.state_dict()
    diffs = {k: _maxdiff(state[k], w) for k, w in want["updated"].items()}
    assert max(diffs.values()) <= TOL, diffs


def test_converter_carries_the_crossformer_tree(jax_runs):
    """Leaf for leaf: the stems' HWIO kernels → OIHW, the 1x1 to_qkv, to_out
    (as ``to_out.0``), fc1 and fc2, the DPB's Dense kernels (in, out) →
    (out, in) and its LayerNorms' scale → weight, the ChannelLayerNorms' g/b
    and the head; loaded strictly."""
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    model = CrossFormer(**SMALL, device="cpu")
    state = model.state_dict()
    converted = state_dict_from_flax(v)
    assert set(converted) == set(state) and len(state) == len(flat)
    model.load_state_dict(converted, strict=True)
    hwio, dense = (3, 2, 0, 1), (1, 0)
    names = {
        "params/cel_0/conv_1/kernel": ("cel_0.conv_1.weight", hwio),
        "params/cel_2/conv_0/bias": ("cel_2.conv_0.bias", None),
        "params/short_attn_0_0/to_qkv/kernel": ("short_attn_0_0.to_qkv.weight", hwio),
        "params/long_attn_1_0/to_out/kernel": ("long_attn_1_0.to_out.0.weight", hwio),
        "params/long_attn_1_0/to_out/bias": ("long_attn_1_0.to_out.0.bias", None),
        "params/short_attn_3_0/norm/g": ("short_attn_3_0.norm.g", None),
        "params/long_attn_0_0/dpb/fc0/kernel": ("long_attn_0_0.dpb.fc0.weight", dense),
        "params/short_attn_2_0/dpb/norm1/scale": ("short_attn_2_0.dpb.norm1.weight", None),
        "params/short_attn_2_0/dpb/out/kernel": ("short_attn_2_0.dpb.out.weight", dense),
        "params/long_ff_3_0/norm/b": ("long_ff_3_0.norm.b", None),
        "params/short_ff_1_0/fc1/kernel": ("short_ff_1_0.fc1.weight", hwio),
        "params/head/kernel": ("head.weight", dense),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path].reshape(state[key].shape)
        got = converted[key].numpy()
        assert got.shape == state[key].shape and np.array_equal(got, want), path
    assert converted["cel_0.conv_1.weight"].shape == (16, 3, 4, 4)
    assert converted["short_attn_1_0.dpb.fc0.weight"].shape == (16, 2)


# CrossEmbedLayer's three forms against vit_tpu's: (b) space-to-depth where the
# stride divides the largest kernel (CrossFormer's stage-1 stem), (a) the
# merged strided convolution where it does not ((3, 6) at stride 4), (c) the
# concatenation where the stride does not divide the map (18 x 18 at 4).
STEM_CASES = {
    "space_to_depth": (((4, 8, 16, 32), 4), 32),
    "strided": (((3, 6), 4), 32),
    "concat": (((2, 4), 4), 18),
}


@pytest.mark.parametrize("form", STEM_CASES)
def test_cross_embed_layer_forms_match_jax(form):
    """The form taken, the output and the gradients of the input and of every
    child convolution's kernel and bias, within 1e-4 of ``vit_tpu``'s layer
    on the same weights."""
    (kernels, stride), side = STEM_CASES[form]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, side, side, 3)).astype(np.float32)
    layer = jax_cf.CrossEmbedLayer(16, kernels, stride=stride)
    v = _random_variables(layer, x, rng)
    want, vjp = jax.vjp(lambda p, a: layer.apply(p, a), v, jnp.asarray(x))
    dy = rng.standard_normal(want.shape).astype(np.float32)
    dv, dx = vjp(jnp.asarray(dy))
    port = CrossEmbedLayer(3, 16, kernels, stride, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert port.form(side, side) == form
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    assert out.shape == want.shape and _maxdiff(out.detach(), want) <= TOL
    out.backward(torch.from_numpy(dy))
    assert _maxdiff(xt.grad, dx) <= TOL
    grads = state_dict_from_flax(dv)
    for k, p in port.named_parameters():
        assert _maxdiff(p.grad, grads[k]) <= TOL, k


@pytest.mark.parametrize("kind,w", [("short", 4), ("long", 4), ("long", 2)])
def test_folds_are_vit_tpu_rearranges(kind, w):
    """The short and long folds are ``vit_tpu``'s einops patterns, contiguous,
    and their inverses give the map back."""
    x = torch.randn(2, 8, 16, 5)
    pattern = ("b (h s1) (w s2) d -> (b h w) (s1 s2) d" if kind == "short"
               else "b (s1 h) (s2 w) d -> (b h w) (s1 s2) d")
    folded = crossformer._fold(x, kind, w)
    assert folded.is_contiguous()
    assert torch.equal(folded, torch.from_numpy(rearrange(x.numpy(), pattern, s1=w, s2=w)))
    assert torch.equal(crossformer._unfold(folded, kind, 2, 8, 16, w), x)


@pytest.mark.parametrize("w", [1, 2, 4, 7])
def test_relative_positions_are_vit_tpu_arithmetic(w):
    """The coordinates and the index into them, ``rel_pos · (2w − 1, 1)``, as
    ``vit_tpu/models/crossformer.py:236-244`` computes them."""
    pos = np.arange(-w, w + 1)
    coords = np.stack(np.meshgrid(pos, pos, indexing="ij"), axis=0).reshape(2, -1).T
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"),
                    axis=0).reshape(2, -1).T
    rel_pos = grid[:, None] - grid[None, :] + w - 1
    index = (rel_pos * np.array([2 * w - 1, 1])).sum(-1)
    got_coords, got_index = crossformer.relative_positions(w)
    assert np.array_equal(got_coords.numpy(), coords.astype(np.float32))
    assert np.array_equal(got_index.numpy(), index)
    assert got_index.max() < (2 * w + 1) ** 2


@pytest.mark.parametrize("route", ROUTES)
def test_a_map_the_window_does_not_divide_raises(monkeypatch, route):
    """112 px: stage 1's 28 x 28 map in 8 x 8 long windows, which
    ``vit_tpu``'s einops fold refuses; the port raises on both routes."""
    if route == "kernels":
        _open_kernel_gates(monkeypatch, [])
    config = dict(SMALL, global_window_size=(8, 2, 2, 1))
    model = CrossFormer(**config, device="cpu", **({} if route == "kernels" else ROUTES["never"]))
    with pytest.raises(ValueError, match="long attention's window size 8"):
        model(torch.zeros(1, 112, 112, 3))


def test_fold_is_cut_into_launches(jax_runs, monkeypatch):
    """With at most 3 window groups a launch, stage 1's short and long folds
    of 128 groups each (2 images of 8 x 8 windows) take 43 calls each,
    stage 2's of 32 groups 11, stage 3's of 8 and stage 4's of 2 three and
    one; the logits are those of whole folds."""
    img = torch.from_numpy(jax_runs["img"])
    with torch.no_grad():
        whole = _port(jax_runs["variables"], "kernels", monkeypatch, []).eval()(img)
        monkeypatch.setattr(crossformer, "MAX_WINDOW_GROUPS", 3)
        calls = []
        cut = _port(jax_runs["variables"], "kernels", monkeypatch, calls).eval()(img)
    assert _counts(calls)["fused_attention_block_bias"] == 2 * 43 + 11 + 3 + 1
    assert _maxdiff(cut, whole) <= 1e-6


def test_gates_send_small_windows_dropout_and_never_to_the_plain_modules(monkeypatch):
    """Windows of at least 8 tokens go to the kernel; 2 x 2 windows (4
    tokens), active attention dropout in training and ``"never"`` take the
    plain modules, as ``vit_tpu``'s gates; both give ``x + attn(x)``."""
    calls = []
    _open_kernel_gates(monkeypatch, calls)
    x = torch.randn(2, 8, 8, 64)
    for kind, w, dropout, train, mode, fused in (
            ("short", 4, 0.0, False, "auto", True), ("long", 4, 0.0, False, "auto", True),
            ("long", 2, 0.0, False, "auto", False), ("short", 4, 0.1, True, "auto", False),
            ("short", 4, 0.1, False, "auto", True), ("short", 4, 0.0, False, "never", False)):
        attn = crossformer.CrossFormerAttention(64, kind, w, dropout=dropout,
                                                device="cpu").train(train)
        before = len(calls)
        with torch.no_grad():
            y = crossformer.crossformer_attention_residual(x, attn, mode)
            assert _maxdiff(y, x + attn(x)) <= 1e-5
        assert len(calls) - before == int(fused), (kind, w, dropout, train, mode)


def test_conv_mlp_residual_takes_the_norm_inside_the_mlp(monkeypatch):
    """``fused_conv_mlp_residual(x, None, mlp)``: the kernel takes
    ``mlp.norm``'s g, b and eps; the plain path is ``x + mlp(x)``."""
    calls = []
    mlp = crossformer.CrossFormerMLP(32, device="cpu")
    with torch.no_grad():
        mlp.norm.g.uniform_(0.5, 1.5)
        mlp.norm.b.uniform_(-0.5, 0.5)
    x = torch.randn(2, 4, 4, 32)
    with torch.no_grad():
        plain = common.fused_conv_mlp_residual(x, None, mlp)
        _open_kernel_gates(monkeypatch, calls)
        fused = common.fused_conv_mlp_residual(x, None, mlp)
        assert _maxdiff(plain, x + mlp(x)) == 0
    assert calls == ["fused_mlp"]
    assert _maxdiff(fused, plain) <= 1e-5


def test_constructor_refuses_tpu_only_modes_and_short_tuples():
    with pytest.raises(ValueError, match="TPU-only"):
        CrossFormer(**SMALL, fused_attention="interpret", device="cpu")
    with pytest.raises(ValueError, match="TPU-only"):
        CrossFormer(**SMALL, fused_mlp="interpret", device="cpu")
    with pytest.raises(ValueError, match="4 stages"):
        CrossFormer(**dict(SMALL, depth=(1, 1, 1)), device="cpu")


def test_smoke_holds_each_position_bias_tensor_stacked_across_attentions():
    """``chip_smoke.stacked_groups``: the step-1 gradient check holds each of
    the DPB's 14 tensors as one stack across the model's attentions (each
    tensor on its own is bf16 noise), and every other tensor on its own."""
    from chip_smoke import stacked_groups

    model = CrossFormer(**SMALL, device="cpu")
    grads = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    groups = stacked_groups(grads)
    assert len(groups) == 14 and all(len(keys) == 8 for keys in groups.values())
    stacked = [k for keys in groups.values() for k in keys]
    assert sorted(stacked) == sorted(k for k in grads if ".dpb." in k)
    assert groups["dpb.out.bias of every attention, stacked"][0] == "long_attn_0_0.dpb.out.bias"
