"""NesT in the port against ``vit_tpu`` in f32 on the CPU, on the same weights
converted from Flax (every parameter drawn with numpy from a seed).

The config is a small one at dim_head 32, the narrowest the port's block
kernel takes (``SUPPORTED_DIM_HEAD``): 64 x 64 images, patch 4, dim 64, 2
heads, 3 hierarchies, block repeats (1, 1, 2), batch 2.  The 16 x 16 patch
map folds into 16, 4 and 1 blocks of 4 x 4 tokens an image: 32, 8 and 2
groups of 16 tokens at 64, 128 and 256 channels (2, 4 and 8 heads of 32).
Two routes:

- ``never``: ``fused_attention="never", fused_mlp="never"`` on both sides;
- ``kernels``: the port's kernel route with the 16-bit CUDA gate opened on
  the CPU (``kernel_activation`` patched in ``vit_tpu_torch.layers.common``),
  where each op runs its plain version, against ``vit_tpu``'s
  ``fused_attention="interpret", fused_mlp="interpret"`` (its Pallas kernels
  in interpret mode).  The calls into the ops are counted: 4 fused attention
  blocks and 4 fused MLPs a forward, one of each a transformer layer.

Eval logits, and one SGD step of ``make_train_step`` against ``vit_tpu``'s
``make_train_step`` (its inner step, jitted): the loss, every parameter's
gradient (the ``pos_emb`` vectors' included) and the updated parameters,
within 1e-4, the port's bar against ``vit_tpu``.  Then the converter leaf
for leaf, the block folds against ``vit_tpu``'s einops patterns, the
aggregate's max pool against Flax's SAME pool (which pads (0, 1) on an even
map, not (1, 1)), the gates, ``fused_conv_mlp_residual`` with a loose
``fc1`` / ``fc2`` pair against the same with an ``mlp`` module, a fold cut
into launches of at most ``MAX_WINDOW_GROUPS`` groups, and the
constructor's divisibility check.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from einops import rearrange  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

from vit_tpu.models import nest as jax_nest  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import NesT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.models import nest  # noqa: E402
from vit_tpu_torch.models.scalable_vit import ConvMLP  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

TOL = 1e-4
SMALL = dict(image_size=64, patch_size=4, num_classes=8, dim=64, heads=2, num_hierarchies=3,
             block_repeats=(1, 1, 2))
LR = 0.1
ROUTES = {"never": "never", "kernels": "interpret"}
PER_FORWARD = {"fused_attention_block": 4, "fused_mlp": 4}


def _maxdiff(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _random_variables(model, img, rng):
    """Flax variables of ``model`` on the shapes its init gives (traced, not
    run), every leaf drawn from ``rng``: the norms' g around 1, their b and
    the biases around 0, the kernels scaled by their fan-in, the position
    scalars at unit scale."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a), jnp.asarray(img))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "g":
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name in ("b", "bias"):
            return (0.1 * draw).astype(np.float32)
        if name == "pos_emb":
            return draw.astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_runs():
    """Per route: the Flax model's eval logits and one SGD step (loss,
    gradient, updated parameters), on one set of variables."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 5], np.int32)
    v = _random_variables(jax_nest.NesT(**SMALL, fused_attention="never", fused_mlp="never"),
                          img, rng)
    out = dict(img=img, labels=labels, variables=v, runs={})
    for route, mode in ROUTES.items():
        model = jax_nest.NesT(**SMALL, fused_attention=mode, fused_mlp=mode)
        tx = optax.sgd(LR)
        step, _ = jax_train.make_train_step(
            lambda p, images, rng_key, m=model: m.apply({"params": p}, images, training=True),
            tx, mesh=None)
        state = jax_train.create_train_state(v["params"], tx)
        new_state, metrics = jax.jit(step)(state, jnp.asarray(img), jnp.asarray(labels),
                                           jax.random.PRNGKey(1))
        grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR, v["params"],
                             new_state.params)
        out["runs"][route] = dict(
            logits=np.asarray(jax.jit(model.apply)(v, jnp.asarray(img))),
            loss=float(metrics["loss"]), grads=state_dict_from_flax(grads),
            updated=state_dict_from_flax(jax.tree.map(np.asarray, new_state.params)))
    return out


def _open_kernel_gates(monkeypatch, calls):
    """Let the f32 CPU tensors through the kernel gate, and count the calls
    into the ops (which then run their plain versions)."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    for module, name in ((nest, "fused_attention_block"), (common, "fused_mlp")):
        monkeypatch.setattr(module, name, lambda *a, f=getattr(module, name), name=name:
                            calls.append(name) or f(*a))


def _port(variables, route, monkeypatch, calls):
    if route == "kernels":
        _open_kernel_gates(monkeypatch, calls)
    model = NesT(**SMALL, device="cpu",
                 **({} if route == "kernels" else dict(fused_attention="never",
                                                       fused_mlp="never")))
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
    """One SGD step: the loss, every parameter's gradient (each hierarchy's
    ``pos_emb`` included) and the updated parameters."""
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
    positions = sorted(k for k in grads if k.endswith("pos_emb"))
    assert len(positions) == 3 and all(float(grads[k].abs().max()) > 0 for k in positions)
    diffs = {k: _maxdiff(grads[k], want["grads"][k]) for k in grads}
    assert max(diffs.values()) <= TOL, diffs
    state = model.state_dict()
    diffs = {k: _maxdiff(state[k], w) for k, w in want["updated"].items()}
    assert max(diffs.values()) <= TOL, diffs


def test_converter_carries_the_nest_tree(jax_runs):
    """Leaf for leaf: the convolutions' HWIO kernels → OIHW, the head's Dense
    kernel (in, out) → (out, in), ``to_out`` as ``to_out.0``, the
    ChannelLayerNorms' g and b as vectors, ``pos_emb`` as it is; the
    per-layer modules keep their names under ``transformer_{idx}`` (not
    ``layers.{i}``); loaded strictly."""
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    model = NesT(**SMALL, device="cpu")
    state = model.state_dict()
    converted = state_dict_from_flax(v)
    assert set(converted) == set(state) and len(state) == len(flat)
    model.load_state_dict(converted, strict=True)
    hwio, dense = (3, 2, 0, 1), (1, 0)
    names = {
        "params/patch_embedding/kernel": ("patch_embedding.weight", hwio),
        "params/transformer_0/pos_emb": ("transformer_0.pos_emb", None),
        "params/transformer_0/attn_norm_0/g": ("transformer_0.attn_norm_0.g", None),
        "params/transformer_1/attn_0/to_qkv/kernel": ("transformer_1.attn_0.to_qkv.weight",
                                                      hwio),
        "params/transformer_2/attn_1/to_out/kernel": ("transformer_2.attn_1.to_out.0.weight",
                                                      hwio),
        "params/transformer_2/attn_1/to_out/bias": ("transformer_2.attn_1.to_out.0.bias", None),
        "params/transformer_1/mlp_norm_0/b": ("transformer_1.mlp_norm_0.b", None),
        "params/transformer_2/mlp_fc1_1/kernel": ("transformer_2.mlp_fc1_1.weight", hwio),
        "params/transformer_0/mlp_fc2_0/bias": ("transformer_0.mlp_fc2_0.bias", None),
        "params/aggregate_conv_1/kernel": ("aggregate_conv_1.weight", hwio),
        "params/aggregate_norm_0/g": ("aggregate_norm_0.g", None),
        "params/head_norm/b": ("head_norm.b", None),
        "params/head/kernel": ("head.weight", dense),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path].reshape(-1)
        got = converted[key].numpy()
        assert got.shape == state[key].shape and np.array_equal(got.reshape(-1),
                                                                want.reshape(-1)), path
    assert converted["patch_embedding.weight"].shape == (64, 4 * 4 * 3, 1, 1)
    assert converted["transformer_2.pos_emb"].shape == (16,)
    assert not any(k.startswith("transformer_0.layers") for k in converted)


@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_block_folds_are_vit_tpu_rearranges(blocks):
    """The fold ``b (b1 h) (b2 w) c -> (b b1 b2) h w c`` as ``NesT.forward``
    takes it from ``_windows`` (contiguous), and the unfold back through
    ``_unwindows``, as ``vit_tpu``'s einops patterns (``nest.py:189-198``)."""
    x = torch.randn(2, 8, 8, 5)
    h = w = 8 // blocks
    want = rearrange(x.numpy(), "b (b1 h) (b2 w) c -> (b b1 b2) h w c", b1=blocks, b2=blocks)
    folded = nest._windows(x, h, w).reshape(-1, h, w, 5)
    assert folded.is_contiguous() and torch.equal(folded, torch.from_numpy(want))
    back = rearrange(want, "(b b1 b2) h w c -> b (b1 h) (b2 w) c", b1=blocks, b2=blocks)
    unfolded = nest._unwindows(folded.reshape(-1, h * w, 5), 2, 8, 8, h, w)
    assert torch.equal(unfolded, torch.from_numpy(back)) and torch.equal(unfolded, x)


@pytest.mark.parametrize("side", [8, 7, 4])
def test_max_pool_is_flax_same(side):
    """The aggregate's 3 x 3, stride-2 max pool against Flax's
    ``padding="SAME"`` (``nest.py:203``), on random maps where the (0, 1)
    pads of an even side and the (1, 1) pads of ``F.max_pool2d(padding=1)``
    give different answers; at an odd side both pad (1, 1)."""
    x = np.random.default_rng(side).standard_normal((2, side, side, 3)).astype(np.float32)
    want = np.asarray(flax_nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = nest.max_pool_same(torch.from_numpy(x))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    symmetric = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
    symmetric = symmetric.permute(0, 2, 3, 1).numpy()
    assert symmetric.shape == want.shape
    assert np.array_equal(symmetric, want) == (side % 2 == 1)


def test_gates_send_dropout_and_never_to_the_plain_modules(monkeypatch):
    """The attention and the MLP go to the kernels unless dropout is active
    in training or the mode is ``"never"``; every case gives the plain
    modules' output (the same dropout draws, from one seed)."""
    calls = []
    _open_kernel_gates(monkeypatch, calls)
    x = torch.randn(3, 4, 4, 64)
    for dropout, train, mode, fused in ((0.0, True, "auto", True), (0.1, False, "auto", True),
                                        (0.1, True, "auto", False), (0.0, False, "never", False)):
        layer = nest.NesTTransformer(64, 16, 1, 2, 4, dropout, mode, mode,
                                     device="cpu").train(train)
        norm, attn = layer.attn_norm_0, layer.attn_0
        before = len(calls)
        torch.manual_seed(0)
        with torch.no_grad():
            y = nest.nest_attention_residual(x, norm, attn, mode)
            z = common.fused_conv_mlp_residual(x, layer.mlp_norm_0, None, mode,
                                               fc1=layer.mlp_fc1_0, fc2=layer.mlp_fc2_0,
                                               dropout=layer.dropout)
            torch.manual_seed(0)
            want_y = x + attn(norm(x))
            want_z = x + layer.dropout(layer.mlp_fc2_0(layer.dropout(common.gelu_exact(
                layer.mlp_fc1_0(layer.mlp_norm_0(x))))))
        assert _maxdiff(y, want_y) <= 1e-5 and _maxdiff(z, want_z) <= 1e-5
        assert calls[before:] == (["fused_attention_block", "fused_mlp"] if fused else []), \
            (dropout, train, mode)


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("train", [False, True])
def test_loose_pair_is_the_mlp_module(monkeypatch, route, train):
    """``fused_conv_mlp_residual`` with a loose ``fc1`` / ``fc2`` pair and its
    dropout gives what it gives with an ``mlp`` module holding them, on the
    plain path and on the kernel route, in eval and (dropout active, the
    same draws) in training."""
    calls = []
    if route == "kernels":
        _open_kernel_gates(monkeypatch, calls)
    g = torch.Generator().manual_seed(3)
    mlp = ConvMLP(32, 4, 0.2, device="cpu", generator=g).train(train)
    norm = common.ChannelLayerNorm(32, device="cpu")
    x = torch.randn(2, 5, 5, 32, generator=g)
    with torch.no_grad():
        torch.manual_seed(1)
        want = common.fused_conv_mlp_residual(x, norm, mlp)
        torch.manual_seed(1)
        got = common.fused_conv_mlp_residual(x, norm, None, fc1=mlp.fc1, fc2=mlp.fc2,
                                             dropout=mlp.dropout)
    assert torch.equal(got, want)
    fused = route == "kernels" and not train
    assert calls == (["fused_mlp"] * 2 if fused else [])


def test_fold_is_cut_into_launches(jax_runs, monkeypatch):
    """With at most 3 groups a launch, the folds of 32, 8 and 2 blocks take
    11, 3 and 1 calls (stage 3's twice, at its two layers); the logits are
    those of whole folds."""
    img = torch.from_numpy(jax_runs["img"])
    v = jax_runs["variables"]
    with torch.no_grad():
        whole = _port(v, "kernels", monkeypatch, []).eval()(img)
        monkeypatch.setattr(nest, "MAX_WINDOW_GROUPS", 3)
        calls = []
        cut = _port(v, "kernels", monkeypatch, calls).eval()(img)
    assert _counts(calls) == {"fused_attention_block": 11 + 3 + 2, "fused_mlp": 4}
    assert _maxdiff(cut, whole) <= 1e-6


def test_constructor_asserts_and_refuses_tpu_modes():
    """``vit_tpu``'s assert (``nest.py:161-164``, a ValueError here), and the
    TPU-only modes."""
    with pytest.raises(ValueError, match="divisible by the patch size"):
        NesT(**dict(SMALL, image_size=66), device="cpu")
    for key in ("fused_attention", "fused_mlp"):
        with pytest.raises(ValueError, match="TPU-only"):
            NesT(**SMALL, **{key: "interpret"}, device="cpu")
