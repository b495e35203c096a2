"""PiT in the port against ``vit_tpu`` in f32 on the CPU, on the same weights
converted from Flax (every parameter drawn with numpy from a seed).

The config keeps PiT@224's own token counts at a small width: 64 x 64
images, patch 4 (stride 2: 31 x 31 overlapping patches), dim 32 (stages 32,
64 and 128 wide), 2 heads of 32 (the narrowest dim_head the block kernel
takes), depth (1, 1, 2), mlp 64, 8 classes, batch 2.  The stages hold 962,
257 and 65 tokens, so the attention block's route past 512 tokens
(``attention_route``: ``mha``) and its short route's two 144-key tiles at
257 are both crossed.  Two routes:

- ``never``: ``fused_attention="never", fused_mlp="never"`` on both sides
  (``vit_tpu``'s ``PiT`` takes no such argument, so its ``Transformer`` is
  replaced for the test by a partial that passes them; no file of
  ``vit_tpu`` changes);
- ``kernels``: the port's kernel route with the 16-bit CUDA gate opened on
  the CPU (``kernel_activation`` patched in ``vit_tpu_torch.layers.common``),
  where each op runs its plain version, against ``vit_tpu``'s
  ``fused_attention="interpret", fused_mlp="interpret"`` (its Pallas kernels
  in interpret mode).  The calls into the ops are counted: 4 fused attention
  blocks and 4 fused MLPs a forward, one of each a transformer layer.

Eval logits, and one SGD step of ``make_train_step`` against ``vit_tpu``'s
``make_train_step`` (its inner step, jitted): the loss, every parameter's
gradient (``pos_embedding``'s and ``cls_token``'s included) and the updated
parameters, within 1e-4, the port's bar against ``vit_tpu``.  Then the
attention block at 962 tokens (inner 64 over d 32) against ``vit_tpu``'s
kernel in interpret mode, forward and gradient; ``Pool`` against
``vit_tpu``'s at 31 → 16 and 16 → 8 (TF-SAME pads (1, 1) and (0, 1));
``OverlapPatchEmbed`` against ``extract_patches`` and a Dense; the converter
leaf for leaf, and NesT's mapping unchanged by the rule that makes PiT's
stages stacks; the constructor's checks.
"""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vit_tpu.layers import common as jax_common  # noqa: E402
from vit_tpu.models import nest as jax_nest  # noqa: E402
from vit_tpu.models import pit as jax_pit  # noqa: E402
from vit_tpu.ops import fused_attention_block as jax_attn  # noqa: E402
from vit_tpu.ops.patchify import extract_patches as jax_extract_patches  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import NesT, PiT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.models import pit  # noqa: E402
from vit_tpu_torch.ops.fused_attention_block import (  # noqa: E402
    attention_route, fused_attention_block,
)
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

TOL = 1e-4
OP_TOL = 1e-5  # the op-level bar of the block's own tests against the Pallas kernel
SMALL = dict(image_size=64, patch_size=4, num_classes=8, dim=32, depth=(1, 1, 2), heads=2,
             dim_head=32, mlp_dim=64)
TOKENS = (962, 257, 65)
LR = 0.1
ROUTES = {"never": "never", "kernels": "interpret"}
PER_FORWARD = {"fused_attention_block": 4, "fused_mlp": 4}


def _maxdiff(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _rel(got, want):
    want = np.asarray(want)
    return _maxdiff(got, want) / (float(np.max(np.abs(want))) + 1e-12)


def _random_variables(model, img, rng):
    """Flax variables of ``model`` on the shapes its init gives (traced, not
    run), every leaf drawn from ``rng``: the LayerNorms' scales around 1,
    the biases around 0, the kernels scaled by their fan-in, the cls token
    and the position embedding at unit scale."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a), jnp.asarray(img))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name in ("scale", "g"):
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name in ("bias", "b"):
            return (0.1 * draw).astype(np.float32)
        if name in ("cls_token", "pos_embedding", "pos_emb"):
            return draw.astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_pit(mode):
    """``vit_tpu``'s PiT with its stages' ``Transformer`` on ``mode`` (the
    class replaced inside ``vit_tpu.models.pit`` for the call, as its
    constructor takes no mode)."""
    stage = functools.partial(jax_common.Transformer, fused_attention=mode, fused_mlp=mode)
    model = jax_pit.PiT(**SMALL)

    def apply(variables, img, **kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_pit, "Transformer", stage)
            return model.apply(variables, img, **kw)

    return model, apply


@pytest.fixture(scope="module")
def jax_runs():
    """Per route: the Flax model's eval logits and one SGD step (loss,
    gradient, updated parameters), on one set of variables."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 5], np.int32)
    v = _random_variables(jax_pit.PiT(**SMALL), img, rng)
    out = dict(img=img, labels=labels, variables=v, runs={})
    for route, mode in ROUTES.items():
        _, apply = _jax_pit(mode)
        tx = optax.sgd(LR)
        step, _ = jax_train.make_train_step(
            lambda p, images, rng_key, apply=apply: apply({"params": p}, images, training=True),
            tx, mesh=None)
        state = jax_train.create_train_state(v["params"], tx)
        new_state, metrics = jax.jit(step)(state, jnp.asarray(img), jnp.asarray(labels),
                                           jax.random.PRNGKey(1))
        grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR, v["params"],
                             new_state.params)
        out["runs"][route] = dict(
            logits=np.asarray(jax.jit(apply)(v, jnp.asarray(img))),
            loss=float(metrics["loss"]), grads=state_dict_from_flax(grads),
            updated=state_dict_from_flax(jax.tree.map(np.asarray, new_state.params)))
    return out


def _open_kernel_gates(monkeypatch, calls):
    """Let the f32 CPU tensors through the kernel gate, and count the calls
    into the ops (which then run their plain versions)."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    for name in ("fused_attention_block", "fused_mlp"):
        monkeypatch.setattr(common, name, lambda *a, f=getattr(common, name), name=name, **k:
                            calls.append((name, a[0].shape[1])) or f(*a, **k))


def _port(variables, route, monkeypatch, calls):
    if route == "kernels":
        _open_kernel_gates(monkeypatch, calls)
    model = PiT(**SMALL, device="cpu",
                **({} if route == "kernels" else dict(fused_attention="never",
                                                      fused_mlp="never")))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def _counts(calls):
    names = [name for name, _ in calls]
    return {n: names.count(n) for n in set(names)}


def _check_calls(calls, route, forwards=1):
    """Per forward: the four layers' blocks and MLPs, at the stages' token
    counts (one layer at 962 and at 257, two at 65)."""
    if route == "never":
        assert calls == []
        return
    assert _counts(calls) == {k: forwards * v for k, v in PER_FORWARD.items()}
    blocks = [n for name, n in calls if name == "fused_attention_block"]
    assert blocks == [962, 257, 65, 65] * forwards
    assert [attention_route(n) for n in blocks[:4]] == ["mha", "short", "short", "short"]


@pytest.mark.parametrize("route", ROUTES)
def test_eval_logits_match_jax(jax_runs, monkeypatch, route):
    calls = []
    model = _port(jax_runs["variables"], route, monkeypatch, calls).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(jax_runs["img"]))
    _check_calls(calls, route)
    assert logits.shape == (2, 8)
    assert _maxdiff(logits, jax_runs["runs"][route]["logits"]) <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_matches_jax(jax_runs, monkeypatch, route):
    """One SGD step: the loss, every parameter's gradient (the position
    embedding's and the cls token's included) and the updated parameters."""
    calls = []
    model = _port(jax_runs["variables"], route, monkeypatch, calls)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = float(step(torch.from_numpy(jax_runs["img"]),
                      torch.from_numpy(jax_runs["labels"]).long())["loss"])
    want = jax_runs["runs"][route]
    _check_calls(calls, route)
    assert abs(loss - want["loss"]) <= TOL
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want["grads"])
    for k in ("pos_embedding", "cls_token"):
        assert float(grads[k].abs().max()) > 0
    diffs = {k: _maxdiff(grads[k], want["grads"][k]) for k in grads}
    assert max(diffs.values()) <= TOL, diffs
    state = model.state_dict()
    diffs = {k: _maxdiff(state[k], w) for k, w in want["updated"].items()}
    assert max(diffs.values()) <= TOL, diffs


def _block_args(rng, b, n, d, heads, dh):
    inner = heads * dh

    def f32(*shape, scale=1.0, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    return (f32(b, n, d), f32(d, scale=0.1, shift=1.0), f32(d, scale=0.1),
            f32(d, 3 * inner, scale=0.05), f32(inner, d, scale=0.05), f32(d, scale=0.05))


def test_attention_block_at_962_tokens_matches_jax_kernel():
    """The block at PiT's stage-1 token count, (1, 962, 32) with 2 heads of
    32 (inner 64 over d 32), on the mha route: the port's plain forward and
    its autograd backward (``fused_attention_block`` on CPU tensors) against
    ``vit_tpu``'s ``fused_attention_block`` in interpret mode and its VJP,
    each output within 1e-5 of max|JAX output|."""
    b, n, d, heads, dh = 1, 962, 32, 2, 32
    assert attention_route(n) == "mha"
    rng = np.random.default_rng(7)
    args = _block_args(rng, b, n, d, heads, dh)
    dy = (rng.standard_normal((b, n, d)) * 0.1).astype(np.float32)
    y, vjp = jax.vjp(lambda *a: jax_attn.fused_attention_block(*a, heads, dh, None, 1e-3, True),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    t = torch.from_numpy
    inputs = [t(a.T.copy() if i in (3, 4) else a).requires_grad_() for i, a in enumerate(args)]
    before = fused_attention_block.launches
    got_y = fused_attention_block(*inputs, heads, dh)
    got = torch.autograd.grad(got_y, inputs, t(dy))
    assert fused_attention_block.launches == before  # CPU: the plain versions
    assert _rel(got_y.detach().numpy(), y) <= OP_TOL
    for i, (name, g, w) in enumerate(zip(["dx", "dgamma", "dbeta", "dwqkv", "dwo", "dbo"],
                                         got, want)):
        g = g.numpy().T if i in (3, 4) else g.numpy()
        assert g.shape == np.shape(w), name
        assert _rel(g, w) <= OP_TOL, f"{name}: {_rel(g, w)}"


@pytest.mark.parametrize("side", [31, 16])
def test_pool_matches_jax(side):
    """``Pool`` against ``vit_tpu``'s at PiT's two pool sides: 31 → 16 (the
    grouped convolution's TF-SAME pads (1, 1)) and 16 → 8 ((0, 1), the pad
    after), each input channel making two outputs."""
    dim, b = 8, 2
    rng = np.random.default_rng(side)
    x = rng.standard_normal((b, side * side + 1, dim)).astype(np.float32)
    module = jax_pit.Pool(dim)
    v = _random_variables(module, x, rng)
    want = np.asarray(module.apply(v, jnp.asarray(x)))
    port = pit.Pool(dim, device="cpu")
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    assert port.downsample_grouped.weight.shape == (2 * dim, 1, 3, 3)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    out_side = -(-side // 2)
    assert got.shape == want.shape == (b, out_side * out_side + 1, 2 * dim)
    assert _maxdiff(got, want) <= 1e-5


def test_overlap_patch_embed_is_extract_patches_and_dense():
    """``OverlapPatchEmbed`` against ``vit_tpu``'s VALID stride-``k // 2``
    unfold (``extract_patches``) and the Dense over it, on the Dense-shaped
    parameters the converter carries; and against ``vit_tpu``'s layer."""
    k, s, c, dim = 4, 2, 3, 16
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 64, 64, c)).astype(np.float32)
    kernel = (rng.standard_normal((k * k * c, dim)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(dim) * 0.1).astype(np.float32)
    patches = np.asarray(jax_extract_patches(jnp.asarray(img), k, s, "VALID"))
    want = patches.reshape(2, -1, k * k * c) @ kernel + bias
    layer = jax_pit.OverlapPatchEmbed(dim, k, s)
    params = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    assert _maxdiff(layer.apply(params, jnp.asarray(img)), want) <= 1e-5
    port = pit.OverlapPatchEmbed(dim, k, s, c, device="cpu")
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    assert port.weight.shape == (dim, k * k * c)
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    assert got.shape == (2, 31 * 31, dim) and _maxdiff(got, want) <= 1e-5
    assert pit.conv_output_size(224, 14, 7) ** 2 + 1 == TOKENS[0]


def test_converter_carries_the_pit_tree(jax_runs):
    """Leaf for leaf: the Dense kernels (in, out) → (out, in), the patch
    embedding's among them; the convolutions' HWIO kernels → OIHW (the
    grouped one's (3, 3, 1, 2d) → (2d, 1, 3, 3)); LayerNorm ``scale`` →
    ``weight``; ``to_out`` as ``to_out.0``; the cls token and the position
    embedding as they are; each stage's per-layer modules under
    ``transformer_{i}.layers.{j}``; loaded strictly."""
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    model = PiT(**SMALL, device="cpu")
    state = model.state_dict()
    converted = state_dict_from_flax(v)
    assert set(converted) == set(state) and len(state) == len(flat)
    model.load_state_dict(converted, strict=True)
    hwio, dense = (3, 2, 0, 1), (1, 0)
    names = {
        "params/patch_embedding/kernel": ("patch_embedding.weight", dense),
        "params/patch_embedding/bias": ("patch_embedding.bias", None),
        "params/cls_token": ("cls_token", None),
        "params/pos_embedding": ("pos_embedding", None),
        "params/transformer_0/attn_norm_0/scale": ("transformer_0.layers.0.attn_norm.weight",
                                                   None),
        "params/transformer_0/attn_0/to_qkv/kernel": ("transformer_0.layers.0.attn.to_qkv.weight",
                                                      dense),
        "params/transformer_2/attn_1/to_out/kernel": (
            "transformer_2.layers.1.attn.to_out.0.weight", dense),
        "params/transformer_2/attn_1/to_out/bias": ("transformer_2.layers.1.attn.to_out.0.bias",
                                                    None),
        "params/transformer_1/mlp_0/fc1/kernel": ("transformer_1.layers.0.mlp.fc1.weight", dense),
        "params/transformer_2/mlp_norm_1/bias": ("transformer_2.layers.1.mlp_norm.bias", None),
        "params/pool_0/cls_ff/kernel": ("pool_0.cls_ff.weight", dense),
        "params/pool_1/downsample_grouped/kernel": ("pool_1.downsample_grouped.weight", hwio),
        "params/pool_1/downsample_grouped/bias": ("pool_1.downsample_grouped.bias", None),
        "params/pool_0/downsample_pointwise/kernel": ("pool_0.downsample_pointwise.weight", hwio),
        "params/head_norm/scale": ("head_norm.weight", None),
        "params/head/kernel": ("head.weight", dense),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path]
        got = converted[key].numpy()
        assert got.shape == state[key].shape == want.shape and np.array_equal(got, want), path
    assert converted["pool_0.downsample_grouped.weight"].shape == (64, 1, 3, 3)
    assert converted["pos_embedding"].shape == (1, TOKENS[0], 32)


def test_converter_leaves_the_nest_tree_as_it_was():
    """NesT's ``transformer_{idx}`` (with ``pos_emb`` and ``mlp_fc1_{i}``)
    is not a stack: its keys keep the per-layer names, no ``layers.{i}``,
    and load strictly into the port's NesT."""
    cfg = dict(image_size=32, patch_size=4, num_classes=4, dim=32, heads=1, num_hierarchies=2,
               block_repeats=(1, 1))
    img = np.zeros((1, 32, 32, 3), np.float32)
    v = _random_variables(jax_nest.NesT(**cfg), img, np.random.default_rng(1))
    converted = state_dict_from_flax(v)
    assert not any(".layers." in k for k in converted)
    assert {"transformer_0.attn_0.to_qkv.weight", "transformer_1.mlp_fc2_0.bias",
            "transformer_0.pos_emb"} <= set(converted)
    model = NesT(**cfg, device="cpu")
    assert set(converted) == set(model.state_dict())
    model.load_state_dict(converted, strict=True)


def test_constructor_checks_and_tpu_modes_raise():
    """``vit_tpu``'s two asserts (``pit.py:110-116``, ValueErrors here),
    ``scan_layers=True``, and the TPU-only modes."""
    with pytest.raises(ValueError, match="divisible by the patch size"):
        PiT(**dict(SMALL, image_size=66), device="cpu")
    with pytest.raises(ValueError, match="depth must be a tuple"):
        PiT(**dict(SMALL, depth=[1, 1, 2]), device="cpu")
    with pytest.raises(ValueError, match="scan_layers"):
        PiT(**SMALL, scan_layers=True, device="cpu")
    for key, mode in (("fused_attention", "interpret"), ("fused_mlp", "interpret"),
                      ("fused_attention", "hybrid"), ("fused_attention", "bmajor")):
        with pytest.raises(ValueError, match="TPU-only"):
            PiT(**SMALL, **{key: mode}, device="cpu")


@pytest.mark.parametrize("mode", ["auto", "never"])
def test_plain_and_kernel_routes_give_one_function(monkeypatch, mode):
    """The port's two routes on one set of weights, a seeded initialisation:
    the kernel route (the gate opened on the CPU) and ``"never"`` within
    1e-4, eval mode; with dropout active in training every call runs the
    plain modules."""
    calls = []
    _open_kernel_gates(monkeypatch, calls)
    g = torch.Generator().manual_seed(2)
    model = PiT(**SMALL, fused_attention=mode, fused_mlp=mode, device="cpu", generator=g)
    plain = PiT(**SMALL, fused_attention="never", fused_mlp="never", device="cpu")
    plain.load_state_dict(model.state_dict())
    img = torch.randn(2, 64, 64, 3, generator=g)
    with torch.no_grad():
        got, want = model.eval()(img), plain.eval()(img)
    _check_calls(calls, "kernels" if mode == "auto" else "never")
    assert _maxdiff(got, want) <= TOL
    dropped = PiT(**SMALL, dropout=0.1, device="cpu").train()
    calls.clear()
    with torch.no_grad():
        dropped(img)
    assert calls == []
