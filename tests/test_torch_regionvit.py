"""RegionViT in the port against ``vit_tpu`` in f32 on the CPU, on the same
weights converted from Flax (every parameter drawn with numpy from a seed).

The config is ``tests/unit/test_windowed_fused.py``'s tiny one (dims 32, 48,
64, 96, depth 1 each, window 4, local patch 4, 4 heads of 32) on 128 x 128
images, batch 2: the region self-attentions hold 64, 16, 4 and 1 tokens an
image, the joint attentions 17 (a region token and its 4 x 4 window) over 128,
32, 8 and 2 windows.  Two variants, the default stem and
``tokenize_local_3_conv=True, use_peg=True``, each on two routes:

- ``never``: ``fused_attention="never"`` on both sides;
- ``kernels``: the port's kernel route with the 16-bit CUDA gate opened on
  the CPU (``kernel_activation`` patched in ``vit_tpu_torch.layers.common``),
  where each op runs its plain version, against ``vit_tpu``'s
  ``fused_attention="interpret"`` (its Pallas kernels in interpret mode,
  which it takes at stage 1's 128 windows only: it declines fewer than 128
  groups).  The calls into the ops are counted: 4 fused attention blocks
  (the region self-attentions) and 4 biased ones (the joint attentions) a
  forward, the port having no ``G < 128`` decline.

Eval logits, and one SGD step of ``make_train_step`` against ``vit_tpu``'s
``make_train_step`` (its inner step, jitted): the loss, every parameter's
gradient (the ``local_rel_pos_bias`` tables' and the attentions' shared by
both calls of a layer included) and the updated parameters, within 1e-4,
the port's bar against ``vit_tpu``.  Then the converter leaf for leaf, the
position index and its zero pad against ``vit_tpu``'s arithmetic, the folds
against its einops patterns, windows narrower than the window size (64
px), the gates, the divisibility checks, a fold cut into launches of at most
``MAX_WINDOW_GROUPS`` groups, an index made while serving, and the short
route's plain backward over one key.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from einops import rearrange  # noqa: E402

from vit_tpu.models import regionvit as jax_rv  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import RegionViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.models import regionvit  # noqa: E402
from vit_tpu_torch.ops import fused_attention_block as fab  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

TOL = 1e-4
SMALL = dict(dim=(32, 48, 64, 96), depth=(1, 1, 1, 1), window_size=4, local_patch_size=4,
             num_classes=8)
VARIANTS = {"default": {}, "3conv_peg": dict(tokenize_local_3_conv=True, use_peg=True)}
SIZE = 128
LR = 0.1
ROUTES = {"never": "never", "kernels": "interpret"}
PER_FORWARD = {"fused_attention_block": 4, "fused_attention_block_bias": 4}
CASES = [(v, r) for v in VARIANTS for r in ROUTES]


def _maxdiff(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _random_variables(model, img, rng):
    """Flax variables of ``model`` on the shapes its init gives (traced, not
    run), every leaf drawn from ``rng``: the norms' scales around 1, their
    shifts and the biases around 0, the kernels scaled by their fan-in, the
    position tables at unit scale."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a), jnp.asarray(img))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name == "bias":
            return (0.1 * draw).astype(np.float32)
        if name == "embedding":
            return draw.astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_runs():
    """Per variant and route: the Flax model's eval logits and one SGD step
    (loss, gradient, updated parameters), on one set of variables a
    variant."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.array([3, 5], np.int32)
    out = dict(img=img, labels=labels, variables={}, runs={})
    for variant, extra in VARIANTS.items():
        v = _random_variables(jax_rv.RegionViT(**SMALL, **extra, fused_attention="never"), img,
                              rng)
        out["variables"][variant] = v
        for route, mode in ROUTES.items():
            model = jax_rv.RegionViT(**SMALL, **extra, fused_attention=mode)
            tx = optax.sgd(LR)
            step, _ = jax_train.make_train_step(
                lambda p, images, rng_key, m=model: m.apply({"params": p}, images,
                                                            training=True), tx, mesh=None)
            state = jax_train.create_train_state(v["params"], tx)
            new_state, metrics = jax.jit(step)(state, jnp.asarray(img), jnp.asarray(labels),
                                               jax.random.PRNGKey(1))
            grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR,
                                 v["params"], new_state.params)
            out["runs"][variant, route] = dict(
                logits=np.asarray(jax.jit(model.apply)(v, jnp.asarray(img))),
                loss=float(metrics["loss"]), grads=state_dict_from_flax(grads),
                updated=state_dict_from_flax(jax.tree.map(np.asarray, new_state.params)))
    return out


def _open_kernel_gates(monkeypatch, calls):
    """Let the f32 CPU tensors through the kernel gate, and count the calls
    into the ops (which then run their plain versions)."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    for name in PER_FORWARD:
        monkeypatch.setattr(regionvit, name, lambda *a, f=getattr(regionvit, name), name=name:
                            calls.append(name) or f(*a))


def _port(variables, variant, route, monkeypatch, calls):
    if route == "kernels":
        _open_kernel_gates(monkeypatch, calls)
    model = RegionViT(**SMALL, **VARIANTS[variant], device="cpu",
                      **({} if route == "kernels" else dict(fused_attention="never")))
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def _counts(calls):
    return {n: calls.count(n) for n in set(calls)}


@pytest.mark.parametrize("variant,route", CASES)
def test_eval_logits_match_jax(jax_runs, monkeypatch, variant, route):
    calls = []
    model = _port(jax_runs["variables"][variant], variant, route, monkeypatch, calls).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(jax_runs["img"]))
    assert _counts(calls) == (PER_FORWARD if route == "kernels" else {})
    assert _maxdiff(logits, jax_runs["runs"][variant, route]["logits"]) <= TOL


@pytest.mark.parametrize("variant,route", CASES)
def test_train_step_matches_jax(jax_runs, monkeypatch, variant, route):
    """One SGD step: the loss, every parameter's gradient (each attention's
    the sum of its region and joint calls; the position tables' through the
    joint attentions' dbias on the kernel route) and the updated
    parameters."""
    calls = []
    model = _port(jax_runs["variables"][variant], variant, route, monkeypatch, calls)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = float(step(torch.from_numpy(jax_runs["img"]),
                      torch.from_numpy(jax_runs["labels"]).long())["loss"])
    want = jax_runs["runs"][variant, route]
    assert _counts(calls) == (PER_FORWARD if route == "kernels" else {})
    assert abs(loss - want["loss"]) <= TOL
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want["grads"])
    # The tables get a gradient through the local tokens' joint rows (the
    # region token's row and column are the zero pad); those of the last
    # layer feed nothing, as the head reads the region tokens only, so the
    # table of stage 4 (one layer here) gets none, in vit_tpu too.
    tables = sorted(k for k in grads if "local_rel_pos_bias" in k)
    assert len(tables) == 4 and all(float(grads[k].abs().max()) > 0 for k in tables[:3])
    assert not torch.any(grads[tables[3]]) and not torch.any(want["grads"][tables[3]])
    diffs = {k: _maxdiff(grads[k], want["grads"][k]) for k in grads}
    assert max(diffs.values()) <= TOL, diffs
    state = model.state_dict()
    diffs = {k: _maxdiff(state[k], w) for k, w in want["updated"].items()}
    assert max(diffs.values()) <= TOL, diffs


@pytest.mark.parametrize("variant", VARIANTS)
def test_converter_carries_the_regionvit_tree(jax_runs, variant):
    """Leaf for leaf: the convolutions' HWIO kernels → OIHW (the depthwise
    PEG's (3, 3, 1, C) too), the Dense kernels (in, out) → (out, in),
    ``to_out`` as ``to_out.0``, the LayerNorms' scale → weight and the
    position table's ``embedding`` → ``weight``; loaded strictly."""
    v = jax_runs["variables"][variant]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    model = RegionViT(**SMALL, **VARIANTS[variant], device="cpu")
    state = model.state_dict()
    converted = state_dict_from_flax(v)
    assert set(converted) == set(state) and len(state) == len(flat)
    model.load_state_dict(converted, strict=True)
    hwio, dense = (3, 2, 0, 1), (1, 0)
    names = {
        "params/region_encoder/kernel": ("region_encoder.weight", hwio),
        "params/downsample_2/kernel": ("downsample_2.weight", hwio),
        "params/transformer_0/attn_0/norm/scale": ("transformer_0.attn_0.norm.weight", None),
        "params/transformer_1/attn_0/to_qkv/kernel": ("transformer_1.attn_0.to_qkv.weight",
                                                      dense),
        "params/transformer_2/attn_0/to_out/kernel": ("transformer_2.attn_0.to_out.0.weight",
                                                      dense),
        "params/transformer_2/attn_0/to_out/bias": ("transformer_2.attn_0.to_out.0.bias", None),
        "params/transformer_3/ff_0/norm/bias": ("transformer_3.ff_0.norm.bias", None),
        "params/transformer_0/ff_0/fc1/kernel": ("transformer_0.ff_0.fc1.weight", dense),
        "params/transformer_1/ff_0/fc2/bias": ("transformer_1.ff_0.fc2.bias", None),
        "params/transformer_3/local_rel_pos_bias/embedding":
            ("transformer_3.local_rel_pos_bias.weight", None),
        "params/head_norm/scale": ("head_norm.weight", None),
        "params/head/kernel": ("head.weight", dense),
    }
    if variant == "default":
        names["params/local_encoder/kernel"] = ("local_encoder.weight", hwio)
    else:
        names.update({"params/local_conv1/kernel": ("local_conv1.weight", hwio),
                      "params/local_norm0/scale": ("local_norm0.weight", None),
                      "params/peg_3/kernel": ("peg_3.weight", hwio)})
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path]
        got = converted[key].numpy()
        assert got.shape == state[key].shape and np.array_equal(got, want), path
    assert converted["region_encoder.weight"].shape == (32, 3 * 16 * 16, 1, 1)
    assert converted["transformer_0.local_rel_pos_bias.weight"].shape == (49, 4)


@pytest.mark.parametrize("w,wh,ww", [(4, 4, 4), (7, 7, 7), (3, 3, 2), (2, 1, 1)])
def test_position_bias_is_vit_tpu_arithmetic(w, wh, ww):
    """The index ``rel · (1, 2w − 1)`` over the ``ij`` grid of a wh x ww
    window and the table gathered, transposed to heads first and zero-padded
    for the region slot, as ``vit_tpu/models/regionvit.py:143-156`` computes
    them."""
    gx, gy = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    grid = np.stack([gx, gy]).reshape(2, -1)
    rel = (grid[:, :, None] - grid[:, None, :]) + (w - 1)
    index = (rel * np.array([1, w * 2 - 1])[:, None, None]).sum(0)
    got = regionvit.relative_position_index(wh, ww, w, torch.device("cpu"))
    assert np.array_equal(got.numpy(), index)
    assert 0 <= index.min() and index.max() < (2 * w - 1) ** 2

    layer = regionvit.R2LTransformer(16, w, depth=0, heads=4, device="cpu")
    table = np.random.default_rng(w).standard_normal(((2 * w - 1) ** 2, 4)).astype(np.float32)
    with torch.no_grad():
        layer.local_rel_pos_bias.weight.copy_(torch.from_numpy(table))
    want = np.pad(rearrange(table[index], "i j h -> h i j"), ((0, 0), (1, 0), (1, 0)))
    bias = layer.position_bias(wh, ww)
    assert bias.dtype == torch.float32 and bias.is_contiguous()
    assert np.array_equal(bias.detach().numpy(), want)


@pytest.mark.parametrize("wh,ww", [(4, 4), (2, 4)])
def test_folds_are_vit_tpu_rearranges(wh, ww):
    """The joint rows ``[region token | (p1 p2) local tokens]`` over ``(b h
    w)``, built as ``vit_tpu``'s einops patterns build them, and the split
    back to the two maps."""
    b, rh, rw, c = 2, 2, 3, 5
    local = torch.randn(b, rh * wh, rw * ww, c)
    region = torch.randn(b, rh, rw, c)
    layer = regionvit.R2LTransformer(c, 4, depth=0, heads=1, device="cpu")
    lt = rearrange(local.numpy(), "b (h p1) (w p2) d -> (b h w) (p1 p2) d", p1=wh, p2=ww)
    rt = rearrange(region.numpy(), "b h w d -> (b h w) () d")
    joint = np.concatenate([rt, lt], axis=1)
    folded = torch.cat([region.reshape(-1, 1, c), regionvit._windows(local, wh, ww)], dim=1)
    assert torch.equal(folded, torch.from_numpy(joint))
    new_local, new_region = layer(local, region)
    want_local = rearrange(joint[:, 1:], "(b h w) (p1 p2) d -> b (h p1 w p2) d", h=rh, w=rw,
                           p1=wh)
    assert torch.equal(new_local.reshape(b, -1, c), torch.from_numpy(want_local))
    assert torch.equal(new_region, region)


def test_gates_send_dropout_and_never_to_the_plain_modules(monkeypatch):
    """A fold of two groups goes to the kernel (no ``G < 128`` decline),
    with and without a bias; active attention dropout in training and
    ``"never"`` take the plain modules; every case gives ``x + attn(x,
    bias)``."""
    calls = []
    _open_kernel_gates(monkeypatch, calls)
    x = torch.randn(2, 17, 64)
    bias = torch.randn(4, 17, 17)
    for b, dropout, train, mode, fused in (
            (None, 0.0, False, "auto", "fused_attention_block"),
            (bias, 0.0, True, "auto", "fused_attention_block_bias"),
            (bias, 0.1, False, "auto", "fused_attention_block_bias"),
            (bias, 0.1, True, "auto", None), (None, 0.1, True, "auto", None),
            (bias, 0.0, False, "never", None)):
        attn = regionvit.RegionAttention(64, dropout=dropout, device="cpu").train(train)
        before = len(calls)
        with torch.no_grad():
            y = regionvit.region_attention_residual(x, attn, mode, b)
            assert _maxdiff(y, x + attn(x, b)) <= 1e-5
        assert calls[before:] == ([fused] if fused else []), (b is None, dropout, train, mode)


def test_windows_narrower_than_the_window_size_match_jax(jax_runs):
    """At 64 px the region maps are 4², 2², 1 and 1 and the local ones 16²,
    8², 4² and 2²: stage 4's windows hold 2 x 2 tokens, fewer than the
    window size 4 that sizes the table and the index, and stage 4's region
    map is 1 x 1 after a SAME stride-2 convolution of a 1 x 1 map.  Eval
    logits on the plain path against ``vit_tpu``'s on the default variant's
    weights."""
    v = jax_runs["variables"]["default"]
    img = jax_runs["img"][:, :64, :64]
    want = jax.jit(jax_rv.RegionViT(**SMALL, fused_attention="never").apply)(v, img)
    model = RegionViT(**SMALL, fused_attention="never", device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(np.ascontiguousarray(img)))
    assert _maxdiff(got, want) <= TOL


def test_fold_is_cut_into_launches(jax_runs, monkeypatch):
    """With at most 3 groups a launch, the joint folds of 128, 32, 8 and 2
    windows take 43, 11, 3 and 1 calls, the region self-attentions of 2
    images one each; the logits are those of whole folds."""
    img = torch.from_numpy(jax_runs["img"])
    v = jax_runs["variables"]["default"]
    with torch.no_grad():
        whole = _port(v, "default", "kernels", monkeypatch, []).eval()(img)
        monkeypatch.setattr(regionvit, "MAX_WINDOW_GROUPS", 3)
        calls = []
        cut = _port(v, "default", "kernels", monkeypatch, calls).eval()(img)
    assert _counts(calls) == {"fused_attention_block": 4,
                              "fused_attention_block_bias": 43 + 11 + 3 + 1}
    assert _maxdiff(cut, whole) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_route_backward_over_one_key_gives_zero_dq_dk(dtype):
    """Stage 4's region self-attention (one token an image): the short
    route's plain backward, fed its training forward's residuals, gives dq =
    dk = 0 exactly, as the TPU kernel's softmax over one key (p = 1, dsum =
    dp) does and as the plain version at the TPU kernel's rounding points
    does; dv is the row's dO.  From p = exp(s·scale − lse) and D =
    rowsum(dO∘O) they would be 1 and dp only to rounding."""
    g = torch.Generator().manual_seed(5)
    b, n, d, heads, dim_head = 6, 1, 64, 4, 32
    inner = heads * dim_head

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)

    x, dy = rn(b, n, d), rn(b, n, d, scale=0.1)
    gamma, beta = (1.0 + rn(d, scale=0.1).float()).to(dtype), rn(d, scale=0.1)
    wqkv, wo, bo = rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5), \
        rn(d, scale=0.1)
    _, _, qkv, oattn, lse = fab.fused_attention_block_short_forward_reference(
        x, gamma, beta, wqkv, wo, bo, heads, dim_head, eps=1e-3)
    short = fab.fused_attention_block_lse_backward_reference(
        dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dim_head, eps=1e-3)
    tpu = fab.fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads,
                                                       dim_head, eps=1e-3)
    doattn = (dy.reshape(-1, d).float() @ wo.float()).to(dtype).reshape(b, n, inner)
    for dx, dqkv, *_ in (short, tpu):
        assert torch.count_nonzero(dqkv[..., :2 * inner]) == 0
        assert torch.equal(dqkv[..., 2 * inner:], doattn)
    assert torch.equal(short[1], tpu[1])


def test_divisibility_and_stage_counts_raise():
    """Images the region patch (local patch x window) does not divide, and
    dims or depths not given for 4 stages, raise as ``vit_tpu``'s asserts."""
    model = RegionViT(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="divisible by region patch size"):
        model(torch.zeros(1, 120, 120, 3))
    with pytest.raises(ValueError, match="dim needs to be"):
        RegionViT(**dict(SMALL, dim=(32, 48, 64)), device="cpu")
    with pytest.raises(ValueError, match="depth needs to be"):
        RegionViT(**dict(SMALL, depth=(1, 1)), device="cpu")
    with pytest.raises(ValueError, match="TPU-only"):
        RegionViT(**SMALL, fused_attention="interpret", device="cpu")


def test_an_index_made_while_serving_serves_training():
    """The position index is cached a shape and device; one made under
    inference mode (a serving call first) must serve a train step after it."""
    regionvit.relative_position_index.cache_clear()
    model = RegionViT(**SMALL, device="cpu")
    img = torch.zeros(1, SIZE, SIZE, 3)
    with torch.inference_mode():
        model.eval()(img)
    step = make_train_step(model.train(), torch.optim.SGD(model.parameters(), lr=LR))
    assert np.isfinite(float(step(img, torch.tensor([1]))["loss"]))
