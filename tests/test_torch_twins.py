"""Twins-SVT in the port against ``vit_tpu`` in f32 on the CPU, on the same
weights converted from Flax (every parameter drawn with numpy from a seed).

The config is ``tests/unit/test_twins_fused.py``'s tiny one (stage widths
32/48/64/80, patch sizes 4/2/1/1, depth 1 each, 8 heads of 64, 7 x 7 local
windows, global k 7) on 56 x 56 images, batch 2: stage 1 folds 2 x 2
windows an image and reduces its 14 x 14 map to 4 keys, stages 2-4 take one
window and one key.  Two routes:

- ``never``: ``fused_attention="never", fused_mlp="never"`` on both sides;
- ``kernels``: the port's kernel routes with the 16-bit CUDA gates opened on
  the CPU (``kernel_activation`` patched in ``vit_tpu_torch.layers.common``
  and ``vit_tpu_torch.models.twins_svt``), where each op runs its plain
  version, against ``vit_tpu``'s ``fused_attention="interpret",
  fused_mlp="interpret"`` (its Pallas kernels in interpret mode).  The calls
  into the ops are counted: 6 fused attention blocks (the local windows of
  stages 1-3), 8 cross-attention blocks (every global attention, stage 4's
  one key included) and 14 fused MLPs per forward.

Eval logits, and one SGD step of ``make_train_step`` against ``vit_tpu``'s
``make_train_step`` (its inner step, jitted): the loss, every parameter's
gradient and the updated parameters, within 1e-4, the port's bar against
``vit_tpu``.  Then the converter leaf for leaf, the window rule (a map 7
does not divide raises), the global gate declining a map that k does not
divide (the plain modules, ceil(14 / 4) = 4 keys a side from the SAME-padded
convolution, within 1e-4 of ``vit_tpu``), and a fold cut into launches of at
most ``MAX_WINDOW_GROUPS`` groups.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vit_tpu.models import twins_svt as jax_twins  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import TwinsSVT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.models import twins_svt  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402
from vit_tpu_torch.tokenizers import PatchEmbedding  # noqa: E402

TOL = 1e-4
SMALL = dict(num_classes=11,
             s1_emb_dim=32, s1_patch_size=4, s1_local_patch_size=7, s1_global_k=7, s1_depth=1,
             s2_emb_dim=48, s2_patch_size=2, s2_local_patch_size=7, s2_global_k=7, s2_depth=1,
             s3_emb_dim=64, s3_patch_size=1, s3_local_patch_size=7, s3_global_k=7, s3_depth=1,
             s4_emb_dim=80, s4_patch_size=1, s4_global_k=7, s4_depth=1)
SIZE = 56
LR = 0.1
ROUTES = {"never": dict(fused_attention="never", fused_mlp="never"),
          "kernels": dict(fused_attention="interpret", fused_mlp="interpret")}
PER_FORWARD = {"fused_attention_block": 6, "fused_cross_attention": 8, "fused_mlp": 14}


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
        if name == "g":
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name in ("b", "bias"):
            return (0.1 * draw).astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_logits(config, route, variables, img):
    return np.asarray(jax.jit(jax_twins.TwinsSVT(**config, **ROUTES[route]).apply)(
        variables, jnp.asarray(img)))


@pytest.fixture(scope="module")
def jax_runs():
    """Per route: the Flax model's eval logits and one SGD step (loss,
    gradient, updated parameters), on one set of variables."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.array([3, 7], np.int32)
    v = _random_variables(jax_twins.TwinsSVT(**SMALL, **ROUTES["never"]), img, rng)
    runs = {}
    for route, kw in ROUTES.items():
        model = jax_twins.TwinsSVT(**SMALL, **kw)
        tx = optax.sgd(LR)
        step, _ = jax_train.make_train_step(
            lambda p, images, rng_key, m=model: m.apply({"params": p}, images, training=True),
            tx, mesh=None)
        state = jax_train.create_train_state(v["params"], tx)
        new_state, metrics = jax.jit(step)(state, jnp.asarray(img), jnp.asarray(labels),
                                           jax.random.PRNGKey(1))
        grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR, v["params"],
                             new_state.params)
        runs[route] = dict(logits=_jax_logits(SMALL, route, v, img), loss=float(metrics["loss"]),
                           grads=state_dict_from_flax(grads),
                           updated=state_dict_from_flax(jax.tree.map(np.asarray,
                                                                     new_state.params)))
    return dict(variables=v, img=img, labels=labels, runs=runs)


def _open_kernel_gates(monkeypatch, calls):
    """Let the f32 CPU tensors through every kernel gate, and count the calls
    into the ops (which then run their plain versions)."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    monkeypatch.setattr(twins_svt, "kernel_activation", lambda x: True)
    for module, name in ((twins_svt, "fused_attention_block"),
                         (twins_svt, "fused_cross_attention"), (common, "fused_mlp")):
        monkeypatch.setattr(module, name, lambda *a, f=getattr(module, name), name=name:
                            calls.append(name) or f(*a))


def _port(variables, route, monkeypatch, calls, config=SMALL):
    if route == "kernels":
        _open_kernel_gates(monkeypatch, calls)
    model = TwinsSVT(**config, device="cpu", **({} if route == "kernels" else ROUTES["never"]))
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
    """One SGD step: the loss, every parameter's gradient (through the
    strided k/v convolutions, the PEGs and the space-to-depth embeddings
    included) and the updated parameters."""
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
    diffs = {k: _maxdiff(grads[k], want["grads"][k]) for k in grads}
    assert max(diffs.values()) <= TOL, diffs
    state = model.state_dict()
    diffs = {k: _maxdiff(state[k], w) for k, w in want["updated"].items()}
    assert max(diffs.values()) <= TOL, diffs


def test_converter_carries_the_twins_tree(jax_runs):
    """Leaf for leaf: the space-to-depth projections, the stacks' layers
    (stage 4's without the local pair), the strided k/v kernels (k, k, in,
    out) → OIHW, the depthwise PEG (3, 3, 1, C) → (C, 1, 3, 3), the
    ChannelLayerNorms' g/b and the head."""
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    state = TwinsSVT(**SMALL, device="cpu").state_dict()
    converted = state_dict_from_flax(v)
    assert set(converted) == set(state) and len(state) == len(flat)
    hwio = (3, 2, 0, 1)
    names = {
        "params/s1_embed/proj/kernel": ("s1_embed.proj.weight", hwio),
        "params/s1_pre_transformer/local_attn_0/to_kv/kernel": (
            "s1_pre_transformer.layers.0.local_attn.to_kv.weight", hwio),
        "params/s2_transformer/global_attn_0/to_kv/kernel": (
            "s2_transformer.layers.0.global_attn.to_kv.weight", hwio),
        "params/s3_transformer/local_attn_0/to_out/bias": (
            "s3_transformer.layers.0.local_attn.to_out.0.bias", None),
        "params/s4_pre_transformer/ff2_0/fc1/kernel": (
            "s4_pre_transformer.layers.0.ff2.fc1.weight", hwio),
        "params/s1_peg/proj/kernel": ("s1_peg.proj.weight", hwio),
        "params/s2_pre_transformer/global_norm_0/g": (
            "s2_pre_transformer.layers.0.global_norm.g", None),
        "params/s3_transformer/ff1_norm_0/b": ("s3_transformer.layers.0.ff1_norm.b", None),
        "params/head/kernel": ("head.weight", (1, 0)),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path].reshape(state[key].shape)
        got = converted[key].numpy()
        assert got.shape == state[key].shape and np.array_equal(got, want), path
    assert converted["s1_transformer.layers.0.global_attn.to_kv.weight"].shape == (1024, 32, 7, 7)
    assert converted["s1_embed.proj.weight"].shape == (32, 48, 1, 1)
    assert not any(k.startswith("s4_transformer.layers.0.local") for k in converted)


def test_patch_embedding_keeps_the_c_p1_p2_order():
    """The space-to-depth channels in ``(c p1 p2)`` order, as ``vit_tpu``'s
    einops pattern gives them (not PyTorch's usual ``(p1 p2 c)``)."""
    embed = PatchEmbedding(3, 5, 2, device="cpu")
    with torch.no_grad():
        embed.proj.weight.copy_(torch.eye(5, 12)[:, :, None, None])
        embed.proj.bias.zero_()
    img = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)
    out = embed(img)
    # channel c of pixel (p1, p2) of the top-left patch at c·4 + p1·2 + p2
    want = torch.stack([img[0, p1, p2, c] for c in range(3) for p1 in range(2)
                        for p2 in range(2)])[:5]
    assert out.shape == (2, 2, 2, 5) and torch.equal(out[0, 0, 0], want)


@pytest.mark.parametrize("route", ROUTES)
def test_a_map_the_window_does_not_divide_raises(monkeypatch, route):
    """48 px: stage 1's 12 x 12 map in 7 x 7 windows, which ``vit_tpu``'s
    einops fold refuses; the port raises on both routes."""
    if route == "kernels":
        _open_kernel_gates(monkeypatch, [])
    model = TwinsSVT(**SMALL, device="cpu", **({} if route == "kernels" else ROUTES["never"]))
    with pytest.raises(ValueError, match="local window size 7"):
        model(torch.zeros(1, 48, 48, 3))


def test_global_gate_declines_a_map_k_does_not_divide(monkeypatch):
    """``s1_global_k=4`` on stage 1's 14 x 14 map: the kernel route's gate
    sends that attention to the plain modules (the SAME-padded 4 x 4 stride-4
    convolution gives 4 x 4 keys), the seven others to the cross-attention
    block; the logits within 1e-4 of ``vit_tpu``'s, whose gate declines it
    too."""
    config = dict(SMALL, s1_global_k=4)
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    v = _random_variables(jax_twins.TwinsSVT(**config, **ROUTES["never"]), img, rng)
    assert v["params"]["s1_transformer"]["global_attn_0"]["to_kv"]["kernel"].shape[:2] == (4, 4)
    calls = []
    model = _port(v, "kernels", monkeypatch, calls, config).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(img))
    assert _counts(calls) == dict(PER_FORWARD, fused_cross_attention=6)
    assert _maxdiff(logits, _jax_logits(config, "kernels", v, img)) <= TOL


def test_local_fold_is_cut_into_launches(jax_runs, monkeypatch):
    """With at most 3 window groups a launch, stage 1's fold of 8 groups (2
    images of 2 x 2 windows) takes three calls of the fused attention block,
    whose outputs join to those of the whole fold."""
    img = torch.from_numpy(jax_runs["img"])
    with torch.no_grad():
        whole = _port(jax_runs["variables"], "kernels", monkeypatch, []).eval()(img)
        monkeypatch.setattr(twins_svt, "MAX_WINDOW_GROUPS", 3)
        calls = []
        cut = _port(jax_runs["variables"], "kernels", monkeypatch, calls).eval()(img)
    assert _counts(calls)["fused_attention_block"] == PER_FORWARD["fused_attention_block"] + 2 * 2
    assert _maxdiff(cut, whole) <= 1e-6


def test_routes_agree_in_the_port(jax_runs, monkeypatch):
    """The kernel route's plain versions against the plain modules, in the
    port alone, on the converted weights."""
    img = torch.from_numpy(jax_runs["img"])
    with torch.no_grad():
        never = _port(jax_runs["variables"], "never", monkeypatch, []).eval()(img)
        kernels = _port(jax_runs["variables"], "kernels", monkeypatch, []).eval()(img)
    assert _maxdiff(kernels, never) <= TOL


def test_dropout_and_never_take_the_plain_modules(monkeypatch):
    """Active dropout in training and ``"never"`` keep both attentions off
    the kernels, as ``vit_tpu``'s gates."""
    calls = []
    _open_kernel_gates(monkeypatch, calls)
    x = torch.randn(1, 14, 14, 32)
    norm = common.ChannelLayerNorm(32, device="cpu")
    local = twins_svt.LocalAttention(32, 2, 32, device="cpu")
    glob = twins_svt.GlobalAttention(32, 2, 32, device="cpu")
    twins_svt.local_attention_residual(x, norm, local)
    twins_svt.global_attention_residual(x, norm, glob)
    assert calls == ["fused_attention_block", "fused_cross_attention"]
    for attn, run in ((twins_svt.LocalAttention(32, 2, 32, 0.1, device="cpu").train(),
                       twins_svt.local_attention_residual),
                      (twins_svt.GlobalAttention(32, 2, 32, 0.1, device="cpu").train(),
                       twins_svt.global_attention_residual)):
        run(x, norm, attn)
    twins_svt.local_attention_residual(x, norm, local, "never")
    twins_svt.global_attention_residual(x, norm, glob, "never")
    assert len(calls) == 2


def test_constructor_refuses_tpu_only_modes():
    with pytest.raises(ValueError, match="TPU-only"):
        TwinsSVT(**SMALL, fused_attention="interpret", device="cpu")
    with pytest.raises(ValueError, match="TPU-only"):
        TwinsSVT(**SMALL, fused_mlp="interpret", device="cpu")
