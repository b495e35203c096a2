"""ScalableViT in the port against ``vit_tpu`` in f32 on the CPU, on the same
weights converted from Flax (every parameter drawn with numpy from a seed).

The config (64 px, dim 32, depths 1/1, heads 2/2, reduction factors 4/2,
windows 8/None, SSA keys 40 and values 32 wide) has a stage-1 window that
splits the 16x16 map into four windows of 64 tokens, SSA widths with a
k-step padding (40), and k/v reductions at both stages.  Two routes:

- ``never``: ``fused_attention="never", fused_mlp="never"`` on both sides;
- ``kernels``: the port's kernel routes with the 16-bit CUDA gates opened on
  the CPU (``kernel_activation`` and ``flash_tensor`` patched, ``FLASH_MIN_SEQ``
  at 64, so that every IWSA window takes the packed flash op), where each op
  runs its plain version, against ``vit_tpu``'s ``fused_attention="interpret",
  fused_mlp="interpret"`` (its Pallas kernels in interpret mode).  The calls
  into the ops are counted: 2 cross-attention blocks, 2 packed flash calls and
  4 fused MLPs per forward.

Eval logits, and one SGD step of ``make_train_step`` against ``vit_tpu``'s
``make_train_step`` (its inner step, jitted): the loss, every parameter's
gradient and the updated parameters, within 1e-4, the port's bar against
``vit_tpu``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vit_tpu.models import scalable_vit as jax_svit  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import ScalableViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.models import scalable_vit  # noqa: E402
from vit_tpu_torch.ops import attention  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

TOL = 1e-4
SMALL = dict(num_classes=10, dim=32, depth=(1, 1), heads=(2, 2), reduction_factor=(4, 2),
             window_size=(8, None), ssa_dim_key=(40, 40), ssa_dim_value=(32, 32))
SIZE = 64
LR = 0.1
ROUTES = {"never": dict(fused_attention="never", fused_mlp="never"),
          "kernels": dict(fused_attention="interpret", fused_mlp="interpret")}


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
    labels = np.array([3, 7], np.int32)
    v = _random_variables(jax_svit.ScalableViT(**SMALL, **ROUTES["never"]), img, rng)
    runs = {}
    for route, kw in ROUTES.items():
        model = jax_svit.ScalableViT(**SMALL, **kw)
        logits = jax.jit(model.apply)(v, jnp.asarray(img))
        tx = optax.sgd(LR)
        step, _ = jax_train.make_train_step(
            lambda p, images, rng_key, m=model: m.apply({"params": p}, images, training=True),
            tx, mesh=None)
        state = jax_train.create_train_state(v["params"], tx)
        new_state, metrics = jax.jit(step)(state, jnp.asarray(img), jnp.asarray(labels),
                                           jax.random.PRNGKey(1))
        grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR, v["params"],
                             new_state.params)
        runs[route] = dict(logits=np.asarray(logits), loss=float(metrics["loss"]),
                           grads=state_dict_from_flax(grads),
                           updated=state_dict_from_flax(jax.tree.map(np.asarray,
                                                                     new_state.params)))
    return dict(variables=v, img=img, labels=labels, runs=runs)


def _open_kernel_gates(monkeypatch, calls):
    """Let the f32 CPU tensors through every kernel gate, and count the calls
    into the ops (which then run their plain versions)."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    monkeypatch.setattr(scalable_vit, "kernel_activation", lambda x: True)
    monkeypatch.setattr(attention, "flash_tensor", lambda t: True)
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 64)
    for module, name in ((scalable_vit, "fused_cross_attention"),
                         (attention, "flash_attention_packed"), (common, "fused_mlp")):
        monkeypatch.setattr(module, name, lambda *a, f=getattr(module, name), name=name:
                            calls.append(name) or f(*a))


def _port(runs, route, monkeypatch, calls):
    if route == "kernels":
        _open_kernel_gates(monkeypatch, calls)
    model = ScalableViT(**SMALL, device="cpu",
                        **({} if route == "kernels" else ROUTES["never"]))
    model.load_state_dict(state_dict_from_flax(runs["variables"]), strict=True)
    return model


PER_FORWARD = {"fused_cross_attention": 2, "flash_attention_packed": 2, "fused_mlp": 4}


@pytest.mark.parametrize("route", ROUTES)
def test_eval_logits_match_jax(jax_runs, monkeypatch, route):
    calls = []
    model = _port(jax_runs, route, monkeypatch, calls).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(jax_runs["img"]))
    want = PER_FORWARD if route == "kernels" else {}
    assert {n: calls.count(n) for n in set(calls)} == want
    assert _maxdiff(logits, jax_runs["runs"][route]["logits"]) <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_matches_jax(jax_runs, monkeypatch, route):
    """One SGD step: the loss, every parameter's gradient (a gradient through
    the SSA's strided k/v convolutions, the local interactive module and the
    PEG included) and the updated parameters."""
    calls = []
    model = _port(jax_runs, route, monkeypatch, calls)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = float(step(torch.from_numpy(jax_runs["img"]),
                      torch.from_numpy(jax_runs["labels"]).long())["loss"])
    want = jax_runs["runs"][route]
    assert len(calls) == (8 if route == "kernels" else 0)
    assert abs(loss - want["loss"]) <= TOL
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want["grads"])
    diffs = {k: _maxdiff(grads[k], want["grads"][k]) for k in grads}
    assert max(diffs.values()) <= TOL, diffs
    state = model.state_dict()
    diffs = {k: _maxdiff(state[k], w) for k, w in want["updated"].items()}
    assert max(diffs.values()) <= TOL, diffs


def test_the_routes_agree_in_the_port(jax_runs, monkeypatch):
    """The kernel route's plain versions against the plain modules, in the
    port alone, on the converted weights."""
    img = torch.from_numpy(jax_runs["img"])
    with torch.no_grad():
        never = _port(jax_runs, "never", monkeypatch, []).eval()(img)
        kernels = _port(jax_runs, "kernels", monkeypatch, []).eval()(img)
    assert _maxdiff(kernels, never) <= TOL


def test_converter_carries_the_scalable_vit_tree(jax_runs):
    """Leaf for leaf: the per-stage layers, the SSA's strided k/v kernels
    (r, r, in, out) → OIHW, the depthwise PEG (3, 3, 1, C) → (C, 1, 3, 3), the
    ChannelLayerNorms' g/b, the downsampling convolution and the head."""
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    state = ScalableViT(**SMALL, device="cpu").state_dict()
    converted = state_dict_from_flax(v)
    assert set(converted) == set(state) and len(state) == len(flat)
    hwio = (3, 2, 0, 1)
    names = {
        "params/to_patches/kernel": ("to_patches.weight", hwio),
        "params/stage_0/ssa_0/to_k/kernel": ("stage_0.layers.0.ssa.to_k.weight", hwio),
        "params/stage_1/ssa_0/to_out/bias": ("stage_1.layers.0.ssa.to_out.0.bias", None),
        "params/stage_0/iwsa_0/local_interactive_module/kernel": (
            "stage_0.layers.0.iwsa.local_interactive_module.weight", hwio),
        "params/stage_1/peg/kernel": ("stage_1.peg.weight", hwio),
        "params/stage_0/ff2_0/fc1/kernel": ("stage_0.layers.0.ff2.fc1.weight", hwio),
        "params/stage_1/iwsa_norm_0/g": ("stage_1.layers.0.iwsa_norm.g", None),
        "params/stage_0/norm/b": ("stage_0.norm.b", None),
        "params/downsample_0/kernel": ("downsample_0.weight", hwio),
        "params/head_norm/scale": ("head_norm.weight", None),
        "params/head/kernel": ("head.weight", (1, 0)),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path].reshape(state[key].shape)
        got = converted[key].numpy()
        assert got.shape == state[key].shape and np.array_equal(got, want), path
    assert converted["stage_0.layers.0.ssa.to_k.weight"].shape == (80, 32, 4, 4)


def test_ssa_gate_needs_a_map_divisible_by_the_reduction(monkeypatch):
    """A 16-bit CUDA map whose height is not a multiple of r takes the plain
    modules, as ``vit_tpu``'s gate; dropout active in training too."""
    calls = []
    _open_kernel_gates(monkeypatch, calls)
    attn = scalable_vit.ScalableSelfAttention(32, 2, 40, 32, reduction_factor=4, device="cpu")
    norm = common.ChannelLayerNorm(32, device="cpu")
    x = torch.randn(1, 8, 8, 32)
    scalable_vit.ssa_residual(x, norm, attn)
    assert calls == ["fused_cross_attention"]
    scalable_vit.ssa_residual(torch.randn(1, 6, 8, 32), norm, attn)
    dropped = scalable_vit.ScalableSelfAttention(32, 2, 40, 32, 0.1, 4, device="cpu").train()
    scalable_vit.ssa_residual(x, norm, dropped)
    scalable_vit.ssa_residual(x, norm, attn, mode="never")
    assert calls == ["fused_cross_attention"]


def test_constructor_refuses_what_the_port_does_not_take():
    with pytest.raises(ValueError, match="TPU-only"):
        ScalableViT(**SMALL, fused_attention="interpret", device="cpu")
    with pytest.raises(ValueError, match="scan_layers"):
        ScalableViT(**SMALL, scan_layers=True, device="cpu")
    with pytest.raises(ValueError, match="tuple"):
        ScalableViT(**{**SMALL, "depth": 2}, device="cpu")
    model = ScalableViT(**{**SMALL, "window_size": (5, None)}, device="cpu")
    with pytest.raises(ValueError, match="window size"):
        model(torch.zeros(1, SIZE, SIZE, 3))
