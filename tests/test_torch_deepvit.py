"""DeepViT in the port against ``vit_tpu`` in f32 on the CPU, on the same
weights converted from Flax (every parameter drawn with numpy from a seed;
``reattn_weights`` at unit scale, so the re-attention's head mix and its
LayerNorm over the heads are exercised for real).

The config: 32 px, patch 8 (16 patches and the cls token), dim 32, depth 2,
4 heads of 8, mlp 64, 5 classes, batch 2.  Two routes:

- ``never``: ``fused_mlp="never"`` on both sides;
- ``kernels``: the port's fused-MLP route with the 16-bit CUDA gate opened on
  the CPU (``kernel_activation`` patched in ``vit_tpu_torch.layers.common``),
  where the op runs its plain version, against ``vit_tpu``'s
  ``fused_mlp="interpret"`` (its Pallas kernel in interpret mode, exact
  GELU).  The calls into the op are counted: one a layer a forward, at 17
  tokens (``vit_tpu``'s ``n >= 128`` gate, a v5e reason, is dropped).

Eval logits (cls and mean pooling), and one SGD step of ``make_train_step``
against ``vit_tpu``'s: the loss, every gradient and the updated parameters,
within 1e-4 (gradients of max(1, their largest entry)).  Then
``ReAttention`` alone (its LayerNorm in f32 under a bf16 input), the
converter leaf for leaf, the constructor's checks and the device rule.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import (  # noqa: E402
    TOL, check_sgd_step, jax_sgd_step, loaded, maxdiff, open_kernel_gate, port_logits,
    random_variables,
)
from vit_tpu.models import deepvit as jax_deepvit  # noqa: E402
from vit_tpu_torch import DeepViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.models import deepvit  # noqa: E402

SMALL = dict(image_size=32, patch_size=8, num_classes=5, dim=32, depth=2, heads=4, dim_head=8,
             mlp_dim=64)
ROUTES = {"never": "never", "kernels": "interpret"}
TOKENS = 17


@pytest.fixture(scope="module")
def jax_runs():
    """Per route: ``vit_tpu``'s eval logits (both poolings) and one SGD step,
    on one set of variables."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = np.array([3, 1], np.int32)
    v = random_variables(jax_deepvit.DeepViT(**SMALL), img, rng)
    out = dict(img=img, labels=labels, variables=v, runs={})
    for route, mode in ROUTES.items():
        run = {}
        for pool in ("cls", "mean"):
            model = jax_deepvit.DeepViT(**SMALL, pool=pool, fused_mlp=mode)
            run[pool] = np.asarray(jax.jit(model.apply)(v, jnp.asarray(img)))
        run["step"] = jax_sgd_step(jax_deepvit.DeepViT(**SMALL, fused_mlp=mode).apply, v, img,
                                   labels)
        out["runs"][route] = run
    return out


def _port(variables, route, monkeypatch, calls, **kw):
    if route == "kernels":
        open_kernel_gate(monkeypatch, calls)
    mode = "auto" if route == "kernels" else "never"
    return loaded(DeepViT(**SMALL, fused_mlp=mode, device="cpu", **kw), variables)


@pytest.mark.parametrize("pool", ["cls", "mean"])
@pytest.mark.parametrize("route", ROUTES)
def test_eval_logits_match_jax(jax_runs, monkeypatch, route, pool):
    calls = []
    model = _port(jax_runs["variables"], route, monkeypatch, calls, pool=pool)
    logits = port_logits(model, jax_runs["img"])
    assert calls == ([TOKENS] * SMALL["depth"] if route == "kernels" else [])
    assert logits.shape == (2, 5)
    assert maxdiff(logits, jax_runs["runs"][route][pool]) <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_matches_jax(jax_runs, monkeypatch, route):
    """One SGD step: the loss, every gradient (``reattn_weights``',
    ``reattn_norm``'s, the tokens' included) and the updated parameters."""
    calls = []
    model = _port(jax_runs["variables"], route, monkeypatch, calls)
    check_sgd_step(model, jax_runs["img"], jax_runs["labels"], jax_runs["runs"][route]["step"],
                   nonzero=("cls_token", "pos_embedding", "layers.0.attn.reattn_weights",
                            "layers.1.attn.reattn_norm.weight"))
    assert calls == ([TOKENS] * SMALL["depth"] if route == "kernels" else [])


def test_reattention_matches_jax_and_keeps_its_norm_in_f32():
    """``ReAttention`` alone (dim 16, 4 heads of 8, 10 tokens) within 1e-5
    of ``vit_tpu``'s; under a bf16 input its head LayerNorm still gets the
    f32 matrix."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    module = jax_deepvit.ReAttention(16, heads=4, dim_head=8)
    v = random_variables(module, x, rng)
    want = np.asarray(module.apply(v, jnp.asarray(x)))
    port = loaded(deepvit.ReAttention(16, 4, 8, device="cpu"), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 10, 16) and maxdiff(got, want) <= 1e-5
    seen = []
    port.reattn_norm.register_forward_hook(lambda m, args, out: seen.append(
        (args[0].dtype, out.dtype, tuple(args[0].shape))))
    with torch.no_grad():
        half = port.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16))
    assert half.dtype == torch.bfloat16
    assert seen == [(torch.float32, torch.float32, (2, 10, 10, 4))]


def test_converter_carries_the_deepvit_tree(jax_runs):
    """Leaf for leaf: the top-level ``{attn_norm,attn,mlp_norm,mlp}_{i}``
    under ``layers.{i}``; ``reattn_weights`` as it is, ``reattn_norm``'s
    scale as ``weight``, ``to_out`` as ``to_out.0``; loaded strictly."""
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    model = DeepViT(**SMALL, device="cpu")
    converted = state_dict_from_flax(v)
    assert set(converted) == set(model.state_dict()) and len(converted) == len(flat)
    model.load_state_dict(converted, strict=True)
    names = {
        "params/attn_1/reattn_weights": ("layers.1.attn.reattn_weights", None),
        "params/attn_0/reattn_norm/scale": ("layers.0.attn.reattn_norm.weight", None),
        "params/attn_0/to_qkv/kernel": ("layers.0.attn.to_qkv.weight", (1, 0)),
        "params/attn_1/to_out/kernel": ("layers.1.attn.to_out.0.weight", (1, 0)),
        "params/mlp_0/fc2/bias": ("layers.0.mlp.fc2.bias", None),
        "params/cls_token": ("cls_token", None),
        "params/pos_embedding": ("pos_embedding", None),
        "params/head/kernel": ("head.weight", (1, 0)),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path]
        assert np.array_equal(converted[key].numpy(), want), path
    assert converted["layers.0.attn.reattn_weights"].shape == (4, 4)


def test_constructor_checks_and_device_rule():
    """``vit_tpu``'s asserts (ValueErrors here), the TPU-only modes, and the
    card by default: without CUDA the constructor raises unless
    ``device="cpu"``."""
    with pytest.raises(ValueError, match="divisible by the patch size"):
        DeepViT(**dict(SMALL, image_size=30), device="cpu")
    with pytest.raises(ValueError, match="pool type"):
        DeepViT(**SMALL, pool="max", device="cpu")
    with pytest.raises(ValueError, match="TPU-only"):
        DeepViT(**SMALL, fused_mlp="interpret", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeepViT(**SMALL)
    assert all(p.device.type == "cpu" for p in DeepViT(**SMALL, device="cpu").parameters())


def test_dropout_in_training_takes_the_plain_mlp(monkeypatch):
    """With the gate open, an active dropout (training, rate 0.1) runs the
    plain MLP modules, as ``vit_tpu``'s gate does; eval mode the kernel."""
    calls = []
    open_kernel_gate(monkeypatch, calls)
    model = DeepViT(**SMALL, dropout=0.1, device="cpu", generator=torch.Generator().manual_seed(1))
    img = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        model.train()(img)
        assert calls == []
        model.eval()(img)
    assert calls == [TOKENS] * SMALL["depth"]
