"""The ViT with a PatchMerger in the port against ``vit_tpu`` in f32 on the
CPU, on the same weights converted from Flax (every parameter drawn with
numpy from a seed; the merger's queries at unit scale).

The config: 32 px, patch 4 (64 patches, no cls token), dim 32, depth 4, 2
heads of 16, mlp 64, merged to 3 tokens after layer 2, 5 classes, batch 2.
Two routes:

- ``never``: ``fused_mlp="never"`` on both sides;
- ``kernels``: the port's fused-MLP route with the 16-bit CUDA gate opened on
  the CPU (``kernel_activation`` patched in ``vit_tpu_torch.layers.common``),
  against ``vit_tpu``'s ``fused_mlp="interpret"``; the calls into the op
  counted: one a layer a forward, at 64 tokens before the merger and 3
  after it.

Eval logits and one SGD step of ``make_train_step`` against ``vit_tpu``'s:
the loss, every gradient (the queries' included) and the updated
parameters, within 1e-4.  Then ``PatchMerger`` alone, the merger's place
(``patch_merge_layer``, its default ``depth // 2``, and none where
``vit_tpu`` never calls it: the two trees hold the same parameters), the
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
from vit_tpu.models import vit_with_patch_merger as jax_merger  # noqa: E402
from vit_tpu_torch import PatchMerger, state_dict_from_flax, vit_with_patch_merger  # noqa: E402

SMALL = dict(image_size=32, patch_size=4, num_classes=5, dim=32, depth=4, heads=2, dim_head=16,
             mlp_dim=64, patch_merge_layer=2, patch_merge_num_tokens=3)
ROUTES = {"never": "never", "kernels": "interpret"}
CALLS = [64, 64, 3, 3]  # tokens at each layer's MLP


@pytest.fixture(scope="module")
def jax_runs():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = np.array([4, 0], np.int32)
    v = random_variables(jax_merger.ViT(**SMALL), img, rng)
    out = dict(img=img, labels=labels, variables=v, runs={})
    for route, mode in ROUTES.items():
        model = jax_merger.ViT(**SMALL, fused_mlp=mode)
        out["runs"][route] = dict(logits=np.asarray(jax.jit(model.apply)(v, jnp.asarray(img))),
                                  step=jax_sgd_step(model.apply, v, img, labels))
    return out


def _port(variables, route, monkeypatch, calls):
    if route == "kernels":
        open_kernel_gate(monkeypatch, calls)
    mode = "auto" if route == "kernels" else "never"
    return loaded(vit_with_patch_merger.ViT(**SMALL, fused_mlp=mode, device="cpu"), variables)


@pytest.mark.parametrize("route", ROUTES)
def test_eval_logits_match_jax(jax_runs, monkeypatch, route):
    calls = []
    logits = port_logits(_port(jax_runs["variables"], route, monkeypatch, calls), jax_runs["img"])
    assert calls == (CALLS if route == "kernels" else [])
    assert logits.shape == (2, 5)
    assert maxdiff(logits, jax_runs["runs"][route]["logits"]) <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_matches_jax(jax_runs, monkeypatch, route):
    calls = []
    model = _port(jax_runs["variables"], route, monkeypatch, calls)
    check_sgd_step(model, jax_runs["img"], jax_runs["labels"], jax_runs["runs"][route]["step"],
                   nonzero=("patch_merger.queries", "patch_merger.norm.weight",
                            "pos_embedding"))
    assert calls == (CALLS if route == "kernels" else [])
    # the position embedding's last row (num_patches + 1 rows, n used) gets none
    assert float(model.pos_embedding.grad[0, -1].abs().max()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_patch_merger_alone_matches_jax(dtype):
    """``PatchMerger(24, 5)`` over 2 x 11 tokens: within 1e-5 of
    ``vit_tpu``'s in f32; under bf16 the output keeps the input's dtype and
    stays within bf16 rounding of the f32 result."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    module = jax_merger.PatchMerger(24, 5)
    v = random_variables(module, x, rng)
    want = np.asarray(module.apply(v, jnp.asarray(x)))
    port = loaded(PatchMerger(24, 5, device="cpu"), v).to(dtype)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(dtype))
    assert got.shape == (2, 5, 24) and got.dtype == dtype
    assert maxdiff(got.float(), want) <= (1e-5 if dtype == torch.float32 else 0.05)


@pytest.mark.parametrize("depth,layer,merged", [(4, None, 1), (4, 3, 2), (1, None, None),
                                                (4, 5, None)])
def test_merger_sits_where_vit_tpu_calls_it(depth, layer, merged):
    """After layer ``patch_merge_layer`` (default ``depth // 2``), 0-based
    index ``merged``; where ``vit_tpu`` never calls it (index -1, or past the
    last layer) the port builds none, so both trees hold the same
    parameters."""
    cfg = dict(SMALL, depth=depth, patch_merge_layer=layer)
    img = np.zeros((1, 32, 32, 3), np.float32)
    v = random_variables(jax_merger.ViT(**cfg), img, np.random.default_rng(1))
    model = vit_with_patch_merger.ViT(**cfg, device="cpu")
    assert ("patch_merger" in v["params"]) == (merged is not None)
    assert (model.patch_merger is not None) == (merged is not None)
    if merged is not None:
        assert model.merge_index == merged
    loaded(model, v)


def test_converter_carries_the_merger_tree(jax_runs):
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    converted = state_dict_from_flax(v)
    model = vit_with_patch_merger.ViT(**SMALL, device="cpu")
    assert set(converted) == set(model.state_dict()) and len(converted) == len(flat)
    for path, key in (("params/patch_merger/queries", "patch_merger.queries"),
                      ("params/patch_merger/norm/scale", "patch_merger.norm.weight"),
                      ("params/attn_3/to_out/bias", "layers.3.attn.to_out.0.bias"),
                      ("params/mlp_norm_2/bias", "layers.2.mlp_norm.bias"),
                      ("params/pos_embedding", "pos_embedding")):
        assert np.array_equal(converted[key].numpy(), flat[path]), path
    assert converted["pos_embedding"].shape == (1, 65, 32)
    assert converted["patch_merger.queries"].shape == (3, 32)


def test_constructor_checks_and_device_rule():
    with pytest.raises(ValueError, match="divisible by the patch size"):
        vit_with_patch_merger.ViT(**dict(SMALL, patch_size=(4, 5)), device="cpu")
    with pytest.raises(ValueError, match="TPU-only"):
        vit_with_patch_merger.ViT(**SMALL, fused_mlp="interpret", device="cpu")
    if not torch.cuda.is_available():
        for build in (lambda **kw: vit_with_patch_merger.ViT(**SMALL, **kw),
                      lambda **kw: PatchMerger(8, 2, **kw)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
            assert all(p.device.type == "cpu" for p in build(device="cpu").parameters())
