"""Parallel ViT in the port against ``vit_tpu`` in f32 on the CPU, on the same
weights converted from Flax (every parameter drawn with numpy from a seed).

The config: 32 px, patch 8 (16 patches and the cls token), dim 32, depth 2,
2 parallel branches (and 3 for the logits), 4 heads of 8, mlp 64, 5
classes, batch 2.  ``vit_tpu`` runs no Pallas kernel here, so neither does
the port: one route.  Eval logits (cls and mean pooling, 2 and 3 branches)
and one SGD step of ``make_train_step`` against ``vit_tpu``'s: the loss,
every gradient and the updated parameters, within 1e-4.  Then the converter
leaf for leaf (``{attn_norm,attn,mlp_norm,mlp}_{i}_{j}`` at the top, as they
are), the constructor's checks and the device rule.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import (  # noqa: E402
    TOL, check_sgd_step, jax_sgd_step, loaded, maxdiff, port_logits, random_variables,
)
from vit_tpu.models import parallel_vit as jax_parallel_vit  # noqa: E402
from vit_tpu_torch import parallel_vit, state_dict_from_flax  # noqa: E402

SMALL = dict(image_size=32, patch_size=8, num_classes=5, dim=32, depth=2, heads=4, dim_head=8,
             mlp_dim=64)


@pytest.fixture(scope="module")
def jax_runs():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 2], np.int32)
    out = dict(img=img, labels=labels, variables={}, logits={})
    for branches in (2, 3):
        cfg = dict(SMALL, num_parallel_branches=branches)
        v = random_variables(jax_parallel_vit.ViT(**cfg), img, rng)
        out["variables"][branches] = v
        for pool in ("cls", "mean"):
            model = jax_parallel_vit.ViT(**cfg, pool=pool)
            out["logits"][branches, pool] = np.asarray(jax.jit(model.apply)(v, jnp.asarray(img)))
    out["step"] = jax_sgd_step(jax_parallel_vit.ViT(**SMALL).apply, out["variables"][2], img,
                               labels)
    return out


@pytest.mark.parametrize("pool", ["cls", "mean"])
@pytest.mark.parametrize("branches", [2, 3])
def test_eval_logits_match_jax(jax_runs, branches, pool):
    model = parallel_vit.ViT(**SMALL, num_parallel_branches=branches, pool=pool, device="cpu")
    logits = port_logits(loaded(model, jax_runs["variables"][branches]), jax_runs["img"])
    assert logits.shape == (2, 5)
    assert maxdiff(logits, jax_runs["logits"][branches, pool]) <= TOL


def test_train_step_matches_jax(jax_runs):
    model = loaded(parallel_vit.ViT(**SMALL, device="cpu"), jax_runs["variables"][2])
    check_sgd_step(model, jax_runs["img"], jax_runs["labels"], jax_runs["step"],
                   nonzero=("cls_token", "pos_embedding", "attn_1_1.to_qkv.weight",
                            "mlp_norm_0_1.weight"))


def test_converter_carries_the_parallel_vit_tree(jax_runs):
    """The branches' modules keep their ``_{i}_{j}`` names at the top (not
    the per-layer ``layers.{i}`` rule); ``to_out`` as ``to_out.0``."""
    v = jax_runs["variables"][3]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    converted = state_dict_from_flax(v)
    model = parallel_vit.ViT(**SMALL, num_parallel_branches=3, device="cpu")
    assert set(converted) == set(model.state_dict()) and len(converted) == len(flat)
    assert not any(k.startswith("layers.") for k in converted)
    for path, key, perm in (
            ("params/attn_1_2/to_qkv/kernel", "attn_1_2.to_qkv.weight", (1, 0)),
            ("params/attn_0_1/to_out/kernel", "attn_0_1.to_out.0.weight", (1, 0)),
            ("params/attn_norm_1_0/scale", "attn_norm_1_0.weight", None),
            ("params/mlp_0_2/fc1/kernel", "mlp_0_2.fc1.weight", (1, 0)),
            ("params/mlp_norm_1_2/bias", "mlp_norm_1_2.bias", None),
            ("params/cls_token", "cls_token", None)):
        want = flat[path].transpose(perm) if perm else flat[path]
        assert np.array_equal(converted[key].numpy(), want), path


def test_constructor_checks_and_device_rule():
    with pytest.raises(ValueError, match="divisible by the patch size"):
        parallel_vit.ViT(**dict(SMALL, image_size=(32, 36)), device="cpu")
    with pytest.raises(ValueError, match="pool type"):
        parallel_vit.ViT(**SMALL, pool="max", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel_vit.ViT(**SMALL)
    assert all(p.device.type == "cpu"
               for p in parallel_vit.ViT(**SMALL, device="cpu").parameters())
