"""The slice as a whole: ``vit_tpu.ViT`` → ``state_dict_from_flax`` → the
port's ``ViT``, same image, f32 logits within 1e-4 (the bar ``vit_tpu`` held
against the TF reference).

Below 128 tokens the JAX side runs ``fused_attention="never"`` (there its
``"interpret"`` routes to the hybrid tier, ``layers/common.py:275-281``, which
``test_torch_fused_hybrid.py`` holds against the port's ``"hybrid"``); at
n ≥ 128 it runs both Pallas block kernels in the interpreter, the path the
port's kernels replace.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_tpu import ViT as JaxViT  # noqa: E402
from vit_tpu.ops.patchify import patchify as jax_patchify  # noqa: E402
from vit_tpu_torch import ViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.ops.patchify import patchify, unpatchify  # noqa: E402

TOL = 1e-4

SMALL = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2,
             heads=2, mlp_dim=128)                       # n = 17
LONG = dict(image_size=48, patch_size=4, num_classes=10, dim=64, depth=2,
            heads=2, dim_head=32, mlp_dim=128)           # n = 145


def _image(size, seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _flax(kw, img, **mode):
    model = JaxViT(**kw, **mode)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(img))
    logits = np.asarray(model.apply(variables, jnp.asarray(img)))
    return jax.tree.map(np.asarray, variables), logits


def _port(kw, variables):
    model = ViT(**kw, device="cpu").eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def _check(kw, **mode):
    img = _image(kw["image_size"])
    variables, want = _flax(kw, img, **mode)
    with torch.no_grad():
        got = _port(kw, variables)(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_matches_jax_short_sequence(pool):
    _check(dict(SMALL, pool=pool), fused_attention="never", fused_mlp="never")


@pytest.mark.parametrize("extra", [
    dict(heads=4, dim_head=24),   # dim_head != dim / heads
    dict(heads=1, dim_head=64),   # single head of width dim: no output projection
])
def test_vit_matches_jax_head_geometries(extra):
    _check(dict(SMALL, **extra), fused_attention="never", fused_mlp="never")


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_matches_jax_pallas_blocks(pool):
    """n = 145: the JAX side runs both block kernels in the interpreter."""
    _check(dict(LONG, pool=pool), fused_attention="interpret", fused_mlp="interpret")


def test_converter_round_trips_every_leaf():
    """Every Flax leaf lands in exactly one port tensor, unchanged (Dense
    kernels transposed), and the keys are exactly the port's state_dict."""
    img = _image(SMALL["image_size"])
    variables, _ = _flax(SMALL, img)
    leaves = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    state = state_dict_from_flax(variables)
    assert len(state) == len(leaves)
    assert set(state) == set(ViT(**SMALL, device="cpu").state_dict())
    unused = {k: v.numpy() for k, v in state.items()}
    for path, leaf in leaves:
        want = leaf.T if path[-1].key == "kernel" else leaf
        match = [k for k, v in unused.items()
                 if v.shape == want.shape and np.array_equal(v, want)]
        assert match, jax.tree_util.keystr(path)
        del unused[match[0]]
    assert not unused


def test_converter_refuses_scanned_and_unknown_trees():
    img = _image(SMALL["image_size"])
    scanned = JaxViT(**SMALL, scan_layers=True).init(jax.random.PRNGKey(0), jnp.asarray(img))
    with pytest.raises(ValueError, match="scanned"):
        state_dict_from_flax(jax.tree.map(np.asarray, scanned))
    with pytest.raises(ValueError, match="unknown leaf"):
        state_dict_from_flax({"params": {"head": {"mystery": np.zeros(3)}}})


def test_patchify_matches_jax_and_inverts():
    img = _image(16, b=3)
    want = np.asarray(jax_patchify(jnp.asarray(img), 4, 8))
    got = patchify(torch.from_numpy(img), 4, 8)
    assert np.array_equal(got.numpy(), want)
    back = unpatchify(got, 4, 2, 4, 8, 3)
    assert np.array_equal(back.numpy(), img)
