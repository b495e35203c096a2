"""The Efficient ViT and the ``Distillable*`` students against ``vit_tpu``'s,
on the CPU in f32: ``extract_patches`` (T2T-ViT's unfold tokenizer) exactly
(TF 'SAME' pads, ``(kh, kw, c)`` order), the logits (and distillation
tokens) within 1e-4 through the same weights (``state_dict_from_flax``), in
eval mode.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_tpu.layers.common import Transformer as JaxTransformer  # noqa: E402
from vit_tpu.models import efficient as jax_efficient  # noqa: E402
from vit_tpu.objectives import distill as jax_distill  # noqa: E402
from vit_tpu.ops.patchify import extract_patches as jax_extract_patches  # noqa: E402
from vit_tpu_torch import state_dict_from_flax, tokenizers  # noqa: E402
from vit_tpu_torch.layers.common import Transformer  # noqa: E402
from vit_tpu_torch.models import efficient  # noqa: E402
from vit_tpu_torch.objectives import distill  # noqa: E402
from vit_tpu_torch.ops.patchify import extract_patches  # noqa: E402

TOL = 1e-4
EFFICIENT = dict(image_size=32, patch_size=8, num_classes=10, dim=64)
ENCODER = dict(dim=64, depth=2, heads=2, dim_head=32, mlp_dim=128)


def _image(size, seed=0, b=2, c=3):
    return np.random.default_rng(seed).standard_normal((b, size, size, c)).astype(np.float32)


def _converted(jax_model, *args, **kwargs):
    variables = jax_model.init(jax.random.PRNGKey(0), *args, **kwargs)
    return variables, state_dict_from_flax(jax.tree.map(np.asarray, variables))


@pytest.mark.parametrize("size,kernel,stride", [(224, 7, 4), (56, 3, 2), (15, 3, 2), (16, 3, 2),
                                                (9, 7, 4)])
@pytest.mark.parametrize("padding", ["SAME", "VALID", ((1, 2), (0, 1))])
def test_extract_patches_matches_jax(size, kernel, stride, padding):
    img = _image(size, c=3 if size > 100 else 5)
    want = np.asarray(jax_extract_patches(jnp.asarray(img), kernel, stride, padding=padding))
    got = extract_patches(torch.from_numpy(img), kernel, stride, padding=padding)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    if padding == "SAME":
        assert got.shape[1] == -(-size // stride)  # TF 'SAME': ceil(size / stride)


def test_extract_patches_refuses_unknown_padding():
    with pytest.raises(ValueError, match="unknown padding"):
        extract_patches(torch.zeros(1, 8, 8, 3), 3, 2, padding="FULL")


def test_tokenizers_facade():
    from vit_tpu_torch.models import crossformer, mobile_vit, pit, twins_svt

    assert tokenizers.extract_patches is extract_patches
    assert tokenizers.PatchEmbedding is twins_svt.PatchEmbedding
    assert tokenizers.CrossEmbedLayer is crossformer.CrossEmbedLayer
    assert tokenizers.OverlapPatchEmbed is pit.OverlapPatchEmbed
    assert tokenizers.ConvNxNBN is mobile_vit.ConvNxNBN
    assert set(tokenizers.__all__) == {"patchify", "unpatchify", "extract_patches", "SPT",
                                       "PatchEmbedding", "CrossEmbedLayer", "OverlapPatchEmbed",
                                       "ConvNxNBN"}


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_efficient_vit_logits_match_jax(pool):
    img = _image(32, seed=2)
    jax_model = jax_efficient.ViT(**EFFICIENT, pool=pool, transformer=JaxTransformer(**ENCODER))
    variables, state = _converted(jax_model, jnp.asarray(img))
    want = np.asarray(jax_model.apply(variables, jnp.asarray(img)))
    port = efficient.ViT(**EFFICIENT, pool=pool, transformer=Transformer(**ENCODER, device="cpu"),
                         device="cpu").eval()
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        assert np.max(np.abs(port(torch.from_numpy(img)).numpy() - want)) <= TOL


def _students():
    vit = dict(image_size=32, patch_size=8, num_classes=10, **ENCODER)
    return {
        "DistillableViT": (lambda: jax_distill.DistillableViT(**vit),
                           lambda: distill.DistillableViT(**vit, device="cpu"), 32),
        "DistillableEfficientViT": (
            lambda: jax_distill.DistillableEfficientViT(**EFFICIENT,
                                                        transformer=JaxTransformer(**ENCODER)),
            lambda: distill.DistillableEfficientViT(
                **EFFICIENT, transformer=Transformer(**ENCODER, device="cpu"), device="cpu"),
            32),
    }


@pytest.mark.parametrize("name", list(_students()))
@pytest.mark.parametrize("with_token", [True, False], ids=["distill-token", "no-token"])
def test_distillable_students_match_jax(name, with_token):
    """Logits (and the distillation token's output) with a token, logits
    alone without one, through the same weights."""
    make_jax, make_port, size = _students()[name]
    img = _image(size, seed=3)
    token = np.random.default_rng(4).standard_normal((1, 1, 64)).astype(np.float32)
    kwargs = dict(distill_token=jnp.asarray(token)) if with_token else {}
    jax_model = make_jax()
    variables, state = _converted(jax_model, jnp.asarray(img), **kwargs)
    want = jax_model.apply(variables, jnp.asarray(img), **kwargs)
    port = make_port().eval()
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(img),
                   distill_token=torch.from_numpy(token) if with_token else None)
    if with_token:
        assert isinstance(got, tuple) and len(got) == 2
        for g, w in zip(got, want):
            assert np.max(np.abs(g.numpy() - np.asarray(w))) <= TOL
    else:
        assert np.max(np.abs(got.numpy() - np.asarray(want))) <= TOL
