"""CrossViT in the port against ``vit_tpu`` in f32 on the CPU, on the same
weights converted from Flax (every parameter drawn with numpy from a seed).

The config: 32 px, a 16-wide branch of patch 4 (65 tokens) and a 24-wide one
of patch 16 (5 tokens), encoder depths 1 and 2 (2 heads of 8, mlp 32), cross
depth 1 (2 heads of 8), 2 rounds, dropout 0, 5 classes, batch 2.  Two routes:

- ``never``: the encoders' MLPs plain on both sides (``vit_tpu``'s CrossViT
  takes no mode: its ``NormedTransformer`` is replaced for the test by a
  partial with ``fused_mlp``, inside each apply; the port's encoders are
  set to ``"never"``);
- ``kernels``: the port's fused-MLP route with the 16-bit CUDA gate opened on
  the CPU (``kernel_activation`` patched in ``vit_tpu_torch.layers.common``),
  against ``vit_tpu``'s encoders on ``fused_mlp="interpret"``; the calls
  counted: 3 a round a forward, at 65, 5 and 5 tokens.

Eval logits and one SGD step of ``make_train_step`` against ``vit_tpu``'s:
the loss, every gradient and the updated parameters, within 1e-4.  Then one
encoder alone (``NormedTransformer``, both routes, its forward and its
gradients), ``CrossAttention`` with ``kv_include_self`` (the context
``[x, ctx]`` in that order), ``CrossTransformer`` at equal widths (no
projections), the converter leaf for leaf (``{sm,lg}_enc_{r}`` keep their
per-layer names), the constructor's checks and the device rule.
"""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import (  # noqa: E402
    TOL, check_sgd_step, grad_diff, jax_sgd_step, loaded, maxdiff, open_kernel_gate,
    port_logits, random_variables,
)
from vit_tpu.models import cross_vit as jax_cross_vit  # noqa: E402
from vit_tpu_torch import CrossViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.models import cross_vit  # noqa: E402

SMALL = dict(image_size=32, num_classes=5, sm_dim=16, lg_dim=24, sm_patch_size=4,
             lg_patch_size=16, sm_enc_depth=1, sm_enc_heads=2, sm_enc_mlp_dim=32,
             sm_enc_dim_head=8, lg_enc_depth=2, lg_enc_heads=2, lg_enc_mlp_dim=32,
             lg_enc_dim_head=8, cross_attn_depth=1, cross_attn_heads=2, cross_attn_dim_head=8,
             depth=2, dropout=0.0, emb_dropout=0.0)
ROUTES = {"never": "never", "kernels": "interpret"}
CALLS = [65, 5, 5] * 2  # a round: the small encoder's layer, the large one's two


def _jax_apply(mode):
    """``vit_tpu``'s CrossViT with its encoders on ``mode``."""
    encoder = functools.partial(jax_cross_vit.NormedTransformer, fused_mlp=mode)
    model = jax_cross_vit.CrossViT(**SMALL)

    def apply(variables, img, **kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_cross_vit, "NormedTransformer", encoder)
            return model.apply(variables, img, **kw)

    return apply


@pytest.fixture(scope="module")
def jax_runs():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = np.array([2, 4], np.int32)
    v = random_variables(jax_cross_vit.CrossViT(**SMALL), img, rng)
    out = dict(img=img, labels=labels, variables=v, runs={})
    for route, mode in ROUTES.items():
        apply = _jax_apply(mode)
        out["runs"][route] = dict(logits=np.asarray(jax.jit(apply)(v, jnp.asarray(img))),
                                  step=jax_sgd_step(apply, v, img, labels))
    return out


def _port(variables, route, monkeypatch, calls):
    if route == "kernels":
        open_kernel_gate(monkeypatch, calls)
    model = loaded(CrossViT(**SMALL, device="cpu"), variables)
    for m in model.modules():
        if isinstance(m, cross_vit.NormedTransformer):
            m.fused_mlp = "auto" if route == "kernels" else "never"
    return model


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
                   nonzero=("sm_image_embedder.cls_token", "lg_image_embedder.pos_embedding",
                            "cross_attend_1.lg_project_in_0.weight",
                            "cross_attend_0.sm_attend_lg_0.to_kv.weight"))
    assert calls == (CALLS if route == "kernels" else [])


@pytest.mark.parametrize("route", ROUTES)
def test_encoder_matches_jax(monkeypatch, route):
    """``NormedTransformer(24, depth 2, 3 heads of 8, mlp 40)`` over 2 x 9
    tokens: its output and the gradients of a fixed cotangent (the input's
    and every parameter's) within 1e-5 of ``vit_tpu``'s (``fused_mlp`` on
    ``"never"`` / ``"interpret"``), the op called once a layer on the kernel
    route."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    dy = (0.1 * rng.standard_normal((2, 9, 24))).astype(np.float32)
    module = jax_cross_vit.NormedTransformer(24, 2, 3, 8, 40, fused_mlp=ROUTES[route])
    v = random_variables(module, x, rng)
    y, (dp, dx) = jax.jit(lambda p, a, c: (lambda out, vjp: (out, vjp(c)))(
        *jax.vjp(lambda p_, a_: module.apply({"params": p_}, a_), p, a)))(
        v["params"], jnp.asarray(x), jnp.asarray(dy))
    calls = []
    if route == "kernels":
        open_kernel_gate(monkeypatch, calls)
    port = cross_vit.NormedTransformer(24, 2, 3, 8, 40, device="cpu",
                                       fused_mlp="auto" if route == "kernels" else "never")
    # converted under a parent name, as in the model (at the top the
    # converter reads attn_{i} as the small-dataset ViT's layers)
    state = state_dict_from_flax({"params": {"enc": v["params"]}})
    port.load_state_dict({k.removeprefix("enc."): t for k, t in state.items()}, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    got.backward(torch.from_numpy(dy))
    assert calls == ([9, 9] if route == "kernels" else [])
    assert maxdiff(got.detach(), y) <= 1e-5
    assert maxdiff(xt.grad, dx) <= 1e-5
    want = {k.removeprefix("enc."): t for k, t in state_dict_from_flax(
        {"params": {"enc": jax.tree.map(np.asarray, dp)}}).items()}
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert set(grads) == set(want)
    assert max(grad_diff(grads[k], want[k]) for k in grads) <= 1e-5


def test_cross_attention_includes_itself_first():
    """``CrossAttention(16, 2 heads of 8)`` of 1 query over a 6-token
    context with ``kv_include_self``: within 1e-5 of ``vit_tpu``'s, and the
    same as attending over ``[x, ctx]`` without it (the order matters:
    ``[ctx, x]`` gives another answer once to_kv's rows differ)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 1, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, 16)).astype(np.float32)
    module = jax_cross_vit.CrossAttention(16, heads=2, dim_head=8)
    v = random_variables(module, x, rng)
    want = np.asarray(module.apply(v, jnp.asarray(x), context=jnp.asarray(ctx),
                                   kv_include_self=True))
    port = loaded(cross_vit.CrossAttention(16, 2, 8, device="cpu"), v)
    t = torch.from_numpy
    with torch.no_grad():
        got = port(t(x), context=t(ctx), kv_include_self=True)
        joined = port(t(x), context=torch.cat([t(x), t(ctx)], dim=1))
    assert got.shape == (2, 1, 16) and maxdiff(got, want) <= 1e-5
    assert torch.equal(got, joined)


def test_cross_transformer_at_equal_widths_has_no_projections():
    """Branches of one width: no ``*_project_*`` modules in either package,
    and the two token sets within 1e-5."""
    rng = np.random.default_rng(13)
    sm = rng.standard_normal((2, 5, 16)).astype(np.float32)
    lg = rng.standard_normal((2, 3, 16)).astype(np.float32)
    module = jax_cross_vit.CrossTransformer(16, 16, 2, 2, 8)
    shapes = jax.eval_shape(lambda a, b: module.init(jax.random.PRNGKey(0), a, b),
                            jnp.asarray(sm), jnp.asarray(lg))
    v = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32), shapes)
    assert not any("project" in k for k in v["params"])
    want = module.apply(v, jnp.asarray(sm), jnp.asarray(lg))
    port = loaded(cross_vit.CrossTransformer(16, 16, 2, 2, 8, device="cpu"), v)
    assert not any("project" in k for k in port.state_dict())
    with torch.no_grad():
        got = port(torch.from_numpy(sm), torch.from_numpy(lg))
    for g, w in zip(got, want):
        assert g.shape == w.shape and maxdiff(g, w) <= 1e-5


def test_converter_carries_the_cross_vit_tree(jax_runs):
    """``{sm,lg}_enc_{r}`` are not stacks: their per-layer modules and their
    trailing ``norm`` keep their names; ``to_out`` as ``to_out.0``."""
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    converted = state_dict_from_flax(v)
    model = CrossViT(**SMALL, device="cpu")
    assert set(converted) == set(model.state_dict()) and len(converted) == len(flat)
    assert not any(".layers." in k for k in converted)
    for path, key, perm in (
            ("params/lg_enc_1/attn_1/to_kv/kernel", "lg_enc_1.attn_1.to_kv.weight", (1, 0)),
            ("params/sm_enc_0/norm/scale", "sm_enc_0.norm.weight", None),
            ("params/sm_enc_1/mlp_0/fc1/bias", "sm_enc_1.mlp_0.fc1.bias", None),
            ("params/cross_attend_0/lg_attend_sm_0/to_out/kernel",
             "cross_attend_0.lg_attend_sm_0.to_out.0.weight", (1, 0)),
            ("params/cross_attend_1/sm_project_out_0/kernel",
             "cross_attend_1.sm_project_out_0.weight", (1, 0)),
            ("params/sm_image_embedder/pos_embedding", "sm_image_embedder.pos_embedding", None),
            ("params/lg_head/kernel", "lg_head.weight", (1, 0))):
        want = flat[path].transpose(perm) if perm else flat[path]
        assert np.array_equal(converted[key].numpy(), want), path


def test_constructor_checks_and_device_rule():
    """``ImageEmbedder``'s assert (a ValueError at construction here), the
    encoder's TPU-only modes, the card by default."""
    with pytest.raises(ValueError, match="divisible by the patch size"):
        CrossViT(**dict(SMALL, lg_patch_size=10), device="cpu")
    with pytest.raises(ValueError, match="TPU-only"):
        cross_vit.NormedTransformer(16, 1, 2, 8, 32, fused_mlp="interpret", device="cpu")
    assert CrossViT(**SMALL, device="cpu").sm_enc_0.fused_mlp == "auto"
    defaults = CrossViT(32, 5, 16, 24, sm_patch_size=4, device="cpu")
    assert defaults.sm_enc_0.mlp_0.dropout.p == 0.1  # vit_tpu's 0.1 dropouts
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CrossViT(**SMALL)
    assert all(p.device.type == "cpu" for p in CrossViT(**SMALL, device="cpu").parameters())
