"""ATS-ViT in the port against ``vit_tpu`` in f32 on the CPU, on the same
weights converted from Flax (every parameter drawn with numpy from a seed)
and the same Gumbel noise: one table a shape, injected into
``vit_tpu.models.ats_vit.sample_gumbel`` and the port's ``sample_gumbel``,
as ``tests/parity/test_ats_parity.py`` injects it against TF.

The config is that file's: 64 px, patch 8 (64 patches and the cls token),
dim 64, depth 3, tokens (32, 16, 8), 2 heads of 32, mlp 128, 13 classes,
batch 2.  Two routes:

- ``never``: ``fused_mlp="never"`` on both sides (``vit_tpu``'s default);
- ``kernels``: the port's fused-MLP route with the 16-bit CUDA gate opened on
  the CPU (``kernel_activation`` patched in ``vit_tpu_torch.layers.common``),
  where the op runs its plain version, against ``vit_tpu``'s
  ``fused_mlp="interpret"``.  The calls into the op are counted: one a layer
  a forward, at 33, 17 and 9 tokens (every layer samples).

Eval logits within 1e-4 and the sampled ids exactly equal, and one SGD step
of ``make_train_step`` (given a generator) against ``vit_tpu``'s: the loss,
every gradient and the updated parameters within 1e-4.  Then
``adaptive_token_sampling`` and ``ATSAttention`` alone (duplicate draws, a
pre-masked input, fully masked rows), the constructor's checks, the
no-generator rule, the converter leaf for leaf and the device rule.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import (  # noqa: E402
    TOL, check_sgd_step, jax_sgd_step, loaded, maxdiff, open_kernel_gate, random_variables,
)
from vit_tpu.models import ats_vit as jax_ats  # noqa: E402
from vit_tpu_torch import state_dict_from_flax  # noqa: E402
from vit_tpu_torch.models import ats_vit  # noqa: E402

SMALL = dict(image_size=64, patch_size=8, num_classes=13, dim=64, depth=3,
             max_tokens_per_depth=(32, 16, 8), heads=2, mlp_dim=128, dim_head=32)
ROUTES = {"never": "never", "kernels": "interpret"}
TOKENS = [33, 17, 9]


def gumbel_table(shape) -> np.ndarray:
    """One Gumbel table for each shape ``(b, k, n)``, from a seed the shape
    gives."""
    b, k, n = (int(s) for s in shape)
    u = np.random.default_rng(1_000_000 * b + 1000 * k + n).uniform(1e-3, 1 - 1e-3, (b, k, n))
    return (-np.log(-np.log(u + 1e-6) + 1e-6)).astype(np.float32)


def jax_noise(mp):
    mp.setattr(jax_ats, "sample_gumbel",
               lambda key, shape, eps=1e-6: jnp.asarray(gumbel_table(shape)))


@pytest.fixture
def port_noise(monkeypatch):
    monkeypatch.setattr(ats_vit, "sample_gumbel",
                        lambda generator, shape, eps=1e-6: torch.from_numpy(gumbel_table(shape)))


@pytest.fixture(scope="module")
def jax_runs():
    """Per route: ``vit_tpu``'s eval logits and sampled ids, and one SGD
    step, on one set of variables and the injected noise."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 11], np.int32)
    v = random_variables(jax_ats.ViT(**SMALL), img, rng)
    out = dict(img=img, labels=labels, variables=v, runs={})
    with pytest.MonkeyPatch.context() as mp:
        jax_noise(mp)
        for route, mode in ROUTES.items():
            model = jax_ats.ViT(**SMALL, fused_mlp=mode)
            logits, ids = jax.jit(lambda variables, x, m=model: m.apply(
                variables, x, return_sampled_token_ids=True))(v, jnp.asarray(img))
            out["runs"][route] = dict(logits=np.asarray(logits), ids=np.asarray(ids),
                                      step=jax_sgd_step(model.apply, v, img, labels))
    return out


def _port(variables, route, monkeypatch, calls):
    if route == "kernels":
        open_kernel_gate(monkeypatch, calls)
    mode = "auto" if route == "kernels" else "never"
    return loaded(ats_vit.ViT(**SMALL, fused_mlp=mode, device="cpu"), variables)


@pytest.mark.parametrize("route", ROUTES)
def test_eval_logits_and_sampled_ids_match_jax(jax_runs, monkeypatch, port_noise, route):
    calls = []
    model = _port(jax_runs["variables"], route, monkeypatch, calls).eval()
    with torch.no_grad():
        logits, ids = model(torch.from_numpy(jax_runs["img"]), return_sampled_token_ids=True,
                            generator=torch.Generator().manual_seed(0))
    want = jax_runs["runs"][route]
    assert calls == (TOKENS if route == "kernels" else [])
    assert ids.shape == (2, 8) and ids.dtype == torch.int64
    assert np.array_equal(ids.numpy(), want["ids"])
    assert logits.shape == (2, 13) and maxdiff(logits, want["logits"]) <= TOL


@pytest.mark.parametrize("route", ROUTES)
def test_train_step_matches_jax(jax_runs, monkeypatch, port_noise, route):
    """One SGD step of ``make_train_step(...)(images, labels,
    generator=g)``: the loss, every gradient (the tokens', the attentions'
    and the head's) and the updated parameters."""
    calls = []
    model = _port(jax_runs["variables"], route, monkeypatch, calls)
    check_sgd_step(model, jax_runs["img"], jax_runs["labels"], jax_runs["runs"][route]["step"],
                   nonzero=("cls_token", "pos_embedding", "transformer.layers.0.attn.to_qkv.weight",
                            "transformer.layers.2.mlp.fc1.weight"),
                   generator=torch.Generator().manual_seed(1))
    assert calls == (TOKENS if route == "kernels" else [])


def _sampling_inputs():
    """Two rows of 9 tokens, 2 heads of 4: the attention of a random
    softmax, the second row with tokens 3, 5 and 8 already padding (its mask
    False, their attention 0); noise of which six of the seven draws of row
    0 and five of row 1 pick one token, so the dedup has duplicates to
    zero."""
    rng = np.random.default_rng(4)
    b, h, n, k = 2, 2, 9, 7
    logits = rng.standard_normal((b, h, n, n)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, [3, 5, 8]] = False
    logits[1][..., ~mask[1]] = -np.inf
    attn = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (attn / attn.sum(-1, keepdims=True)).astype(np.float32)
    value = rng.standard_normal((b, h, n, 4)).astype(np.float32)
    noise = rng.gumbel(size=(b, k, n - 1)).astype(np.float32)
    noise[0, :6, 4] += 50.0   # token 5 six times
    noise[1, 1:6, 1] += 50.0  # token 2 five times
    noise[1, 0, 4] += 50.0    # token 5 of row 1: padding, never drawn over a live one
    return attn, value, mask, k, noise


def test_adaptive_token_sampling_matches_jax(monkeypatch):
    """``adaptive_token_sampling`` alone on a draw with duplicates and a
    pre-masked input: the ids and the mask exactly ``vit_tpu``'s, the
    gathered attention rows within 1e-6; the padding slots lead, the unique
    ids follow in ascending order."""
    attn, value, mask, k, noise = _sampling_inputs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ats, "sample_gumbel", lambda key, shape, eps=1e-6: jnp.asarray(noise))
        want = [np.asarray(t) for t in jax_ats.adaptive_token_sampling(
            jnp.asarray(attn), jnp.asarray(value), jnp.asarray(mask), k, jax.random.PRNGKey(0))]
    monkeypatch.setattr(ats_vit, "sample_gumbel",
                        lambda generator, shape, eps=1e-6: torch.from_numpy(noise))
    got = [t.numpy() for t in ats_vit.adaptive_token_sampling(
        torch.from_numpy(attn), torch.from_numpy(value), torch.from_numpy(mask), k,
        torch.Generator())]
    assert got[1].dtype == np.bool_ and got[2].dtype == np.int64
    assert np.array_equal(got[2], want[2]) and np.array_equal(got[1], want[1])
    assert got[0].shape == (2, 2, k + 1, 9) and maxdiff(got[0], want[0]) <= 1e-6
    ids, new_mask = got[2], got[1]
    for row, keep in zip(ids, new_mask):
        live = row[keep][1:]
        assert row[0] == 0 and np.all(np.diff(live) > 0)
        assert np.all(row[1:][~keep[1:]] == 0) and np.all(np.diff(keep[1:].astype(int)) >= 0)
    assert (~new_mask[0]).sum() >= 5 and (~new_mask[1]).sum() >= 4  # the duplicates dropped
    assert not set(ids[1][new_mask[1]]) & {3, 5, 8}  # padding is never sampled


@pytest.mark.parametrize("sample", [False, True], ids=["keeps", "samples"])
def test_ats_attention_with_padding_matches_jax(monkeypatch, sample):
    """``ATSAttention`` (dim 16, 2 heads of 8) over 9 tokens of which 3 are
    padding: their query rows are fully masked and come out uniform in both
    packages; with ``output_num_tokens=5`` it samples on the injected noise.
    The output within 1e-5, the mask and ids exactly."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[1, [3, 5, 8]] = False
    tokens = 5 if sample else None
    module = jax_ats.ATSAttention(16, heads=2, dim_head=8, output_num_tokens=tokens)
    v = random_variables(module, x, rng, mask=jnp.asarray(mask))
    with pytest.MonkeyPatch.context() as mp:
        jax_noise(mp)
        want = module.apply(v, jnp.asarray(x), mask=jnp.asarray(mask))
    monkeypatch.setattr(ats_vit, "sample_gumbel",
                        lambda generator, shape, eps=1e-6: torch.from_numpy(gumbel_table(shape)))
    port = loaded(ats_vit.ATSAttention(16, 2, 8, output_num_tokens=tokens, device="cpu"), v)
    with torch.no_grad():
        out, new_mask, ids = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert maxdiff(out, want[0]) <= 1e-5
    assert np.array_equal(new_mask.numpy(), np.asarray(want[1]))
    if sample:
        assert ids.shape == (2, 6) and np.array_equal(ids.numpy(), np.asarray(want[2]))
    else:
        assert ids is None and want[2] is None
    # A fully masked row is a uniform softmax in the port too.
    q = torch.zeros(1, 1, 3, 4)
    none = torch.zeros(1, 1, 3, 3, dtype=torch.bool)
    from vit_tpu_torch.ops.attention import attention_weights
    assert torch.equal(attention_weights(q, q, mask=none), torch.full((1, 1, 3, 3), 1 / 3))


@pytest.mark.parametrize("bad, match", [
    (dict(max_tokens_per_depth=(32, 16)), "length that is equal to the depth"),
    (dict(max_tokens_per_depth=(16, 32, 8)), "decreasing order"),
    (dict(max_tokens_per_depth=(32, 16, 0)), "at least 1 token"),
    (dict(image_size=60), "divisible by the patch size"),
], ids=["length", "order", "zero", "patch"])
def test_constructor_checks_raise_value_errors(bad, match):
    """``vit_tpu``'s asserts as ``ValueError`` s, which hold under ``python -O``."""
    with pytest.raises(ValueError, match=match):
        ats_vit.ViT(**{**SMALL, **bad}, device="cpu")


def test_forward_draws_from_its_generator_or_seed_zero():
    """Two eval forwards without a generator are equal (each sampling layer
    draws from a generator seeded 0, as ``vit_tpu``'s take ``PRNGKey(0)``); a
    generator's draws decide the sampled ids; a training forward with
    dropout and no generator raises."""
    g = torch.Generator().manual_seed(2)
    model = ats_vit.ViT(**SMALL, device="cpu", generator=g).eval()
    img = torch.randn(2, 64, 64, 3, generator=g)
    with torch.no_grad():
        a, ids_a = model(img, return_sampled_token_ids=True)
        b, ids_b = model(img, return_sampled_token_ids=True)
        d = [model(img, return_sampled_token_ids=True,
                   generator=torch.Generator().manual_seed(s))[1] for s in (1, 2, 3)]
    assert torch.equal(a, b) and torch.equal(ids_a, ids_b)
    assert any(not torch.equal(ids_a, ids) for ids in d)
    for row in ids_a:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live) and int(row.max()) < 64
    dropped = ats_vit.ViT(**SMALL, dropout=0.1, device="cpu").train()
    with pytest.raises(ValueError, match="explicit generator"):
        dropped(img)
    out = dropped(img, generator=torch.Generator().manual_seed(4))
    assert out.shape == (2, 13) and bool(torch.isfinite(out).all())


def test_converter_carries_the_ats_tree(jax_runs):
    """Leaf for leaf: ``transformer`` is a stack (``layers.{i}``), ``to_out``
    as ``to_out.0``, the tokens as they are; loaded strictly."""
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    model = ats_vit.ViT(**SMALL, device="cpu")
    converted = state_dict_from_flax(v)
    assert set(converted) == set(model.state_dict()) and len(converted) == len(flat)
    model.load_state_dict(converted, strict=True)
    names = {
        "params/transformer/attn_2/to_qkv/kernel": ("transformer.layers.2.attn.to_qkv.weight",
                                                    (1, 0)),
        "params/transformer/attn_0/to_out/bias": ("transformer.layers.0.attn.to_out.0.bias", None),
        "params/transformer/attn_norm_1/scale": ("transformer.layers.1.attn_norm.weight", None),
        "params/transformer/mlp_norm_0/bias": ("transformer.layers.0.mlp_norm.bias", None),
        "params/transformer/mlp_1/fc2/kernel": ("transformer.layers.1.mlp.fc2.weight", (1, 0)),
        "params/patch_embedding/kernel": ("patch_embedding.weight", (1, 0)),
        "params/cls_token": ("cls_token", None),
        "params/pos_embedding": ("pos_embedding", None),
        "params/head_norm/scale": ("head_norm.weight", None),
        "params/head/bias": ("head.bias", None),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path]
        assert np.array_equal(converted[key].numpy(), want), path
    assert converted["pos_embedding"].shape == (1, 65, 64)


def test_device_rule_and_modes():
    """The card by default: without CUDA the constructor raises unless
    ``device="cpu"``; ``fused_mlp`` defaults to ``"never"`` and refuses the
    TPU-only modes."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ats_vit.ViT(**SMALL)
    model = ats_vit.ViT(**SMALL, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert model.transformer.fused_mlp == "never"
    with pytest.raises(ValueError, match="TPU-only"):
        ats_vit.ViT(**SMALL, fused_mlp="interpret", device="cpu")
