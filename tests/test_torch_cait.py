"""CaiT in the port against ``vit_tpu`` in f32 on the CPU, on the same weights
converted from Flax (every parameter drawn with numpy from a seed: the
talking-heads mixes at unit scale, the LayerScales around 0.1).

The config: 32 px, patch 8 (16 patch tokens, no cls token among them), dim
32, depth 3, cls_depth 2, 4 heads of 8, mlp 64, 5 classes, batch 2.
``vit_tpu`` runs no Pallas kernel in CaiT, so neither does the port: one
route.  Eval logits and one SGD step of ``make_train_step`` against
``vit_tpu``'s: the loss, every gradient (the LayerScales' and the head
mixes' included) and the updated parameters, within 1e-4.  Then the
layer-dropout rule (one draw injected into both packages: all layers
dropped but the forced one, and some dropped; eval mode and a rate of 0
drop none; a training forward without a generator raises; the train step
passes its generator on),
``layer_scale_init`` at its boundaries, ``TalkingHeadsAttention`` with a
context, the converter leaf for leaf (the LayerScales as leaves of each
transformer), the constructor's checks and the device rule.
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
from vit_tpu.models import cait as jax_cait  # noqa: E402
from vit_tpu_torch import CaiT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.models import cait  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

SMALL = dict(image_size=32, patch_size=8, num_classes=5, dim=32, depth=3, cls_depth=2, heads=4,
             dim_head=8, mlp_dim=64)


@pytest.fixture(scope="module")
def jax_runs():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 3], np.int32)
    model = jax_cait.CaiT(**SMALL)
    v = random_variables(model, img, rng)
    return dict(img=img, labels=labels, variables=v,
                logits=np.asarray(jax.jit(model.apply)(v, jnp.asarray(img))),
                step=jax_sgd_step(model.apply, v, img, labels))


def test_eval_logits_match_jax(jax_runs):
    logits = port_logits(loaded(CaiT(**SMALL, device="cpu"), jax_runs["variables"]),
                         jax_runs["img"])
    assert logits.shape == (2, 5)
    assert maxdiff(logits, jax_runs["logits"]) <= TOL


def test_train_step_matches_jax(jax_runs):
    model = loaded(CaiT(**SMALL, device="cpu"), jax_runs["variables"])
    check_sgd_step(model, jax_runs["img"], jax_runs["labels"], jax_runs["step"],
                   nonzero=("cls_token", "pos_embedding", "patch_transformer.layerscale_attn_0",
                            "cls_transformer.layerscale_mlp_1",
                            "patch_transformer.layers.2.attn.mix_heads_pre_attn",
                            "cls_transformer.layers.0.attn.mix_heads_post_attn"))


# Per transformer depth: (which layers drop, the layer kept if all do).
DRAWS = {
    "all dropped": {3: ([True, True, True], 1), 2: ([True, True], 0)},
    "some dropped": {3: ([True, False, True], 2), 2: ([False, True], 0)},
}


@pytest.mark.parametrize("draws", DRAWS)
def test_layer_dropout_matches_jax_on_one_draw(jax_runs, monkeypatch, draws):
    """Training mode with ``layer_dropout=0.5`` (every other dropout 0), the
    same draw in both packages (``vit_tpu``'s ``jax.random.bernoulli`` and
    ``randint`` for the test's scope, the port's :func:`cait.layer_drop`):
    the logits within 1e-4; with every layer drawn to drop, the forced one
    survives."""
    table = DRAWS[draws]
    img, v = jax_runs["img"], jax_runs["variables"]
    cfg = dict(SMALL, layer_dropout=0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p, shape: jnp.asarray(table[shape[0]][0]))
        mp.setattr(jax.random, "randint",
                   lambda key, shape, lo, hi: jnp.asarray(table[hi][1], jnp.int32))
        want = np.asarray(jax.jit(lambda variables, x: jax_cait.CaiT(**cfg).apply(
            variables, x, training=True, rngs={"dropout": jax.random.PRNGKey(2)}))(
                v, jnp.asarray(img)))
    seen = []

    def draw(generator, depth, p):
        seen.append((depth, p))
        return torch.tensor(table[depth][0]), torch.tensor(table[depth][1])

    monkeypatch.setattr(cait, "layer_drop", draw)
    model = loaded(CaiT(**cfg, device="cpu"), v).train()
    with torch.no_grad():
        got = model(torch.from_numpy(img), generator=torch.Generator())
    assert seen == [(3, 0.5), (2, 0.5)]
    assert maxdiff(got, want) <= TOL
    # both draws keep only layer 1 of the patch transformer: forced, or drawn
    assert model.patch_transformer.keep(torch.zeros(1), torch.Generator()).tolist() == \
        [0.0, 1.0, 0.0]


def test_layer_dropout_draws_only_in_training_and_needs_a_generator():
    """Eval mode and a rate of 0 keep every layer (no draw); a training
    forward with a rate above 0 and no generator raises; a seeded generator
    gives the same forward twice."""
    img = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    model = CaiT(**SMALL, layer_dropout=0.5, device="cpu",
                 generator=torch.Generator().manual_seed(4))
    assert model.eval().patch_transformer.keep(img, None) is None
    assert CaiT(**SMALL, device="cpu").train().patch_transformer.keep(img, None) is None
    with pytest.raises(ValueError, match="explicit generator"):
        model.train()(img)
    with torch.no_grad():
        a = model(img, generator=torch.Generator().manual_seed(5))
        b = model(img, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    drop, forced = cait.layer_drop(torch.Generator().manual_seed(6), 1000, 0.25)
    assert drop.shape == (1000,) and drop.dtype == torch.bool and 0 <= int(forced) < 1000
    assert 0.2 < drop.float().mean().item() < 0.3


def test_train_step_passes_its_generator_to_layer_dropout():
    """``make_train_step``'s ``step(images, labels, generator=g)`` gives the
    forward its generator: with ``layer_dropout=0.5`` a step from one seed
    on one set of weights is the same twice, and one without a generator
    raises; with ``accum_steps=2`` the microbatches draw from it in turn (one
    draw each, as many as two single-batch steps make)."""
    g = torch.Generator().manual_seed(11)
    images = torch.randn(4, 32, 32, 3, generator=g)
    labels = torch.tensor([0, 1, 2, 3])
    cfg = dict(SMALL, layer_dropout=0.5)
    start = CaiT(**cfg, device="cpu", generator=g).state_dict()

    def stepped(seed, accum_steps=1, draws=None):
        model = CaiT(**cfg, device="cpu")
        model.load_state_dict(start)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                               accum_steps=accum_steps)
        gen = torch.Generator().manual_seed(seed)
        loss = step(images, labels, generator=gen)["loss"]
        if draws is not None:
            draws.append(torch.rand(1, generator=gen))
        return loss, model.state_dict()

    (a, wa), (b, wb) = stepped(12), stepped(12)
    assert torch.equal(a, b) and all(torch.equal(wa[k], wb[k]) for k in wa)
    model = CaiT(**cfg, device="cpu")
    with pytest.raises(ValueError, match="explicit generator"):
        make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))(images, labels)
    after = []
    stepped(13, accum_steps=2, draws=after)
    gen = torch.Generator().manual_seed(13)
    for _ in range(2):  # two forwards' draws: each transformer's layer_drop
        for depth in (SMALL["depth"], SMALL["cls_depth"]):
            cait.layer_drop(gen, depth, 0.5)
    assert torch.equal(after[0], torch.rand(1, generator=gen))


@pytest.mark.parametrize("depth", [1, 18, 19, 24, 25, 36])
def test_layer_scale_init_matches_jax(depth):
    """0.1 up to depth 18, 1e-5 up to 24, 1e-6 past it; each transformer's
    LayerScales start at their layer's value, in both packages."""
    assert cait.layer_scale_init(depth) == jax_cait.layer_scale_init(depth)
    assert cait.layer_scale_init(depth) == (0.1 if depth <= 18 else 1e-5 if depth <= 24
                                            else 1e-6)


def test_layer_scales_start_at_their_depths_value():
    """Layer i's two LayerScales start at ``layer_scale_init(i + 1)``, as
    ``vit_tpu``'s ``CaiTTransformer`` initialises them."""
    block = cait.CaiTTransformer(8, 25, 2, 4, 16, device="cpu")
    for i, value in ((0, 0.1), (17, 0.1), (18, 1e-5), (23, 1e-5), (24, 1e-6)):
        for branch in ("attn", "mlp"):
            got = getattr(block, f"layerscale_{branch}_{i}")
            assert got.shape == (1, 1, 8) and got.dtype == torch.float32
            assert torch.equal(got, torch.full((1, 1, 8), value))


def test_talking_heads_attention_with_a_context_matches_jax():
    """``TalkingHeadsAttention(16, 4 heads of 4)``: one cls query over itself
    and 7 context tokens, within 1e-5 of ``vit_tpu``'s."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 16)).astype(np.float32)
    module = jax_cait.TalkingHeadsAttention(16, heads=4, dim_head=4)
    shapes = jax.eval_shape(lambda a, c: module.init(jax.random.PRNGKey(0), a, c),
                            jnp.asarray(x), jnp.asarray(ctx))
    v = jax.tree_util.tree_map_with_path(
        lambda path, s: rng.standard_normal(s.shape).astype(np.float32) * 0.5, shapes)
    want = np.asarray(module.apply(v, jnp.asarray(x), jnp.asarray(ctx)))
    port = loaded(cait.TalkingHeadsAttention(16, 4, 4, device="cpu"), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ctx))
    assert got.shape == (2, 1, 16) and maxdiff(got, want) <= 1e-5


def test_converter_carries_the_cait_tree(jax_runs):
    """``patch_transformer`` and ``cls_transformer`` are stacks
    (``layers.{i}``); their LayerScales stay leaves of the transformer; the
    head mixes as they are; ``to_out`` as ``to_out.0``."""
    v = jax_runs["variables"]
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    converted = state_dict_from_flax(v)
    model = CaiT(**SMALL, device="cpu")
    assert set(converted) == set(model.state_dict()) and len(converted) == len(flat)
    for path, key, perm in (
            ("params/patch_transformer/layerscale_attn_2", "patch_transformer.layerscale_attn_2",
             None),
            ("params/cls_transformer/layerscale_mlp_0", "cls_transformer.layerscale_mlp_0", None),
            ("params/patch_transformer/attn_1/mix_heads_pre_attn",
             "patch_transformer.layers.1.attn.mix_heads_pre_attn", None),
            ("params/cls_transformer/attn_1/to_kv/kernel",
             "cls_transformer.layers.1.attn.to_kv.weight", (1, 0)),
            ("params/cls_transformer/attn_0/to_out/bias",
             "cls_transformer.layers.0.attn.to_out.0.bias", None),
            ("params/patch_transformer/mlp_norm_2/scale",
             "patch_transformer.layers.2.mlp_norm.weight", None),
            ("params/pos_embedding", "pos_embedding", None)):
        want = flat[path].transpose(perm) if perm else flat[path]
        assert np.array_equal(converted[key].numpy(), want), path
    assert converted["pos_embedding"].shape == (1, 16, 32)


def test_constructor_checks_and_device_rule():
    with pytest.raises(ValueError, match="divisible by the patch size"):
        CaiT(**dict(SMALL, patch_size=5), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CaiT(**SMALL)
    assert all(p.device.type == "cpu" for p in CaiT(**SMALL, device="cpu").parameters())


def test_bf16_gradient_stays_near_vit_tpus(jax_runs):
    """The step-1 gradient in bf16 compute (f32 parameters) against the f32
    one, relative L2 over every parameter: the port's at most twice
    ``vit_tpu``'s, on the same weights and images (the rounding points of
    the talking heads and the LayerScales as ``vit_tpu`` places them;
    ``vit_tpu``'s gradient jitted, as its train step runs)."""
    import optax
    import torch.nn.functional as F

    img, labels, variables = jax_runs["img"], jax_runs["labels"], jax_runs["variables"]
    names = [k for k, _ in CaiT(**SMALL, device="cpu").named_parameters()]

    def port(dtype):
        model = loaded(CaiT(**SMALL, device="cpu", compute_dtype=dtype), variables).train()
        F.cross_entropy(model(torch.from_numpy(img)).float(),
                        torch.from_numpy(labels).long()).backward()
        grads = dict(model.named_parameters())
        return torch.cat([grads[k].grad.flatten() for k in names]).double()

    def vit_tpu(dtype):
        model = jax_cait.CaiT(**SMALL, dtype=dtype)

        def loss(params):
            logits = model.apply({"params": params}, jnp.asarray(img)).astype(jnp.float32)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels)).mean()

        grads = state_dict_from_flax(jax.tree.map(np.asarray,
                                                  jax.jit(jax.grad(loss))(variables["params"])))
        return torch.cat([torch.as_tensor(np.asarray(grads[k])).flatten() for k in names]).double()

    def rel_l2(a, ref):
        return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref))

    ours = rel_l2(port(torch.bfloat16), port(torch.float32))
    theirs = rel_l2(vit_tpu(jnp.bfloat16), vit_tpu(jnp.float32))
    assert 0 < theirs and ours <= 2 * theirs, (ours, theirs)
