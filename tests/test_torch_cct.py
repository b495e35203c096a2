"""CCT in the port against ``vit_tpu`` in f32 on the CPU, on the same weights
converted from Flax (every parameter drawn with numpy from a seed).

The config: 32 px, embedding 32, 2 conv layers of kernel 3 at stride 1 (8
then 32 channels; 32 → 16 → 8 px, 64 tokens), 2 layers, 2 heads, mlp_ratio
2, 5 classes, batch 2.  ``vit_tpu`` runs no Pallas kernel in CCT, so neither
does the port: one route.  Eval logits within 1e-4 in every positional mode
(``learnable``, ``sine``, ``none``) with sequence pooling and with the cls
token, and at 224 and 33 px through a 7 x 7, stride-2 tokenizer (TF-SAME's
odd pads after); one SGD step of ``make_train_step`` at rates 0 against
``vit_tpu``'s (loss, every gradient, the updated parameters); one training
forward at rates 0.1 with the same dropout and stochastic-depth masks
injected into both packages (``jax.random.bernoulli`` for the test's scope,
the port's ``layers.common.dropout_mask``), call for call.  Then the train
step's generator at CCT's default rates, ``sequence_length``, the factories,
the legacy keywords, the sine table (a non-persistent buffer), the converter
leaf for leaf and the device rule.
"""

import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import (  # noqa: E402
    TOL, check_sgd_step, jax_sgd_step, loaded, maxdiff, port_logits, random_variables,
)
from vit_tpu.models import cct as jax_cct  # noqa: E402
from vit_tpu_torch import state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.models import cct  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

SMALL = dict(img_size=32, embedding_dim=32, n_conv_layers=2, kernel_size=3, stride=1,
             in_planes=8, num_layers=2, num_heads=2, mlp_ratio=2.0, num_classes=5)
NO_DRAWS = dict(attention_dropout=0.0, stochastic_depth_rate=0.0)
RATES = dict(dropout_rate=0.1, attention_dropout=0.1, stochastic_depth_rate=0.1)


def _images(size, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


def _variables(cfg, img, seed=1):
    return random_variables(jax_cct.CCT(**cfg), img, np.random.default_rng(seed))


def _jax_logits(cfg, v, img):
    return np.asarray(jax.jit(jax_cct.CCT(**cfg).apply)(v, jnp.asarray(img)))


@pytest.mark.parametrize("seq_pool", [True, False], ids=["seq_pool", "cls"])
@pytest.mark.parametrize("pos", ["learnable", "sine", "none"])
def test_eval_logits_match_jax(pos, seq_pool):
    cfg = dict(SMALL, positional_embedding=pos, seq_pool=seq_pool)
    img = _images(32)
    v = _variables(cfg, img)
    model = loaded(cct.CCT(**cfg, device="cpu"), v)
    logits = port_logits(model, img)
    assert logits.shape == (2, 5)
    assert maxdiff(logits, _jax_logits(cfg, v, img)) <= TOL


@pytest.mark.parametrize("size", [224, 33])
def test_strided_tokenizer_at_an_even_and_an_odd_size_matches_jax(size):
    """A 7 x 7, stride-2 tokenizer of two layers (8 then 16 channels): at 224
    px the convolutions pad (2, 3) and the pools (0, 1) at 112 and 28 (196
    tokens); at 33 px the pads fall elsewhere (9 tokens).  One encoder layer;
    the eval logits within 1e-4."""
    cfg = dict(SMALL, img_size=size, embedding_dim=16, kernel_size=7, stride=2, num_layers=1,
               positional_embedding="learnable")
    img = _images(size, batch=1)
    v = _variables(cfg, img)
    model = loaded(cct.CCT(**cfg, device="cpu"), v)
    assert maxdiff(port_logits(model, img), _jax_logits(cfg, v, img)) <= TOL
    tokens = model.tokens(torch.from_numpy(img))
    assert tokens.shape == (1, model.sequence_length(3, size, size), 16)


@pytest.mark.parametrize("pos, seq_pool", [("learnable", True), ("sine", False)],
                         ids=["learnable-seq_pool", "sine-cls"])
def test_train_step_at_rates_zero_matches_jax(pos, seq_pool):
    """One SGD step: the loss, every gradient (the positions', the cls
    token's, the pool's and the convolutions' included) and the updated
    parameters."""
    cfg = dict(SMALL, **NO_DRAWS, positional_embedding=pos, seq_pool=seq_pool)
    img, labels = _images(32), np.array([1, 4], np.int32)
    v = _variables(cfg, img)
    want = jax_sgd_step(jax_cct.CCT(**cfg).apply, v, img, labels)
    model = loaded(cct.CCT(**cfg, device="cpu"), v)
    nonzero = ["conv_0.weight", "conv_1.weight", "block_1.self_attn.to_qkv.weight",
               "block_0.linear1.weight"]
    nonzero += ["positional_emb", "attention_pool.weight"] if seq_pool else ["class_emb"]
    check_sgd_step(model, img, labels, want, nonzero=nonzero,
                   generator=torch.Generator().manual_seed(0))


def test_training_forward_with_injected_draws_matches_jax(monkeypatch):
    """Training mode at dropout, attention dropout and stochastic depth 0.1:
    the i-th mask drawn (numpy, from seed i) goes to the i-th draw of both
    packages, whose shapes and keep rates must agree call for call (the
    embedding dropout, then per layer the attention matrix's, the
    projection's, the attention branch's stochastic depth, the feed-forward's
    two and its stochastic depth; layer 0's stochastic depth is 0 and draws
    nothing); the logits within 1e-4."""
    cfg = dict(SMALL, **RATES, positional_embedding="learnable")
    img = _images(32)
    v = _variables(cfg, img)

    def mask(i, shape, keep):
        return np.random.default_rng(100 + i).random(tuple(int(s) for s in shape)) < keep

    jax_draws, port_draws = [], []

    def jax_bernoulli(key, p=0.5, shape=None):
        jax_draws.append((tuple(int(s) for s in shape), float(p)))
        return jnp.asarray(mask(len(jax_draws) - 1, shape, p))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", jax_bernoulli)
        want = np.asarray(jax.jit(lambda variables, x: jax_cct.CCT(**cfg).apply(
            variables, x, training=True, rngs={"dropout": jax.random.PRNGKey(3)}))(
                v, jnp.asarray(img)))

    def port_mask(generator, shape, keep):
        port_draws.append((tuple(int(s) for s in shape), float(keep)))
        return torch.from_numpy(mask(len(port_draws) - 1, shape, keep))

    monkeypatch.setattr(common, "dropout_mask", port_mask)
    model = loaded(cct.CCT(**cfg, device="cpu"), v).train()
    with torch.no_grad():
        got = model(torch.from_numpy(img), generator=torch.Generator())
    assert port_draws == pytest.approx(jax_draws)
    assert len(port_draws) == 1 + 4 + 6  # the embedding, layer 0 (no drop path), layer 1
    assert maxdiff(got, want) <= TOL


def test_train_step_takes_the_forward_generator_at_the_default_rates():
    """At CCT's defaults (attention dropout and stochastic depth 0.1)
    ``make_train_step``'s step draws from the generator it is given: two
    steps from one seed on one set of weights are identical, another seed's
    masks give another loss, and a step without a generator raises.  With ``accum_steps=2`` the microbatches draw in turn."""
    g = torch.Generator().manual_seed(5)
    images = torch.randn(4, 32, 32, 3, generator=g)
    labels = torch.tensor([0, 1, 2, 3])
    start = cct.CCT(**SMALL, device="cpu", generator=g).state_dict()

    def trained(accum_steps=1, seed=7):
        model = cct.CCT(**SMALL, device="cpu")
        model.load_state_dict(start)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                               accum_steps=accum_steps)
        loss = step(images, labels, generator=torch.Generator().manual_seed(seed))["loss"]
        return loss, model.state_dict()

    (a, wa), (b, wb), (c, _) = trained(), trained(), trained(seed=8)
    assert torch.equal(a, b) and all(torch.equal(wa[k], wb[k]) for k in wa)
    assert not torch.equal(a, c)
    model = cct.CCT(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="explicit generator"):
        make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1))(images, labels)
    d, _ = trained(accum_steps=2)
    assert torch.isfinite(d) and not torch.equal(a, d)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("stride", [1, 2])
def test_sequence_length_is_the_tokenizers(size, stride):
    cfg = dict(SMALL, img_size=size, stride=stride)
    model = cct.CCT(**cfg, device="cpu")
    tokens = model.tokens(torch.zeros(1, size, size, 3))
    assert tokens.shape[1] == model.sequence_length(3, size, size) == \
        jax_cct.CCT(**cfg).sequence_length(3, size, size)
    assert model.sequence_length(3, 224, 224) == jax_cct.CCT(**cfg).sequence_length(3, 224, 224)


FACTORIES = ["cct_2", "cct_4", "cct_6", "cct_7", "cct_8", "cct_14", "cct_16"]


@pytest.mark.parametrize("name", FACTORIES)
def test_factories_match_jax(name):
    """Each factory's settings, the stride default ``max(1, k // 2 - 1)``
    included, are ``vit_tpu``'s: the same parameter shapes at 32 px."""
    kw = dict(img_size=32, num_classes=5, positional_embedding="learnable", kernel_size=7)
    jax_model = getattr(jax_cct, name)(**kw)
    port = getattr(cct, name)(**kw, device="cpu")
    assert port.stride == jax_model.stride == 2
    shapes = jax.eval_shape(lambda a: jax_model.init(jax.random.PRNGKey(0), a),
                            jnp.zeros((1, 32, 32, 3)))
    converted = state_dict_from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                                  shapes))
    assert {k: tuple(t.shape) for k, t in converted.items()} == \
        {k: tuple(t.shape) for k, t in port.state_dict().items()}
    assert getattr(cct, name)(img_size=32, kernel_size=3, device="cpu").stride == 1


def test_legacy_keywords_warn_and_unknown_ones_raise():
    with pytest.warns(UserWarning, match="legacy kwarg 'padding'"):
        cct.cct_2(img_size=32, num_classes=5, padding=3, device="cpu")
    with pytest.warns(UserWarning, match="legacy kwarg 'mlp_radio'"):
        cct.CCT(**SMALL, mlp_radio=2.0, pooling_padding=None, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cct.CCT(**SMALL, pooling_padding=None, device="cpu")  # None is not a use
    with pytest.raises(TypeError, match="unexpected keyword argument 'pooling'"):
        cct.CCT(**SMALL, pooling=1, device="cpu")


def test_sine_table_matches_jax_and_is_not_a_parameter():
    """The table equals ``vit_tpu``'s; it is a non-persistent buffer, so a
    converted Flax tree (which holds it as a constant) loads strictly."""
    assert np.array_equal(cct.sinusoidal_embedding(7, 10), jax_cct.sinusoidal_embedding(7, 10))
    model = cct.CCT(**dict(SMALL, positional_embedding="sine"), device="cpu")
    assert "positional_emb" not in model.state_dict()
    assert "positional_emb" not in dict(model.named_parameters())
    assert np.array_equal(model.positional_emb.numpy(), jax_cct.sinusoidal_embedding(64, 32))
    other = cct.CCT(**dict(SMALL, positional_embedding="cosine"), device="cpu")  # any other: sine
    assert other.pos_mode == "sine" and other.positional_emb.shape == (1, 64, 32)


def test_converter_carries_the_cct_tree():
    """Leaf for leaf: ``conv_{i}``, ``block_{i}`` and their children keep
    their names, ``positional_emb`` and ``class_emb`` as they are; loaded
    strictly."""
    cfg = dict(SMALL, positional_embedding="learnable", seq_pool=False)
    v = _variables(cfg, _images(32))
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(v)}
    model = cct.CCT(**cfg, device="cpu")
    converted = state_dict_from_flax(v)
    assert set(converted) == set(model.state_dict()) and len(converted) == len(flat)
    model.load_state_dict(converted, strict=True)
    names = {
        "params/conv_0/kernel": ("conv_0.weight", (3, 2, 0, 1)),
        "params/block_1/self_attn/to_qkv/kernel": ("block_1.self_attn.to_qkv.weight", (1, 0)),
        "params/block_0/self_attn/proj/bias": ("block_0.self_attn.proj.bias", None),
        "params/block_1/norm1/scale": ("block_1.norm1.weight", None),
        "params/block_0/linear2/kernel": ("block_0.linear2.weight", (1, 0)),
        "params/norm/bias": ("norm.bias", None),
        "params/positional_emb": ("positional_emb", None),
        "params/class_emb": ("class_emb", None),
        "params/fc/kernel": ("fc.weight", (1, 0)),
    }
    for path, (key, perm) in names.items():
        want = flat[path].transpose(perm) if perm else flat[path]
        assert np.array_equal(converted[key].numpy(), want), path
    assert converted["positional_emb"].shape == (1, 65, 32)


def test_device_rule():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cct.CCT(**SMALL)
    model = cct.CCT(**SMALL, device="cpu")
    assert all(t.device.type == "cpu" for t in [*model.parameters(), *model.buffers()])
