"""The small-dataset ViT's path: the biased attention block, SPT, LSA and the
whole ``vit_for_small_dataset.ViT`` of the port against ``vit_tpu``, in f32
on the CPU.

- The op: ``fused_attention_block_bias`` forward and VJP against JAX's
  Pallas kernel in interpret mode, and the backward kernel's outputs (dbias
  included) against ``_backward(..., bias=)``, for a shared and a per-head
  bias, at n = 49 and n = 65 (≡ 1 mod 64: a last key tile with one key).
  Within 1e-5 of max|JAX|, the JAX kernels' own bar.
- SPT's convolution form against JAX's ``_spt_conv`` and the port's eager SPT
  (1e-5); the fused LSA block against JAX's eager LSA block (1e-4); the whole
  model, logits and every gradient, temperature included, against
  ``vit_tpu``'s ``fused_attention="never"`` model with the converted weights
  (1e-4), through the port's plain LSA and through its kernel route (the
  dispatch gate opened on the CPU, where the ops run their plain versions).
  JAX's interpret tier routes LSA to its kernel only at n ≥ 128
  (``vit_tpu/layers/common.py:279-281``), so at these small n the op is held
  against the JAX op directly, and the model against JAX's eager model.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_tpu.layers.common import LayerNorm as JaxLayerNorm  # noqa: E402
from vit_tpu.models import vit_for_small_dataset as jax_sd  # noqa: E402
from vit_tpu.ops import fused_attention_block as jax_attn  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.layers.common import LayerNorm  # noqa: E402
from vit_tpu_torch.models import vit_for_small_dataset as sd  # noqa: E402
from vit_tpu_torch.ops.fused_attention_block import (  # noqa: E402
    attention_lse_reference, attention_route, fused_attention_block,
    fused_attention_block_backward_reference, fused_attention_block_bias,
    fused_attention_block_bias_backward, fused_attention_block_forward_reference,
    fused_attention_block_short_backward_reference,
    fused_attention_block_short_forward_reference,
)
from vit_tpu_torch.parallel.train import cross_entropy_loss, make_train_step  # noqa: E402

TOL_OP = 1e-5
TOL = 1e-4
HEADS, DH = 2, 32
SMALL = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2,
             dim_head=32, mlp_dim=128)  # n = 17


def _f32(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(np.asarray(got) - want)) / (np.max(np.abs(want)) + 1e-12)


def _block_args(n, hb, b=2, d=64, seed=0):
    """Flax-layout block inputs, a (hb, n, n) bias and a cotangent."""
    rng = np.random.default_rng(seed)
    inner = HEADS * DH
    args = (_f32(rng, b, n, d), _f32(rng, d, scale=0.1, shift=1.0), _f32(rng, d, scale=0.1),
            _f32(rng, d, 3 * inner, scale=0.05), _f32(rng, inner, d, scale=0.05),
            _f32(rng, d, scale=0.05))
    return args, _f32(rng, hb, n, n, scale=0.3), _f32(rng, b, n, d)


def _torch_layout(args):
    """Flax Dense kernels (in, out) → nn.Linear weights (out, in)."""
    return [torch.from_numpy(a.T.copy() if i in (3, 4) else a) for i, a in enumerate(args)]


BIAS_CASES = [(49, 1), (49, HEADS), (65, 1), (65, HEADS)]


@pytest.mark.parametrize("n,hb", BIAS_CASES)
def test_biased_block_forward_and_vjp_match_jax_kernel(n, hb):
    args, bias, dy = _block_args(n, hb)
    y_want, vjp = jax.vjp(
        lambda *a: jax_attn.fused_attention_block_bias(*a, HEADS, DH, None, 1e-3, True),
        *map(jnp.asarray, args + (bias,)))
    want = vjp(jnp.asarray(dy))
    inputs = [t.requires_grad_() for t in _torch_layout(args) + [torch.from_numpy(bias)]]
    counts = (fused_attention_block.launches, fused_attention_block_bias.launches)
    y = fused_attention_block_bias(*inputs, HEADS, DH)
    assert _rel(y.detach().numpy(), y_want) <= TOL_OP
    got = torch.autograd.grad(y, inputs, torch.from_numpy(dy))
    assert (fused_attention_block.launches,
            fused_attention_block_bias.launches) == counts  # CPU: plain versions
    names = ["dx", "dgamma", "dbeta", "dwqkv", "dwo", "dbo", "dbias"]
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        g = g.numpy().T if i in (3, 4) else g.numpy()
        assert g.shape == np.asarray(w).shape, name
        assert _rel(g, w) <= TOL_OP, f"{name}: {_rel(g, w)}"


@pytest.mark.parametrize("hb", [1, HEADS])
def test_biased_backward_outputs_match_jax_kernel(hb):
    """Every output of the biased backward kernel, dqkv and dbias included,
    against ``_backward(..., bias=)`` given the same saved projection."""
    args, bias, dy = _block_args(65, hb, seed=1)
    x, gamma, beta, wqkv, wo, bo = map(jnp.asarray, args)
    scale = DH ** -0.5
    _, _, qkv, _ = jax_attn._forward(x, gamma, beta, wqkv, wo, bo, HEADS, DH, scale, 1e-3, True,
                                     save_residuals=True, bias=jnp.asarray(bias))
    want = jax_attn._backward(jnp.asarray(dy), x, qkv, gamma, wqkv, wo, HEADS, DH, scale, 1e-3,
                              True, bias=jnp.asarray(bias))
    t = torch.from_numpy
    got = fused_attention_block_bias_backward(t(dy), t(args[0]), t(np.array(qkv)), t(args[1]),
                                              t(args[3].T.copy()), t(args[4].T.copy()), t(bias),
                                              HEADS, DH)
    for name, g, w in zip(["dx", "dqkv", "dgamma", "dbeta", "dbo", "dbias"], got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= TOL_OP, f"{name}: {_rel(g.numpy(), w)}"
    no_dbias = fused_attention_block_bias_backward(
        t(dy), t(args[0]), t(np.array(qkv)), t(args[1]), t(args[3].T.copy()),
        t(args[4].T.copy()), t(bias), HEADS, DH, need_dbias=False)
    assert no_dbias[5] is None and torch.equal(no_dbias[0], got[0])


# The biased block's short route (short_fwd / short_bwd with the bias, the
# route of every biased block of at most 512 tokens) against the TPU kernel:
# p = e / l normalised before P·V, p recomputed from the forward's lse, D =
# rowsum(dO∘O) for dsum, dbias from (lse, D); in f32 one function with the TPU
# kernel's, apart by f32 rounding.  n = 257 is the small-dataset ViT's (two
# 144-key tiles on the card), 197 ViT-B/16's, 65 one past a 64-key tile; 16,
# 49 and 64, with a bias the heads share, CrossFormer's windows at dh 32 (its
# long 4 x 4 and 8 x 8, its short 7 x 7: one 64-key tile, ragged at 16 and 49).
SHORT_BIAS_CASES = [(n, hb) for n in (65, 197, 257) for hb in (1, HEADS)] + \
    [(n, 1) for n in (16, 49, 64)]


@pytest.mark.parametrize("n,hb", SHORT_BIAS_CASES)
def test_short_route_biased_plain_versions_match_jax_kernel(n, hb):
    """The short route's plain biased forward (y, xn, qkv, oattn, and its lse
    against the log-sum-exp of the biased f32 logits) and backward (dx, dqkv,
    dγ, dβ, dbo, dbias), fed JAX's saved projection and output, against
    ``_forward`` and ``_backward(..., bias=)``: each within 1e-4 of its
    max|JAX output|."""
    assert attention_route(n) == "short"
    args, bias, dy = _block_args(n, hb, seed=3)
    x, gamma, beta, wqkv, wo, bo = map(jnp.asarray, args)
    scale, jbias, t = DH ** -0.5, jnp.asarray(bias), torch.from_numpy
    fwd = jax_attn._forward(x, gamma, beta, wqkv, wo, bo, HEADS, DH, scale, 1e-3, True,
                            save_residuals=True, bias=jbias)
    want = jax_attn._backward(jnp.asarray(dy), x, fwd[2], gamma, wqkv, wo, HEADS, DH, scale,
                              1e-3, True, bias=jbias)
    got = fused_attention_block_short_forward_reference(*_torch_layout(args), HEADS, DH, scale,
                                                        1e-3, t(bias))
    for name, g, w in zip(["y", "xn", "qkv", "oattn"], got, fwd):
        assert _rel(g.numpy(), w) <= TOL, f"{name}: {_rel(g.numpy(), w)}"
    qkv, oattn = t(np.array(fwd[2])), t(np.array(fwd[3]))
    lse = attention_lse_reference(qkv, HEADS, DH, scale, t(bias))
    assert _rel(got[4].numpy(), lse.numpy()) <= TOL
    got = fused_attention_block_short_backward_reference(
        t(dy), t(args[0]), qkv, oattn, lse, t(args[1]), t(args[3].T.copy()),
        t(args[4].T.copy()), HEADS, DH, scale, 1e-3, t(bias))
    for name, g, w in zip(["dx", "dqkv", "dgamma", "dbeta", "dbo", "dbias"], got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= TOL, f"{name}: {_rel(g.numpy(), w)}"


def test_lsa_bias_at_n_one_past_a_key_tile_matches_jax():
    """LSA's operands (scale 1.0, -f32.max on the diagonal) at n = 65, where
    the last 64-key tile holds one key, query 64's own masked one: finite, and
    the forward and input gradient as JAX's kernel computes them."""
    args, _, dy = _block_args(65, 1, seed=2)
    bias = sd.lsa_bias(65, "cpu")
    y_want, vjp = jax.vjp(
        lambda *a: jax_attn.fused_attention_block_bias(*a, jnp.asarray(bias.numpy()), HEADS,
                                                       DH, 1.0, 1e-3, True),
        *map(jnp.asarray, args))
    inputs = [t.requires_grad_() for t in _torch_layout(args)]
    y = fused_attention_block_bias(*inputs, bias, HEADS, DH, 1.0)
    assert torch.isfinite(y).all()
    assert _rel(y.detach().numpy(), y_want) <= TOL_OP
    dx = torch.autograd.grad(y, inputs[0], torch.from_numpy(dy))[0]
    assert _rel(dx.numpy(), vjp(jnp.asarray(dy))[0]) <= TOL_OP


@pytest.mark.parametrize("hb", [1, HEADS])
def test_plain_biased_backward_is_the_gradient_of_the_plain_forward(hb):
    g = torch.Generator().manual_seed(hb)
    b, n, d = 2, 19, 32
    heads, dh = HEADS, 16
    inner = heads * dh
    x, dy = torch.randn(b, n, d, generator=g), torch.randn(b, n, d, generator=g)
    gamma, beta = 1 + 0.1 * torch.randn(d, generator=g), 0.1 * torch.randn(d, generator=g)
    wqkv = 0.3 * torch.randn(3 * inner, d, generator=g)
    wo, bo = 0.3 * torch.randn(d, inner, generator=g), 0.1 * torch.randn(d, generator=g)
    bias = 0.5 * torch.randn(hb, n, n, generator=g)
    inputs = [t.requires_grad_() for t in (x, gamma, beta, wqkv, wo, bo, bias)]
    y = fused_attention_block_forward_reference(*inputs[:6], heads, dh, bias=inputs[6])[0]
    want = torch.autograd.grad(y, inputs, dy)
    with torch.no_grad():
        _, xn, qkv, oattn = fused_attention_block_forward_reference(
            *inputs[:6], heads, dh, bias=bias)
        dx, dqkv, dgamma, dbeta, dbo, dbias = fused_attention_block_backward_reference(
            dy, x, qkv, gamma, wqkv, wo, heads, dh, bias=bias)
        got = (dx, dgamma, dbeta, dqkv.reshape(-1, 3 * inner).t() @ xn.reshape(-1, d),
               dy.reshape(-1, d).t() @ oattn.reshape(-1, inner), dbo, dbias)
    names = ["dx", "dgamma", "dbeta", "dwqkv", "dwo", "dbo", "dbias"]
    for name, a, w in zip(names, got, want):
        assert _rel(a.numpy(), w.numpy()) <= TOL_OP, name


def test_bias_that_the_kernel_does_not_take_raises():
    args = _torch_layout(_block_args(9, 1)[0])
    good = torch.zeros(1, 9, 9)
    for bad in (good.double(), torch.zeros(3, 9, 9), torch.zeros(1, 9, 8),
                torch.zeros(1, 9, 18)[:, :, ::2], None):
        with pytest.raises(ValueError, match="bias"):
            fused_attention_block_bias(*args, bad, HEADS, DH)
    fused_attention_block_bias(*args, good, HEADS, DH)


@pytest.mark.parametrize("hw,p,c", [(16, 4, 3), (24, 8, 5)])
def test_spt_conv_matches_jax_and_the_eager_spt(hw, p, c):
    """Inputs with a non-zero mean, where the convolution form subtracts
    nearly equal terms."""
    rng = np.random.default_rng(hw)
    feat, d = p * p * 5 * c, 48
    x = _f32(rng, 2, hw, hw, c, shift=0.5)
    gamma, beta = _f32(rng, feat, scale=0.1, shift=1.0), _f32(rng, feat, scale=0.1)
    kernel, bias = _f32(rng, feat, d, scale=feat ** -0.5), _f32(rng, d, scale=0.1)
    want = jax_sd._spt_conv(*map(jnp.asarray, (x, gamma, beta, kernel, bias)), p, 1e-3)
    t = torch.from_numpy
    got = sd._spt_conv(t(x), t(gamma), t(beta), t(kernel), t(bias), p, 1e-3)
    assert _rel(got.numpy(), want) <= TOL_OP
    spt = sd.SPT(d, p, c, device="cpu")
    with torch.no_grad():
        spt.norm.weight.copy_(t(gamma))
        spt.norm.bias.copy_(t(beta))
        spt.proj.weight.copy_(t(kernel.T.copy()))
        spt.proj.bias.copy_(t(bias))
        assert _rel(spt(t(x)).numpy(), spt.plain(t(x)).numpy()) <= TOL_OP


class _LSABlock(fnn.Module):
    """``x + LSA(LN(x))``, the eager JAX block that ``apply_fused_lsa_block``
    replaces."""
    dim: int
    heads: int
    dim_head: int

    @fnn.compact
    def __call__(self, x):
        lsa = jax_sd.LSA(self.dim, heads=self.heads, dim_head=self.dim_head, name="attn")
        return x + lsa(JaxLayerNorm(name="attn_norm")(x))


@pytest.mark.parametrize("n", [17, 65])
def test_fused_lsa_block_matches_the_jax_eager_block(n):
    rng = np.random.default_rng(n)
    x = _f32(rng, 2, n, 64)
    block = _LSABlock(64, HEADS, DH)
    params = jax.tree.map(np.asarray, block.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["attn_norm"] = {"scale": _f32(rng, 64, scale=0.1, shift=1.0),
                           "bias": _f32(rng, 64, scale=0.1)}
    params["attn"]["temperature"] = params["attn"]["temperature"] + np.float32(0.3)

    def loss(p):
        out = block.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(jnp.sin(out)), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port = torch.nn.ModuleDict({"attn_norm": LayerNorm(64, device="cpu"),
                                "attn": sd.LSA(64, HEADS, DH, device="cpu")})
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    out = sd.apply_fused_lsa_block(port["attn_norm"], port["attn"], torch.from_numpy(x),
                                   sd.lsa_bias(n, "cpu"))
    assert _rel(out.detach().numpy(), want) <= TOL
    out.sin().sum().backward()
    t_want = float(grads["attn"]["temperature"])
    assert abs(t_want) > 0
    assert abs(float(port["attn"].temperature.grad) - t_want) <= TOL * abs(t_want)


def _flax_model(kw, img, **mode):
    model = jax_sd.ViT(**kw, **mode)
    return model, model.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"]


def _port(kw, params, **extra):
    model = sd.ViT(**kw, device="cpu", **extra)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return model


def _batch(kw, b=2, seed=0):
    rng = np.random.default_rng(seed)
    img = _f32(rng, b, kw["image_size"], kw["image_size"], 3, shift=0.2)
    return img, (np.arange(b) * 3 % kw["num_classes"]).astype(np.int32)


def _open_gate(monkeypatch):
    """Let the CPU activation through the ``"auto"`` gates; the ops then run
    their plain versions under their autograd Functions."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    monkeypatch.setattr(sd, "kernel_activation", lambda x: True)


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_small_dataset_vit_logits_and_gradients_match_jax(monkeypatch, route):
    img, labels = _batch(SMALL)
    model, params = _flax_model(SMALL, img, fused_attention="never", fused_mlp="never")

    def loss_of(p):
        logits = model.apply({"params": p}, jnp.asarray(img))
        return jax_train.cross_entropy_loss(logits, jnp.asarray(labels)), logits

    (loss_want, logits_want), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
    if route == "kernel":
        _open_gate(monkeypatch)
        port = _port(SMALL, params)
    else:
        port = _port(SMALL, params, fused_attention="never", fused_mlp="never")
    calls = []
    monkeypatch.setattr(sd, "apply_fused_lsa_block",
                        lambda *a, f=sd.apply_fused_lsa_block: calls.append(1) or f(*a))
    logits = port(torch.from_numpy(img))
    assert len(calls) == (SMALL["depth"] if route == "kernel" else 0)
    assert np.max(np.abs(logits.detach().numpy() - np.asarray(logits_want))) <= TOL
    loss = cross_entropy_loss(logits, torch.from_numpy(labels).long())
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_want)) <= TOL
    want = state_dict_from_flax(jax.tree.map(np.asarray, grads))
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    diffs = {k: float((got[k] - want[k]).abs().max()) for k in want}
    assert max(diffs.values()) <= TOL, diffs
    assert all(float(got[f"layers.{i}.attn.temperature"]) != 0 for i in range(SMALL["depth"]))


def test_converter_carries_the_small_dataset_tree():
    """The Flax tree loads strictly into the port (the key sets agree), leaf
    for leaf: Dense kernels transposed, the scalar temperatures, the SPT's
    LayerNorm and projection, the top-level per-layer modules."""
    img, _ = _batch(SMALL)
    _, params = _flax_model(SMALL, img)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    state = _port(SMALL, params).state_dict()
    assert len(state) == len(flat) == 34
    names = {
        "attn_1/temperature": "layers.1.attn.temperature",
        "attn_0/to_qkv/kernel": "layers.0.attn.to_qkv.weight",
        "attn_1/to_out/kernel": "layers.1.attn.to_out.0.weight",
        "attn_0/to_out/bias": "layers.0.attn.to_out.0.bias",
        "attn_norm_0/scale": "layers.0.attn_norm.weight",
        "mlp_1/fc2/kernel": "layers.1.mlp.fc2.weight",
        "mlp_norm_1/bias": "layers.1.mlp_norm.bias",
        "patch_embedding/norm/scale": "patch_embedding.norm.weight",
        "patch_embedding/proj/kernel": "patch_embedding.proj.weight",
        "cls_token": "cls_token",
        "pos_embedding": "pos_embedding",
        "head_norm/bias": "head_norm.bias",
        "head/kernel": "head.weight",
    }
    for path, key in names.items():
        want = flat[path].T if path.endswith("kernel") else flat[path]
        assert state[key].shape == want.shape and np.array_equal(state[key].numpy(), want), path


@pytest.mark.parametrize("dropout,train,mode,fused", [
    (0.0, True, "auto", True),     # training with a rate of 0: the kernel
    (0.1, False, "auto", True),    # eval: dropout inactive, the kernel
    (0.1, True, "auto", False),    # active dropout: the plain LSA, as vit_tpu
    (0.0, False, "never", False),  # "never": the plain LSA
])
def test_small_dataset_dispatch_gate(monkeypatch, dropout, train, mode, fused):
    """``"auto"`` routes every LSA half to the biased kernel and builds LSA's
    bias once per forward, not once per layer."""
    _open_gate(monkeypatch)
    counts = {"block": [], "bias": []}
    for name, key in (("apply_fused_lsa_block", "block"), ("lsa_bias", "bias")):
        fn = getattr(sd, name)
        monkeypatch.setattr(sd, name, lambda *a, f=fn, k=key: counts[k].append(1) or f(*a))
    g = torch.Generator().manual_seed(0)
    model = sd.ViT(**dict(SMALL, depth=3), dropout=dropout, fused_attention=mode,
                   device="cpu", generator=g)
    model.train(train)
    model(torch.randn(2, 32, 32, 3, generator=g))
    assert (len(counts["block"]), len(counts["bias"])) == ((3, 1) if fused else (0, 0))


def test_bf16_compute_train_step_keeps_f32_parameters(monkeypatch):
    """f32 parameters with ``compute_dtype=bf16`` through the kernel route
    (the gate opened on the CPU): bf16 logits, f32 gradients for every
    parameter, temperatures included, and a falling loss."""
    _open_gate(monkeypatch)
    g = torch.Generator().manual_seed(4)
    model = sd.ViT(**SMALL, compute_dtype=torch.bfloat16, device="cpu", generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.05))
    img = torch.randn(4, 32, 32, 3, generator=g)
    labels = torch.tensor([1, 4, 7, 2])
    assert model(img).dtype == torch.bfloat16
    losses = [float(step(img, labels)["loss"]) for _ in range(3)]
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(float(model.layers[i].attn.temperature.grad) != 0 for i in range(2))
    assert np.isfinite(losses).all() and losses[2] < losses[0]
