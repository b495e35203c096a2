"""The port's block backwards against the JAX Pallas backward kernels.

On the CPU the port's ops run their plain PyTorch versions under autograd
(:class:`FusedMLPFunction`, :class:`FusedAttentionBlockFunction`, with the
plain training forward and the plain backward of the kernels); the JAX side
runs ``jax.vjp`` of ``vit_tpu.ops.fused_mlp`` / ``fused_attention_block`` in
the Pallas interpreter with exact-erf GELU, which runs their ``_bwd_kernel``,
as ``tests/unit/test_fused_mlp.py`` and ``test_fused_attention_block.py`` do.
Same f32 inputs and cotangent from ``numpy.random.default_rng``; each
gradient within 1e-5 of max|JAX gradient|, the JAX kernels' own bar.  The
block at Twins-SVT's window (49 tokens, 8 heads of 64 in a 64-wide model)
takes the ChannelLayerNorm's eps 1e-5.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_tpu.ops import fused_attention_block as jax_attn  # noqa: E402
from vit_tpu.ops import fused_mlp as jax_mlp  # noqa: E402
from vit_tpu_torch.ops.fused_attention_block import (  # noqa: E402
    attention_lse_reference, fused_attention_block, fused_attention_block_backward,
    fused_attention_block_backward_reference, fused_attention_block_forward_reference,
    fused_attention_block_lse_backward_reference,
)
from vit_tpu_torch.ops.fused_mlp import (  # noqa: E402
    fused_mlp, fused_mlp_backward, fused_mlp_backward_reference, fused_mlp_forward_reference,
)

TOL = 1e-5


def _f32(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return np.max(np.abs(np.asarray(got) - want)) / (np.max(np.abs(want)) + 1e-12)


def _mlp_args(shape, hidden, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    args = (_f32(rng, *shape), _f32(rng, d, scale=0.1, shift=1.0), _f32(rng, d, scale=0.1),
            _f32(rng, d, hidden, scale=0.05), _f32(rng, hidden, scale=0.05),
            _f32(rng, hidden, d, scale=0.05), _f32(rng, d, scale=0.05))
    return args, _f32(rng, *shape)


def _attn_args(b, n, d, heads, dh, seed=0):
    rng = np.random.default_rng(seed)
    inner = heads * dh
    args = (_f32(rng, b, n, d), _f32(rng, d, scale=0.1, shift=1.0), _f32(rng, d, scale=0.1),
            _f32(rng, d, 3 * inner, scale=0.05), _f32(rng, inner, d, scale=0.05),
            _f32(rng, d, scale=0.05))
    return args, _f32(rng, b, n, d)


def _linear_layout(args, kernels):
    """Flax Dense kernels (in, out) → nn.Linear weights (out, in)."""
    return [torch.from_numpy(a.T.copy() if i in kernels else a) for i, a in enumerate(args)]


MLP_SHAPES = [
    ((2, 17, 64), 128),   # odd n, 3-D
    ((3, 67, 96), 160),   # odd n, 3-D, several token blocks
    ((2, 145, 64), 96),   # n >= 128
    ((197, 96), 160),     # 2-D rows, a ragged last token block of 64
]
ATTN_SHAPES = [
    (3, 17, 64, 2, 32),   # odd n
    (3, 67, 96, 3, 32),   # odd n
    (2, 145, 64, 2, 32),  # n >= 128, the window the JAX auto dispatch uses
    (2, 17, 64, 4, 24),   # dim_head != d / heads
    (3, 49, 64, 8, 64),   # Twins-SVT's 7 x 7 window at stage 1: inner 512 above d
]
# The LayerNorm's eps by shape: 1e-3 (the token LayerNorm), 1e-5 where the
# block stands for a ChannelLayerNorm (Twins-SVT's local attention).
EPS = {(3, 49, 64, 8, 64): 1e-5}


@pytest.mark.parametrize("shape,hidden", MLP_SHAPES)
def test_fused_mlp_vjp_matches_jax_kernel(shape, hidden):
    args, dy = _mlp_args(shape, hidden)
    _, vjp = jax.vjp(lambda *a: jax_mlp.fused_mlp(*a, 1e-3, 64, True, "exact"),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    inputs = [t.requires_grad_() for t in _linear_layout(args, kernels=(3, 5))]
    counts = (fused_mlp.launches, fused_mlp_backward.launches)
    y = fused_mlp(*inputs)
    got = torch.autograd.grad(y, inputs, torch.from_numpy(dy))
    assert (fused_mlp.launches, fused_mlp_backward.launches) == counts  # CPU: plain versions
    names = ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"]
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        w = np.asarray(w)
        g = g.numpy().T if i in (3, 5) else g.numpy()
        assert g.shape == w.shape, name
        assert _rel(g, w) <= TOL, f"{name}: {_rel(g, w)}"


@pytest.mark.parametrize("shape,hidden", MLP_SHAPES[:2] + MLP_SHAPES[3:])
def test_fused_mlp_backward_outputs_match_jax_kernel(shape, hidden):
    """Every output of the backward kernel, intermediates dh and gact
    included, against ``_backward`` given the same saved pre-activation."""
    args, dy = _mlp_args(shape, hidden, seed=1)
    x, gamma, beta, w1, b1, w2, b2 = map(jnp.asarray, args)
    _, _, h = jax_mlp._forward(x, gamma, beta, w1, b1, w2, b2, 1e-3, 64, True,
                               save_residuals=True, gelu="exact")
    want = jax_mlp._backward(jnp.asarray(dy), x, h, gamma, w1, w2, 1e-3, 64, True,
                             gelu="exact")
    t = torch.from_numpy
    got = fused_mlp_backward(t(dy), t(args[0]), t(np.array(h)), t(args[1]),
                             t(args[3].T.copy()), t(args[5].T.copy()))
    for name, g, w in zip(["dx", "dh", "gact", "dgamma", "dbeta", "db1", "db2"], got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= TOL, f"{name}: {_rel(g.numpy(), w)}"


@pytest.mark.parametrize("b,n,d,heads,dh", ATTN_SHAPES)
def test_fused_attention_block_vjp_matches_jax_kernel(b, n, d, heads, dh):
    args, dy = _attn_args(b, n, d, heads, dh)
    eps = EPS.get((b, n, d, heads, dh), 1e-3)
    _, vjp = jax.vjp(lambda *a: jax_attn.fused_attention_block(*a, heads, dh, None, eps, True),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    inputs = [t.requires_grad_() for t in _linear_layout(args, kernels=(3, 4))]
    counts = (fused_attention_block.launches, fused_attention_block_backward.launches)
    y = fused_attention_block(*inputs, heads, dh, eps=eps)
    got = torch.autograd.grad(y, inputs, torch.from_numpy(dy))
    assert (fused_attention_block.launches,
            fused_attention_block_backward.launches) == counts  # CPU: plain versions
    for i, (name, g, w) in enumerate(zip(["dx", "dgamma", "dbeta", "dwqkv", "dwo", "dbo"],
                                         got, want)):
        w = np.asarray(w)
        g = g.numpy().T if i in (3, 4) else g.numpy()
        assert g.shape == w.shape, name
        assert _rel(g, w) <= TOL, f"{name}: {_rel(g, w)}"


@pytest.mark.parametrize("b,n,d,heads,dh", [ATTN_SHAPES[1], ATTN_SHAPES[3]])
def test_fused_attention_block_backward_outputs_match_jax_kernel(b, n, d, heads, dh):
    """Every output of the backward kernel, dqkv included, against
    ``_backward`` given the same saved projection."""
    args, dy = _attn_args(b, n, d, heads, dh, seed=1)
    x, gamma, beta, wqkv, wo, bo = map(jnp.asarray, args)
    scale = dh ** -0.5
    _, _, qkv, _ = jax_attn._forward(x, gamma, beta, wqkv, wo, bo, heads, dh, scale, 1e-3,
                                     True, save_residuals=True)
    want = jax_attn._backward(jnp.asarray(dy), x, qkv, gamma, wqkv, wo, heads, dh, scale,
                              1e-3, True)[:5]
    t = torch.from_numpy
    got = fused_attention_block_backward(t(dy), t(args[0]), t(np.array(qkv)), t(args[1]),
                                         t(args[3].T.copy()), t(args[4].T.copy()), heads, dh)
    for name, g, w in zip(["dx", "dqkv", "dgamma", "dbeta", "dbo"], got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= TOL, f"{name}: {_rel(g.numpy(), w)}"


# The card's math against the TPU kernel's, on both routes (short_bwd up to
# 512 tokens, the flash backward past them): D = rowsum(dO∘O) over the stored
# output where the kernel sums dsum = Σ dp·p, the softmax from the forward's
# lse where the kernel takes its own row max and sum; equal in exact
# arithmetic, apart by f32 rounding.
SHORT_ROUTE_TOL = 1e-4


@pytest.mark.parametrize("b,n,d,heads,dh", ATTN_SHAPES + [
    (2, 65, 128, 2, 64),
    (2, 577, 64, 2, 32),   # the mha route: the ViTs' 577 tokens at 384 px
    (2, 962, 64, 2, 64),   # PiT's stage 1
])
def test_short_route_backward_matches_jax_kernel(b, n, d, heads, dh):
    """The plain f32 version of the card's backward on either route (lse
    from the training forward, D = rowsum(dO∘O) over its output) against
    ``_backward`` given the same saved projection: every output within 1e-4
    of max|JAX output|."""
    args, dy = _attn_args(b, n, d, heads, dh, seed=2)
    x, gamma, beta, wqkv, wo, bo = map(jnp.asarray, args)
    scale = dh ** -0.5
    eps = EPS.get((b, n, d, heads, dh), 1e-3)
    _, _, qkv, oattn = jax_attn._forward(x, gamma, beta, wqkv, wo, bo, heads, dh, scale, eps,
                                         True, save_residuals=True)
    want = jax_attn._backward(jnp.asarray(dy), x, qkv, gamma, wqkv, wo, heads, dh, scale,
                              eps, True)[:5]
    t = torch.from_numpy
    qkv, oattn = t(np.array(qkv)), t(np.array(oattn))
    lse = attention_lse_reference(qkv, heads, dh, scale)
    got = fused_attention_block_lse_backward_reference(
        t(dy), t(args[0]), qkv, oattn, lse, t(args[1]), t(args[3].T.copy()),
        t(args[4].T.copy()), heads, dh, scale, eps)
    for name, g, w in zip(["dx", "dqkv", "dgamma", "dbeta", "dbo"], got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= SHORT_ROUTE_TOL, f"{name}: {_rel(g.numpy(), w)}"


def _autograd_of(forward, dy, inputs):
    y = forward(*inputs)[0]
    return torch.autograd.grad(y, inputs, dy)


@pytest.mark.parametrize("shape", [(2, 17, 32), (33, 48)])
def test_plain_mlp_backward_is_the_gradient_of_the_plain_forward(shape):
    """Written out step by step, the plain backward is still the gradient of
    the plain forward (f32, where the rounding points are identities)."""
    g = torch.Generator().manual_seed(0)
    d, hidden = shape[-1], 2 * shape[-1]
    x, dy = torch.randn(*shape, generator=g), torch.randn(*shape, generator=g)
    gamma, beta = 1 + 0.1 * torch.randn(d, generator=g), 0.1 * torch.randn(d, generator=g)
    w1, b1 = 0.2 * torch.randn(hidden, d, generator=g), 0.1 * torch.randn(hidden, generator=g)
    w2, b2 = 0.2 * torch.randn(d, hidden, generator=g), 0.1 * torch.randn(d, generator=g)
    inputs = [t.requires_grad_() for t in (x, gamma, beta, w1, b1, w2, b2)]
    want = _autograd_of(fused_mlp_forward_reference, dy, inputs)
    _, _, h = fused_mlp_forward_reference(x, gamma, beta, w1, b1, w2, b2)
    with torch.no_grad():
        dx, dh, gact, dgamma, dbeta, db1, db2 = fused_mlp_backward_reference(
            dy, x, h, gamma, w1, w2)
        xn = fused_mlp_forward_reference(x, gamma, beta, w1, b1, w2, b2)[1]
        got = (dx, dgamma, dbeta, dh.reshape(-1, hidden).t() @ xn.reshape(-1, d), db1,
               dy.reshape(-1, d).t() @ gact.reshape(-1, hidden), db2)
    for name, a, w in zip(["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"], got, want):
        assert _rel(a.numpy(), w.numpy()) <= TOL, name


@pytest.mark.parametrize("heads,dh", [(2, 16), (3, 8)])
def test_plain_attention_backward_is_the_gradient_of_the_plain_forward(heads, dh):
    g = torch.Generator().manual_seed(1)
    b, n, d = 2, 19, 32
    inner = heads * dh
    x, dy = torch.randn(b, n, d, generator=g), torch.randn(b, n, d, generator=g)
    gamma, beta = 1 + 0.1 * torch.randn(d, generator=g), 0.1 * torch.randn(d, generator=g)
    wqkv = 0.3 * torch.randn(3 * inner, d, generator=g)
    wo, bo = 0.3 * torch.randn(d, inner, generator=g), 0.1 * torch.randn(d, generator=g)
    inputs = [t.requires_grad_() for t in (x, gamma, beta, wqkv, wo, bo)]
    want = _autograd_of(lambda *a: fused_attention_block_forward_reference(*a, heads, dh),
                        dy, inputs)
    with torch.no_grad():
        _, xn, qkv, oattn = fused_attention_block_forward_reference(*inputs, heads, dh)
        dx, dqkv, dgamma, dbeta, dbo = fused_attention_block_backward_reference(
            dy, x, qkv, gamma, wqkv, wo, heads, dh)
        got = (dx, dgamma, dbeta, dqkv.reshape(-1, 3 * inner).t() @ xn.reshape(-1, d),
               dy.reshape(-1, d).t() @ oattn.reshape(-1, inner), dbo)
    for name, a, w in zip(["dx", "dgamma", "dbeta", "dwqkv", "dwo", "dbo"], got, want):
        assert _rel(a.numpy(), w.numpy()) <= TOL, name


def test_master_parameters_get_gradients_in_their_own_dtype():
    """bf16 activations with f32 γ/β, as the ViT's f32 master parameters
    reach the op: the op rounds γ/β itself and returns their gradients in
    f32; the other gradients come back in the compute dtype."""
    args, dy = _mlp_args((2, 9, 32), 64)
    x, gamma, beta, w1, b1, w2, b2 = _linear_layout(args, kernels=(3, 5))
    bf = torch.bfloat16
    inputs = [x.to(bf), gamma, beta, *(t.to(bf) for t in (w1, b1, w2, b2))]
    inputs = [t.requires_grad_() for t in inputs]
    got = torch.autograd.grad(fused_mlp(*inputs), inputs, torch.from_numpy(dy).to(bf))
    assert [t.dtype for t in got] == [bf, torch.float32, torch.float32, bf, bf, bf, bf]
    want = fused_mlp_backward_reference(
        torch.from_numpy(dy).to(bf), inputs[0].detach(),
        fused_mlp_forward_reference(*(t.detach() for t in inputs[:1]),
                                    gamma.to(bf), beta.to(bf),
                                    *(t.detach() for t in inputs[3:]))[2],
        gamma.to(bf), *(t.detach() for t in (inputs[3], inputs[5])))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[3]) and torch.equal(got[2], want[4])
