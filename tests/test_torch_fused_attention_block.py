"""The port's fused attention block and plain attention against JAX.

The block: the port's ``fused_attention_block`` (its plain PyTorch version on
the CPU) against ``vit_tpu.ops.fused_attention_block`` in the Pallas
interpreter, as ``tests/unit/test_fused_attention_block.py`` runs it.  The
plain attention of ``vit_tpu_torch/ops/attention.py`` against
``vit_tpu.ops.attention``.  Same inputs from ``numpy.random.default_rng``;
f32 tolerance 1e-5, the bar of the JAX kernel's own tests.  The block's plain
forward on the short route (``short_attention``'s softmax, which divides
before P·V where the TPU kernel divides after) against the TPU kernel's
training forward (``_forward`` with ``save_residuals``) within 1e-4 of each
output's max.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vit_tpu.ops import attention as jax_attention  # noqa: E402
from vit_tpu.ops import fused_attention_block as jax_attn  # noqa: E402
from vit_tpu.ops.fused_attention_block import (  # noqa: E402
    fused_attention_block as jax_block,
)
from vit_tpu_torch.ops import attention  # noqa: E402
from vit_tpu_torch.ops.fused_attention_block import (  # noqa: E402
    attention_lse_reference, attention_route, fused_attention_block,
    fused_attention_block_short_forward_reference,
)

TOL = 1e-5


def _rng_f32(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("b,n,d,heads,dh", [
    (3, 67, 96, 3, 32),   # odd n, as test_fused_attention_block.py:30
    (2, 145, 64, 2, 32),  # n >= 128, the window the JAX auto dispatch uses
    (8, 65, 128, 2, 64),  # the B/32 n=65 shape class
    (2, 17, 64, 4, 24),   # dim_head != d / heads
])
def test_fused_attention_block_matches_jax_kernel(b, n, d, heads, dh):
    rng = np.random.default_rng(0)
    inner = heads * dh
    x = _rng_f32(rng, b, n, d)
    gamma = _rng_f32(rng, d, scale=0.1, shift=1.0)
    beta = _rng_f32(rng, d, scale=0.1)
    wqkv = _rng_f32(rng, d, 3 * inner, scale=0.05)
    wo = _rng_f32(rng, inner, d, scale=0.05)
    bo = _rng_f32(rng, d, scale=0.05)

    want = np.asarray(jax_block(*map(jnp.asarray, (x, gamma, beta, wqkv, wo, bo)),
                                heads, dh, None, 1e-3, True))
    before = fused_attention_block.launches
    t = torch.from_numpy
    got = fused_attention_block(t(x), t(gamma), t(beta), t(wqkv.T.copy()),
                                t(wo.T.copy()), t(bo), heads, dh).numpy()
    assert fused_attention_block.launches == before  # CPU: plain version
    assert np.max(np.abs(got - want)) <= TOL


# The short route against the TPU kernel: p = e / l normalised before P·V
# where the kernel divides after it, lse as m + log l where the reference
# takes logsumexp; equal in exact arithmetic, apart by f32 rounding.
SHORT_ROUTE_TOL = 1e-4


@pytest.mark.parametrize("b,n,d,heads,dh", [
    (4, 65, 128, 2, 64),   # ViT-B/32's n
    (2, 197, 96, 3, 32),   # ViT-B/16's n
])
def test_short_route_forward_matches_jax_kernel(b, n, d, heads, dh):
    """The plain f32 version of the forward on the short route against
    ``_forward`` with ``save_residuals``: y, xn, qkv and oattn each within
    1e-4 of max|JAX output|, and its lse within 1e-5 of
    ``attention_lse_reference`` over the same qkv."""
    assert attention_route(n) == "short"
    rng = np.random.default_rng(3)
    inner = heads * dh
    x = _rng_f32(rng, b, n, d)
    gamma = _rng_f32(rng, d, scale=0.1, shift=1.0)
    beta = _rng_f32(rng, d, scale=0.1)
    wqkv = _rng_f32(rng, d, 3 * inner, scale=0.05)
    wo = _rng_f32(rng, inner, d, scale=0.05)
    bo = _rng_f32(rng, d, scale=0.05)
    scale = dh ** -0.5
    want = jax_attn._forward(*map(jnp.asarray, (x, gamma, beta, wqkv, wo, bo)), heads, dh,
                             scale, 1e-3, True, save_residuals=True)
    t = torch.from_numpy
    got = fused_attention_block_short_forward_reference(
        t(x), t(gamma), t(beta), t(wqkv.T.copy()), t(wo.T.copy()), t(bo), heads, dh, scale)
    for name, g, w in zip(["y", "xn", "qkv", "oattn"], got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = np.max(np.abs(g.numpy() - w)) / np.max(np.abs(w))
        assert err <= SHORT_ROUTE_TOL, f"{name}: {err}"
    lse = got[4]
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, heads, n)
    assert torch.max(torch.abs(lse - attention_lse_reference(got[2], heads, dh, scale))) <= TOL


def _qkv(rng, b=2, h=3, n=19, d=16):
    return tuple(_rng_f32(rng, b, h, n, d) for _ in range(3))


@pytest.mark.parametrize("with_bias,with_mask", [(False, False), (True, False), (False, True)])
def test_plain_attention_matches_jax_f32(with_bias, with_mask):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng)
    bias = _rng_f32(rng, 1, 3, 19, 19, scale=0.3) if with_bias else None
    mask = rng.random((2, 1, 19, 19)) > 0.3 if with_mask else None
    j = (lambda a: None if a is None else jnp.asarray(a))
    t = (lambda a: None if a is None else torch.from_numpy(a))
    want = np.asarray(jax_attention.scaled_dot_product_attention(
        j(q), j(k), j(v), scale=0.3, bias=j(bias), mask=j(mask), use_flash="never"))
    got = attention.scaled_dot_product_attention(
        t(q), t(k), t(v), scale=0.3, bias=t(bias), mask=t(mask)).numpy()
    assert np.max(np.abs(got - want)) <= TOL

    w_want = np.array(jax_attention.attention_weights(j(q), j(k), bias=j(bias), mask=j(mask)))
    w_got = attention.attention_weights(t(q), t(k), bias=t(bias), mask=t(mask)).numpy()
    assert np.max(np.abs(w_got - w_want)) <= TOL
    o_want = np.asarray(jax_attention.apply_attention(jnp.asarray(w_want), j(v)))
    o_got = attention.apply_attention(torch.from_numpy(w_want), t(v)).numpy()
    assert np.max(np.abs(o_got - o_want)) <= TOL


def test_plain_attention_bf16_storage_policy_matches_jax():
    """bf16: logits and probabilities stored bf16, exp and the row sum in f32
    (vit_tpu/ops/attention.py:204-220).  The two CPU exp implementations may
    differ in the last f32 bit, which can move a bf16 rounding by one unit:
    tolerance 2^-7 of the output's largest value (two bf16 units)."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, n=33, d=32)
    want = np.asarray(jax_attention._xla_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale=32 ** -0.5)
        .astype(jnp.float32))
    got = attention.plain_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        scale=32 ** -0.5)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.max(np.abs(got - want)) <= 2.0 ** -7 * np.max(np.abs(want))


def test_mask_value_matches_jax():
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        assert attention.mask_value(tdt) == jax_attention.mask_value(jdt)
