"""The fused cross-attention op of the port against ``vit_tpu``'s Pallas kernel
pair, in f32 on the CPU, where the port's op runs its plain versions and the
JAX kernels run in interpret mode (as ``tests/unit/test_fused_cross_attention.py``
runs them).

The forward and the VJP of every input (dx, dxn, dWq, dk, dv, dWo, dbo) at
that file's shapes (3 images of 64 tokens against 9 keys, c 48, 2 heads, dh_k
16 / dh_v 24; 5 images of 24 tokens against 4 keys) and at ScalableViT's SSA
widths (dh_k 40 / dh_v 32), within 1e-5 of max(1, max|ref|): in f32 both
sides are exact attention and its gradient, and differ by summation order.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_tpu.ops.fused_cross_attention import fused_cross_attention_block  # noqa: E402
from vit_tpu_torch.ops import fused_cross_attention as fca  # noqa: E402

TOL = 1e-5
# (b, n, n_k, c, heads, dh_k, dh_v)
CASES = [
    (3, 64, 9, 48, 2, 16, 24),   # tests/unit/test_fused_cross_attention.py::_args
    (5, 24, 4, 48, 2, 16, 24),   # its batch-padding case
    (2, 64, 16, 64, 2, 40, 32),  # ScalableViT's SSA widths, stage 1 scaled down
]


def _inputs(b, n, n_k, c, heads, dh_k, dh_v, seed=0):
    """x, xn, wq, k, v, wo, bo in vit_tpu's layout (wq (c, hk), wo (hv, c)),
    and a cotangent, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    args = (rn(b, n, c), rn(b, n, c), rn(c, heads * dh_k, scale=0.1), rn(b, n_k, heads * dh_k),
            rn(b, n_k, heads * dh_v), rn(heads * dh_v, c, scale=0.1), rn(c, scale=0.1))
    return args, rn(b, n, c)


def _to_port(args):
    """vit_tpu's argument layout → the port's (nn.Linear weights)."""
    x, xn, wq, k, v, wo, bo = (torch.from_numpy(a) for a in args)
    return x, xn, wq.t().contiguous(), k, v, wo.t().contiguous(), bo


def _close(got, want, name):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), (name, err)


@pytest.mark.parametrize("b,n,n_k,c,heads,dh_k,dh_v", CASES)
def test_forward_and_vjp_match_jax_kernel(b, n, n_k, c, heads, dh_k, dh_v):
    args, g = _inputs(b, n, n_k, c, heads, dh_k, dh_v)
    scale = dh_k ** -0.5

    def jax_op(*a):
        return fused_cross_attention_block(*a, heads, dh_k, dh_v, scale, True)

    y_want, vjp = jax.vjp(jax_op, *map(jnp.asarray, args))
    grads_want = vjp(jnp.asarray(g))
    counts = (fca.fused_cross_attention.launches, fca.fused_cross_attention_backward.launches)
    inputs = [t.requires_grad_() for t in _to_port(args)]
    y = fca.fused_cross_attention(*inputs, heads, dh_k, dh_v, scale)
    grads = torch.autograd.grad(y, inputs, torch.from_numpy(g))
    assert (fca.fused_cross_attention.launches,
            fca.fused_cross_attention_backward.launches) == counts  # CPU: plain versions
    _close(y.detach(), y_want, "y")
    dx, dxn, dwq, dk, dv, dwo, dbo = grads
    for name, got, want in zip(("dx", "dxn", "dwq", "dk", "dv", "dwo", "dbo"),
                               (dx, dxn, dwq.t(), dk, dv, dwo.t(), dbo), grads_want):
        _close(got, want, name)


def test_serving_forward_keeps_no_graph_and_matches_training_forward():
    args, _ = _inputs(*CASES[2])
    x, xn, wq, k, v, wo, bo = _to_port(args)
    with torch.no_grad():
        y = fca.fused_cross_attention(x, xn, wq, k, v, wo, bo, 2, 40, 32)
    y_train, q, oattn, lse = fca.fused_cross_attention_forward_reference(
        x, xn, wq, k, v, wo, bo, 2, 40, 32)
    assert torch.equal(y, y_train)
    assert q.shape == (2, 64, 80) and oattn.shape == (2, 64, 64) and lse.shape == (2, 2, 64)
    assert lse.dtype == torch.float32


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """In f32, where no rounding point rounds: autograd through the plain
    forward against the plain backward (which takes D from the stored
    output, as the kernel does), to f32 precision."""
    args, g = _inputs(2, 40, 7, 32, 2, 40, 32, seed=3)
    inputs = [t.requires_grad_() for t in _to_port(args)]
    x, xn, wq, k, v, wo, bo = inputs
    y, q, oattn, lse = fca.fused_cross_attention_forward_reference(*inputs, 2, 40, 32)
    want = torch.autograd.grad(y, (xn, k, v, bo), torch.from_numpy(g))
    dxn, _, dk, dv, dbo = fca.fused_cross_attention_backward(
        torch.from_numpy(g), q.detach(), k.detach(), v.detach(), oattn.detach(), lse.detach(),
        wq.detach(), wo.detach(), 2, 40, 32)
    for name, got, w in zip(("dxn", "dk", "dv", "dbo"), (dxn, dk, dv, dbo), want):
        _close(got, w, name)


@pytest.mark.parametrize("c,dh_k,dh_v,ok", [
    (64, 40, 32, True), (256, 40, 32, True), (512, 32, 32, True), (128, 64, 64, True),
    (60, 40, 32, False),   # rows of 16 bytes need c % 8 == 0
    (64, 16, 24, False),   # no flash instance for (16, 24)
    (64, 40, 40, False),
])
def test_supported_widths(c, dh_k, dh_v, ok):
    assert fca.fused_cross_attention_supported(c, dh_k, dh_v) == ok
