"""The short-sequence attention op of the port against ``vit_tpu``'s Pallas
kernel pair, in f32 on the CPU, where the port's op runs its plain versions
and the JAX kernels run in interpret mode (as
``tests/unit/test_short_attention.py`` runs them).

The forward and the VJP (dq, dk, dv) at that file's self-attention shape (2
images, 3 heads, 197 tokens of 64) and its ragged cross-attention shape (2
heads, 65 queries against 130 keys of 32), within 1e-5 of max(1, max|ref|),
the JAX tests' own bar: in f32 both sides are exact attention and its
gradient, and differ by summation order.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_tpu.ops.short_attention import short_attention as jax_short_attention  # noqa: E402
from vit_tpu_torch.ops import short_attention as sa  # noqa: E402

TOL = 1e-5
CASES = [(2, 3, 197, 197, 64), (2, 2, 65, 130, 32)]  # (b, h, n_q, n_k, d)


def _inputs(b, h, n_q, n_k, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, n_q, d), (b, h, n_k, d), (b, h, n_k, d), (b, h, n_q, d)))


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), (name, err)


@pytest.mark.parametrize("b,h,n_q,n_k,d", CASES)
def test_forward_and_vjp_match_jax_kernel(b, h, n_q, n_k, d):
    q, k, v, g = _inputs(b, h, n_q, n_k, d)
    scale = d ** -0.5
    out_want, vjp = jax.vjp(lambda *a: jax_short_attention(*a, scale, True),
                            *map(jnp.asarray, (q, k, v)))
    grads_want = vjp(jnp.asarray(g))
    counts = (sa.short_attention.launches, sa.short_attention_backward.launches)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = sa.short_attention(*inputs, scale)
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    assert (sa.short_attention.launches, sa.short_attention_backward.launches) == counts
    _close(out.detach(), out_want, "out")
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_want):
        _close(got, want, name)


def test_serving_forward_keeps_no_lse_and_matches_the_training_forward():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(*CASES[1], seed=1))
    with torch.no_grad():
        out = sa.short_attention(q, k, v)
    want, lse = sa.short_attention_forward_reference(q, k, v)
    assert torch.equal(out, want) and lse.shape == (2, 2, 65) and lse.dtype == torch.float32
    assert sa.short_attention_forward(q, k, v, need_lse=False)[1] is None


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """In f32, where no rounding point rounds: autograd through the plain
    forward against the plain backward (D from the stored output, p from the
    stored lse, as the kernel takes them), to f32 precision."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(2, 2, 40, 72, 32, seed=2))
    inputs = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = sa.short_attention_forward_reference(*inputs, 0.3)
    want = torch.autograd.grad(out, inputs, g)
    got = sa.short_attention_backward(q, k, v, out.detach(), lse.detach(), g, 0.3)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a, w, name)


def test_nb_layout_lays_the_gradients_in_one_buffer():
    """``layout="nb"``: the outputs are (b, h, n, d) views of (n, b, ·)
    memory, the three gradients views of one (n, b, 3, h, d) buffer, with
    the values of the plain versions."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(3, 2, 17, 17, 32, seed=3))
    out, lse = sa.short_attention_forward(q, k, v, layout="nb")
    assert out.permute(2, 0, 1, 3).is_contiguous()
    assert torch.equal(out, sa.short_attention_forward_reference(q, k, v)[0])
    dq, dk, dv = sa.short_attention_backward(q, k, v, out, lse, g, 32 ** -0.5, layout="nb")
    base = dq.data_ptr()
    assert dk.data_ptr() == base + 2 * 32 * 4 and dv.data_ptr() == base + 2 * 2 * 32 * 4
    assert dq.stride() == (3 * 2 * 32, 32, 3 * 3 * 2 * 32, 1)
    for a, w in zip((dq, dk, dv), sa.short_attention_backward_reference(q, k, v, out, lse, g,
                                                                        32 ** -0.5)):
        assert torch.equal(a, w)


@pytest.mark.parametrize("n_q,n_k,d,ok", [
    (512, 512, 128, True), (65, 130, 32, True), (0, 1, 64, True),
    (513, 64, 64, False), (64, 513, 64, False),  # MAX_SEQ
    (64, 0, 64, False), (64, 64, 48, False), (64, 64, 96, False),  # no key; no instance
])
def test_supported_shapes(n_q, n_k, d, ok):
    assert sa.short_attention_supported(n_q, n_k, d) == ok
