"""The fused cross-attention op of the port against ``vit_tpu``'s Pallas kernel
pair, in f32 on the CPU, where the port's op runs its plain versions and the
JAX kernels run in interpret mode (as ``tests/unit/test_fused_cross_attention.py``
runs them).

The forward and the VJP of every input (dx, dxn, dWq, dk, dv, dWo, dbo) at
that file's shapes (3 images of 64 tokens against 9 keys, c 48, 2 heads, dh_k
16 / dh_v 24; 5 images of 24 tokens against 4 keys), at ScalableViT's SSA
widths (dh_k 40 / dh_v 32) and at Twins-SVT's global attention (8 heads of
64, c 64 and 128, 49 tokens over 16, 4 and 1 keys), within 1e-5 of max(1,
max|ref|): in f32 both
sides are exact attention and its gradient, and differ by summation order.
The plain version of the one-kernel forward (``cross_fwd``: q, oattn and lse
from its own rounding points) against ``_forward``'s y, q and oattn at
ScalableViT's widths, n_k 64, within 1e-4; the plain backward, fed the plain
forward's residuals, with either dsum (``cross_bwd``'s Σ p·dp or the four
steps' D from the stored output), against the VJP within TOL at each head
width, ragged n, n_k 49 and 64, c 64 and 256; and the wrapper's arguments to
C, with the library replaced by a recorder: serving allocates and passes no q
or lse, and no oattn where the one ``cross_fwd`` kernel takes the shape.
"""

import contextlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_tpu.ops import fused_cross_attention as jax_fca  # noqa: E402
from vit_tpu.ops.fused_cross_attention import fused_cross_attention_block  # noqa: E402
from vit_tpu_torch.ops import fused_cross_attention as fca  # noqa: E402

TOL = 1e-5
# (b, n, n_k, c, heads, dh_k, dh_v)
CASES = [
    (3, 64, 9, 48, 2, 16, 24),   # tests/unit/test_fused_cross_attention.py::_args
    (5, 24, 4, 48, 2, 16, 24),   # its batch-padding case
    (2, 64, 16, 64, 2, 40, 32),  # ScalableViT's SSA widths, stage 1 scaled down
    # Twins-SVT's global attention (8 heads of 64) at a ragged 49 tokens over
    # the key counts of its stages 2-4: 16, 4 and 1
    (2, 49, 16, 64, 8, 64, 64),
    (2, 49, 4, 128, 8, 64, 64),
    (2, 49, 1, 128, 8, 64, 64),
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


# cross_fwd's widths on ScalableViT's SSA at n_k 64: (b, n, n_k, c, heads,
# dh_k, dh_v), stages 1-3's (40, 32) and stage 4's (32, 32), scaled down.
FUSED_CASES = [(2, 96, 64, 64, 2, 40, 32), (2, 64, 64, 128, 4, 32, 32)]
FUSED_TOL = 1e-4


@pytest.mark.parametrize("b,n,n_k,c,heads,dh_k,dh_v", FUSED_CASES)
def test_fused_forward_plain_version_matches_jax_forward(b, n, n_k, c, heads, dh_k, dh_v):
    """The plain version of the one-kernel forward (y, and the residuals q,
    oattn it writes in training) against ``_forward``'s in interpret mode,
    and its lse against the log-sum-exp of JAX's q·kᵀ·scale: each within
    1e-4 of max(1, max|ref|) in f32."""
    args, _ = _inputs(b, n, n_k, c, heads, dh_k, dh_v, seed=5)
    scale = dh_k ** -0.5
    want = jax_fca._forward(*map(jnp.asarray, args), heads, dh_k, dh_v, scale, interpret=True,
                            save_residuals=True)
    got = fca.fused_cross_attention_forward_reference(*_to_port(args), heads, dh_k, dh_v, scale)
    for name, g, w in zip(("y", "q", "oattn"), got[:3], want):
        err = float(np.max(np.abs(g.numpy() - np.asarray(w))))
        assert g.shape == np.asarray(w).shape and \
            err <= FUSED_TOL * max(1.0, float(np.max(np.abs(np.asarray(w))))), (name, err)
    q = torch.from_numpy(np.array(want[1])).unflatten(-1, (heads, dh_k)).transpose(1, 2)
    k = torch.from_numpy(args[3]).unflatten(-1, (heads, dh_k)).transpose(1, 2)
    lse = torch.logsumexp(q @ k.transpose(-1, -2) * scale, dim=-1)
    assert float((got[3] - lse).abs().max()) <= FUSED_TOL * max(1.0, float(lse.abs().max()))


class _RecordingLib:
    """Stands in for the kernel library: records the forward entry point's
    arguments, launches nothing, and gives the shape's route."""

    def __init__(self, fused):
        self.fused, self.calls = fused, []

    def vit_fused_cross_attention_fused(self, *shape):
        return self.fused

    def vit_fused_cross_attention_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("fused", [1, 2, 0])
def test_serving_writes_no_residuals(monkeypatch, fused):
    """Serving passes null q and lse (it allocates neither) on the
    ``cross_fwd`` routes, and null oattn too where the one kernel takes the
    whole block (route 1; route 2's GEMM reads oattn); training passes all
    three, as does serving a shape that takes the three launches, which go
    through device memory."""
    lib = _RecordingLib(fused)
    monkeypatch.setattr(fca._build, "load", lambda: lib)
    monkeypatch.setattr(fca, "check_kernel_tensors", lambda *args: None)
    monkeypatch.setattr(fca, "launch_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    b, n, n_k, c, heads, dh_k, dh_v = 2, 64, 64, 64, 2, 40, 32
    x, xn, wq, k, v, wo, bo = (t.to(torch.bfloat16) for t in _to_port(
        _inputs(b, n, n_k, c, heads, dh_k, dh_v)[0]))
    served = fca._launch_forward(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, 0.1)
    trained = fca._launch_forward(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, 0.1,
                                  training=True)
    assert [t is None for t in served[1:]] == [fused != 0, fused == 1, fused != 0]
    assert tuple(trained[1].shape) == (b, n, heads * dh_k)
    assert tuple(trained[2].shape) == (b, n, heads * dh_v)
    assert trained[3].dtype == torch.float32 and tuple(trained[3].shape) == (b, heads, n)
    (*_, q_s, o_s, lse_s), (*_, q_t, o_t, lse_t) = (args[:11] for args in lib.calls)
    assert [t is None for t in (q_s, o_s, lse_s)] == [fused != 0, fused == 1, fused != 0]
    assert (q_t, o_t, lse_t) == tuple(t.data_ptr() for t in trained[1:])


# The plain backward at each (dh_k, dh_v) instance, ragged n, n_k 49 and 64,
# and c 64 and 256: either side of cross_bwd's split at 128 channels.
BACKWARD_CASES = [
    (2, 100, 49, 64, 2, 40, 32),   # stage 1's widths, 7 x 7 keys
    (1, 64, 64, 256, 8, 40, 32),   # stage 3's
    (2, 70, 64, 64, 2, 32, 32),
    (1, 65, 49, 256, 4, 64, 64),
]


@pytest.mark.parametrize("stored_output_d", [False, True])
@pytest.mark.parametrize("b,n,n_k,c,heads,dh_k,dh_v", BACKWARD_CASES)
def test_plain_backward_matches_jax_vjp(b, n, n_k, c, heads, dh_k, dh_v, stored_output_d):
    """The plain backward fed the plain forward's residuals, with the dsum
    cross_bwd takes (Σ p·dp, the TPU kernel's) or the four steps' D from the
    stored output, against the VJP of ``vit_tpu``'s
    ``fused_cross_attention_block`` (its Pallas kernels in interpret mode):
    dxn, dk, dv, dbo and dWq = xnᵀ·dq within TOL of max(1, max|ref|) in
    f32."""
    args, g = _inputs(b, n, n_k, c, heads, dh_k, dh_v, seed=7)
    scale = dh_k ** -0.5

    def jax_op(*a):
        return fused_cross_attention_block(*a, heads, dh_k, dh_v, scale, True)

    _, vjp = jax.vjp(jax_op, *map(jnp.asarray, args))
    _, want_dxn, want_dwq, want_dk, want_dv, _, want_dbo = vjp(jnp.asarray(g))
    x, xn, wq, k, v, wo, bo = _to_port(args)
    _, q, oattn, lse = fca.fused_cross_attention_forward_reference(x, xn, wq, k, v, wo, bo,
                                                                   heads, dh_k, dh_v, scale)
    dxn, dq, dk, dv, dbo = fca.fused_cross_attention_backward_reference(
        torch.from_numpy(g), q, k, v, oattn, lse, wq, wo, heads, dh_k, dh_v, scale,
        stored_output_d=stored_output_d)
    dwq = xn.reshape(-1, c).t() @ dq.reshape(-1, heads * dh_k)  # vit_tpu's (c, hk) layout
    for name, got, want in zip(("dxn", "dwq", "dk", "dv", "dbo"), (dxn, dwq, dk, dv, dbo),
                               (want_dxn, want_dwq, want_dk, want_dv, want_dbo)):
        _close(got, want, name)


def test_one_key_gives_exactly_zero_query_gradients():
    """Over one key (Twins-SVT's stage 4: a 7 x 7 map reduced to 1 x 1) the
    softmax is exactly 1 whatever the logit, so ds = p·(dp - Σ p·dp) is 0
    and dq, dk and dxn are exactly 0, as the TPU kernel, which recomputes
    the row's softmax, gives them; dv is doattn summed over the queries."""
    args, g = _inputs(2, 49, 1, 64, 8, 64, 64, seed=11)
    x, xn, wq, k, v, wo, bo = _to_port(args)
    _, q, oattn, lse = fca.fused_cross_attention_forward_reference(x, xn, wq, k, v, wo, bo,
                                                                   8, 64, 64)
    dy = torch.from_numpy(g)
    dxn, dq, dk, dv, _ = fca.fused_cross_attention_backward_reference(
        dy, q, k, v, oattn, lse, wq, wo, 8, 64, 64)
    assert not dxn.any() and not dq.any() and not dk.any()
    _close(dv, (dy @ wo).sum(1, keepdim=True), "dv")


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """In f32, where no rounding point rounds: autograd through the plain
    forward against the plain backward (which takes the softmax's dsum = Σ
    p·dp, as cross_bwd does), to f32 precision."""
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
