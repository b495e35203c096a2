"""The port's fused MLP block against the JAX Pallas kernel it replaces.

On the CPU the port's ``fused_mlp`` runs its plain PyTorch version; the JAX
side runs ``vit_tpu.ops.fused_mlp`` in the Pallas interpreter with exact-erf
GELU, as ``tests/unit/test_fused_mlp.py`` does.  Same f32 inputs from
``numpy.random.default_rng``; tolerance 1e-5, the bar of the JAX kernel's own
tests.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp  # noqa: E402
from vit_tpu.ops.fused_mlp import fused_mlp_3d as jax_fused_mlp_3d  # noqa: E402
from vit_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from vit_tpu_torch.ops._shared import ln_stats  # noqa: E402
from vit_tpu_torch.ops.fused_mlp import (  # noqa: E402
    fused_mlp, fused_mlp_forward_reference, fused_mlp_ragged_reference, fused_mlp_reference,
    fused_mlp_supported, kernel_operands, padded_width,
)

TOL = 1e-5


def _args(shape, hidden, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]

    def f(*s, scale=1.0, shift=0.0):
        return (rng.standard_normal(s) * scale + shift).astype(np.float32)

    return (f(*shape), f(d, scale=0.1, shift=1.0), f(d, scale=0.1),
            f(d, hidden, scale=0.05), f(hidden, scale=0.05),
            f(hidden, d, scale=0.05), f(d, scale=0.05))


def _torch_args(x, gamma, beta, w1, b1, w2, b2):
    # Flax Dense kernels are (in, out); nn.Linear weights are (out, in).
    t = torch.from_numpy
    return t(x), t(gamma), t(beta), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2)


@pytest.mark.parametrize("shape,hidden", [
    ((2, 17, 64), 128),
    ((3, 67, 96), 160),
    ((197, 96), 160),
    ((67, 64), 96),
])
def test_fused_mlp_matches_jax_kernel(shape, hidden):
    args = _args(shape, hidden)
    # block_t 64: several token blocks and a ragged last one on the 2-D path.
    want = np.asarray(jax_fused_mlp(*map(jnp.asarray, args), 1e-3, 64, True, "exact"))
    before = fused_mlp.launches
    got = fused_mlp(*_torch_args(*args)).numpy()
    assert fused_mlp.launches == before  # CPU tensors never reach the kernel
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL


def test_fused_mlp_reference_eps_matches_jax():
    args = _args((2, 9, 64), 96, seed=3)
    want = np.asarray(jax_fused_mlp(*map(jnp.asarray, args), 1e-5, 64, True, "exact"))
    got = fused_mlp_reference(*_torch_args(*args), eps=1e-5).numpy()
    assert np.max(np.abs(got - want)) <= TOL


# T2T-ViT's token transformers: d = hidden = 147 (3·7·7) and 1323 (147·3·3),
# widths off 8, a few dozen rows.
T2T_WIDTHS = [((2, 17, 147), 147), ((3, 11, 1323), 1323)]
T2T_TOL = 1e-4


@pytest.mark.parametrize("shape,hidden", T2T_WIDTHS)
def test_fused_mlp_matches_jax_kernel_at_t2t_widths(shape, hidden):
    """Forward and VJP at 147 and 1323 against ``vit_tpu``'s ``fused_mlp_3d``
    in the Pallas interpreter (exact erf): the port's plain versions, which
    the kernels at these widths are held to on the card."""
    args = _args(shape, hidden, seed=5)
    g = np.random.default_rng(6).standard_normal(shape).astype(np.float32)

    def jax_op(*a):
        return jax_fused_mlp_3d(*a, 1e-3, 64, True, "exact")

    want, vjp = jax.vjp(jax_op, *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(g))
    inputs = [t.requires_grad_() for t in _torch_args(*args)]
    got = fused_mlp(*inputs)
    assert np.max(np.abs(got.detach().numpy() - np.asarray(want))) <= TOL
    grads = torch.autograd.grad(got, inputs, torch.from_numpy(g))
    for name, got_g, want_g in zip(("x", "gamma", "beta", "w1", "b1", "w2", "b2"), grads,
                                   want_grads):
        want_g = np.asarray(want_g)
        if name in ("w1", "w2"):  # Flax (in, out) against nn.Linear (out, in)
            want_g = want_g.T
        assert got_g.shape == want_g.shape, name
        assert np.max(np.abs(got_g.numpy() - want_g)) <= T2T_TOL, name


@pytest.mark.parametrize("shape,hidden", T2T_WIDTHS + [((5, 64), 40), ((4, 27), 64)])
def test_padded_route_plain_version_equals_the_unpadded_one(shape, hidden):
    """The route the kernels take at widths off 8 (zero-padded parameter
    copies, xn and h at the padded widths, LayerNorm statistics over the true
    width) computes the block's function: within 1e-5 of the unpadded plain
    version in f32, every pad column exactly 0.  Statistics over the padded
    width, the trap, would move y far past that."""
    x, *params = _torch_args(*_args(shape, hidden, seed=7))
    d = shape[-1]
    y, xn, h = fused_mlp_forward_reference(x, *params)
    yp, xnp, hp = fused_mlp_ragged_reference(x, *params)
    dp, hidden_p = padded_width(d), padded_width(hidden)
    assert xnp.shape[-1] == dp and hp.shape[-1] == hidden_p
    assert torch.all(xnp[..., d:] == 0) and torch.all(hp[..., hidden:] == 0)
    for got, want in ((yp, y), (xnp[..., :d], xn), (hp[..., :hidden], h)):
        assert float((got - want).abs().max()) <= TOL
    if dp != d:  # normalising the zero-padded row instead moves every output
        gamma, beta, w1, b1, w2, b2 = kernel_operands(*params)
        xz = F.pad(x, (0, dp - d))
        mu, rstd = ln_stats(xz, 1e-3)
        wrong = xz + F.linear(F.gelu(F.linear((xz - mu) * rstd * gamma + beta, w1, b1)), w2, b2)
        assert float((wrong[..., :d] - y).abs().max()) > 1e-3


def test_kernel_operands_pad_with_zeros_and_only_once():
    x, gamma, beta, w1, b1, w2, b2 = _torch_args(*_args((3, 147), 147, seed=8))
    ops = kernel_operands(gamma, beta, w1, b1, w2, b2)
    shapes = [tuple(t.shape) for t in ops]
    assert shapes == [(152,), (152,), (152, 152), (152,), (152, 152), (152,)]
    for padded, t in zip(ops, (gamma, beta, w1, b1, w2, b2)):
        assert torch.equal(padded[tuple(slice(0, n) for n in t.shape)], t)
        rest = padded.clone()
        rest[tuple(slice(0, n) for n in t.shape)] = 0
        assert not rest.any()
    again = kernel_operands(*ops)
    assert all(a is b for a, b in zip(again, ops))  # already padded: no second copy
    aligned = _torch_args(*_args((3, 64), 96))[1:]
    assert all(a is b for a, b in zip(kernel_operands(*aligned), aligned))
    assert (padded_width(147), padded_width(1323), padded_width(64)) == (152, 1328, 64)
    assert fused_mlp_supported(147, 147) and fused_mlp_supported(1323, 1323)
    assert not fused_mlp_supported(0, 64)


class _Library:
    """Stands in for the kernel library: records the ragged entry points'
    scalar arguments and copies out the f16 parameter copies they are given
    (through their pointers: the tensors are on the CPU), launching nothing."""

    def __init__(self):
        self.calls = {}

    @staticmethod
    def _read(ptr, *shape):
        n = int(np.prod(shape))
        return np.ctypeslib.as_array((ctypes.c_uint16 * n).from_address(ptr)) \
            .view(np.float16).reshape(shape).copy()

    def vit_fused_mlp_fwd_ragged(self, *args):
        (x, gamma, beta, w1, b1, w2, b2, y, xn, xp, g, h, yp, rows, d, dp, hp, eps, dtype,
         stream) = args
        self.calls["fwd"] = dict(
            rows=rows, d=d, dp=dp, hp=hp, x=x, y=y, scratch=(xp, yp), h=h,
            gamma=self._read(gamma, dp), beta=self._read(beta, dp), w1=self._read(w1, hp, dp),
            b1=self._read(b1, hp), w2=self._read(w2, dp, hp), b2=self._read(b2, dp))
        return 0

    def vit_fused_mlp_bwd_ragged(self, *args):
        (dy, x, h, gamma, w1, w2, dx, dh, gact, sums_h, sums_d, dxn, stats, part_h, part_d, dyp,
         rows, d, dp, hp, eps, dtype, stream) = args
        self.calls["bwd"] = dict(rows=rows, d=d, dp=dp, hp=hp, dy=dy, x=x, h=h, dx=dx,
                                 scratch=(dxn, stats, dyp), w=(gamma, w1, w2))
        return 0

    def vit_linear_partial_rows(self, rows):
        return 2 * ((rows + 127) // 128)

    def vit_ln_bwd_partial_rows(self, rows):
        return (rows + 63) // 64


@pytest.mark.parametrize("d,rows", [(147, 6), (1323, 4)])
def test_wrappers_pass_the_true_width_and_padded_copies_to_c(monkeypatch, d, rows):
    """At 147 and 1323 the forward and backward wrappers pass C the module's
    width d for x, y, dy and dx (their own pointers: no copy in Python), the
    padded width and stride for the scratch rows and the parameter copies,
    and copies whose pad rows and columns are zero; the backward takes the
    forward's copies and its h as they are."""
    lib = _Library()
    monkeypatch.setattr(fm._build, "load", lambda: lib)
    monkeypatch.setattr(fm, "check_kernel_tensors", lambda *args: None)
    monkeypatch.setattr(fm, "launch_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    rng = np.random.default_rng(9)

    def f16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float16))

    x, dy = f16(2, rows // 2, d), f16(2, rows // 2, d)
    params = (f16(d), f16(d), f16(d, d), f16(d), f16(d, d), f16(d))
    ops = kernel_operands(*params)
    y, xn, h = fm._launch_forward(x, *ops, 1e-3, save_residuals=True)
    fwd = lib.calls["fwd"]
    dp = padded_width(d)
    assert (fwd["rows"], fwd["d"], fwd["dp"], fwd["hp"]) == (rows, d, dp, dp)
    assert (fwd["x"], fwd["y"], fwd["h"]) == (x.data_ptr(), y.data_ptr(), h.data_ptr())
    assert all(isinstance(p, int) for p in fwd["scratch"])
    assert y.shape == x.shape and xn.shape[-1] == h.shape[-1] == dp
    for name, want in zip(("gamma", "beta", "w1", "b1", "w2", "b2"), params):
        got = fwd[name]
        inside = tuple(slice(0, n) for n in want.shape)
        assert np.array_equal(got[inside], want.numpy()), name
        got[inside] = 0
        assert not got.any(), name  # the pad rows and columns
    fm._launch_backward(dy, x, h, ops[0], ops[2], ops[4], 1e-3)
    bwd = lib.calls["bwd"]
    assert (bwd["rows"], bwd["d"], bwd["dp"], bwd["hp"]) == (rows, d, dp, dp)
    assert (bwd["dy"], bwd["x"], bwd["h"]) == (dy.data_ptr(), x.data_ptr(), h.data_ptr())
    assert bwd["w"] == (ops[0].data_ptr(), ops[2].data_ptr(), ops[4].data_ptr())
    assert all(isinstance(p, int) for p in bwd["scratch"])
