"""The port's fused MLP block against the JAX Pallas kernel it replaces.

On the CPU the port's ``fused_mlp`` runs its plain PyTorch version; the JAX
side runs ``vit_tpu.ops.fused_mlp`` in the Pallas interpreter with exact-erf
GELU, as ``tests/unit/test_fused_mlp.py`` does.  Same f32 inputs from
``numpy.random.default_rng``; tolerance 1e-5, the bar of the JAX kernel's own
tests.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vit_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp  # noqa: E402
from vit_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference  # noqa: E402

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
