"""The LayerNorm backward as the dgrad's epilogue (``gemm_wgmma.cu``'s
``kEpiLnBwd``) and where the port takes it.

- Its plain version, ``fused_hybrid.gemm_reference(..., "ln_bwd", layout="kn")``
  (the kernel's order of sums: per-256-column row partials joined in a fixed
  order, 64-row column partials), against ``vit_tpu`` in f32: ``ln_gemm``'s
  backward kernel (``_ln_gemm_backward``, interpret mode) and the LayerNorm
  part of the fused MLP's and attention block's backward kernels
  (``_backward``, interpret mode, as ``tests/test_torch_backward.py`` runs
  them), fed the JAX kernel's own dh or dqkv; dx, dγ, dβ and Σ dy within 1e-4
  of max(1, max|JAX output|), at d 256, 768 and 1024 (clusters of one, three
  and four column tiles) over rows no multiple of 128.
- The widths it takes (``ln_bwd_fused``), pinned to the C constants.
- The backward wrappers, with the library replaced by a recorder: where it
  holds they pass no f32 dxn and no row statistics; elsewhere both.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vit_tpu.ops import fused_attention_block as jax_attn  # noqa: E402
from vit_tpu.ops import fused_hybrid as jfh  # noqa: E402
from vit_tpu.ops import fused_mlp as jax_mlp  # noqa: E402
from vit_tpu_torch.ops import _shared  # noqa: E402
from vit_tpu_torch.ops import fused_attention_block as fab  # noqa: E402
from vit_tpu_torch.ops import fused_hybrid as fh  # noqa: E402
from vit_tpu_torch.ops import fused_mlp as fm  # noqa: E402

TOL = 1e-4
EPS = 1e-3
BF16 = torch.bfloat16
# (d, b, n): one, three and four 256-column tiles; 134, 201 and 198 rows.
WIDTHS = [(256, 2, 67), (768, 3, 67), (1024, 2, 99)]


def _rn(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(want)))), (name, err)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _ln_bwd(a, w, x, gamma, dy=None):
    """The plain version of the LayerNorm-backward dgrad, through the GEMM's
    CPU path: (dx, dgamma, dbeta, dsum)."""
    return fh.gemm_wgmma(_t(a), _t(w), "ln_bwd", layout="kn", x=_t(x), gamma=_t(gamma),
                         dy=None if dy is None else _t(dy), eps=EPS)


@pytest.mark.parametrize("d,b,n", WIDTHS)
def test_plain_version_matches_ln_gemm_backward_kernel(d, b, n):
    """No residual: ``ln_gemm``'s backward (dqkv·W, then the LayerNorm's)."""
    rng = np.random.default_rng(d)
    rows, n_out = b * n, 96
    x, gamma = _rn(rng, rows, d, shift=0.5), _rn(rng, d, scale=0.1, shift=1.0)
    w, dout = _rn(rng, d, n_out, scale=0.05), _rn(rng, rows, n_out)  # vit_tpu's (in, out)
    want = jfh._ln_gemm_backward([jnp.asarray(dout)], jnp.asarray(x), jnp.asarray(gamma),
                                 jnp.asarray(w), EPS, 64, True, 1)
    dx, dgamma, dbeta, dsum = _ln_bwd(dout, w.T, x, gamma)
    assert dsum is None
    for name, got, w_ in zip(("dx", "dgamma", "dbeta"), (dx, dgamma, dbeta), want):
        _close(got, w_, name)


@pytest.mark.parametrize("d,b,n", WIDTHS)
def test_plain_version_matches_fused_mlp_backward_kernel(d, b, n):
    """The fused MLP's dh·W1 and LayerNorm backward, with the residual dy:
    dx, dγ, dβ and db2 = Σ dy, from the kernel's own dh."""
    rng = np.random.default_rng(d + 1)
    hidden = 64
    x, gamma = _rn(rng, b, n, d, shift=0.5), _rn(rng, d, scale=0.1, shift=1.0)
    beta, w1, b1 = _rn(rng, d, scale=0.1), _rn(rng, d, hidden, scale=0.05), _rn(rng, hidden)
    w2, b2, dy = _rn(rng, hidden, d, scale=0.05), _rn(rng, d, scale=0.05), _rn(rng, b, n, d)
    args = tuple(map(jnp.asarray, (x, gamma, beta, w1, b1, w2, b2)))
    _, _, h = jax_mlp._forward(*args, EPS, 64, True, save_residuals=True, gelu="exact")
    dx, dh, _, dgamma, dbeta, _, db2 = jax_mlp._backward(
        jnp.asarray(dy), args[0], h, args[1], args[3], args[5], EPS, 64, True, gelu="exact")
    got = _ln_bwd(np.asarray(dh).reshape(-1, hidden), w1.T, x.reshape(-1, d), gamma,
                  dy.reshape(-1, d))
    for name, g, w_ in zip(("dx", "dgamma", "dbeta", "db2"), got,
                           (np.asarray(dx).reshape(-1, d), dgamma, dbeta, db2)):
        _close(g, w_, name)


@pytest.mark.parametrize("d,b,n", WIDTHS)
def test_plain_version_matches_attention_block_backward_kernel(d, b, n):
    """The attention block's dqkv·Wqkv and LayerNorm backward, with the
    residual dy: dx, dγ, dβ and dbo = Σ dy, from the kernel's own dqkv."""
    rng = np.random.default_rng(d + 2)
    heads, dh = 2, 32
    inner = heads * dh
    x, gamma = _rn(rng, b, n, d, shift=0.5), _rn(rng, d, scale=0.1, shift=1.0)
    beta, wqkv = _rn(rng, d, scale=0.1), _rn(rng, d, 3 * inner, scale=0.05)
    wo, bo, dy = _rn(rng, inner, d, scale=0.05), _rn(rng, d, scale=0.05), _rn(rng, b, n, d)
    args = tuple(map(jnp.asarray, (x, gamma, beta, wqkv, wo, bo)))
    scale = dh ** -0.5
    _, _, qkv, _ = jax_attn._forward(*args, heads, dh, scale, EPS, True, save_residuals=True)
    dx, dqkv, dgamma, dbeta, dbo = jax_attn._backward(
        jnp.asarray(dy), args[0], qkv, args[1], args[3], args[4], heads, dh, scale, EPS,
        True)[:5]
    got = _ln_bwd(np.asarray(dqkv).reshape(-1, 3 * inner), wqkv.T, x.reshape(-1, d), gamma,
                  dy.reshape(-1, d))
    for name, g, w_ in zip(("dx", "dgamma", "dbeta", "dbo"), got,
                           (np.asarray(dx).reshape(-1, d), dgamma, dbeta, dbo)):
        _close(g, w_, name)


def test_fused_widths_are_the_cluster_sizes_c_takes():
    """256 ≤ d ≤ 2048 in steps of 256 (clusters of 1 to 8 CTAs, the portable
    size): ViT-B's 768 and 1024, ScalableViT's stages 3-4 (256, 512); not
    CvT's 64, 192 and 384 or ScalableViT's 64 and 128.  The Python mirror
    holds the constants ``gemm_wgmma.cu`` chooses by."""
    fused = [d for d in range(8, 4097, 8) if _shared.ln_bwd_fused(d)]
    assert fused == list(range(256, 2049, 256))
    src = (Path(fh.__file__).parents[1] / "csrc" / "gemm_wgmma.cu").read_text()
    consts = dict(re.findall(r"\b(kBN|kLnBwdMinD|kLnBwdMaxD) = (\d+)", src))
    assert (int(consts["kBN"]), int(consts["kLnBwdMinD"]), int(consts["kLnBwdMaxD"])) == (
        _shared.LN_BWD_TILE, _shared.LN_BWD_MIN_D, _shared.LN_BWD_MAX_D)
    assert re.search(r"bool ln_bwd_fused\(int d\) \{ return d % kBN == 0 && d >= kLnBwdMinD && "
                     r"d <= kLnBwdMaxD; \}", src)


@pytest.mark.parametrize("d", [256, 192])
def test_scratch_follows_the_predicate(d):
    dxn, stats = _shared.ln_bwd_scratch(33, d, "cpu")
    if _shared.ln_bwd_fused(d):
        assert dxn is None and stats is None
    else:
        assert tuple(dxn.shape) == (33, d) and tuple(stats.shape) == (33, 2)
        assert dxn.dtype == stats.dtype == torch.float32


class _Recorder:
    """Stands in for the kernel library: records the backward entry points'
    arguments and launches nothing."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if name.startswith("vit_") and name.endswith("_bwd"):
            def record(*args):
                self.calls[name] = args
                return 0
            return record
        raise AttributeError(name)

    def vit_ln_bwd_partial_rows(self, rows):
        return (rows + 63) // 64

    def vit_linear_partial_rows(self, rows):
        return 2 * ((rows + 127) // 128)

    def vit_short_attention_parts(self, n_k, d):
        return 1


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    for mod in (fm, fab, fh):
        monkeypatch.setattr(mod._build, "load", lambda: lib)
        monkeypatch.setattr(mod, "check_kernel_tensors", lambda *args: None)
        monkeypatch.setattr(mod, "launch_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return lib


def _zeros(*shape):
    return torch.zeros(*shape, dtype=BF16)


def _launch(op, d):
    """One backward wrapper's CUDA path at width d (33 rows), its entry
    point's name and the (dxn, stats) positions in its arguments."""
    b, n, inner, hidden = 3, 11, 64, 96
    rows = b * n
    g = torch.ones(d, dtype=BF16)
    if op == "fused_mlp":
        fm._launch_backward(_zeros(b, n, d), _zeros(b, n, d), _zeros(b, n, hidden), g,
                            _zeros(hidden, d), _zeros(d, hidden), EPS)
        return "vit_fused_mlp_bwd", (11, 12)
    if op == "fused_attention_block":
        qkv, oattn, lse = _zeros(b, n, 3 * inner), _zeros(b, n, inner), torch.zeros(b, 2, n)
        fab._launch_backward(_zeros(b, n, d), _zeros(b, n, d), qkv, g, _zeros(3 * inner, d),
                             _zeros(d, inner), 2, 32, 32 ** -0.5, EPS, oattn=oattn, lse=lse)
        return "vit_fused_attention_block_bwd", (17, 18)
    if op == "ln_gemm":
        fh._launch_ln_gemm_backward(_zeros(rows, 3 * inner), _zeros(rows, d), g,
                                    _zeros(3 * inner, d), EPS)
        return "vit_ln_gemm_bwd", (6, 7)
    fh._launch_proj_mlp_backward(_zeros(rows, d), _zeros(rows, d), _zeros(rows, hidden), g,
                                 _zeros(d, inner), _zeros(hidden, d), _zeros(d, hidden), EPS)
    return "vit_proj_mlp_bwd", (14, 15)


@pytest.mark.parametrize("d", [256, 768, 192])
@pytest.mark.parametrize("op", ["fused_mlp", "fused_attention_block", "ln_gemm", "proj_mlp"])
def test_backwards_pass_no_dxn_where_the_epilogue_takes_the_width(recorder, op, d):
    """Rows 2, 4, 12 and 14's backwards pass C null dxn and stats where
    ``ln_bwd_fused(d)`` holds (C then takes the LayerNorm-backward dgrad and
    refuses no null), and an f32 (rows, d) dxn and (rows, 2) stats where it
    does not (C's f32 dgrad and layernorm.cu's passes)."""
    entry, (i_dxn, i_stats) = _launch(op, d)
    args = recorder.calls[entry]
    if _shared.ln_bwd_fused(d):
        assert args[i_dxn] is None and args[i_stats] is None
    else:
        assert isinstance(args[i_dxn], int) and isinstance(args[i_stats], int)
