"""Host-side logic of the Hopper kernels fed by TMA, on CPU tensors.

The flash forward and backward and the short-attention forward and backward
read their operands through TMA tensor maps, which ``vit_tpu_torch/csrc/hopper.cuh``'s
``head_map`` builds from the (batch, head, row) element strides that
``kernel_strides`` passes.  These tests pin those strides for each caller's
view, check that every caller's view is one a tensor map takes, and that the
views no map takes are refused (``_tma_problem``, which
``check_flash_tensors`` raises on before any launch).  The hybrid layer's
forward GEMM (``gemm_wgmma.cu``: ``ln_gemm``'s QKV, ``proj_mlp``'s
out-projection, fc1 and fc2) reads its operands through 2-d maps
(``matrix_map``: rows their width apart), which take what the wrappers let
through: contiguous, 16-byte aligned, widths that are multiples of 8.
"""

import pytest
import torch

from vit_tpu_torch.ops import flash_attention_packed as fap
from vit_tpu_torch.ops import fused_hybrid as fh
from vit_tpu_torch.ops.flash_attention import _tma_problem, _token_major, kernel_strides

BF16 = torch.bfloat16


def _head_view(b, n, h, d, width=None):
    """A (b, h, n, d) view of a channels-last (b, n, width) map, head 0 at column 0."""
    t = torch.zeros(b, n, width or h * d, dtype=BF16)
    return t[..., :h * d].unflatten(-1, (h, d)).transpose(1, 2)


@pytest.mark.parametrize("name,view,strides", [
    ("contiguous (b, h, n, d)", torch.zeros(2, 3, 5, 64, dtype=BF16), [3 * 5 * 64, 5 * 64, 64]),
    # CvT's q: a view of the channels-last (b, n, h·d) map
    ("channels-last q", _head_view(2, 7, 3, 64), [7 * 192, 64, 192]),
    # CvT's k and v: the two halves of one (b, n_k, 2·h·d) projection
    ("k half", _head_view(2, 7, 3, 64, width=384), [7 * 384, 64, 384]),
    # ScalableViT's SSA q/k: 40 wide, the next head's columns 40 elements on
    ("packed dk 40", fap.split_heads(torch.zeros(2, 9, 2 * 40, dtype=BF16), 2), [9 * 80, 40, 80]),
    # attention_nb: q|k|v column views of one (n, b, 3·heads·dh) projection
    ("attention_nb k", torch.zeros(65, 4, 3 * 2 * 64, dtype=BF16)[..., 128:256]
     .unflatten(-1, (2, 64)).permute(1, 2, 0, 3), [384, 64, 4 * 384]),
    # size-1 batch, head and row axes: their strides address nothing and go as 8
    ("size-1 axes", torch.zeros(1, 1, 1, 32, dtype=BF16), [8, 8, 8]),
])
def test_kernel_strides_of_each_callers_view(name, view, strides):
    assert _tma_problem(view) is None, name
    assert list(kernel_strides(view)) == strides, name


def test_kernel_strides_give_size_one_axes_a_stride_a_map_takes():
    t = torch.zeros(1, 5, 3, 64, dtype=BF16).transpose(1, 2)[:, :1]  # (1, 1, 5, 64)
    assert list(kernel_strides(t)) == [8, 8, 3 * 64]


@pytest.mark.parametrize("name,view,match", [
    ("last axis not contiguous", torch.zeros(2, 2, 64, 64, dtype=BF16).transpose(2, 3),
     "not contiguous"),
    ("data 8 bytes off", torch.zeros(2, 2, 8, 68, dtype=BF16)[..., 4:], "16-byte aligned"),
    ("head stride of 120 bytes", fap.split_heads(torch.zeros(2, 8, 2 * 60, dtype=BF16), 2),
     "multiple of 16"),
    ("an expanded batch", torch.zeros(1, 2, 8, 64, dtype=BF16).expand(3, 2, 8, 64),
     "multiple of 16"),
])
def test_views_no_tensor_map_takes_are_refused(name, view, match):
    assert match in _tma_problem(view), name


@pytest.mark.parametrize("name,q,k,v,strides", [
    # CvT: channels-last q, k and v the halves of one (b, n_k, 2·h·d) projection
    ("CvT", _head_view(2, 7, 3, 64), _head_view(2, 5, 3, 64, width=384),
     _head_view(2, 5, 3, 64, width=384),
     [7 * 192, 64, 192, 5 * 384, 64, 384, 5 * 384, 64, 384]),
    # ScalableViT's SSA inside the cross-attention block and the packed op:
    # q/k 40 wide, v 32, each channel-packed (b, n, heads·d)
    ("packed 40/32", fap.split_heads(torch.zeros(2, 9, 2 * 40, dtype=BF16), 2),
     fap.split_heads(torch.zeros(2, 4, 2 * 40, dtype=BF16), 2),
     fap.split_heads(torch.zeros(2, 4, 2 * 32, dtype=BF16), 2),
     [9 * 80, 40, 80, 4 * 80, 40, 80, 4 * 64, 32, 64]),
    # one key: its row axis has size 1 and goes as 8
    ("one key", torch.zeros(2, 2, 3, 64, dtype=BF16), torch.zeros(2, 2, 1, 64, dtype=BF16),
     torch.zeros(2, 2, 1, 64, dtype=BF16), [384, 192, 64, 128, 64, 8, 128, 64, 8]),
])
def test_forward_passes_each_callers_strides_and_writes_token_major(name, q, k, v, strides):
    """The forward's q, k and v maps take every caller's view; its out (written
    through strides, not a map) is the token-major view the wrapper makes."""
    b, h, n_q, _ = q.shape
    out = _token_major(b, h, n_q, v.shape[-1], q)
    for t in (q, k, v):
        assert _tma_problem(t) is None, name
    dv = v.shape[-1]
    assert list(kernel_strides(q, k, v, out)) == strides + [n_q * h * dv, dv, h * dv], name


@pytest.mark.parametrize("rows,d,n_out", [(8320, 1024, 3072), (8333, 72, 200), (1, 8, 8)])
def test_gemm_operands_are_matrices_a_map_takes(rows, d, n_out):
    """xn (rows, d) and W (n_out, d) as ln_gemm's wrapper holds them: rows d
    elements apart, the row stride matrix_map is given."""
    for t in (torch.zeros(rows, d, dtype=BF16), torch.zeros(n_out, d, dtype=BF16)):
        assert _tma_problem(t) is None
        assert t.stride() == (d, 1)


@pytest.mark.parametrize("name,w,match", [
    ("rows of 136 bytes", torch.zeros(200, 68, dtype=BF16), "multiple of 16"),
    ("a transposed weight", torch.zeros(72, 200, dtype=BF16).t(), "not contiguous"),
    ("data 8 bytes off", torch.zeros(200 * 72 + 4, dtype=BF16)[4:].view(200, 72),
     "16-byte aligned"),
])
def test_gemm_operands_no_map_takes_are_refused(name, w, match):
    assert match in _tma_problem(w), name


def test_ln_gemm_refuses_widths_no_map_takes_before_any_launch():
    x, g = torch.zeros(5, 68, dtype=BF16), torch.ones(68, dtype=BF16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fh._launch_ln_gemm(x, g, g, torch.zeros(200, 68, dtype=BF16), 1e-3)
    with pytest.raises(ValueError, match="multiples of 8"):
        fh._launch_ln_gemm(x[:, :64], g[:64], g[:64], torch.zeros(204, 64, dtype=BF16), 1e-3)


@pytest.mark.parametrize("t,d,inner,hidden", [(8320, 1024, 1024, 2048), (2112, 96, 96, 160),
                                              (1, 8, 8, 8)])
def test_proj_mlp_gemm_operands_are_matrices_a_map_takes(t, d, inner, hidden):
    """proj_mlp's three forward GEMMs read o·Woᵀ, xn·W1ᵀ and g·W2ᵀ through 2-d
    maps: o, Wo, xn, W1, g and W2 as _launch_proj_mlp holds them (the caller's
    rows and the nn.Linear weights, and its own xn and g buffers), each a
    matrix whose rows lie its width apart."""
    x = torch.zeros(t, d, dtype=BF16)
    _, _, xn, g, h = fh._proj_mlp_buffers(x, hidden, save_residuals=True)
    operands = {"o": (torch.zeros(t, inner, dtype=BF16), inner),
                "wo": (torch.zeros(d, inner, dtype=BF16), inner), "xn": (xn, d),
                "w1": (torch.zeros(hidden, d, dtype=BF16), d), "g": (g, hidden),
                "w2": (torch.zeros(d, hidden, dtype=BF16), hidden)}
    for name, (m, width) in operands.items():
        assert _tma_problem(m) is None, name
        assert m.stride() == (width, 1), name
    assert h.shape == g.shape and h.is_contiguous()


@pytest.mark.parametrize("d,inner,hidden", [(68, 64, 128), (64, 68, 128), (64, 64, 204)])
def test_proj_mlp_refuses_widths_no_map_takes_before_any_launch(d, inner, hidden):
    x, o = torch.zeros(5, d, dtype=BF16), torch.zeros(5, inner, dtype=BF16)
    vd, vh = torch.zeros(d, dtype=BF16), torch.zeros(hidden, dtype=BF16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fh._launch_proj_mlp(x, o, torch.zeros(d, inner, dtype=BF16), vd, vd, vd,
                            torch.zeros(hidden, d, dtype=BF16), vh,
                            torch.zeros(d, hidden, dtype=BF16), vd, 1e-3, True)


def test_gemm_refuses_widths_no_map_takes_before_any_launch():
    with pytest.raises(ValueError, match="multiples of 8"):
        fh.gemm_wgmma(torch.zeros(5, 68, dtype=BF16, device="meta"),
                      torch.zeros(64, 68, dtype=BF16), "store")
