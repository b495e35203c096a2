"""Host-side logic of the Hopper attention kernels, on CPU tensors.

The flash backward and the short-attention forward read their operands
through TMA tensor maps, which ``vit_tpu_torch/csrc/hopper.cuh``'s
``head_map`` builds from the (batch, head, row) element strides that
``kernel_strides`` passes.  These tests pin those strides for each caller's
view, check that every caller's view is one a tensor map takes, and that the
views no map takes are refused (``_tma_problem``, which
``check_flash_tensors`` raises on before any launch).
"""

import pytest
import torch

from vit_tpu_torch.ops import flash_attention_packed as fap
from vit_tpu_torch.ops.flash_attention import _tma_problem, kernel_strides

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
