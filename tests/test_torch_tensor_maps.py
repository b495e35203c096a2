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
through: contiguous, 16-byte aligned, widths that are multiples of 8.  So do
the block backwards' dgrads on the same GEMM, whose weights are read as they
lie, ``(k, n)`` with n contiguous (B MN-major); and so do the fused MLP's
and the attention block's forward GEMMs (fc1, fc2, QKV and the
out-projection, on the same kernel from n = 256) over the buffers their
wrappers allocate.  The short route of the attention block (``short_fwd`` and
``short_bwd`` over the packed qkv, chosen by ``attention_route`` for both
directions) passes the strides of its column views; the forward keeps the lse
the backward reads exactly on that route.  The cross-attention block's
backward (``cross_bwd``) passes its operands as they lie, each a view its maps
take, and refuses widths and routes it cannot take before any launch;
proj_mlp's backward passes its three dgrad weights as they lie.
"""

import contextlib

import pytest
import torch

from vit_tpu_torch.ops import flash_attention_packed as fap
from vit_tpu_torch.ops import fused_attention_block as fab
from vit_tpu_torch.ops import fused_hybrid as fh
from vit_tpu_torch.ops import fused_mlp as fm
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


# The short route's shapes: ViT-B/32's, ViT-B/16's, ragged ones, and
# Twins-SVT's 7 x 7 windows folded into the batch (49 tokens, 8 heads of 64:
# a (rows, 1536) qkv over a 64-wide model).
SHORT_SHAPES = [(128, 65, 16, 64), (64, 197, 12, 64), (3, 67, 3, 32), (1, 300, 2, 128),
                (8, 49, 8, 64)]


@pytest.mark.parametrize("b,n,heads,dh", SHORT_SHAPES)
def test_short_route_passes_the_packed_projections_strides(b, n, heads, dh):
    """The attention block's backward on the short route: q, k and v are the
    column thirds of the packed (b, n, 3·inner) qkv (batch stride n·3·inner,
    head stride dh, row stride 3·inner), O and dO the (b, n, inner) oattn and
    doattn, dq, dk and dv the thirds of dqkv, written through qkv's strides;
    the C entry point finds k and v (dk, dv) 2·inner bytes apart."""
    inner = heads * dh
    qkv, dqkv = (torch.zeros(b, n, 3 * inner, dtype=BF16) for _ in range(2))
    oattn, doattn = (torch.zeros(b, n, inner, dtype=BF16) for _ in range(2))
    views = fab.short_route_views(qkv, oattn, doattn, dqkv, heads, dh)
    packed = [n * 3 * inner if b > 1 else 8, dh, 3 * inner]
    assert list(kernel_strides(*views)) == packed * 3 + [n * inner if b > 1 else 8, dh, inner] * 2 \
        + packed * 3
    for v in views:
        assert _tma_problem(v) is None and tuple(v.shape) == (b, heads, n, dh)
    for base, thirds in ((qkv, views[:3]), (dqkv, views[5:])):
        assert [t.data_ptr() - base.data_ptr() for t in thirds] == [0, 2 * inner, 4 * inner]
    assert views[3].data_ptr() == oattn.data_ptr() and views[4].data_ptr() == doattn.data_ptr()


ROUTES_BY_SHAPE = [(65, False, "short"), (197, False, "short"), (512, False, "short"),
                   (513, False, "mha"), (600, False, "mha"), (65, True, "short"),
                   (257, True, "short"), (512, True, "short"), (513, True, "mha")]


@pytest.mark.parametrize("n,biased,route", ROUTES_BY_SHAPE)
def test_backward_route_is_chosen_by_shape(n, biased, route):
    """ViT-B/32's 65, ViT-B/16's 197 and the small-dataset ViT's 257 tokens
    (LSA's bias) take short_fwd and short_bwd, with or without a bias; more
    than 512 tokens keep mha_fwd and mha_bwd.  One function chooses for both
    directions, by the token count alone: it takes no bias, so a biased case
    (``biased``, driven through both directions by
    test_forward_and_backward_take_one_route) routes as its token count."""
    assert fab.attention_route(n) == route


class _RecordingLib:
    """Stands in for the kernel library: records the arguments the block's
    entry points are given and launches nothing."""

    def __init__(self):
        self.calls = {}

    def vit_fused_attention_block_fwd(self, *args):
        self.calls.setdefault("fwd", []).append(args)
        return 0

    def vit_fused_attention_block_bwd(self, *args):
        self.calls.setdefault("bwd", []).append(args)
        return 0

    def vit_ln_bwd_partial_rows(self, rows):
        return 1

    def vit_short_attention_parts(self, n_k, d):
        return 1


@pytest.fixture
def recording_lib(monkeypatch):
    """The block's wrappers on CPU tensors, each call recorded by a
    :class:`_RecordingLib`: what they pass to the C entry points, with the
    device checks and the stream left out."""
    lib = _RecordingLib()
    monkeypatch.setattr(fab._build, "load", lambda: lib)
    monkeypatch.setattr(fab, "check_kernel_tensors", lambda *args: None)
    monkeypatch.setattr(fab, "launch_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("n,biased,route", ROUTES_BY_SHAPE)
def test_forward_and_backward_take_one_route(recording_lib, n, biased, route):
    """The forward and the backward pass one route to C: on the short route
    the forward passes short_fwd's strides over the packed qkv and oattn and,
    in training only, an f32 (b, heads, n) lse, and the backward passes
    short_bwd's strides and that lse; on the mha route neither passes
    strides, and no lse is kept.  A bias goes with either route, in both
    directions.  Each direction counts its route."""
    b, d, heads, dh = 2, 64, 2, 32
    inner = heads * dh
    x, dy = torch.zeros(b, n, d, dtype=BF16), torch.zeros(b, n, d, dtype=BF16)
    g, bo = torch.ones(d, dtype=BF16), torch.zeros(d, dtype=BF16)
    wqkv, wo = torch.zeros(3 * inner, d, dtype=BF16), torch.zeros(d, inner, dtype=BF16)
    bias = torch.zeros(1, n, n) if biased else None
    counts = [r[route].launches for r in (fab.FORWARD_ROUTES, fab.BACKWARD_ROUTES)]
    served = fab._launch_forward(x, g, g, wqkv, wo, bo, heads, dh, dh ** -0.5, 1e-3, bias)
    _, _, qkv, oattn, lse = fab._launch_forward(x, g, g, wqkv, wo, bo, heads, dh, dh ** -0.5,
                                                1e-3, bias, training=True)
    assert served[4] is None
    short = route == "short"
    packed = [n * 3 * inner, dh, 3 * inner]
    for (*_, lse_ptr, strides, bias_ptr, hb), keeps in zip(
            (args[:14] for args in recording_lib.calls["fwd"]), (False, True)):
        assert (strides is not None) == short and bool(bias_ptr) == biased
        if short:
            assert list(strides) == packed * 3 + [n * inner, dh, inner]
        assert (lse_ptr is not None) == (short and keeps)
    assert (lse is not None) == short
    if short:
        assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, heads, n)
        assert lse.is_contiguous()
    fab._launch_backward(dy, x, qkv, g, wqkv, wo, heads, dh, dh ** -0.5, 1e-3, bias,
                         oattn=oattn, lse=lse)
    (bwd,) = recording_lib.calls["bwd"]
    lse_ptr, strides, bias_ptr = bwd[4], bwd[12], bwd[18]
    assert (strides is not None) == short and bool(bias_ptr) == biased
    if short:
        assert lse_ptr == lse.data_ptr() and list(strides)[:12] == packed * 3 + [
            n * inner, dh, inner]
    assert [r[route].launches for r in (fab.FORWARD_ROUTES, fab.BACKWARD_ROUTES)] == \
        [counts[0] + 2, counts[1] + 1]


@pytest.mark.parametrize("n,need_dbias", [(257, True), (257, False), (65, True), (600, True)])
def test_biased_backward_passes_row_statistics_only_for_dbias(recording_lib, n, need_dbias):
    """The biased backward passes the bias and its head count on either
    route; an f32 (b, heads, n, 2) rowstat, where the short route's short_bwd
    writes (lse, D) for the dbias pass, only when dbias is asked for there
    (mha_bwd always takes it as scratch), with dbias (hb, n, n) f32 and its
    parts."""
    b, d, heads, dh = 2, 64, 2, 32
    inner = heads * dh
    x = torch.zeros(b, n, d, dtype=BF16)
    g, bo = torch.ones(d, dtype=BF16), torch.zeros(d, dtype=BF16)
    wqkv, wo = torch.zeros(3 * inner, d, dtype=BF16), torch.zeros(d, inner, dtype=BF16)
    bias = torch.zeros(heads, n, n)
    recording_lib.vit_attention_dbias_parts = lambda *args: 3
    _, _, qkv, oattn, lse = fab._launch_forward(x, g, g, wqkv, wo, bo, heads, dh, dh ** -0.5,
                                                1e-3, bias, training=True)
    out = fab._launch_backward(x, x, qkv, g, wqkv, wo, heads, dh, dh ** -0.5, 1e-3, bias,
                               need_dbias, oattn=oattn, lse=lse)
    (bwd,) = recording_lib.calls["bwd"]
    short = fab.attention_route(n) == "short"
    strides, rowstat, bias_ptr, hb, dbias_ptr = bwd[12], bwd[14], bwd[18], bwd[19], bwd[20]
    assert (strides is not None) == short and (bias_ptr, hb) == (bias.data_ptr(), heads)
    assert (rowstat is not None) == (need_dbias or not short)
    assert (dbias_ptr is not None) == need_dbias
    if need_dbias:
        assert tuple(out[5].shape) == (heads, n, n) and out[5].dtype == torch.float32
    else:
        assert out[5] is None


@pytest.mark.parametrize("b,n,heads,dh", SHORT_SHAPES)
def test_short_forward_passes_the_packed_projections_strides(b, n, heads, dh):
    """The attention block's forward on the short route: short_fwd reads q,
    k and v as the column thirds of the (b, n, 3·inner) qkv its wrapper
    allocates and writes O through the strides of its (b, n, inner) oattn,
    the backward's first four views; the C entry point finds k and v 2·inner
    bytes after q."""
    x = torch.zeros(b, n, 8, dtype=BF16, device="meta")
    _, _, qkv, oattn = fab._forward_buffers(x, heads, dh)
    qkv, oattn = torch.zeros_like(qkv, device="cpu"), torch.zeros_like(oattn, device="cpu")
    inner = heads * dh
    views = fab.short_forward_views(qkv, oattn, heads, dh)
    packed = [n * 3 * inner if b > 1 else 8, dh, 3 * inner]
    assert list(fab.short_route_strides("block", views)) == \
        packed * 3 + [n * inner if b > 1 else 8, dh, inner]
    assert [t.data_ptr() - qkv.data_ptr() for t in views[:3]] == [0, 2 * inner, 4 * inner]
    assert views[3].data_ptr() == oattn.data_ptr()
    assert all(tuple(v.shape) == (b, heads, n, dh) for v in views)
    backward = fab.short_route_views(qkv, oattn, oattn, qkv, heads, dh)
    assert all(v.stride() == w.stride() for v, w in zip(views, backward[:4]))
    # What the wrappers pass, computed once per shape.
    assert list(fab._short_strides(b, n, heads, dh, backward=False)) == \
        list(fab.short_route_strides("block", views))
    assert list(fab._short_strides(b, n, heads, dh, backward=True)) == \
        list(fab.short_route_strides("block", backward))


@pytest.mark.parametrize("name,offset,width", [("qkv 8 bytes off", 4, None),
                                               ("rows of 392 bytes", 0, 196)])
def test_short_route_refuses_views_no_map_takes_before_any_launch(name, offset, width):
    """A packed projection whose data or rows are off the 16-byte grid has
    no tensor map: the short route's strides raise instead."""
    heads, dh, n = 2, 32, 5
    width = width or 3 * heads * dh
    buf = torch.zeros(2 * n * width + offset, dtype=BF16)[offset:].view(2, n, width)
    qkv = buf[..., :3 * heads * dh]
    views = fab.short_forward_views(qkv, torch.zeros(2, n, heads * dh, dtype=BF16), heads, dh)
    with pytest.raises(ValueError, match="no tensor map takes"):
        fab.short_route_strides("fused_attention_block", views)
    with pytest.raises(ValueError, match="no tensor map takes"):  # heads 8 bytes apart
        fab._short_strides(2, n, heads, 4, backward=False)


@pytest.mark.parametrize("rows,d,heads,dh,hidden", [
    (8320, 1024, 16, 64, 2048),     # ViT-B/32 @256, batch 128
    (12608, 768, 12, 64, 3072),     # ViT-B/16 @224, batch 64
    (262144, 64, None, None, 256),  # ScalableViT @256's conv-MLPs, batch 64: stage 1
    (65536, 128, None, None, 512),  # stage 2
    (16384, 256, None, None, 1024),  # stage 3
    (4096, 512, None, None, 2048),  # stage 4
])
def test_block_forward_gemm_operands_are_matrices_a_map_takes(rows, d, heads, dh, hidden):
    """fc1 (xn·W1ᵀ), fc2 (g·W2ᵀ), QKV (xn·Wqkvᵀ) and the out-projection
    (oattn·Woᵀ) read their A operand and the nn.Linear weight through 2-d
    maps: the buffers _forward_buffers allocates and the weights as they
    lie, each a matrix whose rows lie its width apart, and h (fc1's kept
    pre-activation, an output) laid out as g."""
    x = torch.zeros(rows, d, dtype=BF16, device="meta")
    y, xn, g, h = fm._forward_buffers(x, hidden, save_residuals=True)
    operands = {"xn": (xn, d), "w1": (_meta(hidden, d), d), "g": (g, hidden),
                "w2": (_meta(d, hidden), hidden), "y": (y, d)}
    if heads:
        inner = heads * dh
        b, n = {8320: (128, 65), 12608: (64, 197)}[rows]
        _, xn3, qkv, oattn = fab._forward_buffers(x.view(b, n, d), heads, dh)
        operands |= {"xn (block)": (xn3.view(rows, d), d), "qkv": (qkv.view(rows, -1), 3 * inner),
                     "wqkv": (_meta(3 * inner, d), d), "oattn": (oattn.view(rows, -1), inner),
                     "wo": (_meta(d, inner), inner)}
    for name, (m, width) in operands.items():
        assert _tma_problem(m) is None, name
        assert m.stride() == (width, 1), name
    assert h.shape == g.shape and h.is_contiguous()


class _HybridRecorder:
    """Stands in for the kernel library: records proj_mlp's backward entry
    point's arguments and launches nothing."""

    def __init__(self):
        self.calls = []

    def vit_proj_mlp_bwd(self, *args):
        self.calls.append(args)
        return 0

    def vit_linear_partial_rows(self, rows):
        return 2 * ((rows + 127) // 128)

    def vit_ln_bwd_partial_rows(self, rows):
        return 1


@pytest.mark.parametrize("rows,d,inner,hidden", [(8320, 1024, 1024, 2048), (12608, 768, 768, 3072),
                                                 (262144, 64, 64, 256), (33, 104, 96, 264)])
def test_dgrad_weights_are_maps_of_the_weight_as_it_lies(monkeypatch, rows, d, inner, hidden):
    """The dgrads dy·Wo, dqkv·Wqkv, dy·W2 and dh·W1 read each nn.Linear
    weight (out, in) as the (k, n) matrix B with n contiguous: a 2-d map of
    k rows n elements apart, 64 x 64 boxes (the 128-byte swizzle's width) at
    columns n0, n0 + 64, ..., the A operand (dy, dqkv, dh) as the forward
    GEMM's, rows k apart.  proj_mlp's backward, whose three dgrads (dz·W2,
    dh·W1, dy·Wo) run the same GEMM, passes Wo, W1 and W2 to C as they lie
    (no transposed copy), with the library replaced by a recorder (at 64
    rows or fewer: the widths make the maps)."""
    weights = {"wo": (torch.zeros(d, inner, dtype=BF16), d, inner),
               "wqkv": (torch.zeros(3 * inner, d, dtype=BF16), 3 * inner, d),
               "w2": (torch.zeros(d, hidden, dtype=BF16), d, hidden),
               "w1": (torch.zeros(hidden, d, dtype=BF16), hidden, d)}
    for name, (w, k, n) in weights.items():
        assert _tma_problem(w) is None, name
        assert tuple(w.shape) == (k, n) and w.stride() == (n, 1), name
    for a, k in ((torch.zeros(rows, d, dtype=BF16), d), (torch.zeros(rows, hidden, dtype=BF16),
                                                           hidden)):
        assert _tma_problem(a) is None and a.stride() == (k, 1)
    lib = _HybridRecorder()
    monkeypatch.setattr(fh._build, "load", lambda: lib)
    monkeypatch.setattr(fh, "check_kernel_tensors", lambda *args: None)
    monkeypatch.setattr(fh, "launch_stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    t = min(rows, 64)
    dz, y, h = (torch.zeros(t, w, dtype=BF16) for w in (d, d, hidden))
    wo, w1, w2 = (weights[name][0] for name in ("wo", "w1", "w2"))
    dy, do, dh, gact, *_ = fh._launch_proj_mlp_backward(dz, y, h, torch.ones(d, dtype=BF16), wo,
                                                        w1, w2, 1e-3)
    (args,) = lib.calls
    assert args[:7] == tuple(x.data_ptr() for x in (dz, y, h)) + (args[3], wo.data_ptr(),
                                                                 w1.data_ptr(), w2.data_ptr())
    for out, width in ((dy, d), (do, inner), (dh, hidden), (gact, hidden)):
        assert _tma_problem(out) is None and out.stride() == (width, 1)
    assert args[-7:-3] == (t, d, inner, hidden)


def _meta(*shape):
    return torch.zeros(*shape, dtype=BF16, device="meta")


@pytest.mark.parametrize("k,n", [(64, 68), (68, 64), (200, 1028)])
def test_dgrads_refuse_widths_no_map_takes_before_any_launch(k, n):
    """A (k, n) weight whose rows are not a multiple of 16 bytes, or an A
    operand whose rows are not, has no map: the GEMM, the fused MLP's and the
    attention block's backwards raise before any launch."""
    with pytest.raises(ValueError, match="multiples of 8"):
        fh.gemm_wgmma(_meta(5, k), torch.zeros(k, n, dtype=BF16), "f32", layout="kn")
    # The fused MLP's backward takes such widths through zero-padded copies:
    # the weights it passes C are maps, rows a multiple of 8 elements apart.
    d, hidden = k, n
    gamma, _, w1, _, w2, _ = fm.kernel_operands(_meta(d), None, _meta(hidden, d), None,
                                                _meta(d, hidden), None)
    for w, shape in ((w1, (fm.padded_width(hidden), fm.padded_width(d))),
                     (w2, (fm.padded_width(d), fm.padded_width(hidden)))):
        assert tuple(w.shape) == shape and _tma_problem(w) is None and w.stride()[0] % 8 == 0
    if d % 8:
        with pytest.raises(ValueError, match="d % 8 == 0"):
            fab.fused_attention_block_backward(_meta(2, 3, d), _meta(2, 3, d),
                                               _meta(2, 3, 3 * 64), _meta(d), _meta(3 * 64, d),
                                               _meta(d, 64), 1, 64)


def test_gemm_takes_each_epilogue_only_over_its_layout():
    a = torch.zeros(5, 64, dtype=BF16, device="meta")
    for epilogue, layout in (("dgelu", "nk"), ("bias_gelu", "kn"), ("store", "mn")):
        with pytest.raises(ValueError, match="no epilogue"):
            fh.gemm_wgmma(a, torch.zeros(64, 64, dtype=BF16), epilogue, layout=layout)


class _CrossRecorder:
    """Stands in for the kernel library: the cross-attention backward's
    route (``route`` for the shape's own, -1 for any other asked for), a
    scratch size, and its entry point's arguments, launching nothing."""

    def __init__(self, route):
        self.route, self.calls = route, []

    def vit_fused_cross_attention_bwd_route(self, *shape):
        return self.route if shape[-1] in (-1, self.route) else -1

    def vit_fused_cross_attention_bwd_scratch(self, *shape):
        return 4096

    def vit_fused_cross_attention_bwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def cross_lib(monkeypatch):
    from vit_tpu_torch.ops import fused_cross_attention as fca

    def make(route):
        lib = _CrossRecorder(route)
        monkeypatch.setattr(fca._build, "load", lambda: lib)
        monkeypatch.setattr(fca, "_BACKWARD_PLANS", {})
        monkeypatch.setattr(fca, "check_kernel_tensors", lambda *args: None)
        monkeypatch.setattr(fca, "launch_stream", lambda x: 0)
        monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
        return fca, lib
    return make


def _cross_operands(b, n, n_k, c, heads, dh_k, dh_v):
    hk, hv = heads * dh_k, heads * dh_v
    dy, q, oattn = (torch.zeros(b, n, w, dtype=BF16) for w in (c, hk, hv))
    k, v = torch.zeros(b, n_k, hk, dtype=BF16), torch.zeros(b, n_k, hv, dtype=BF16)
    lse = torch.zeros(b, heads, n)
    wq, wo = torch.zeros(hk, c, dtype=BF16), torch.zeros(c, hv, dtype=BF16)
    return dy, q, k, v, oattn, lse, wq, wo


@pytest.mark.parametrize("b,n,n_k,c,heads,dh_k,dh_v,route", [
    (2, 4096, 64, 64, 2, 40, 32, 1),   # ScalableViT's SSA stages 1-4: cross_bwd
    (2, 1024, 64, 128, 4, 40, 32, 1),
    (2, 256, 64, 256, 8, 40, 32, 2),
    (2, 64, 64, 512, 16, 32, 32, 2),
    (2, 100, 49, 72, 3, 64, 64, 1),    # ragged n and c, 7 x 7 keys, (64, 64) heads
    (2, 3136, 64, 64, 8, 64, 64, 2),   # Twins-SVT's global attention at stages 1 and 3:
    (2, 196, 4, 256, 8, 64, 64, 2),    # split past heads·dh_k 256, from c 64
])
def test_cross_backward_operands_are_views_a_map_takes(cross_lib, b, n, n_k, c, heads, dh_k,
                                                       dh_v, route):
    """The cross-attention backward passes dy, q, k, v, oattn, lse, Wq and Wo
    to C as they lie (no copy), and each is a view that cross_bwd's tensor
    maps take with the strides C builds them from: dy an image's (n, c) rows
    (its head axis size 1), q, k, v and oattn channel-packed, a head h·d
    elements into each row (the C side's packed_strides), Wo's heads its
    dh_v-column slices of c rows, Wq one (hk, c) matrix; lse contiguous f32,
    read per row; the route asked for is the shape's own (-1)."""
    fca, lib = cross_lib(route)
    ops = _cross_operands(b, n, n_k, c, heads, dh_k, dh_v)
    dy, q, k, v, oattn, lse, wq, wo = ops
    hk, hv = heads * dh_k, heads * dh_v
    fca._launch_backward(*ops, heads, dh_k, dh_v, dh_k ** -0.5)
    (args,) = lib.calls
    assert args[:8] == tuple(t.data_ptr() for t in ops)
    assert args[14:21] == (b, n, n_k, c, heads, dh_k, dh_v) and args[22] == -1
    views = {
        "dy": (dy.unsqueeze(1), [n * c, 8, c]),
        "q": (fap.split_heads(q, heads), [n * hk, dh_k, hk]),
        "oattn": (fap.split_heads(oattn, heads), [n * hv, dh_v, hv]),
        "k": (fap.split_heads(k, heads), [n_k * hk, dh_k, hk]),
        "v": (fap.split_heads(v, heads), [n_k * hv, dh_v, hv]),
        "wo": (wo.unflatten(-1, (heads, dh_v)).transpose(0, 1).unsqueeze(0), [8, dh_v, hv]),
        "wq": (wq[None, None], [8, 8, c]),
    }
    for name, (view, strides) in views.items():
        assert _tma_problem(view) is None, name
        assert list(kernel_strides(view)) == strides, name
    assert lse.dtype == torch.float32 and lse.is_contiguous()
    assert fca.BACKWARD_ROUTES[route].launches > 0


@pytest.mark.parametrize("c,dh_k,dh_v,route,match", [
    (60, 40, 32, None, "c % 8"),      # rows of 120 bytes
    (64, 16, 24, None, "dh_k"),       # no instance for (16, 24)
    (64, 40, 40, None, "dh_k"),
    (256, 40, 32, 1, "route 1"),      # the one kernel stops at 128 channels
])
def test_cross_backward_refuses_what_no_map_takes_before_any_launch(cross_lib, c, dh_k, dh_v,
                                                                    route, match):
    """Widths no tensor map or instance takes, and a route the shape cannot
    take, raise before the library is called."""
    fca, lib = cross_lib(2)
    ops = _cross_operands(2, 64, 64, c, 2, dh_k, dh_v)
    before = fca.fused_cross_attention_backward.launches
    with pytest.raises(ValueError, match=match):
        fca._launch_backward(*ops, 2, dh_k, dh_v, 0.1, route)
    assert lib.calls == [] and fca.fused_cross_attention_backward.launches == before
