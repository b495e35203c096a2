"""CrossFormer: cross-scale embeddings, and short (windowed) and long
(dilated) attention with a dynamic position bias (port of
``vit_tpu/models/crossformer.py``).

Four stages over NHWC maps, each a :class:`CrossEmbedLayer` and ``depth``
blocks; a block is a short-distance attention and its MLP, then a
long-distance attention and its MLP.  The short attention folds ``w x w``
windows into the batch (``b (h s1) (w s2) c -> (b h w) (s1 s2) c``), the
long one dilated windows of every ``H / w``-th token (``b (l1 h) (l2 w) c ->
(b h w) (l1 l2) c``).  Each adds a :class:`DynamicPositionBias` to its
logits: an MLP over the (2w+1)² relative coordinates, gathered to an ``(n,
n)`` table with ``vit_tpu``'s index ``rel_pos · (2w − 1, 1)``, whose
gradient reaches the MLP.  The head averages the map and projects it.

With ``fused_attention="auto"`` a 16-bit CUDA map runs each residual
attention, forward and backward, as ``vit_tpu`` runs its Pallas kernels:

- :func:`crossformer_attention_residual`: ``x + CrossFormerAttention(x)``
  through the biased fused attention block
  (:func:`~vit_tpu_torch.ops.fused_attention_block.fused_attention_block_bias`)
  over the windows folded into the batch, the ``ChannelLayerNorm``'s g, b
  and eps 1e-5, q|k|v from ``to_qkv``, the DPB table computed once a call
  and gathered to a contiguous f32 ``(1, n, n)`` bias that the heads share;
  its gradient comes back as the kernel's dbias.  The fold goes in
  launches of at most :data:`MAX_WINDOW_GROUPS` groups.  The gates kept are
  :func:`~vit_tpu_torch.layers.common.windowed_attention_eligible`'s
  semantic ones and ``vit_tpu``'s ``n < 8`` decline: the long attention's
  windows of 2 x 2 and 1 x 1 tokens (stages 3-4 at the defaults) take the
  plain modules.
- the MLPs, which keep their LayerNorm inside, through
  :func:`~vit_tpu_torch.layers.common.fused_conv_mlp_residual` with
  ``norm=None``.

A width the kernels do not take raises; nothing falls back to the plain
modules on the card.  The plain attention is ``vit_tpu``'s einsum form: q
scaled in the compute dtype, f32 logits plus the bias, an f32 softmax, the
probabilities rounded to the compute dtype for P·V with an f32 sum.  The
stem's convolutions, the DPB MLP, the dW GEMMs and the head stay library
calls, outside every Pallas kernel in ``vit_tpu`` too.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations'),
``generator=`` and ``channels=`` (the image's, which Flax infers at init),
as :class:`vit_tpu_torch.models.twins_svt.TwinsSVT`.  ``fused_attention``
and ``fused_mlp`` take ``"auto"`` or ``"never"``.  Images are NHWC.  The
modules carry the Flax names: ``cel_{s}/conv_{i}``,
``{short,long}_attn_{s}_{i}`` (``norm``, ``to_qkv``, ``to_out.0``, ``dpb``),
``{short,long}_ff_{s}_{i}`` (``norm``, ``fc1``, ``fc2``) and ``head``.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
each attention splits by heads (``to_qkv`` by heads in each of q, k and v,
``to_out``'s columns), each MLP by hidden units, the kernel route on rows
1–2's and row 5's split forms, the plain one (windows under
:data:`MIN_FUSED_TOKENS`, f32, the CPU) with Megatron's two functions.  The
:class:`DynamicPositionBias` stays whole on every rank, a departure from
``vit_tpu``'s rule table (which matches its ``fc1`` and ``fc2`` by name and
has GSPMD shard them around the LayerNorm between, no Megatron pair) with the
same numbers: its table, shared by the heads, reaches the attention through
``copy_to_model_parallel``, which sums the ranks' shares of its dbias in f32,
so the DPB's gradients are whole and equal on every rank.  The plan lists its
parameters under ``replicated``.  A split model's MLP dropout draws from the
forward's ``generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import cast_tuple, resolve_device
from vit_tpu_torch.layers.common import (
    MLP_CUTS, QKV, ROW, ChannelLayerNorm, Conv, LayerNorm, cast_to, check_fused_mode,
    fused_conv_mlp_residual, gelu_exact, glorot_linear_, group_kw, linear, row_parallel_conv,
    split_dropout, split_input, windowed_attention_eligible,
)
from vit_tpu_torch.models.scalable_vit import _unwindows, _windows
from vit_tpu_torch.ops.flash_attention_packed import merge_heads, split_heads
from vit_tpu_torch.ops.fused_attention_block import SHORT_MAX_BATCH, fused_attention_block_bias

# Window groups one launch of the fused attention block takes (the short
# route's grid.z); a larger fold is cut into launches of at most this many.
MAX_WINDOW_GROUPS = SHORT_MAX_BATCH
# vit_tpu's decline (crossformer.py:47-49): windows of fewer tokens take the
# plain modules.
MIN_FUSED_TOKENS = 8


def _pad_lo(k: int, s: int) -> int:
    """The top (left) TF-SAME pad of a k x k, stride-s convolution over a map
    the stride divides: ``max(k - s, 0) // 2``."""
    return max(k - s, 0) // 2


def _padded(x: torch.Tensor, big: int, s: int) -> torch.Tensor:
    """The NHWC map ``x`` with the merged K x K, stride-s convolution's TF-SAME
    pads."""
    lo = _pad_lo(big, s)
    hi = max(big - s, 0) - lo
    return F.pad(x, (0, 0, lo, hi, lo, hi))


def stem_strided(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 stride: int) -> torch.Tensor:
    """Form (a) of the merged stem: one K x K, stride-s convolution of the NHWC
    map ``x`` (the stride dividing its height and width) with TF-SAME pads,
    then the bias added in x's dtype (``vit_tpu/models/crossformer.py:
    172-177``)."""
    xp = _padded(x, weight.shape[-1], stride)
    return F.conv2d(xp.permute(0, 3, 1, 2), weight, None, stride).permute(0, 2, 3, 1) + bias


def stem_space_to_depth(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """Form (b), where the stride s divides K: the same sums as
    :func:`stem_strided` as a stride-1 convolution over the padded map with
    each s x s pixel block packed into channels ``(ry, rx, c)``, and the
    kernel reindexed the same way to ``(K/s, K/s)`` taps of ``s·s·c`` channels
    (``vit_tpu/models/crossformer.py:145-171``)."""
    big, s = weight.shape[-1], stride
    xp = _padded(x, big, s)
    b, hp, wp, cin = xp.shape
    xp = xp.reshape(b, hp // s, s, wp // s, s, cin).permute(0, 1, 3, 2, 4, 5)
    xp = xp.reshape(b, hp // s, wp // s, s * s * cin)
    kb, cout = big // s, weight.shape[0]
    # (cout, cin, kb·s, kb·s) -> (cout, (ry, rx, cin), kb, kb)
    w2 = weight.reshape(cout, cin, kb, s, kb, s).permute(0, 3, 5, 1, 2, 4)
    w2 = w2.reshape(cout, s * s * cin, kb, kb)
    return F.conv2d(xp.permute(0, 3, 1, 2), w2).permute(0, 2, 3, 1) + bias


class CrossEmbedLayer(nn.Module):
    """Convolutions of several kernel sizes at one stride, their outputs
    concatenated over the channels (``vit_tpu/models/crossformer.py:90-178``):
    ``conv_{i}`` over the sorted kernel sizes, ``dim/2, dim/4, …`` channels
    and the rest to the largest.  ``dim_in`` is the input's channels (Flax
    infers them).  Three forms, as :meth:`form` chooses:

    - ``"concat"`` (c): each convolution on its own, then the concatenation,
      where the stride does not divide the map or there is one scale;
    - ``"space_to_depth"`` (b): the children zero-embedded at offset
      ``lo(K) − lo(k)`` in the largest K x K kernel and run as one
      convolution (:meth:`merged`), in :func:`stem_space_to_depth`'s form,
      where the stride divides K;
    - ``"strided"`` (a): the same merged kernel as one strided convolution
      (:func:`stem_strided`) otherwise.

    ``vit_tpu``'s ``VIT_TPU_S2D_STEM`` switch was a TPU lever and is not
    ported: (b) runs wherever K % s == 0, ``vit_tpu``'s default."""

    def __init__(self, dim_in: int, dim: int, kernel_sizes: tuple, stride: int = 2, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kernel_sizes = sorted(kernel_sizes)
        dim_scales = [int(dim / (2 ** i)) for i in range(1, len(kernel_sizes))]
        dim_scales = [*dim_scales, dim - sum(dim_scales)]
        self.kernel_sizes, self.stride = tuple(kernel_sizes), stride
        for i, (k, d) in enumerate(zip(kernel_sizes, dim_scales)):
            self.add_module(f"conv_{i}", Conv(dim_in, d, k, stride, device=device, dtype=dtype,
                                              generator=generator))

    def convs(self) -> list:
        return [getattr(self, f"conv_{i}") for i in range(len(self.kernel_sizes))]

    def form(self, h: int, w: int) -> str:
        """The form a map of ``h`` x ``w`` takes."""
        s = self.stride
        if h % s or w % s or len(self.kernel_sizes) == 1:
            return "concat"
        return "space_to_depth" if self.kernel_sizes[-1] % s == 0 else "strided"

    def merged(self, x: torch.Tensor) -> tuple:
        """The merged OIHW K x K kernel and its bias, in x's dtype: each child
        zero-padded to K at offset ``lo(K) − lo(k)``, the channels in the
        children's order."""
        big, s = self.kernel_sizes[-1], self.stride
        parts = []
        for k, conv in zip(self.kernel_sizes, self.convs()):
            off = _pad_lo(big, s) - _pad_lo(k, s)
            parts.append(F.pad(cast_to(conv.weight, x), (off, big - k - off, off, big - k - off)))
        return torch.cat(parts), torch.cat([cast_to(conv.bias, x) for conv in self.convs()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        form = self.form(x.shape[1], x.shape[2])
        if form == "concat":
            return torch.cat([conv(x) for conv in self.convs()], dim=-1)
        conv = stem_space_to_depth if form == "space_to_depth" else stem_strided
        return conv(x, *self.merged(x), self.stride)


class DynamicPositionBias(nn.Module):
    """Three rounds of Dense → the token ``LayerNorm`` (eps 1e-3) → ReLU, then
    Dense(1), over continuous relative coordinates
    (``vit_tpu/models/crossformer.py:181-195``); computed in the dtype of
    the coordinates it is given (the compute dtype, as ``vit_tpu``'s
    ``dtype=attn.dtype``)."""

    def __init__(self, dim: int, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        for i in range(3):
            self.add_module(f"fc{i}", glorot_linear_(nn.Linear(2 if i == 0 else dim, dim, **kw),
                                                     generator))
            self.add_module(f"norm{i}", LayerNorm(dim, **kw))
        self.out = glorot_linear_(nn.Linear(dim, 1, **kw), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = F.relu(getattr(self, f"norm{i}")(linear(getattr(self, f"fc{i}"), x)))
        return linear(self.out, x).squeeze(-1)


def relative_positions(w: int) -> tuple:
    """The (2w+1)² continuous relative coordinates ``(dy, dx)``, f32, and the
    ``(w², w²)`` index of each query-key pair into them: ``rel_pos · (2w − 1,
    1)`` with ``rel_pos = pos_q − pos_k + w − 1``, ``vit_tpu``'s arithmetic
    as it is (``crossformer.py:243-244``; every index lies in the table)."""
    pos = torch.arange(-w, w + 1)
    coords = torch.stack(torch.meshgrid(pos, pos, indexing="ij")).reshape(2, -1).T
    grid = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij"))
    grid = grid.reshape(2, -1).T
    rel = grid[:, None] - grid[None, :] + w - 1
    return coords.float(), (rel * torch.tensor([2 * w - 1, 1])).sum(-1)


def _fold(t: torch.Tensor, kind: str, w: int) -> torch.Tensor:
    """``b H W c`` → ``(groups, w², c)``, contiguous: the short attention's
    windows, or the long attention's dilated ones ``b (l1 h) (l2 w) c -> (b
    h w) (l1 l2) c`` (every ``H / w``-th token)."""
    if kind == "short":
        return _windows(t, w, w)
    b, h, wd, c = t.shape
    t = t.reshape(b, w, h // w, w, wd // w, c).permute(0, 2, 4, 1, 3, 5)
    return t.reshape(-1, w * w, c)


def _unfold(t: torch.Tensor, kind: str, b: int, h: int, wd: int, w: int) -> torch.Tensor:
    """The inverse of :func:`_fold`."""
    if kind == "short":
        return _unwindows(t, b, h, wd, w, w)
    t = t.reshape(b, h // w, wd // w, w, w, -1).permute(0, 3, 1, 4, 2, 5)
    return t.reshape(b, h, wd, -1)


class CrossFormerAttention(nn.Module):
    """Short (windowed) or long (dilated) attention
    (``vit_tpu/models/crossformer.py:198-264``): a ``ChannelLayerNorm``
    ``norm``, a 1x1 ``to_qkv`` without bias (q|k|v thirds), ``dim //
    dim_head`` heads, a :class:`DynamicPositionBias` ``dpb`` over
    ``dim // 4`` features, ``to_out`` a 1x1 convolution (``to_out.0``, as the
    converter lays it).  ``dropout`` only gates the kernel route, as in
    ``vit_tpu``, whose attention applies none.  ``shard`` (set by
    ``shard_params``) splits it by heads (``tp_cuts``); ``dpb`` stays whole
    (the module docstring)."""

    shard = None
    tp_cuts = {"to_qkv.weight": QKV, "to_out.0.weight": ROW}

    def __init__(self, dim: int, attn_type: str, window_size: int, dim_head: int = 32,
                 dropout: float = 0.0, *, device=None, dtype=None, generator=None):
        super().__init__()
        if attn_type not in ("short", "long"):
            raise ValueError(f"attention type must be 'short' or 'long', got {attn_type!r}")
        kw = dict(device=device, dtype=dtype)
        self.attn_type, self.window_size, self.dim_head = attn_type, window_size, dim_head
        self.heads = dim // dim_head
        self.dropout = dropout
        inner = self.heads * dim_head
        self.norm = ChannelLayerNorm(dim, **kw)
        self.to_qkv = Conv(dim, 3 * inner, 1, use_bias=False, generator=generator, **kw)
        self.dpb = DynamicPositionBias(dim // 4, generator=generator, **kw)
        self.to_out = nn.Sequential(Conv(inner, dim, 1, generator=generator, **kw))
        coords, index = relative_positions(window_size)
        self.register_buffer("rel_coords", coords.to(device), persistent=False)
        self.register_buffer("rel_index", index.to(device), persistent=False)

    @property
    def dropout_active(self) -> bool:
        return self.training and self.dropout > 0

    def position_bias(self, dtype: torch.dtype) -> torch.Tensor:
        """The ``(w², w²)`` bias table: the DPB over the relative coordinates
        in ``dtype``, gathered by the query-key index."""
        return self.dpb(self.rel_coords.to(dtype))[self.rel_index]

    def split_bias(self, dtype: torch.dtype) -> torch.Tensor:
        """:meth:`position_bias` in f32, through ``copy_to_model_parallel``
        where the attention is split: the heads of every rank read the one
        table, and the ranks' shares of its gradient are summed in f32."""
        return split_input(self.position_bias(dtype).float(), self.shard)

    def check_windows(self, h: int, w: int) -> None:
        p = self.window_size
        if h % p or w % p:
            raise ValueError(f"feature map {h}x{w} is not divisible by the {self.attn_type} "
                             f"attention's window size {p}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        self.check_windows(h, w)
        xw = split_input(_fold(self.norm(x), self.attn_type, self.window_size), self.shard)
        q, k, v = (split_heads(t, self.heads) for t in self.to_qkv(xw).chunk(3, dim=-1))
        q = q * self.dim_head ** -0.5
        sim = q.float() @ k.float().transpose(-1, -2) + self.split_bias(x.dtype)
        attn = torch.softmax(sim, dim=-1)
        out = merge_heads((attn.to(v.dtype).float() @ v.float()).to(v.dtype))
        return _unfold(row_parallel_conv(self.to_out[0], out, self.shard), self.attn_type, b, h,
                       w, self.window_size)


def crossformer_attention_residual(x: torch.Tensor, attn: CrossFormerAttention,
                                   mode: str = "auto") -> torch.Tensor:
    """``x + attn(x)``: with :func:`windowed_attention_eligible`'s gate and
    windows of at least :data:`MIN_FUSED_TOKENS` tokens, through the biased
    fused attention block over the windows folded into the batch, in launches
    of at most :data:`MAX_WINDOW_GROUPS` groups, the DPB table computed once
    and shared by the launches and the heads (``vit_tpu``'s
    ``_fused_crossformer_attention_residual``, ``crossformer.py:32-87``);
    else the plain modules.  A map the window size does not divide raises
    either way.  A split ``attn`` runs row 5's split form over its model
    group, the shared table whole (:meth:`CrossFormerAttention.split_bias`)."""
    b, h, w, _ = x.shape
    attn.check_windows(h, w)
    p = attn.window_size
    if p * p < MIN_FUSED_TOKENS or not windowed_attention_eligible(x, attn, mode):
        return x + attn(x)
    bias = attn.split_bias(x.dtype)[None].contiguous()
    out = attn.to_out[0]
    weights = (cast_to(attn.to_qkv.weight, x).flatten(1), cast_to(out.weight, x).flatten(1),
               cast_to(out.bias, x))
    y = torch.cat([fused_attention_block_bias(xw, attn.norm.g, attn.norm.b, *weights, bias,
                                              attn.heads, attn.dim_head,
                                              attn.dim_head ** -0.5, attn.norm.eps,
                                              **group_kw(attn))
                   for xw in _fold(x, attn.attn_type, p).split(MAX_WINDOW_GROUPS)])
    return _unfold(y, attn.attn_type, b, h, w, p)


class CrossFormerMLP(nn.Module):
    """The MLP with its LayerNorm inside (``vit_tpu/models/crossformer.py:
    267-282``): ``norm`` (a ``ChannelLayerNorm``), 1x1 ``fc1`` → exact GELU →
    dropout → 1x1 ``fc2``.  ``shard`` (set by ``shard_params``) splits it
    by hidden units (``tp_cuts``), ``fc2``'s bias added once after the sum;
    ``generator``, where given, draws the dropout."""

    shard = None
    tp_cuts, tp_multiple = MLP_CUTS, 8

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = ChannelLayerNorm(dim, **kw)
        self.fc1 = Conv(dim, dim * mult, 1, generator=generator, **kw)
        self.fc2 = Conv(dim * mult, dim, 1, generator=generator, **kw)
        self.dropout = nn.Dropout(dropout)

    @property
    def dropout_active(self) -> bool:
        return self.training and self.dropout.p > 0

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        hdn = gelu_exact(self.fc1(split_input(self.norm(x), self.shard)))
        hdn = split_dropout(hdn, self.dropout, self.shard, generator, hidden=True)
        return row_parallel_conv(self.fc2, hdn, self.shard)


class CrossFormer(nn.Module):
    """Constructor parity: ``vit_tpu/models/crossformer.py:285-340``."""

    def __init__(self, dim=(64, 128, 256, 512), depth=(2, 2, 8, 2),
                 global_window_size=(8, 4, 2, 1), local_window_size=7,
                 cross_embed_kernel_sizes=((4, 8, 16, 32), (2, 4), (2, 4), (2, 4)),
                 cross_embed_strides=(4, 2, 2, 2), num_classes: int = 1000,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 dtype: torch.dtype | None = None, fused_attention: str = "auto",
                 fused_mlp: str = "auto", *, compute_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None, channels: int = 3):
        super().__init__()
        config = {name: cast_tuple(val, 4) for name, val in (
            ("dim", dim), ("depth", depth), ("global_window_size", global_window_size),
            ("local_window_size", local_window_size),
            ("cross_embed_kernel_sizes", cross_embed_kernel_sizes),
            ("cross_embed_strides", cross_embed_strides))}
        for name, val in config.items():
            if len(val) != 4:
                raise ValueError(f"{name} must give one value for each of the 4 stages, "
                                 f"got {val!r}")
        self.fused_attention = check_fused_mode("fused_attention", fused_attention)
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        self.compute_dtype = compute_dtype
        self.depth = config["depth"]
        kw = dict(device=resolve_device(device), dtype=dtype, generator=generator)
        dim_in = channels
        for s, (dim_out, layers, gw, lw, ks, st) in enumerate(zip(*config.values())):
            self.add_module(f"cel_{s}", CrossEmbedLayer(dim_in, dim_out, ks, st, **kw))
            for i in range(layers):
                for kind, w in (("short", lw), ("long", gw)):
                    self.add_module(f"{kind}_attn_{s}_{i}", CrossFormerAttention(
                        dim_out, kind, w, dropout=attn_dropout, **kw))
                    self.add_module(f"{kind}_ff_{s}_{i}", CrossFormerMLP(
                        dim_out, dropout=ff_dropout, **kw))
            dim_in = dim_out
        self.head = glorot_linear_(nn.Linear(dim_in, num_classes, device=kw["device"],
                                             dtype=dtype), generator)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the draws of the MLPs' active dropout, where given
        (a split model's raises without one)."""
        x = img.to(self.compute_dtype or self.head.weight.dtype)
        for s, layers in enumerate(self.depth):
            x = getattr(self, f"cel_{s}")(x)
            for i in range(layers):
                for kind in ("short", "long"):
                    x = crossformer_attention_residual(x, getattr(self, f"{kind}_attn_{s}_{i}"),
                                                       self.fused_attention)
                    x = fused_conv_mlp_residual(x, None, getattr(self, f"{kind}_ff_{s}_{i}"),
                                                self.fused_mlp, generator=generator)
        return linear(self.head, x.mean(dim=(1, 2)))
