"""RegionViT: regional-to-local attention (port of
``vit_tpu/models/regionvit.py``).

Two token streams over NHWC maps: local tokens from an 8 x 8, stride-4
convolution (or three 3 x 3 ones with ``tokenize_local_3_conv``), and one
region token per ``local_patch_size · window_size`` square of pixels from a
1 x 1 convolution over its ``(c p1 p2)``-ordered pixels.  Each stage after
the first halves both streams with one shared 3 x 3, stride-2 convolution
(and adds a depthwise PEG to the local stream under ``use_peg``), then runs
an :class:`R2LTransformer`: per layer, one :class:`RegionAttention` (shared
weights) first self-attends the region tokens, then attends each region
token prepended to its window's local tokens, with a per-head relative
position bias zero-padded for the region slot, and a :class:`RegionMLP`
follows.  The head averages the region tokens, normalises and projects.

With ``fused_attention="auto"`` a 16-bit CUDA activation runs both
attentions of every layer, forward and backward, as ``vit_tpu`` runs its
Pallas kernels (:func:`region_attention_residual`): the region
self-attention through the fused attention block
(:func:`~vit_tpu_torch.ops.fused_attention_block.fused_attention_block`,
the images as groups of ``rh·rw`` tokens) and the joint attention through
the biased one
(:func:`~vit_tpu_torch.ops.fused_attention_block.fused_attention_block_bias`,
the windows folded into the batch as groups of ``1 + wh·ww`` tokens, the
bias an f32 ``(heads, n, n)`` tensor whose gradient comes back as the
kernel's dbias), each with the norm's weight, bias and eps 1e-3, q|k|v from
``to_qkv`` and ``to_out.0``.  ``vit_tpu`` declines both below 128 groups for
a reason of its TPU compiler (``regionvit.py:40-47``: the module of ten
Mosaic kernels that its whole train step embeds is OOM-killed compiling);
the port has no such limit, so its region self-attentions (one group an
image) and stage 4's joint attention run on the kernels as well.  The
gate kept is :func:`~vit_tpu_torch.layers.common.windowed_attention_eligible`'s
semantic one.  A width the kernels do not take raises; nothing falls back to
the plain modules on the card.  ``RegionMLP`` keeps its exact-erf GELU on
plain modules, as ``vit_tpu`` never routes it through its fused MLP.

The plain attention is ``vit_tpu``'s einsum form: q scaled in the compute
dtype, f32 logits plus the bias, an f32 softmax, the probabilities rounded
to the compute dtype for P·V with an f32 sum.  ``vit_tpu`` unfolds the local
tokens after every layer and folds them again before the next; the port
keeps a stage's ``[region token | window]`` rows between its layers, the
same tokens in the same places, and unfolds once at the stage's end.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations'),
``generator=`` and ``channels=`` (the image's, which Flax infers at init),
as :class:`vit_tpu_torch.models.crossformer.CrossFormer`.
``fused_attention`` takes ``"auto"`` or ``"never"``.  Images are NHWC.  The
modules carry the Flax names: ``local_encoder`` (or ``local_conv{0,1,2}``
and ``local_norm{0,1}``), ``region_encoder``, ``downsample_{s}``,
``peg_{s}``, ``transformer_{s}`` with ``attn_{i}`` (``norm``, ``to_qkv``,
``to_out.0``), ``ff_{i}`` (``norm``, ``fc1``, ``fc2``) and
``local_rel_pos_bias``, then ``head_norm`` and ``head``.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
each :class:`RegionAttention` splits by heads (``to_qkv`` by heads in each of
q, k and v, ``to_out``'s columns) on both of its calls, the region
self-attention on rows 3–4's split form and the joint rows on row 5's with
this rank's heads of the bias; each stage's ``local_rel_pos_bias`` table is
cut by heads with them (its columns, as LeViT's position bias), so the bias
and its gradient stay this rank's.  :class:`RegionMLP`, plain in
``vit_tpu``, splits as a Megatron pair (``fc1``'s rows and bias, ``fc2``'s
columns).  A split model's MLP dropout draws from the forward's
``generator``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import cast_tuple, divisible_by, resolve_device
from vit_tpu_torch.layers.common import (
    MLP_CUTS, QKV, ROW, Conv, GroupedConv, LayerNorm, cast_to, check_fused_mode, gelu_exact,
    glorot_linear_, group_kw, linear, row_parallel_output, split_dropout, split_input,
    windowed_attention_eligible,
)
from vit_tpu_torch.models.scalable_vit import _unwindows, _windows
from vit_tpu_torch.ops.flash_attention_packed import merge_heads, split_heads
from vit_tpu_torch.ops.fused_attention_block import (
    SHORT_MAX_BATCH, fused_attention_block, fused_attention_block_bias,
)

# Groups one launch of the fused attention block takes (the short route's
# grid.z); a larger fold is cut into launches of at most this many.
MAX_WINDOW_GROUPS = SHORT_MAX_BATCH


class RegionAttention(nn.Module):
    """Pre-norm attention with an optional additive logits bias
    (``vit_tpu/models/regionvit.py:71-99``): ``norm`` (eps 1e-3), ``to_qkv``
    without a bias (q|k|v thirds), ``to_out`` (``to_out.0``, as the converter
    lays it).  ``dropout`` only gates the kernel route, as in ``vit_tpu``,
    whose attention applies none.  ``shard`` (set by ``shard_params``)
    splits it by heads (``tp_cuts``)."""

    shard = None
    tp_cuts = {"to_qkv.weight": QKV, "to_out.0.weight": ROW}

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dropout: float = 0.0, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        inner = heads * dim_head
        self.norm = LayerNorm(dim, **kw)
        self.to_qkv = glorot_linear_(nn.Linear(dim, 3 * inner, bias=False, **kw), generator)
        self.to_out = nn.Sequential(glorot_linear_(nn.Linear(inner, dim, **kw), generator))

    @property
    def dropout_active(self) -> bool:
        return self.training and self.dropout > 0

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
        """``x`` ``(b, n, dim)``; ``bias`` None or ``(heads, n, n)`` (this
        rank's heads where split)."""
        xn = split_input(self.norm(x), self.shard)
        q, k, v = (split_heads(t, self.heads) for t in linear(self.to_qkv, xn).chunk(3, dim=-1))
        q = q * self.dim_head ** -0.5
        sim = q.float() @ k.float().transpose(-1, -2)
        if bias is not None:
            sim = sim + bias.float()
        attn = torch.softmax(sim, dim=-1)
        out = merge_heads((attn.to(v.dtype).float() @ v.float()).to(v.dtype))
        return row_parallel_output(self.to_out[0], out, self.shard)


class RegionMLP(nn.Module):
    """The MLP with its LayerNorm inside (``vit_tpu/models/regionvit.py:
    102-117``): ``norm`` (eps 1e-3) → ``fc1`` → exact GELU → dropout →
    ``fc2``.  ``shard`` (set by ``shard_params``) splits it by hidden units
    (``tp_cuts``), ``fc2``'s bias added once after the sum; ``generator``,
    where given, draws the dropout."""

    shard = None
    tp_cuts = MLP_CUTS

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.norm = LayerNorm(dim, **kw)
        self.fc1 = glorot_linear_(nn.Linear(dim, dim * mult, **kw), generator)
        self.fc2 = glorot_linear_(nn.Linear(dim * mult, dim, **kw), generator)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        hdn = gelu_exact(linear(self.fc1, split_input(self.norm(x), self.shard)))
        hdn = split_dropout(hdn, self.dropout, self.shard, generator, hidden=True)
        return row_parallel_output(self.fc2, hdn, self.shard)


def region_attention_residual(x: torch.Tensor, attn: RegionAttention, mode: str = "auto",
                              bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x + attn(x, bias)`` over ``(groups, n, dim)``: with
    :func:`windowed_attention_eligible`'s gate, through the fused attention
    block (or, with a ``bias``, contiguous f32 ``(heads, n, n)``, the biased
    one) in launches of at most :data:`MAX_WINDOW_GROUPS` groups
    (``vit_tpu``'s ``_fused_region_attention_residual``,
    ``regionvit.py:28-68``); else the plain modules.  ``vit_tpu``'s ``G <
    128`` decline is dropped: it kept a TPU compiler's module small (the
    module docstring), which no launch here needs.  A split ``attn`` runs
    the split forms over its model group, ``bias`` this rank's heads."""
    if not windowed_attention_eligible(x, attn, mode):
        return x + attn(x, bias)
    out = attn.to_out[0]
    norm = attn.norm
    args = (norm.weight, norm.bias, cast_to(attn.to_qkv.weight, x), cast_to(out.weight, x),
            cast_to(out.bias, x))
    shape = (attn.heads, attn.dim_head, attn.dim_head ** -0.5, norm.eps)
    kw = group_kw(attn)
    ys = [fused_attention_block(xg, *args, *shape, **kw) if bias is None
          else fused_attention_block_bias(xg, *args, bias, *shape, **kw)
          for xg in x.contiguous().split(MAX_WINDOW_GROUPS)]
    return ys[0] if len(ys) == 1 else torch.cat(ys)


@functools.lru_cache(maxsize=16)
def relative_position_index(wh: int, ww: int, window_size: int,
                            device: torch.device) -> torch.Tensor:
    """The ``(wh·ww, wh·ww)`` index of each query-key pair of a window into
    the ``(2w − 1)²`` table, ``vit_tpu``'s arithmetic as it is
    (``regionvit.py:145-148``): ``rel · (1, 2w − 1)`` with ``rel = pos_q −
    pos_k + w − 1`` over the ``meshgrid(..., indexing="ij")`` grid.  Cached
    a shape and device, so that a call copies nothing to the card, and made
    outside inference mode, so that a serving call's index serves training
    too."""
    with torch.inference_mode(False):
        grid = torch.stack(torch.meshgrid(torch.arange(wh), torch.arange(ww), indexing="ij"))
        grid = grid.reshape(2, -1)
        rel = grid[:, :, None] - grid[:, None, :] + (window_size - 1)
        index = (rel * torch.tensor([1, 2 * window_size - 1])[:, None, None]).sum(0)
        return index.to(device)


class R2LTransformer(nn.Module):
    """Regional-to-local attention layers over a stage
    (``vit_tpu/models/regionvit.py:120-198``): ``attn_{i}`` and ``ff_{i}`` a
    layer, one ``local_rel_pos_bias`` table ((2w − 1)² x heads) for the
    stage.  ``shard`` (set by ``shard_params``) cuts the table by heads
    (``tp_cuts``: its columns) with its attentions; ``heads`` becomes the
    local count."""

    shard = None
    tp_cuts = {"local_rel_pos_bias.weight": ROW}

    def __init__(self, dim: int, window_size: int, depth: int = 4, heads: int = 4,
                 dim_head: int = 32, attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 fused_attention: str = "auto", *, device=None, dtype=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.fused_attention = check_fused_mode("fused_attention", fused_attention)
        self.window_size, self.depth, self.heads = window_size, depth, heads
        self.local_rel_pos_bias = nn.Embedding((2 * window_size - 1) ** 2, heads, device=device,
                                               dtype=dtype)
        with torch.no_grad():  # Flax's Embed: normal over variance 1 / features
            nn.init.normal_(self.local_rel_pos_bias.weight, std=heads ** -0.5,
                            generator=generator)
        for i in range(depth):
            self.add_module(f"attn_{i}", RegionAttention(dim, heads, dim_head, attn_dropout,
                                                         **kw))
            self.add_module(f"ff_{i}", RegionMLP(dim, dropout=ff_dropout, **kw))

    def position_bias(self, wh: int, ww: int) -> torch.Tensor:
        """The contiguous f32 ``(heads, n, n)`` bias of a joint row of ``n = 1
        + wh·ww`` tokens: the table gathered by
        :func:`relative_position_index`, zero-padded for the region slot."""
        index = relative_position_index(wh, ww, self.window_size,
                                        self.local_rel_pos_bias.weight.device)
        bias = self.local_rel_pos_bias(index).permute(2, 0, 1)
        return F.pad(bias.float(), (1, 0, 1, 0)).contiguous()

    def forward(self, local_tokens: torch.Tensor, region_tokens: torch.Tensor,
                generator: torch.Generator | None = None) -> tuple:
        """``local_tokens`` ``(b, lh, lw, c)`` and ``region_tokens`` ``(b, rh,
        rw, c)`` → both, updated.  Each window of ``(lh / rh) x (lw / rw)``
        local tokens belongs to one region token.  ``generator``: the MLPs'
        dropout draws, where given."""
        b, lh, lw, c = local_tokens.shape
        rh, rw = region_tokens.shape[1:3]
        wh, ww = lh // rh, lw // rw
        bias = self.position_bias(wh, ww)
        regions = rh * rw
        # (b h w) rows of [region token | its window's (p1 p2) local tokens]
        joint = torch.cat([region_tokens.reshape(b * regions, 1, c),
                           _windows(local_tokens, wh, ww)], dim=1)
        for i in range(self.depth):
            attn, ff = getattr(self, f"attn_{i}"), getattr(self, f"ff_{i}")
            region = region_attention_residual(joint[:, 0].reshape(b, regions, c), attn,
                                               self.fused_attention)
            joint = torch.cat([region.reshape(b * regions, 1, c), joint[:, 1:]], dim=1)
            joint = region_attention_residual(joint, attn, self.fused_attention, bias)
            joint = ff(joint, generator) + joint
        return (_unwindows(joint[:, 1:], b, lh, lw, wh, ww),
                joint[:, 0].reshape(b, rh, rw, c))


class RegionViT(nn.Module):
    """Constructor parity: ``vit_tpu/models/regionvit.py:201-277``."""

    def __init__(self, dim=(64, 128, 256, 512), depth=(2, 2, 8, 2), window_size: int = 7,
                 num_classes: int = 1000, tokenize_local_3_conv: bool = False,
                 local_patch_size: int = 4, use_peg: bool = False, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, dtype: torch.dtype | None = None,
                 fused_attention: str = "auto", *, compute_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None, channels: int = 3):
        super().__init__()
        dims, depths = cast_tuple(dim, 4), cast_tuple(depth, 4)
        if len(dims) != 4:
            raise ValueError("dim needs to be a single value or a tuple of length 4")
        if len(depths) != 4:
            raise ValueError("depth needs to be a single value or a tuple of length 4")
        self.fused_attention = check_fused_mode("fused_attention", fused_attention)
        self.compute_dtype = compute_dtype
        self.local_patch_size, self.window_size = local_patch_size, window_size
        self.tokenize_local_3_conv, self.use_peg = tokenize_local_3_conv, use_peg
        kw = dict(device=resolve_device(device), dtype=dtype)
        gen = dict(kw, generator=generator)
        init_dim = dims[0]
        if tokenize_local_3_conv:
            self.local_conv0 = Conv(channels, init_dim, 3, 2, **gen)
            self.local_norm0 = LayerNorm(init_dim, **kw)
            self.local_conv1 = Conv(init_dim, init_dim, 3, 2, **gen)
            self.local_norm1 = LayerNorm(init_dim, **kw)
            self.local_conv2 = Conv(init_dim, init_dim, 3, **gen)
        else:
            self.local_encoder = Conv(channels, init_dim, 8, 4, **gen)
        region_patch = local_patch_size * window_size
        self.region_encoder = Conv(channels * region_patch ** 2, init_dim, 1, **gen)
        for s, (d, layers) in enumerate(zip(dims, depths)):
            if s:
                self.add_module(f"downsample_{s}", Conv(dims[s - 1], d, 3, 2, **gen))
                if use_peg:
                    self.add_module(f"peg_{s}", GroupedConv(d, 3, **gen))
            self.add_module(f"transformer_{s}", R2LTransformer(
                d, window_size, layers, attn_dropout=attn_dropout, ff_dropout=ff_dropout,
                fused_attention=fused_attention, **gen))
        self.head_norm = LayerNorm(dims[-1], **kw)
        self.head = glorot_linear_(nn.Linear(dims[-1], num_classes, **kw), generator)

    def local_tokens(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tokenize_local_3_conv:
            return self.local_encoder(x)
        x = gelu_exact(self.local_norm0(self.local_conv0(x)))
        x = gelu_exact(self.local_norm1(self.local_conv1(x)))
        return self.local_conv2(x)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the draws of the MLPs' active dropout, where given
        (a split model's raises without one)."""
        x = img.to(self.compute_dtype or self.head.weight.dtype)
        b, h, w, c = x.shape
        p = self.local_patch_size * self.window_size
        if not (divisible_by(h, p) and divisible_by(w, p)):
            raise ValueError("height and width must be divisible by region patch size")
        if not (divisible_by(h, self.local_patch_size) and divisible_by(w, self.local_patch_size)):
            raise ValueError("height and width must be divisible by local patch size")
        local = self.local_tokens(x)
        # b (h p1) (w p2) c -> b h w (c p1 p2)
        rt = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
        region = self.region_encoder(rt.reshape(b, h // p, w // p, c * p * p))
        for s in range(4):
            if s:
                down = getattr(self, f"downsample_{s}")
                local, region = down(local), down(region)
                if self.use_peg:
                    local = getattr(self, f"peg_{s}")(local) + local
            local, region = getattr(self, f"transformer_{s}")(local, region, generator)
        return linear(self.head, self.head_norm(region.mean(dim=(1, 2))))
