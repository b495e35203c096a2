"""ViT for small datasets — Shifted Patch Tokenization + Locality
Self-Attention (port of ``vit_tpu/models/vit_for_small_dataset.py``).

SPT concatenates four zero-padded diagonal shifts channel-wise before
patchify + LN + Dense; :class:`SPT` computes that as one stride-p convolution
plus a per-patch affine correction (:func:`_spt_conv`), with the eager form as
its plain version (:meth:`SPT.plain`).  LSA uses a learnable log-temperature
and masks the attention diagonal to ``-f32.max``.  On the card both of LSA's
differences fold into the operands of the hand-written biased attention-block
kernel (:func:`apply_fused_lsa_block`), so LSA has no kernel of its own.

Constructor: ``vit_tpu``'s, plus PyTorch's ``device=`` / ``dtype=``,
``compute_dtype=``, a ``generator=`` for the initialisation and ``channels=``,
as :class:`vit_tpu_torch.models.vit.ViT`.  Images are NHWC.  Dispatch follows
:mod:`vit_tpu_torch.layers.common`: ``fused_attention="auto"`` sends every
LSA half to ``fused_attention_block_bias`` for a 16-bit CUDA activation with
inactive dropout, at every token count, and widths the kernel does not take
raise ``ValueError``; ``fused_mlp="auto"`` does the same for the MLP half
through ``fused_mlp_residual``.  ``vit_tpu``'s window for its TPU kernels
(128 ≤ n ≤ 1024 and d ≥ 128, ``vit_tpu/layers/common.py:282-303``) was
measured on a TPU for its VMEM and layouts, and does not carry over.
``"never"`` runs the plain LSA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import pair, resolve_device
from vit_tpu_torch.layers.common import (
    MLP, LayerNorm, cast_to, check_fused_mode, fused_mlp_residual, glorot_linear_,
    kernel_activation, linear,
)
from vit_tpu_torch.ops.attention import apply_attention, mask_value
from vit_tpu_torch.ops.fused_attention_block import fused_attention_block_bias
from vit_tpu_torch.ops.patchify import patchify


def lsa_bias(n: int, device) -> torch.Tensor:
    """LSA's diagonal self-mask as the biased block's ``(1, n, n)`` f32 logits
    bias: ``mask_value(f32)`` (``-f32.max``) on the diagonal, 0 elsewhere.
    The model builds it once per forward and hands it to every layer."""
    eye = torch.eye(n, dtype=torch.bool, device=device)[None]
    bias = torch.zeros((1, n, n), dtype=torch.float32, device=device)
    return bias.masked_fill_(eye, mask_value(torch.float32))


def apply_fused_lsa_block(norm: LayerNorm, attn: "LSA", x: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """``x + LSA(norm(x))`` through the biased attention-block kernel, with
    ``bias`` from :func:`lsa_bias`.

    The learnable temperature scales the logits: the q-third of ``to_qkv``
    (rows ``[:inner]`` of the ``nn.Linear`` weight) is multiplied by
    ``exp(temperature)`` in f32 and rounded to the compute dtype, under
    autograd, and the kernel runs with ``scale=1.0``; the temperature's
    gradient then reaches it through the kernel's ``dWqkv``.  The diagonal
    self-mask is the additive ``bias``, a constant, so no ``dbias`` is
    computed.
    """
    inner = attn.heads * attn.dim_head
    w = attn.to_qkv.weight
    wq = (w[:inner].float() * attn.temperature.float().exp()).to(x.dtype)
    wqkv = torch.cat([wq, w[inner:].to(x.dtype)])
    out = attn.to_out[0]
    return fused_attention_block_bias(x, norm.weight, norm.bias, wqkv, cast_to(out.weight, x),
                                      cast_to(out.bias, x), bias, attn.heads, attn.dim_head,
                                      1.0, norm.eps)


def shift_4(x: torch.Tensor) -> list[torch.Tensor]:
    """Four zero-padded single-pixel shifts of an NHWC image: right, left,
    down, up (reference vit_for_small_dataset.py:15-47)."""
    right = F.pad(x[:, :, :-1, :], (0, 0, 1, 0))
    left = F.pad(x[:, :, 1:, :], (0, 0, 0, 1))
    down = F.pad(x[:, :-1, :, :], (0, 0, 0, 0, 1, 0))
    up = F.pad(x[:, 1:, :, :], (0, 0, 0, 0, 0, 1))
    return [right, left, down, up]


# (group dy, dx) for the concat order [identity, *shift_4]: a shifted
# image's pixel (py, px) is the original's (py + dy, px + dx).
_SPT_OFFSETS = ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0))


def _spt_conv(x, gamma, beta, kernel, bias, p: int, eps: float):
    """The whole SPT — 5-way shifted concat, patchify, LayerNorm, Dense — as
    one stride-``p`` convolution plus a per-patch affine correction
    (``vit_tpu``'s ``_spt_conv``).

    ``x`` is NHWC; ``kernel`` is the Dense kernel ``(p·p·5c, d)`` (the
    ``nn.Linear`` weight transposed), its rows in (p1, p2, group, c) order.
    Every shifted-patch feature is an input pixel read at a fixed offset, so
    ``Dense(LN(v))`` is ``rstd·[(v∘γ)W] − rstd·μ·(γᵀW) + (βᵀW + b)``, where
    ``(v∘γ)W`` is a stride-p convolution over the raw image whose
    ``(p+2, p+2, c, d)`` kernel carries the γ-scaled Dense rows added at each
    group's offset.  Its (1, 1) zero pad is the shifts' zero fill.  μ and σ
    are f32 sums of x and x² over each patch's five shifted windows.  As in
    ``vit_tpu``, the main convolution multiplies ``x`` by the kernel rounded
    to ``x``'s dtype and keeps the sum in f32: ``main·rstd − μ·rstd·gw`` is a
    difference of two large, nearly equal terms on an image with a non-zero
    mean, which a 16-bit ``main`` would ruin.  It is PyTorch's convolution
    (cuDNN on the card) over f32 tensors, under the caller's TF32 setting:
    for a 16-bit ``x`` both operands are 16-bit values, exact in TF32, so it
    sums exact products in f32 either way.  The statistics are reductions,
    which no TF32 setting rounds (x² is not exact in TF32).
    """
    b, hh, ww, c = x.shape
    d = kernel.shape[-1]
    feat = p * p * 5 * c

    # (p·p·5c, d) Dense rows -> (p, p, 5, c, d), γ folded in f32.
    wg = kernel.float().reshape(p, p, 5, c, d) * gamma.float().reshape(p, p, 5, c)[..., None]
    kk = p + 2
    wt = torch.zeros((kk, kk, c, d), dtype=torch.float32, device=x.device)
    for gi, (dy, dx) in enumerate(_SPT_OFFSETS):
        wt[1 + dy:1 + dy + p, 1 + dx:1 + dx + p] += wg[:, :, gi]

    x32 = x.float()
    main = F.conv2d(x32.permute(0, 3, 1, 2), wt.to(x.dtype).float().permute(3, 2, 0, 1),
                    stride=p, padding=1).permute(0, 2, 3, 1)

    # Σ x and Σ x² over the patch's pixels read at each group's offset.
    sums = F.pad(torch.stack([x32.sum(-1), (x32 * x32).sum(-1)], -1), (0, 0, 1, 1, 1, 1))
    s = 0.0
    for dy, dx in _SPT_OFFSETS:
        win = sums[:, 1 + dy:1 + dy + hh, 1 + dx:1 + dx + ww]
        s = s + win.reshape(b, hh // p, p, ww // p, p, 2).sum((2, 4))
    mu = s[..., :1] / feat
    var = s[..., 1:] / feat - mu * mu
    rstd = torch.rsqrt(var + eps)

    gw = gamma.float() @ kernel.float()
    bw = beta.float() @ kernel.float() + bias.float()
    out = main * rstd - (mu * rstd) * gw + bw
    return out.reshape(b, (hh // p) * (ww // p), d).to(x.dtype)


class SPT(nn.Module):
    """Shifted Patch Tokenization (reference vit_for_small_dataset.py:142-157):
    ``norm`` (LayerNorm over p·p·5c features) and ``proj`` (Dense to ``dim``),
    as ``patch_embedding/norm`` and ``patch_embedding/proj`` in the Flax tree.
    Computes in the dtype of its input."""

    def __init__(self, dim: int, patch_size: int, channels: int = 3, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.patch_size = patch_size
        feat = patch_size * patch_size * 5 * channels
        self.norm = LayerNorm(feat, device=device, dtype=dtype)
        self.proj = glorot_linear_(nn.Linear(feat, dim, device=device, dtype=dtype), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        if x.dim() == 4 and x.shape[1] % p == 0 and x.shape[2] % p == 0:
            return _spt_conv(x, self.norm.weight, self.norm.bias, self.proj.weight.t(),
                             self.proj.bias, p, self.norm.eps)
        return self.plain(x)

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The eager form: concat the shifts, patchify, LayerNorm, Dense."""
        p = self.patch_size
        x = patchify(torch.cat([x, *shift_4(x)], dim=-1), p, p)
        return linear(self.proj, self.norm(x))


class LSA(nn.Module):
    """Locality Self-Attention (reference vit_for_small_dataset.py:88-121): a
    learnable log-temperature (a scalar, initialised to
    ``log(dim_head ** -0.5)``) scales the f32 logits, the diagonal is replaced
    by ``mask_value(f32)``, the softmax runs in exact f32 and its rounded
    probabilities multiply v (``apply_attention``), as ``vit_tpu``'s eager
    LSA.  Always projects out."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        temperature = torch.tensor(dim_head ** -0.5, dtype=torch.float32).log()
        self.temperature = nn.Parameter(temperature.to(device=device, dtype=dtype))
        self.to_qkv = glorot_linear_(
            nn.Linear(dim, inner * 3, bias=False, device=device, dtype=dtype), generator)
        self.to_out = nn.Sequential(
            glorot_linear_(nn.Linear(inner, dim, device=device, dtype=dtype), generator),
            nn.Dropout(dropout))

    @property
    def dropout_active(self) -> bool:
        return self.training and self.to_out[1].p > 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in linear(self.to_qkv, x).chunk(3, dim=-1))
        dots = (q.float() @ k.float().transpose(-1, -2)) * self.temperature.float().exp()
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        attn = torch.softmax(dots.masked_fill(eye, mask_value(torch.float32)), dim=-1)
        out = apply_attention(attn, v).transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.to_out[1](linear(self.to_out[0], out))


def fused_lsa_eligible(x: torch.Tensor, attn: LSA, mode: str) -> bool:
    """``vit_tpu``'s gate for the LSA half (``_fused_attention_tier``, read at
    vit_for_small_dataset.py:290-292): not the single-head ``dim_head == dim``
    shape, no active dropout, on an activation the kernels take."""
    project_out = not (attn.heads == 1 and attn.dim_head == x.shape[-1])
    return (mode == "auto" and project_out and not attn.dropout_active
            and kernel_activation(x))


class ViT(nn.Module):
    """Constructor parity: reference vit_for_small_dataset.py:160-172.

    ``layers[i]`` holds ``attn_norm``, ``attn`` (:class:`LSA`), ``mlp_norm``
    and ``mlp`` (``attn_norm_{i}`` … at the top of the Flax tree).  See the
    module docstring for the dtypes, the device and the dispatch.
    """

    def __init__(self, image_size, patch_size, num_classes: int, dim: int, depth: int,
                 heads: int, mlp_dim: int, pool: str = "cls", dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype: torch.dtype | None = None, fused_mlp: str = "auto",
                 fused_attention: str = "auto", *, compute_dtype: torch.dtype | None = None,
                 channels: int = 3, device=None, generator: torch.Generator | None = None):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in {"cls", "mean"}:
            raise ValueError("pool type must be either cls (cls token) or mean (mean pooling)")
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        self.fused_attention = check_fused_mode("fused_attention", fused_attention)
        self.pool = pool
        self.compute_dtype = compute_dtype
        num_patches = (ih // ph) * (iw // pw)
        kw = dict(device=resolve_device(device), dtype=dtype)

        self.patch_embedding = SPT(dim, ph, channels, generator=generator, **kw)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.cls_token, generator=generator)
            nn.init.normal_(self.pos_embedding, generator=generator)
        self.emb_dropout = nn.Dropout(emb_dropout)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "attn_norm": LayerNorm(dim, **kw),
                "attn": LSA(dim, heads, dim_head, dropout, generator=generator, **kw),
                "mlp_norm": LayerNorm(dim, **kw),
                "mlp": MLP(dim, mlp_dim, dropout, generator=generator, **kw),
            })
            for _ in range(depth))
        self.head_norm = LayerNorm(dim, **kw)
        self.head = glorot_linear_(nn.Linear(dim, num_classes, **kw), generator)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(img.to(self.compute_dtype or self.cls_token.dtype))
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = self.emb_dropout(x + self.pos_embedding[:, : n + 1].to(x.dtype))

        bias = None  # LSA's mask, built once for every layer that takes the kernel
        for layer in self.layers:
            if fused_lsa_eligible(x, layer["attn"], self.fused_attention):
                if bias is None:
                    bias = lsa_bias(x.shape[1], x.device)
                x = apply_fused_lsa_block(layer["attn_norm"], layer["attn"], x, bias)
            else:
                x = x + layer["attn"](layer["attn_norm"](x))
            x = fused_mlp_residual(x, layer["mlp_norm"], layer["mlp"], self.fused_mlp)

        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return linear(self.head, self.head_norm(x))
