"""DeiT-style knowledge distillation (port of ``vit_tpu/objectives/distill.py``).

``Distillable{ViT,T2TViT,EfficientViT}`` append a learnable distillation
token after the pos-embedded sequence (dropout after the concat, as the
reference's mixin, distill.py:26-30), and return ``(logits,
distill_tokens)`` when one is passed.

``DistillWrapper`` combines cross-entropy on the student's logits with a
distillation term from a LayerNorm + Linear head over the distillation
token.  The teacher runs under ``torch.no_grad()`` (``stop_gradient`` in
``vit_tpu``): its parameters get no gradient, and on the card its blocks
take the serving kernels while the student's take the training ones.
``vit_tpu``'s fixes are kept (SURVEY §8.8): soft mode is ``KL(softmax(t/T) ‖
softmax(d/T)) · T²`` with a batch mean, hard mode the sparse cross-entropy on
the teacher's argmax; the loss is the scalar mean, in f32.  Labels may be
integers ``(b,)`` or one-hot ``(b, classes)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import LayerNorm, glorot_linear_, linear
from vit_tpu_torch.models.efficient import ViT as EfficientViT
from vit_tpu_torch.models.t2t import T2TViT
from vit_tpu_torch.models.vit import ViT


def _with_distill_token(x: torch.Tensor, distill_token: torch.Tensor | None) -> torch.Tensor:
    if distill_token is None:
        return x
    return torch.cat([x, distill_token.to(x.dtype).expand(x.shape[0], -1, -1)], dim=1)


def _split(x: torch.Tensor, distilling: bool):
    return (x[:, :-1], x[:, -1]) if distilling else (x, None)


def _out(logits: torch.Tensor, distill_tokens: torch.Tensor | None):
    return logits if distill_tokens is None else (logits, distill_tokens)


class DistillableViT(ViT):
    """Reference distill.py:47-58."""

    def forward(self, img: torch.Tensor, distill_token: torch.Tensor | None = None):
        x = _with_distill_token(self.tokens(self.to_patch(img)), distill_token)
        x, distill_tokens = _split(self.transformer(self.emb_dropout(x)),
                                   distill_token is not None)
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return _out(linear(self.head, self.head_norm(x)), distill_tokens)


class DistillableT2TViT(T2TViT):
    """Reference distill.py:61-72 (``vit_tpu/objectives/distill.py:76-147``):
    the distillation token after the pos-embedded sequence, before the
    dropout, as :class:`DistillableViT`."""

    def forward(self, img: torch.Tensor, distill_token: torch.Tensor | None = None):
        x = _with_distill_token(self.tokens(img), distill_token)
        x, distill_tokens = _split(self.transformer(self.emb_dropout(x)),
                                   distill_token is not None)
        return _out(self.pool_head(x), distill_tokens)


class DistillableEfficientViT(EfficientViT):
    """Reference distill.py:74-85."""

    def forward(self, img: torch.Tensor, distill_token: torch.Tensor | None = None):
        x = _with_distill_token(self.embed(img), distill_token)
        x, distill_tokens = _split(self.transformer(x), distill_token is not None)
        return _out(self.pool_head(x), distill_tokens)


def _sparse_cross_entropy(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -logp.gather(-1, labels[:, None].long())[:, 0]


class DistillWrapper(nn.Module):
    """Constructor parity: reference distill.py:88; plus ``device=``,
    ``dtype=``, ``compute_dtype=`` (the distillation head's, ``vit_tpu``'s
    ``dtype``) and ``generator=``.  ``forward((img, labels))`` returns the
    scalar loss."""

    def __init__(self, teacher: nn.Module, student: nn.Module, temperature: float = 1.0,
                 alpha: float = 0.5, hard: bool = False, dtype: torch.dtype | None = None, *,
                 compute_dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not isinstance(student, (DistillableViT, DistillableT2TViT, DistillableEfficientViT)):
            raise TypeError("student must be a vision transformer")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.teacher, self.student = teacher, student
        self.temperature, self.alpha, self.hard = temperature, alpha, hard
        self.compute_dtype = compute_dtype
        dim = student.pos_embedding.shape[-1]
        self.distillation_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.distillation_token, generator=generator)
        self.distill_norm = LayerNorm(dim, **kw)
        self.distill_head = glorot_linear_(nn.Linear(dim, student.head.out_features, **kw),
                                           generator)

    def forward(self, inputs, temperature: float | None = None,
                alpha: float | None = None) -> torch.Tensor:
        img, labels = inputs
        alpha = alpha if alpha is not None else self.alpha
        T = temperature if temperature is not None else self.temperature

        with torch.no_grad():
            teacher_logits = self.teacher(img)
        student_logits, distill_tokens = self.student(img, distill_token=self.distillation_token)
        distill_tokens = distill_tokens.to(self.compute_dtype or self.distill_head.weight.dtype)
        distill_logits = linear(self.distill_head, self.distill_norm(distill_tokens))

        student_logp = F.log_softmax(student_logits.float(), dim=-1)
        if labels.dim() == 1:  # integer labels: sparse cross-entropy
            ce = _sparse_cross_entropy(student_logp, labels)
        else:  # one-hot labels (the reference's documented usage)
            ce = -(labels.float() * student_logp).sum(dim=-1)
        loss = ce.mean()

        if not self.hard:
            t_prob = F.softmax(teacher_logits.float() / T, dim=-1)
            d_logp = F.log_softmax(distill_logits.float() / T, dim=-1)
            kl = (t_prob * ((t_prob + 1e-12).log() - d_logp)).sum(dim=-1)
            distill_loss = kl.mean() * T ** 2
        else:  # sparse cross-entropy on the teacher's argmax (§8.8)
            d_logp = F.log_softmax(distill_logits.float(), dim=-1)
            distill_loss = _sparse_cross_entropy(d_logp, teacher_logits.argmax(dim=-1)).mean()

        return loss * (1 - alpha) + distill_loss * alpha
