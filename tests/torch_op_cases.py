"""The port's ten serving kernel ops as one-op cases, shared by
``test_torch_export.py`` (CPU) and ``test_torch_kernels_gpu.py`` (the card),
the inputs drawn from a seed at small shapes the kernels take (d 64, two
heads of 32, 24 tokens; the fused MLP also at the ragged width 36).  Imports
no JAX; pytest does not collect it."""

from typing import Callable, NamedTuple

import torch

from vit_tpu_torch.ops import flash_attention as fa
from vit_tpu_torch.ops import flash_attention_packed as fap
from vit_tpu_torch.ops import fused_attention_block as fab
from vit_tpu_torch.ops import fused_cross_attention as fca
from vit_tpu_torch.ops import fused_hybrid as fh
from vit_tpu_torch.ops import fused_mlp as fm
from vit_tpu_torch.ops import short_attention as sa

NAMES = ("fused_mlp", "fused_mlp_ragged", "fused_attention_block", "fused_attention_block_bias",
         "fused_cross_attention", "flash_attention", "flash_attention_packed", "short_attention",
         "ln_gemm", "attention_nb", "proj_mlp")
EPS = 1e-3  # the entries' default


class Case(NamedTuple):
    entry: Callable    # entry(*args, **kwargs): the public op, without autograd
    op: object         # the registered op it calls
    args: tuple
    kwargs: dict
    op_args: tuple     # what entry passes the registered op
    plain: Callable    # plain(*args, **kwargs): the plain PyTorch version
    direct: Callable   # direct(*args, **kwargs): the launcher the op's CUDA side calls


def case(name: str, device="cpu", dtype=torch.float32, seed: int = 0) -> Case:
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=g, device=device) * scale).to(dt)

    def norm(d):
        return rn(d, scale=0.1) + 1.0, rn(d, scale=0.1)

    b, n, heads, dh = 2, 24, 2, 32
    d, scale = heads * dh, dh ** -0.5
    if name.startswith("fused_mlp"):
        width = 36 if name == "fused_mlp_ragged" else d  # off 8: the ragged route
        args = (rn(b, n, width), *norm(width), rn(2 * d, width, scale=width ** -0.5),
                rn(2 * d, scale=0.1), rn(width, 2 * d, scale=(2 * d) ** -0.5),
                rn(width, scale=0.1))
        return Case(fm.fused_mlp, fm.fused_mlp_op, args, {}, (*args, EPS),
                    fm.fused_mlp_reference,
                    lambda *a: fm._launch_forward(*a, EPS, save_residuals=False)[0])
    if name.startswith("fused_attention_block"):
        args = (rn(b, n, d), *norm(d), rn(3 * d, d, scale=d ** -0.5), rn(d, d, scale=d ** -0.5),
                rn(d, scale=0.1))
        kw = dict(heads=heads, dim_head=dh)
        if name.endswith("bias"):
            args = (*args, rn(heads, n, n, dt=torch.float32))
            return Case(fab.fused_attention_block_bias, fab.fused_attention_block_bias_op, args,
                        kw, (*args, heads, dh, scale, EPS),
                        lambda *a, **k: fab.fused_attention_block_reference(*a[:6], bias=a[6],
                                                                            **k),
                        lambda *a, **k: fab._launch_forward(*a[:6], heads, dh, scale, EPS,
                                                            a[6])[0])
        return Case(fab.fused_attention_block, fab.fused_attention_block_op, args, kw,
                    (*args, heads, dh, scale, EPS), fab.fused_attention_block_reference,
                    lambda *a, **k: fab._launch_forward(*a, heads, dh, scale, EPS)[0])
    if name == "fused_cross_attention":
        n_k = 16
        args = (rn(b, n, d), rn(b, n, d), rn(d, d, scale=d ** -0.5), rn(b, n_k, d), rn(b, n_k, d),
                rn(d, d, scale=d ** -0.5), rn(d, scale=0.1))
        return Case(fca.fused_cross_attention, fca.fused_cross_attention_op, args,
                    dict(heads=heads, dh_k=dh, dh_v=dh), (*args, heads, dh, dh, scale),
                    fca.fused_cross_attention_reference,
                    lambda *a, **k: fca._launch_forward(*a, heads, dh, dh, scale)[0])
    if name == "flash_attention":
        args = (rn(b, heads, n, dh), rn(b, heads, 40, dh), rn(b, heads, 40, dh))
        return Case(fa.flash_attention, fa.flash_attention_op, args, {}, (*args, scale),
                    lambda *a: fa.flash_attention_forward_reference(*a)[0],
                    lambda *a: fa.flash_attention_forward(*a, scale)[0])
    if name == "flash_attention_packed":
        args = (rn(b, n, d), rn(b, 40, d), rn(b, 40, d))
        return Case(fap.flash_attention_packed, fap.flash_attention_packed_op, args,
                    dict(heads=heads), (*args, heads, scale),
                    lambda *a, **k: fap.flash_attention_packed_forward_reference(*a, **k)[0],
                    lambda *a, **k: fap.flash_attention_packed_forward(*a, heads, scale)[0])
    if name == "short_attention":
        args = tuple(rn(b, heads, n, dh) for _ in range(3))
        return Case(sa.short_attention, sa.short_attention_op, args, {}, (*args, scale),
                    lambda *a: sa.short_attention_forward_reference(*a)[0],
                    lambda *a: sa.short_attention_forward(*a, scale, need_lse=False)[0])
    if name == "ln_gemm":
        args = (rn(n, b, d), *norm(d), rn(3 * d, d, scale=d ** -0.5))
        return Case(fh.ln_gemm, fh.ln_gemm_op, args, {}, (*args, EPS),
                    lambda x, *a: fh.ln_gemm_forward_reference(x.reshape(-1, d), *a)[0]
                    .view(n, b, -1),
                    lambda x, *a: fh._launch_ln_gemm(x.reshape(-1, d), *a, EPS)[0]
                    .view(n, b, -1))
    if name == "attention_nb":
        args = tuple(rn(n, b, d) for _ in range(3))
        return Case(fh.attention_nb, fh.attention_nb_op, args, dict(heads=heads, dim_head=dh),
                    (*args, heads, dh, scale),
                    lambda *a, **k: fh.attention_nb_forward_reference(*a, **k)[0],
                    lambda *a, **k: fh.attention_nb_forward(*a, heads, dh, scale,
                                                            need_lse=False)[0])
    if name == "proj_mlp":
        hidden = 2 * d
        args = (rn(n, b, d), rn(n, b, d), rn(d, d, scale=d ** -0.5), rn(d, scale=0.1), *norm(d),
                rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1),
                rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1))

        def rows(fn):
            return lambda x, o, *a: fn(x.reshape(-1, d), o.reshape(-1, d), *a)[0].view(x.shape)

        return Case(fh.proj_mlp, fh.proj_mlp_op, args, {}, (*args, EPS),
                    rows(fh.proj_mlp_forward_reference),
                    rows(lambda *a: fh._launch_proj_mlp(*a, EPS, save_residuals=False)))
    raise KeyError(name)


class OneOp(torch.nn.Module):
    """``forward(*args) = entry(*args, **kwargs)``: one op as a module."""

    def __init__(self, entry, kwargs):
        super().__init__()
        self.entry, self.kwargs = entry, kwargs

    def forward(self, *args):
        return self.entry(*args, **self.kwargs)


def fake_output(op, op_args):
    """``op``'s output under fake tensors made from ``op_args``: what
    ``torch.export`` records of it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        return op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in op_args))
