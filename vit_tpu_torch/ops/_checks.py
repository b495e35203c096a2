"""Argument checks shared by the kernel wrappers (run before any launch)."""

from __future__ import annotations

import torch

KERNEL_DTYPES = (torch.bfloat16, torch.float16)


def forbid_grad(name: str, *tensors) -> None:
    """The Hopper kernels are forward only until their backward kernels are
    ported; refuse a call that autograd would have to differentiate."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet; call it under "
            "torch.no_grad() / torch.inference_mode(), or build the model with "
            "fused_attention='never', fused_mlp='never' for the plain path")


def check_kernel_tensors(name: str, x: torch.Tensor, weights: dict) -> None:
    """``x`` must be a contiguous 16-bit CUDA tensor with 16-byte aligned
    rows; each weight ``{label: (tensor, shape)}`` must match its shape and
    ``x``'s device and dtype, and be contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes bfloat16 or float16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")
    for label, (t, shape) in weights.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name}: {label} is {t.dtype} on {t.device}, "
                            f"expected {x.dtype} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")


def launch_stream(x: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream
