"""Checks shared by the kernel wrappers before a pointer reaches CUDA."""

from __future__ import annotations

import torch


def check_inputs(name: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """Every tensor fp32, contiguous, on ``device``, and not requiring grad:
    a raw kernel wrapper is not differentiable; gradients go through the
    autograd Functions (``CholBundle``, ``IAFChain``), which pass detached
    tensors."""
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: {arg} requires grad, but the raw kernel wrapper is not "
                "differentiable (use the module's autograd Function)"
            )


def raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {code}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
