"""Checks shared by the kernel wrappers before a pointer reaches CUDA, and
the plain route that call sites take past a kernel's envelope."""

from __future__ import annotations

from typing import Callable

import torch


def plain_route(plain: Callable, z: torch.Tensor, *args):
    """``plain(z, *args)``: the plain version a call site takes past its
    kernel's envelope (a metric kernel past D = 32, the IAF chain past D = 32
    or H = 256), as the JAX package takes XLA there.  Counts the calls on
    CUDA tensors in ``plain_route.calls``, which stays 0 inside the
    envelopes."""
    if z.device.type == "cuda":
        plain_route.calls += 1
    return plain(z, *args)


plain_route.calls = 0


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
