"""Layers with Flax's semantics, shared by the CNN and ResNet nets.

The JAX nets (``rlvae_tpu/nets/cnn.py``, ``resnet.py``) compute in NHWC with
``flax.linen`` layers; the port keeps activations in NCHW, PyTorch's layout
for cuDNN, and reproduces each layer's arithmetic:

- :class:`Conv` is ``nn.Conv``: input, kernel and bias cast to ``dtype``;
  ``"SAME"`` padding is XLA's, (lo, hi) = (total // 2, total - total // 2)
  with total = max((ceil(n / s) - 1) s + k - n, 0), so a stride-2 3x3 on
  an even size pads (0, 1), which ``F.conv2d`` cannot express alone (an
  ``F.pad`` first); explicit ``((lo, hi), (lo, hi))`` pads as given.
- :class:`ConvTranspose` is ``nn.ConvTranspose(padding="SAME")``: Flax
  dilates the input by the stride, pads it by ``lax.conv_transpose``'s
  rule ((2, 1) for k=3, (2, 2) for k=4 at stride 2) and correlates with the
  kernel unflipped.  ``F.conv_transpose2d`` correlates with the kernel
  flipped and pads k-1-p on each side, so the port keeps its weight in
  PyTorch's layout [in, out, kh, kw] (the Flax kernel flipped in H and W,
  in/out swapped; :mod:`rlvae_tpu_torch.convert`), takes p = k-1-lo, an
  output padding of hi-lo where that is >= 0, and crops the last -(hi-lo)
  rows and columns where it is not (k=3: p=0 and one cropped; k=4: p=1).
- :class:`BatchNorm` is ``nn.BatchNorm(dtype=float32)`` with Flax's
  defaults (momentum 0.99, epsilon 1e-5, ``use_fast_variance``): in train
  the batch's mean and var = max(E[x^2] - E[x]^2, 0) over (N, H, W) in
  fp32, and the buffers ``mean``/``var`` move by 0.99 old + 0.01 batch
  (the biased var, unlike ``nn.BatchNorm2d``), once per call, without
  gradient; in eval the buffers.  The output is fp32,
  (x - mean) * (rsqrt(var + eps) * scale) + bias in Flax's order.
- :func:`dropout` is ``nn.Dropout``: survivors divided by the keep
  probability cast to the activation's dtype, dropped entries zero.  The
  keep-masks come from a :class:`DropoutMasks`, which draws them from an
  explicit ``torch.Generator`` (never the global one) or replays given
  masks.

fp32 convolutions and products run in IEEE fp32 on the card whatever the
global TF32 flags say (:func:`ieee_fp32`): cuDNN lets convolutions use
TF32 by default, and the fidelity rule for an fp32 policy is fp32
arithmetic.  Parameters are fp32 and initialised from a seeded generator
(:func:`init_net`: a net from seed 0 when it is built, the model's nets
again from the model's generator), never from the global one.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Padding = Union[str, Sequence[Tuple[int, int]]]
BN_MOMENTUM = 0.99
BN_EPSILON = 1e-5


@contextlib.contextmanager
def ieee_fp32():
    """cuDNN convolutions and cuBLAS products in IEEE fp32 (no TF32) inside."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


class _IEEEConv(torch.autograd.Function):
    """``aten.convolution`` and its backward, both under :func:`ieee_fp32`."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, transposed, output_padding):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, transposed, output_padding)
        with ieee_fp32():
            return torch.ops.aten.convolution(x, w, b, stride, padding, [1, 1], transposed,
                                              output_padding, 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, transposed, output_padding = ctx.conf
        with ieee_fp32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, [w.shape[1] if transposed else w.shape[0]], stride,
                padding, [1, 1], transposed, output_padding, 1, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None, None, None, None


class _IEEELinear(torch.autograd.Function):
    """``F.linear`` of 2-D inputs and its backward, both under :func:`ieee_fp32`."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with ieee_fp32():
            return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with ieee_fp32():
            gx = g.mm(w) if ctx.needs_input_grad[0] else None
            gw = g.t().mm(x) if ctx.needs_input_grad[1] else None
        gb = g.sum(0) if ctx.needs_input_grad[2] else None
        return gx, gw, gb


def ieee_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of fp32 matrices, forward and backward under :func:`ieee_fp32`."""
    return _IEEELinear.apply(a, b.t(), None)


def conv(x, w, b, stride, padding, transposed=False, output_padding=(0, 0)):
    """One (transposed) convolution; fp32 operands under :func:`ieee_fp32`.
    In a lower precision the bias is added to the rounded convolution, as
    Flax's ``y = conv(x, kernel); y += bias`` does."""
    stride, padding, output_padding = list(stride), list(padding), list(output_padding)
    if x.dtype == torch.float32:
        return _IEEEConv.apply(x, w, b, stride, padding, transposed, output_padding)
    if transposed:
        y = F.conv_transpose2d(x, w, None, stride, padding, output_padding)
    else:
        y = F.conv2d(x, w, None, stride, padding)
    return y + b[:, None, None]


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``Dense(dtype=dtype)``: input and parameters cast to ``dtype``;
    fp32 under :func:`ieee_fp32`.  A tensor-parallel layer
    (``parallel.sharding.ShardedLinear``) computes on its slice."""
    sharded = getattr(layer, "sharded_dense", None)
    if sharded is not None:
        return sharded(x, dtype)
    x, w, b = x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype)
    if dtype == torch.float32 and x.dim() == 2:
        return _IEEELinear.apply(x, w, b)
    return F.linear(x, w, b)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding (lo, hi) of one spatial dimension."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """``lax.conv_transpose``'s ``"SAME"`` padding (lo, hi) of the dilated input."""
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return lo, pad_len - lo


class Conv(nn.Module):
    """``flax.linen.Conv`` over NCHW; weight [out, in, kh, kw] (Flax: HWIO)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Padding = "SAME", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            (hl, hh), (wl, wh) = (same_pads(n, self.kernel, self.stride) for n in x.shape[2:])
        else:
            (hl, hh), (wl, wh) = self.padding
        x = x.to(self.dtype)
        if (hl, wl) != (hh, wh):
            x, pads = F.pad(x, (wl, wh, hl, hh)), (0, 0)
        else:
            pads = (hl, wl)
        return conv(x, self.kernel_weight().to(self.dtype), self.bias.to(self.dtype),
                    (self.stride, self.stride), pads)

    def kernel_weight(self) -> torch.Tensor:
        """The weight the convolution applies (a masked layer overrides it)."""
        return self.weight


class ConvTranspose(nn.Module):
    """``flax.linen.ConvTranspose(padding="SAME")`` over NCHW; weight
    [in, out, kh, kw] in ``F.conv_transpose2d``'s layout (module docstring)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        lo, hi = transpose_pads(kernel, stride)
        self.pad = kernel - 1 - lo
        self.out_pad, self.crop = max(hi - lo, 0), max(lo - hi, 0)
        if self.pad < 0 or self.out_pad >= stride:
            raise ValueError(f"no conv_transpose2d form of k={kernel}, s={stride} SAME")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, p, op = (self.stride,) * 2, (self.pad,) * 2, (self.out_pad,) * 2
        y = conv(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype),
                 s, p, transposed=True, output_padding=op)
        if self.crop:
            y = y[:, :, :y.shape[2] - self.crop, :y.shape[3] - self.crop]
        return y


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(dtype=float32)`` over the channels of NCHW
    (module docstring).  ``weight``/``bias`` are Flax's ``scale``/``bias``;
    the buffers ``mean``/``var`` its ``batch_stats``."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            axes = (0, 2, 3)
            mean = xf.mean(axes)
            var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPSILON) * self.weight
        return (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


MaskFn = Callable[[Tuple[int, ...], float, torch.device], torch.Tensor]


class DropoutMasks:
    """The keep-masks of one forward's dropout layers, in call order.

    Drawn from ``generator`` (keep where U[0, 1) < 1 - rate, as Flax's
    ``bernoulli``), or taken in order from ``replay``.  With ``record`` every
    mask handed out is kept in ``drawn``, so a run can be replayed (on
    another device) with ``DropoutMasks(replay=masks.drawn)``.  Without a
    generator or a replay, a draw raises: dropout never falls back to the
    global generator."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 replay: Optional[Sequence[torch.Tensor]] = None, record: bool = False):
        self.generator = generator
        self.replay = None if replay is None else list(replay)
        self.record = record
        self.drawn: List[torch.Tensor] = []

    def __call__(self, shape: Tuple[int, ...], rate: float, device: torch.device) -> torch.Tensor:
        if self.replay is not None:
            if not self.replay:
                raise ValueError("dropout replay ran out of masks")
            keep = self.replay.pop(0).to(device)
            if tuple(keep.shape) != tuple(shape):
                raise ValueError(f"replayed mask of shape {tuple(keep.shape)} for {shape}")
        elif self.generator is None:
            raise ValueError("a train forward with dropout needs a generator or masks")
        else:
            keep = torch.rand(shape, generator=self.generator, device=device) < 1.0 - rate
        if self.record:
            self.drawn.append(keep)
        return keep


def dropout(x: torch.Tensor, rate: float, train: bool,
            masks: Optional[MaskFn]) -> torch.Tensor:
    """``flax.linen.Dropout(rate)(x, deterministic=not train)``."""
    if not train or rate <= 0:
        return x
    keep = masks(tuple(x.shape), rate, x.device)
    keep_prob = float(torch.tensor(1.0 - rate, dtype=x.dtype))  # Flax's weakly typed scalar
    return torch.where(keep, x / keep_prob, 0.0)


def init_net(net: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every ``nn.Linear``, :class:`Conv` and
    :class:`ConvTranspose` of ``net``, in module order: weight, then bias,
    each U(-1/sqrt(fan_in), +1/sqrt(fan_in)) (PyTorch's default bounds;
    fan_in = in * kh * kw for a convolution, transposed or not).
    :class:`BatchNorm` starts at scale 1, bias 0, mean 0, var 1, as Flax's."""
    for layer in net.modules():
        if isinstance(layer, nn.Linear):
            fan_in = layer.in_features
        elif isinstance(layer, (Conv, ConvTranspose)):
            w = layer.weight
            fan_in = (w.shape[0] if isinstance(layer, ConvTranspose) else w.shape[1]) \
                * w.shape[2] * w.shape[3]
        else:
            continue
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            for p in (layer.weight, layer.bias):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
