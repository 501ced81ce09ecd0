"""IAF chain forward: every temporal transition of the density-direction IAF
in one launch.

Port of the forward of ``_build_fused_iaf_chain``
(``rlvae_tpu/ops/iaf_kernels.py:504-583``) as the hand-written CUDA kernel
``csrc/iaf_chain.cu``.  The weights arrive mask-premultiplied and stacked per
transition (the temporal chain's reused last flow appears once per use):

    w0 [NT, NB, D, H]          b0 [NT, NB, H]
    wh [NT, NB, NH-1, H, H]    bh [NT, NB, NH-1, H]
    wo [NT, NB, H, 2D]         bo [NT, NB, 2D]

and the kernel returns z [NT, B, D] (each transition's output) and
ld [NT, B] (its log|det J|).  :func:`iaf_chain_fwd` launches the kernel for
CUDA tensors and runs :func:`iaf_chain_fwd_ref`, the plain PyTorch version,
for CPU tensors.  ``iaf_chain_fwd.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from rlvae_tpu_torch.flows.made import LOG_VAR_CLAMP
from rlvae_tpu_torch.ops._launch import check_inputs, raise_on_error, stream_handle

MAX_DIM = 32  # csrc/iaf_chain.cu: MAX_D
MAX_HIDDEN = 256  # csrc/iaf_chain.cu: MAX_H

Stack = Tuple[torch.Tensor, ...]


def stack_chain(chain: Sequence) -> Stack:
    """(w0, b0, wh, bh, wo, bo) from one IAF module per transition."""
    per_t = []
    for iaf in chain:
        blocks = list(iaf.blocks)
        last = blocks[0].n_layers - 1
        hidden = range(1, last)  # the [H, H] layers between layer 0 and the output
        h = blocks[0].weights[0].shape[1]
        per_t.append((
            torch.stack([blk.masked_weight(0) for blk in blocks]),
            torch.stack([blk.biases[0] for blk in blocks]),
            torch.stack([
                torch.stack([blk.masked_weight(li) for li in hidden]) if len(hidden)
                else blk.weights[0].new_zeros((0, h, h))
                for blk in blocks
            ]),
            torch.stack([
                torch.stack([blk.biases[li] for li in hidden]) if len(hidden)
                else blk.biases[0].new_zeros((0, h))
                for blk in blocks
            ]),
            torch.stack([blk.masked_weight(last) for blk in blocks]),
            torch.stack([blk.biases[last] for blk in blocks]),
        ))
    return tuple(torch.stack([p[i] for p in per_t]).contiguous() for i in range(6))


def _shapes(z0: torch.Tensor, w0, b0, wh, bh, wo, bo):
    if z0.dim() != 2 or w0.dim() != 4:
        raise ValueError(f"iaf_chain_fwd: z0 [B,D] and w0 [NT,NB,D,H] expected, got "
                         f"{tuple(z0.shape)}, {tuple(w0.shape)}")
    b, d = z0.shape
    nt, nb, d_w, h = w0.shape
    nh = wh.shape[2] + 1 if wh.dim() == 5 else -1
    expected = {
        "w0": (nt, nb, d, h), "b0": (nt, nb, h), "wh": (nt, nb, nh - 1, h, h),
        "bh": (nt, nb, nh - 1, h), "wo": (nt, nb, h, 2 * d), "bo": (nt, nb, 2 * d),
    }
    for name, t in zip(expected, (w0, b0, wh, bh, wo, bo)):
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"iaf_chain_fwd: {name} has shape {tuple(t.shape)}, "
                             f"expected {expected[name]}")
    return b, d, h, nb, nh, nt


def iaf_chain_fwd_ref(z0: torch.Tensor, w0, b0, wh, bh, wo, bo) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (z [NT, B, D], ld [NT, B]), in the weights' dtype."""
    b, d, h, nb, nh, nt = _shapes(z0, w0, b0, wh, bh, wo, bo)
    x = z0.to(w0.dtype)
    zs, lds = [], []
    for t in range(nt):
        ld = torch.zeros(b, dtype=x.dtype, device=z0.device)
        for blk in range(nb):
            y = torch.zeros_like(x)
            for i in range(d):
                a = y @ w0[t, blk] + b0[t, blk]  # no activation after layer 0
                for li in range(nh - 1):
                    a = torch.relu(a @ wh[t, blk, li] + bh[t, blk, li])
                out = a @ wo[t, blk] + bo[t, blk]
                s = torch.clamp(out[:, d + i], -LOG_VAR_CLAMP, LOG_VAR_CLAMP)
                y = y.clone()
                y[:, i] = (x[:, i] - out[:, i]) * torch.exp(-s)
                ld = ld - s
            x = torch.flip(y, dims=(1,))
        zs.append(x)
        lds.append(ld)
    return torch.stack(zs), torch.stack(lds)


def iaf_chain_fwd(z0: torch.Tensor, w0, b0, wh, bh, wo, bo) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z [NT, B, D], ld [NT, B]); kernel on CUDA, plain version on CPU."""
    if z0.device.type == "cpu":
        return iaf_chain_fwd_ref(z0, w0, b0, wh, bh, wo, bo)
    if z0.device.type != "cuda":
        raise ValueError(f"iaf_chain_fwd: unsupported device {z0.device}")
    check_inputs("iaf_chain_fwd", z0.device, z0=z0, w0=w0, b0=b0, wh=wh, bh=bh, wo=wo, bo=bo)
    b, d, h, nb, nh, nt = _shapes(z0, w0, b0, wh, bh, wo, bo)
    if not (1 <= d <= MAX_DIM and 4 <= h <= MAX_HIDDEN and h % 4 == 0 and nb >= 1
            and nh >= 1 and nt >= 1):
        raise ValueError(
            f"iaf_chain_fwd: kernel takes D<={MAX_DIM}, H<={MAX_HIDDEN} with H%4==0, "
            f"NB, NH, NT >= 1; got D={d}, H={h}, NB={nb}, NH={nh}, NT={nt}"
        )
    z = torch.empty((nt, b, d), dtype=torch.float32, device=z0.device)
    ld = torch.empty((nt, b), dtype=torch.float32, device=z0.device)
    if b == 0:
        return z, ld
    from rlvae_tpu_torch.ops.build import kernel_library

    code = kernel_library().iaf_chain_fwd_f32(
        z0.data_ptr(), w0.data_ptr(), b0.data_ptr(), wh.data_ptr(), bh.data_ptr(),
        wo.data_ptr(), bo.data_ptr(), z.data_ptr(), ld.data_ptr(),
        b, d, h, nb, nh, nt, stream_handle(z0.device),
    )
    raise_on_error("iaf_chain_fwd", code)
    iaf_chain_fwd.launches += 1
    return z, ld


iaf_chain_fwd.launches = 0
