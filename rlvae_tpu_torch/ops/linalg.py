"""Batched small-matrix linear algebra for latent-sized SPD matrices.

Port of ``rlvae_tpu/ops/linalg.py``.  The matrices are latent_dim x
latent_dim (D=16); the loops run over D with the batch as the vector width,
in the same column/row order as the JAX routines, so the two agree to
fp32 rounding.  All functions treat the last two dims as the matrix and
broadcast over leading batch dims.
"""

from __future__ import annotations

import torch


def cholesky_small(a: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower-triangular L with L L^T = a (+ jitter*I).

    ``a`` must be SPD; only its lower triangle is read (column j, rows >= j).
    """
    d = a.shape[-1]
    if jitter:
        a = a + jitter * torch.eye(d, dtype=a.dtype, device=a.device)
    rows = torch.arange(d, device=a.device)
    cols = []  # cols[j][..., i] = L[i, j]; built out of place, so autograd can differentiate it
    for j in range(d):
        # v = a[:, j] - sum_{k<j} L[:, k] * L[j, k]
        v = a[..., :, j]
        if j:
            prev = torch.stack(cols, dim=-1)  # [..., D, j]
            v = v - (prev * prev[..., j : j + 1, :]).sum(-1)
        ljj = torch.sqrt(v[..., j : j + 1])
        cols.append(torch.where(rows >= j, v / ljj, torch.zeros_like(v)))
    return torch.stack(cols, dim=-1)


def _as_matrix_rhs(l: torch.Tensor, b: torch.Tensor):
    vec = b.dim() == l.dim() - 1
    return (b.unsqueeze(-1) if vec else b), vec


def tri_solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b for lower-triangular L by forward substitution.

    ``b`` has shape [..., D] or [..., D, M].
    """
    b, vec = _as_matrix_rhs(l, b)
    d = l.shape[-1]
    rows = []
    for i in range(d):
        v = b[..., i, :]
        if i:
            x_prev = torch.stack(rows, dim=-2)  # [..., i, M]
            v = v - (l[..., i, :i].unsqueeze(-1) * x_prev).sum(-2)
        rows.append(v / l[..., i, i].unsqueeze(-1))
    x = torch.stack(rows, dim=-2)
    return x[..., 0] if vec else x


def tri_solve_upper_t(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b (L lower-triangular) by back substitution."""
    b, vec = _as_matrix_rhs(l, b)
    d = l.shape[-1]
    rows = [None] * d
    for i in reversed(range(d)):
        v = b[..., i, :]
        if i < d - 1:
            x_next = torch.stack(rows[i + 1 :], dim=-2)  # [..., d-i-1, M]
            # (L^T)[i, k] = L[k, i]
            v = v - (l[..., i + 1 :, i].unsqueeze(-1) * x_next).sum(-2)
        rows[i] = v / l[..., i, i].unsqueeze(-1)
    x = torch.stack(rows, dim=-2)
    return x[..., 0] if vec else x


def logdet_from_chol(l: torch.Tensor) -> torch.Tensor:
    """log det(A) given L = chol(A): 2 * sum(log diag L)."""
    return 2.0 * torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)


def solve_psd_small(a: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve a x = b for SPD ``a`` via the unrolled Cholesky."""
    l = cholesky_small(a, jitter=jitter)
    return tri_solve_upper_t(l, tri_solve_lower(l, b))


def inv_psd_small(a: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Inverse of an SPD matrix via unrolled Cholesky solves against I."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(a.shape)
    return solve_psd_small(a, eye, jitter=jitter)
