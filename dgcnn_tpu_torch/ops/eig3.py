"""Closed-form symmetric 3x3 eigendecomposition, batched, on the tensors'
device (port of dgcnn_tpu/ops/eig3.py).

The eigenvalues come from the trigonometric (Cardano) method, the principal
eigenvector from the Cayley-Hamilton identity (A - l2 I)(A - l3 I), whose
columns span the l1 eigenspace, polished by two shifted inverse-iteration
steps; its sign is fixed so that its largest-magnitude component is
non-negative.  The operations and their order are the JAX package's: the
3x3 determinant is its six-term expansion (``jnp.linalg.det`` on 3x3
matrices), not an LU factorization.  Everything is elementwise; no host
round trip and no loop.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-20


def _eye(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=a.dtype, device=a.device)


def _det3(a: torch.Tensor) -> torch.Tensor:
    """det of (..., 3, 3), the six-term expansion in JAX's order."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def eigvals3x3_sym_desc(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3) matrices, descending: (..., 3)
    with lam[..., 0] >= lam[..., 1] >= lam[..., 2]."""
    a = a.float()
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    b = a - q[..., None, None] * _eye(a)
    p2 = torch.square(b).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    # r = det(B / p) / 2, guarded for p ~ 0 (isotropic: all eigenvalues q)
    safe_p = torch.clamp(p, min=_EPS)
    r = torch.clamp(_det3(b / safe_p[..., None, None]) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam0 = q + 2.0 * p * torch.cos(phi)
    lam2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam1 = 3.0 * q - lam0 - lam2
    return torch.stack([lam0, lam1, lam2], dim=-1)


def _unit_or(v: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """v / |v| where |v|^2 > eps, else ``fallback``."""
    norm_sq = torch.square(v).sum(-1, keepdim=True)
    return torch.where(norm_sq > _EPS,
                       v * torch.rsqrt(torch.clamp(norm_sq, min=_EPS)),
                       fallback)


def _cayley_eigvec(a: torch.Tensor, l1: torch.Tensor,
                   l2: torch.Tensor) -> torch.Tensor:
    """Largest-norm column of (A - l1 I)(A - l2 I), unit-normalized (or
    e_z)."""
    eye = _eye(a)
    m = torch.matmul(a - l1[..., None, None] * eye,
                     a - l2[..., None, None] * eye)
    best = torch.square(m).sum(-2).argmax(-1)                    # (...,)
    v = torch.gather(m, -1, best[..., None, None].expand(
        *m.shape[:-1], 1))[..., 0]
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    return _unit_or(v, fallback)


def _rayleigh(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rayleigh quotient v^T A v of a unit v."""
    av = torch.einsum("...ij,...j->...i", a, v)
    return (av * v).sum(-1)


def _cross(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u x w over the last axis, in ``jnp.cross``'s operation order."""
    return torch.stack([u[..., 1] * w[..., 2] - u[..., 2] * w[..., 1],
                        u[..., 2] * w[..., 0] - u[..., 0] * w[..., 2],
                        u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0]],
                       dim=-1)


def _adjugate3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate of (..., 3, 3): adj(M) @ M = det(M) I."""
    c0 = _cross(m[..., :, 1], m[..., :, 2])
    c1 = _cross(m[..., :, 2], m[..., :, 0])
    c2 = _cross(m[..., :, 0], m[..., :, 1])
    return torch.stack([c0, c1, c2], dim=-2)   # rows = cofactor rows


def _inverse_iteration_step(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One shifted inverse-iteration step v <- adj(A - sigma I) v,
    normalized, sigma the Rayleigh quotient of v; oriented along v."""
    sigma = _rayleigh(a, v)
    m = a - sigma[..., None, None] * _eye(a)
    w = torch.einsum("...ij,...j->...i", _adjugate3(m), v)
    w = w * torch.where((w * v).sum(-1) < 0, -1.0, 1.0)[..., None]
    return _unit_or(w, v)


def principal_eigvec3x3_sym(a: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector (..., 3) of the largest eigenvalue of symmetric
    (..., 3, 3) matrices: Cayley-Hamilton, two polish steps, and the sign
    that makes the largest-magnitude component non-negative."""
    a = a.float()
    lam = eigvals3x3_sym_desc(a)
    v = _cayley_eigvec(a, lam[..., 1], lam[..., 2])
    v = _inverse_iteration_step(a, v)
    v = _inverse_iteration_step(a, v)
    dom = torch.gather(v, -1, v.abs().argmax(-1, keepdim=True))
    return v * torch.where(dom[..., 0] < 0, -1.0, 1.0)[..., None]


def principal_eig3x3_sym(
        a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Principal (eigenvector, polished eigenvalue) of symmetric
    (..., 3, 3) matrices."""
    a32 = a.float()
    v = principal_eigvec3x3_sym(a32)
    return v, _rayleigh(a32, v)
