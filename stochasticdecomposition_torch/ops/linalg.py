"""Basis inverse and refactorization in f64 with ``torch.linalg``.

The card has native f64, so the inverse is one batched LU-based
``torch.linalg.inv_ex`` call.  The result is certified the way the JAX
package certifies its refined inverse: a lane whose factorization failed,
or whose residual ``max row-sum |I - B X|`` squared is not below
``resid_tol``, comes back as NaN, the signal every caller already treats as
"this basis is unusable" (solve_lp drops such a warm basis for the slack
basis).
"""

from __future__ import annotations

import torch


def basis_inverse(B: torch.Tensor, resid_tol: float = 1e-6) -> torch.Tensor:
    """Inverse of a batch of square matrices ``B`` [..., m, m]."""
    X, info = torch.linalg.inv_ex(B)
    m = B.shape[-1]
    eye = torch.eye(m, dtype=B.dtype, device=B.device)
    R = eye - B @ X
    r_norm = torch.amax(torch.sum(torch.abs(R), dim=-1), dim=-1)
    ok = (info == 0) & torch.isfinite(r_norm) & (r_norm * r_norm < resid_tol)
    return torch.where(ok[..., None, None], X, torch.full_like(X, float("nan")))


def refactorize(A: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Inverse of the basis matrices ``A[:, basis[l]]`` for every lane l.

    A: [m, nt] shared by the lanes; basis: [lanes, m] column indices."""
    Bm = A[:, basis].permute(1, 0, 2)                  # [lanes, m, m]
    return basis_inverse(Bm)
