"""Newton's method with a dense Jacobian, for the references' own solves at
the CPU tests' sizes (a few thousand unknowns)."""
from __future__ import annotations

import torch

__all__ = ["newton"]


def newton(F, x0: torch.Tensor, atol: float, maxit: int = 30):
    """Solve ``F(x) = 0`` from ``x0`` until ``‖F(x)‖ ≤ atol``; the Jacobian
    by forward-mode autograd, each step the least-squares step of least norm
    (the equal-order discretisations' Jacobians are singular in a pressure
    mode, so an LU step would grow without bound along it)."""
    x = x0.clone()
    for _ in range(maxit):
        r = F(x)
        if float(torch.linalg.vector_norm(r)) <= atol:
            return x
        J = torch.func.jacfwd(F)(x)
        x = x - torch.linalg.lstsq(J.cpu(), r.cpu()[:, None], rcond=1e-13,
                                   driver="gelsd").solution[:, 0].to(x)
    raise RuntimeError(f"reference Newton: no convergence in {maxit} steps "
                       f"(residual {float(torch.linalg.vector_norm(F(x)))}, "
                       f"target {atol})")
