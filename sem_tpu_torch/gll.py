"""Gauss-Legendre-Lobatto (GLL) nodal Lagrange basis — 1D building blocks.

Capability parity with the reference's polynomial-basis layer
(reference Solvers/GLL.py:7-116), re-implemented with vectorized closed-form
algorithms (Newton iteration on P'_P for the interior nodes, barycentric
Lagrange evaluation).  All constructors run host-side in float64 NumPy and
return small dense arrays from which the operator modules build their device
tensors.  The code is a copy of ``sem_tpu.gll``: importing that module would
import JAX, and the port's basis must be bit-identical to the reference's.

Definitions (standard element ξ ∈ [-1, 1], order ``P``, nodes ξ₀..ξ_P):

* mass matrix          Mˢᵢⱼ = ∫ ℓᵢ ℓⱼ dξ  = diag(w)       (GLL quadrature ⇒ diagonal)
* differentiation      Dˢᵢⱼ = ℓ'ⱼ(ξᵢ)
* gradient (weak)      Gˢᵢⱼ = ∫ ℓᵢ ℓ'ⱼ dξ = diag(w) · Dˢ
* stiffness            Kˢᵢⱼ = ∫ ℓ'ᵢ ℓ'ⱼ dξ = Dˢᵀ diag(w) Dˢ
* product 3-tensor     Fˢᵢⱼₖ = ∫ ℓᵢ ℓⱼ ℓₖ dξ  = wᵢ δᵢⱼ δᵢₖ
* convection 3-tensor  Cˢᵢⱼₖ = ∫ ℓᵢ ℓⱼ ℓ'ₖ dξ = wᵢ δᵢⱼ Dˢᵢₖ

The 3-tensors are never materialized anywhere in this framework (their
contractions collapse to elementwise products with ``D``-derivatives — see
``sem_tpu_torch.operators``); the constructors below exist for parity and testing.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

__all__ = [
    "legendre",
    "nodes_weights",
    "standard_nodes",
    "standard_mass_matrix",
    "standard_differentiation_matrix",
    "standard_gradient_matrix",
    "standard_stiffness_matrix",
    "standard_product_matrix",
    "standard_convection_matrix",
    "standard_evaluation_matrix",
    "Basis1D",
    "basis",
]


def legendre(n: int, x: np.ndarray):
    """Evaluate the Legendre polynomial P_n and its derivative at ``x``.

    Uses the three-term recurrence and the derivative identity
    (x²-1) P'_n = n (x P_n - P_{n-1}).  Vectorized over ``x``.

    :return: (P_n(x), P'_n(x))
    """
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.ones_like(x), np.zeros_like(x)
    p_prev = np.ones_like(x)
    p = x.copy()
    for k in range(2, n + 1):
        p_prev, p = p, ((2 * k - 1) * x * p - (k - 1) * p_prev) / k
    with np.errstate(divide="ignore", invalid="ignore"):
        dp = n * (x * p - p_prev) / (x * x - 1.0)
    # endpoints: P'_n(±1) = (±1)^{n-1} n(n+1)/2
    at_end = np.isclose(np.abs(x), 1.0)
    if np.any(at_end):
        sign = np.sign(x) ** (n - 1)
        dp = np.where(at_end, sign * n * (n + 1) / 2.0, dp)
    return p, dp


@functools.lru_cache(maxsize=None)
def _nodes_weights_cached(P: int):
    if P < 1:
        raise ValueError("polynomial order P must be >= 1")
    if P == 1:
        nodes = np.array([-1.0, 1.0])
        weights = np.array([1.0, 1.0])
        return nodes, weights
    # Interior GLL nodes are the roots of P'_P.  Newton iteration from the
    # Chebyshev-Lobatto points; the second derivative comes from the Legendre
    # ODE (1-x²)P'' = 2xP' - P(P+1)P.
    x = -np.cos(np.pi * np.arange(1, P) / P)
    for _ in range(200):
        p, dp = legendre(P, x)
        d2p = (2.0 * x * dp - P * (P + 1) * p) / (1.0 - x * x)
        step = dp / d2p
        x = x - step
        if np.max(np.abs(step)) <= np.finfo(np.float64).eps:
            break
    nodes = np.concatenate(([-1.0], x, [1.0]))
    pP = legendre(P, nodes)[0]
    weights = 2.0 / (P * (P + 1) * pP**2)
    nodes.setflags(write=False)
    weights.setflags(write=False)
    return nodes, weights


def nodes_weights(P: int):
    """GLL quadrature nodes ξᵢ ∈ [-1,1] and weights wᵢ (each shape ``(P+1,)``)."""
    return _nodes_weights_cached(P)


def standard_nodes(P: int):
    """Nodes, weights, and the Legendre Vandermonde Pⱼ(ξᵢ).

    Parity with reference GLL.py:7-33 (same return convention).
    """
    nodes, weights = nodes_weights(P)
    vandermonde = np.empty((P + 1, P + 1))
    for j in range(P + 1):
        vandermonde[:, j] = legendre(j, nodes)[0]
    return nodes, weights, vandermonde


def standard_mass_matrix(P: int):
    """Diagonal GLL mass matrix Mˢ = diag(w) (reference GLL.py:36-42)."""
    return np.diag(nodes_weights(P)[1])


@functools.lru_cache(maxsize=None)
def standard_differentiation_matrix(P: int):
    """Nodal differentiation matrix Dˢᵢⱼ = ℓ'ⱼ(ξᵢ) (reference GLL.py:45-59).

    Off-diagonal closed form Dᵢⱼ = (P_P(ξᵢ)/P_P(ξⱼ)) / (ξᵢ-ξⱼ); corner values
    ∓P(P+1)/4; interior diagonal zero.
    """
    nodes, _ = nodes_weights(P)
    pP = legendre(P, nodes)[0]
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)  # avoid 0/0; diagonal overwritten below
    D = (pP[:, None] / pP[None, :]) / diff
    np.fill_diagonal(D, 0.0)
    D[0, 0] = -P * (P + 1) / 4.0
    D[-1, -1] = P * (P + 1) / 4.0
    D.setflags(write=False)
    return D


def standard_gradient_matrix(P: int):
    """Weak 1st-derivative matrix Gˢ = diag(w) Dˢ (reference GLL.py:62-70)."""
    _, w = nodes_weights(P)
    return w[:, None] * standard_differentiation_matrix(P)


def standard_stiffness_matrix(P: int):
    """Stiffness Kˢ = Dˢᵀ diag(w) Dˢ (reference GLL.py:73-81)."""
    D = standard_differentiation_matrix(P)
    _, w = nodes_weights(P)
    return (D * w[:, None]).T @ D


def standard_product_matrix(P: int):
    """Super-diagonal product 3-tensor Fˢᵢⱼₖ = wᵢ δᵢⱼ δᵢₖ (reference GLL.py:84-91)."""
    _, w = nodes_weights(P)
    F = np.zeros((P + 1,) * 3)
    idx = np.arange(P + 1)
    F[idx, idx, idx] = w
    return F


def standard_convection_matrix(P: int):
    """Convection 3-tensor Cˢᵢⱼₖ = wᵢ δᵢⱼ Dˢᵢₖ (reference GLL.py:94-102)."""
    _, w = nodes_weights(P)
    D = standard_differentiation_matrix(P)
    C = np.zeros((P + 1,) * 3)
    idx = np.arange(P + 1)
    C[idx, idx, :] = w[:, None] * D
    return C


def standard_evaluation_matrix(P: int, xi: np.ndarray):
    """Lagrange evaluation matrix Sᵢⱼ = ℓⱼ(xi[i]) (reference GLL.py:105-116).

    Implemented with the (numerically superior) barycentric second form;
    query points that coincide with a node get an exact 0/1 row.
    """
    nodes, _ = nodes_weights(P)
    xi = np.atleast_1d(np.asarray(xi, dtype=np.float64))
    # barycentric weights b_j = 1 / prod_{k != j} (x_j - x_k)
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    b = 1.0 / np.prod(diff, axis=1)
    dist = xi[:, None] - nodes[None, :]
    exact = np.isclose(dist, 0.0, atol=1e-14)
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = b[None, :] / dist
    terms = np.where(exact, 0.0, terms)
    denom = np.sum(terms, axis=1, keepdims=True)
    S = terms / np.where(denom == 0.0, 1.0, denom)
    hit = exact.any(axis=1)
    S[hit] = exact[hit].astype(np.float64)
    return S


@dataclass(frozen=True)
class Basis1D:
    """Bundle of the 1D standard-element operators for polynomial order ``P``.

    All arrays are read-only float64 NumPy; the operator modules cast them to
    the field dtype when they build device tensors.
    """

    P: int
    nodes: np.ndarray       # (P+1,)   GLL nodes ξᵢ
    weights: np.ndarray     # (P+1,)   quadrature weights wᵢ
    D: np.ndarray           # (P+1,P+1) differentiation ℓ'ⱼ(ξᵢ)
    K: np.ndarray           # (P+1,P+1) stiffness ∫ℓ'ᵢℓ'ⱼ
    G: np.ndarray           # (P+1,P+1) weak gradient ∫ℓᵢℓ'ⱼ

    def __hash__(self):
        return hash(("Basis1D", self.P))

    def __eq__(self, other):
        return isinstance(other, Basis1D) and other.P == self.P


@functools.lru_cache(maxsize=None)
def basis(P: int) -> Basis1D:
    """Construct (and cache) the order-``P`` GLL basis bundle."""
    nodes, weights = nodes_weights(P)
    D = standard_differentiation_matrix(P)
    K = standard_stiffness_matrix(P)
    G = standard_gradient_matrix(P)
    for a in (K, G):
        a.setflags(write=False)
    return Basis1D(P=P, nodes=nodes, weights=weights, D=D, K=K, G=G)
