"""A plain spectral-element discretisation of the unit-aspect cavities.

Everything here is worked out from the configuration's numbers alone:

* the Gauss-Lobatto-Legendre (GLL) nodes and weights of order ``P`` (roots
  of P_P' from the Legendre series, polished by Newton's method) and the
  nodal differentiation matrix (barycentric form);
* a uniform ``N_ex × N_ey`` grid of square-tensor elements on
  ``[0, L_x] × [0, L_y]`` with C0 numbering in x-major order
  (``flat = ix·Ngy + iy``);
* the assembled operators, element by element: a field is cut into element
  blocks, each block takes its local operator, and the blocks are summed back
  into the global field with ``index_add``.

Local operators of an element of size ``hx × hy`` (``w`` the GLL weights,
``D`` the differentiation matrix, ``Kr = Dᵀ diag(w) D``, ``Gr = diag(w) D``):

* mass ``(hx/2)(hy/2) w_i w_j u_ij`` (lumped, diagonal);
* stiffness ``(hy/hx) Σ_k Kr_ik u_kj w_j + (hx/hy) w_i Σ_l Kr_jl u_il``;
* weak x-derivative ``(hy/2) w_j Σ_k Gr_ik u_kj`` (the 2/hx of d/dx cancels
  the hx/2 of the x integral), and the y one alike;
* convection ``u∘(Gx w) + v∘(Gy w)``, the nodal wind times the assembled
  weak derivatives.

All arithmetic is float64.  Nothing here imports the program under test.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from numpy.polynomial import legendre as npleg

__all__ = ["gll", "Grid", "make_grid", "eval_matrix"]

F64 = torch.float64


@functools.lru_cache(maxsize=None)
def gll(P: int):
    """(nodes, weights, D) of the order-``P`` GLL rule on [-1, 1]."""
    if P < 1:
        raise ValueError("P must be >= 1")
    cP = np.zeros(P + 1)
    cP[P] = 1.0
    dcP = npleg.legder(cP)
    x = np.sort(np.real(npleg.legroots(dcP))) if P > 1 else np.zeros(0)
    d2cP = npleg.legder(dcP)
    for _ in range(50):   # Newton on P_P'(x) = 0
        step = npleg.legval(x, dcP) / npleg.legval(x, d2cP)
        x = x - step
        if x.size == 0 or np.max(np.abs(step)) < 1e-16:
            break
    nodes = np.concatenate(([-1.0], x, [1.0]))
    weights = 2.0 / (P * (P + 1) * npleg.legval(nodes, cP) ** 2)
    # barycentric weights and differentiation matrix; the diagonal makes
    # every row of D sum to zero (D·1 = 0)
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    lam = 1.0 / np.prod(diff, axis=1)
    D = (lam[None, :] / lam[:, None]) / diff
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(D, -D.sum(axis=1))
    return nodes, weights, D


def _lagrange_rows(nodes: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """Values of the ``len(nodes)`` Lagrange polynomials at ``xi``
    (``(len(xi), len(nodes))``), by the barycentric formula; exact 0/1 rows
    where a point is a node."""
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    lam = 1.0 / np.prod(diff, axis=1)
    d = xi[:, None] - nodes[None, :]
    hit = np.isclose(d, 0.0, rtol=0.0, atol=1e-15)
    d = np.where(hit, 1.0, d)
    t = lam[None, :] / d
    rows = t / t.sum(axis=1, keepdims=True)
    on = hit.any(axis=1)
    rows[on] = hit[on].astype(float)
    return rows


def eval_matrix(P: int, N_e: int, L: float, xq) -> np.ndarray:
    """``(len(xq), N_e·P+1)``: row ``a`` evaluates a 1D C0 spectral-element
    field of order ``P`` on ``N_e`` uniform elements of ``[0, L]`` at
    ``xq[a]``."""
    xq = np.asarray(xq, dtype=np.float64)
    h = L / N_e
    nodes = gll(P)[0]
    e = np.clip(np.floor(xq / h).astype(int), 0, N_e - 1)
    xi = np.clip(2.0 * (xq - e * h) / h - 1.0, -1.0, 1.0)
    rows = _lagrange_rows(nodes, xi)
    E = np.zeros((xq.size, N_e * P + 1))
    for a in range(xq.size):
        E[a, e[a] * P:e[a] * P + P + 1] = rows[a]
    return E


class Grid:
    """Uniform C0 spectral-element grid; fields are ``(Ngx, Ngy)`` float64
    tensors on ``device``."""

    def __init__(self, P: int, N_ex: int, N_ey: int, L_x: float = 1.0,
                 L_y: float = 1.0, device="cpu"):
        self.P, self.N_ex, self.N_ey = int(P), int(N_ex), int(N_ey)
        self.L_x, self.L_y = float(L_x), float(L_y)
        self.hx, self.hy = self.L_x / self.N_ex, self.L_y / self.N_ey
        self.Ngx, self.Ngy = self.N_ex * P + 1, self.N_ey * P + 1
        self.N = self.Ngx * self.Ngy
        self.device = torch.device(device)
        nodes, w, D = gll(P)
        self.x = np.concatenate([e * self.hx + self.hx / 2 * (nodes[:-1] + 1)
                                 for e in range(self.N_ex)] + [[self.L_x]])
        self.y = np.concatenate([e * self.hy + self.hy / 2 * (nodes[:-1] + 1)
                                 for e in range(self.N_ey)] + [[self.L_y]])
        t = functools.partial(torch.as_tensor, dtype=F64, device=self.device)
        self.w = t(w)
        self.Kr = t(D.T @ np.diag(w) @ D)
        self.Gr = t(np.diag(w) @ D)
        ex = np.arange(self.N_ex)[:, None, None, None]
        ey = np.arange(self.N_ey)[None, :, None, None]
        i = np.arange(P + 1)[None, None, :, None]
        j = np.arange(P + 1)[None, None, None, :]
        self._idx = torch.as_tensor(((ex * P + i) * self.Ngy
                                     + ey * P + j).reshape(-1),
                                    device=self.device)
        self._transfer = {}

    # element blocks and their assembly
    def blocks(self, U: torch.Tensor) -> torch.Tensor:
        """``(N_ex, N_ey, P+1, P+1)`` view of the element blocks of ``U``."""
        P = self.P
        return U.unfold(0, P + 1, P).unfold(1, P + 1, P)

    def assemble(self, E: torch.Tensor) -> torch.Tensor:
        """Sum element blocks into a global ``(Ngx, Ngy)`` field."""
        out = torch.zeros(self.N, dtype=E.dtype, device=E.device)
        return out.index_add(0, self._idx, E.reshape(-1)).reshape(
            self.Ngx, self.Ngy)

    # assembled operators on (Ngx, Ngy) fields
    def mass(self, U):
        w = self.w
        return self.assemble(self.hx * self.hy / 4 * w[:, None] * w[None, :]
                             * self.blocks(U))

    def stiffness(self, U):
        E, w, Kr = self.blocks(U), self.w, self.Kr
        ax = torch.einsum("ik,abkj->abij", Kr, E) * w[None, :]
        ay = torch.einsum("jl,abil->abij", Kr, E) * w[:, None]
        return self.assemble(self.hy / self.hx * ax + self.hx / self.hy * ay)

    def grad_x(self, U):
        gx = torch.einsum("ik,abkj->abij", self.Gr, self.blocks(U))
        return self.assemble(self.hy / 2 * self.w[None, :] * gx)

    def grad_y(self, U):
        gy = torch.einsum("jl,abil->abij", self.Gr, self.blocks(U))
        return self.assemble(self.hx / 2 * self.w[:, None] * gy)

    def convection(self, U, V, W):
        return U * self.grad_x(W) + V * self.grad_y(W)

    # masks and point evaluation
    def side(self, name: str) -> torch.Tensor:
        """Bool ``(Ngx, Ngy)`` mask of the nodes on side W, E, S or N."""
        m = torch.zeros(self.Ngx, self.Ngy, dtype=torch.bool,
                        device=self.device)
        sl = {"W": (0, slice(None)), "E": (-1, slice(None)),
              "S": (slice(None), 0), "N": (slice(None), -1)}[name]
        m[sl] = True
        return m

    def transfer_to(self, dst: "Grid", U: torch.Tensor) -> torch.Tensor:
        """``U`` interpolated at the nodes of ``dst``."""
        key = (dst.P, dst.N_ex, dst.N_ey, U.device)
        if key not in self._transfer:
            self._transfer[key] = tuple(
                torch.as_tensor(eval_matrix(self.P, n, L, xq), dtype=F64,
                                device=U.device)
                for n, L, xq in ((self.N_ex, self.L_x, dst.x),
                                 (self.N_ey, self.L_y, dst.y)))
        Ex, Ey = self._transfer[key]
        return Ex @ U @ Ey.T

    def evaluate(self, U: torch.Tensor, xq, yq) -> np.ndarray:
        """``U`` at the tensor-product points ``xq ⊗ yq``."""
        Ex = torch.as_tensor(eval_matrix(self.P, self.N_ex, self.L_x, xq),
                             dtype=F64, device=U.device)
        Ey = torch.as_tensor(eval_matrix(self.P, self.N_ey, self.L_y, yq),
                             dtype=F64, device=U.device)
        return (Ex @ U @ Ey.T).cpu().numpy()


@functools.lru_cache(maxsize=8)
def make_grid(P: int, N_ex: int, N_ey: int, L_x: float, L_y: float,
              device: str) -> Grid:
    """A :class:`Grid`, made once per configuration and device."""
    return Grid(P, N_ex, N_ey, L_x, L_y, device=device)
