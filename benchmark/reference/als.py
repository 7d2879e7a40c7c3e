"""Plain ALS-WR, as the configuration states it, from the raw ratings.

Each half-step solves every user (or item) ``u`` from the opposing
factors ``Y``: ``(sum_i y_i y_i^T + reg n_u I) x_u = sum_i r_ui y_i``
over the ratings of ``u`` (``n_u`` of them), by ``cg_iters`` steps of
Jacobi-preconditioned conjugate gradient warm-started from the previous
``x_u``; a user with no rating gets zeros. The Gramians and the rhs are
two sparse-times-dense products over the rating matrix (CSR): ``M @
(Y (x) Y)`` and ``R @ Y``, with ``Y`` rounded to the configuration's
compute precision and the sums in float32; the CG's matvec reads ``A``
and its vector rounded to the configured CG precision, the recurrences
float32. Nothing here depends on the program's layout or state.

``check`` judges a training's factors by two numbers:

- ``loss_gap``: the ALS-WR objective of the judged factors against the
  objective of this reference's own training over the same ratings from
  the same initial factors, ``|L - L_ref| / L_ref``;
- ``row_err``: the judged item factors against the exact solve of the
  item half-step from the judged user factors (float64, the last
  half-step a training makes), worst item, each measured against the
  larger of its own exact row's norm and the median row's.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark.reference.rounding import exact_matmuls, rounder


@dataclasses.dataclass
class Side:
    """One orientation of the ratings: rows are the solved entities."""

    mask: torch.Tensor      # CSR [rows, cols], 1 per rating
    vals: torch.Tensor      # CSR [rows, cols], the ratings
    counts: torch.Tensor    # [rows] ratings of each row


def _side(rows, cols, vals, n_rows, n_cols, dtype) -> Side:
    order = torch.argsort(rows * n_cols + cols)
    cols_s = cols[order]
    counts = torch.bincount(rows, minlength=n_rows)
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(counts, 0)
    v = vals[order].to(dtype)
    with warnings.catch_warnings():
        # CSR is beta in torch and says so once a process
        warnings.simplefilter("ignore", UserWarning)
        return Side(
            mask=torch.sparse_csr_tensor(crow, cols_s, torch.ones_like(v),
                                         size=(n_rows, n_cols)),
            vals=torch.sparse_csr_tensor(crow, cols_s, v,
                                         size=(n_rows, n_cols)),
            counts=counts)


class Ratings:
    """The training ratings on ``device``, in both orientations."""

    def __init__(self, users: np.ndarray, items: np.ndarray,
                 vals: np.ndarray, n_users: int, n_items: int, device,
                 dtype=torch.float32):
        self.n_users, self.n_items = int(n_users), int(n_items)
        self.u = torch.as_tensor(users, dtype=torch.int64, device=device)
        self.i = torch.as_tensor(items, dtype=torch.int64, device=device)
        self.r = torch.as_tensor(vals, dtype=torch.float32, device=device)
        self.by_user = _side(self.u, self.i, self.r, self.n_users,
                             self.n_items, dtype)
        self.by_item = _side(self.i, self.u, self.r, self.n_items,
                             self.n_users, dtype)


def normal_equations(side: Side, Y: torch.Tensor, reg: float,
                     rnd: Callable) -> tuple:
    """``(A, b)`` of every row of ``side``: the Gramian of its ratings'
    opposing rows (rounded by ``rnd``) plus ``reg n I``, and the rhs."""
    n, K = side.counts.shape[0], Y.shape[1]
    Yr = rnd(Y)
    Z = (Yr[:, :, None] * Yr[:, None, :]).reshape(Yr.shape[0], K * K)
    A = (side.mask @ Z).reshape(n, K, K)
    del Z
    b = side.vals @ Yr
    shift = reg * side.counts.clamp_min(1).to(A.dtype)
    A += shift[:, None, None] * torch.eye(K, dtype=A.dtype, device=A.device)
    return A, b


def cg(A, b, x0, iters: int, rnd: Callable) -> torch.Tensor:
    """Jacobi-preconditioned CG, ``iters`` steps from ``x0``."""
    Am = rnd(A)

    def mv(v):
        return torch.bmm(Am, rnd(v).unsqueeze(-1)).squeeze(-1)

    Minv = 1.0 / (torch.diagonal(A, dim1=-2, dim2=-1) + 1e-20)
    x = x0
    r = b - mv(x0)
    z = Minv * r
    p = z
    rs = (r * z).sum(-1)
    for _ in range(iters):
        Ap = mv(p)
        alpha = rs / ((p * Ap).sum(-1) + 1e-20)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = Minv * r
        rs1 = (r * z).sum(-1)
        p = z + (rs1 / (rs + 1e-20))[:, None] * p
        rs = rs1
    return x


def half_step(side: Side, Y, X_prev, model: dict, gather: Callable,
              matvec: Callable) -> torch.Tensor:
    A, b = normal_equations(side, Y, float(model["reg"]), gather)
    x = cg(A, b, X_prev, int(model["cg_iters"]), matvec)
    return torch.where((side.counts > 0)[:, None], x, 0.0)


def train(ratings: Ratings, X0, Y0, model: dict,
          precision: Optional[str] = None) -> tuple:
    """``model["iterations"]`` alternations from ``(X0, Y0)``; the gather
    in ``precision`` (default the configured ``compute_dtype``) and the
    CG matvec in the configured ``cg_dtype`` (or ``precision`` where
    given: the control rounds both)."""
    exact_matmuls()
    gather = rounder(precision or model["compute_dtype"])
    matvec = rounder(precision or model["cg_dtype"])
    X, Y = X0.float().clone(), Y0.float().clone()
    for _ in range(int(model["iterations"])):
        X = half_step(ratings.by_user, Y, X, model, gather, matvec)
        Y = half_step(ratings.by_item, X, Y, model, gather, matvec)
    return X, Y


def objective(ratings: Ratings, X, Y, reg: float,
              chunk: int = 1 << 22) -> float:
    """The ALS-WR objective in float64: squared error over the ratings
    plus ``reg`` times each row's rating count times its squared norm."""
    X, Y = X.double(), Y.double()
    total = torch.zeros((), dtype=torch.float64, device=X.device)
    for s in range(0, ratings.u.shape[0], chunk):
        u, i = ratings.u[s:s + chunk], ratings.i[s:s + chunk]
        pred = (X[u] * Y[i]).sum(-1)
        total += ((ratings.r[s:s + chunk].double() - pred) ** 2).sum()
    total += reg * (ratings.by_user.counts.double() * (X * X).sum(-1)).sum()
    total += reg * (ratings.by_item.counts.double() * (Y * Y).sum(-1)).sum()
    return float(total)


def row_err(ratings: Ratings, X, Y, model: dict) -> float:
    """Worst item: the judged ``Y`` against the exact float64 solve of
    the item half-step from the judged ``X`` (rounded to the configured
    compute precision, as the half-step reads it)."""
    side64 = _side(ratings.i, ratings.u, ratings.r, ratings.n_items,
                   ratings.n_users, torch.float64)
    Xr = rounder(model["compute_dtype"])(X.float()).double()
    A, b = normal_equations(side64, Xr, float(model["reg"]), lambda t: t)
    exact = torch.linalg.solve(A, b)
    del A
    seen = side64.counts > 0
    err = torch.linalg.norm(Y.double() - exact, dim=-1)[seen]
    norm = torch.linalg.norm(exact, dim=-1)[seen]
    if not len(norm):
        return 0.0
    return float((err / torch.clamp(norm, min=float(norm.median()))).max())


def check(ratings: Ratings, X0, Y0, X, Y, model: dict,
          ref: Optional[tuple] = None) -> Dict[str, float]:
    """The two numbers for the judged factors ``(X, Y)`` (tensors on the
    ratings' device); ``ref``, this reference's own factors when already
    trained."""
    if ref is None:
        ref = train(ratings, X0, Y0, model)
    reg = float(model["reg"])
    l_ref = objective(ratings, *ref, reg)
    l_got = objective(ratings, X, Y, reg)
    return {"loss_gap": abs(l_got - l_ref) / l_ref,
            "row_err": row_err(ratings, X, Y, model)}
