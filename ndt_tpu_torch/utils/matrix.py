"""Dense matrix routines (the reference's public matrix.{h,c}).

Counterpart of ``ndt_tpu/utils/matrix.py``: multiply, transpose, the
partial-pivot Gaussian-elimination solve, Doolittle LU decompose and solve,
inverse and determinant (matrix.c:77-597), and the Givens rotation
vectNd_rotate builds (vectNd.c:233-239), with the reference's algorithms
over float64 torch tensors.  A tensor argument keeps its device; anything
else is placed on ``device``, the card unless the caller asks for the CPU.
The embedded self-tests (matrix_test_solve{,2,3}, matrix.c:398-528) run as
unit tests (tests/test_torch_f64.py).  The texture map's least-squares
projection (utils/texmap.py, map.c:51-61) is the solve's production
caller.
"""

from __future__ import annotations

import math

import torch

from ndt_tpu_torch.camera import render_device


def as_matrix(a, device="cuda"):
    """``a`` as a float64 tensor: a tensor on its own device, anything else
    on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64)
    return torch.as_tensor(a, dtype=torch.float64,
                           device=render_device(device))


def identity(n: int, device="cuda") -> torch.Tensor:
    return torch.eye(n, dtype=torch.float64, device=render_device(device))


def mult(a, b, device="cuda") -> torch.Tensor:
    """matrix_mult (matrix.c:98-118)."""
    a = as_matrix(a, device)
    b = as_matrix(b, a.device)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    return a @ b


def transpose(a, device="cuda") -> torch.Tensor:
    return as_matrix(a, device).T.clone()


def gauss_elim_solve(a, b, device="cuda") -> torch.Tensor:
    """Gaussian elimination with partial pivoting (matrix_gauss_elim,
    matrix.c:166-263): solves A x = b."""
    a = as_matrix(a, device).clone()
    b = as_matrix(b, a.device).reshape(-1).clone()
    n = a.shape[0]
    if a.shape[1] != n or b.shape[0] != n:
        raise ValueError("need square A and matching b")
    for col in range(n):
        pivot = col + int(torch.argmax(a[col:, col].abs()))
        if abs(float(a[pivot, col])) < 1e-300:
            raise torch.linalg.LinAlgError("singular matrix")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            b[[col, pivot]] = b[[pivot, col]]
        for row in range(col + 1, n):
            f = a[row, col] / a[col, col]
            a[row, col:] -= f * a[col, col:]
            b[row] -= f * b[col]
    x = torch.zeros(n, dtype=torch.float64, device=a.device)
    for row in range(n - 1, -1, -1):
        x[row] = (b[row] - a[row, row + 1:] @ x[row + 1:]) / a[row, row]
    return x


def lu_decompose(a, device="cuda"):
    """Doolittle LU without pivoting (matrix_lu_decompose,
    matrix.c:265-340): (L, U) with a unit-diagonal L."""
    a = as_matrix(a, device)
    n = a.shape[0]
    L = torch.eye(n, dtype=torch.float64, device=a.device)
    U = torch.zeros((n, n), dtype=torch.float64, device=a.device)
    for i in range(n):
        for j in range(i, n):
            U[i, j] = a[i, j] - L[i, :i] @ U[:i, j]
        for j in range(i + 1, n):
            L[j, i] = (a[j, i] - L[j, :i] @ U[:i, i]) / U[i, i]
    return L, U


def lu_solve(a, b, device="cuda") -> torch.Tensor:
    """matrix_lu_solve (matrix.c:342-377): forward and back
    substitution."""
    L, U = lu_decompose(a, device)
    b = as_matrix(b, L.device).reshape(-1)
    n = b.shape[0]
    y = torch.zeros(n, dtype=torch.float64, device=L.device)
    for i in range(n):
        y[i] = b[i] - L[i, :i] @ y[:i]
    x = torch.zeros(n, dtype=torch.float64, device=L.device)
    for i in range(n - 1, -1, -1):
        x[i] = (y[i] - U[i, i + 1:] @ x[i + 1:]) / U[i, i]
    return x


def invert(a, device="cuda") -> torch.Tensor:
    """matrix_invert (matrix.c:529-585): solves against the identity's
    columns."""
    a = as_matrix(a, device)
    eye = torch.eye(a.shape[0], dtype=torch.float64, device=a.device)
    return torch.stack([gauss_elim_solve(a, eye[:, k])
                        for k in range(a.shape[0])], dim=1)


def det(a, device="cuda") -> float:
    """matrix_det: the product of U's diagonal (matrix.c:587-597)."""
    _, U = lu_decompose(a, device)
    return float(torch.prod(torch.diagonal(U)))


def rotation(n: int, i: int, j: int, angle: float,
             device="cuda") -> torch.Tensor:
    """The Givens rotation vectNd_rotate builds (vectNd.c:233-239)."""
    m = identity(n, device)
    c, s = math.cos(angle), math.sin(angle)
    m[i, i] = c
    m[i, j] = -s
    m[j, i] = s
    m[j, j] = c
    return m
