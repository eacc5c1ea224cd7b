"""Linear algebra ops — counterpart of ``paddle_tpu/ops/linalg.py``
(the ``paddle.linalg`` namespace).

Decompositions have sign and order freedom (``svd``, ``eigh``, ``eig``,
``qr``, ``lu``): hold them to other implementations by reconstruction
and by sorted eigen- or singular values, not factor by factor.
``cross(axis=9)`` means the first axis of size 3, as in Paddle.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import primitive, ensure_tensor


def _axis(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    axis = _axis(axis)
    dims = (tuple(range(x.ndim)) if axis is None else
            axis if isinstance(axis, tuple) else (axis,))

    if p == "fro" or (p == 2 and axis is None):
        def fn(a):
            return torch.sqrt(torch.sum(torch.square(a), dim=dims,
                                        keepdim=keepdim))
    elif p == float("inf"):
        def fn(a):
            return torch.amax(torch.abs(a), dim=dims, keepdim=keepdim)
    elif p == float("-inf"):
        def fn(a):
            return torch.amin(torch.abs(a), dim=dims, keepdim=keepdim)
    elif p == 0:
        def fn(a):
            return torch.sum((a != 0).to(a.dtype), dim=dims, keepdim=keepdim)
    elif p == 1:
        def fn(a):
            return torch.sum(torch.abs(a), dim=dims, keepdim=keepdim)
    else:
        pf = float(p)

        def fn(a):
            return torch.pow(torch.sum(torch.pow(torch.abs(a), pf),
                                       dim=dims, keepdim=keepdim), 1.0 / pf)
    return primitive(name="p_norm")(fn)(x)


def dist(x, y, p=2, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    d = primitive(name="dist_sub")(torch.sub)(x, y)
    return norm(d, p=p)


@primitive(name="cholesky")
def _cholesky(x, upper=False):
    L = torch.linalg.cholesky(x)
    return L.transpose(-1, -2) if upper else L


def cholesky(x, upper=False, name=None):
    return _cholesky(ensure_tensor(x), upper=upper)


@primitive(name="inverse")
def _inv(x):
    return torch.linalg.inv(x)


def inverse(x, name=None):
    return _inv(ensure_tensor(x))


inv = inverse


@primitive(name="matrix_power")
def _matrix_power(x, n=1):
    return torch.linalg.matrix_power(x, n)


def matrix_power(x, n, name=None):
    return _matrix_power(ensure_tensor(x), n=int(n))


def det(x, name=None):
    return primitive(name="determinant")(torch.linalg.det)(ensure_tensor(x))


def slogdet(x, name=None):
    return primitive(name="slogdet")(
        lambda a: torch.stack(list(torch.linalg.slogdet(a))))(
        ensure_tensor(x))


def svd(x, full_matrices=False, name=None):
    """x = U @ diag(S) @ VH (the third output is VH, not V)."""
    return primitive(name="svd")(
        lambda a: tuple(torch.linalg.svd(a, full_matrices=full_matrices)))(
        ensure_tensor(x))


def qr(x, mode="reduced", name=None):
    return primitive(name="qr")(
        lambda a: tuple(torch.linalg.qr(a, mode=mode)))(ensure_tensor(x))


def _sym(a):
    return (a + a.transpose(-1, -2).conj()) / 2


def eigh(x, UPLO="L", name=None):
    return primitive(name="eigh")(
        lambda a: tuple(torch.linalg.eigh(_sym(a), UPLO=UPLO)))(
        ensure_tensor(x))


def eigvalsh(x, UPLO="L", name=None):
    return primitive(name="eigvalsh")(
        lambda a: torch.linalg.eigvalsh(_sym(a), UPLO=UPLO))(
        ensure_tensor(x))


@primitive(name="solve")
def _solve(a, b):
    return torch.linalg.solve(a, b)


def solve(x, y, name=None):
    return _solve(ensure_tensor(x), ensure_tensor(y))


@primitive(name="triangular_solve")
def _triangular_solve(a, b, upper=True, transpose=False,
                      unitriangular=False):
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return _triangular_solve(ensure_tensor(x), ensure_tensor(y), upper=upper,
                             transpose=transpose,
                             unitriangular=unitriangular)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    a = ensure_tensor(x)._data
    return Tensor._wrap(torch.linalg.matrix_rank(
        a, rtol=tol, hermitian=hermitian).to(torch.int64))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return primitive(name="pinv")(
        lambda a: torch.linalg.pinv(a, rtol=rcond, hermitian=hermitian))(
        ensure_tensor(x))


def cond(x, p=None, name=None):
    return primitive(name="cond")(
        lambda a: torch.linalg.cond(a, p))(ensure_tensor(x))


def multi_dot(tensors, name=None):
    ts = [ensure_tensor(t) for t in tensors]
    return primitive(name="multi_dot")(
        lambda *arrs: torch.linalg.multi_dot(list(arrs)))(*ts)


def cross(x, y, axis=9, name=None):
    x, y = ensure_tensor(x), ensure_tensor(y)
    if axis == 9:  # paddle default: the first axis of size 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return primitive(name="cross")(
        lambda a, b: torch.linalg.cross(a, b, dim=axis))(x, y)


def histogram(x, bins=100, min=0, max=0, name=None):
    """Counts of ``bins`` equal bins over ``[min, max]`` (the data's range
    when both are 0), computed on the host as the JAX package does."""
    x = ensure_tensor(x)
    arr = x.numpy()
    if min == 0 and max == 0:
        min, max = float(arr.min()), float(arr.max())
    hist, _ = np.histogram(arr, bins=bins, range=(min, max))
    return Tensor._wrap(torch.from_numpy(hist.astype(np.int64)).to(
        x._data.device))


def bincount(x, weights=None, minlength=0, name=None):
    a = ensure_tensor(x)._data
    w = ensure_tensor(weights)._data if weights is not None else None
    return Tensor._wrap(torch.bincount(a.reshape(-1), weights=w,
                                       minlength=int(minlength)))


def _lstsq_one(a, b, rcond):
    """``jnp.linalg.lstsq``'s SVD solution of one system: (x, residuals,
    rank, singular values)."""
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    if rcond is None:
        rcond = float(torch.finfo(a.dtype).eps) * builtins.max(m, n)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    sol = vt.transpose(-1, -2).conj() @ (s_inv * (u.transpose(-1, -2).conj()
                                                  @ b))
    resid = torch.linalg.vector_norm(b - a @ sol, dim=0) ** 2
    if vec:
        sol = sol.reshape(-1)
    return sol, resid, rank, s



def lstsq(x, y, rcond=None, driver=None, name=None):
    """paddle.linalg.lstsq — (solution, residuals, rank, singular values),
    computed from an SVD as ``jnp.linalg.lstsq`` computes them (torch's
    own ``lstsq`` on the card returns the solution only).  Batched
    ``(*, M, N)`` inputs solve each system; ``driver`` is ignored."""
    a, b = ensure_tensor(x)._data, ensure_tensor(y)._data
    if a.dim() == 2:
        return tuple(Tensor._wrap(t) for t in _lstsq_one(a, b, rcond))
    lead = a.shape[:-2]
    parts = [_lstsq_one(ai, bi, rcond) for ai, bi in
             zip(a.reshape(-1, *a.shape[-2:]),
                 b.reshape(-1, *b.shape[len(lead):]))]
    return tuple(Tensor._wrap(torch.stack([p[k] for p in parts]).reshape(
        *lead, *parts[0][k].shape)) for k in range(4))


def lu(x, pivot=True, get_infos=False, name=None):
    """paddle.linalg.lu — packed LU and 1-based pivots; ``infos`` flags
    the first zero pivot on the diagonal (0 when none)."""
    a = ensure_tensor(x)._data
    lu_mat, piv = torch.linalg.lu_factor(a)
    piv = piv.to(torch.int32)
    if get_infos:
        d = torch.diagonal(lu_mat, dim1=-2, dim2=-1)
        zero = d == 0
        first = torch.argmax(zero.to(torch.int32), dim=-1) + 1
        info = torch.where(zero.any(-1), first,
                           torch.zeros_like(first)).to(torch.int32)
        return Tensor._wrap(lu_mat), Tensor._wrap(piv), Tensor._wrap(info)
    return Tensor._wrap(lu_mat), Tensor._wrap(piv)


def eig(x, name=None):
    """paddle.linalg.eig — general eigendecomposition (complex)."""
    return primitive(name="eig")(
        lambda a: tuple(torch.linalg.eig(a)))(ensure_tensor(x))


def eigvals(x, name=None):
    return primitive(name="eigvals")(torch.linalg.eigvals)(ensure_tensor(x))


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
