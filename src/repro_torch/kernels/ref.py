"""PyTorch reference oracles for the six BLAS L3 subroutines (the reference
package's ``kernels/ref.py``, same semantics, paper Table I):

  gemm : C := alpha*A@B + beta*C                      A(m,k) B(k,n) C(m,n)
  symm : C := alpha*sym(A)@B + beta*C  (left, lower)  A(m,m) B(m,n) C(m,n)
  syrk : C := alpha*A@A^T + beta*C     (lower)        A(n,k) C(n,n)
  syr2k: C := alpha*(A@B^T + B@A^T) + beta*C (lower)  A,B(n,k) C(n,n)
  trmm : B := alpha*tril(A)@B          (left, lower, non-unit)  A(m,m) B(m,n)
  trsm : solve tril(A)@X = alpha*B     (left, lower, non-unit)

Symmetric operands are stored in the lower triangle; syrk/syr2k return the
full symmetric matrix.  All broadcast over a leading batch axis.
"""

from __future__ import annotations

import torch

__all__ = ["gemm", "symm", "syrk", "syr2k", "trmm", "trsm", "REFS"]


def _sym_lower(a):
    return torch.tril(a) + torch.tril(a, -1).transpose(-1, -2)


def gemm(a, b, c=None, *, alpha=1.0, beta=0.0):
    out = alpha * (a @ b)
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out.to(a.dtype)


def symm(a, b, c=None, *, alpha=1.0, beta=0.0):
    out = alpha * (_sym_lower(a) @ b)
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out.to(a.dtype)


def syrk(a, c=None, *, alpha=1.0, beta=0.0):
    out = alpha * (a @ a.transpose(-1, -2))
    if c is not None and beta != 0.0:
        out = out + beta * _sym_lower(c)
    return out.to(a.dtype)


def syr2k(a, b, c=None, *, alpha=1.0, beta=0.0):
    out = alpha * (a @ b.transpose(-1, -2) + b @ a.transpose(-1, -2))
    if c is not None and beta != 0.0:
        out = out + beta * _sym_lower(c)
    return out.to(a.dtype)


def trmm(a, b, *, alpha=1.0):
    return (alpha * (torch.tril(a) @ b)).to(a.dtype)


def trsm(a, b, *, alpha=1.0):
    x = torch.linalg.solve_triangular(torch.tril(a), alpha * b, upper=False,
                                      left=True)
    return x.to(a.dtype)


REFS = {"gemm": gemm, "symm": symm, "syrk": syrk, "syr2k": syr2k,
        "trmm": trmm, "trsm": trsm}
