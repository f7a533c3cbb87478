"""PyTorch reference oracles for the six BLAS L3 subroutines (the reference
package's ``kernels/ref.py``, same semantics, paper Table I):

  gemm : C := alpha*A@B + beta*C                      A(m,k) B(k,n) C(m,n)
  symm : C := alpha*sym(A)@B + beta*C  (left, lower)  A(m,m) B(m,n) C(m,n)
  syrk : C := alpha*A@A^T + beta*C     (lower)        A(n,k) C(n,n)
  syr2k: C := alpha*(A@B^T + B@A^T) + beta*C (lower)  A,B(n,k) C(n,n)
  trmm : B := alpha*tril(A)@B          (left, lower, non-unit)  A(m,m) B(m,n)
  trsm : solve tril(A)@X = alpha*B     (left, lower, non-unit)

Symmetric operands are stored in the lower triangle; syrk/syr2k return the
full symmetric matrix.  syrk/syr2k read C as lower-stored (BLAS, and the
reference's Pallas ``tri``/``tri_packed``) unless ``variant="full"`` asks
for C as given, both triangles, as the reference's Pallas ``full`` adds
it.  All broadcast over a leading batch axis.
"""

from __future__ import annotations

import torch

__all__ = ["gemm", "symm", "syrk", "syr2k", "trmm", "trsm", "sym_lower",
           "REFS"]


def sym_lower(a: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix whose lower triangle ``a`` stores: each element
    taken from where it is stored, by selection (no arithmetic)."""
    lower = torch.ones(a.shape[-2:], dtype=torch.bool,
                       device=a.device).tril_()
    return torch.where(lower, a, a.mT)


def gemm(a, b, c=None, *, alpha=1.0, beta=0.0):
    out = alpha * (a @ b)
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out.to(a.dtype)


def symm(a, b, c=None, *, alpha=1.0, beta=0.0):
    out = alpha * (sym_lower(a) @ b)
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out.to(a.dtype)


def _rank_k_c(c, variant):
    return c if variant == "full" else sym_lower(c)


def syrk(a, c=None, *, alpha=1.0, beta=0.0, variant="tri"):
    out = alpha * (a @ a.transpose(-1, -2))
    if c is not None and beta != 0.0:
        out = out + beta * _rank_k_c(c, variant)
    return out.to(a.dtype)


def syr2k(a, b, c=None, *, alpha=1.0, beta=0.0, variant="tri"):
    out = alpha * (a @ b.transpose(-1, -2) + b @ a.transpose(-1, -2))
    if c is not None and beta != 0.0:
        out = out + beta * _rank_k_c(c, variant)
    return out.to(a.dtype)


def trmm(a, b, *, alpha=1.0):
    return (alpha * (torch.tril(a) @ b)).to(a.dtype)


def trsm(a, b, *, alpha=1.0):
    x = torch.linalg.solve_triangular(torch.tril(a), alpha * b, upper=False,
                                      left=True)
    return x.to(a.dtype)


REFS = {"gemm": gemm, "symm": symm, "syrk": syrk, "syr2k": syr2k,
        "trmm": trmm, "trsm": trsm}
