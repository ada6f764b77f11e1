"""Cholesky-centric linear algebra for GP covariance matrices.

The reference relies on explicit `solve(R)` / `det(R, tol=1e-16)` everywhere
(e.g. `1D Codes and Designs/1D Combined GP Public.R:424-444,622`). This design
never forms R^{-1}: every quadratic form and log-determinant goes
through one Cholesky factorization plus triangular solves, which XLA compiles
to batched library calls. Singularity handling replaces the
reference's `try(solve(R))` retry loops (`1D...Public.R:457-466,687-693`)
with a jitter ladder + NaN propagation: a non-finite result marks the
proposal/start as invalid, which downstream code treats as "reject/retry"
without host-side exceptions.

All functions broadcast over leading batch dimensions (vmap-compatible).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


def jitter_cholesky(a: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Cholesky of a PSD matrix with optional diagonal jitter.

    Returns the lower factor L with NaNs where factorization failed;
    callers detect failure via `jnp.isfinite`. `jitter` is relative to the
    mean diagonal, so correlation matrices (unit diagonal) get `jitter`
    added directly. Accepts a traced scalar (e.g. CombinedGPFit.jitter
    inside a jitted lazy-predict program): only a STATIC Python zero
    skips the add — a traced value always takes the add path (adding a
    concrete 0.0 * scale * I is a bitwise no-op on normal diagonals).
    """
    if not (isinstance(jitter, (int, float)) and jitter == 0.0):
        n = a.shape[-1]
        scale = jnp.mean(jnp.diagonal(a, axis1=-2, axis2=-1), axis=-1)
        a = a + (jitter * scale)[..., None, None] * jnp.eye(n, dtype=a.dtype)
    return jnp.linalg.cholesky(a)


def bordered_cholesky_quadratics(a: jnp.ndarray, y: jnp.ndarray,
                                 jitter: float = 0.0) -> dict:
    """One factorization -> factor + every GP sufficient statistic.

    Factors the bordered matrix  M = [[A, B], [B', c I]]  with B = [y, 1]:
    its lower Cholesky is [[L, 0], [W', S]] with L L' = A and W = L^{-1} B,
    so a SINGLE (n+2)-Cholesky yields the factor, logdet A, and the three
    quadratic forms  qyy = y'A^{-1}y, qoy = 1'A^{-1}y, qoo = 1'A^{-1}1  that
    every likelihood in the framework consumes (`ops/gp.py`) — with NO
    triangular solves. At GP sizes a batched triangular solve is as
    latency-bound as the factorization itself, so this halves the
    sequential-depth cost of each log-posterior evaluation (the Metropolis
    hot loop, Laplace mode searches, grid scans).

    The quadratics are read off the border ROWS of the factor (exact
    forward substitution — no cancellation against c). c MUST make the
    whole bordered matrix PSD: on CPU a failed LAPACK potrf NaN-masks the
    ENTIRE factor (not just trailing columns), so an undersized c would
    silently reject VALID states. Guarantee: for PSD A,
    lambda_min(A + jitter*scale*I) >= jitter*scale, and
    lambda_max(W'W) <= tr(W'W) = qyy + qoo <= (|y|^2 + n) / lambda_min,
    so c = (|y|^2 + n) / (jitter*scale) keeps c I - W'W PSD. With
    jitter = 0 the floor is n*eps(dtype): matrices whose lambda_min sits
    below n*eps are at the dtype's noise floor and NaN out — the
    framework's documented rejection dataflow (a truly singular A NaNs
    the leading block regardless of c).

    a: (..., n, n) PSD; y: (n,) or broadcastable to a's batch. Returns a
    dict with 'chol' (..., n, n), 'logdet', 'qyy', 'qoy', 'qoo'.
    """
    n = a.shape[-1]
    dtype = a.dtype
    if jitter:
        scale = jnp.mean(jnp.diagonal(a, axis1=-2, axis2=-1), axis=-1)
        a = a + (jitter * scale)[..., None, None] * jnp.eye(n, dtype=dtype)
        lam = jitter * scale[..., None]                      # (..., 1)
    else:
        lam = n * float(jnp.finfo(dtype).eps)
    y = jnp.broadcast_to(y, a.shape[:-2] + (n,))
    ones = jnp.ones_like(y)
    b = jnp.stack([y, ones], axis=-1)                        # (..., n, 2)
    c = (jnp.sum(y * y, axis=-1, keepdims=True) + n) / lam   # (..., 1)
    d = c[..., None] * jnp.eye(2, dtype=dtype)               # (..., 2, 2)
    m = jnp.concatenate([
        jnp.concatenate([a, b], axis=-1),
        jnp.concatenate([jnp.swapaxes(b, -1, -2), d], axis=-1),
    ], axis=-2)
    lf = jnp.linalg.cholesky(m)
    chol = lf[..., :n, :n]
    wy = lf[..., n, :n]
    wo = lf[..., n + 1, :n]
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    return {
        "chol": chol,
        "logdet": logdet,
        "qyy": jnp.sum(wy * wy, axis=-1),
        "qoy": jnp.sum(wy * wo, axis=-1),
        "qoo": jnp.sum(wo * wo, axis=-1),
    }


def tri_solve(chol: jnp.ndarray, b: jnp.ndarray, lower: bool = True,
              trans: bool = False) -> jnp.ndarray:
    """Batched triangular solve; b may be (..., n) or (..., n, k)."""
    vec = b.ndim == chol.ndim - 1
    if vec:
        b = b[..., None]
    out = solve_triangular(chol, b, lower=lower, trans=1 if trans else 0)
    return out[..., 0] if vec else out


def chol_solve(chol: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b given lower Cholesky factor of A."""
    return tri_solve(chol, tri_solve(chol, b), trans=True)


def chol_logdet(chol: jnp.ndarray) -> jnp.ndarray:
    """log det A from its lower Cholesky factor."""
    return 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1
    )


def solve_psd(a: jnp.ndarray, b: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Solve A x = b for PSD A via Cholesky (replaces `solve(R)` paths)."""
    return chol_solve(jitter_cholesky(a, jitter), b)


def logdet_psd(a: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """log det A for PSD A via Cholesky (replaces `log(det(R, tol=1e-16))`)."""
    return chol_logdet(jitter_cholesky(a, jitter))


def schur_complement(r_new: jnp.ndarray, r_cross: jnp.ndarray,
                     chol_old: jnp.ndarray) -> jnp.ndarray:
    """Schur complement R_new - R_cross R_old^{-1} R_cross^T.

    `r_cross` is (m, n_old); `chol_old` the lower Cholesky of R_old.
    This is the conditional covariance of the new batch given the old one —
    the augmented-entropy criterion of the reference
    (`Batch Sequential ME Designs/Batch Sequential ME Design.R:866-878`)
    computed without ever forming R_old^{-1}.
    """
    w = tri_solve(chol_old, jnp.swapaxes(r_cross, -1, -2))  # (n_old, m)
    return r_new - jnp.einsum("...ki,...kj->...ij", w, w)


def augmented_logdet(r_new: jnp.ndarray, r_cross: jnp.ndarray,
                     chol_old: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Incremental log-det: log det([[R_old, Rx^T],[Rx, R_new]]) - log det R_old.

    Equals log det of the Schur complement; used for batch-sequential
    maximum-entropy scoring where log det R_old is a constant.
    """
    s = schur_complement(r_new, r_cross, chol_old)
    return logdet_psd(s, jitter)
