"""Pairwise-distance primitives.

Squared distances are built from the rank-1 expansion
``|a|^2 + |b|^2 - 2 a.b`` so the O(n^2 d) work is one matmul
(the same expansion the reference uses in plain R at
`2D Codes and Designs/2D Combined GP Isotropic Public.R:350-360`).

All functions broadcast over leading batch dimensions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# The inner product MUST run at full float32 precision: reduced-precision
# matmul passes (bf16 or TF32) introduce ~1e-3..1e-2 absolute error in
# squared distances, which destroys the PSD structure of ill-conditioned SE
# Grams (Cholesky failures on a 100-point maximin design). Negligible cost
# at GP sizes, mandatory for correctness.
_PREC = jax.lax.Precision.HIGHEST


def _weighted(x: jnp.ndarray, theta) -> jnp.ndarray:
    """Scale coordinates by sqrt(theta) per axis (theta scalar or (d,))."""
    theta = jnp.asarray(theta, dtype=x.dtype)
    return x * jnp.sqrt(theta)


def pairwise_sqdist(x: jnp.ndarray, theta=1.0) -> jnp.ndarray:
    """Weighted squared distances D_ij = sum_k theta_k (x_ik - x_jk)^2.

    x: (..., n, d); theta: scalar or (d,). Returns (..., n, n) >= 0.
    """
    xw = _weighted(x, theta)
    sq = jnp.sum(xw * xw, axis=-1)
    inner = jnp.einsum("...nd,...md->...nm", xw, xw, precision=_PREC)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * inner
    return jnp.maximum(d2, 0.0)


def cross_sqdist(x: jnp.ndarray, y: jnp.ndarray, theta=1.0) -> jnp.ndarray:
    """Weighted squared distances between two point sets.

    x: (..., n, d), y: (..., m, d) -> (..., n, m).
    """
    xw = _weighted(x, theta)
    yw = _weighted(y, theta)
    sqx = jnp.sum(xw * xw, axis=-1)
    sqy = jnp.sum(yw * yw, axis=-1)
    inner = jnp.einsum("...nd,...md->...nm", xw, yw, precision=_PREC)
    d2 = sqx[..., :, None] + sqy[..., None, :] - 2.0 * inner
    return jnp.maximum(d2, 0.0)


def pairwise_absdiff(x: jnp.ndarray) -> jnp.ndarray:
    """|x_i - x_j| for 1-D inputs x: (..., n) -> (..., n, n).

    Used by the stationary 1-D kernels (Matern, cubic spline); the reference
    builds the same matrix at `1D Codes and Designs/1D Combined GP
    Public.R:368-374`.
    """
    return jnp.abs(x[..., :, None] - x[..., None, :])


def cross_absdiff(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """|x_i - y_j| for 1-D inputs: (..., n), (..., m) -> (..., n, m)."""
    return jnp.abs(x[..., :, None] - y[..., None, :])
