"""GP estimation primitives shared by the model and inference layers.

Reference semantics (`1D Codes and Designs/1D Combined GP Public.R:397-444`):

    beta_hat   = 1'R^{-1}y / 1'R^{-1}1          (GLS intercept, `beta.MLE`)
    sigma2_hat = (y-b1)'R^{-1}(y-b1)/n          (`sigma2.MLE`)
    profile NLL = log det R + n log sigma2_hat  (`log.like`/`log.likeli`)

All via one Cholesky factor; batched over leading dims.
"""
from __future__ import annotations

import jax.numpy as jnp

from ccgp_tpu.ops import linalg


def gls_beta(chol: jnp.ndarray, y: jnp.ndarray):
    """GLS intercept via whitened regressors: beta = <u, a>/<u, u> where
    u = L^{-1}1, a = L^{-1}y."""
    ones = jnp.ones_like(y)
    u = linalg.tri_solve(chol, ones)
    a = linalg.tri_solve(chol, y)
    return jnp.sum(u * a, axis=-1) / jnp.sum(u * u, axis=-1)


def sigma2_mle(chol: jnp.ndarray, y: jnp.ndarray, beta) -> jnp.ndarray:
    """(y - beta 1)' R^{-1} (y - beta 1) / n."""
    n = y.shape[-1]
    w = linalg.tri_solve(chol, y - beta[..., None])
    return jnp.sum(w * w, axis=-1) / n


def profile_nll(chol: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """log det R + n log sigma2_hat — minimized for ordinary-kriging MLEs."""
    n = y.shape[-1]
    beta = gls_beta(chol, y)
    s2 = sigma2_mle(chol, y, beta)
    return linalg.chol_logdet(chol) + n * jnp.log(s2)


def chol_quadratics(grams: jnp.ndarray, y: jnp.ndarray,
                    jitter: float = 0.0) -> dict:
    """Batched {logdet, y'R^-1 y, 1'R^-1 y, 1'R^-1 1} of Grams (B, n, n)
    with absolute diagonal `jitter`, from ONE bordered factorization per
    matrix (`linalg.bordered_cholesky_quadratics`: the border rows of the
    factor are L^{-1}[y, 1], so no triangular solves). Non-PSD inputs give
    NaN, the framework's rejection signal."""
    n = grams.shape[-1]
    if jitter:
        grams = grams + jitter * jnp.eye(n, dtype=grams.dtype)
    q = linalg.bordered_cholesky_quadratics(grams, y, jitter=0.0)
    return {k: q[k] for k in ("logdet", "qyy", "qoy", "qoo")}


def profile_nll_from_quadratics(q: dict, n: int) -> jnp.ndarray:
    """log det R + n log sigma2_hat from the quadratic summary."""
    beta = q["qoy"] / q["qoo"]
    n_sigma2 = q["qyy"] - beta * q["qoy"]
    return q["logdet"] + n * jnp.log(n_sigma2 / n)


def mvn_nll_from_quadratics(q: dict, n: int, log_scale) -> jnp.ndarray:
    """-2 log N(y; beta_hat 1, e^{log_scale} R) + const, per batch element:
    the transformed-posterior likelihood core (beta profiled)."""
    beta = q["qoy"] / q["qoo"]
    quad = (q["qyy"] - beta * q["qoy"]) * jnp.exp(-log_scale)
    return q["logdet"] + n * log_scale + quad
