"""Per-draw prediction factor cache.

The reference precomputes, for each retained posterior draw, the explicit
inverse R^{-1}, the vector R^{-1}(y - beta 1), the column sums of R^{-1} and
their total, then flattens all of it into a wide data frame
(`1D Codes and Designs/1D Combined GP Public.R:729-783`). Here the cache
is Cholesky-based and batched:

    L      (m, n, n)   lower Cholesky of R_mix per draw
    a      (m, n)      L^{-1}(y - beta 1)
    u      (m, n)      L^{-1} 1

from which every predictive quantity follows with one batched triangular
solve per test block:

    r' R^{-1} (y - beta 1) = (L^{-1} r) . a
    r' R^{-1} r            = ||L^{-1} r||^2
    1' R^{-1} r            = u . (L^{-1} r)
    1' R^{-1} 1            = ||u||^2

The whole cache is rebuilt in one vmapped pass over retained draws — one
batched factorization instead of storing and re-loading m * n^2 floats of
explicit inverses the way the reference's data-frame cache does.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ccgp_tpu.models.combination import MixtureSpec, MixParams, mixed_gram, unpack
from ccgp_tpu.ops import linalg


class FactorCache(NamedTuple):
    chol: jnp.ndarray    # (m, n, n)
    a: jnp.ndarray       # (m, n)  whitened centered data
    u: jnp.ndarray       # (m, n)  whitened ones
    beta: jnp.ndarray    # (m,)
    params: MixParams    # batched constrained parameters (leading dim m)


def build_factors(
    spec: MixtureSpec,
    x: jnp.ndarray,
    y: jnp.ndarray,
    zs: jnp.ndarray,
    betas: jnp.ndarray,
    jitter: float = 0.0,
) -> FactorCache:
    """zs: (m, n_params) retained unconstrained draws; betas: (m,)."""
    def one(z, beta):
        params, _ = unpack(spec, z)
        r = mixed_gram(spec, x, params)
        chol = linalg.jitter_cholesky(r, jitter)
        a = linalg.tri_solve(chol, y - beta)
        u = linalg.tri_solve(chol, jnp.ones_like(y))
        return chol, a, u, params

    chol, a, u, params = jax.vmap(one)(zs, betas)
    return FactorCache(chol=chol, a=a, u=u, beta=betas, params=params)
