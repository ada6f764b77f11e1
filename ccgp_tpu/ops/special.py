"""Special functions missing from jax.scipy: inverse of the regularized
lower incomplete gamma (needed for inverse-gamma quantiles in the
empirical-Bayes hyperprior machinery, replacing `pscl::qigamma`)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammainc, gammaln, ndtri


def gammaincinv(a, q: jnp.ndarray, n_newton: int = 30) -> jnp.ndarray:
    """x such that P(a, x) = q, elementwise in q; a may be a Python float or
    a traced scalar/array (broadcast against q).

    Wilson–Hilferty initial guess + guarded Newton on the log scale
    (fixed trip count, branch-free — jit/vmap-safe). Accuracy ~1e-12
    relative in float64 over q in (1e-12, 1-1e-12).
    """
    q = jnp.asarray(q)
    dtype = q.dtype
    a = jnp.asarray(a, dtype)
    tiny = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)

    # Wilson-Hilferty: x ~ a (1 - 1/(9a) + z sqrt(1/(9a)))^3
    z = ndtri(jnp.clip(q, 1e-15, 1.0 - 1e-15))
    c = 1.0 / (9.0 * a)
    x0 = a * (1.0 - c + z * jnp.sqrt(c)) ** 3
    # fall back to the small-x expansion P(a,x) ~ x^a / Gamma(a+1) when the
    # WH cube goes nonpositive (q very small)
    log_small = (jnp.log(jnp.maximum(q, tiny)) + gammaln(a + 1.0)) / a
    x0 = jnp.where(x0 <= 0.0, jnp.exp(log_small), x0)
    t = jnp.log(jnp.maximum(x0, tiny))

    lg = gammaln(a)

    def body(_, t):
        x = jnp.exp(t)
        f = gammainc(a, x) - q
        # dP/dx = x^{a-1} e^{-x} / Gamma(a); d/dt with x = e^t adds a factor x
        deriv = jnp.exp(a * t - x - lg)
        step = jnp.clip(f / jnp.maximum(deriv, tiny), -4.0, 4.0)
        return t - step

    t = jax.lax.fori_loop(0, n_newton, body, t)
    return jnp.exp(t)


def invgamma_quantile(p: jnp.ndarray, a, b) -> jnp.ndarray:
    """qigamma: quantile of InverseGamma(a, b) (X = b / Gamma(a, 1)).

    P(X <= x) = Q(a, b/x) = 1 - P(a, b/x)  =>  x = b / gammaincinv(a, 1-p).
    """
    return jnp.asarray(b) / gammaincinv(a, 1.0 - jnp.asarray(p))
