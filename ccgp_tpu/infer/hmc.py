"""Hamiltonian Monte Carlo over the unconstrained posterior.

NEW CAPABILITY — no reference analogue: the reference's only sampler is
the Laplace-seeded random-walk Metropolis (`1D Codes and Designs/1D
Combined GP Public.R:657-719`), whose mixing per posterior evaluation is
bounded by the random-walk step. Because every log-posterior in this
framework is a pure differentiable JAX function (`models.likelihood.
make_logpost`), the exact gradient is one `jax.value_and_grad` away and
gradient-guided proposals come essentially for free — a capability R
could not express without hand-derived gradients through the Cholesky.

Design:

* **Laplace preconditioning.** The sampler runs in the whitened space
  u = C^{-1} z with C the Cholesky factor of a position-space covariance
  estimate (pass `LaplaceFit.cov` — the same matrix the Metropolis
  proposal uses). Momentum is standard normal in u, so a well-scaled
  step size is O(1) regardless of the posterior's conditioning.
* **Dual-averaging step-size adaptation** (Hoffman & Gelman 2014, §3.2)
  during `n_warmup` iterations targeting `target_accept`; the averaged
  step size is frozen for the sampling phase.
* **NaN-as-divergence.** Singular Grams at extreme parameters surface as
  NaN log-posteriors/gradients (the framework-wide dataflow, CLAUDE.md);
  a non-finite trajectory or a Hamiltonian error > `divergence_thresh`
  zeroes the acceptance probability — the standard divergent-transition
  rejection, branch-free.
* One `lax.scan` per phase; the whole sampler jits into a single
  program. Multi-chain = `vmap` over (start, key), same as `metropolis`.

Layering: takes a scalar `logpost_val` callable (like `infer.laplace`)
— this module must not import `models`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class HMCResult(NamedTuple):
    samples: jnp.ndarray      # (n_samples, dim) unconstrained draws
    logposts: jnp.ndarray     # (n_samples,)
    accept_rate: jnp.ndarray  # mean Metropolis acceptance prob, sampling
    step_size: jnp.ndarray    # adapted (whitened-space) step size
    n_divergent: jnp.ndarray  # divergent transitions in the sampling phase


def _leapfrog(vg: Callable, u, p, g, eps, n_steps: int):
    """n_steps leapfrog steps; returns (u, p, logpost(u), grad(u))."""

    def step(carry, _):
        u, p, g, _ = carry
        p = p + 0.5 * eps * g
        u = u + eps * p
        lp, g = vg(u)
        p = p + 0.5 * eps * g
        return (u, p, g, lp), None

    (u, p, g, lp), _ = jax.lax.scan(
        step, (u, p, g, jnp.zeros_like(eps)), None, length=n_steps)
    return u, p, lp, g


def hmc(
    logpost_val: Callable,
    start: jnp.ndarray,
    key: jax.Array,
    n_samples: int,
    n_warmup: int = 500,
    n_leapfrog: int = 16,
    mass_cov: jnp.ndarray | None = None,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    divergence_thresh: float = 1000.0,
) -> HMCResult:
    """Sample `n_samples` draws after `n_warmup` adaptation iterations.

    logpost_val: z -> scalar log-posterior (higher is better; -inf/NaN
    for invalid states). mass_cov: position-space covariance used for
    preconditioning (typically `laplace(...).cov`); identity if None.
    """
    dim = start.shape[-1]
    dtype = start.dtype
    if mass_cov is None:
        chol = jnp.eye(dim, dtype=dtype)
    else:
        chol = jnp.linalg.cholesky(mass_cov.astype(dtype))

    def logpost_u(u):
        return logpost_val(chol @ u)

    vg = jax.value_and_grad(logpost_u)

    u0 = jax.scipy.linalg.solve_triangular(chol, start, lower=True)
    lp0, g0 = vg(u0)

    def transition(u, lp, g, eps, key):
        kp, ka = jax.random.split(key)
        p = jax.random.normal(kp, (dim,), dtype)
        h0 = lp - 0.5 * jnp.sum(p * p)
        u1, p1, lp1, g1 = _leapfrog(vg, u, p, g, eps, n_leapfrog)
        h1 = lp1 - 0.5 * jnp.sum(p1 * p1)
        delta = h1 - h0
        finite = (jnp.isfinite(delta)
                  & jnp.all(jnp.isfinite(u1)) & jnp.all(jnp.isfinite(g1)))
        divergent = ~finite | (delta < -divergence_thresh)
        alpha = jnp.where(divergent, 0.0,
                          jnp.minimum(1.0, jnp.exp(jnp.minimum(delta, 0.0))))
        acc = jax.random.uniform(ka, dtype=dtype) < alpha
        u = jnp.where(acc, u1, u)
        lp = jnp.where(acc, lp1, lp)
        g = jnp.where(acc, g1, g)
        return u, lp, g, alpha.astype(dtype), divergent

    # ---- warmup: dual averaging of log step size --------------------------
    gamma, t0, kappa = 0.05, 10.0, 0.75
    mu = jnp.log(10.0 * jnp.asarray(init_step_size, dtype))

    def warm_step(carry, m):
        u, lp, g, key, h_bar, log_eps, log_eps_bar = carry
        key, kt = jax.random.split(key)
        u, lp, g, alpha, _ = transition(u, lp, g, jnp.exp(log_eps), kt)
        mf = m.astype(dtype)
        h_bar = ((1.0 - 1.0 / (mf + t0)) * h_bar
                 + (target_accept - alpha) / (mf + t0))
        log_eps = mu - jnp.sqrt(mf) / gamma * h_bar
        eta = mf ** -kappa
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
        return (u, lp, g, key, h_bar, log_eps, log_eps_bar), None

    log_eps0 = jnp.log(jnp.asarray(init_step_size, dtype))
    carry = (u0, lp0, g0, key, jnp.zeros((), dtype), log_eps0, log_eps0)
    if n_warmup > 0:
        carry, _ = jax.lax.scan(
            warm_step, carry, jnp.arange(1, n_warmup + 1))
    u, lp, g, key, _, _, log_eps_bar = carry
    eps = jnp.exp(log_eps_bar)

    # ---- sampling: frozen step size ---------------------------------------
    def samp_step(carry, key_t):
        u, lp, g = carry
        u, lp, g, alpha, div = transition(u, lp, g, eps, key_t)
        return (u, lp, g), (chol @ u, lp, alpha, div)

    keys = jax.random.split(key, n_samples)
    (_, _, _), (zs, lps, alphas, divs) = jax.lax.scan(
        samp_step, (u, lp, g), keys)
    return HMCResult(samples=zs, logposts=lps,
                     accept_rate=jnp.mean(alphas),
                     step_size=eps,
                     n_divergent=jnp.sum(divs.astype(jnp.int32)))
