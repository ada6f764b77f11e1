"""Ordinary-kriging maximum-likelihood fit — the plug-in sigma^2 source.

Replaces both the reference's hand-rolled `MLEs` (`1D Codes and Designs/1D
Combined GP Public.R:455-471`: `nlminb` from a random uniform start with
retry-on-singularity) and its `mlegp::mlegp` dependency (used purely as the
sigma^2 plug-in in every >=2-D script, e.g. `2D Codes and Designs/2D
Combined GP Isotropic Public.R:743-744` and `Heat Exchanger
Emulator/Combined GP Heat Exchanger.R:759-760`).

Design: the profile negative log-likelihood (Cholesky log-det + GLS
beta + variance MLE) is differentiated with jax.grad and minimized by a
vmapped multistart BFGS in log-theta space — all restarts run as one
compiled batch, and singular Grams turn into +inf objectives instead of R
exceptions.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ccgp_tpu.infer.optim import multistart_minimize
from ccgp_tpu.ops.gp import gls_beta, sigma2_mle, profile_nll
from ccgp_tpu.ops import linalg
from ccgp_tpu.ops.kernels import KernelFamily


class KrigingMLE(NamedTuple):
    beta: jnp.ndarray
    sigma2: jnp.ndarray
    theta: jnp.ndarray      # (scalar stored as shape-() or (d,) for ARD)
    nll: jnp.ndarray        # profile NLL at the optimum
    chol: jnp.ndarray       # Cholesky of the optimal Gram (reusable)


def kriging_mle(
    family: KernelFamily,
    x: jnp.ndarray,
    y: jnp.ndarray,
    key: jax.Array,
    ard: bool = False,
    n_starts: int = 8,
    log_theta_low: float = -7.0,
    log_theta_high: float = 7.0,
    jitter: float = 1e-10,
    maxiter: int = 100,
) -> KrigingMLE:
    """Fit a constant-mean GP with `family` correlation by profile ML.

    ard=True fits one rate per input dimension (the mlegp behavior);
    ard=False a single scalar (the reference's 1-D / isotropic fits).

    The search is box-constrained to [log_theta_low, log_theta_high] (tanh
    reparameterization): an unconstrained line search can step into
    singular-Gram territory whose NaN value poisons the quasi-Newton state
    (the reference hits the same failure as an R exception and retries,
    `1D...Public.R:457-466`). The default diagonal jitter keeps the profile
    NLL finite over the whole box, so gradients stay clean.
    """
    n, d = x.shape[-2], x.shape[-1]
    k = d if ard else 1

    def nll_of_logtheta(lt):
        theta = jnp.exp(lt if ard else lt[0])
        r = family.gram(x, theta)
        chol = linalg.jitter_cholesky(r, jitter)
        nll = profile_nll(chol, y)
        # Reject the profile-NLL ridge at the all-ones Gram (distinct design
        # points numerically perfectly correlated, sigma2_hat exploding to
        # compensate): a global multistart finds this degenerate "optimum"
        # on smooth kernels, but the reference's single-start nlminb never
        # leaves the interior basin and its retry loop discards the singular
        # limit (`1D...Public.R:455-471`). Observed: Matern nu=5, n=8,
        # theta ~ 9e2 gives NLL -8.9 < interior -17.7 with sigma2 = NaN.
        off_max = jnp.max(r * (1.0 - jnp.eye(n, dtype=r.dtype)))
        return jnp.where(off_max < 1.0 - 1e-6, nll, jnp.inf)

    span = log_theta_high - log_theta_low
    starts = log_theta_low + span * (
        (jnp.arange(n_starts, dtype=x.dtype)[:, None] + 0.5) / n_starts
        + 0.2 * jax.random.uniform(key, (n_starts, k), dtype=x.dtype,
                                   minval=-1.0, maxval=1.0) / n_starts)
    starts = jnp.clip(starts, log_theta_low, log_theta_high)
    res = multistart_minimize(
        nll_of_logtheta, starts,
        lower=jnp.full((k,), log_theta_low, x.dtype),
        upper=jnp.full((k,), log_theta_high, x.dtype), maxiter=maxiter)
    theta = jnp.exp(res.x if ard else res.x[0])
    chol = linalg.jitter_cholesky(family.gram(x, theta), jitter)
    beta = gls_beta(chol, y)
    sigma2 = sigma2_mle(chol, y, beta)
    return KrigingMLE(beta=beta, sigma2=sigma2, theta=theta, nll=res.fun,
                      chol=chol)


def kriging_mle_grid(
    family: KernelFamily,
    x: jnp.ndarray,
    y: jnp.ndarray,
    log_theta_low: float = -5.0,
    log_theta_high: float = 6.0,
    n_grid: int = 32,
    jitter: float = 1e-10,
) -> KrigingMLE:
    """Scalar-rate profile-ML fit by a dense batched log-theta grid plus one
    parabolic refinement: one batched Cholesky (throughput-bound) instead
    of a sequential quasi-Newton chain (latency-bound).
    Same role as `MLEs`/`mlegp`'s sigma^2 plug-in (`1D...Public.R:455-471`);
    scalar theta only — use `kriging_mle(ard=True)` for per-dimension rates.
    """
    from ccgp_tpu.ops.gp import chol_quadratics, profile_nll_from_quadratics

    n = y.shape[-1]

    def scan(center, half_span, m):
        mg = center + jnp.linspace(-half_span, half_span, m, dtype=x.dtype)
        grams = jax.vmap(lambda lt: family.gram(x, jnp.exp(lt)))(mg)
        q = chol_quadratics(grams, y, jitter=jitter)
        nlls = profile_nll_from_quadratics(q, n)
        # same all-ones-Gram ridge rejection as kriging_mle
        eye = jnp.eye(n, dtype=x.dtype)
        off_max = jnp.max(grams * (1.0 - eye), axis=(-2, -1))
        nlls = jnp.where(off_max < 1.0 - 1e-6, nlls, jnp.inf)
        nlls = jnp.where(jnp.isfinite(nlls), nlls, jnp.inf)
        i = jnp.clip(jnp.argmin(nlls), 1, m - 2)
        f0, f1, f2 = nlls[i - 1], nlls[i], nlls[i + 1]
        h = mg[1] - mg[0]
        denom = f0 - 2.0 * f1 + f2
        shift = jnp.where(jnp.abs(denom) > 1e-12,
                          0.5 * h * (f0 - f2) / denom, 0.0)
        return mg[i] + jnp.clip(shift, -h, h), h

    # coarse sweep + one zoomed sweep around the incumbent: two batched
    # Cholesky rounds, sequential depth 2
    mid = 0.5 * (log_theta_low + log_theta_high)
    lt, h = scan(jnp.asarray(mid, x.dtype),
                 0.5 * (log_theta_high - log_theta_low), n_grid)
    lt, _ = scan(lt, h, 17)
    theta = jnp.exp(lt)
    chol = linalg.jitter_cholesky(family.gram(x, theta), jitter)
    beta = gls_beta(chol, y)
    sigma2 = sigma2_mle(chol, y, beta)
    return KrigingMLE(beta=beta, sigma2=sigma2, theta=theta,
                      nll=profile_nll(chol, y), chol=chol)


def mlegp_fit(
    family: KernelFamily,
    x: jnp.ndarray,
    y: jnp.ndarray,
    key: jax.Array | None = None,
    jitter: float = 1e-10,
    n_random: int = 12,
    maxiter: int = 300,
    log_theta_low: float = -14.0,
    log_theta_high: float = 14.0,
) -> KrigingMLE:
    """ARD Gaussian-correlation GP fit — the framework's `mlegp::mlegp`
    baseline (`Ground Vibrations Emulator/Combined GP Ground
    Vibrations.R:655,720`; same role in every >=2-D script).

    mlegp's algorithm is profile ML over per-dimension rates, searched by
    5 random-start simplex runs + a loosely-converged BFGS (tol 0.01).
    The protocol here is stronger and deterministic-by-default:
    seed from the 1-D isotropic profile-ML optimum (a dense batched grid),
    fan out per-dimension +/-2 and +/-4 log-kicks plus a small Gaussian
    cloud, refine every start as ONE vmapped box-BFGS batch, and take the
    best re-evaluated optimum.

    Parity evidence (scripts/recover_mlegp_fit.py + tests): mlegp's exact
    GV size-50 sample-1 fit was recovered from the archived results table
    (se-formula residual 1.7e-7) and our predictor reproduces the archived
    columns bit-for-printed-bit at those parameters; mlegp's point is a
    loosely-converged stop (profile NLL 83.68) that no fully-convergent
    optimizer terminates at — this protocol finds NLL 78.94 on that data
    (better likelihood AND better RMSPE 2.56 vs 2.69; coverage 0.84 vs
    0.87). The formula-level parity is pinned by the archived-table test;
    the optimizer is deliberately better, not bug-compatible.
    """
    n, d = x.shape[-2], x.shape[-1]
    iso = kriging_mle_grid(family, x, y, jitter=jitter)
    lt_iso = jnp.log(iso.theta)

    def nll_of_logtheta(lt):
        theta = jnp.exp(lt)
        r = family.gram(x, theta)
        chol = linalg.jitter_cholesky(r, jitter)
        nll = profile_nll(chol, y)
        off_max = jnp.max(r * (1.0 - jnp.eye(n, dtype=r.dtype)))
        return jnp.where(off_max < 1.0 - 1e-6, nll, jnp.inf)

    base = jnp.full((d,), lt_iso, x.dtype)
    starts = [base]
    for j in range(d):
        for kick in (2.0, -2.0, 4.0, -4.0):
            starts.append(base.at[j].add(kick))
    if n_random:
        k = key if key is not None else jax.random.PRNGKey(0)
        noise = jax.random.normal(k, (n_random, d), x.dtype)
        scales = jnp.asarray([0.5, 1.0, 2.0] * (n_random // 3 + 1),
                             x.dtype)[:n_random, None]
        starts.extend(list(base[None, :] + scales * noise))
    starts = jnp.clip(jnp.stack(starts), log_theta_low, log_theta_high)
    res = multistart_minimize(
        nll_of_logtheta, starts,
        lower=jnp.full((d,), log_theta_low, x.dtype),
        upper=jnp.full((d,), log_theta_high, x.dtype), maxiter=maxiter)
    theta = jnp.exp(res.x)
    chol = linalg.jitter_cholesky(family.gram(x, theta), jitter)
    beta = gls_beta(chol, y)
    sigma2 = sigma2_mle(chol, y, beta)
    return KrigingMLE(beta=beta, sigma2=sigma2, theta=theta, nll=res.fun,
                      chol=chol)
