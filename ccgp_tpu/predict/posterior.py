"""Posterior-predictive prediction with Monte Carlo intervals.

Reference semantics:

* per-draw moments (`1D Codes and Designs/1D Combined GP Public.R:794-812`):
    mean = beta + r' R^{-1} (y - beta 1)
    var  = sigma2 (1 - r' R^{-1} r + (1 - 1'R^{-1}r)^2 / 1'R^{-1}1)
  NOTE the reference multiplies by plain sigma2, not the mixture's marginal
  variance (p^2+(1-p)^2) sigma2; `var_scale="marginal"` provides the
  corrected alternative, default reproduces the reference.
* aggregation (`1D...Public.R:825-844`): one normal draw per posterior
  sample, point estimate = mean of per-draw means, interval = empirical
  (alpha/2, 1-alpha/2) quantiles of the draws, calibration statistic
  Quant = fraction of draws above a reference value (y_true in the 1-D
  script :839, the predictive mean mu0 in all others,
  `2D...Isotropic Public.R:633`).
* negative predictive-variance draws are dropped (`2D...Isotropic
  Public.R:625-626`) — here via fixed-shape masking.

Design: draws x test points is one batched triangular-solve + matmul
(per-draw (n,n) solve against the (n, t) cross-correlation block), then the
MC aggregation is a couple of fused elementwise/sort kernels. No per-point
Python loops (the reference's `apply_pb` over test points, `:869`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ccgp_tpu.models.combination import MixtureSpec, mixed_cross, mix_weights
from ccgp_tpu.ops import linalg
from ccgp_tpu.predict.factors import FactorCache
from ccgp_tpu.utils import stats


class PosteriorPrediction(NamedTuple):
    mean: jnp.ndarray        # (t,) point predictions (mean of draw means)
    lower: jnp.ndarray       # (t,) lower PI bound
    upper: jnp.ndarray       # (t,) upper PI bound
    quant: jnp.ndarray       # (t,) calibration quantile statistic
    draw_mean: jnp.ndarray   # (m, t) per-draw predictive means
    draw_var: jnp.ndarray    # (m, t) per-draw predictive variances


def predictive_moments(
    spec: MixtureSpec,
    cache: FactorCache,
    x: jnp.ndarray,
    x_new: jnp.ndarray,
    sigma2,
    var_scale: str = "sigma2",       # 'sigma2' (reference) | 'marginal'
    normalized_cross: bool = True,   # False reproduces the two-families bug
    solve_mode: Optional[str] = None,  # 'trsm' | 'inv_matmul' | None=auto
):
    """Per-draw predictive means/variances at x_new: returns ((m,t), (m,t)).

    solve_mode picks how v = L^{-1} r is formed per draw:
      'trsm'       one triangular solve against the full (n, t) cross
                   block — t sequential substitution columns;
      'inv_matmul' triangular solve against I_n (n columns, t/n-fold less
                   sequential substitution work at the bench shape's
                   t=625 vs n=100) followed by one batched L^{-1} @ r
                   matmul (`precision=HIGHEST`: the variance term
                   1 - r'R^{-1}r cancels, reduced-precision passes are
                   not enough). Same algebra; both paths are
                   substitution + f32 products (tests/test_predict.py
                   pins them together at conditioning-amplified
                   roundoff).
    None defaults to 'trsm' (the two have not been timed on a GPU)."""
    if solve_mode is None:
        solve_mode = "trsm"

    def one(chol, a, u, beta, params):
        r = mixed_cross(spec, x, x_new, params, predict=True,
                        normalized=normalized_cross)      # (n, t)
        if solve_mode == "inv_matmul":
            linv = linalg.tri_solve(
                chol, jnp.eye(chol.shape[-1], dtype=chol.dtype))
            v = jnp.matmul(linv, r, precision=jax.lax.Precision.HIGHEST)
        else:
            v = linalg.tri_solve(chol, r)                  # (n, t)
        mean = beta + jnp.einsum("n,nt->t", a, v)
        rinv_quad = jnp.einsum("nt,nt->t", v, v)
        one_rinv_r = jnp.einsum("n,nt->t", u, v)
        denom = jnp.sum(u * u)
        scale = sigma2
        if var_scale == "marginal":
            _, _, s = mix_weights(params.p)
            scale = s * sigma2
        var = scale * (1.0 - rinv_quad + (1.0 - one_rinv_r) ** 2 / denom)
        return mean, var

    return jax.vmap(one)(cache.chol, cache.a, cache.u, cache.beta,
                         cache.params)


def predictive_moments_lazy(
    spec: MixtureSpec,
    x: jnp.ndarray,
    y: jnp.ndarray,
    x_new: jnp.ndarray,
    zs: jnp.ndarray,
    betas: jnp.ndarray,
    sigma2,
    jitter: float = 0.0,
    draw_chunk: int = 64,
    var_scale: str = "sigma2",
    normalized_cross: bool = True,
):
    """Draw-chunked predictive moments for fits whose full factor cache
    (m, n, n) does not fit in device memory (e.g. m=400 draws at n=2048 is
    6.25 GB of Cholesky factors alone, before the batched trsm workspace
    on top). Builds factors for `draw_chunk` draws at a time inside a
    sequential `lax.map` and discards them after their (chunk, t) moments
    are computed — peak factor memory is draw_chunk * n^2 instead of
    m * n^2. Same per-draw algorithm as build_factors +
    predictive_moments; results agree to numerical roundoff (~1e-12 in
    f64 — XLA fuses the batched reductions differently per batch size,
    so NOT bit-identical; tests/test_predict.py)."""
    from ccgp_tpu.predict.factors import build_factors

    m = zs.shape[0]
    if m == 0:
        empty = jnp.zeros((0, x_new.shape[-2]), x.dtype)
        return empty, empty
    c = min(int(draw_chunk), m)
    nc = -(-m // c)
    pad = nc * c - m
    if pad:
        zs = jnp.concatenate(
            [zs, jnp.broadcast_to(zs[-1:], (pad, zs.shape[1]))])
        betas = jnp.concatenate(
            [betas, jnp.broadcast_to(betas[-1:], (pad,))])

    def one_chunk(args):
        z_c, b_c = args
        cache = build_factors(spec, x, y, z_c, b_c, jitter=jitter)
        return predictive_moments(spec, cache, x, x_new, sigma2,
                                  var_scale=var_scale,
                                  normalized_cross=normalized_cross)

    dm, dv = jax.lax.map(
        one_chunk, (zs.reshape(nc, c, zs.shape[1]), betas.reshape(nc, c)))
    t = x_new.shape[-2]
    return dm.reshape(nc * c, t)[:m], dv.reshape(nc * c, t)[:m]


def posterior_predict(
    key: jax.Array,
    draw_mean: jnp.ndarray,
    draw_var: jnp.ndarray,
    alpha: float = 0.05,
    quant_ref: Optional[jnp.ndarray] = None,
    drop_negative_var: bool = True,
) -> PosteriorPrediction:
    """Aggregate per-draw moments into predictions + MC intervals.

    quant_ref: values against which the calibration quantile is computed —
    pass y_true for the 1-D reference behavior; None uses the predictive
    mean mu0 (the >=2-D reference behavior).
    """
    m, t = draw_mean.shape
    valid = (draw_var >= 0.0) if drop_negative_var else jnp.ones_like(
        draw_var, dtype=bool)
    sd = jnp.sqrt(jnp.maximum(draw_var, 0.0))
    eps = jax.random.normal(key, draw_mean.shape, draw_mean.dtype)
    pp = draw_mean + sd * eps                              # (m, t)

    mu0 = stats.masked_mean(draw_mean.T, valid.T)          # (t,)
    ref = mu0 if quant_ref is None else quant_ref
    quant = stats.masked_mean((ref[None, :] <= pp).T.astype(pp.dtype),
                              valid.T)
    # both interval endpoints from ONE sort of the (t, m) draw matrix —
    # identical values to two masked_quantile calls at half the sort cost
    lower, upper = stats.masked_quantile_pair(pp.T, valid.T,
                                              alpha / 2, 1 - alpha / 2)
    return PosteriorPrediction(mean=mu0, lower=lower, upper=upper,
                               quant=quant, draw_mean=draw_mean,
                               draw_var=draw_var)
