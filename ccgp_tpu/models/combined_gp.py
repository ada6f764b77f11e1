"""CombinedGP — the flagship end-to-end model.

Orchestrates the full reference pipeline `Combined.GP.fit`
(`1D Codes and Designs/1D Combined GP Public.R:989-1018`):

  1. plug-in sigma^2 from an ordinary-kriging profile-ML fit
     (replaces `MLEs` / `mlegp`),
  2. Laplace-seeded Metropolis over the transformed hyperparameters
     (`factors.frame` / `Metro`),
  3. per-draw Cholesky factor cache,
  4. posterior-predictive prediction with MC intervals.

Everything after data loading is jit-compiled; the MCMC is one
`lax.while_loop`, the factor cache and prediction are batched over retained
draws, and multiple chains vmap.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, TYPE_CHECKING

import jax
import jax.numpy as jnp

from ccgp_tpu.infer.metropolis import metropolis, MetropolisResult
from ccgp_tpu.infer.mle import kriging_mle, kriging_mle_grid, KrigingMLE
from ccgp_tpu.models.combination import MixtureSpec, MixParams, unpack
from ccgp_tpu.models.likelihood import make_logpost, make_mh_rounds
from ccgp_tpu.models.priors import InverseGamma
from ccgp_tpu.ops.kernels import KernelFamily

if TYPE_CHECKING:   # runtime imports are function-local: `predict` sits
    # ABOVE `models` in the layering (CLAUDE.md), so a module-level import
    # here is a cycle — `from ccgp_tpu.predict import ...` as a user's
    # FIRST import used to die on the partially-initialized
    # predict.factors this module pulled back in.
    from ccgp_tpu.predict.factors import FactorCache
    from ccgp_tpu.predict.posterior import PosteriorPrediction


@dataclass(frozen=True)
class MCMCConfig:
    """Knobs of the reference's `Metro` runs (defaults = 2-D scripts,
    `2D Codes and Designs/2D Combined GP Isotropic Public.R:845-852`)."""

    start: tuple = (1.0, 1.0, 0.0)
    n_max: int = 5000
    samp_size: int = 1000
    net_samp_size: int = 1000
    batch_size: int = 20
    alpha_geweke: float = 0.5
    record: str = "accepted"
    max_proposals: Optional[int] = None   # None -> metropolis default
    speculative: int = 0   # K>1: batched speculative proposals (accepted-only)


class CombinedGPFit(NamedTuple):
    sigma2: jnp.ndarray
    mle: KrigingMLE
    mcmc: MetropolisResult
    cache: FactorCache          # factors for the net retained draws
    zs: jnp.ndarray             # (net, n_params) retained unconstrained draws
    params: MixParams           # batched constrained draws
    chain_ok: Optional[jnp.ndarray] = None  # Geweke-converged AND window full
    y: Optional[jnp.ndarray] = None         # training responses (lazy predict)
    jitter: Optional[jnp.ndarray] = None    # the jitter the fit was built with


def fit_combined_gp(
    spec: MixtureSpec,
    x: jnp.ndarray,
    y: jnp.ndarray,
    key: jax.Array,
    mcmc: MCMCConfig = MCMCConfig(),
    theta1_prior=InverseGamma(3, 2),
    theta2_prior=InverseGamma(5, 16),
    p_prior=None,
    sigma2=None,
    mle_family: Optional[KernelFamily] = None,
    mle_ard: bool = False,
    jitter: float = 0.0,
    mle_method: str = "bfgs",    # 'bfgs' | 'grid' (scalar-rate, batched)
    whiten: bool = False,
    draw_chunk: Optional[int] = None,
) -> CombinedGPFit:
    """Fit the combined GP. sigma2=None triggers the plug-in kriging MLE;
    mle_method='grid' uses the batched dense-grid profile-ML plug-in
    (one wide Cholesky sweep instead of a sequential BFGS chain; scalar
    rate only).

    whiten=True switches every log-posterior evaluation to the
    cancellation-free whitened quadratic (see `make_logpost`): for f32
    chains at n >= 768 where the bordered qoy accumulation loses ~0.17
    relative accuracy (DESIGN.md; oracle adjudication in
    scripts/verify_whiten_oracle.py). Routes the sampler to the XLA
    scan (no CUDA kernel) — slower, so default off.

    draw_chunk: for large-n fits whose full per-draw factor cache
    (net, n, n) would not fit in device memory (m=400 draws at n=2048 is already
    6.25 GB of Cholesky factors), skip the cache build entirely and
    return a LAZY cache (empty factor arrays): `predict_combined_gp`
    then computes the predictive moments draw_chunk draws at a time
    (`predict.posterior.predictive_moments_lazy`, peak factor memory
    draw_chunk * n^2). The fit stores `y` and `jitter` so the lazy
    predict path is self-contained. Predictions match the classic cache
    to numerical roundoff (tests/test_predict.py)."""
    k_mle, k_mcmc = jax.random.split(key)
    family = mle_family or spec.kernel1
    if mle_method == "grid":
        if mle_ard:
            raise ValueError("mle_method='grid' supports scalar rates only")
        mle = kriging_mle_grid(family, x, y, jitter=jitter)
    else:
        mle = kriging_mle(family, x, y, k_mle, ard=mle_ard, jitter=jitter)
    s2 = mle.sigma2 if sigma2 is None else jnp.asarray(sigma2, x.dtype)

    logpost = make_logpost(spec, x, y, s2, theta1_prior=theta1_prior,
                           theta2_prior=theta2_prior, p_prior=p_prior,
                           jitter=jitter, whiten=whiten)
    n_train = x.shape[-2]
    rounds_fn = None
    if mcmc.speculative and mcmc.speculative > 1:
        # the chunked multi-round driver: 120 (warm) or 20 rounds per
        # mh_rounds call — one CUDA launch on a GPU inside the kernel's
        # envelope, an XLA scan elsewhere
        rounds_fn = make_mh_rounds(spec, x, y, s2, theta1_prior=theta1_prior,
                                   theta2_prior=theta2_prior,
                                   p_prior=p_prior, jitter=jitter,
                                   whiten=whiten)
    res = metropolis(logpost, jnp.asarray(mcmc.start, x.dtype), k_mcmc,
                     n_max=mcmc.n_max, samp_size=mcmc.samp_size,
                     batch_size=mcmc.batch_size,
                     alpha_geweke=mcmc.alpha_geweke, record=mcmc.record,
                     max_proposals=mcmc.max_proposals,
                     speculative=mcmc.speculative,
                     mh_rounds=rounds_fn)
    from ccgp_tpu.predict.factors import FactorCache, build_factors

    zs_all, betas_all, _ = res.retained(mcmc.samp_size)
    # reference keeps the last net_samp_size of the samp_size window
    # (`1D...Public.R:755,777`)
    zs = zs_all[mcmc.samp_size - mcmc.net_samp_size:]
    betas = betas_all[mcmc.samp_size - mcmc.net_samp_size:]
    params, _ = jax.vmap(lambda z: unpack(spec, z))(zs)
    if draw_chunk is not None:
        # LAZY cache: factors are built draw_chunk at a time inside
        # predict_combined_gp (see the docstring above); the empty
        # leading axis is the static marker predict dispatches on
        cache = FactorCache(
            chol=jnp.zeros((0, n_train, n_train), x.dtype),
            a=jnp.zeros((0, n_train), x.dtype),
            u=jnp.zeros((0, n_train), x.dtype),
            beta=betas, params=params)
    else:
        cache = build_factors(spec, x, y, zs, betas, jitter=jitter)
    return CombinedGPFit(sigma2=s2, mle=mle, mcmc=res, cache=cache, zs=zs,
                         params=params, chain_ok=res.chain_ok(mcmc.samp_size),
                         y=y, jitter=jnp.asarray(jitter, x.dtype))


def predict_combined_gp(
    spec: MixtureSpec,
    fit: CombinedGPFit,
    x: jnp.ndarray,
    x_new: jnp.ndarray,
    key: jax.Array,
    alpha: float = 0.05,
    quant_ref: Optional[jnp.ndarray] = None,
    var_scale: str = "sigma2",
    normalized_cross: bool = True,
    drop_negative_var: bool = True,
    y: Optional[jnp.ndarray] = None,
    jitter: float = 0.0,
    draw_chunk: int = 64,
) -> PosteriorPrediction:
    """Posterior-predictive prediction from a CombinedGPFit.

    A fit built with `fit_combined_gp(..., draw_chunk=...)` carries a
    LAZY factor cache (empty factor arrays): its moments are computed
    draw_chunk draws at a time using the `y` and `jitter` STORED on the
    fit (fits from fit_combined_gp carry both; explicit y=/jitter=
    arguments are only needed for fits deserialized by an older
    models/serialize.py that predates those fields)."""
    from ccgp_tpu.predict.posterior import (
        posterior_predict, predictive_moments, predictive_moments_lazy)

    lazy = fit.cache.chol.shape[0] == 0 and fit.zs.shape[0] > 0
    if lazy:
        y_train = fit.y if fit.y is not None else y
        jitter_fit = fit.jitter if fit.jitter is not None else jitter
        if y_train is None:
            raise ValueError(
                "fit carries a lazy factor cache (fit_combined_gp(..., "
                "draw_chunk=...)) but no stored y: pass y= and the fit's "
                "jitter= to predict_combined_gp")
        dm, dv = predictive_moments_lazy(
            spec, x, y_train, x_new, fit.zs, fit.cache.beta, fit.sigma2,
            jitter=jitter_fit, draw_chunk=draw_chunk, var_scale=var_scale,
            normalized_cross=normalized_cross)
    else:
        dm, dv = predictive_moments(spec, fit.cache, x, x_new, fit.sigma2,
                                    var_scale=var_scale,
                                    normalized_cross=normalized_cross)
    return posterior_predict(key, dm, dv, alpha=alpha, quant_ref=quant_ref,
                             drop_negative_var=drop_negative_var)
