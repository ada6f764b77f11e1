"""The flagship workload: 2-D anisotropic SE/SE combined GP, n = 100.

Shared by `bench.py` and `chip_smoke.py`. The reference fits this model on
its JMP 100-point maximin design (`2D Codes and Designs/maximin 100
pts.txt`), which is not part of this repository; here the design is a
SEEDED maximin Latin hypercube (`design.lhs.maximin_lhs`, best of 32
random LHDs) and is named as such. The response is the reference's 2-D
test function 2 (`eval.functions.test_function_2d`), predictions are on a
25 x 25 lattice of [0, 1]^2.

Two programs:

* `map_fit_predict`: plug-in sigma^2 by a batched log-theta grid, MAP of
  the four transformed hyperparameters by a batched Halton sweep plus one
  zoom re-scan (batched `chol_quadratics` scans at B = 24, 128 and 64),
  then posterior-predictive moments at the MAP.
* `bayes_fit_predict`: the reference's own pipeline, full-Bayes — grid
  plug-in sigma^2, Laplace, Geweke-stopped speculative Metropolis (K = 4)
  at the reference budgets (n_max = 5000, samp_size = net_samp_size =
  1000, `2D...Isotropic Public.R:845-852`), posterior-predictive MC
  intervals over the retained draws.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ccgp_tpu.design.lhs import maximin_lhs
from ccgp_tpu.eb.halton import halton
from ccgp_tpu.eval.functions import test_function_2d
from ccgp_tpu.models import (InverseGamma, LogNormal, MCMCConfig,
                             MixtureSpec, fit_combined_gp, make_logpost,
                             predict_combined_gp)
from ccgp_tpu.models.combination import mixed_cross, mixed_gram, unpack
from ccgp_tpu.ops import kernels, linalg
from ccgp_tpu.ops.gp import (chol_quadratics, gls_beta,
                             mvn_nll_from_quadratics,
                             profile_nll_from_quadratics, sigma2_mle)

DESIGN_NAME = "seeded maximin LHS (design.lhs.maximin_lhs, PRNGKey(0))"
N_TRAIN = 100
FUNC = 2
# float32 needs ~1e-3 relative jitter: the 100-point SE Gram's smallest
# eigenvalues sit below the f32 rounding floor (n*eps*lambda_max ~ 6e-4)
JITTER = 1e-3
SPEC = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2,
                   rough="tied", anisotropic=True)
THETA1_PRIOR = LogNormal(-1.0, 1.0)
THETA2_PRIOR = InverseGamma(3, 4)
MCMC = MCMCConfig(start=(1.0, 1.0, 0.0, 0.0), n_max=5000, samp_size=1000,
                  net_samp_size=1000, speculative=4)
# threefry PRNGKey(7): the stream the full-Bayes metric has always used
BAYES_KEY = 7


def design(n: int = N_TRAIN, seed: int = 0) -> np.ndarray:
    """The seeded (n, 2) maximin LHS training design, as float64 numpy."""
    with jax.default_device(jax.devices("cpu")[0]):
        x = maximin_lhs(jax.random.PRNGKey(seed), n, 2, dtype=jnp.float32)
    return np.asarray(x, np.float64)


def response(x) -> np.ndarray:
    """Test function 2 at the rows of x, as float64 numpy."""
    return np.asarray(test_function_2d(np.asarray(x), FUNC), np.float64)


def lattice(m: int = 25) -> np.ndarray:
    u = np.linspace(0, 1, m)
    return np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)


def inputs(dtype=jnp.float32):
    """(x, y, grid, y_true_on_grid) of the flagship workload."""
    x_np = design()
    grid_np = lattice()
    return (jnp.asarray(x_np, dtype), jnp.asarray(response(x_np), dtype),
            jnp.asarray(grid_np, dtype), response(grid_np))


def map_fit_predict(x, y, grid):
    """MAP program: returns (mean, var, z_map, sigma2) on the grid."""
    fam = kernels.sqexp_family()
    n = x.shape[0]
    log2pi = float(np.log(2.0 * np.pi))
    mg = jnp.asarray(np.linspace(-5.0, 6.0, 24), x.dtype)
    cloud = jnp.asarray(halton(128, 4) * np.array([6.0, 6.0, 8.0, 5.0])
                        + np.array([-2.0, -2.0, -4.0, -3.0]), x.dtype)
    zoom = jnp.asarray(halton(64, 4, start=17) - 0.5, x.dtype)

    # 1) plug-in sigma^2: profile NLL on a dense batched theta grid + one
    # parabolic refinement
    grams0 = jax.vmap(lambda lt: fam.gram(x, jnp.exp(lt)))(mg)
    nlls = profile_nll_from_quadratics(
        chol_quadratics(grams0, y, jitter=JITTER), n)
    nlls = jnp.where(jnp.isfinite(nlls), nlls, jnp.inf)
    im = jnp.clip(jnp.argmin(nlls), 1, mg.shape[0] - 2)
    f0, f1, f2 = nlls[im - 1], nlls[im], nlls[im + 1]
    h = mg[1] - mg[0]
    denom = f0 - 2.0 * f1 + f2
    shift = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * h * (f0 - f2) / denom,
                      0.0)
    lt_opt = mg[im] + jnp.clip(shift, -h, h)
    chol0 = linalg.jitter_cholesky(fam.gram(x, jnp.exp(lt_opt)), JITTER)
    sigma2 = sigma2_mle(chol0, y, gls_beta(chol0, y))

    # 2) MAP: a 128-point Halton sweep + one zoom re-scan, each one
    # batched factorization
    def neg_logpost(zs):
        params, log_jac = jax.vmap(lambda z: unpack(SPEC, z))(zs)
        grams = jax.vmap(lambda p: mixed_gram(SPEC, x, p))(params)
        q = chol_quadratics(grams, y, jitter=JITTER)
        s2mix = params.p ** 2 + (1.0 - params.p) ** 2
        core = mvn_nll_from_quadratics(q, n, jnp.log(s2mix * sigma2))
        lp = (-0.5 * (core + n * log2pi) + log_jac
              + jnp.sum(THETA1_PRIOR.log_kernel(params.theta1), axis=-1)
              + THETA2_PRIOR.log_kernel(params.theta2))
        return jnp.where(jnp.isfinite(lp), -lp, jnp.inf)

    vals = neg_logpost(cloud)
    z_best, v_best = cloud[jnp.argmin(vals)], jnp.min(vals)
    cand = z_best[None, :] + 1.2 * zoom
    vals = neg_logpost(cand)
    i = jnp.argmin(vals)
    z_map = jnp.where(vals[i] < v_best, cand[i], z_best)

    # 3) predict at the MAP over the lattice
    out = make_logpost(SPEC, x, y, sigma2, theta1_prior=THETA1_PRIOR,
                       theta2_prior=THETA2_PRIOR, jitter=JITTER)(z_map)
    params, _ = unpack(SPEC, z_map)
    v = linalg.tri_solve(out.chol, mixed_cross(SPEC, x, grid, params))
    a = linalg.tri_solve(out.chol, y - out.beta)
    u = linalg.tri_solve(out.chol, jnp.ones_like(y))
    hi = jax.lax.Precision.HIGHEST
    mean = out.beta + jnp.einsum("n,nt->t", a, v, precision=hi)
    var = sigma2 * (1.0 - jnp.einsum("nt,nt->t", v, v, precision=hi)
                    + (1.0 - jnp.einsum("n,nt->t", u, v, precision=hi)) ** 2
                    / jnp.sum(u * u))
    return mean, var, z_map, sigma2


def bayes_fit_predict(x, y, grid, key, mcmc: MCMCConfig = MCMC):
    """Full-Bayes program: returns a dict of the prediction and the chain's
    health and size."""
    kf, kp = jax.random.split(key)
    fit = fit_combined_gp(SPEC, x, y, kf, mcmc=mcmc,
                          theta1_prior=THETA1_PRIOR,
                          theta2_prior=THETA2_PRIOR, jitter=JITTER,
                          mle_method="grid")
    pred = predict_combined_gp(SPEC, fit, x, grid, kp)
    return {"mean": pred.mean, "lower": pred.lower, "upper": pred.upper,
            "chain_ok": fit.chain_ok, "n_recorded": fit.mcmc.n_recorded,
            "n_proposals": fit.mcmc.n_proposals,
            "n_rounds": fit.mcmc.n_rounds, "sigma2": fit.sigma2,
            "zs": fit.zs}


def bayes_guards(out: dict, y_true: np.ndarray) -> dict:
    """The full-Bayes accuracy, calibration and mixing guards; raises
    AssertionError on a violation, returns the guarded numbers."""
    from ccgp_tpu.infer.diagnostics import effective_sample_size

    mean = np.asarray(out["mean"], np.float64)
    assert mean.shape == y_true.shape and np.isfinite(mean).all()
    rmspe = float(np.sqrt(np.mean((y_true - mean) ** 2)))
    cover = float(np.mean((y_true >= np.asarray(out["lower"]))
                          & (y_true <= np.asarray(out["upper"]))))
    min_ess = float(np.min(np.asarray(effective_sample_size(
        jnp.asarray(np.asarray(out["zs"]))[None]))))
    res = {"rmspe": rmspe, "coverage95": cover,
           "chain_ok": bool(out["chain_ok"]), "min_ess": min_ess,
           "n_recorded": int(out["n_recorded"]),
           "n_proposals": int(out["n_proposals"]),
           "n_rounds": int(out["n_rounds"])}
    assert rmspe < 0.03, f"bayes accuracy regression: {res}"
    assert cover >= 0.80, f"bayes calibration regression: {res}"
    assert res["chain_ok"], f"bayes chain unhealthy: {res}"
    # min-ESS < 10 is the mixing policy's HMC-switch threshold (DESIGN.md)
    assert min_ess >= 10.0, f"bayes mixing regression: {res}"
    return res


def kernel_check(n: int = N_TRAIN, rr: int = 120, seed: int = 0,
                 tol: float = 2e-4) -> dict:
    """The CUDA multi-round kernel against the XLA scan on identical
    float32 inputs: the flagship model at n points, K = 4, `rr` rounds
    from the Laplace mode with the sampler's own proposal scale.

    `tol` bounds the relative log-posterior difference: a float32 XLA
    evaluation itself differs from float64 by up to ~3e-5 relative on
    these proposals, so 2e-4 leaves room for another summation order but
    not for a wrong term. Intercepts get 10 * tol; a candidate finite on
    one side only, or an accept decision that differs by more than the
    value difference explains, fails the check."""
    from ccgp_tpu.infer.laplace import laplace
    from ccgp_tpu.infer.mle import kriging_mle_grid
    from ccgp_tpu.ops import mh_rounds_gpu

    f32 = jnp.float32
    kk = MCMC.speculative
    x_np = design(n)
    x, y = jnp.asarray(x_np, f32), jnp.asarray(response(x_np), f32)
    pri = dict(theta1_prior=THETA1_PRIOR, theta2_prior=THETA2_PRIOR,
               jitter=JITTER)
    s2 = jax.jit(lambda: kriging_mle_grid(SPEC.kernel1, x, y,
                                          jitter=JITTER).sigma2)()
    lp = make_logpost(SPEC, x, y, s2, **pri)
    lap = jax.jit(lambda z: laplace(lambda q: lp(q).val, z))(
        jnp.asarray(MCMC.start, f32))
    rng = np.random.default_rng(seed)
    prop = np.linalg.cholesky(np.sqrt(2.0) * np.asarray(lap.cov, np.float64))
    deltas = jnp.asarray(rng.normal(size=(rr * kk, SPEC.n_params)) @ prop.T,
                         f32)
    log_u = jnp.asarray(np.log(rng.uniform(size=(rr, kk))), f32)
    res = mh_rounds_gpu.compare_with_xla(SPEC, x, y, s2, lap.mode, deltas,
                                         log_u, **pri)
    res.update(n=n, k=kk, tol=tol,
               ok=bool(res["val_err"] <= tol
                       and res["beta_err"] <= 10 * tol
                       and res["finite_mismatch"] == 0
                       and res["clear_flips"] == 0))
    return res
