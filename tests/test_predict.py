import jax
import jax.numpy as jnp
import numpy as np
import scipy.spatial.distance as ssd

from ccgp_tpu.models import MixtureSpec, MixParams, pack
from ccgp_tpu.ops import kernels
from ccgp_tpu.predict import build_factors, predictive_moments, posterior_predict
from ccgp_tpu.utils import stats


def iso_spec():
    return MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)


def se(x, y, th):
    return np.exp(-ssd.cdist(x, y) ** 2 * th)


def mix_np(x, y, p, t1, t2):
    r = p**2 * se(x, y, t1) + (1 - p) ** 2 * se(x, y, t2)
    return r / (p**2 + (1 - p) ** 2)


def test_predictive_moments_match_reference_formulas(rng):
    """Per-draw mean/var vs literal transcription of predict.post
    (`1D Combined GP Public.R:794-812`)."""
    n, t, m = 10, 6, 4
    x = rng.uniform(size=(n, 2))
    xn = rng.uniform(size=(t, 2))
    y = rng.normal(size=n)
    sigma2 = 1.9
    spec = iso_spec()

    draws = [(0.6, 1.1, 7.0), (0.7, 0.8, 5.0), (0.5, 2.0, 9.0), (0.65, 1.5, 6.0)]
    zs = jnp.stack([
        pack(spec, MixParams(p=jnp.asarray(p), theta1=jnp.asarray(a),
                             theta2=jnp.asarray(b)))
        for p, a, b in draws
    ])
    betas = jnp.asarray(rng.normal(size=m))
    cache = build_factors(spec, jnp.asarray(x), jnp.asarray(y), zs, betas)
    dm, dv = predictive_moments(spec, cache, jnp.asarray(x), jnp.asarray(xn),
                                sigma2)
    for i, (p, t1, t2) in enumerate(draws):
        r_train = mix_np(x, x, p, t1, t2)
        np.fill_diagonal(r_train, 1.0)
        rinv = np.linalg.inv(r_train)
        rvec = mix_np(x, xn, p, t1, t2)          # (n, t)
        beta = float(betas[i])
        mean_want = beta + rvec.T @ rinv @ (y - beta)
        ones = np.ones(n)
        var_want = sigma2 * (1 - np.einsum("nt,nm,mt->t", rvec, rinv, rvec)
                             + (1 - ones @ rinv @ rvec) ** 2
                             / (ones @ rinv @ ones))
        assert np.allclose(np.asarray(dm[i]), mean_want, rtol=1e-10)
        assert np.allclose(np.asarray(dv[i]), var_want, rtol=1e-10)


def test_posterior_predict_aggregation(rng):
    m, t = 4000, 3
    mu = np.array([1.0, -2.0, 0.5])
    sd = np.array([0.3, 0.8, 0.1])
    dm = jnp.asarray(np.broadcast_to(mu, (m, t)) + 0.0)
    dv = jnp.asarray(np.broadcast_to(sd**2, (m, t)) + 0.0)
    out = posterior_predict(jax.random.PRNGKey(0), dm, dv, alpha=0.05)
    assert np.allclose(np.asarray(out.mean), mu, atol=1e-9)
    # MC quantiles approx mu +- 1.96 sd
    assert np.allclose(np.asarray(out.upper), mu + 1.96 * sd, atol=0.12)
    assert np.allclose(np.asarray(out.lower), mu - 1.96 * sd, atol=0.12)
    # calibration vs the mean should be ~0.5
    assert np.allclose(np.asarray(out.quant), 0.5, atol=0.05)


def test_posterior_predict_negative_var_masked(rng):
    m, t = 200, 2
    dm = jnp.asarray(rng.normal(size=(m, t)))
    dv = jnp.asarray(rng.uniform(0.5, 1.0, size=(m, t)))
    dv = dv.at[: m // 2, 0].set(-1.0)  # half the draws invalid at point 0
    out = posterior_predict(jax.random.PRNGKey(1), dm, dv)
    assert np.all(np.isfinite(np.asarray(out.lower)))
    assert np.all(np.isfinite(np.asarray(out.upper)))
    # masked mean at point 0 uses only valid draws
    want = np.mean(np.asarray(dm)[m // 2:, 0])
    assert np.isclose(float(out.mean[0]), want, rtol=1e-9)


def test_masked_quantile_matches_numpy(rng):
    x = rng.normal(size=100)
    valid = rng.uniform(size=100) > 0.3
    got = float(stats.masked_quantile(jnp.asarray(x), jnp.asarray(valid), 0.25))
    want = np.quantile(x[valid], 0.25)
    assert np.isclose(got, want, rtol=1e-9)


def test_quant_ref_y_true(rng):
    # 1-D reference computes calibration against y_true
    m, t = 1000, 2
    dm = jnp.zeros((m, t))
    dv = jnp.ones((m, t))
    y_true = jnp.asarray([0.0, 10.0])
    out = posterior_predict(jax.random.PRNGKey(2), dm, dv, quant_ref=y_true)
    assert abs(float(out.quant[0]) - 0.5) < 0.06   # y_true at the center
    assert float(out.quant[1]) < 0.01              # y_true far above draws


def test_build_factors_matches_dense(rng):
    """The batched factor cache (chol, a = L^-1(y - beta), u = L^-1 1)
    equals per-draw dense numpy factorizations of the mixture Grams."""
    from ccgp_tpu.models import MixtureSpec
    from ccgp_tpu.models.combination import mixed_gram, unpack
    from ccgp_tpu.ops import kernels
    from ccgp_tpu.predict.factors import build_factors

    x = jnp.asarray(rng.uniform(size=(17, 2)))
    y = jnp.sin(5 * x[:, 0]) + x[:, 1]
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    zs = jnp.asarray(rng.normal(size=(64, 3)) * 0.4)
    betas = jnp.asarray(rng.normal(size=(64,)) * 0.05)
    got = build_factors(spec, x, y, zs, betas, jitter=1e-8)
    for i in (0, 31, 63):
        g = np.asarray(mixed_gram(spec, x, unpack(spec, zs[i])[0]))
        g = g + 1e-8 * np.mean(np.diag(g)) * np.eye(17)
        chol = np.linalg.cholesky(g)
        assert np.allclose(np.asarray(got.chol[i]), chol, atol=1e-9)
        yv = np.asarray(y) - float(betas[i])
        assert np.allclose(np.asarray(got.a[i]),
                           np.linalg.solve(chol, yv), atol=1e-7)
        assert np.allclose(np.asarray(got.u[i]),
                           np.linalg.solve(chol, np.ones(17)), atol=1e-7)


def test_lazy_draw_chunked_predict_matches_classic(rng):
    """fit_combined_gp(draw_chunk=...) skips the (m, n, n) factor-cache
    materialization (the n=2048 full-Bayes OOM, DESIGN.md §14) and
    predict_combined_gp rebuilds factors draw_chunk at a time; the
    predictions must match the classic cache to numerical roundoff
    (NOT bitwise: XLA fuses the batched reductions differently per
    batch size). draw_chunk=7 over 30 draws also exercises the
    ragged-tail padding (nc*c - m = 5)."""
    from ccgp_tpu.models import (MCMCConfig, fit_combined_gp,
                                 predict_combined_gp)

    spec = iso_spec()
    x = jnp.asarray(rng.uniform(size=(24, 2)))
    y = jnp.asarray(rng.normal(size=24))
    xt = jnp.asarray(rng.uniform(size=(17, 2)))
    cfg = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=200, samp_size=50,
                     net_samp_size=30, speculative=4)
    kf, kp = jax.random.split(jax.random.PRNGKey(3))

    classic = fit_combined_gp(spec, x, y, kf, mcmc=cfg, jitter=1e-6,
                              mle_method="grid")
    p0 = predict_combined_gp(spec, classic, x, xt, kp)

    lazy = fit_combined_gp(spec, x, y, kf, mcmc=cfg, jitter=1e-6,
                           mle_method="grid", draw_chunk=7)
    assert lazy.cache.chol.shape == (0, 24, 24)   # nothing materialized
    # the fit stores y and jitter (ADVICE r4): the lazy path is
    # self-contained — no y=/jitter= arguments needed, and a forgotten
    # jitter= can no longer silently rebuild factors with the wrong one
    assert np.allclose(np.asarray(lazy.y), np.asarray(y))
    assert float(lazy.jitter) == 1e-6
    p1 = predict_combined_gp(spec, lazy, x, xt, kp, draw_chunk=7)
    for name in ("mean", "lower", "upper", "quant"):
        a, b = np.asarray(getattr(p0, name)), np.asarray(getattr(p1, name))
        assert np.allclose(a, b, rtol=1e-9, atol=1e-11), name

    # stored y/jitter survive a checkpoint round-trip
    import tempfile

    from ccgp_tpu.models.serialize import load_fit, save_fit

    with tempfile.TemporaryDirectory() as d:
        save_fit(d + "/fit.npz", lazy)
        back = load_fit(d + "/fit.npz")
    p2 = predict_combined_gp(spec, back, x, xt, kp, draw_chunk=7)
    assert np.allclose(np.asarray(p1.mean), np.asarray(p2.mean))

    # a legacy fit without stored y (pre-field checkpoint) still raises
    import pytest

    with pytest.raises(ValueError, match="lazy factor cache"):
        predict_combined_gp(spec, lazy._replace(y=None), x, xt, kp)


def test_moments_solve_modes_agree(rng):
    """The 'inv_matmul' path (solve against I, then one matmul) and the
    default 'trsm' path are the same algebra; both are
    kappa*eps-accurate, so they agree to conditioning-amplified roundoff
    (measured: 1.2e-9 at jitter=1e-6, 1.3e-11 at 1e-4, 7e-8 at the
    near-singular 1e-10 — pure kappa scaling, not an algorithm gap)."""
    from ccgp_tpu.predict.factors import build_factors
    from ccgp_tpu.predict.posterior import predictive_moments

    spec = iso_spec()
    x = jnp.asarray(rng.uniform(size=(18, 2)))
    y = jnp.asarray(rng.normal(size=18))
    xt = jnp.asarray(rng.uniform(size=(11, 2)))
    zs = jnp.asarray(0.3 * rng.normal(size=(9, 3)))
    betas = jnp.asarray(0.1 * rng.normal(size=9))
    cache = build_factors(spec, x, y, zs, betas, jitter=1e-6)
    dm_t, dv_t = predictive_moments(spec, cache, x, xt, 0.8,
                                    solve_mode="trsm")
    dm_i, dv_i = predictive_moments(spec, cache, x, xt, 0.8,
                                    solve_mode="inv_matmul")
    assert np.allclose(np.asarray(dm_t), np.asarray(dm_i), atol=1e-8)
    assert np.allclose(np.asarray(dv_t), np.asarray(dv_i), atol=1e-12)


def test_lazy_moments_empty_draws():
    """predictive_moments_lazy on zero draws returns empty (0, t) moment
    arrays instead of a ZeroDivisionError from the chunk-count arithmetic
    (ADVICE r4)."""
    from ccgp_tpu.predict.posterior import predictive_moments_lazy

    spec = iso_spec()
    x = jnp.zeros((5, 2))
    y = jnp.zeros(5)
    xt = jnp.zeros((3, 2))
    dm, dv = predictive_moments_lazy(
        spec, x, y, xt, jnp.zeros((0, 3)), jnp.zeros((0,)), 1.0)
    assert dm.shape == (0, 3) and dv.shape == (0, 3)
