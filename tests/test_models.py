import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats
import scipy.spatial.distance as ssd

from ccgp_tpu.models import (
    InverseGamma, LogNormal, Uniform01,
    MixtureSpec, MixParams, mixed_gram, mixed_cross, unpack, pack,
    gls_beta, sigma2_mle, profile_nll, make_logpost,
)
from ccgp_tpu.ops import kernels, linalg


def se_gram_np(x, theta):
    return np.exp(-ssd.squareform(ssd.pdist(x * np.sqrt(np.atleast_1d(theta)))) ** 2)


def mix_np(x, p, th1, th2):
    r = (p**2 * se_gram_np(x, th1) + (1 - p) ** 2 * se_gram_np(x, th2))
    return r / (p**2 + (1 - p) ** 2)


def iso_spec(d):
    return MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=d)


def test_mixed_gram_iso_matches_reference_algebra(rng):
    x = rng.uniform(size=(14, 2))
    params = MixParams(p=jnp.asarray(0.7), theta1=jnp.asarray(1.3), theta2=jnp.asarray(8.0))
    got = np.asarray(mixed_gram(iso_spec(2), jnp.asarray(x), params))
    want = mix_np(x, 0.7, 1.3, 8.0)
    assert np.allclose(got, want, atol=1e-12)


def test_mixed_gram_two_families(rng):
    x = rng.uniform(size=(9, 1))
    spec = MixtureSpec(kernels.matern_family(5.0), kernels.spline_family(), dim=1)
    params = MixParams(p=jnp.asarray(0.6), theta1=jnp.asarray(0.4), theta2=jnp.asarray(0.9))
    got = np.asarray(mixed_gram(spec, jnp.asarray(x), params))
    r1 = np.asarray(kernels.matern_gram(jnp.asarray(x), 0.4, 5.0))
    r2 = np.asarray(kernels.spline_gram(jnp.asarray(x), 0.9))
    want = (0.36 * r1 + 0.16 * r2) / 0.52
    assert np.allclose(got, want, atol=1e-12)


def test_mixed_cross_unnormalized_compat(rng):
    # the two-families reference bug: corr *vector* lacks the normalizer
    x = rng.uniform(size=(8, 1))
    y = rng.uniform(size=(3, 1))
    spec = MixtureSpec(kernels.matern_family(5.0), kernels.spline_family(), dim=1)
    params = MixParams(p=jnp.asarray(0.6), theta1=jnp.asarray(0.4), theta2=jnp.asarray(0.9))
    c_norm = np.asarray(mixed_cross(spec, jnp.asarray(x), jnp.asarray(y), params))
    c_raw = np.asarray(mixed_cross(spec, jnp.asarray(x), jnp.asarray(y), params,
                                   normalized=False))
    assert np.allclose(c_raw, c_norm * 0.52, atol=1e-12)


def test_tied_anisotropic_gram(rng):
    x = rng.uniform(size=(10, 2))
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2,
                       rough="tied", anisotropic=True)
    th = np.array([0.9, 2.1])
    lam = 1.7
    params = MixParams(p=jnp.asarray(0.55), theta1=jnp.asarray(th), theta2=jnp.asarray(lam))
    got = np.asarray(mixed_gram(spec, jnp.asarray(x), params))
    r1 = se_gram_np(x, th)
    r2 = se_gram_np(x, (1 + lam) * th)
    want = (0.55**2 * r1 + 0.45**2 * r2) / (0.55**2 + 0.45**2)
    assert np.allclose(got, want, atol=1e-12)


def test_lambda_mode_train_predict_mismatch(rng):
    # Advanced-script quirk: training Gram at rate lambda, prediction at
    # theta1*(1+lambda)
    x = rng.uniform(size=(8, 2))
    y = rng.uniform(size=(4, 2))
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2,
                       rough="lambda")
    params = MixParams(p=jnp.asarray(0.5), theta1=jnp.asarray(1.2), theta2=jnp.asarray(5.0))
    g_train = np.asarray(mixed_gram(spec, jnp.asarray(x), params))
    want_train = mix_np(x, 0.5, 1.2, 5.0)
    assert np.allclose(g_train, want_train, atol=1e-12)
    c_pred = np.asarray(mixed_cross(spec, jnp.asarray(x), jnp.asarray(y), params))
    r1 = np.exp(-ssd.cdist(x * np.sqrt(1.2), y * np.sqrt(1.2)) ** 2)
    r2 = np.exp(-ssd.cdist(x, y) ** 2 * 1.2 * 6.0)
    want_pred = (0.25 * r1 + 0.25 * r2) / 0.5
    assert np.allclose(c_pred, want_pred, atol=1e-12)


def test_unpack_pack_roundtrip():
    spec = iso_spec(2)
    z = jnp.asarray([0.3, 1.1, -0.4])
    params, log_jac = unpack(spec, z)
    assert np.isclose(float(params.theta1), np.exp(0.3))
    assert np.isclose(float(params.p), 1 / (1 + np.exp(0.4)))
    # reference jacobian: -phi - 2 log(1+exp(-phi)) + psi1 + psi2
    phi = -0.4
    want = -phi - 2 * np.log(1 + np.exp(-phi)) + 0.3 + 1.1
    assert np.isclose(float(log_jac), want, rtol=1e-12)
    z2 = pack(spec, params)
    assert np.allclose(np.asarray(z2), np.asarray(z), atol=1e-12)

    aspec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2,
                        rough="tied", anisotropic=True)
    za = jnp.asarray([0.2, -0.1, 0.5, 0.9])
    pa, ja = unpack(aspec, za)
    want_ja = 0.2 + (-0.1) + 0.9 + (-0.5 - 2 * np.log(1 + np.exp(-0.5)))
    assert np.isclose(float(ja), want_ja, rtol=1e-10)
    assert np.allclose(np.asarray(pack(aspec, pa)), np.asarray(za), atol=1e-12)


def test_gls_beta_sigma2(rng):
    x = rng.uniform(size=(12, 2))
    r = mix_np(x, 0.6, 1.0, 6.0)
    y = rng.normal(size=12)
    rinv = np.linalg.inv(r)
    ones = np.ones(12)
    beta_want = ones @ rinv @ y / (ones @ rinv @ ones)
    s2_want = (y - beta_want) @ rinv @ (y - beta_want) / 12
    ch = linalg.jitter_cholesky(jnp.asarray(r))
    beta = float(gls_beta(ch, jnp.asarray(y)))
    s2 = float(sigma2_mle(ch, jnp.asarray(y), jnp.asarray(beta)))
    assert np.isclose(beta, beta_want, rtol=1e-10)
    assert np.isclose(s2, s2_want, rtol=1e-10)
    nll = float(profile_nll(ch, jnp.asarray(y)))
    want_nll = np.linalg.slogdet(r)[1] + 12 * np.log(s2_want)
    assert np.isclose(nll, want_nll, rtol=1e-10)


def test_logpost_matches_reference_formula(rng):
    """Full logpost against a literal numpy transcription of the reference:
    dmnorm + log.jacob + log.prior with IG(3,2)/IG(5,16)."""
    x = rng.uniform(size=(10, 2))
    y = rng.normal(size=10)
    sigma2 = 1.7
    z = np.array([0.4, 1.6, 0.2])
    spec = iso_spec(2)
    lp = make_logpost(spec, jnp.asarray(x), jnp.asarray(y), sigma2,
                      theta1_prior=InverseGamma(3, 2),
                      theta2_prior=InverseGamma(5, 16))
    out = lp(jnp.asarray(z))

    psi1, psi2, phi = z
    th1, th2, p = np.exp(psi1), np.exp(psi2), 1 / (1 + np.exp(-phi))
    r = mix_np(x, p, th1, th2)
    rinv = np.linalg.inv(r)
    ones = np.ones(10)
    beta = ones @ rinv @ y / (ones @ rinv @ ones)
    s = p**2 + (1 - p) ** 2
    loglike = scipy.stats.multivariate_normal(mean=beta * ones,
                                              cov=s * sigma2 * r).logpdf(y)
    log_jacob = -phi - 2 * np.log(1 + np.exp(-phi)) + psi1 + psi2
    log_prior = -4 * psi1 - 2 / th1 - 6 * psi2 - 16 / th2
    want = loglike + log_jacob + log_prior
    assert np.isclose(float(out.val), want, rtol=1e-9)
    assert np.isclose(float(out.beta), beta, rtol=1e-9)


def test_logpost_singular_is_neg_inf():
    x = jnp.zeros((5, 2))  # all-identical points -> singular R
    y = jnp.asarray(np.arange(5.0))
    lp = make_logpost(iso_spec(2), x, y, 1.0)
    out = lp(jnp.asarray([0.0, 1.0, 0.0]))
    assert float(out.val) == -np.inf


def test_logpost_whiten_matches_bordered(rng):
    """whiten=True computes the same log-posterior through the
    cancellation-free whitened residual (one extra triangular solve) —
    in f64 at small n the two paths must agree to near round-off, and the
    batch sibling must agree with the single evaluator. The f32 accuracy
    case that motivates the option (n >= 768) is adjudicated against a
    CPU-f64 oracle in scripts/verify_whiten_oracle.py."""
    from ccgp_tpu.models.likelihood import make_logpost_batch

    x = rng.uniform(size=(12, 2))
    y = rng.normal(size=12)
    kw = dict(theta1_prior=InverseGamma(3, 2),
              theta2_prior=InverseGamma(5, 16), jitter=1e-10)
    lp = make_logpost(iso_spec(2), jnp.asarray(x), jnp.asarray(y), 1.3, **kw)
    lp_w = make_logpost(iso_spec(2), jnp.asarray(x), jnp.asarray(y), 1.3,
                        whiten=True, **kw)
    lpb_w = make_logpost_batch(iso_spec(2), jnp.asarray(x), jnp.asarray(y),
                               1.3, whiten=True, **kw)
    zs = jnp.asarray(rng.normal(size=(5, 3)) * 0.5)
    vals_w, betas_w = lpb_w(zs)
    for i, z in enumerate(zs):
        a, b = lp(z), lp_w(z)
        assert np.isclose(float(a.val), float(b.val), rtol=1e-9)
        assert np.isclose(float(a.beta), float(b.beta), rtol=1e-9)
        assert np.isclose(float(vals_w[i]), float(a.val), rtol=1e-9)
        assert np.isclose(float(betas_w[i]), float(a.beta), rtol=1e-9)


def test_fit_combined_gp_whiten_path(rng):
    """fit_combined_gp(whiten=True) routes the sampler to the XLA scan
    (never the CUDA kernel) and still produces a healthy chain."""
    from ccgp_tpu.models import MCMCConfig, fit_combined_gp

    x = jnp.asarray(rng.uniform(size=(16, 2)))
    y = jnp.sin(5 * x[:, 0]) + jnp.cos(3 * x[:, 1])
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)
    cfg = MCMCConfig(start=(1.0, 1.0, 0.0, 0.0), n_max=150, samp_size=60,
                     net_samp_size=60, speculative=4)
    fit = fit_combined_gp(spec, x, y, jax.random.PRNGKey(2), mcmc=cfg,
                          theta1_prior=LogNormal(-1, 1),
                          theta2_prior=InverseGamma(3, 4), jitter=1e-9,
                          mle_method="grid", whiten=True)
    assert int(fit.mcmc.n_recorded) > 0
    assert np.isfinite(np.asarray(fit.zs)).all()
    assert np.isfinite(np.asarray(fit.cache.chol)).all()


def test_logpost_grad_finite(rng):
    x = rng.uniform(size=(10, 2))
    y = rng.normal(size=10)
    lp = make_logpost(iso_spec(2), jnp.asarray(x), jnp.asarray(y), 1.0,
                      theta1_prior=InverseGamma(3, 2),
                      theta2_prior=InverseGamma(5, 16))
    g = jax.grad(lambda z: lp(z).val)(jnp.asarray([0.4, 1.6, 0.2]))
    assert np.all(np.isfinite(np.asarray(g)))


def test_lognormal_prior_matches_aniso_reference():
    # reference log.prior term for theta: -psi - psi^2/2  (+ const)
    ln = LogNormal(-1.0, 1.0)
    for th in [0.3, 1.0, 2.5]:
        psi = np.log(th)
        got = float(ln.log_kernel(jnp.asarray(th)))
        want = -psi - (psi + 1.0) ** 2 / 2
        # log_kernel = -psi - (psi - mu)^2/2 = want up to additive const
        got0 = float(ln.log_kernel(jnp.asarray(1.0)))
        want0 = -0.0 - (0.0 + 1.0) ** 2 / 2
        assert np.isclose(got - got0, want - want0, rtol=1e-10)


def test_logpost_batched_vmap(rng):
    x = rng.uniform(size=(10, 2))
    y = rng.normal(size=10)
    lp = make_logpost(iso_spec(2), jnp.asarray(x), jnp.asarray(y), 1.0)
    zs = jnp.asarray(rng.normal(size=(7, 3)))
    out = jax.vmap(lp)(zs)
    assert out.val.shape == (7,)
    single = lp(zs[3])
    assert np.isclose(float(out.val[3]), float(single.val), rtol=1e-12)


def test_fit_combined_gp_speculative_path(rng):
    """fit_combined_gp(speculative=4) exercises the whole-round mh_round
    wiring (XLA fallback on CPU): healthy chain, finite posterior, and a
    posterior location consistent with the sequential fit."""
    from ccgp_tpu.models import (MixtureSpec, MCMCConfig, fit_combined_gp,
                                 InverseGamma)
    from ccgp_tpu.ops import kernels

    x = jnp.asarray(rng.uniform(size=(12, 2)))
    y = jnp.sin(5 * x[:, 0]) * jnp.cos(3 * x[:, 1])
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    kw = dict(theta1_prior=InverseGamma(3, 2),
              theta2_prior=InverseGamma(5, 16), jitter=1e-8)
    cfg_s = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=900, samp_size=300,
                       net_samp_size=200, speculative=4)
    cfg_0 = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=900, samp_size=300,
                       net_samp_size=200)
    fit_s = fit_combined_gp(spec, x, y, jax.random.PRNGKey(0), mcmc=cfg_s,
                            **kw)
    fit_0 = fit_combined_gp(spec, x, y, jax.random.PRNGKey(0), mcmc=cfg_0,
                            **kw)
    assert bool(fit_s.chain_ok)
    assert np.all(np.isfinite(np.asarray(fit_s.zs)))
    med_s = np.median(np.asarray(fit_s.zs), axis=0)
    med_0 = np.median(np.asarray(fit_0.zs), axis=0)
    # same posterior, different streams: medians agree loosely
    assert np.all(np.abs(med_s - med_0) < 2.0), (med_s, med_0)
    # acceptance-rate agreement (same Markov kernel)
    a_s = float(fit_s.mcmc.n_accepted) / float(fit_s.mcmc.n_proposals)
    a_0 = float(fit_0.mcmc.n_accepted) / float(fit_0.mcmc.n_proposals)
    assert abs(a_s - a_0) < 0.15, (a_s, a_0)


def test_fit_combined_gp_matern_spline_speculative(rng):
    """The reference's ORIGINAL 1-D mixture — Matérn(nu=5) smooth +
    cubic-spline rough (`1D Combined GP Public.R` / two-families) —
    through the speculative fit+predict path in the DEFAULT lane. Non-SE
    mixtures never reach the SE-only CUDA rounds kernel, so this pins the
    chunked driver's XLA scan end-to-end at small budgets (the
    full-budget runs live in the slow experiment tests)."""
    from ccgp_tpu.models import (MixtureSpec, MCMCConfig, fit_combined_gp,
                                 predict_combined_gp, InverseGamma)
    from ccgp_tpu.ops import kernels

    x = jnp.sort(jnp.asarray(rng.uniform(size=(14, 1))), axis=0)
    y = jnp.sin(7 * x[:, 0]) + 0.3 * x[:, 0]
    xt = jnp.asarray(rng.uniform(size=(9, 1)))
    spec = MixtureSpec(kernels.matern_family(5.0), kernels.spline_family(),
                       dim=1)
    cfg = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=400, samp_size=120,
                     net_samp_size=80, speculative=4)
    fit = fit_combined_gp(spec, x, y, jax.random.PRNGKey(2), mcmc=cfg,
                          theta1_prior=InverseGamma(3, 2),
                          theta2_prior=InverseGamma(5, 16), jitter=1e-8)
    assert np.all(np.isfinite(np.asarray(fit.zs)))
    assert int(fit.mcmc.n_accepted) > 0
    pred = predict_combined_gp(spec, fit, x, xt, jax.random.PRNGKey(3))
    assert np.all(np.isfinite(np.asarray(pred.mean)))
    assert np.all(np.asarray(pred.upper) >= np.asarray(pred.lower))
    # interpolation sanity: at the training points the posterior mean
    # reproduces y (noise-free GP emulator)
    pred_tr = predict_combined_gp(spec, fit, x, x, jax.random.PRNGKey(4))
    assert np.allclose(np.asarray(pred_tr.mean), np.asarray(y), atol=5e-2)
