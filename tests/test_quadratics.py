"""Batched GP quadratics (`ops.gp.chol_quadratics`: one bordered
factorization per matrix) against dense references."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccgp_tpu.ops import kernels, linalg
from ccgp_tpu.ops.gp import (
    chol_quadratics, profile_nll, profile_nll_from_quadratics,
    mvn_nll_from_quadratics,
)


def _batch(rng, b=3, n=20):
    x = rng.uniform(size=(n, 2))
    thetas = np.linspace(1.0, 12.0, b)
    grams = jnp.stack([kernels.sqexp_gram(jnp.asarray(x), t) for t in thetas])
    y = jnp.asarray(rng.normal(size=n))
    return grams, y


def test_quadratics_xla_path_matches_dense(rng):
    grams, y = _batch(rng)
    q = chol_quadratics(grams, y, jitter=1e-10)
    for i in range(grams.shape[0]):
        r = np.asarray(grams[i]) + 1e-10 * np.eye(grams.shape[-1])
        rinv = np.linalg.inv(r)
        ones = np.ones_like(np.asarray(y))
        assert np.isclose(float(q["logdet"][i]), np.linalg.slogdet(r)[1],
                          rtol=1e-9)
        assert np.isclose(float(q["qyy"][i]), np.asarray(y) @ rinv @ np.asarray(y), rtol=1e-8)
        assert np.isclose(float(q["qoy"][i]), ones @ rinv @ np.asarray(y), rtol=1e-8)
        assert np.isclose(float(q["qoo"][i]), ones @ rinv @ ones, rtol=1e-8)


def test_profile_nll_from_quadratics_matches_reference(rng):
    grams, y = _batch(rng)
    n = y.shape[0]
    q = chol_quadratics(grams, y)
    got = profile_nll_from_quadratics(q, n)
    for i in range(grams.shape[0]):
        ch = linalg.jitter_cholesky(grams[i])
        want = float(profile_nll(ch, y))
        assert np.isclose(float(got[i]), want, rtol=1e-9)


def test_mvn_nll_from_quadratics(rng):
    grams, y = _batch(rng, b=2)
    n = y.shape[0]
    q = chol_quadratics(grams, y)
    ls = 0.7
    got = mvn_nll_from_quadratics(q, n, ls)
    import scipy.stats
    for i in range(2):
        r = np.asarray(grams[i])
        rinv = np.linalg.inv(r)
        ones = np.ones(n)
        beta = ones @ rinv @ np.asarray(y) / (ones @ rinv @ ones)
        # -2 loglike - n log 2pi = logdet + n ls + quad
        ll = scipy.stats.multivariate_normal(
            mean=beta * ones, cov=np.exp(ls) * r).logpdf(np.asarray(y))
        want = -2.0 * ll - n * np.log(2 * np.pi)
        assert np.isclose(float(got[i]), want, rtol=1e-8)


def test_logpost_batch_matches_vmapped_logpost(rng):
    """make_logpost_batch == vmap(make_logpost) on the XLA path (the
    speculative Metropolis body consumes the batched form)."""
    from ccgp_tpu.models import MixtureSpec, InverseGamma
    from ccgp_tpu.models.likelihood import make_logpost, make_logpost_batch

    x = jnp.asarray(rng.uniform(size=(15, 2)))
    y = jnp.sin(4 * x[:, 0]) + x[:, 1]
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    kw = dict(theta1_prior=InverseGamma(3, 2),
              theta2_prior=InverseGamma(5, 16), jitter=1e-8)
    lp = make_logpost(spec, x, y, 1.3, **kw)
    lpb = make_logpost_batch(spec, x, y, 1.3, **kw)
    zs = jnp.asarray(rng.normal(size=(5, 3)))
    import jax as _jax
    want = _jax.vmap(lambda z: (lambda o: (o.val, o.beta))(lp(z)))(zs)
    got = lpb(zs)
    assert np.allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=1e-9)
    assert np.allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=1e-9)


@pytest.mark.parametrize("n", [1, 100, 126, 300])
def test_quadratics_match_jnp_linalg(rng, n):
    """The bordered-factorization quadratics equal the textbook
    jnp.linalg Cholesky + triangular solves, from a 1x1 Gram through
    sizes past every former tile boundary."""
    x = jnp.asarray(rng.uniform(size=(n, 3)))
    grams = jnp.stack([kernels.sqexp_gram(x, t) for t in (2.0, 9.0)])
    y = jnp.asarray(rng.normal(size=n))
    q = chol_quadratics(grams, y, jitter=1e-6)
    for i in range(2):
        chol = jnp.linalg.cholesky(grams[i] + 1e-6 * jnp.eye(n))
        wy = jax.scipy.linalg.solve_triangular(chol, y, lower=True)
        wo = jax.scipy.linalg.solve_triangular(chol, jnp.ones(n), lower=True)
        want = {"logdet": 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol))),
                "qyy": wy @ wy, "qoy": wy @ wo, "qoo": wo @ wo}
        for k, v in want.items():
            assert np.isclose(float(q[k][i]), float(v), rtol=1e-7,
                              atol=1e-9), (n, i, k)


def test_quadratics_indefinite_gram_is_nan(rng):
    # a Gram with negative eigenvalues cannot be factorized: the
    # quadratics carry NaN (the framework's rejection signal)
    x = rng.uniform(size=(6, 2))
    g = (kernels.sqexp_gram(jnp.asarray(x), 3.0) - 2.0 * jnp.eye(6))[None]
    q = chol_quadratics(g, jnp.asarray(rng.normal(size=6)))
    assert not np.isfinite(float(q["logdet"][0]) + float(q["qyy"][0]))
