import jax.numpy as jnp
import numpy as np

from ccgp_tpu.models.combination import MixtureSpec
from ccgp_tpu.ops import kernels
from ccgp_tpu.utils import stats, transforms


def test_tanh_box_roundtrip(rng):
    lo = jnp.asarray([-1.0, 0.0])
    hi = jnp.asarray([1.0, 5.0])
    x = jnp.asarray([[0.3, 4.2], [-0.99, 0.01]])
    z = transforms.tanh_box_inverse(x, lo, hi)
    back = transforms.tanh_box(z, lo, hi)
    assert np.allclose(np.asarray(back), np.asarray(x), atol=1e-6)
    # stays strictly inside the box for any z
    big = transforms.tanh_box(jnp.asarray([100.0, -100.0]), lo, hi)
    assert float(big[0]) <= 1.0 and float(big[1]) >= 0.0


def test_logit_jacobian_matches_reference_expression():
    # reference log-jacobian: -phi - 2 log(1 + e^{-phi})
    for phi in [-30.0, -2.0, 0.0, 3.0, 40.0]:
        p, jac = transforms.logit_to_unit(jnp.asarray(phi))
        if abs(phi) < 20:
            want = -phi - 2 * np.log(1 + np.exp(-phi))
            assert np.isclose(float(jac), want, rtol=1e-10)
        assert np.isfinite(float(jac))  # stable at extreme phi


def test_batch_se_iid(rng):
    x = jnp.asarray(rng.normal(size=2000))
    se = float(stats.batch_se(x, batch_size=20))
    # iid: SE of the mean ~ 1/sqrt(n)
    assert 0.5 / np.sqrt(2000) < se < 2.5 / np.sqrt(2000)


def test_quantile_type7_matches_r_default(rng):
    x = rng.normal(size=57)
    got = float(stats.quantile_type7(jnp.asarray(x), 0.3))
    want = np.quantile(x, 0.3)  # numpy 'linear' == R type 7
    assert np.isclose(got, want, rtol=1e-12)


def test_mixture_spec_n_params():
    fam = kernels.sqexp_family()
    assert MixtureSpec(fam, fam, dim=2).n_params == 3
    assert MixtureSpec(fam, fam, dim=2, rough="tied",
                       anisotropic=True).n_params == 4
    assert MixtureSpec(fam, fam, dim=9).n_params == 3


def test_mvn_logpdf_chol_scale(rng):
    import scipy.stats
    from ccgp_tpu.ops import linalg

    n = 7
    a = rng.normal(size=(n, n))
    cov = a @ a.T + n * np.eye(n)
    y = rng.normal(size=n)
    ls = 0.8
    ch = linalg.jitter_cholesky(jnp.asarray(cov))
    got = float(stats.mvn_logpdf_chol(jnp.asarray(y), 0.0, ch, ls))
    want = scipy.stats.multivariate_normal(
        mean=np.zeros(n), cov=np.exp(ls) * cov).logpdf(y)
    assert np.isclose(got, want, rtol=1e-10)


def test_masked_quantile_pair_topk_equals_sort():
    """The dual-top_k tail path must be element-equal to two full-sort
    masked_quantile calls for uneven per-row valid counts."""
    import jax
    import jax.numpy as jnp

    from ccgp_tpu.utils import stats

    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(37, 400)))
    valid = jnp.asarray(rng.uniform(size=(37, 400)) > 0.15)
    # guarantee at least one valid entry per row
    valid = valid.at[:, 0].set(True)
    for q_lo, q_hi in [(0.025, 0.975), (0.005, 0.995), (0.25, 0.75)]:
        lo2, hi2 = stats.masked_quantile_pair(x, valid, q_lo, q_hi)
        lo1 = jax.vmap(lambda c, v: stats.masked_quantile(c, v, q_lo))(
            x, valid)
        hi1 = jax.vmap(lambda c, v: stats.masked_quantile(c, v, q_hi))(
            x, valid)
        assert np.array_equal(np.asarray(lo1), np.asarray(lo2)), (q_lo, q_hi)
        assert np.array_equal(np.asarray(hi1), np.asarray(hi2)), (q_lo, q_hi)

def test_masked_quantile_pair_all_invalid_row():
    """An all-invalid row must return +big at BOTH endpoints on the
    top_k tail path (matching the sort path); before the round-3 fix the
    'hi' tail read its -big-filled selection buffer and inverted the
    interval."""
    import jax
    import jax.numpy as jnp

    from ccgp_tpu.utils import stats

    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(4, 300)))
    valid = jnp.ones((4, 300), bool).at[2].set(False)
    lo, hi = stats.masked_quantile_pair(x, valid, 0.025, 0.975)
    lo1 = jax.vmap(lambda c, v: stats.masked_quantile(c, v, 0.025))(x, valid)
    hi1 = jax.vmap(lambda c, v: stats.masked_quantile(c, v, 0.975))(x, valid)
    assert np.array_equal(np.asarray(lo), np.asarray(lo1))
    assert np.array_equal(np.asarray(hi), np.asarray(hi1))
    assert float(lo[2]) == float(hi[2]) and float(lo[2]) > 1e30
    ok = np.asarray(valid.any(-1))
    assert np.all(np.asarray(lo)[ok] <= np.asarray(hi)[ok])
