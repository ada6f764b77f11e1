import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats

from ccgp_tpu.eval import (
    load_qian, load_ground_vibrations, load_maximin_2d, load_1d_designs,
    load_hyperpars_grid, load_initial_me_design, load_gv_archived_results,
    comparison_summary,
)
from ccgp_tpu.eval.compare import ModelPrediction
from ccgp_tpu.eval.functions import (
    test_function_1d as f1d, test_function_2d as f2d)
from ccgp_tpu.infer import kriging_mle
from ccgp_tpu.models import kriging_predict
from ccgp_tpu.ops import kernels
import pytest


def test_kriging_predict_interpolates(rng):
    x = jnp.asarray(rng.uniform(size=(20, 2)))
    y = f2d(x, 3)
    fam = kernels.sqexp_family()
    fit = kriging_mle(fam, x, y, jax.random.PRNGKey(0))
    pred = kriging_predict(fam, x, y, fit, x, alpha=0.05)
    # GP interpolates the training points; variance ~ 0 there
    assert np.allclose(np.asarray(pred.mean), np.asarray(y), atol=1e-5)
    assert np.all(np.asarray(pred.var) < 1e-5)


@pytest.mark.slow
def test_kriging_t_interval_width(rng):
    x = jnp.asarray(np.linspace(0, 1, 10)[:, None])
    y = f1d(x[:, 0], 2)
    fam = kernels.matern_family(5.0)
    fit = kriging_mle(fam, x, y, jax.random.PRNGKey(0))
    xn = jnp.asarray(np.linspace(0.03, 0.97, 17)[:, None])
    pred = kriging_predict(fam, x, y, fit, xn, alpha=0.05)
    # t_{n-1} interval: upper - mean = t_q * sd
    tq = scipy.stats.t.ppf(0.975, 9)
    sd = np.sqrt(np.asarray(pred.var))
    assert np.allclose(np.asarray(pred.upper) - np.asarray(pred.mean),
                       tq * sd, rtol=1e-9)
    # truth mostly inside the intervals
    yt = np.asarray(f1d(xn[:, 0], 2))
    cov = np.mean((yt >= np.asarray(pred.lower)) & (yt <= np.asarray(pred.upper)))
    assert cov >= 0.8


def test_datasets_shapes(reference_data):
    q = load_qian()
    assert q["x_train"].shape == (64, 4) and q["y_train"].shape == (64,)
    assert q["x_test"].shape == (14, 4)
    gv = load_ground_vibrations(50, 1)
    assert gv["x_train"].shape == (50, 9)
    assert gv["x_test"].shape == (150, 9)
    assert load_maximin_2d(14).shape == (14, 2)
    assert load_maximin_2d(100).shape == (100, 2)
    # reference ReadMe claims 100 designs; the shipped file has 201 rows
    d1 = load_1d_designs()
    assert d1.shape[1] == 8 and d1.shape[0] >= 100
    assert load_hyperpars_grid("2d").shape == (60, 4)
    assert load_hyperpars_grid("heat").shape == (624, 4)
    assert load_initial_me_design().shape == (14, 2)


def test_gv_archived_baseline_numbers(reference_data):
    """Recompute BASELINE.md's golden numbers from the archived reference
    output table."""
    cols, tab = load_gv_archived_results()
    assert tab.shape == (150, 20)
    get = lambda name: tab[:, cols.index(name) - 0]
    y = get("y.true")
    preds = {
        "combined": ModelPrediction(get("y.hat.Combined"), get("LL.Combined"),
                                    get("UL.Combined"), get("Quant.Combined")),
        "single": ModelPrediction(get("y.hat.single"), get("LL.single"),
                                  get("UL.single")),
        "cgp": ModelPrediction(get("y.hat.CGP"), get("LL.CGP"), get("UL.CGP")),
    }
    s = comparison_summary(y, preds)
    assert np.isclose(s.rmspe["combined"], 2.722, atol=2e-3)
    assert np.isclose(s.rmspe["single"], 2.687, atol=2e-3)
    assert np.isclose(s.rmspe["cgp"], 2.856, atol=2e-3)
    assert np.isclose(s.coverage["combined"], 0.973, atol=1e-3)
    assert np.isclose(s.coverage["single"], 0.867, atol=1e-3)
    assert np.isclose(s.coverage["cgp"], 0.727, atol=1e-3)
    assert np.isclose(s.average_quantile, 0.503, atol=1e-3)


def test_functions_match_r_forms():
    # spot values computed by hand from the R expressions
    assert np.isclose(float(f1d(jnp.asarray(0.3), 2)),
                      np.sin(3.0))
    x, y = 0.4, 0.6
    want = ((x - 0.2) ** 2 - (y - 0.7) ** 2) * np.exp(
        -5 * ((x - 0.8) ** 2 + (y - 0.1) ** 2)) * np.cos(10 * (x - 0.5) * y)
    assert np.isclose(float(f2d(jnp.asarray([x, y]), 2)), want)


def test_mlegp_archived_table_reproduction(reference_data):
    """THE mlegp parity oracle: at mlegp's exact fitted parameters —
    recovered to machine precision from the archived GV size-50 sample-1
    results table by least squares (scripts/recover_mlegp_fit.py; final
    loss 2.8e-20, residual 1e-11) — `kriging_predict(variant='mlegp')`
    reproduces the archived `y.hat.single` / `LL.single` / `UL.single`
    columns. This pins the single-GP baseline's FORMULAS (ARD SE
    correlation, GLS constant mean, sigma^2 MLE, se without the GLS
    mean-correction term, t(n-1) intervals) against
    `Ground Vibrations Emulator/Combined GP Ground Vibrations.R:655-666`
    independently of optimizer trajectory."""
    import jax.numpy as jnp

    from ccgp_tpu.eval.datasets import load_ground_vibrations
    from ccgp_tpu.infer.mle import KrigingMLE
    from ccgp_tpu.models.kriging import kriging_predict
    from ccgp_tpu.ops import linalg
    from ccgp_tpu.ops.gp import gls_beta, sigma2_mle
    from ccgp_tpu.ops.kernels import sqexp_family

    log_betas = jnp.asarray([
        -2.561435108508144, -1.5216932002999748, -8.073697106923673,
        0.14044709365967756, -4.549593747305096, -9.977837387620257,
        -3.3272257457333776, -4.646009837747379, 12.706648321321953])
    data = load_ground_vibrations(50, 1)
    x = jnp.asarray(data["x_train"])
    y = jnp.asarray(data["y_train"])
    xt = jnp.asarray(data["x_test"])
    fam = sqexp_family()
    theta = jnp.exp(log_betas)
    chol = linalg.jitter_cholesky(fam.gram(x, theta), 0.0)
    beta = gls_beta(chol, y)
    sigma2 = sigma2_mle(chol, y, beta)
    fit = KrigingMLE(beta=beta, sigma2=sigma2, theta=theta,
                     nll=jnp.asarray(0.0), chol=chol)
    pred = kriging_predict(fam, x, y, fit, xt, alpha=0.05, variant="mlegp")

    cols, tab = load_gv_archived_results()
    get = lambda name: tab[:, cols.index(name)]
    assert float(jnp.max(jnp.abs(pred.mean - get("y.hat.single")))) < 1e-6
    assert float(jnp.max(jnp.abs(pred.lower - get("LL.single")))) < 1e-6
    assert float(jnp.max(jnp.abs(pred.upper - get("UL.single")))) < 1e-6
    # and mlegp's own fitted mean/variance match the profile formulas
    assert np.isclose(float(beta), 3.9059508390545363, atol=1e-6)
    assert np.isclose(float(sigma2), 10.249401335560487, rtol=1e-6)
