"""The SURVEY section-7 'minimum end-to-end slice': 2-D isotropic combined
GP on the reference's maximin 14-pt design, full Bayesian fit + posterior
prediction + comparison vs ordinary kriging."""
import jax
import jax.numpy as jnp
import numpy as np

from ccgp_tpu.eval import load_maximin_2d, comparison_summary
from ccgp_tpu.eval.compare import ModelPrediction
from ccgp_tpu.eval.functions import test_function_2d as f2d
from ccgp_tpu.infer import kriging_mle
from ccgp_tpu.models import (
    MixtureSpec, MCMCConfig, fit_combined_gp, predict_combined_gp,
    kriging_predict, InverseGamma,
)
from ccgp_tpu.ops import kernels
import pytest


@pytest.mark.slow
def test_2d_iso_slice(reference_data):
    x = jnp.asarray(load_maximin_2d(14))
    y = f2d(x, 2)
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=2)
    cfg = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=3000, samp_size=800,
                     net_samp_size=500)
    fit = fit_combined_gp(spec, x, y, jax.random.PRNGKey(0), mcmc=cfg,
                          theta1_prior=InverseGamma(3, 2),
                          theta2_prior=InverseGamma(5, 16))
    assert int(fit.mcmc.n_recorded) >= 800
    assert np.all(np.isfinite(np.asarray(fit.zs)))

    # posterior parameters in sensible ranges
    p = np.asarray(fit.params.p)
    th1 = np.asarray(fit.params.theta1)
    th2 = np.asarray(fit.params.theta2)
    assert (p > 0).all() and (p < 1).all()
    assert (th1 > 0).all() and (th2 > 0).all()

    # predict on a 11x11 lattice
    u = np.linspace(0, 1, 11)
    grid = np.stack(np.meshgrid(u, u), axis=-1).reshape(-1, 2)
    xg = jnp.asarray(grid)
    pred = predict_combined_gp(spec, fit, x, xg, jax.random.PRNGKey(1))
    y_true = np.asarray(f2d(xg, 2))

    fam = kernels.sqexp_family()
    kfit = kriging_mle(fam, x, y, jax.random.PRNGKey(2))
    kpred = kriging_predict(fam, x, y, kfit, xg)

    s = comparison_summary(y_true, {
        "combined": ModelPrediction(np.asarray(pred.mean),
                                    np.asarray(pred.lower),
                                    np.asarray(pred.upper),
                                    np.asarray(pred.quant)),
        "single": ModelPrediction(np.asarray(kpred.mean),
                                  np.asarray(kpred.lower),
                                  np.asarray(kpred.upper)),
    })
    # function 2 has range ~[-0.3, 0.4]; a working emulator on 14 points
    # should do much better than the trivial predictor
    assert s.rmspe["combined"] < 0.12, s
    assert s.rmspe["single"] < 0.2, s
    assert s.coverage["combined"] > 0.6, s
    assert 0.2 < s.average_quantile < 0.8, s
