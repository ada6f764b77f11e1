"""Seed-replication brackets for the T4 (distribution-level) claims.

The golden studies report ONE seed's coverage / calibration-quantile per
case; the archived reference values come from one R RNG stream. This
script replicates the MCMC + predictive-MC over >= 20 seeds (same data,
same budgets) and reports the seed distribution, so the T4 comparisons
become intervals instead of point assertions:

  * Ground vibrations size-50 sample-1: is the archived combined
    coverage 0.973 inside the seed spread?
  * 1-D functions 1-2: are the reported calibration quantiles
    (0.563 / 0.594 vs the 0.5 ideal) seed luck or a stable property of
    the model-data pair?

Runs on the default device (f32, full reference MCMC budgets; the T4
claims are distribution-level, and seed variation dwarfs f32-vs-f64
rounding).
Seeds run serially through one compiled program each.

Usage: python scripts/run_seed_brackets.py [--seeds N] [--cpu]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

from ccgp_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import jax.numpy as jnp  # noqa: E402

from ccgp_tpu.eval.datasets import load_ground_vibrations  # noqa: E402
from ccgp_tpu.eval.functions import test_function_1d  # noqa: E402
from ccgp_tpu.models import (InverseGamma, MCMCConfig,  # noqa: E402
                             MixtureSpec, fit_combined_gp,
                             predict_combined_gp)
from ccgp_tpu.ops import kernels  # noqa: E402


def n_seeds():
    if "--seeds" in sys.argv:
        return int(sys.argv[sys.argv.index("--seeds") + 1])
    return 20


def bracket(tag, y_true, quant_vs_truth, seeds, dtype, jitter, spec,
            x, y, x_new, mcmc, t1p, t2p, sigma2=None):
    t0 = time.time()
    cov, quant, rmspe, healthy = [], [], [], 0

    def one(key):
        kf, kp = jax.random.split(key)
        # mle_method='bfgs' matches the goldens' plug-in path exactly
        # (the grid plug-in lands on a slightly different sigma^2 and
        # shifts the calibration statistic)
        fit = fit_combined_gp(spec, x, y, kf, mcmc=mcmc, theta1_prior=t1p,
                              theta2_prior=t2p, jitter=jitter,
                              sigma2=sigma2)
        qref = jnp.asarray(y_true, dtype) if quant_vs_truth else None
        pred = predict_combined_gp(spec, fit, x, x_new, kp, quant_ref=qref)
        return (pred.mean, pred.lower, pred.upper, pred.quant, fit.chain_ok)

    run = jax.jit(one)
    for s in range(seeds):
        mean, lo, hi, qn, ok = jax.block_until_ready(
            run(jax.random.PRNGKey(1000 + s)))
        mean = np.asarray(mean)
        cov.append(float(np.mean((y_true >= np.asarray(lo))
                                 & (y_true <= np.asarray(hi)))))
        quant.append(float(np.mean(np.asarray(qn))))
        rmspe.append(float(np.sqrt(np.mean((y_true - mean) ** 2))))
        healthy += int(bool(ok))
    cov, quant, rmspe = map(np.asarray, (cov, quant, rmspe))
    print(f"{tag}: {seeds} seeds, healthy {healthy}/{seeds}, "
          f"wall {time.time()-t0:.0f}s")
    print(f"  coverage: mean {cov.mean():.3f} sd {cov.std(ddof=1):.3f} "
          f"range [{cov.min():.3f}, {cov.max():.3f}]")
    print(f"  quantile: mean {quant.mean():.3f} sd {quant.std(ddof=1):.3f} "
          f"range [{quant.min():.3f}, {quant.max():.3f}]")
    print(f"  rmspe:    mean {rmspe.mean():.3f} sd {rmspe.std(ddof=1):.3f} "
          f"range [{rmspe.min():.3f}, {rmspe.max():.3f}]", flush=True)
    return cov, quant, rmspe


def main():
    seeds = n_seeds()
    dtype = jnp.float64 if "--cpu" in sys.argv else jnp.float32
    jitter = 0.0 if "--cpu" in sys.argv else 1e-4

    # --- ground vibrations size 50 sample 1 (archived coverage 0.973) ----
    data = load_ground_vibrations(50, 1)
    x = jnp.asarray(data["x_train"], dtype)
    y = jnp.asarray(data["y_train"], dtype)
    x_new = jnp.asarray(data["x_test"], dtype)
    y_true = np.asarray(data["y_test"])
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(), dim=9)
    # sigma^2 plug-in fixed across seeds (it is deterministic in the
    # reference too — mlegp); computed once by the mlegp protocol
    from ccgp_tpu.infer.mle import mlegp_fit

    mle = mlegp_fit(kernels.sqexp_family(), x, y, jax.random.PRNGKey(0),
                    jitter=max(jitter, 1e-6))
    print(f"GV sigma2 plug-in {float(mle.sigma2):.3f}", flush=True)
    mcmc = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=5000, samp_size=1000,
                      net_samp_size=1000,
                      speculative=4 if dtype == jnp.float32 else 0)
    bracket("GV size-50 sample-1 combined", y_true, False, seeds,
            dtype, jitter, spec, x, y, x_new, mcmc,
            InverseGamma(3, 1), InverseGamma(5, 75),
            sigma2=float(mle.sigma2))

    # --- 1-D functions 1 and 2, SAME designs as the golden studies -------
    # (run_goldens draws the design from PRNGKey(10+func) via sim_1d.run)
    from ccgp_tpu.design.lhs import random_lhs

    fam = kernels.matern_family(5.0)
    spec1 = MixtureSpec(fam, fam, dim=1)
    for func in (1, 2):
        k_d, _ = jax.random.split(jax.random.PRNGKey(10 + func))
        x1 = jnp.asarray(np.asarray(random_lhs(k_d, 8, 1, jnp.float64)),
                         dtype).reshape(-1, 1)
        y1 = test_function_1d(x1[:, 0], func)
        xn = jnp.asarray(np.linspace(0, 1, 50)[:, None], dtype)
        yt = np.asarray(test_function_1d(xn[:, 0], func))
        mcmc1 = MCMCConfig(start=(0.0, 1.5, 0.0), n_max=10000,
                           samp_size=5000, net_samp_size=2500)
        bracket(f"1-D function {func} combined", yt, True, seeds,
                dtype, max(jitter, 1e-6), spec1, x1, y1, xn, mcmc1,
                InverseGamma(3, 2), InverseGamma(5, 16))


if __name__ == "__main__":
    main()
