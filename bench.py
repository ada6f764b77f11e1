"""Benchmark: the flagship workload (`ccgp_tpu.experiments.flagship`) on
one GPU — the 2-D anisotropic SE/SE combined GP on a seeded 100-point
maximin LHS design, predicting on a 25 x 25 lattice.

Two metrics, each the median of `block_until_ready`-timed runs after a
compile run, each with an accuracy guard:

* MAP fit + predict (`flagship.map_fit_predict`): batched plug-in sigma^2
  grid, batched Halton MAP sweep, prediction at the MAP;
* full-Bayes fit + predict (`flagship.bayes_fit_predict`): grid plug-in
  sigma^2, Laplace, Geweke-stopped speculative Metropolis (K = 4) at the
  reference budgets, posterior-predictive MC intervals; guarded by
  RMSPE, 95% coverage, chain health and min-ESS.

Refuses to run without a GPU. Prints ONE JSON line naming the device.
"""
from __future__ import annotations

import json
import statistics
import time

import numpy as np


def _times(fn, *args, reps):
    import jax

    out = jax.block_until_ready(fn(*args))          # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return out, ts


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    from ccgp_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    from ccgp_tpu.experiments import flagship as F

    x, y, grid, y_true = F.inputs()
    (mean, _, _, _), map_ms = _times(jax.jit(F.map_fit_predict), x, y, grid,
                                     reps=20)
    mean = np.asarray(mean, np.float64)
    assert np.isfinite(mean).all()
    rmspe = float(np.sqrt(np.mean((y_true - mean) ** 2)))
    assert rmspe < 0.02, f"accuracy regression: rmspe={rmspe}"

    key = jax.random.PRNGKey(F.BAYES_KEY)
    out, bayes_ms = _times(jax.jit(F.bayes_fit_predict), x, y, grid, key,
                           reps=5)
    guards = F.bayes_guards(out, y_true)

    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "design": F.DESIGN_NAME,
        "map": {"metric": "fit_predict_2d_aniso_100pt", "unit": "ms",
                "median": statistics.median(map_ms), "runs": map_ms,
                "rmspe": rmspe},
        "bayes": {"metric": "fit_predict_bayes_2d_aniso_100pt", "unit": "ms",
                  "median": statistics.median(bayes_ms), "runs": bayes_ms,
                  **guards},
    }))


if __name__ == "__main__":
    main()
