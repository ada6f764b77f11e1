"""The 1-D simulation study over the reference's shipped designs.

The reference runs `Combined.GP.fit` serially per design of
`1D Combined GP Simulation Designs.txt` (one row per size-8 LHD,
`ReadMe.md:9-11`). Here each CHUNK of designs is one jitted vmapped
program — plug-in sigma^2 grid-MLE, Laplace seed, Metropolis chain,
posterior prediction, RMSPE/coverage/quantile all batched — and the full
100-design study loops chunks through the SAME compiled program (one
compile, persistent-cached across processes via utils/cache.py).

Chunking note: 20-lane chunks keep shapes constant, so every chunk
reuses one compiled program.

Usage: python scripts/run_sim1d_sweep.py [n_designs=100] [func=1] [chunk=20]
Appends a summary block to RESULTS.md.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N_DESIGNS = int(sys.argv[1]) if len(sys.argv) > 1 else 100
FUNC = int(sys.argv[2]) if len(sys.argv) > 2 else 1
CHUNK = int(sys.argv[3]) if len(sys.argv) > 3 else 20


def main():
    from ccgp_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    import jax
    import jax.numpy as jnp

    from ccgp_tpu.eval.datasets import load_1d_designs
    from ccgp_tpu.infer.metropolis import metropolis
    from ccgp_tpu.models import MixtureSpec, InverseGamma, make_logpost
    from ccgp_tpu.ops import kernels, linalg
    from ccgp_tpu.ops.gp import gls_beta, sigma2_mle, profile_nll
    from ccgp_tpu.predict import build_factors, predictive_moments, posterior_predict

    dtype = jnp.float32
    jitter = 1e-5
    nu = 5.0
    n_new = 50
    samp_size, net, n_max = 600, 400, 3000

    fam = kernels.matern_family(nu)
    spec = MixtureSpec(fam, fam, dim=1)

    def f_np(x):
        if FUNC == 1:
            return 0.5 * np.sin(10 * x) + 0.5 * np.cos(15 * x)
        if FUNC == 2:
            return np.sin(10 * x)
        if FUNC == 3:
            u = 18 * x - 9
            return np.where(u == 0, 1.0, np.sin(u) / np.where(u == 0, 1, u))
        return np.exp(3 * x) * np.cos(5 * (x - 2))

    designs_np = load_1d_designs()[:N_DESIGNS]              # (m, 8)
    y_np = f_np(designs_np)                                  # (m, 8)
    xg_np = np.linspace(0, 1, n_new)
    y_true_np = f_np(xg_np)

    xg = jnp.asarray(xg_np[:, None], dtype)
    y_true = jnp.asarray(y_true_np, dtype)
    mle_grid_np = np.linspace(-4.0, 2.0, 32, dtype=np.float32)

    def study_one(x, y, key):
        # plug-in sigma^2 by dense grid over log-theta (Matern scale)
        mg = jnp.asarray(mle_grid_np)

        def nll(lt):
            r = fam.gram(x, jnp.exp(lt))
            return profile_nll(linalg.jitter_cholesky(r, jitter), y)

        nlls = jax.vmap(nll)(mg)
        nlls = jnp.where(jnp.isfinite(nlls), nlls, jnp.inf)
        lt = mg[jnp.argmin(nlls)]
        ch = linalg.jitter_cholesky(fam.gram(x, jnp.exp(lt)), jitter)
        s2 = sigma2_mle(ch, y, gls_beta(ch, y))

        lp = make_logpost(spec, x, y, s2, theta1_prior=InverseGamma(3, 2),
                          theta2_prior=InverseGamma(5, 16), jitter=jitter)
        res = metropolis(lp, jnp.asarray([0.0, 1.5, 0.0], dtype), key,
                         n_max=n_max, samp_size=samp_size, alpha_geweke=0.5)
        zs, betas, _ = res.retained(samp_size)
        zs, betas = zs[samp_size - net:], betas[samp_size - net:]
        cache = build_factors(spec, x, y, zs, betas, jitter=jitter)
        dm, dv = predictive_moments(spec, cache, x, xg, s2)
        key2 = jax.random.fold_in(key, 7)
        pred = posterior_predict(key2, dm, dv, alpha=0.05, quant_ref=y_true)
        e = y_true - pred.mean
        rmspe = jnp.sqrt(jnp.mean(e * e))
        cover = jnp.mean(((y_true >= pred.lower) & (y_true <= pred.upper))
                         .astype(dtype))
        quant = jnp.mean(pred.quant)
        return rmspe, cover, quant, res.chain_ok(samp_size)

    sweep = jax.jit(jax.vmap(study_one))
    keys_np = np.asarray(jax.random.split(jax.random.PRNGKey(0), N_DESIGNS))

    # pad to a whole number of chunks (padded lanes are dropped after)
    m_pad = (-N_DESIGNS) % CHUNK
    designs_all = np.concatenate([designs_np, designs_np[:m_pad]])
    y_all = np.concatenate([y_np, y_np[:m_pad]])
    keys_all = np.concatenate([keys_np, keys_np[:m_pad]])
    n_chunks = len(designs_all) // CHUNK

    def chunk_args(c):
        s = slice(c * CHUNK, (c + 1) * CHUNK)
        return (jnp.asarray(designs_all[s][..., None], dtype),
                jnp.asarray(y_all[s], dtype),
                jnp.asarray(keys_all[s]))

    # compile once (AOT) so compile vs steady-state is reported separately
    t0 = time.time()
    compiled = sweep.lower(*chunk_args(0)).compile()
    t_compile = time.time() - t0

    t0 = time.time()
    outs = []
    for c in range(n_chunks):
        out = compiled(*chunk_args(c))
        outs.append([np.asarray(o) for o in out])
    t_run = time.time() - t0

    rmspe, cover, quant, ok = (np.concatenate([o[i] for o in outs])[:N_DESIGNS]
                               for i in range(4))

    lines = [
        "",
        f"## 1-D simulation sweep (function {FUNC}, {N_DESIGNS} shipped "
        f"designs, {n_chunks}x{CHUNK}-lane chunks of one compiled program, "
        f"backend={jax.default_backend()})",
        "",
        f"- RMSPE combined: median {np.median(rmspe):.3f}, "
        f"IQR [{np.quantile(rmspe, .25):.3f}, {np.quantile(rmspe, .75):.3f}]",
        f"- 95% PI coverage: median {np.median(cover):.3f}, "
        f"mean {cover.mean():.3f}",
        f"- calibration quantile: mean {quant.mean():.3f} (ideal 0.5)",
        f"- chains healthy (Geweke-converged, window full): "
        f"{int(ok.sum())}/{N_DESIGNS}",
        f"- wall-clock: compile {t_compile:.1f}s (persistent-cached) + "
        f"run {t_run:.1f}s",
    ]
    print("\n".join(lines))
    with open(ROOT / "RESULTS.md", "a") as fh:
        fh.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
