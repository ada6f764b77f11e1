"""Extra golden studies: 2-D anisotropic and 2-D advanced (EB hyperprior
selection over the shipped 60x4 grid), on the CPU in float64. Appends to
RESULTS.md.

Usage: python scripts/run_goldens_extra.py [--fast]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ccgp_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

FAST = "--fast" in sys.argv


def cpu_studies():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from ccgp_tpu.experiments import sim_2d_aniso, sim_2d_iso_advanced
    from ccgp_tpu.models import MCMCConfig

    lines = []
    nmax, samp, net = (1500, 400, 300) if FAST else (5000, 1000, 1000)

    cfg = sim_2d_aniso.Config(
        func=2, mcmc=MCMCConfig(start=(1.0, 1.0, 0.0, 0.0), n_max=nmax,
                                samp_size=samp, net_samp_size=net))
    res = sim_2d_aniso.run(cfg, key=jax.random.PRNGKey(0))

    def fmt(s):
        r = " / ".join(f"{k} {v:.3f}" for k, v in s.rmspe.items())
        c = " / ".join(f"{k} {v:.3f}" for k, v in s.coverage.items())
        return f"RMSPE: {r} | coverage: {c} | avg quantile: {s.average_quantile:.3f}"

    lam = np.asarray(res.fit.params.theta2)
    lines.append(f"- **2D anisotropic (tied (1+lambda)theta), function 2**: "
                 f"{fmt(res.summary)}; posterior lambda mean "
                 f"{lam.mean():.2f}")
    print(lines[-1], flush=True)

    cfg = sim_2d_iso_advanced.Config(
        func=2, n_nodes=(128 if FAST else 1728),
        mcmc=MCMCConfig(start=(1.0, 1.0, 0.0), n_max=nmax, samp_size=samp,
                        net_samp_size=net))
    res = sim_2d_iso_advanced.run(cfg, key=jax.random.PRNGKey(1))
    lines.append(f"- **2D advanced (EB hyperprior over shipped 60x4 grid, "
                 f"Halton N={cfg.n_nodes})**: {fmt(res.summary)}")
    print(lines[-1], flush=True)
    return lines


def main():
    lines = ["", "## Extra golden studies", ""]
    lines += cpu_studies()
    with open(ROOT / "RESULTS.md", "a") as fh:
        fh.write("\n".join(lines) + "\n")
    print("appended to RESULTS.md")


if __name__ == "__main__":
    main()
