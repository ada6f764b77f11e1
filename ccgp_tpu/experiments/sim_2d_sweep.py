"""Multi-design 2-D simulation sweep, optionally sharded over a device
mesh.

The reference loops its 100 shipped Train_Designs serially through
`Combined.GP.fit` (`ReadMe.md:22-23`; `2D Codes and Designs/2D Combined GP
Isotropic Public.R:840-868` is the per-design pipeline). Here every design
is a batch lane of ONE jitted program — plug-in sigma^2 grid-MLE,
Metropolis chain, posterior prediction, RMSPE/coverage/quantile — and with
`mesh_devices` set the design axis is sharded over a `jax.sharding.Mesh`
(`parallel.sharded_design_sweep`), so the sweep scales across devices with
zero communication until the final host-side summary.

CLI: `python -m ccgp_tpu sim_2d_sweep --mesh 4 --designs 16`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ccgp_tpu.eval.datasets import load_2d_training_design
from ccgp_tpu.eval.functions import test_function_2d
from ccgp_tpu.infer.metropolis import metropolis
from ccgp_tpu.models import MixtureSpec, MCMCConfig, InverseGamma, make_logpost
from ccgp_tpu.ops import kernels, linalg
from ccgp_tpu.ops.gp import gls_beta, sigma2_mle, profile_nll
from ccgp_tpu.predict import build_factors, predictive_moments, posterior_predict


@dataclass(frozen=True)
class Config:
    func: int = 2
    n_designs: int = 16
    n_new_axis: int = 15
    jitter: float = 1e-5
    mesh_devices: int = 0      # 0 = unsharded; N >= 1 = an N-device mesh
    mcmc: MCMCConfig = MCMCConfig(start=(1.0, 1.0, 0.0), n_max=3000,
                                  samp_size=600, net_samp_size=400)


class SweepResult(NamedTuple):
    rmspe: np.ndarray       # (m,) per-design combined-GP RMSPE
    coverage: np.ndarray    # (m,) 95% PI coverage
    quant: np.ndarray       # (m,) calibration quantile
    chain_ok: np.ndarray    # (m,) healthy-chain flags
    summary: None = None    # CLI prints per-design medians instead


def _study_one_fn(cfg: Config, fam, spec, xg, y_true, mle_grid_np, dtype):
    jitter = cfg.jitter
    mc = cfg.mcmc

    def study_one(x, key):
        y = test_function_2d(x, cfg.func)
        mg = jnp.asarray(mle_grid_np)

        def nll(lt):
            r = fam.gram(x, jnp.exp(lt))
            return profile_nll(linalg.jitter_cholesky(r, jitter), y)

        nlls = jax.vmap(nll)(mg)
        nlls = jnp.where(jnp.isfinite(nlls), nlls, jnp.inf)
        ch = linalg.jitter_cholesky(fam.gram(x, jnp.exp(mg[jnp.argmin(nlls)])),
                                    jitter)
        s2 = sigma2_mle(ch, y, gls_beta(ch, y))
        lp = make_logpost(spec, x, y, s2, theta1_prior=InverseGamma(3, 2),
                          theta2_prior=InverseGamma(5, 16), jitter=jitter)
        res = metropolis(lp, jnp.asarray(mc.start, dtype), key,
                         n_max=mc.n_max, samp_size=mc.samp_size,
                         batch_size=mc.batch_size,
                         alpha_geweke=mc.alpha_geweke)
        zs, betas, _ = res.retained(mc.samp_size)
        keep = mc.samp_size - mc.net_samp_size
        zs, betas = zs[keep:], betas[keep:]
        cache = build_factors(spec, x, y, zs, betas, jitter=jitter)
        dm, dv = predictive_moments(spec, cache, x, xg, s2)
        pred = posterior_predict(jax.random.fold_in(key, 7), dm, dv)
        e = y_true - pred.mean
        rmspe = jnp.sqrt(jnp.mean(e * e))
        cover = jnp.mean(((y_true >= pred.lower) & (y_true <= pred.upper))
                         .astype(dtype))
        return rmspe, cover, jnp.mean(pred.quant), res.chain_ok(mc.samp_size)

    return study_one


def seeded_designs(m: int, n: int = 14, seed: int = 0) -> np.ndarray:
    """m seeded n-point maximin LHS designs on [0, 1]^2 (`design.lhs`), in
    place of the reference's shipped Train_Designs."""
    from ccgp_tpu.design.lhs import maximin_lhs

    keys = jax.random.split(jax.random.PRNGKey(seed), m)
    with jax.default_device(jax.devices("cpu")[0]):
        return np.stack([np.asarray(maximin_lhs(k, n, 2, dtype=jnp.float32),
                                    np.float64) for k in keys])


def run(cfg: Config = Config(), key=None, dtype=jnp.float32,
        designs: np.ndarray | None = None) -> SweepResult:
    """designs: (m, n, 2) training designs; None loads the reference's
    first cfg.n_designs shipped Train_Designs."""
    key = jax.random.PRNGKey(0) if key is None else key

    fam = kernels.sqexp_family()
    spec = MixtureSpec(fam, fam, dim=2)
    if designs is None:
        designs_np = np.stack([load_2d_training_design(i + 1)
                               for i in range(cfg.n_designs)])
    else:
        designs_np = np.asarray(designs)
    u = np.linspace(0, 1, cfg.n_new_axis)
    grid_np = np.stack(np.meshgrid(u, u), -1).reshape(-1, 2)
    xg = jnp.asarray(grid_np, dtype)
    y_true = test_function_2d(xg, cfg.func)
    mle_grid_np = np.linspace(-2.0, 5.0, 32, dtype=np.float32)

    designs = jnp.asarray(designs_np, dtype)
    keys = jax.random.split(key, designs.shape[0])

    study_one = _study_one_fn(cfg, fam, spec, xg, y_true, mle_grid_np, dtype)

    if cfg.mesh_devices:
        from ccgp_tpu.parallel import make_mesh, sharded_design_sweep

        mesh = make_mesh(cfg.mesh_devices)
        out = sharded_design_sweep(study_one, designs, keys, mesh)
    else:
        out = jax.jit(jax.vmap(study_one))(designs, keys)

    rmspe, cover, quant, ok = (np.asarray(o) for o in out)
    return SweepResult(rmspe=rmspe, coverage=cover, quant=quant, chain_ok=ok)
