"""Sharded sweep runners: the multi-chip execution paths.

Every runner is ordinary jitted code with sharding constraints — XLA
inserts the collectives (psum/all-gather). The same functions run
unsharded on one device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ccgp_tpu.eb.halton import halton
from ccgp_tpu.eb.hyperpriors import marginal_likelihood
from ccgp_tpu.infer.metropolis import metropolis
from ccgp_tpu.models.combination import MixtureSpec, unpack, mixed_gram, mixed_cross
from ccgp_tpu.ops import linalg
from ccgp_tpu.ops.gp import gls_beta


def _pad_to(arr: jnp.ndarray, mult: int):
    """Pad the leading dim to a multiple of `mult` (sharding needs even
    splits); returns (padded, original_length)."""
    n = arr.shape[0]
    pad = (-n) % mult
    if pad:
        arr = jnp.concatenate([arr, jnp.repeat(arr[-1:], pad, axis=0)])
    return arr, n


def sharded_hyperpar_scan(
    spec: MixtureSpec,
    x: jnp.ndarray,
    y: jnp.ndarray,
    grid: np.ndarray,
    sigma2,
    mesh: Mesh,
    n_nodes: int = 1728,
    tau: float = 100.0,
    jitter: float = 0.0,
):
    """EB hyperprior grid scan with rows sharded over the 'dp' mesh axis.

    The 60x1728 (or 624x1000) likelihood table is embarrassingly parallel;
    each device scans its row shard with a local lax.map and only the final
    argmax reduces across chips.
    """
    nodes = jnp.asarray(halton(n_nodes, 1)[:, 0], x.dtype)
    ndp = mesh.shape["dp"] * mesh.shape.get("mp", 1)
    grid_j, n_rows = _pad_to(jnp.asarray(grid, x.dtype), ndp)

    row_shard = NamedSharding(mesh, P(("dp", "mp")))
    grid_j = jax.device_put(grid_j, row_shard)

    @jax.jit
    def scan(grid_rows):
        def row_ml(row):
            return marginal_likelihood(spec, x, y, (row[0], row[1]),
                                       (row[2], row[3]), sigma2, nodes,
                                       tau=tau, jitter=jitter)

        likes = jax.lax.map(row_ml, grid_rows)
        return jax.lax.with_sharding_constraint(likes, row_shard)

    likes = scan(grid_j)[:n_rows]
    idx = int(jnp.argmax(likes))
    return grid[idx], np.asarray(likes)


def multi_chain_metropolis(
    logpost: Callable,
    starts: jnp.ndarray,      # (c, dim)
    keys: jax.Array,          # (c, 2) PRNG keys
    mesh: Mesh,
    **metro_kwargs,
):
    """Independent MCMC chains sharded over all mesh devices."""
    shard = NamedSharding(mesh, P(("dp", "mp")))
    starts = jax.device_put(starts, shard)
    keys = jax.device_put(keys, shard)
    run = jax.jit(jax.vmap(lambda s, k: metropolis(logpost, s, k,
                                                   **metro_kwargs)))
    return run(starts, keys)


def sharded_design_sweep(
    fit_one: Callable,
    designs: jnp.ndarray,     # (m, n, d) training designs
    keys: jax.Array,          # (m, ...) per-design PRNG keys
    mesh: Mesh,
):
    """The 100-design simulation study (`2D Codes and Designs` training
    designs): one fit per design, designs sharded across chips."""
    shard = NamedSharding(mesh, P(("dp", "mp")))
    designs, n = _pad_to(designs, int(np.prod(list(mesh.shape.values()))))
    keys, _ = _pad_to(keys, int(np.prod(list(mesh.shape.values()))))
    designs = jax.device_put(designs, shard)
    keys = jax.device_put(keys, shard)
    out = jax.jit(jax.vmap(fit_one))(designs, keys)
    return jax.tree_util.tree_map(lambda a: a[:n], out)


def sharded_posterior_predict(
    spec: MixtureSpec,
    x: jnp.ndarray,           # (n, d) training inputs (replicated)
    y: jnp.ndarray,           # (n,)
    x_new: jnp.ndarray,       # (t, d) prediction points (replicated)
    zs: jnp.ndarray,          # (m, p) retained unconstrained draws
    betas: jnp.ndarray,       # (m,) per-draw GLS intercepts
    sigma2,
    mesh: Mesh,
    jitter: float = 0.0,
    var_scale: str = "sigma2",
    normalized_cross: bool = True,
):
    """Posterior-predictive moments with the retained DRAWS sharded over
    the mesh — the other half of every study next to the training step
    (reference per-draw predictive: `1D Combined GP Public.R:783-811`).

    Each device factorizes and predicts its draw shard locally (factor
    build + trsm, embarrassingly parallel over draws); the cross-draw
    aggregation mean mu0 = E[mean_i] is the XLA collective. Returns (draw_mean, draw_var, mu0) with the per-draw
    arrays gathered back; identical on a 1-device mesh
    (tests/test_parallel.py, chip_smoke.py --four-cards).
    """
    from ccgp_tpu.predict.factors import build_factors
    from ccgp_tpu.predict.posterior import predictive_moments

    ndev = int(np.prod(list(mesh.shape.values())))
    draw_shard = NamedSharding(mesh, P(("dp", "mp")))
    zs_p, m = _pad_to(zs, ndev)
    betas_p, _ = _pad_to(betas, ndev)
    zs_p = jax.device_put(zs_p, draw_shard)
    betas_p = jax.device_put(betas_p, draw_shard)
    row_shard = NamedSharding(mesh, P(("dp", "mp"), None))

    @jax.jit
    def run(zs_p, betas_p):
        cache = build_factors(spec, x, y, zs_p, betas_p, jitter=jitter)
        dm, dv = predictive_moments(spec, cache, x, x_new, sigma2,
                                    var_scale=var_scale,
                                    normalized_cross=normalized_cross)
        dm = jax.lax.with_sharding_constraint(dm, row_shard)
        dv = jax.lax.with_sharding_constraint(dv, row_shard)
        # cross-draw aggregation: padded rows replicate the LAST real draw,
        # so sum real rows only and divide by the true draw count
        mask = (jnp.arange(dm.shape[0]) < m).astype(dm.dtype)
        mu0 = jnp.einsum("m,mt->t", mask, dm) / m
        return dm, dv, mu0

    dm, dv, mu0 = run(zs_p, betas_p)
    return dm[:m], dv[:m], mu0


class TrainStepState(NamedTuple):
    """Per-chain MCMC state for the distributed training step."""

    z: jnp.ndarray          # (c, p) current unconstrained parameters
    lp: jnp.ndarray         # (c,) current log-posterior values
    key: jnp.ndarray        # (c, 2) PRNG keys
    accepts: jnp.ndarray    # (c,) running acceptance counts


def distributed_train_step(
    spec: MixtureSpec,
    x: jnp.ndarray,           # (n, d) training inputs (replicated)
    y: jnp.ndarray,           # (n,)
    x_eval: jnp.ndarray,      # (t, d) monitoring grid, sharded over 'mp'
    sigma2,
    prop_chol: jnp.ndarray,   # (p, p) proposal Cholesky (replicated)
    mesh: Mesh,
    theta1_prior=None,
    theta2_prior=None,
    jitter: float = 0.0,
):
    """Build the jitted multi-chip training step for the combined GP.

    One step = (for every chain, sharded over 'dp') one Metropolis
    proposal/accept on the transformed posterior + (sharded over 'mp') the
    posterior-predictive mean over the monitoring grid at each chain's
    current parameters, mean-reduced across chains (an XLA psum over 'dp').
    This is the framework's honest analogue of a "training step": the
    likelihood Gram/Cholesky is the compute, chains are dp, the
    evaluation grid is mp, and the cross-chain monitoring reduction is the
    collective.

    Returns (step_fn, make_state) where step_fn(state) -> (state, metrics).
    """
    from ccgp_tpu.models.likelihood import make_logpost

    logpost = make_logpost(spec, x, y, sigma2, theta1_prior=theta1_prior,
                           theta2_prior=theta2_prior, jitter=jitter)
    dp_shard = NamedSharding(mesh, P("dp"))
    mp_shard = NamedSharding(mesh, P("mp"))

    x_eval = jax.device_put(x_eval, mp_shard)

    def one_chain(z, lp, key):
        key, k1, k2 = jax.random.split(key, 3)
        eps = jax.random.normal(k1, z.shape, z.dtype)
        cand = z + prop_chol @ eps
        out = logpost(cand)
        accept = (out.val - lp) > jnp.log(jax.random.uniform(k2, dtype=z.dtype))
        z_new = jnp.where(accept, cand, z)
        lp_new = jnp.where(accept, out.val, lp)
        # predictive mean on the monitoring grid at current parameters
        params, _ = unpack(spec, z_new)
        r = mixed_gram(spec, x, params)
        chol = linalg.jitter_cholesky(r, jitter)
        beta = gls_beta(chol, y)
        rx = mixed_cross(spec, x, x_eval, params)
        v = linalg.tri_solve(chol, rx)
        a = linalg.tri_solve(chol, y - beta)
        mean = beta + jnp.einsum("n,nt->t", a, v)
        return z_new, lp_new, key, accept, mean

    @jax.jit
    def step(state: TrainStepState):
        z, lp, key, acc, means = jax.vmap(one_chain)(state.z, state.lp,
                                                     state.key)
        z = jax.lax.with_sharding_constraint(z, dp_shard)
        # cross-chain monitoring reduction: mean over the dp axis
        grid_mean = jnp.mean(means, axis=0)
        grid_mean = jax.lax.with_sharding_constraint(grid_mean, mp_shard)
        new_state = TrainStepState(z=z, lp=lp, key=key,
                                   accepts=state.accepts + acc)
        metrics = {
            "acc_rate": jnp.mean(acc.astype(z.dtype)),
            "mean_logpost": jnp.mean(lp),
            "grid_mean": grid_mean,
        }
        return new_state, metrics

    def make_state(key: jax.Array, n_chains: int, z0: jnp.ndarray):
        k_chains, k_perturb = jax.random.split(key)
        keys = jax.random.split(k_chains, n_chains)
        zs = jnp.tile(z0[None], (n_chains, 1))
        # perturb chains so they differ
        zs = zs + 0.01 * jax.random.normal(k_perturb, zs.shape, zs.dtype)
        lps = jax.vmap(lambda z: logpost(z).val)(zs)
        state = TrainStepState(
            z=jax.device_put(zs, dp_shard),
            lp=jax.device_put(lps, dp_shard),
            key=jax.device_put(keys, dp_shard),
            accepts=jax.device_put(jnp.zeros(n_chains, zs.dtype), dp_shard),
        )
        return state

    return step, make_state
