"""Latin hypercube sampling (replaces the reference's lhs::randomLHS /
optimumLHS usage for training designs and optimizer starts,
`1D Codes and Designs/1D Combined GP Public.R:1095`, `Batch Sequential ME
Designs/Batch Sequential ME Design.R:899,935`)."""
from __future__ import annotations

import jax
import jax.numpy as jnp


def random_lhs(key: jax.Array, n: int, d: int,
               dtype=jnp.float64) -> jnp.ndarray:
    """randomLHS: one uniform draw per stratum, strata permuted per column."""
    kp, ku = jax.random.split(key)
    u = jax.random.uniform(ku, (n, d), dtype=dtype)
    cols = []
    for j, k in enumerate(jax.random.split(kp, d)):
        perm = jax.random.permutation(k, n)
        cols.append((perm.astype(dtype) + u[:, j]) / n)
    return jnp.stack(cols, axis=1)


def _min_dist(x: jnp.ndarray) -> jnp.ndarray:
    n = x.shape[0]
    d2 = jnp.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    d2 = d2 + jnp.eye(n, dtype=x.dtype) * 1e9
    return jnp.min(d2)


def maximin_lhs(key: jax.Array, n: int, d: int, n_candidates: int = 32,
                dtype=jnp.float64) -> jnp.ndarray:
    """Best-of-k maximin LHS — a vmapped stand-in for lhs::optimumLHS
    (which runs a serial columnwise swap optimization): draw `n_candidates`
    random LHDs in one batch and keep the one with the largest minimum
    pairwise distance."""
    keys = jax.random.split(key, n_candidates)
    designs = jnp.stack([random_lhs(k, n, d, dtype) for k in keys])
    scores = jax.vmap(_min_dist)(designs)
    return designs[jnp.argmax(scores)]


def _s_criterion(x: jnp.ndarray) -> jnp.ndarray:
    """Sum of inverse squared pairwise distances (minimize — the
    S-optimality surrogate lhs::optimumLHS's CP algorithm improves)."""
    n = x.shape[0]
    d2 = jnp.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
    d2 = d2 + jnp.eye(n, dtype=x.dtype)           # diagonal contributes n
    return jnp.sum(1.0 / d2) - n


def optimum_lhs(key: jax.Array, n: int, d: int, max_sweeps: int = 2,
                dtype=jnp.float64) -> jnp.ndarray:
    """Columnwise-pairwise swap-optimized LHS — the batched equivalent of
    `lhs::optimumLHS` (`Batch Sequential ME Design.R:899,935`): start from a
    random LHD and, column by column, repeatedly apply the best
    S-criterion-improving swap of two entries.

    Where R's CP algorithm walks the n(n-1)/2 swaps of a column serially
    and accepts improvements one at a time, here every candidate swap of a
    column is scored as ONE vmapped batch and the argmin applied, iterated
    until the column admits no improvement (a steepest-descent CP — at
    least as strong per sweep as the serial first-improvement walk).
    Shapes are static; the whole search jits.
    """
    x = random_lhs(key, n, d, dtype)
    ii, jj = jnp.triu_indices(n, k=1)             # all swap pairs (static)

    def swap_col(x, c, i, j):
        col = x[:, c]
        col = col.at[i].set(x[j, c]).at[j].set(x[i, c])
        return x.at[:, c].set(col)

    def best_swap_round(x, c):
        cands = jax.vmap(lambda i, j: swap_col(x, c, i, j))(ii, jj)
        scores = jax.vmap(_s_criterion)(cands)
        b = jnp.argmin(scores)
        better = scores[b] < _s_criterion(x)
        return jnp.where(better, cands[b], x), better

    def column_pass(x, c):
        def body(state):
            x, _, it = state
            x, improved = best_swap_round(x, c)
            return x, improved, it + 1

        def cond(state):
            _, improved, it = state
            return improved & (it < n)

        x, _, _ = jax.lax.while_loop(cond, body, (x, jnp.asarray(True), 0))
        return x

    for _ in range(max_sweeps):
        for c in range(d):
            x = column_pass(x, c)
    return x
