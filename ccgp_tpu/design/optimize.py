"""Multistart maximum-entropy design search.

Reference (`Batch Sequential ME Designs/Batch Sequential ME Design.R:
883-949`): `n_starts` optimumLHS starts rescaled to [-1,1]^{n x d}, each
refined by a serial L-BFGS-B over the flattened coordinates, keep the best.

Design: all restarts refine as ONE vmapped bounded-BFGS batch; the
criterion itself is a batched Cholesky log-det, and for the second batch the
Schur complement reuses a single factorization of R_old across every
candidate evaluation of every restart (incremental log-det, the
BASELINE.json north-star requirement).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ccgp_tpu.design.entropy import me_criterion, augmented_me_criterion
from ccgp_tpu.design.lhs import optimum_lhs
from ccgp_tpu.models.combination import MixtureSpec, MixParams, mixed_gram
from ccgp_tpu.ops import linalg


class DesignResult(NamedTuple):
    design: jnp.ndarray       # (n, d) best design found
    log_entropy: jnp.ndarray  # logdet criterion value at the optimum
    score: jnp.ndarray        # raw minimized objective (criterion scale)


def _search(objective, key, n_pts: int, d: int, n_starts: int,
            box: Tuple[float, float], maxiter: int) -> DesignResult:
    lo, hi = box
    k = n_pts * d
    keys = jax.random.split(key, n_starts)
    # optimumLHS-strength starts (`Batch Sequential ME Design.R:899,935`
    # uses lhs::optimumLHS): columnwise-pairwise swap-optimized LHDs —
    # round 2's best-of-32 maximin stand-in left the second-batch golden
    # at 6/7 matched points
    starts = jnp.stack([
        lo + (hi - lo) * optimum_lhs(kk, n_pts, d).reshape(-1)
        for kk in keys
    ])
    from ccgp_tpu.infer.optim import multistart_minimize

    res = multistart_minimize(objective, starts,
                              lower=jnp.full((k,), lo),
                              upper=jnp.full((k,), hi), maxiter=maxiter)
    return res


def me_design(
    spec: MixtureSpec,
    params: MixParams,
    n_pts: int,
    d: int,
    key: jax.Array,
    n_starts: int = 25,
    box: Tuple[float, float] = (-1.0, 1.0),
    criterion: str = "logdet",
    jitter: float = 0.0,
    maxiter: int = 200,
) -> DesignResult:
    """First-batch ME design: maximize (log)det R_mix over the box."""

    def obj(flat):
        return me_criterion(spec, flat.reshape(n_pts, d), params,
                            criterion=criterion, jitter=jitter)

    res = _search(obj, key, n_pts, d, n_starts, box, maxiter)
    best = res.x.reshape(n_pts, d)
    ld = linalg.logdet_psd(mixed_gram(spec, best, params), jitter)
    return DesignResult(design=best, log_entropy=ld, score=res.fun)


def batch_me_design(
    spec: MixtureSpec,
    params: MixParams,
    d_old: jnp.ndarray,
    n_new: int,
    key: jax.Array,
    n_starts: int = 25,
    box: Tuple[float, float] = (-1.0, 1.0),
    criterion: str = "logdet",
    jitter: float = 0.0,
    maxiter: int = 200,
) -> DesignResult:
    """Second-batch augmented-entropy design given existing D_old."""
    d = d_old.shape[-1]
    r_old = mixed_gram(spec, d_old, params)
    chol_old = linalg.jitter_cholesky(r_old, jitter)

    def obj(flat):
        return augmented_me_criterion(spec, d_old, chol_old,
                                      flat.reshape(n_new, d), params,
                                      criterion=criterion, jitter=jitter)

    res = _search(obj, key, n_new, d, n_starts, box, maxiter)
    best = res.x.reshape(n_new, d)
    ld = -augmented_me_criterion(spec, d_old, chol_old, best, params,
                                 criterion="logdet", jitter=jitter)
    return DesignResult(design=best, log_entropy=ld, score=res.fun)
