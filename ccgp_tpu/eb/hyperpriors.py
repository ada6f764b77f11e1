"""Empirical-Bayes hyperprior selection by quasi-Monte Carlo marginal
likelihood.

Reference (`2D Codes and Designs/2D Combined GP Isotropic Advanced.R:
548-600`; heat-exchanger variant with N=1000, tau=50 at `Heat Exchanger
Emulator/Combined GP Heat Exchanger.R:545-596`): for each candidate
(a1,b1,a2,b2) row of the hyperprior grid,

    ml = E_prior[ N(y; 0, sigma2_t R_mix + tau^2 J) ],   J = all-ones

approximated over Halton nodes p ~ U(0,1), theta_i = qigamma(p; a_i, b_i);
the tau^2 J term integrates the intercept out under a vague prior. The grid
row with the largest value wins.

Design: the reference evaluates 60 x 1728 (or 624 x 1000) dense
likelihoods in nested R loops with a progress bar; here all nodes of a row
are one vmapped batched-Cholesky sweep and rows run under lax.map (or
sharded over a device mesh via ccgp_tpu.parallel) — the workload is
embarrassingly parallel in both axes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ccgp_tpu.eb.halton import halton
from ccgp_tpu.models.combination import MixtureSpec, MixParams, mixed_gram
from ccgp_tpu.ops.gp import chol_quadratics
from ccgp_tpu.ops.special import invgamma_quantile

_LOG2PI = 1.8378770664093453


class HyperparChoice(NamedTuple):
    pars: jnp.ndarray         # winning (a1, b1, a2, b2)
    index: jnp.ndarray        # row index in the grid
    likelihoods: jnp.ndarray  # LOG marginal likelihood per grid row


def marginal_likelihood(
    spec: MixtureSpec,
    x: jnp.ndarray,
    y: jnp.ndarray,
    theta1_pars,
    theta2_pars,
    sigma2,
    nodes: jnp.ndarray,
    tau: float = 100.0,
    jitter: float = 0.0,
) -> jnp.ndarray:
    """Marginal likelihood for one (a1,b1) x (a2,b2) quadruplet.

    nodes: (N,) Halton/uniform p-values in (0,1); used simultaneously as the
    mixing weight p and (via the inverse-gamma quantile transform) to place
    theta1/theta2 — exactly the reference's node construction
    (`Advanced.R:557-560`). theta*_pars may be floats or traced scalars.

    Returns the LOG marginal likelihood (log of the node-averaged density;
    the raw average the reference uses underflows for bad hyperpriors).
    """
    a1, b1 = theta1_pars
    a2, b2 = theta2_pars
    p = nodes
    theta1 = invgamma_quantile(p, a1, b1)
    theta2 = invgamma_quantile(p, a2, b2)
    n = y.shape[-1]

    def cov_of(p_i, t1_i, t2_i):
        params = MixParams(p=p_i, theta1=t1_i, theta2=t2_i)
        s2t = sigma2 * (p_i * p_i + (1.0 - p_i) ** 2)
        return s2t * mixed_gram(spec, x, params) + tau * tau  # + tau^2 J

    covs = jax.vmap(cov_of)(p, theta1, theta2)        # (N, n, n)
    # the node sweep is one batched Cholesky
    q = chol_quadratics(covs, y, jitter=jitter)
    ll = -0.5 * (n * _LOG2PI + q["logdet"] + q["qyy"])
    ll = jnp.where(jnp.isfinite(ll), ll, -jnp.inf)
    # LOG of the node average: the reference averages raw densities
    # (`Advanced.R:574,577`), which underflows for poorly fitting
    # hyperpriors (certainly in f32); log-sum-exp preserves the argmax
    # with no underflow.
    return jax.scipy.special.logsumexp(ll) - jnp.log(float(len(p)))


def choose_hyperpars(
    spec: MixtureSpec,
    x: jnp.ndarray,
    y: jnp.ndarray,
    grid: np.ndarray,
    sigma2,
    n_nodes: int = 1728,
    tau: float = 100.0,
    jitter: float = 0.0,
) -> HyperparChoice:
    """Scan the (G, 4) hyperprior grid; return the argmax row.

    One jitted lax.map over rows; each row is a vmapped node sweep. For
    multi-chip sharding of the row axis see
    ccgp_tpu.parallel.sharded_hyperpar_scan.
    """
    nodes = jnp.asarray(halton(n_nodes, 1)[:, 0], x.dtype)
    grid_j = jnp.asarray(grid, x.dtype)

    def row_ml(row):
        return marginal_likelihood(spec, x, y, (row[0], row[1]),
                                   (row[2], row[3]), sigma2, nodes,
                                   tau=tau, jitter=jitter)

    likes = jax.lax.map(row_ml, grid_j)
    idx = jnp.argmax(likes)
    return HyperparChoice(pars=grid_j[idx], index=idx, likelihoods=likes)
