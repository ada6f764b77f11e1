"""Profile likelihood and transformed log-posterior for the combined GP.

Reference semantics (`1D Codes and Designs/1D Combined GP Public.R:397-444,
609-641`):

    beta_hat   = 1'R^{-1}y / 1'R^{-1}1                    (GLS intercept)
    sigma2_hat = (y-beta 1)'R^{-1}(y-beta 1) / n          (plug-in variance)
    loglike    = dmnorm(y; beta 1, (p^2+(1-p)^2) sigma2 R)
    logpost    = loglike + log-Jacobian + log-prior

Everything is one Cholesky + triangular solves (no explicit
R^{-1}); a singular R yields NaN which flows to logpost = -inf, turning the
reference's try/retry exception handling (`1D...Public.R:687-693`) into pure
dataflow that the Metropolis kernel treats as a rejection.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ccgp_tpu.models.combination import (
    MixtureSpec, MixParams, mixed_gram, mix_weights, unpack)
from ccgp_tpu.ops import linalg
from ccgp_tpu.ops.gp import gls_beta, sigma2_mle, profile_nll  # re-export


class LogPost(NamedTuple):
    """Value + per-evaluation byproducts cached for downstream prediction."""

    val: jnp.ndarray      # log-posterior (non-finite == invalid proposal)
    beta: jnp.ndarray     # GLS intercept at these parameters
    chol: jnp.ndarray     # lower Cholesky of R_mix (the factor cache)
    params: MixParams     # constrained parameters


def make_logpost(
    spec: MixtureSpec,
    x: jnp.ndarray,
    y: jnp.ndarray,
    sigma2,
    theta1_prior=None,
    theta2_prior=None,
    p_prior=None,
    jitter: float = 0.0,
    whiten: bool = False,
):
    """Build logpost(z) for unconstrained z, closing over data and priors.

    * theta1_prior / theta2_prior apply to the constrained theta1/theta2
      entries of MixParams (theta2 is lambda in tied/lambda modes);
      anisotropic theta1 priors apply elementwise (the reference uses iid
      per-axis lognormals, `2D...Anisotropic Public.R:462`).
    * p_prior defaults to flat on (0,1).
    * whiten=True computes the Gaussian quadratic form by whitening the
      centered residual explicitly — one extra triangular solve of
      y - beta*1 — instead of the bordered identity qyy - qoy^2/qoo.
      The bordered form subtracts two large near-equal sums, which in f32
      at n >= 768 loses ~0.17 relative digits of quad to cancellation
      (DESIGN.md; adjudicated vs a CPU-f64 oracle in
      scripts/verify_whiten_oracle.py); the whitened form squares a
      residual that is computed BEFORE it becomes small, so it keeps full
      relative accuracy. Default off: at the bench sizes (n <= 512 f32)
      the bordered path is exact enough and one solve cheaper.
    """
    y = jnp.asarray(y)
    n = y.shape[-1]

    log2pi = math.log(2.0 * math.pi)

    def logpost(z: jnp.ndarray) -> LogPost:
        params, log_jac = unpack(spec, z)
        r = mixed_gram(spec, x, params)
        # ONE bordered factorization yields the factor, logdet and all
        # quadratic forms — no triangular solves in this hot path (the
        # Metropolis loop evaluates this thousands of times sequentially,
        # and a small triangular solve is as latency-bound as the
        # factorization itself). Algebra identical to gls_beta +
        # mvn_logpdf_chol: beta = qoy/qoo, quad = qyy - qoy^2/qoo.
        q = linalg.bordered_cholesky_quadratics(r, y, jitter)
        chol = q["chol"]
        beta = q["qoy"] / q["qoo"]
        if whiten:
            w = linalg.tri_solve(chol, y - beta)
            quad = jnp.sum(w * w, axis=-1)
        else:
            quad = q["qyy"] - q["qoy"] ** 2 / q["qoo"]
        _, _, s = mix_weights(params.p)
        log_scale = jnp.log(s * sigma2)
        loglike = -0.5 * (n * log2pi + q["logdet"] + n * log_scale
                          + quad * jnp.exp(-log_scale))

        log_prior = jnp.zeros_like(loglike)
        if theta1_prior is not None:
            lp1 = theta1_prior.log_kernel(params.theta1)
            log_prior = log_prior + (jnp.sum(lp1, axis=-1)
                                     if spec.anisotropic else lp1)
        if theta2_prior is not None:
            log_prior = log_prior + theta2_prior.log_kernel(params.theta2)
        if p_prior is not None:
            log_prior = log_prior + p_prior.log_kernel(params.p)

        val = loglike + log_jac + log_prior
        # non-finite Cholesky (singular R) => -inf: proposal auto-rejected
        ok = jnp.isfinite(val)
        val = jnp.where(ok, val, -jnp.inf)
        return LogPost(val=val, beta=beta, chol=chol, params=params)

    return logpost


def make_logpost_batch(
    spec: MixtureSpec,
    x: jnp.ndarray,
    y: jnp.ndarray,
    sigma2,
    theta1_prior=None,
    theta2_prior=None,
    p_prior=None,
    jitter: float = 0.0,
    whiten: bool = False,
):
    """Batched sibling of `make_logpost`: f(Z (K, dim)) -> (vals, betas).

    whiten=True (see `make_logpost`): the cancellation-free whitened
    quadratic — batched explicit factorization + triangular solves instead
    of the quadratics kernels (which accumulate the same bordered sums
    in-register). For f32 chains at n >= 768 where qoy cancellation costs
    ~0.17 relative; slower, so default off.

    Same math, but the K Gram factorizations run as ONE explicit batch
    (`ops.gp.chol_quadratics`) instead of a vmap of single evaluations.

    Only (val, beta) are returned — exactly what the sampler consumes;
    rejected candidates' factors are never materialized.
    """
    from ccgp_tpu.ops.gp import chol_quadratics

    y = jnp.asarray(y)
    n = y.shape[-1]
    log2pi = math.log(2.0 * math.pi)

    def logpost_batch(zs: jnp.ndarray):
        params, log_jac = jax.vmap(lambda z: unpack(spec, z))(zs)
        kk = zs.shape[0]
        if whiten:
            # cancellation-free path: explicit batched factorization +
            # whitened residual (the quadratics kernels accumulate the
            # same bordered sums the default path subtracts, so opting
            # out of cancellation means opting out of them too)
            r = jax.vmap(lambda p: mixed_gram(spec, x, p))(params)
            chol = linalg.jitter_cholesky(r, jitter)
            wy = linalg.tri_solve(chol, jnp.broadcast_to(y, (kk, n)))
            wo = linalg.tri_solve(chol, jnp.ones((kk, n), y.dtype))
            beta = jnp.sum(wo * wy, axis=-1) / jnp.sum(wo * wo, axis=-1)
            # center BEFORE whitening (third solve): `wy - beta*wo`
            # subtracts two large near-equal whitened vectors and loses
            # the same digits the bordered form does — centering y in the
            # original space first keeps the residual O(signal) before any
            # large value is formed (oracle-measured 7x at y-offset 1000,
            # scripts/verify_whiten_oracle.py)
            w = linalg.tri_solve(chol, y[None, :] - beta[:, None])
            quad = jnp.sum(w * w, axis=-1)
            logdet = linalg.chol_logdet(chol)
        else:
            r = jax.vmap(lambda p: mixed_gram(spec, x, p))(params)  # (K,n,n)
            # R_mix is a correlation matrix (unit diagonal), so the
            # dispatcher's absolute jitter equals make_logpost's
            # mean-diagonal-relative jitter exactly.
            q = chol_quadratics(r, y, jitter=jitter)
        if not whiten:
            beta = q["qoy"] / q["qoo"]
            quad = q["qyy"] - q["qoy"] ** 2 / q["qoo"]
            logdet = q["logdet"]
        _, _, s = mix_weights(params.p)
        log_scale = jnp.log(s * sigma2)
        loglike = -0.5 * (n * log2pi + logdet + n * log_scale
                          + quad * jnp.exp(-log_scale))

        log_prior = jnp.zeros_like(loglike)
        if theta1_prior is not None:
            lp1 = theta1_prior.log_kernel(params.theta1)
            log_prior = log_prior + (jnp.sum(lp1, axis=-1)
                                     if spec.anisotropic else lp1)
        if theta2_prior is not None:
            log_prior = log_prior + theta2_prior.log_kernel(params.theta2)
        if p_prior is not None:
            log_prior = log_prior + p_prior.log_kernel(params.p)

        val = loglike + log_jac + log_prior
        val = jnp.where(jnp.isfinite(val), val, -jnp.inf)
        return val, beta

    return logpost_batch


def make_mh_rounds(
    spec: MixtureSpec,
    x: jnp.ndarray,
    y: jnp.ndarray,
    sigma2,
    theta1_prior=None,
    theta2_prior=None,
    p_prior=None,
    jitter: float = 0.0,
    whiten: bool = False,
):
    """R whole speculative Metropolis rounds per evaluation:
    f(z, lp_val, lp_beta, deltas (R*K, dim), log_u (R, K)) -> dict with

      rec       (R, dim+2) per-round post-state rows [z | beta | logpost]
                (row r repeats the previous state when round r rejected)
      acc       (R,) bool    per-round acceptance flags
      consumed  (R,) int32   proposals consumed per round
      z_fin (dim,), val_fin, beta_fin: state after all R rounds

    On a GPU, for models and shapes inside the CUDA kernel's envelope
    (`ops.mh_rounds_gpu.use_kernel`: SE/SE mixture, float32, K bordered
    Grams in one block's shared memory), the R rounds run as ONE kernel
    launch. Everywhere else they run as a lax.scan of the batched-logpost
    evaluation. Both consume the random stream identically, so chains
    match the one-round speculative body draw-for-draw up to float
    rounding.
    whiten=True always takes the scan (the kernel accumulates the bordered
    quadratics whose cancellation whiten avoids).
    """
    from ccgp_tpu.ops import mh_rounds_gpu

    y = jnp.asarray(y)
    n, d = x.shape[-2], x.shape[-1]
    lp_batch = make_logpost_batch(spec, x, y, sigma2,
                                  theta1_prior=theta1_prior,
                                  theta2_prior=theta2_prior,
                                  p_prior=p_prior, jitter=jitter,
                                  whiten=whiten)
    model = (None if whiten else mh_rounds_gpu.rounds_model(
        spec, theta1_prior, theta2_prior, p_prior, jitter))

    def mh_rounds(z, lp_val, lp_beta, deltas, log_u):
        rr, kk = log_u.shape
        if mh_rounds_gpu.use_kernel(model, n, d, kk, x.dtype):
            return mh_rounds_gpu.mh_rounds_gpu(model, x, y, z, lp_val,
                                               lp_beta, sigma2, deltas,
                                               log_u)

        def step(carry, rk):
            zc, lpv, lpb = carry
            drow, lu = rk
            cands = zc[None, :] + drow
            vals, betas = lp_batch(cands)
            acc = (vals - lpv) > lu
            any_acc = jnp.any(acc)
            first = jnp.argmax(acc)
            consumed = jnp.where(any_acc, first + 1, kk).astype(jnp.int32)
            z_n = jnp.where(any_acc, cands[first], zc)
            v_n = jnp.where(any_acc, vals[first], lpv)
            b_n = jnp.where(any_acc, betas[first], lpb)
            row = jnp.concatenate([z_n, b_n[None], v_n[None]])
            return (z_n, v_n, b_n), (row, any_acc, consumed)

        (zf, vf, bf), (rows, accs, cons) = jax.lax.scan(
            step, (z, lp_val, lp_beta),
            (deltas.reshape(rr, kk, -1), log_u))
        return {"rec": rows, "acc": accs, "consumed": cons,
                "z_fin": zf, "val_fin": vf, "beta_fin": bf}

    return mh_rounds
