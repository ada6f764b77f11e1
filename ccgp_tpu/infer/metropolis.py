"""Laplace-seeded random-walk Metropolis with Geweke stopping.

Reference semantics (`1D Codes and Designs/1D Combined GP Public.R:657-719`):

* proposal: fixed multivariate normal centered at the current state with
  covariance sqrt(2) * V_hat, where V_hat is the Laplace-approximation
  covariance (`:669,690`); the chain starts at the Laplace mode.
* accepted-only recording: rejected proposals are *retried without
  recording the current state* — the stored chain is the subsequence of
  accepted moves (reference quirk 2.7-1). `record="all"` gives the textbook
  MH chain instead.
* singular covariance at a proposal: the reference redraws until R is
  invertible (`:687-693`); here a singular Gram yields logpost = -inf and
  is rejected — the same Markov kernel, branch-free.
* stopping: after `samp_size` accepted draws, every `batch_size` further
  acceptances run a Geweke stationarity test on the trailing `samp_size`
  window; sampling halts when min-over-parameters p-value >= alpha_geweke,
  or after `n_max` recorded draws (`:684,707-712`).

Design: one `lax.while_loop` whose carry holds the fixed-size sample
buffers; the Geweke diagnostic runs on-device (`lax.cond`-gated), so an
entire chain is a single jitted computation. Multiple chains = vmap over
(start, key) — each chain stops at its own Geweke time, with masked
buffers. Per-draw R^{-1} caches are NOT stored (the reference hauls n^2
floats per draw through a data frame, `:729-783`); factorizations are
recomputed batched at prediction time.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ccgp_tpu.infer.geweke import geweke_pvalue
from ccgp_tpu.infer.laplace import laplace, LaplaceFit

# default warm-phase chunk size (rounds per call while no Geweke check
# boundary is reachable)
ROUNDS_PER_CALL_WARM = 120


class MetropolisResult(NamedTuple):
    samples: jnp.ndarray     # (n_max, dim) unconstrained draws (ring buffer)
    betas: jnp.ndarray       # (n_max,) GLS intercept per recorded draw
    logposts: jnp.ndarray    # (n_max,) log-posterior per recorded draw
    n_recorded: jnp.ndarray  # draws actually recorded (<= n_max)
    n_proposals: jnp.ndarray
    n_accepted: jnp.ndarray
    pvalue: jnp.ndarray      # final Geweke p-value
    converged: jnp.ndarray   # stopped via Geweke (vs. hitting n_max)
    laplace: LaplaceFit
    # speculative ROUNDS executed (each evaluates all K candidates as one
    # batched kernel step regardless of how many proposals it consumes) —
    # the honest kernel-work unit for perf tables: n_proposals counts
    # CONSUMED candidates (up to the first acceptance), so high-acceptance
    # chains make ms/proposal overstate kernel cost. None for the plain
    # K=1 driver, where rounds == n_proposals
    n_rounds: jnp.ndarray | None = None

    def retained(self, samp_size: int):
        """Last `samp_size` recorded draws — the reference's
        `samp[(k-samp.size):(k-1)]` slice (`1D...Public.R:717`).

        If the chain recorded fewer than `samp_size` draws (it hit the
        proposal cap without converging), indices clamp into the recorded
        range so the window repeats real draws instead of returning
        uninitialized buffer rows; `converged`/`n_recorded` flag the
        degenerate case to callers.
        """
        hi = jnp.maximum(self.n_recorded - 1, 0)
        idx = jnp.clip(self.n_recorded - samp_size + jnp.arange(samp_size),
                       0, hi)
        return self.samples[idx], self.betas[idx], self.logposts[idx]

    def chain_ok(self, samp_size: int) -> jnp.ndarray:
        """Healthy-chain flag: Geweke-converged AND the retained window is
        fully backed by real draws (no clamped duplication in `retained`).
        The reference can't hit the under-fill case — it loops until Geweke
        passes or N.max records (`1D...Public.R:684-713`); the bounded
        `max_proposals` here introduces it, so callers must check."""
        return self.converged & (self.n_recorded >= samp_size)


def metropolis(
    logpost: Callable,
    start: jnp.ndarray,
    key: jax.Array,
    n_max: int,
    samp_size: int,
    batch_size: int = 20,
    alpha_geweke: float = 0.5,
    record: str = "accepted",       # 'accepted' (reference) | 'all'
    proposal_cov_scale: float = 1.4142135623730951,  # sqrt(2), ref :690
    laplace_maxiter: int = 100,
    max_proposals: int | None = None,
    laplace_fit: LaplaceFit | None = None,
    speculative: int = 0,
    logpost_batch: Callable | None = None,
    mh_rounds: Callable | None = None,
    rounds_per_call: int = 20,
    rounds_per_call_warm: int = ROUNDS_PER_CALL_WARM,
) -> MetropolisResult:
    """Run one chain. `logpost(z)` must return an object with `.val` (scalar
    log-posterior; -inf for invalid) and `.beta`.

    laplace_fit: pass a precomputed/checkpointed Laplace approximation to
    skip the mode search and RESUME sampling — the chain then starts at
    `start` (e.g. the last retained draw of a saved fit) with the saved
    proposal covariance, instead of re-optimizing to the mode.

    speculative: with K = speculative > 1, each loop iteration draws K
    proposals from the CURRENT state, evaluates their log-posteriors as one
    batched Cholesky sweep, and consumes the prefix up to (and including)
    the first acceptance; the rest are discarded. Because a rejected
    random-walk proposal leaves the state unchanged, the K candidates are
    i.i.d. draws from the same proposal distribution the sequential
    algorithm would use — the Markov kernel is EXACTLY the reference's
    (`1D...Public.R:684-713`), only the evaluation is batched (one wide
    batched factorization instead of ~1/acc_rate latency-bound sequential
    ones). Requires record='accepted' (rejections
    are never recorded, so discarding unused candidates loses nothing).

    logpost_batch: optional f(Z (K, dim)) -> (vals (K,), betas (K,)) used
    by the speculative body instead of `jax.vmap(logpost)`. Pass
    `models.likelihood.make_logpost_batch(...)` so the K factorizations
    run as one explicit batch.

    mh_rounds: optional CHUNKED driver (`models.likelihood.make_mh_rounds`)
    evaluating `rounds_per_call` whole rounds per call — on a GPU one
    CUDA kernel launch per chunk inside its envelope. The chunk RNG
    reproduces the per-round
    stream exactly (sequential key splits, batched generation) and
    Geweke stopping / caps are applied with per-round truncation, so the
    chain is draw-for-draw identical to the one-round bodies
    (tests/test_mh_rounds.py). Takes precedence over logpost_batch.
    `rounds_per_call` is clamped to `batch_size` so a chunk can cross at
    most one Geweke check boundary.

    rounds_per_call_warm: chunk size of the WARM phase. A Geweke check can
    only fire at record position >= samp_size, so while
    k_rec + rounds_per_call_warm < samp_size NO round of a chunk can reach
    a check boundary and the driver runs big check-free chunks (one
    mh_rounds call + one slab landing per `rounds_per_call_warm` rounds, no
    conditional); the check-aware `rounds_per_call` loop takes over for the
    tail. The per-round random stream depends only on the sequential key
    splits, never on chunk boundaries, so the chain is bit-identical for
    any warm size (the bench chain's ~90% of rounds sit below samp_size —
    this deletes most of the per-chunk dispatch/conditional overhead).
    """
    if record not in ("accepted", "all"):
        raise ValueError(record)
    if speculative and speculative > 1 and record != "accepted":
        raise ValueError("speculative proposals need record='accepted'")
    dim = start.shape[-1]
    dtype = start.dtype
    if max_proposals is None:
        max_proposals = 50 * n_max

    if laplace_fit is None:
        fit = laplace(lambda z: logpost(z).val, start,
                      maxiter=laplace_maxiter)
        z0 = fit.mode
    else:
        fit = laplace_fit
        z0 = start
    prop_chol = jnp.linalg.cholesky(proposal_cov_scale * fit.cov)

    lp0 = logpost(z0)

    # ONE packed record buffer [z | beta | logpost] per row: a single
    # unconditional dynamic-update-slice per round replaces three
    # buffer-wide jnp.where selects + three scatters. Rows are written every
    # round: when nothing is recorded the row index does not advance, so
    # the slot is overwritten by the next real record and rows >= k_rec
    # are never read (`retained` clamps into the recorded range).
    packed0 = jnp.zeros((n_max, dim + 2), dtype)

    def pack_row(z_new, beta_new, val_new):
        return jnp.concatenate([z_new, beta_new[None], val_new[None]])

    def write_row(P, row, z_new, beta_new, val_new):
        return jax.lax.dynamic_update_slice(
            P, pack_row(z_new, beta_new, val_new)[None, :],
            (row, jnp.zeros((), row.dtype)))

    def do_geweke(P, k_rec):
        window = jax.lax.dynamic_slice_in_dim(P, k_rec - samp_size,
                                              samp_size)
        return geweke_pvalue(window[:, :dim])

    def cond(state):
        k_rec, n_prop, pv = state[1], state[2], state[8]
        return (k_rec < n_max) & (pv < alpha_geweke) & (n_prop < max_proposals)

    def body(state):
        (key, k_rec, n_prop, n_acc, z, lp_val, lp_beta, P, pv,
         n_rnd) = state
        key, k1, k2 = jax.random.split(key, 3)
        eps = jax.random.normal(k1, (dim,), dtype)
        cand = z + prop_chol @ eps
        lp_c = logpost(cand)
        log_u = jnp.log(jax.random.uniform(k2, dtype=dtype))
        accept = (lp_c.val - lp_val) > log_u

        z_new = jnp.where(accept, cand, z)
        val_new = jnp.where(accept, lp_c.val, lp_val)
        beta_new = jnp.where(accept, lp_c.beta, lp_beta)

        if record == "accepted":
            rec = accept
        else:
            rec = jnp.asarray(True)
        P = write_row(P, k_rec, z_new, beta_new, val_new)
        k_rec = k_rec + rec.astype(k_rec.dtype)
        n_acc = n_acc + accept.astype(n_acc.dtype)
        n_prop = n_prop + 1

        check = rec & (k_rec >= samp_size) & (k_rec % batch_size == 0)
        pv = jax.lax.cond(check, lambda: do_geweke(P, k_rec), lambda: pv)
        return (key, k_rec, n_prop, n_acc, z_new, val_new, beta_new,
                P, pv, n_rnd + 1)

    K = int(speculative) if speculative else 1

    def body_spec(state):
        (key, k_rec, n_prop, n_acc, z, lp_val, lp_beta, P, pv,
         n_rnd) = state
        key, k1, k2 = jax.random.split(key, 3)
        eps = jax.random.normal(k1, (K, dim), dtype)
        cands = z[None, :] + eps @ prop_chol.T
        # one batched Cholesky sweep; keep only (val, beta) per candidate
        if logpost_batch is not None:
            vals, betas = logpost_batch(cands)
        else:
            vals, betas = jax.vmap(
                lambda c: (lambda o: (o.val, o.beta))(logpost(c)))(cands)
        log_u = jnp.log(jax.random.uniform(k2, (K,), dtype=dtype))
        acc = (vals - lp_val) > log_u
        any_acc = jnp.any(acc)
        first = jnp.argmax(acc)                   # first acceptance (0 if none)
        consumed = jnp.where(any_acc, first + 1, K)

        z_new = jnp.where(any_acc, cands[first], z)
        val_new = jnp.where(any_acc, vals[first], lp_val)
        beta_new = jnp.where(any_acc, betas[first], lp_beta)
        P = write_row(P, k_rec, z_new, beta_new, val_new)
        k_rec = k_rec + any_acc.astype(k_rec.dtype)
        n_acc = n_acc + any_acc.astype(n_acc.dtype)
        n_prop = n_prop + consumed.astype(n_prop.dtype)

        check = any_acc & (k_rec >= samp_size) & (k_rec % batch_size == 0)
        pv = jax.lax.cond(check, lambda: do_geweke(P, k_rec), lambda: pv)
        return (key, k_rec, n_prop, n_acc, z_new, val_new, beta_new,
                P, pv, n_rnd + 1)

    # ---- chunked multi-round driver (mh_rounds): RR rounds per loop
    # iteration, one mh_rounds call + one record-slab write each ---------
    RR = int(rounds_per_call)
    if mh_rounds is not None and K > 1:
        if record != "accepted":
            raise ValueError("mh_rounds needs record='accepted'")
        # the <=1-Geweke-boundary-per-chunk truncation argument needs the
        # chunk's max new records (RR) to fit inside one check interval
        RR = min(RR, batch_size)
        RW = max(RR, int(rounds_per_call_warm or 0))

        # +RW slack rows for chunk overshoot, +1 scratch row that rejected
        # rounds' scatter writes land in (never read)
        Pc0 = jnp.zeros((n_max + RW + 1, dim + 2), dtype)

        def rng_step(k, _):
            k, k1, k2 = jax.random.split(k, 3)
            return k, (k1, k2)

        def chunk_keys(k, rr: int):
            # the per-chunk SEQUENTIAL key-split chain, unrolled so XLA
            # fuses it (named so a profile attributes its device time)
            with jax.named_scope("split_chain"):
                k, (k1s, k2s) = jax.lax.scan(rng_step, k, None, length=rr,
                                             unroll=True)
            return k, k1s, k2s

        def make_body(rr: int, check: bool):
            """Chunk body for rr rounds; check=False elides the Geweke
            conditional entirely (legal only while no round of the chunk
            can reach record position samp_size)."""

            def body_c(state):
                (key, k_rec, n_prop, n_acc, z, lpv, lpb, P, pv,
                 n_rnd) = state
                # chunk RNG: the EXACT per-round stream (sequential key
                # splits via scan, then batched generation per round key —
                # values identical to the one-round bodies')
                key, k1s, k2s = chunk_keys(key, rr)
                eps = jax.vmap(
                    lambda k1: jax.random.normal(k1, (K, dim), dtype))(k1s)
                log_u = jax.vmap(lambda k2: jnp.log(
                    jax.random.uniform(k2, (K,), dtype=dtype)))(k2s)
                deltas = eps.reshape(rr * K, dim) @ prop_chol.T

                out = mh_rounds(z, lpv, lpb, deltas, log_u)
                acc_i = out["acc"].astype(jnp.int32)
                cum_acc = jnp.cumsum(acc_i)
                cum_con = jnp.cumsum(out["consumed"])
                prev_acc = cum_acc - acc_i
                prev_con = cum_con - out["consumed"]
                # a round ran iff every cap held BEFORE it — always a
                # prefix
                runnable = (((n_prop + prev_con) < max_proposals)
                            & ((k_rec + prev_acc) < n_max))
                pos = k_rec + cum_acc

                # land accepted rounds' post-state rows at their record
                # positions first (the Geweke window reads P). Accepted
                # rows are COMPACTED to the slab front by ONE gather
                # (stable order), then ONE dynamic-update-slice lands the
                # slab at k_rec instead of a per-row scatter. Rejected rows
                # in the slab tail and any beyond-prefix rows are scratch
                # that later chunks overwrite from the truncated k_rec.
                idx_r = jnp.arange(rr)
                order = jnp.argsort(jnp.where(out["acc"], idx_r,
                                              rr + idx_r))
                P = jax.lax.dynamic_update_slice(
                    P, out["rec"][order], (k_rec, 0))

                if check:
                    check_round = (runnable & out["acc"]
                                   & (pos >= samp_size)
                                   & (pos % batch_size == 0))
                    has_check = jnp.any(check_round)
                    first_chk = jnp.argmax(check_round)
                    pos_chk = pos[first_chk]
                    pv = jax.lax.cond(has_check,
                                      lambda: do_geweke(P, pos_chk),
                                      lambda: pv)
                    stopped = has_check & (pv >= alpha_geweke)
                    valid = runnable & jnp.where(stopped,
                                                 idx_r <= first_chk, True)
                else:
                    valid = runnable
                n_acc_c = jnp.sum(jnp.where(valid, acc_i, 0))
                n_con_c = jnp.sum(jnp.where(valid, out["consumed"], 0))
                n_rnd_c = jnp.sum(valid.astype(n_rnd.dtype))
                return (key, k_rec + n_acc_c, n_prop + n_con_c,
                        n_acc + n_acc_c, out["z_fin"], out["val_fin"],
                        out["beta_fin"], P, pv, n_rnd + n_rnd_c)

            return body_c

        def cond_c(state):
            k_rec, n_prop, pv = state[1], state[2], state[8]
            return ((k_rec < n_max) & (pv < alpha_geweke)
                    & (n_prop < max_proposals))

        def cond_free(rr: int):
            # max record position an rr-round chunk can reach is
            # k_rec + rr: strictly below samp_size means NO check boundary
            # is reachable, so eliding the Geweke conditional cannot
            # change the chain
            def cond(state):
                k_rec, n_prop, pv = state[1], state[2], state[8]
                return ((k_rec + rr < samp_size) & (k_rec < n_max)
                        & (pv < alpha_geweke) & (n_prop < max_proposals))

            return cond

        init_c = (key, jnp.asarray(0), jnp.asarray(0), jnp.asarray(0),
                  z0, lp0.val, lp0.beta, Pc0, jnp.asarray(0.0, dtype),
                  jnp.asarray(0))
        # three phases, all over the SAME per-round stream (chunk size and
        # check elision never change which rounds run — only how they are
        # batched): check-free 120-round warm chunks, then check-free
        # 20-round chunks up to the last boundary-free window, then the
        # check-aware tail
        warm = jax.lax.while_loop(cond_free(RW), make_body(RW, check=False),
                                  init_c)
        mid = (jax.lax.while_loop(cond_free(RR), make_body(RR, check=False),
                                  warm)
               if RR < RW else warm)
        (key, k_rec, n_prop, n_acc, z, lp_val, lp_beta, P, pv, n_rnd) = (
            jax.lax.while_loop(cond_c, make_body(RR, check=True), mid)
        )
        row_ids = jnp.arange(n_max)
        recorded = row_ids < k_rec
        return MetropolisResult(
            samples=P[:n_max, :dim], betas=P[:n_max, dim],
            logposts=jnp.where(recorded, P[:n_max, dim + 1], -jnp.inf),
            n_recorded=k_rec, n_proposals=n_prop, n_accepted=n_acc,
            pvalue=pv, converged=pv >= alpha_geweke, laplace=fit,
            n_rounds=n_rnd,
        )

    body_fn = body_spec if K > 1 else body
    init = (key, jnp.asarray(0), jnp.asarray(0), jnp.asarray(0),
            z0, lp0.val, lp0.beta, packed0, jnp.asarray(0.0, dtype),
            jnp.asarray(0))
    (key, k_rec, n_prop, n_acc, z, lp_val, lp_beta, P, pv, n_rnd) = (
        jax.lax.while_loop(cond, body_fn, init)
    )
    # unpack; rows >= n_recorded are scratch (never read by consumers) —
    # logposts there are forced back to -inf to keep the documented
    # "unrecorded rows are -inf" invariant for serialization round-trips
    row_ids = jnp.arange(n_max)
    recorded = row_ids < k_rec
    S = P[:, :dim]
    B = P[:, dim]
    L = jnp.where(recorded, P[:, dim + 1], -jnp.inf)
    return MetropolisResult(
        samples=S, betas=B, logposts=L, n_recorded=k_rec,
        n_proposals=n_prop, n_accepted=n_acc, pvalue=pv,
        converged=pv >= alpha_geweke, laplace=fit,
        n_rounds=n_rnd if K > 1 else n_prop,
    )
