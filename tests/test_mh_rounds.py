"""Law-equality tests for the chunked multi-round Metropolis driver
(`infer.metropolis` mh_rounds path over `models.likelihood.make_mh_rounds`).

The chunked driver must reproduce the one-round-at-a-time speculative
sampler EXACTLY — same random stream, same records, same stopping point —
including the cap/stop edge cases where a chunk overshoots and truncates.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccgp_tpu.infer.metropolis import metropolis
from ccgp_tpu.models import MixtureSpec, InverseGamma, LogNormal, make_logpost
from ccgp_tpu.models.likelihood import make_logpost_batch, make_mh_rounds
from ccgp_tpu.ops import kernels


@pytest.fixture(scope="module")
def problem():
    spec = MixtureSpec(kernels.sqexp_family(), kernels.sqexp_family(),
                       dim=2, rough="tied", anisotropic=True)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(size=(16, 2)))
    y = jnp.sin(5 * x[:, 0]) + jnp.cos(3 * x[:, 1])
    t1p, t2p = LogNormal(-1, 1), InverseGamma(3, 4)
    s2 = jnp.asarray(0.05)
    kw = dict(theta1_prior=t1p, theta2_prior=t2p, jitter=1e-9)
    lp = make_logpost(spec, x, y, s2, **kw)
    lpb = make_logpost_batch(spec, x, y, s2, **kw)
    rounds = make_mh_rounds(spec, x, y, s2, **kw)
    return spec, x, y, s2, lp, lpb, rounds, kw


def _run_pair(lp, lpb, rounds, key, **kw):
    start = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    r1 = metropolis(lp, start, key, logpost_batch=lpb, speculative=4, **kw)
    r2 = metropolis(lp, start, key, mh_rounds=rounds, rounds_per_call=16,
                    speculative=4, **kw)
    return r1, r2


def _assert_identical(r1, r2):
    n = int(r1.n_recorded)
    assert int(r2.n_recorded) == n
    assert int(r2.n_proposals) == int(r1.n_proposals)
    assert int(r2.n_accepted) == int(r1.n_accepted)
    assert np.array_equal(np.asarray(r1.samples[:n]),
                          np.asarray(r2.samples[:n]))
    assert np.array_equal(np.asarray(r1.betas[:n]), np.asarray(r2.betas[:n]))
    assert np.array_equal(np.asarray(r1.logposts[:n]),
                          np.asarray(r2.logposts[:n]))
    assert float(r1.pvalue) == float(r2.pvalue)
    assert bool(r1.converged) == bool(r2.converged)
    # the rounds counter is law-equal too: the chunked driver counts
    # valid (runnable, pre-truncation) rounds, the one-round driver
    # counts body executions — same set by the prefix argument
    if r1.n_rounds is not None and r2.n_rounds is not None:
        assert int(r1.n_rounds) == int(r2.n_rounds)


def test_chunked_equals_sequential(problem):
    _, _, _, _, lp, lpb, rounds, _ = problem
    r1, r2 = _run_pair(lp, lpb, rounds, jax.random.PRNGKey(11),
                       n_max=400, samp_size=120, batch_size=20,
                       alpha_geweke=0.5)
    _assert_identical(r1, r2)


def test_chunked_geweke_stop_truncation(problem):
    # alpha tiny -> the FIRST Geweke check passes; the chunk that crosses
    # the boundary must truncate its surplus records to stop exactly there
    _, _, _, _, lp, lpb, rounds, _ = problem
    r1, r2 = _run_pair(lp, lpb, rounds, jax.random.PRNGKey(5),
                       n_max=400, samp_size=100, batch_size=20,
                       alpha_geweke=1e-9)
    assert bool(r1.converged)
    _assert_identical(r1, r2)
    assert int(r1.n_recorded) % 20 == 0   # stopped exactly at a boundary


def test_chunked_proposal_cap(problem):
    _, _, _, _, lp, lpb, rounds, _ = problem
    r1, r2 = _run_pair(lp, lpb, rounds, jax.random.PRNGKey(7),
                       n_max=400, samp_size=100, batch_size=20,
                       alpha_geweke=0.5, max_proposals=53)
    _assert_identical(r1, r2)
    assert int(r1.n_proposals) >= 53      # cap bound mid-chunk


def test_chunked_nmax_cap(problem):
    _, _, _, _, lp, lpb, rounds, _ = problem
    r1, r2 = _run_pair(lp, lpb, rounds, jax.random.PRNGKey(9),
                       n_max=37, samp_size=20, batch_size=20,
                       alpha_geweke=0.9999)
    _assert_identical(r1, r2)
    assert int(r1.n_recorded) == 37


def test_warm_phase_equals_sequential(problem):
    # rounds_per_call_warm < samp_size so the check-free warm loop
    # actually executes, covering the warm -> check-aware handoff: the
    # chain must stay bit-identical to the one-round speculative body
    _, _, _, _, lp, lpb, rounds, _ = problem
    start = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    key = jax.random.PRNGKey(11)
    kw = dict(n_max=400, samp_size=120, batch_size=20, alpha_geweke=0.5)
    r1 = metropolis(lp, start, key, logpost_batch=lpb, speculative=4, **kw)
    r2 = metropolis(lp, start, key, mh_rounds=rounds, rounds_per_call=16,
                    rounds_per_call_warm=48, speculative=4, **kw)
    _assert_identical(r1, r2)


def test_warm_phase_proposal_cap(problem):
    # the proposal cap lands INSIDE a warm (check-free) chunk: prefix
    # truncation must stop the chain at exactly the sequential point
    _, _, _, _, lp, lpb, rounds, _ = problem
    start = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    key = jax.random.PRNGKey(7)
    kw = dict(n_max=400, samp_size=120, batch_size=20, alpha_geweke=0.5,
              max_proposals=53)
    r1 = metropolis(lp, start, key, logpost_batch=lpb, speculative=4, **kw)
    r2 = metropolis(lp, start, key, mh_rounds=rounds, rounds_per_call=16,
                    rounds_per_call_warm=48, speculative=4, **kw)
    _assert_identical(r1, r2)
    assert int(r1.n_proposals) >= 53


def test_warm_phase_geweke_stop(problem):
    # alpha tiny -> the FIRST check (at pos samp_size) passes: the warm
    # loop must hand off to the check-aware loop exactly at the boundary
    # and stop there, identical to the sequential body. (With valid
    # configs samp_size <= n_max, so the n_max cap can never land inside
    # the warm phase — warm exits strictly below samp_size.)
    _, _, _, _, lp, lpb, rounds, _ = problem
    start = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    key = jax.random.PRNGKey(5)
    kw = dict(n_max=400, samp_size=100, batch_size=20, alpha_geweke=1e-9)
    r1 = metropolis(lp, start, key, logpost_batch=lpb, speculative=4, **kw)
    r2 = metropolis(lp, start, key, mh_rounds=rounds, rounds_per_call=16,
                    rounds_per_call_warm=32, speculative=4, **kw)
    assert bool(r1.converged)
    _assert_identical(r1, r2)
    assert int(r1.n_recorded) % 20 == 0


def test_chunk_rng_matches_per_round_stream():
    # the chunk generator (scan of splits + batched normal/uniform) must
    # emit the SAME values as the per-round split/normal/uniform sequence
    key = jax.random.PRNGKey(3)
    K, dim, R = 4, 4, 16
    dt = jnp.float64

    seq_eps, seq_lu = [], []
    k = key
    for _ in range(R):
        k, k1, k2 = jax.random.split(k, 3)
        seq_eps.append(jax.random.normal(k1, (K, dim), dt))
        seq_lu.append(jnp.log(jax.random.uniform(k2, (K,), dtype=dt)))

    def rng_step(k, _):
        k, k1, k2 = jax.random.split(k, 3)
        return k, (k1, k2)

    k_end, (k1s, k2s) = jax.lax.scan(rng_step, key, None, length=R)
    eps = jax.vmap(lambda kk: jax.random.normal(kk, (K, dim), dt))(k1s)
    lu = jax.vmap(lambda kk: jnp.log(
        jax.random.uniform(kk, (K,), dtype=dt)))(k2s)
    assert np.array_equal(np.asarray(eps), np.asarray(jnp.stack(seq_eps)))
    assert np.array_equal(np.asarray(lu), np.asarray(jnp.stack(seq_lu)))
    assert np.array_equal(np.asarray(k_end), np.asarray(k))


def test_mid_phase_equal_chunk_sizes(problem):
    # rounds_per_call == rounds_per_call_warm elides the mid loop (the
    # `RR < RW` guard): the driver must still be draw-identical to the
    # one-round body and to a config where the mid phase DOES run
    _, _, _, _, lp, lpb, rounds, _ = problem
    start = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    key = jax.random.PRNGKey(3)
    kw = dict(n_max=400, samp_size=120, batch_size=20, alpha_geweke=0.5)
    r1 = metropolis(lp, start, key, logpost_batch=lpb, speculative=4, **kw)
    r2 = metropolis(lp, start, key, mh_rounds=rounds, rounds_per_call=24,
                    rounds_per_call_warm=24, speculative=4, **kw)
    r3 = metropolis(lp, start, key, mh_rounds=rounds, rounds_per_call=8,
                    rounds_per_call_warm=96, speculative=4, **kw)
    _assert_identical(r1, r2)
    _assert_identical(r1, r3)
