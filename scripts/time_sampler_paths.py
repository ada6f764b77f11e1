"""Time the speculative sampler's GPU paths on the flagship workload.

    python scripts/time_sampler_paths.py [--reps 3] [--phases a,b,...]
                                         [--trace-dir DIR]

Needs a GPU. Two ways to run the same K = 4 speculative chain:

  chunked_xla     20 or 120 rounds per iteration, XLA lax.scan
  chunked_cuda    20 or 120 rounds per iteration, one CUDA launch each

and for each: compile seconds, end-to-end fit+predict seconds (median of
`--reps`, runs interleaved across variants), rounds and guards. Also: the
kernel against the XLA scan at n = 100 and at the envelope's largest n
for K = 4; one 120-round chunk through the kernel and through the scan;
the per-chunk key-split chain; each float32 product site with and
without precision=HIGHEST; optionally (`scaling`) one chunk across n and
K, and (`trace`) a profiler trace of one end-to-end run with the kernel.
Prints one JSON object per line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def emit(**kw):
    print(json.dumps(kw), flush=True)


def timed(fn, *args, reps: int = 10):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--phases", default="checks,chunks,split,e2e,precision",
                    help="comma list of checks, chunks, split, e2e, "
                         "precision, scaling, trace")
    ap.add_argument("--trace-dir", default="chiprun_out/trace")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {dev.platform!r}")
    from ccgp_tpu.experiments import flagship as F
    from ccgp_tpu.infer.laplace import laplace
    from ccgp_tpu.models import make_logpost
    from ccgp_tpu.models.likelihood import make_mh_rounds
    from ccgp_tpu.ops import mh_rounds_gpu as G

    where = {"card": card(), "kind": dev.device_kind,
             "count": len(jax.devices())}
    emit(phase="device", **where)
    t0 = time.perf_counter()
    G.build_library()
    emit(phase="nvcc", seconds=time.perf_counter() - t0)

    x, y, grid, y_true = F.inputs()
    pri = dict(theta1_prior=F.THETA1_PRIOR, theta2_prior=F.THETA2_PRIOR,
               jitter=F.JITTER)
    s2 = jnp.asarray(0.01, jnp.float32)
    rng = np.random.default_rng(0)

    # ---- kernel vs the XLA scan on identical inputs
    if "checks" in phases:
        for n in (100, 114):
            emit(phase="kernel_check", **F.kernel_check(n=n))

    def chunk(n, kk, rr):
        """One rr-round chunk, kernel vs scan, on the same inputs."""
        xs = jnp.asarray(F.design(n), jnp.float32)
        ys = jnp.asarray(F.response(np.asarray(xs)), jnp.float32)
        z = jnp.asarray([0.3, 0.5, -0.8, 1.7], jnp.float32)
        lz = make_logpost(F.SPEC, xs, ys, s2, **pri)(z)
        deltas = jnp.asarray(0.1 * rng.normal(size=(rr * kk, 4)),
                             jnp.float32)
        log_u = jnp.asarray(np.log(rng.uniform(size=(rr, kk))), jnp.float32)
        med = {}
        for path in ("cuda", "xla"):
            orig = G.use_kernel
            if path == "xla":
                G.use_kernel = lambda *a: False
            try:
                f = jax.jit(lambda *a: make_mh_rounds(
                    F.SPEC, xs, ys, s2, **pri)(*a))
                med[path], _ = timed(f, z, lz.val, lz.beta, deltas, log_u,
                                     reps=20)
            finally:
                G.use_kernel = orig
        emit(phase="chunk", n=n, k=kk, rr=rr,
             cuda_in_envelope=G.in_envelope(G.rounds_model(F.SPEC), n, 2,
                                            kk, jnp.float32),
             cuda_ms=med["cuda"] * 1e3, xla_ms=med["xla"] * 1e3,
             cuda_us_per_round=med["cuda"] * 1e6 / rr,
             xla_us_per_round=med["xla"] * 1e6 / rr)

    if "chunks" in phases:
        for rr in (20, 120):
            chunk(100, 4, rr)
    if "scaling" in phases:
        for n in (30, 60, 114):
            chunk(n, 4, 120)
        for kk in (1, 2):
            chunk(100, kk, 120)

    # ---- the per-chunk key-split chain alone (120 rounds), 100 chunks
    def chain100(key):
        def one(_, k):
            def st(k, _):
                k, k1, k2 = jax.random.split(k, 3)
                return k, (k1, k2)
            k, _ = jax.lax.scan(st, k, None, length=120, unroll=True)
            return k
        return jax.lax.fori_loop(0, 100, one, key)

    if "split" in phases:
        med, _ = timed(jax.jit(chain100), jax.random.PRNGKey(0), reps=10)
        emit(phase="split_chain", us_per_120_round_chunk=med * 1e6 / 100)

    key = jax.random.PRNGKey(F.BAYES_KEY)
    if "trace" in phases:
        f = jax.jit(F.bayes_fit_predict)
        jax.block_until_ready(f(x, y, grid, key))
        with jax.profiler.trace(args.trace_dir):
            jax.block_until_ready(f(x, y, grid, key))
        emit(phase="trace", dir=args.trace_dir)
    if not phases & {"e2e", "precision"}:
        return

    # ---- end to end, both sampler paths, interleaved

    def variant(name):
        orig = G.use_kernel
        if name == "chunked_xla":
            G.use_kernel = lambda *a: False
        try:
            t0 = time.perf_counter()
            f = jax.jit(lambda *a: F.bayes_fit_predict(*a)).lower(
                x, y, grid, key).compile()
            comp = time.perf_counter() - t0
        finally:
            G.use_kernel = orig
        return f, comp

    names = ("chunked_xla", "chunked_cuda")
    progs = {}
    for nm in names:
        progs[nm] = variant(nm)
    times = {nm: [] for nm in names}
    outs = {}
    for _ in range(args.reps):
        for nm in names:
            t0 = time.perf_counter()
            outs[nm] = jax.block_until_ready(progs[nm][0](x, y, grid, key))
            times[nm].append(time.perf_counter() - t0)
    for nm in names if "e2e" in phases else ():
        try:
            g = F.bayes_guards(outs[nm], y_true)
            ok = True
        except AssertionError as e:
            g, ok = {"error": str(e)}, False
        emit(phase="end_to_end", path=nm, compile_s=progs[nm][1],
             median_s=statistics.median(times[nm]), runs_s=times[nm],
             guards_ok=ok, **g,
             peak_bytes=dev.memory_stats().get("peak_bytes_in_use"), **where)

    # ---- float32 products with and without precision=HIGHEST
    if "precision" not in phases:
        return
    from ccgp_tpu.infer.mle import kriging_mle_grid
    from ccgp_tpu.models.kriging import kriging_predict
    from ccgp_tpu.predict.factors import build_factors
    from ccgp_tpu.predict.posterior import predictive_moments

    zs = outs["chunked_cuda"]["zs"]
    s2f = outs["chunked_cuda"]["sigma2"]
    lpf = make_logpost(F.SPEC, x, y, s2f, **pri)
    betas = jax.jit(jax.vmap(lambda q: lpf(q).beta))(zs)
    fam = F.SPEC.kernel1
    mle = jax.jit(lambda: kriging_mle_grid(fam, x, y, jitter=F.JITTER))()
    eps = jnp.asarray(rng.normal(size=(480, 4)), jnp.float32)
    lap = jax.jit(lambda z: laplace(lambda q: lpf(q).val, z))(
        jnp.asarray(F.MCMC.start, jnp.float32))
    prop = jnp.linalg.cholesky(1.4142135623730951 * lap.cov)
    sites = {
        "predictive_moments": lambda: predictive_moments(
            F.SPEC, build_factors(F.SPEC, x, y, zs, betas, jitter=F.JITTER),
            x, grid, s2f),
        "kriging_predict": lambda: tuple(kriging_predict(
            fam, x, y, mle, grid)[:2]),
        "proposal_product": lambda: eps @ prop.T,
        "laplace_cov": lambda: laplace(lambda q: lpf(q).val,
                                       jnp.asarray(F.MCMC.start,
                                                   jnp.float32)).cov,
    }
    for nm, fn in sites.items():
        a = jax.tree_util.tree_leaves(jax.jit(lambda: fn())())
        with jax.default_matmul_precision("highest"):
            b = jax.tree_util.tree_leaves(jax.jit(lambda: fn())())
        diff = max(float(np.max(np.abs(np.asarray(u, np.float64)
                                       - np.asarray(v, np.float64))))
                   for u, v in zip(a, b))
        scale = max(float(np.max(np.abs(np.asarray(v)))) for v in b)
        emit(phase="precision", site=nm, max_abs_diff=diff, scale=scale)


if __name__ == "__main__":
    main()
