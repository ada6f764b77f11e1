"""Smoke run of the main path on an NVIDIA GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sharded path on four cards

One card, in one process (a second JAX process on the card would find its
memory taken), phases in order:

  (a) device: the platform must be `gpu`, else exit non-zero with no
      result; prints the card's name and power limit (nvidia-smi);
  (b) MAP program of the flagship workload (`experiments.flagship`):
      batched chol_quadratics scans at B = 24, 128, 64, then prediction;
  (c) full-Bayes fit + predict through `fit_combined_gp` /
      `predict_combined_gp`: grid plug-in sigma^2, Laplace, speculative
      Metropolis (K = 4) at n_max 5000 / samp 1000, MC intervals on a
      25 x 25 lattice; guards RMSPE < 0.03, coverage >= 0.80, chain_ok,
      min-ESS >= 10; RMSPE and coverage beside a CPU float64 run of the
      same seed and design (a CPU-only child process);
  (d) the CUDA multi-round kernel against the XLA scan at n = 100 and at
      n = 114, the largest n its shared-memory envelope admits at K = 4.

`--four-cards` runs only the sharded path, each step on a 4-device mesh
against a 1-device mesh on the same card: the design sweep (16 seeded
14-point designs, a full fit each), the EB hyperprior scan (seeded
inverse-gamma grid, n = 64, d = 4) and the sharded posterior predict.

Every failure raises; the last line of standard output is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def timed_runs(fn, *args, reps: int = 3):
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, ts


def compile_timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    return exe, time.perf_counter() - t0


def phase_map(card: str):
    import numpy as np

    from ccgp_tpu.experiments import flagship as F

    x, y, grid, y_true = F.inputs()
    exe, comp = compile_timed(F.map_fit_predict, x, y, grid)
    (mean, var, z_map, s2), ts = timed_runs(exe, x, y, grid, reps=5)
    mean, var = np.asarray(mean, np.float64), np.asarray(var, np.float64)
    assert mean.shape == y_true.shape and np.isfinite(mean).all()
    assert np.isfinite(var).all() and np.isfinite(np.asarray(z_map)).all()
    rmspe = float(np.sqrt(np.mean((y_true - mean) ** 2)))
    assert rmspe < 0.02, f"MAP accuracy: rmspe={rmspe}"
    print(f"[map] design={F.DESIGN_NAME} n={F.N_TRAIN} rmspe={rmspe:.6f} "
          f"compile_s={comp:.2f} run_ms={[round(t * 1e3, 3) for t in ts]} "
          f"| {card}", flush=True)


def cpu_reference() -> dict:
    """The full-Bayes program on the CPU in float64, same seed and design,
    in a child process that never touches the card."""
    code = (
        "import json, jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import jax.numpy as jnp\n"
        "from ccgp_tpu.experiments import flagship as F\n"
        "x, y, grid, yt = F.inputs(jnp.float64)\n"
        "out = jax.jit(F.bayes_fit_predict)(x, y, grid, "
        "jax.random.PRNGKey(F.BAYES_KEY))\n"
        "print(json.dumps(F.bayes_guards(out, yt)))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=900)
    if r.returncode:
        raise RuntimeError(f"CPU float64 reference failed:\n{r.stderr}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def phase_bayes(card: str):
    import jax

    from ccgp_tpu.experiments import flagship as F

    x, y, grid, y_true = F.inputs()
    key = jax.random.PRNGKey(F.BAYES_KEY)
    exe, comp = compile_timed(F.bayes_fit_predict, x, y, grid, key)
    out, ts = timed_runs(exe, x, y, grid, key, reps=3)
    g = F.bayes_guards(out, y_true)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"[bayes] design={F.DESIGN_NAME} n={F.N_TRAIN} K=4 f32 "
          f"compile_s={comp:.2f} run_s={[round(t, 4) for t in ts]} "
          f"median_s={statistics.median(ts):.4f} "
          f"peak_bytes_in_use={peak} | {card}", flush=True)
    print(f"[bayes] gpu f32: {json.dumps(g)}", flush=True)
    ref = cpu_reference()
    print(f"[bayes] cpu f64: {json.dumps(ref)}", flush=True)
    print(f"[bayes] rmspe gpu/cpu {g['rmspe']:.6f}/{ref['rmspe']:.6f} "
          f"coverage gpu/cpu {g['coverage95']:.4f}/{ref['coverage95']:.4f}",
          flush=True)


def phase_kernel(card: str):
    from ccgp_tpu.experiments import flagship as F

    for n in (100, 114):
        res = F.kernel_check(n=n)
        print(f"[kernel] mh_rounds CUDA vs XLA scan, f32: "
              f"{json.dumps(res)} | {card}", flush=True)
        assert res["ok"], f"kernel check failed at n={n}: {res}"


def four_card_parity(n_dev: int) -> dict:
    """Each sharded path on an n_dev-device mesh against a 1-device mesh,
    in float64 (which the GPU computes natively): a wrong sharding or
    collective changes results by O(1), while a different batch split
    changes them by float64 roundoff, so every comparison holds a relative
    tolerance of 1e-9 (chain flags must be equal)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ccgp_tpu.design.lhs import maximin_lhs
    from ccgp_tpu.experiments import flagship as F, sim_2d_sweep
    from ccgp_tpu.models import MixtureSpec
    from ccgp_tpu.ops import kernels
    from ccgp_tpu.parallel import (make_mesh, sharded_hyperpar_scan,
                                   sharded_posterior_predict)

    f64, tol = jnp.float64, 1e-9
    meshes = {n_dev: make_mesh(n_dev), 1: make_mesh(1)}

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))

    def both(fn):
        out = {}
        for nd in (n_dev, 1):
            t0 = time.perf_counter()
            out[nd] = jax.block_until_ready(fn(nd))
            out[f"s{nd}"] = time.perf_counter() - t0
        return out

    res = {}
    # design sweep: 16 seeded 14-point designs, a full fit + predict each
    designs = sim_2d_sweep.seeded_designs(16)
    o = both(lambda nd: sim_2d_sweep.run(
        sim_2d_sweep.Config(mesh_devices=nd), key=jax.random.PRNGKey(0),
        dtype=f64, designs=designs))
    a, b = o[n_dev], o[1]
    d = max(rel(a.rmspe, b.rmspe), rel(a.coverage, b.coverage),
            rel(a.quant, b.quant))
    res["design_sweep"] = {
        "designs": 16, "n": 14, "max_rel_diff": d, "tol": tol,
        "chain_ok_equal": bool(np.array_equal(a.chain_ok, b.chain_ok)),
        "healthy": int(np.sum(b.chain_ok)),
        "median_rmspe": float(np.median(b.rmspe)),
        f"seconds_{n_dev}dev": o[f"s{n_dev}"], "seconds_1dev": o["s1"],
        "ok": d < tol and bool(np.array_equal(a.chain_ok, b.chain_ok))}

    # EB hyperprior scan: seeded inverse-gamma grid, n = 64, d = 4
    with jax.default_device(jax.devices("cpu")[0]):
        x_np = np.asarray(maximin_lhs(jax.random.PRNGKey(1), 64, 4,
                                      dtype=jnp.float32), np.float64)
    y_np = (np.sin(2 * np.pi * x_np[:, 0]) + x_np[:, 1] ** 2
            + 0.5 * np.cos(3 * x_np[:, 2] * x_np[:, 3]))
    rng = np.random.default_rng(0)
    grid = np.stack([rng.uniform(2, 8, 128), rng.uniform(1, 10, 128),
                     rng.uniform(2, 8, 128), rng.uniform(5, 40, 128)], 1)
    se = kernels.sqexp_family()
    spec4 = MixtureSpec(se, se, dim=4)
    x4, y4 = jnp.asarray(x_np, f64), jnp.asarray(y_np, f64)
    o = both(lambda nd: sharded_hyperpar_scan(
        spec4, x4, y4, grid, jnp.asarray(1.0, f64), meshes[nd],
        n_nodes=1000, jitter=1e-8)[1])
    d = rel(o[n_dev], o[1])
    res["eb_scan"] = {"rows": 128, "nodes": 1000, "n": 64, "d": 4,
                      "max_rel_diff": d, "tol": tol,
                      f"seconds_{n_dev}dev": o[f"s{n_dev}"],
                      "seconds_1dev": o["s1"], "ok": d < tol}

    # posterior predict: 1000 draws around the flagship's prior centre
    x, y, grid2, _ = F.inputs(f64)
    zs = jnp.asarray(np.array([0.3, 0.5, -0.8, 1.7])
                     + 0.1 * rng.normal(size=(1000, 4)), f64)
    betas = jnp.asarray(0.05 * rng.normal(size=1000), f64)
    o = both(lambda nd: sharded_posterior_predict(
        F.SPEC, x, y, grid2, zs, betas, jnp.asarray(0.01, f64), meshes[nd],
        jitter=F.JITTER))
    d = max(rel(u, v) for u, v in zip(o[n_dev], o[1]))
    res["posterior_predict"] = {"draws": 1000, "n": 100, "points": 625,
                                "max_rel_diff": d, "tol": tol,
                                f"seconds_{n_dev}dev": o[f"s{n_dev}"],
                                "seconds_1dev": o["s1"], "ok": d < tol}
    return res


def four_cards(card: str):
    import jax

    assert len(jax.devices()) >= 4, (
        f"--four-cards needs 4 devices, found {len(jax.devices())}")
    for name, res in four_card_parity(4).items():
        print(f"[four-cards] {name}: {json.dumps(res)} | {card}", flush=True)
        assert res["ok"], f"{name}: 4-device vs 1-device mismatch: {res}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on a 4-device mesh")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ccgp_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}", flush=True)
    if args.four_cards:
        jax.config.update("jax_enable_x64", True)
        four_cards(card)
    else:
        phase_map(card)
        phase_bayes(card)
        phase_kernel(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
